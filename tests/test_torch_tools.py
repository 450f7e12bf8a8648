"""The port's offline tools against the repository's: vdo_slam_tpu_torch/
tools/pack_sequence.py against tools/pack_sequence.py (the output
directory byte-equal for every flag combination the original has, and the
entropy wire against the JAX pack_dataset), and vdo_slam_tpu_torch/tools/
cube_segmentation.py against tools/cube_segmentation.py (the JAX tests of
tests/test_tools_and_configs.py:51-101 on the port's copy, labels equal).
"""

import contextlib
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vdo_slam_tpu_torch.io import write_reference_sequence
from vdo_slam_tpu_torch.io.packed_dataset import PackedDataset
from vdo_slam_tpu_torch.io.synthetic import make_scene
from vdo_slam_tpu_torch.tools import cube_segmentation, pack_sequence

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs in several worker processes at once, and each worker's idle
    OpenMP threads spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq_dir(tmp_path_factory):
    """tests/test_packed_dataset.py's scene written in the reference's
    layout, as its test_pack_sequence_cli writes it."""
    scene = make_scene(num_frames=6, width=320, height=240, num_objects=2,
                       seed=3)
    return write_reference_sequence(
        scene, tmp_path_factory.mktemp("seq") / "seq",
        depth_map_factor=256.0, bf=40.0)


def _quiet(fn, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(argv)


def _same_tree(a: Path, b: Path):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    assert "frames.i16" in names and "meta.json" in names
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_pack_sequence_cli(seq_dir, tmp_path):
    """tests/test_packed_dataset.py::test_pack_sequence_cli on the port."""
    rc = _quiet(pack_sequence.main, [str(seq_dir), str(tmp_path / "packed"),
                                     "--depth-map-factor", "256.0",
                                     "--frames", "3"])
    assert rc == 0
    pk = PackedDataset(tmp_path / "packed")
    assert len(pk) == 3
    assert pk.meta["flow_half"] is True


@pytest.mark.parametrize("flags", [
    [], ["--full-res-flow"], ["--flow-delta"],
    ["--depth-down", "2", "--depth-resid", "64"],
], ids=["default", "full-res-flow", "flow-delta", "depth-down-resid"])
def test_pack_cli_byte_equal_to_the_original(flags, seq_dir, tmp_path):
    import tools.pack_sequence as original

    argv = ["--depth-map-factor", "256.0", *flags]
    assert _quiet(pack_sequence.main,
                  [str(seq_dir), str(tmp_path / "port"), *argv]) == 0
    assert _quiet(original.main,
                  [str(seq_dir), str(tmp_path / "jax"), *argv]) == 0
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_pack_cli_entropy_equals_jax_pack_dataset(seq_dir, tmp_path):
    """--entropy (which the original CLI lacks) against the JAX
    pack_dataset with tpu_fast's wire flags."""
    from vdo_slam_tpu.io.dataset import SequenceDataset
    from vdo_slam_tpu.io.packed_dataset import pack_dataset

    assert _quiet(pack_sequence.main,
                  [str(seq_dir), str(tmp_path / "port"), "--flow-delta",
                   "--entropy"]) == 0
    pack_dataset(SequenceDataset(seq_dir), tmp_path / "jax",
                 depth_map_factor=256.0, flow_half=True, flow_delta=True,
                 entropy=True)
    _same_tree(tmp_path / "port", tmp_path / "jax")
    assert PackedDataset(tmp_path / "port").meta["entropy"] is True


def test_pack_cli_depth_steps_and_cap_reach_pack_dataset(seq_dir, tmp_path):
    """--depth-steps and --depth-exc-cap (a configuration's
    wire_depth_steps and wire_depth_exc_cap, configs/omd.json's 64 and
    32768) pack what the port's pack_dataset packs with them, and the
    directory records the scale that check_config holds to the steps."""
    from vdo_slam_tpu_torch.io.dataset import SequenceDataset
    from vdo_slam_tpu_torch.io.packed_dataset import pack_dataset

    assert _quiet(pack_sequence.main,
                  [str(seq_dir), str(tmp_path / "cli"), "--flow-delta",
                   "--entropy", "--depth-steps", "64", "--depth-exc-cap",
                   "32768"]) == 0
    pack_dataset(SequenceDataset(seq_dir), tmp_path / "lib",
                 depth_map_factor=256.0, flow_half=True, flow_delta=True,
                 entropy=True, depth_exc_cap=32768, depth_steps=64)
    _same_tree(tmp_path / "cli", tmp_path / "lib")
    meta = PackedDataset(tmp_path / "cli").meta
    assert meta["depth_scale"] == 0.25 and meta["depth_exc_cap"] == 32768


# ---- cube segmentation (tests/test_tools_and_configs.py:51-101)


def _original():
    sys.path.insert(0, str(REPO / "tools"))
    import cube_segmentation as original

    return original


def _cubes():
    rgb = np.full((300, 400, 3), 20, np.uint8)
    rgb[30:180, 40:190] = (200, 30, 30)    # red cube, 150x150
    rgb[120:280, 230:390] = (30, 60, 210)  # blue cube, 160x160
    return rgb


def test_segments_two_cubes():
    labels = cube_segmentation.segment_cubes(_cubes())
    assert sorted(set(np.unique(labels)) - {0}) == [1, 2]
    for lo_y, hi_y, lo_x, hi_x in [(30, 180, 40, 190), (120, 280, 230, 390)]:
        vals = np.unique(labels[lo_y + 40:hi_y - 40, lo_x + 40:hi_x - 40])
        assert len(vals) == 1 and vals[0] > 0
    np.testing.assert_array_equal(labels,
                                  _original().segment_cubes(_cubes()))


def test_min_size_filter_drops_specks():
    rgb = np.full((300, 400, 3), 20, np.uint8)
    rgb[10:40, 10:40] = (200, 30, 30)  # 30x30 speck << 10000 px
    labels = cube_segmentation.segment_cubes(rgb)
    assert (labels == 0).all()
    np.testing.assert_array_equal(labels, _original().segment_cubes(rgb))


def test_morphology_matches_definitions():
    m = np.zeros((20, 20), bool)
    m[5:12, 5:12] = True
    er = cube_segmentation.erode(m, 3)
    assert er.sum() == 5 * 5 and er[6:11, 6:11].all()
    assert (cube_segmentation.dilate(er, 3) == m).all()
    orig = _original()
    for k in (1, 2, 3, 4, 9):
        np.testing.assert_array_equal(cube_segmentation.erode(m, k),
                                      orig.erode(m, k))
        np.testing.assert_array_equal(cube_segmentation.dilate(m, k),
                                      orig.dilate(m, k))


def test_noisy_frame_labels_equal_the_original():
    """A textured frame with noise, every threshold on its default and off
    it: the port's labels equal the original's."""
    rng = np.random.default_rng(5)
    rgb = np.clip(_cubes().astype(np.int32)
                  + rng.integers(-25, 26, (300, 400, 3)), 0,
                  255).astype(np.uint8)
    orig = _original()
    for kw in ({}, {"sat_thres": 0.5, "min_size": 5000, "erode_k": 5,
                    "dilate_k": 12}):
        np.testing.assert_array_equal(cube_segmentation.segment_cubes(rgb,
                                                                      **kw),
                                      orig.segment_cubes(rgb, **kw))


def test_cli_reads_png_with_the_native_reader(tmp_path):
    from PIL import Image

    from vdo_slam_tpu_torch.io import native_loader

    if native_loader.build_native_loader() is None:
        pytest.skip(f"native reader unavailable: {native_loader.BUILD_LOG}")
    (tmp_path / "img").mkdir()
    for i, rgb in enumerate((_cubes(), np.full((300, 400, 3), 20,
                                               np.uint8))):
        Image.fromarray(rgb).save(tmp_path / "img" / f"{i:06d}.png")
    rc = _quiet(cube_segmentation.main, [str(tmp_path / "img"),
                                         str(tmp_path / "out")])
    assert rc == 0
    got = np.loadtxt(tmp_path / "out" / "000000.txt", dtype=np.int64)
    np.testing.assert_array_equal(got,
                                  cube_segmentation.segment_cubes(_cubes()))
    assert (np.loadtxt(tmp_path / "out" / "000001.txt") == 0).all()
    assert _quiet(cube_segmentation.main, [str(tmp_path / "none"),
                                           str(tmp_path / "o2")]) == 1
