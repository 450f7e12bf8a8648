"""The port's FusedTracker.step_chunk and the bench's scene cache on disk.

On the CPU: step_chunk against the tracker's step called frame by frame,
bit-equal; the chunked drive's archive against the frame-by-frame drive's;
the scene cache (at 320x96, where bench.py's camera sees trackable points)
loaded, not made, on the second call; and the port's tools and the cache
load without jax.
"""

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_slice import WIRE, tiny_pair
from vdo_slam_tpu_torch import bench
from vdo_slam_tpu_torch.io import synthetic
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.pipeline import draws as draws_mod
from vdo_slam_tpu_torch.pipeline.fused import FusedTracker, pack_outputs

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs in several worker processes at once, and each worker's idle
    OpenMP threads spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_tempdir(tmp_path, monkeypatch):
    """tempfile's directory (the scene cache's) moved under tmp_path."""
    d = tmp_path / "tmp"
    d.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(d))
    return d


@pytest.fixture(scope="module")
def tiny_ds():
    scene = synthetic.make_scene(num_frames=9, width=96, height=64,
                                 num_objects=1, seed=1)
    return SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)


# ---- step_chunk


def test_step_chunk_equals_frame_steps(tiny_ds):
    """Two chunks of 4 through step_chunk against the tracker's step called
    frame by frame with each frame's draws: equal output vectors and
    states, bit for bit."""
    _, cfg = tiny_pair(fused_chunk=4, **WIRE)
    tr = FusedTracker(cfg, device="cpu")
    ref = FusedTracker(cfg, device="cpu")
    state, st = tr.state, ref.state
    for f0 in (0, 4):
        staged = tr.device_inputs_chunk([tiny_ds[f0 + c] for c in range(4)])
        staged.pop("_T_cw_gt_host")
        state, vecs = tr.step_chunk(state, staged, f0)
        want = []
        for c in range(4):
            draws = draws_mod.UniformDraws(ref.frame_draws(f0 + c))
            st, m = ref.step(st, {k: v[c] for k, v in staged.items()}, draws,
                             f0 + c > 0)
            want.append(pack_outputs(st, m))
        assert vecs.shape == (4, want[0].numel())
        assert torch.equal(vecs, torch.stack(want))
    assert tr.initialized
    from vdo_slam_tpu_torch.parallel.multistream import _flatten

    for a, b in zip(_flatten(state), _flatten(st)):
        assert torch.equal(a, b)


def test_grab_chunk_archive_equals_frame_drive(tiny_ds):
    """grab_chunk (which now steps through step_chunk) over 8 frames in
    chunks of 4 archives what grab_frame archives frame by frame."""
    _, cfg4 = tiny_pair(fused_chunk=4, fused_drain_chunks=1, **WIRE)
    _, cfg1 = tiny_pair(**WIRE)
    fds = [tiny_ds[i] for i in range(8)]
    chunked = FusedTracker(cfg4, device="cpu")
    reps = chunked.grab_chunk(fds[:4]) + chunked.grab_chunk(fds[4:])
    reps += chunked.flush()
    frames = FusedTracker(cfg1, device="cpu")
    for fd in fds:
        frames.grab_frame(fd)
    frames.flush()
    assert [r["frame_id"] for r in reps] == list(range(8))
    assert chunked.map.num_frames == frames.map.num_frames == 8
    for key in ("cam_pose", "stat_xy", "dyn_xy", "dyn_obj_label"):
        np.testing.assert_array_equal(np.stack(getattr(chunked.map, key)),
                                      np.stack(getattr(frames.map, key)),
                                      err_msg=key)


# ---- the scene cache


def test_scene_cache_loads_on_second_call(tmp_tempdir, monkeypatch):
    """bench_scene's disk cache: made and written on the first call, loaded
    on the second (making it again would raise), equal to a fresh
    make_scene; the path keyed on the values; the hard variant a file of
    its own; a damaged file made anew; no temporary file left."""
    make = bench._scene.__wrapped__          # past the in-process memo
    real_make = synthetic.make_scene
    first = make(3, 320, 96, False)
    path = Path(bench.scene_cache_path(3, 320, 96, False))
    assert path.parent == tmp_tempdir and path.exists()

    def no_make(*a, **k):
        raise AssertionError("made again, not loaded")

    monkeypatch.setattr(synthetic, "make_scene", no_make)
    again = make(3, 320, 96, False)
    fresh = real_make(num_frames=4, width=320, height=96, num_objects=3,
                      fx=bench.FX, seed=7)
    for k in bench.dataclasses.fields(fresh):
        np.testing.assert_array_equal(getattr(again, k.name),
                                      getattr(fresh, k.name))
        np.testing.assert_array_equal(getattr(first, k.name),
                                      getattr(fresh, k.name))
        assert getattr(again, k.name).dtype == getattr(fresh, k.name).dtype
    assert bench.scene_cache_path(n_frames=3, width=320, height=96,
                                  hard=False) == str(path)
    others = {bench.scene_cache_path(4, 320, 96, False),
              bench.scene_cache_path(3, 321, 96, False),
              bench.scene_cache_path(3, 320, 97, False),
              bench.scene_cache_path(3, 320, 96, True)}
    assert len(others) == 4 and str(path) not in others
    # the hard variant: its own file, the degraded scene
    monkeypatch.setattr(synthetic, "make_scene", real_make)
    hard = make(3, 320, 96, True)
    hard_path = Path(bench.scene_cache_path(3, 320, 96, True))
    assert hard_path.exists()
    monkeypatch.setattr(synthetic, "degrade_scene", no_make)
    hard_again = make(3, 320, 96, True)
    np.testing.assert_array_equal(hard_again.flow, hard.flow)
    assert not np.array_equal(hard.flow, fresh.flow)
    # a damaged file is made anew and rewritten
    monkeypatch.setattr(synthetic, "make_scene", real_make)
    path.write_bytes(b"not a zip")
    remade = make(3, 320, 96, False)
    np.testing.assert_array_equal(remade.rgb, fresh.rgb)
    assert path.stat().st_size > 1000
    assert sorted(p.name for p in tmp_tempdir.iterdir()) == sorted(
        [path.name, hard_path.name])


NO_JAX = r"""
import sys
if sys.argv[1] == "block":
    sys.modules["jax"] = None
    sys.modules["flax"] = None
from vdo_slam_tpu_torch import bench
from vdo_slam_tpu_torch.tools import cube_segmentation, pack_sequence
scene = bench.bench_scene(3, 320, 96)
assert scene.rgb.shape == (4, 96, 320), scene.rgb.shape
bad = [m for m in sys.modules if sys.modules[m] is not None and (
    m in ("jax", "vdo_slam_tpu", "bench") or m.startswith(
        ("jax.", "flax", "vdo_slam_tpu.")))]
assert not bad, bad
print("NO_JAX_OK")
"""


@pytest.mark.parametrize("block", ["block", "free"])
def test_tools_and_cache_load_without_jax(tmp_tempdir, block):
    """In a fresh process, the port's two tools import and the cached scene
    loads (not made: the log says so) with jax unimportable ("block"), and
    with jax importable but never imported ("free")."""
    import os

    bench._scene.__wrapped__(3, 320, 96, False)      # plant the cache
    env = {k: v for k, v in os.environ.items() if not k.startswith(
        "VDO_BENCH_")}
    env["TMPDIR"] = str(tmp_tempdir)
    out = subprocess.run([sys.executable, "-c", NO_JAX, block], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
    assert "scene loaded from " + str(tmp_tempdir) in out.stderr
