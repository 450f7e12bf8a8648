"""The port's on-disk input path against the JAX package's: the sequence
writer (byte-equal files), the Python reader (equal frames, atol = 0), the
native C++ reader with its prefetch thread (against the port's Python
reader: rgb within 1e-5, depth, flow and mask at atol = 0, as
tests/test_pipeline_e2e.py:337-350 holds the JAX one; and against the JAX
native library's decode of the same files), the PNG cases of
tests/test_native_loader.py, a regression test of the prefetch race that
the JAX loader has (ROADMAP Queue 3), and the CLI's positional form
`run.main([settings.yaml, sequence_dir, ...])` against the JAX CLI on the
same written sequence.

The JAX native library is compiled into a temporary directory here (its
build_native_loader with `_LIB` pointed there), so this file never writes
native/libvdoloader.so, which other test files build.  Its sequence reader
is not used: its prefetch race (re-requesting a frame in flight) makes it
fail when read at full speed, so it is compared at the decode level
(vdo_png_read, vdo_flo_read, vdo_mask_read).

The 320x240 scene is tests/test_pipeline_e2e.py's, 6 frames, with the raw
depth stored as DepthMapFactor * bf / z (DepthMapFactor 512, as in
TestOnDiskSequence).
"""

import ctypes
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_slice import pose_gap
from vdo_slam_tpu.io import native_loader as jax_native
from vdo_slam_tpu.io.dataset import SequenceDataset as JaxSequenceDataset
from vdo_slam_tpu.io.sequence_writer import \
    write_reference_sequence as jax_write
from vdo_slam_tpu_torch.io import native_loader
from vdo_slam_tpu_torch.io.dataset import SequenceDataset
from vdo_slam_tpu_torch.io.flo import write_flo
from vdo_slam_tpu_torch.io.native_loader import (NativeSequenceDataset,
                                                 build_native_loader,
                                                 read_png_native)
from vdo_slam_tpu_torch.io.sequence_writer import write_reference_sequence
from vdo_slam_tpu_torch.io.synthetic import make_scene

DMF, BF = 512.0, 40.0
N_FRAMES = 6               # tracked frames (the scene renders one more)
RACE_REPEATS = 60
# the CLI's whole-run tolerance: tests/test_torch_tracking.py's
# test_system_metrics_within_bounds (camera within 3x JAX's or under
# 5e-3 m / 0.01 deg, obj_t under 0.02 m, the same object estimates)
CAM_T_FLOOR, CAM_R_FLOOR, OBJ_T_MAX, RATIO = 5e-3, 0.01, 0.02, 3.0
# a frame of the native reader's run against the Python reader's run: the
# rgb differs in its last bit, so the runs are held as the card is held to
# the CPU (tests/test_torch_kernel_cuda.py)
T_TOL_M, R_TOL_DEG = 1e-3, 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _native_unavailable_reason() -> str | None:
    """Why the loader cannot be built here, where the machine lacks a tool
    or header it needs; None where it has them."""
    if shutil.which("g++") is None:
        return "g++ is not installed"
    if not any(Path(d, "png.h").exists()
               for d in ("/usr/include", "/usr/local/include",
                         "/usr/include/libpng16")):
        return "png.h (libpng's header) is not installed"
    return None


@pytest.fixture(scope="module")
def lib():
    built = build_native_loader()
    if built is None:
        reason = _native_unavailable_reason()
        if reason:
            pytest.skip(f"native loader not built: {reason}")
        pytest.fail(f"native loader did not build: {native_loader.BUILD_LOG}")
    return built


@pytest.fixture(scope="module")
def jax_lib(lib, tmp_path_factory):
    """The JAX package's library, built from native/loader.cpp into a
    temporary directory."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "_LIB",
               tmp_path_factory.mktemp("jax_native") / "libvdoloader.so")
    try:
        built = jax_native.build_native_loader()
    finally:
        mp.undo()
    assert built is not None
    return built


@pytest.fixture(scope="module")
def scene():
    return make_scene(num_frames=N_FRAMES + 1, width=320, height=240,
                      num_objects=2, seed=3)


@pytest.fixture(scope="module")
def roots(scene, tmp_path_factory):
    port = write_reference_sequence(scene, tmp_path_factory.mktemp("port"),
                                    depth_map_factor=DMF, bf=BF)
    ref = jax_write(scene, tmp_path_factory.mktemp("jax"),
                    depth_map_factor=DMF, bf=BF)
    return Path(port), Path(ref)


def settings_yaml(scene, path: Path) -> Path:
    """A settings file in the reference's format for the scene's camera;
    the keys left out keep their KITTI defaults (config.load_settings)."""
    K = scene.K_mat
    H, W = scene.rgb.shape[1:3]
    path.write_text("%YAML:1.0\n" + "".join(
        f"{k}: {v}\n" for k, v in (
            ("Camera.fx", float(K[0, 0])), ("Camera.fy", float(K[1, 1])),
            ("Camera.cx", float(K[0, 2])), ("Camera.cy", float(K[1, 2])),
            ("Camera.width", W), ("Camera.height", H), ("Camera.bf", BF),
            ("ChooseData", 2), ("DepthMapFactor", DMF))))
    return path


def _files(root: Path) -> list[Path]:
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def test_writer_bytes_equal_jax(roots):
    port, ref = roots
    names = _files(ref)
    assert names == _files(port)
    assert len(names) == 4 * (N_FRAMES + 1) + 3
    for name in names:
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name


def test_python_reader_equals_jax(roots):
    port, ref = roots
    a, b = SequenceDataset(port), JaxSequenceDataset(ref)
    assert len(a) == len(b) == N_FRAMES
    for i in range(N_FRAMES + 1):      # every frame on disk
        fa, fb = a[i], b[i]
        for field in ("rgb", "depth_raw", "flow", "mask", "pose_gt_raw",
                      "obj_gt_rows"):
            x, y = getattr(fa, field), getattr(fb, field)
            assert x.dtype == y.dtype, field
            np.testing.assert_array_equal(x, y, err_msg=field)
        assert fa.timestamp == fb.timestamp


def _assert_frames_match(nat, py, rgb_atol=1e-5):
    np.testing.assert_allclose(nat.rgb, py.rgb, rtol=0, atol=rgb_atol)
    np.testing.assert_array_equal(nat.depth_raw, py.depth_raw)
    np.testing.assert_array_equal(nat.flow, py.flow)
    np.testing.assert_array_equal(nat.mask, py.mask)
    np.testing.assert_array_equal(nat.pose_gt_raw, py.pose_gt_raw)
    np.testing.assert_array_equal(nat.obj_gt_rows, py.obj_gt_rows)


def test_native_reader_equals_python_reader(lib, roots):
    root, _ = roots
    py = SequenceDataset(root)
    nat = NativeSequenceDataset(root)
    try:
        assert len(nat) == len(py)
        for i in range(len(py.timestamps)):
            _assert_frames_match(nat[i], py[i])
    finally:
        nat.close()


def test_native_decode_equals_jax_native(lib, jax_lib, roots):
    root, _ = roots
    H, W = 240, 320
    for i in range(N_FRAMES + 1):
        name = f"{i:06d}"
        for sub in ("image_0", "depth"):
            path = str(root / sub / f"{name}.png")
            np.testing.assert_array_equal(read_png_native(lib, path),
                                          jax_native.read_png_native(
                                              jax_lib, path))
        flo = str(root / "flow" / f"{name}.flo").encode()
        sem = str(root / "semantic" / f"{name}.txt").encode()
        outs = []
        for L in (lib, jax_lib):
            flow = np.empty((H, W, 2), np.float32)
            mask = np.empty((H, W), np.int32)
            assert L.vdo_flo_read(flo, flow.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)), flow.size) == 0
            assert L.vdo_mask_read(sem, mask.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)), mask.size) == 0
            outs.append((flow, mask))
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        np.testing.assert_array_equal(outs[0][1], outs[1][1])


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    """tests/test_native_loader.py's files: an 8-bit gray image and a
    16-bit depth image of a 96x64 scene."""
    from PIL import Image

    root = tmp_path_factory.mktemp("png")
    sc = make_scene(num_frames=2, width=96, height=64, num_objects=1)
    Image.fromarray((sc.rgb[0] * 255).astype(np.uint8)).save(root / "g8.png")
    Image.fromarray((sc.depth[0] * 100).astype(np.uint16)).save(
        root / "g16.png")
    write_flo(root / "f.flo", sc.flow[0])
    return root, sc


def test_png_gray8(lib, png_dir):
    root, sc = png_dir
    img = read_png_native(lib, str(root / "g8.png"))
    ref = (sc.rgb[0] * 255).astype(np.uint8).astype(np.float32)
    np.testing.assert_allclose(img, ref, atol=0)


def test_png_gray16(lib, png_dir):
    root, sc = png_dir
    img = read_png_native(lib, str(root / "g16.png"))
    ref = (sc.depth[0] * 100).astype(np.uint16).astype(np.float32)
    np.testing.assert_allclose(img, ref, atol=0)


def test_prefetch_race_regression(lib, roots):
    """Open the sequence and read every frame in order, RACE_REPEATS times,
    then out of order.  The JAX loader re-requests the frame in flight: it
    decodes that frame twice, and where its thread takes the lock first the
    read fails (-2).  The port's must return every frame, each equal to the
    Python reader's, and decode each frame of an in-order read once."""
    root, _ = roots
    py = SequenceDataset(root)
    n = len(py.timestamps)             # every frame on disk
    want = [py[i] for i in range(n)]
    for _ in range(RACE_REPEATS):
        nat = NativeSequenceDataset(root)
        try:
            for i in range(n):
                _assert_frames_match(nat[i], want[i])
            assert nat.loads() == n
        finally:
            nat.close()
    nat = NativeSequenceDataset(root)
    try:
        order = [3, 1, 1, 6, 0, 5, 2, 4, 4, 3] * 3
        for i in order:
            _assert_frames_match(nat[i], want[i])
        with pytest.raises(IOError):
            nat[n]
    finally:
        nat.close()


def _report(capsys) -> dict:
    return json.loads(capsys.readouterr().out)


def test_cli_on_a_written_sequence(scene, roots, tmp_path, capsys):
    """run.main([settings, sequence_dir]) in the default mode with both BA
    passes: the port on the CPU against the JAX CLI on the same files."""
    from vdo_slam_tpu import run as jax_run
    from vdo_slam_tpu_torch import run

    root, _ = roots
    yaml = settings_yaml(scene, tmp_path / "settings.yaml")
    out = tmp_path / "out"
    argv = [str(yaml), str(root), "--quiet", "--frames", str(N_FRAMES)]
    assert run.main(argv + ["--device", "cpu", "--out", str(out)]) == 0
    port = _report(capsys)
    assert jax_run.main(argv) == 0
    ref = _report(capsys)
    assert set(port) == set(ref)
    assert port["frames"] == ref["frames"] == N_FRAMES
    for key in ("metrics_initial", "metrics_refined"):
        p, r = port[key], ref[key]
        assert p["cam_t_rpe"] < max(RATIO * r["cam_t_rpe"], CAM_T_FLOOR), \
            (key, p, r)
        assert p["cam_r_rpe_deg"] < max(RATIO * r["cam_r_rpe_deg"],
                                        CAM_R_FLOOR), (key, p, r)
        assert p["obj_t_rpe"] < max(RATIO * r["obj_t_rpe"], OBJ_T_MAX), \
            (key, p, r)
        assert p["n_obj_estimates"] == r["n_obj_estimates"] > 0, (key, p, r)
    assert port["timing"]["camera_est_ms"] > 0
    for f in ("initial_stereo_new.txt", "refined_stereo_new.txt",
              "obj_mot_stereo_new.txt", "speed_estimated.txt",
              "dynamic_slam_graph_after_opt.g2o"):
        assert (out / f).exists(), f


@pytest.mark.parametrize("mode", ["reference", "fused"])
def test_system_over_native_reader(lib, scene, roots, tmp_path, mode):
    """System(...).run_sequence over NativeSequenceDataset in both modes,
    frame by frame against the same run over the Python reader."""
    from vdo_slam_tpu_torch.config import load_settings
    from vdo_slam_tpu_torch.pipeline import System

    root, _ = roots
    cfg = load_settings(settings_yaml(scene, tmp_path / "settings.yaml"))
    maps, mets = [], []
    for ds in (SequenceDataset(root), NativeSequenceDataset(root)):
        sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                      mode=mode, device="cpu")
        sysm.run_sequence(ds, max_frames=N_FRAMES)
        maps.append(sysm.map)
        mets.append(sysm.metrics())
        if isinstance(ds, NativeSequenceDataset):
            ds.close()
    py, nat = maps
    assert py.num_frames == nat.num_frames == N_FRAMES
    for a, b in zip(nat.cam_pose, py.cam_pose):
        dt, dr = pose_gap(a, b)
        assert dt < T_TOL_M and dr < R_TOL_DEG, (dt, dr)
    assert mets[0]["n_obj_estimates"] == mets[1]["n_obj_estimates"] > 0
