"""The port's on-disk input path against the JAX package's: the sequence
writer (byte-equal files), the Python reader (equal frames, atol = 0), the
native C++ reader with its prefetch thread (against the port's Python
reader: rgb within 1e-5, depth, flow and mask at atol = 0, as
tests/test_pipeline_e2e.py:337-350 holds the JAX one; and against the JAX
native library's decode of the same files), the PNG cases of
tests/test_native_loader.py, the port's PNG decoder on zlib alone against
the JAX library's libpng on every colour type, depth, row filter and
interlace libpng accepts, against PIL on the files PIL writes, and on the
files libpng refuses, a regression test of the prefetch race that
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
import struct
import zlib
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


def _missing_header(name: str, dirs=("/usr/include", "/usr/local/include",
                                      "/usr/include/libpng16")) -> bool:
    return not any(Path(d, name).exists() for d in dirs)


def _native_unavailable_reason() -> str | None:
    """Why the port's loader cannot be built here, where the machine lacks
    a tool or header it needs (g++ and zlib); None where it has them."""
    if shutil.which("g++") is None:
        return "g++ is not installed"
    if _missing_header("zlib.h"):
        return "zlib.h (zlib's header) is not installed"
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
    temporary directory; it links libpng, which the port's does not."""
    if _missing_header("png.h"):
        pytest.skip("the JAX package's loader needs png.h (libpng's "
                    "header), which is not installed")
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


def _crc_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _filter_row(cur: np.ndarray, prior: np.ndarray, kind: int,
                bpp: int) -> np.ndarray:
    """One scanline under PNG filter `kind` (0-4), as an encoder filters
    it: each byte minus its predictor from the unfiltered bytes."""
    c, b = cur.astype(np.int32), prior.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), c[:-bpp]])
    up_left = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(c)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) // 2
    else:
        p = a + b - up_left
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - up_left)
        pred = np.where((pa <= pb) & (pa <= pc), a,
                        np.where(pb <= pc, b, up_left))
    return ((c - pred) % 256).astype(np.uint8)


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def encode_png(samples: np.ndarray, color: int, depth: int,
               interlace: bool = False, palette=None, trns=None,
               filter_type=None) -> bytes:
    """A PNG written here, not by PIL, so that every colour type, depth,
    filter and Adam7 can be tested: samples (H, W, channels) of raw values
    (palette indices for color 3).  Row k of each pass takes filter
    k mod 5 unless `filter_type` fixes one."""
    H, W = samples.shape[:2]
    ch = samples.shape[2]
    bpp = max(1, ch * depth // 8)
    raw = bytearray()
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prior = None
        for k, row in enumerate(sub):
            flat = row.reshape(-1)
            if depth == 16:
                cur = flat.astype(">u2").view(np.uint8)
            elif depth == 8:
                cur = flat.astype(np.uint8)
            else:
                bits = ((flat[:, None] >> np.arange(depth - 1, -1, -1))
                        & 1).astype(np.uint8)
                cur = np.packbits(bits.reshape(-1))
            prior = np.zeros_like(cur) if prior is None else prior
            kind = k % 5 if filter_type is None else filter_type
            raw += bytes([kind]) + _filter_row(cur, prior, kind,
                                               bpp).tobytes()
            prior = cur
    out = b"\x89PNG\r\n\x1a\n" + _crc_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += _crc_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _crc_chunk(b"tRNS", np.asarray(trns, np.uint8).tobytes())
    z = zlib.compress(bytes(raw), 6)
    # the image data split over two IDAT chunks, as encoders may split it
    out += _crc_chunk(b"IDAT", z[:len(z) // 2])
    out += _crc_chunk(b"IDAT", z[len(z) // 2:])
    return out + _crc_chunk(b"IEND", b"")


# (name, colour type, depth, channels, palette entries)
PNG_KINDS = [("gray1", 0, 1, 1, 0), ("gray2", 0, 2, 1, 0),
             ("gray4", 0, 4, 1, 0), ("gray8", 0, 8, 1, 0),
             ("gray16", 0, 16, 1, 0), ("ga8", 4, 8, 2, 0),
             ("ga16", 4, 16, 2, 0), ("rgb8", 2, 8, 3, 0),
             ("rgb16", 2, 16, 3, 0), ("rgba8", 6, 8, 4, 0),
             ("rgba16", 6, 16, 4, 0), ("pal1", 3, 1, 1, 2),
             ("pal2", 3, 2, 1, 4), ("pal4", 3, 4, 1, 16),
             ("pal8", 3, 8, 1, 200)]


def _expected(samples, color, depth, palette, trns):
    """What the libpng path returns for these samples: raw values, gray
    below 8 bits scaled to 0..255, palette indices looked up (RGBA where
    there is a tRNS chunk)."""
    if color == 3:
        pal = np.zeros((256, 4), np.float32)
        pal[:, 3] = 255
        pal[:len(palette), :3] = palette
        if trns is not None:
            pal[:len(trns), 3] = trns
        return pal[samples[..., 0]][..., :3 if trns is None else 4]
    out = samples.astype(np.float32)
    if depth < 8:
        out = out * (255 // (2 ** depth - 1))
    return out[..., 0] if out.shape[-1] == 1 else out


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("name,color,depth,ch,n_pal", PNG_KINDS)
def test_png_decode_every_kind(lib, jax_lib, tmp_path, name, color, depth,
                               ch, n_pal, interlace):
    """Every colour type and depth the libpng path accepts, each row
    filter, plain and Adam7 (odd sizes leave passes short or empty):
    decoded as the values written, and as the JAX package's libpng reader
    decodes the same file."""
    rng = np.random.default_rng(depth * 10 + color)
    H, W = 13, 21
    hi = n_pal if color == 3 else 2 ** depth
    samples = rng.integers(0, hi, (H, W, ch)).astype(np.uint16)
    palette = trns = None
    if color == 3:
        palette = rng.integers(0, 256, (n_pal, 3))
    for with_trns in ((False, True) if color == 3 else (False,)):
        if with_trns:
            trns = rng.integers(0, 256, max(n_pal // 2, 1))
        path = tmp_path / f"{name}_{int(interlace)}_{int(with_trns)}.png"
        path.write_bytes(encode_png(samples, color, depth, interlace,
                                    palette, trns))
        got = read_png_native(lib, str(path))
        want = _expected(samples, color, depth, palette, trns)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, jax_native.read_png_native(jax_lib, str(path)))


def test_png_pil_written_files_equal_pil(lib, tmp_path):
    """PNGs that PIL writes, in each mode it writes (1-bit, 8- and 16-bit
    gray, gray+alpha, RGB, RGBA, palette with and without transparency,
    and a 4-bit palette), decoded as PIL decodes them."""
    from PIL import Image

    rng = np.random.default_rng(11)
    H, W = 37, 53
    rgba = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    images = {
        "1": Image.fromarray(rng.random((H, W)) > 0.5),
        "L": Image.fromarray(rgba[..., 0]),
        "I;16": Image.fromarray(rng.integers(0, 65536, (H, W),
                                             dtype=np.uint16)),
        "LA": Image.fromarray(rgba[..., :2], "LA"),
        "RGB": Image.fromarray(rgba[..., :3]),
        "RGBA": Image.fromarray(rgba),
        "P": Image.fromarray(rgba[..., :3]).quantize(200),
    }
    for mode, im in images.items():
        path = tmp_path / f"{mode.replace(';', '_')}.png"
        im.save(path)
        got = read_png_native(lib, str(path))
        ref = Image.open(path)
        if mode == "P":
            ref = ref.convert("RGB")
        want = np.asarray(ref).astype(np.float32)
        if mode == "1":
            want = want * 255
        np.testing.assert_array_equal(got, want)
    pal = images["P"]
    pal.save(tmp_path / "pt.png", transparency=bytes(range(0, 200, 2)))
    pal.save(tmp_path / "p4.png", bits=4)
    for name, conv in (("pt.png", "RGBA"), ("p4.png", "RGB")):
        got = read_png_native(lib, str(tmp_path / name))
        want = np.asarray(Image.open(tmp_path / name).convert(conv))
        np.testing.assert_array_equal(got, want.astype(np.float32))


def test_png_refusals_match_libpng(lib, jax_lib, tmp_path):
    """What the libpng path refuses, the port's decoder refuses with the
    same error return: a bad signature, a bad IHDR CRC, a depth the colour
    type does not allow, a palette image without PLTE, a row filter of 5,
    truncated image data, and a missing file."""
    rng = np.random.default_rng(3)
    good = encode_png(rng.integers(0, 256, (5, 6, 3)), 2, 8)
    bad = {
        "sig.png": b"\x89PNX" + good[4:],
        "crc.png": good[:29] + bytes([good[29] ^ 1]) + good[30:],
        "depth.png": encode_png(rng.integers(0, 16, (5, 6, 3)), 2, 4),
        "noplte.png": encode_png(rng.integers(0, 4, (5, 6, 1)), 3, 8),
        "filter.png": encode_png(rng.integers(0, 256, (5, 6, 3)), 2, 8,
                                 filter_type=5),
        "short.png": encode_png(rng.integers(0, 256, (5, 6, 3)), 2, 8)[:60],
    }
    for name, data in bad.items():
        (tmp_path / name).write_bytes(data)
    for name in [*bad, "missing.png"]:
        path = str(tmp_path / name)
        for L, reader in ((lib, read_png_native),
                          (jax_lib, jax_native.read_png_native)):
            with pytest.raises(IOError):
                reader(L, path)
            w = ctypes.c_int()
            assert L.vdo_png_info(path.encode(), w, w, w, w) == -1, name


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
