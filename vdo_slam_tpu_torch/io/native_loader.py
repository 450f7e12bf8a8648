"""ctypes bindings of the native (C++) sequence loader — port of
vdo_slam_tpu/io/native_loader.py.

Builds the port's own copy of the loader, `csrc/loader.cpp` (the JAX
package's native/loader.cpp with its prefetch race fixed, and a PNG decoder
on zlib alone where the original links libpng), with g++ and zlib into
`vdo_slam_tpu_torch/_build/` at first use, and again when the source is
newer than the library.  NativeSequenceDataset is a drop-in
replacement for io.dataset.SequenceDataset with decode in native code and a
background prefetch thread, replacing the reference demo driver's
synchronous cv::imread loop (example/vdo_slam.cc:98-141).
`build_native_loader` returns None when the library cannot be built or
loaded, as in the JAX package; `BUILD_LOG` then holds why.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from .dataset import FrameData, SequenceDataset

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "loader.cpp"
_BUILD_DIR = _PKG / "_build"
_LIB = _BUILD_DIR / "libvdoloader.so"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
GXX_LIBS = ("-lz", "-lpthread")

# why the last build_native_loader() call returned None ("" after success)
BUILD_LOG = ""


def _compile() -> None:
    """g++ the source into a temporary file, then move it into place, so a
    library that another process is loading is never half written."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", tmp, *GXX_LIBS],
                       check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_native_loader(force: bool = False):
    """Compile (if needed) and load the native library; None on failure,
    with the reason (the compiler's stderr, or the loader's error) in
    BUILD_LOG."""
    global BUILD_LOG
    try:
        if (force or not _LIB.exists()
                or _LIB.stat().st_mtime < _SRC.stat().st_mtime):
            _compile()
        lib = ctypes.CDLL(str(_LIB))
    except subprocess.CalledProcessError as e:
        BUILD_LOG = f"g++ failed (exit {e.returncode}): {e.stderr}"
        return None
    except (OSError, subprocess.SubprocessError) as e:
        BUILD_LOG = f"{type(e).__name__}: {e}"
        return None
    BUILD_LOG = ""

    lib.vdo_png_info.argtypes = [ctypes.c_char_p] + [
        ctypes.POINTER(ctypes.c_int)] * 4
    lib.vdo_png_info.restype = ctypes.c_int
    lib.vdo_png_read.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_long]
    lib.vdo_png_read.restype = ctypes.c_int
    lib.vdo_flo_info.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
    lib.vdo_flo_info.restype = ctypes.c_int
    lib.vdo_flo_read.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_long]
    lib.vdo_flo_read.restype = ctypes.c_int
    lib.vdo_mask_read.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_int32),
                                  ctypes.c_long]
    lib.vdo_mask_read.restype = ctypes.c_int
    lib.vdo_seq_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int]
    lib.vdo_seq_open.restype = ctypes.c_void_p
    lib.vdo_seq_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.vdo_seq_get.restype = ctypes.c_int
    lib.vdo_seq_loads.argtypes = [ctypes.c_void_p]
    lib.vdo_seq_loads.restype = ctypes.c_long
    lib.vdo_seq_close.argtypes = [ctypes.c_void_p]
    lib.vdo_seq_close.restype = None
    return lib


def read_png_native(lib, path: str) -> np.ndarray:
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    bd = ctypes.c_int()
    if lib.vdo_png_info(path.encode(), w, h, c, bd) != 0:
        raise IOError(f"png read failed: {path}")
    out = np.empty(h.value * w.value * c.value, np.float32)
    got = lib.vdo_png_read(path.encode(),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           out.size)
    if got < 0:
        raise IOError(f"png read failed: {path}")
    img = out.reshape(h.value, w.value, c.value)
    return img[..., 0] if c.value == 1 else img


class NativeSequenceDataset(SequenceDataset):
    """SequenceDataset with native decode + double-buffered prefetch.  One
    thread reads a dataset at a time (the loader has one consumer)."""

    def __init__(self, seq_dir: str | Path):
        super().__init__(seq_dir)
        self._lib = build_native_loader()
        if self._lib is None:
            raise RuntimeError(f"native loader unavailable: {BUILD_LOG}")
        # probe geometry from frame 0 rgb
        probe = read_png_native(self._lib,
                                str(self.dir / "image_0" / "000000.png"))
        self._H, self._W = probe.shape[:2]
        self._handle = self._lib.vdo_seq_open(
            str(self.dir).encode(), len(self.timestamps), self._H, self._W
        )

    def __getitem__(self, i: int) -> FrameData:
        H, W = self._H, self._W
        rgb = np.empty((H, W), np.float32)
        depth = np.empty((H, W), np.float32)
        flow = np.empty((H, W, 2), np.float32)
        mask = np.empty((H, W), np.int32)
        rc = self._lib.vdo_seq_get(
            self._handle, i,
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            flow.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc != 0:
            raise IOError(f"native frame load failed at {i} (rc={rc})")
        return FrameData(
            rgb=rgb, depth_raw=depth, flow=flow, mask=mask,
            pose_gt_raw=self.poses_gt[i],
            obj_gt_rows=self.obj_by_frame[i],
            timestamp=self.timestamps[i],
        )

    def loads(self) -> int:
        """Frames the prefetch thread has decoded so far: an in-order read
        of n frames decodes each once, n in all."""
        return self._lib.vdo_seq_loads(self._handle)

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.vdo_seq_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
