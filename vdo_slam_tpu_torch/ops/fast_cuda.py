"""Wrapper of the FAST-9/16 CUDA kernel (csrc/fast_score.cu).

`fast_score_pyramid(levels, th_ini, th_min)` returns the corner score maps
of every level of a pyramid at two thresholds; `fast_score_pair(gray,
th_ini, th_min)` is its one-level case.  For CUDA tensors it launches the
hand-written kernel once for all levels (one allocation, one ctypes call)
or raises; for CPU tensors it runs the plain PyTorch version,
`ops.fast.fast_score`, once per level and threshold.  The kernel replaces
the Pallas kernel vdo_slam_tpu/ops/fast_pallas.py:_fast_kernel.

The shared library is compiled with nvcc at first use, from the source in
the package, into `vdo_slam_tpu_torch/_build/` (named by a hash of the
source, so an edited source rebuilds), and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

Tensor = torch.Tensor

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "fast_score.cu"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_LEVELS = 16  # FAST_MAX_LEVELS of the source
TILE = 32        # side of a block's output tile in the source


class _Level(ctypes.Structure):
    """struct FastLevel of the source."""
    _fields_ = [("data", ctypes.c_void_p), ("out_off", ctypes.c_longlong),
                ("H", ctypes.c_int), ("W", ctypes.c_int),
                ("tile0", ctypes.c_int), ("tiles_x", ctypes.c_int)]


class _Pyramid(ctypes.Structure):
    """struct FastPyramid of the source, passed to the launch by value."""
    _fields_ = [("lv", _Level * MAX_LEVELS), ("n_levels", ctypes.c_int),
                ("th_ini", ctypes.c_float), ("th_min", ctypes.c_float)]


def pyramid_layout(shapes, S: int):
    """The launch geometry of levels of shape (H_l, W_l), S images each.

    Returns (rows, n_tiles, size): one row (level, out_off, H, W, tile0,
    tiles_x) per level in the order of FastPyramid's table (rows[k][1:] is
    struct FastLevel), the grid's tile count, and the output's length.  The
    output holds, level after level, the level's (S, H_l, W_l) th_ini
    scores from out_off, then its th_min scores.  The grid takes the last
    (smallest) level's tiles first: the compass test lists the most pixels
    there, so those blocks take longest and should not trail in the last
    wave.
    """
    offs, off = [], 0
    for H, W in shapes:
        offs.append(off)
        off += 2 * S * H * W
    rows, tiles = [], 0
    for level in reversed(range(len(shapes))):
        H, W = shapes[level]
        tiles_x = -(-W // TILE)
        rows.append((level, offs[level], H, W, tiles, tiles_x))
        tiles += tiles_x * -(-H // TILE)
    return rows, tiles, off


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the FAST "
                       "kernel is built from source at first use")


class FastScoreKernel:
    """The built kernel and its launch count.

    `launches` goes up by one for each kernel launch and for nothing else
    (the CPU path does not count).  A call made while its stream captures a
    CUDA graph records the launch into the graph without launching it: it
    counts in `captured`, and each replay of that graph adds the launches
    its capture recorded to `launches` (utils/cuda_graph.py).
    `build_seconds` and `build_log` (nvcc's -Xptxas -v report) are filled
    when this process built or loaded the library.
    """

    def __init__(self):
        self.launches = 0
        self.captured = 0
        self.build_seconds: float | None = None
        self.build_log = ""
        self._lib = None  # the loaded library, kept for the function's life
        self._fn = None

    def library_path(self) -> Path:
        digest = hashlib.sha1(_SOURCE.read_bytes()
                              + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return _BUILD_DIR / f"libfast_score_{digest[:12]}.so"

    def build(self):
        """Compile (if the library for this source is missing) and load."""
        if self._fn is not None:
            return self._fn
        t0 = time.time_ns()
        lib_path = self.library_path()
        if not lib_path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
                    capture_output=True, text=True)
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}):\n{self.build_log}")
                os.replace(tmp, lib_path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(str(lib_path))
        lib.fast_pyramid_sizeof.restype = ctypes.c_int
        if lib.fast_pyramid_sizeof() != ctypes.sizeof(_Pyramid):
            raise RuntimeError(
                f"struct FastPyramid is {lib.fast_pyramid_sizeof()} bytes in "
                f"the library, {ctypes.sizeof(_Pyramid)} here")
        fn = lib.fast_score_pyramid_launch
        fn.argtypes = [_Pyramid, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self._lib = lib
        self._fn = fn
        t1 = time.time_ns()
        self.build_seconds = (t1 - t0) / 1e9
        # imported here: utils/ imports this module
        from ..utils import profiling
        rec = profiling.ACTIVE
        if rec is not None:
            rec.add("setup.fast_build", t0, t1, "fast_score")
        return fn

    def launch(self, levels: list[Tensor], th_ini: float, th_min: float):
        """One launch over checked levels on the current stream of their
        device (recorded into the graph where that stream captures one); no
        sync.  Returns a (score_ini, score_min) pair per level, views of one
        allocation."""
        fn = self.build()
        S = levels[0].shape[0] if levels[0].ndim == 3 else 1
        rows, n_tiles, size = pyramid_layout(
            [g.shape[-2:] for g in levels], S)
        p = _Pyramid(n_levels=len(levels), th_ini=th_ini, th_min=th_min)
        for k, (level, *row) in enumerate(rows):
            p.lv[k] = _Level(levels[level].data_ptr(), *row)
        out = torch.empty(size, dtype=torch.float32, device=levels[0].device)
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(p, n_tiles, S, out.data_ptr(), stream)
            capturing = torch.cuda.is_current_stream_capturing()
        if err != 0:
            raise RuntimeError(f"fast_score_pyramid_launch failed: "
                               f"cudaError_t {err}")
        if capturing:
            self.captured += 1
        else:
            self.launches += 1
        maps = out.split_with_sizes([g.numel() for g in levels
                                     for _ in range(2)])
        return [(maps[2 * k].view(g.shape), maps[2 * k + 1].view(g.shape))
                for k, g in enumerate(levels)]


KERNEL = FastScoreKernel()


def _check_levels(levels) -> None:
    if not levels or len(levels) > MAX_LEVELS:
        raise ValueError(f"fast_score_pyramid takes 1 to {MAX_LEVELS} "
                         f"levels, got {len(levels)}")
    lead = levels[0].shape[:-2]
    device = levels[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fast_score_pyramid runs on cuda or cpu, got "
                         f"{device}")
    for g in levels:
        shape = g.shape
        if g.dtype != torch.float32:
            raise TypeError(f"fast_score_pyramid wants float32, got "
                            f"{g.dtype}")
        if (len(shape) not in (2, 3) or shape[:-2] != lead
                or shape[-2] < 7 or shape[-1] < 7):
            raise ValueError(f"fast_score_pyramid wants levels (H, W) or "
                             f"(S, H, W), H, W >= 7, one S for all; got "
                             f"{tuple(shape)} after {tuple(lead)}")
        if not g.is_contiguous():
            raise ValueError("fast_score_pyramid wants contiguous levels")
        if g.device != device:
            raise ValueError(f"fast_score_pyramid wants all levels on one "
                             f"device, got {g.device} and {device}")


def fast_score_pyramid(levels: list[Tensor], th_ini: float, th_min: float):
    """FAST scores of each level at two thresholds.

    `levels` are contiguous fp32 tensors, all (H_l, W_l) or all
    (S, H_l, W_l) with one S, at most MAX_LEVELS of them.  Returns one
    (score_ini, score_min) pair per level, each of the level's shape with
    its 3 px border zeroed.  CUDA tensors: one kernel launch for all levels;
    the pairs are contiguous views of one allocation.  CPU tensors: the
    plain version.  Anything else raises.
    """
    _check_levels(levels)
    if levels[0].device.type == "cpu":
        from .fast import fast_score

        return [(fast_score(g, th_ini), fast_score(g, th_min))
                for g in levels]
    return KERNEL.launch(levels, th_ini, th_min)


def fast_score_pair(gray: Tensor, th_ini: float, th_min: float):
    """FAST scores of (S, H, W) or (H, W) fp32 gray at two thresholds: the
    one-level case of `fast_score_pyramid`."""
    return fast_score_pyramid([gray], th_ini, th_min)[0]
