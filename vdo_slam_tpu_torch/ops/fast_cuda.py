"""Wrapper of the FAST-9/16 CUDA kernel (csrc/fast_score.cu).

`fast_score_pair(gray, th_ini, th_min)` returns the corner score maps at
two thresholds.  For a CUDA tensor it launches the hand-written kernel (one
launch per call, blockIdx.z over the leading stream axis) or raises; for a
CPU tensor it runs the plain PyTorch version, `ops.fast.fast_score`, once
per threshold.  The kernel replaces the Pallas kernel
vdo_slam_tpu/ops/fast_pallas.py:_fast_kernel.

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
    (the CPU path does not count).  `build_seconds` and `build_log` (nvcc's
    -Xptxas -v report) are filled when this process built or loaded the
    library.
    """

    def __init__(self):
        self.launches = 0
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
        t0 = time.perf_counter()
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
        fn = lib.fast_score_pair_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self._lib = lib
        self._fn = fn
        self.build_seconds = time.perf_counter() - t0
        return fn

    def launch(self, gray: Tensor, th_ini: float, th_min: float):
        """Launch on the current stream of gray's device; no sync."""
        fn = self.build()
        S, H, W = gray.shape
        out_ini = torch.empty_like(gray)
        out_min = torch.empty_like(gray)
        with torch.cuda.device(gray.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(gray.data_ptr(), out_ini.data_ptr(), out_min.data_ptr(),
                     S, H, W, th_ini, th_min, stream)
        if err != 0:
            raise RuntimeError(f"fast_score_pair_launch failed: cudaError_t "
                               f"{err}")
        self.launches += 1
        return out_ini, out_min


KERNEL = FastScoreKernel()


def fast_score_pair(gray: Tensor, th_ini: float, th_min: float):
    """FAST scores of (S, H, W) or (H, W) fp32 gray at two thresholds.

    Returns (score_ini, score_min), each gray's shape, 3 px border zeroed.
    CUDA tensor: the kernel.  CPU tensor: the plain version.  Anything else
    raises.
    """
    if gray.dtype != torch.float32:
        raise TypeError(f"fast_score_pair wants float32, got {gray.dtype}")
    if gray.ndim not in (2, 3):
        raise ValueError(f"fast_score_pair wants (H, W) or (S, H, W), got "
                         f"{tuple(gray.shape)}")
    if gray.shape[-2] < 7 or gray.shape[-1] < 7:
        raise ValueError(f"fast_score_pair wants H, W >= 7, got "
                         f"{tuple(gray.shape)}")
    if not gray.is_contiguous():
        raise ValueError("fast_score_pair wants a contiguous tensor")
    if gray.device.type == "cpu":
        from .fast import fast_score

        return fast_score(gray, th_ini), fast_score(gray, th_min)
    if gray.device.type != "cuda":
        raise ValueError(f"fast_score_pair runs on cuda or cpu, got "
                         f"{gray.device}")
    s_ini, s_min = KERNEL.launch(gray.reshape((-1,) + gray.shape[-2:]),
                                 th_ini, th_min)
    return s_ini.reshape(gray.shape), s_min.reshape(gray.shape)
