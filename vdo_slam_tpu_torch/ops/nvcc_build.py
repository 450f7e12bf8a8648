"""Build a CUDA source of the package into a shared library at first use.

The hand-written kernels (csrc/*.cu) have plain C interfaces and are bound
with ctypes.  Each is compiled by nvcc, on the machine with the card, into
`vdo_slam_tpu_torch/_build/lib<stem>_<hash>.so`, the hash taken over the
source and the flags, so that an edited source or flag rebuilds; a library
already there is loaded as it is.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# every library's flags: sm_90a (the H100), a plain C interface, and
# ptxas's register and spill report in nvcc's output
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built from source at first use")


def library_path(source: Path, flags, stem: str) -> Path:
    """Where the library of `source` built with `flags` lies."""
    digest = hashlib.sha1(source.read_bytes()
                          + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{stem}_{digest[:12]}.so"


def build_library(source: Path, flags, stem: str) -> tuple[Path, str]:
    """(the library's path, nvcc's output): compiled where the library is
    missing (written under a temporary name, then renamed, so that two
    processes never load a half-written file), else '' for the output.
    Raises RuntimeError with nvcc's output if it fails."""
    lib_path = library_path(source, flags, stem)
    if lib_path.exists():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc(), *flags, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib_path, log
