#!/usr/bin/env python3
"""Time the phases of the FAST-9/16 pyramid kernel on one NVIDIA GPU.

    python3 chip_fast_phases.py      # from the repository root; needs one GPU

Builds cut-down copies of vdo_slam_tpu_torch/csrc/fast_score.cu, each
missing one phase, and times each against the kernel as built on the 8-level
pyramid of the bench frame (1242x375, seed 7), on a flat image (every pixel
leaves at the compass test) and on a batch of 4 frames.  The differences say
what each phase costs; the batch says whether the time scales with the work
(throughput) or not (latency).  Only the kernel as built is checked against
the plain version: the cut-down copies compute something else.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

# text of the source -> what replaces it, per cut-down copy
CUTS = {
    "as built": [],
    "no arcs (phase 2 skipped)": [
        ("  for (int k = tid; k < n_all; k += THREADS) {",
         "  for (int k = tid; k < 0; k += THREADS) {")],
    "no compass test, no arcs (load and write only)": [
        ("    if (x_in && y >= R && y < H - R) {",
         "    if (y < 0) {")],
    "launch only (return after the level lookup)": [
        ("  const int tid = threadIdx.y * TILE + lane;\n",
         "  const int tid = threadIdx.y * TILE + lane;\n"
         "  if (p.n_levels > 0) return;\n")],
}


def build(source: str, cuts, out_dir: Path, name: str):
    from vdo_slam_tpu_torch.ops import fast_cuda as fc

    for old, new in cuts:
        if old not in source:
            raise RuntimeError(f"{name}: the source no longer holds {old!r}")
        source = source.replace(old, new)
    cu = out_dir / f"{name}.cu"
    so = out_dir / f"lib{name}.so"
    cu.write_text(source)
    subprocess.run([fc._nvcc(), *fc.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    kernel = fc.FastScoreKernel()
    kernel._lib = ctypes.CDLL(str(so))
    kernel._fn = kernel._lib.fast_score_pyramid_launch
    kernel._fn.argtypes = [fc._Pyramid, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p]
    kernel._fn.restype = ctypes.c_int
    return kernel


def device_us(fn, reps: int = 30) -> float:
    """Kernel time per call under torch.profiler, FAST kernel only."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if "fast_pyramid" in e.key) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_fast_phases: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import TH_INI, TH_MIN, bench_scene, card_line
    from vdo_slam_tpu_torch.ops import fast
    from vdo_slam_tpu_torch.ops.fast_cuda import _SOURCE

    card = card_line()
    dev = torch.device("cuda", 0)
    rgb = bench_scene(num_frames=4).rgb
    per_frame = [fast.pyramid(torch.from_numpy(f).to(dev), 8, 1.2)
                 for f in rgb]
    inputs = {"bench frame": per_frame[0],
              "flat image": [torch.full_like(g, 0.5) for g in per_frame[0]],
              "4 frames (S=4)": [torch.stack(lv).contiguous()
                                 for lv in zip(*per_frame)]}
    with tempfile.TemporaryDirectory() as tmp:
        kernels = {name: build(_SOURCE.read_text(), cuts, Path(tmp), f"v{i}")
                   for i, (name, cuts) in enumerate(CUTS.items())}
        built = kernels["as built"]
        pairs = built.launch(per_frame[0], TH_INI, TH_MIN)
        for g, (s_ini, s_min) in zip(per_frame[0], pairs):
            if not (torch.equal(s_ini, fast.fast_score(g, TH_INI))
                    and torch.equal(s_min, fast.fast_score(g, TH_MIN))):
                raise RuntimeError("the kernel as built != plain version")
        device_us(lambda: torch.ones(4, device=dev) + 1)  # profiler start-up
        times = {name: {k: [] for k in inputs} for name in kernels}
        order = list(kernels) + list(kernels)[::-1]
        for name in order:
            for what, lv in inputs.items():
                times[name][what].append(device_us(
                    lambda: kernels[name].launch(lv, TH_INI, TH_MIN)))
    for name, row in times.items():
        cells = "; ".join(
            f"{what} {min(v):.2f} us (runs {', '.join(f'{x:.2f}' for x in v)})"
            for what, v in row.items())
        print(f"{name}: {cells} [{card}]")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
