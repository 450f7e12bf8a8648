#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, in order (any failure raises and exits nonzero):
  1. the card's name and power limit (nvidia-smi); no GPU -> exit 1;
  2. build the FAST-9/16 CUDA kernel from vdo_slam_tpu_torch/csrc;
  3. the kernel against its plain PyTorch version on the card, atol=0:
     one-level launches on binary test images, each pyramid level of a
     1242x375 synthetic frame and a batch of 3; then one launch for the
     whole 8-level pyramid of that frame, and of frames 0-2 (S=3), level
     by level.  Then the pyramid's device time (torch.profiler) and event
     time per frame against its bound, the plain version's, the compass
     test's pass shares, and per-level times;
  4. the main path: System(mode="fused", device="cuda").run_sequence over
     the bench scene cut to 25 tracked frames (make_scene(num_frames=26,
     1242x375, 3 objects, seed 7); the dataset tracks num_frames - 1), with
     the bench config, lm_iters 10 / lm_iters_obj 6 and BA off.  Checks:
     25 frames reported, one kernel launch per frame, finite poses, and
     accuracy within the gates below against the JAX package's numbers.
The line before the last holds the kernels' JSON record, the one before it
the card as nvidia-smi reports it; the last line is the device JSON.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# The JAX package's numbers for the same 25 frames and config, taken by
# running vdo_slam_tpu's System(cfg, enable_local_ba=False,
# enable_global_ba=False, mode="fused").run_sequence on the CPU (JAX 0.9.0,
# JAX_PLATFORMS=cpu), with the scene and config that `main_path` builds.
JAX_REF = {
    "cam_t_rpe": 0.0002617016249354637,
    "cam_r_rpe_deg": 0.00022229936464838678,
    "obj_t_rpe": 0.0004971564036774604,
    "obj_r_rpe_deg": 0.0061579478500530865,
    "n_obj_estimates": 48,
}
# A metric passes if it is within 2x the JAX number or under this floor,
# whichever is looser.
ABS_FLOOR = {"cam_t_rpe": 1e-3, "cam_r_rpe_deg": 0.01, "obj_t_rpe": 5e-3,
             "obj_r_rpe_deg": 0.05}
N_FRAMES = 25
W, H = 1242, 375
TH_INI, TH_MIN = 20 / 255.0, 7 / 255.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12     # H100 SXM data sheet, fp32 outside tensor cores
# fp32 operations of the kernel (csrc/fast_score.cu): each interior pixel
# 4 subtractions, 8 compass compares and 2 output compares; each entry of
# the bright list 16 subtractions, 80 min/max for the 16 arcs and 1 compare;
# a dark entry also 16 negations.
OPS_PER_PIXEL, OPS_PER_BRIGHT, OPS_PER_DARK = 14, 97, 113


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_scene(num_frames: int = N_FRAMES + 1, width: int = W,
                height: int = H):
    from vdo_slam_tpu_torch.io.synthetic import make_scene

    return make_scene(num_frames=num_frames, width=width, height=height,
                      num_objects=3, fx=721.5377, seed=7)


def bench_config(width: int = W, height: int = H):
    """bench.py's config (bench.py:262-284) with tpu_fast's LM budgets and
    no wire flags; the backend capacities do not matter with BA off."""
    from vdo_slam_tpu_torch.config import (KITTI, ShapeConfig, TrackingConfig,
                                           VDOConfig)

    cfg = VDOConfig()
    return cfg.replace(
        camera=dataclasses.replace(
            cfg.camera, fx=721.5377, fy=721.5377, cx=width / 2.0,
            cy=height / 2.0, width=width, height=height, bf=387.5744),
        tracking=dataclasses.replace(TrackingConfig(), dataset=KITTI,
                                     depth_map_factor=256.0),
        shapes=ShapeConfig(),
        solver=dataclasses.replace(cfg.solver, lm_iters=10, lm_iters_obj=6),
    )


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int = 5, match: str | None = None,
               between=None) -> float:
    """Device time of fn per call: the sum of its kernels' durations under
    torch.profiler (CUDA activity only), without the host's launch cost.
    `between` runs before each call (an L2 flush); `match` keeps only the
    kernels whose name holds it, so the flush is not counted."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if between is not None:
                between()
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if match is None or match in e.key)
    return us / reps / 1e3


def compass_shares(levels, t: float):
    """Per level (bright, dark, listed, interior, active warps, warps): the
    interior pixels that the kernel's compass test at t puts on its bright
    list, on its dark list, and on either (the others leave after 5 loads);
    and the warps (32-pixel row segments of a tile) that hold a listed
    pixel, all of which would run the arc code without the lists."""
    out = []
    for g in levels:
        Hl, Wl = g.shape
        c = g[3:Hl - 3, 3:Wl - 3]
        comp = [g[3 + dy:Hl - 3 + dy, 3 + dx:Wl - 3 + dx] - c
                for dx, dy in ((0, -3), (3, 0), (0, 3), (-3, 0))]
        bright = torch.zeros_like(c, dtype=torch.bool)
        dark = torch.zeros_like(bright)
        for i in range(4):
            a, b = comp[i], comp[(i + 1) % 4]
            bright |= (a > t) & (b > t)
            dark |= (a < -t) & (b < -t)
        listed = bright | dark
        full = torch.zeros((Hl, -(-Wl // 32) * 32), dtype=torch.bool,
                           device=g.device)
        full[3:Hl - 3, 3:Wl - 3] = listed
        warps = full.view(Hl, -1, 32).any(-1)
        out.append((int(bright.sum()), int(dark.sum()), int(listed.sum()),
                    c.numel(), int(warps.sum()), warps.numel()))
    return out


def _pyramids(scene, device, frames):
    from vdo_slam_tpu_torch.ops import fast

    return [fast.pyramid(torch.from_numpy(scene.rgb[f]).to(device), 8, 1.2)
            for f in frames]


def check_kernel(scene, device) -> float:
    """Phase 3a: kernel == plain version (atol=0), one level per launch and
    one launch per pyramid.  Returns the largest abs error seen."""
    from vdo_slam_tpu_torch.ops import fast
    from vdo_slam_tpu_torch.ops.fast_cuda import (KERNEL, fast_score_pair,
                                                  fast_score_pyramid)

    rng0, rng1, rng2 = (np.random.default_rng(s) for s in (0, 1, 2))
    cases = [
        ("binary 120x200", (rng0.random((120, 200)) > 0.5), TH_INI, TH_MIN),
        ("binary 97x131", (rng1.random((97, 131)) > 0.5), 15 / 255.0,
         TH_MIN),
        ("binary batch 3x64x150", (rng2.random((3, 64, 150)) > 0.5), TH_INI,
         TH_MIN),
    ]
    levels = _pyramids(scene, device, [0])[0]
    cases += [(f"level {l} {tuple(g.shape)}", g, TH_INI, TH_MIN)
              for l, g in enumerate(levels)]
    cases.append(("frames 0-2 batched S=3",
                  torch.from_numpy(np.ascontiguousarray(scene.rgb[:3])),
                  TH_INI, TH_MIN))

    def held(name, img, k_ini, k_min, ti, tm) -> float:
        p_ini, p_min = fast.fast_score(img, ti), fast.fast_score(img, tm)
        err = max(float((k_ini - p_ini).abs().max()),
                  float((k_min - p_min).abs().max()))
        if not (torch.equal(k_ini, p_ini) and torch.equal(k_min, p_min)):
            raise RuntimeError(f"{name}: kernel != plain, max abs err {err}")
        nz = float((p_min > 0).float().mean())
        print(f"kernel == plain (atol=0): {name}, corner share {nz:.4f}")
        return err

    max_err = 0.0
    for name, img, ti, tm in cases:
        g = (img if torch.is_tensor(img)
             else torch.from_numpy(img.astype(np.float32))).to(device)
        before = KERNEL.launches
        k_ini, k_min = fast_score_pair(g, ti, tm)
        torch.cuda.synchronize()
        if KERNEL.launches != before + 1:
            raise RuntimeError(f"{name}: launch counter did not go up")
        max_err = max(max_err, held(name, g, k_ini, k_min, ti, tm))

    batch = [torch.stack(lv).contiguous()
             for lv in zip(*_pyramids(scene, device, [0, 1, 2]))]
    for what, lv in (("frame 0", levels), ("frames 0-2 S=3", batch)):
        before = KERNEL.launches
        pairs = fast_score_pyramid(lv, TH_INI, TH_MIN)
        torch.cuda.synchronize()
        if KERNEL.launches != before + 1:
            raise RuntimeError(f"pyramid of {what}: "
                               f"{KERNEL.launches - before} launches, want 1")
        for l, (g, (k_ini, k_min)) in enumerate(zip(lv, pairs)):
            max_err = max(max_err, held(
                f"one launch for the pyramid of {what}, level {l} "
                f"{tuple(g.shape)}", g, k_ini, k_min, TH_INI, TH_MIN))
    return max_err


def time_pyramid(scene, device, card: str, reps: int = 20) -> dict:
    """Phase 3b: the 8-level pyramid of frame 0, per frame: the kernel (one
    launch) and the plain version (two fast_score calls per level), device
    and event time, against the kernel's bound; what the compass test lets
    through; one-level launches per level."""
    from vdo_slam_tpu_torch.ops import fast
    from vdo_slam_tpu_torch.ops.fast_cuda import (fast_score_pair,
                                                  fast_score_pyramid)

    levels = _pyramids(scene, device, [0])[0]
    n_px = sum(g.numel() for g in levels)
    shares = compass_shares(levels, min(TH_INI, TH_MIN))
    n_bright, n_dark, n_listed, n_interior, n_warp, n_warps = (
        sum(r[k] for r in shares) for k in range(6))
    byte_ms = 12.0 * n_px / HBM_BYTES_PER_S * 1e3
    ops_ms = ((OPS_PER_PIXEL * n_interior + OPS_PER_BRIGHT * n_bright
               + OPS_PER_DARK * n_dark) / FP32_OPS_PER_S * 1e3)
    bound_ms = max(byte_ms, ops_ms)
    bound_by = "bytes" if byte_ms >= ops_ms else "operations"

    def kernel():
        return fast_score_pyramid(levels, TH_INI, TH_MIN)

    def plain():
        return [(fast.fast_score(g, TH_INI), fast.fast_score(g, TH_MIN))
                for g in levels]

    # a process's first profiler session has read kernel times longer than
    # the sessions after it: spend it on something else
    _device_ms(lambda: torch.ones(4, device=device) + 1)
    # kernel, plain, plain, kernel: each side once early and once late
    ev = {"kernel": [], "plain": []}
    dev = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        fn = kernel if name == "kernel" else plain
        ev[name].append(_time_ms(fn, reps))
        dev[name].append(_device_ms(fn, 20 if name == "kernel" else 5))
    k_ev, k_dev = min(ev["kernel"]), min(dev["kernel"])
    p_ev, p_dev = min(ev["plain"]), min(dev["plain"])
    # reading 64 MB (> the 50 MB L2) evicts the levels and leaves no dirty
    # lines for the kernel to write back
    flush = torch.ones(64 * 2**20 // 4, device=device)
    cold = _device_ms(kernel, match="fast_pyramid",
                      between=lambda: flush.sum())
    flat = [torch.full_like(g, 0.5) for g in levels]
    flat_ms = _device_ms(lambda: fast_score_pyramid(flat, TH_INI, TH_MIN))

    def runs(xs):
        return ", ".join(f"{x:.5f}" for x in xs)

    print(f"pyramid of 8 levels per frame ({n_px} px), one launch: "
          f"{k_dev:.5f} ms on the device (profiler; runs "
          f"{runs(dev['kernel'])}), {k_ev:.5f} ms by CUDA events over "
          f"{reps} back-to-back calls, host call included (runs "
          f"{runs(ev['kernel'])}) [{card}]")
    print(f"pyramid bound: {bound_ms * 1e3:.3f} us by {bound_by} (12 B/px "
          f"at {HBM_BYTES_PER_S / 1e12} TB/s: {byte_ms * 1e3:.3f} us; fp32 "
          f"operations of this frame at {FP32_OPS_PER_S / 1e12} TFLOP/s: "
          f"{ops_ms * 1e3:.3f} us); share of the bound reached "
          f"{bound_ms / k_dev:.3f} [{card}]")
    print(f"pyramid with the L2 flushed (read) before each call: "
          f"{cold:.5f} ms on "
          f"the device; flat image (every pixel leaves at the compass "
          f"test): {flat_ms:.5f} ms [{card}]")
    print(f"plain version per frame: {p_dev:.5f} ms on the device (runs "
          f"{runs(dev['plain'])}), {p_ev:.5f} ms by CUDA events [{card}]")
    print(f"compass test at min(th_ini, th_min): {n_listed / n_interior:.4f}"
          f" of interior pixels listed ({n_bright} bright, {n_dark} dark "
          f"entries), {n_warp / n_warps:.4f} of warps hold one")
    for l, (g, row) in enumerate(zip(levels, shares)):
        one = _device_ms(lambda: fast_score_pair(g, TH_INI, TH_MIN))
        lv_bound = 12.0 * g.numel() / HBM_BYTES_PER_S * 1e6
        print(f"level {l} {tuple(g.shape)}: one-level launch {one:.5f} ms on "
              f"the device, byte bound {lv_bound:.3f} us; listed "
              f"{row[2] / row[3]:.4f} of pixels, {row[4] / row[5]:.4f} of "
              f"warps [{card}]")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(f"after timing, clocks.sm, clocks.max.sm, power.draw, "
          f"temperature.gpu: {clocks.stdout.strip()}")
    return {"ms": k_dev, "plain_ms": p_dev, "bound_ms": bound_ms,
            "bound_by": bound_by}


class _Timed:
    """Dataset view that notes when each frame is requested."""

    def __init__(self, base, n):
        self.base, self.n, self.t = base, n, {}

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.t[i] = time.perf_counter()
        return self.base[i]


def main_path(scene, cfg, device, card: str) -> dict:
    """Phase 4: the port's System over the 25-frame bench scene."""
    from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL
    from vdo_slam_tpu_torch.pipeline import System

    ds = _Timed(SyntheticDataset(scene, depth_map_factor=256.0, bf=387.5744),
                N_FRAMES)
    sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  mode="fused", device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KERNEL.launches = 0
    reports = sysm.run_sequence(ds)
    t_end = time.perf_counter()
    launches = KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    fps = (N_FRAMES - 3) / (t_end - ds.t[3])
    print(f"tracking fps after 3 warm frames: {fps:.3f} ({N_FRAMES - 3} "
          f"frames, host clock, inputs staged per frame) [{card}]")
    print(f"peak device memory (max_memory_allocated): {peak} bytes "
          f"({peak / 2**20:.1f} MiB) [{card}]")
    if len(reports) != N_FRAMES:
        raise RuntimeError(f"{len(reports)} frames reported, want {N_FRAMES}")
    if launches != N_FRAMES:
        raise RuntimeError(f"{launches} FAST kernel launches, want "
                           f"{N_FRAMES}, one per frame")
    if not all(np.isfinite(r["T_cw"]).all() for r in reports):
        raise RuntimeError("non-finite pose in a report")
    print(f"main path: {len(reports)} frames, {launches} FAST kernel "
          f"launches")
    rep = sysm.metrics()
    print(f"port metrics: {json.dumps(rep)}")
    print(f"JAX metrics:  {json.dumps(JAX_REF)}")
    for k, floor in ABS_FLOOR.items():
        bound = max(2.0 * JAX_REF[k], floor)
        if not (math.isfinite(rep[k]) and rep[k] <= bound):
            raise RuntimeError(f"{k} = {rep[k]} above {bound}")
        print(f"gate {k}: {rep[k]:.6g} <= {bound:.6g}")
    need = 0.9 * JAX_REF["n_obj_estimates"]
    if rep["n_obj_estimates"] < need:
        raise RuntimeError(f"n_obj_estimates {rep['n_obj_estimates']} < "
                           f"{need}")
    print(f"gate n_obj_estimates: {rep['n_obj_estimates']} >= {need}")
    return {"launches": launches, "fps": fps, "peak_bytes": peak,
            "metrics": rep}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on a GPU only", file=sys.stderr)
        return 1
    try:
        import vdo_slam_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from the "
              f"repository root", file=sys.stderr)
        return 1
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL

    card = card_line()
    print(f"card: {card}")
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    device = torch.device("cuda", 0)

    KERNEL.build()
    print(f"FAST kernel built and loaded in {KERNEL.build_seconds:.2f} s")
    for line in KERNEL.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

    t0 = time.perf_counter()
    scene = bench_scene()
    print(f"scene: {scene.rgb.shape} made in {time.perf_counter() - t0:.1f} s")
    max_err = check_kernel(scene, device)
    kern = time_pyramid(scene, device, card)
    path = main_path(scene, bench_config(), device, card)

    print(json.dumps({"kernels": [{
        "name": "fast_score_pyramid",
        "route": "cuda",
        "source": "vdo_slam_tpu_torch/csrc/fast_score.cu",
        "replaces": "vdo_slam_tpu/ops/fast_pallas.py:37",
        "launches": path["launches"],
        "launches_per_frame": path["launches"] / N_FRAMES,
        "max_abs_err": max_err,
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
