#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, in order (any failure raises and exits nonzero):
  1. the card's name and power limit (nvidia-smi); no GPU -> exit 1;
  2. build the FAST-9/16 CUDA kernel from vdo_slam_tpu_torch/csrc;
  3. the kernel against its plain PyTorch version on the card, atol=0:
     binary test images, all 8 pyramid levels of a 1242x375 synthetic
     frame, and a batch of 3; then per-level times (CUDA events);
  4. the main path: System(mode="fused", device="cuda").run_sequence over
     the bench scene cut to 25 tracked frames (make_scene(num_frames=26,
     1242x375, 3 objects, seed 7); the dataset tracks num_frames - 1), with
     the bench config, lm_iters 10 / lm_iters_obj 6 and BA off.  Checks:
     25 frames reported, 8 x 25 kernel launches, finite poses, and accuracy
     within the gates below against the JAX package's numbers.
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


def _device_ms(fn, reps: int = 5) -> float:
    """Device time of fn per call: the sum of its kernels' durations under
    torch.profiler (CUDA activity only), without the host's launch cost."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    return us / reps / 1e3


def check_kernel(scene, device, card: str, reps: int = 20) -> dict:
    """Phase 3: kernel == plain version (atol=0), then per-level times."""
    from vdo_slam_tpu_torch.ops import fast
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL, fast_score_pair

    th_ini, th_min = 20 / 255.0, 7 / 255.0
    rng0, rng1, rng2 = (np.random.default_rng(s) for s in (0, 1, 2))
    cases = [
        ("binary 120x200", (rng0.random((120, 200)) > 0.5), th_ini, th_min),
        ("binary 97x131", (rng1.random((97, 131)) > 0.5), 15 / 255.0, th_min),
        ("binary batch 3x64x150", (rng2.random((3, 64, 150)) > 0.5), th_ini,
         th_min),
    ]
    gray0 = torch.from_numpy(scene.rgb[0]).to(device)
    levels = fast.pyramid(gray0, 8, 1.2)
    cases += [(f"level {l} {tuple(g.shape)}", g, th_ini, th_min)
              for l, g in enumerate(levels)]
    cases.append(("frames 0-2 batched S=3",
                  torch.from_numpy(np.ascontiguousarray(scene.rgb[:3])),
                  th_ini, th_min))
    max_err = 0.0
    for name, img, ti, tm in cases:
        g = (img if torch.is_tensor(img)
             else torch.from_numpy(img.astype(np.float32))).to(device)
        before = KERNEL.launches
        k_ini, k_min = fast_score_pair(g, ti, tm)
        torch.cuda.synchronize()
        if KERNEL.launches != before + 1:
            raise RuntimeError(f"{name}: launch counter did not go up")
        p_ini, p_min = fast.fast_score(g, ti), fast.fast_score(g, tm)
        err = max(float((k_ini - p_ini).abs().max()),
                  float((k_min - p_min).abs().max()))
        if not (torch.equal(k_ini, p_ini) and torch.equal(k_min, p_min)):
            raise RuntimeError(f"{name}: kernel != plain, max abs err {err}")
        nz = float((p_min > 0).float().mean())
        print(f"kernel == plain (atol=0): {name}, corner share {nz:.4f}")
        max_err = max(max_err, err)

    ev = {"kernel": 0.0, "plain": 0.0}
    dev = {"kernel": 0.0, "plain": 0.0}
    for l, g in enumerate(levels):
        fns = {"kernel": lambda: fast_score_pair(g, th_ini, th_min),
               "plain": lambda: (fast.fast_score(g, th_ini),
                                 fast.fast_score(g, th_min))}
        row = {}
        for name, fn in fns.items():
            row[name] = (_time_ms(fn, reps), _device_ms(fn))
            ev[name] += row[name][0]
            dev[name] += row[name][1]
        print(f"level {l} {tuple(g.shape)}: kernel {row['kernel'][0]:.4f} ms "
              f"per call by CUDA events ({reps} calls, host launch cost "
              f"included), {row['kernel'][1]:.4f} ms on the device; plain "
              f"{row['plain'][0]:.4f} ms / {row['plain'][1]:.4f} ms [{card}]")
    print(f"pyramid of 8 levels per frame: kernel {ev['kernel']:.4f} ms "
          f"(events) {dev['kernel']:.4f} ms (device); plain "
          f"{ev['plain']:.4f} ms (events) {dev['plain']:.4f} ms (device) "
          f"[{card}]")
    if dev["kernel"] <= 0.0:
        raise RuntimeError("the profiler saw no device time for the kernel")
    return {"max_abs_err": max_err, "ms": dev["kernel"],
            "plain_ms": dev["plain"]}


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
    if launches != 8 * N_FRAMES:
        raise RuntimeError(f"{launches} FAST kernel launches, want "
                           f"{8 * N_FRAMES}")
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
    kern = check_kernel(scene, device, card)
    path = main_path(scene, bench_config(), device, card)

    print(json.dumps({"kernels": [{
        "name": "fast_score_pair",
        "route": "cuda",
        "source": "vdo_slam_tpu_torch/csrc/fast_score.cu",
        "replaces": "vdo_slam_tpu/ops/fast_pallas.py:37",
        "launches": path["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
