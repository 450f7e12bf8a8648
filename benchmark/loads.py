"""The traffic kinds: one general generator per kind of load, driven by a
traffic file's parameters.  A cell names a configuration and a traffic
file; the file's "kind" picks the loop here.

- "drive" (closed loop): one drive of frames made from the seed, packed for
  the configuration's wire, fed to `System(cfg, mode="fused",
  enable_global_ba=False)`: warm frames through run_sequence, then the
  window, ONE run_sequence call over the rest of the drive, as a user runs
  one sequence.  Its length is --seconds times the file's planning_fps.  A
  traced run traces trace_frames frames in the middle of that same call.

Each kind returns a Run: what the end-to-end and per-layer metrics and the
reference read.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np

from . import scene as S
from .counting import pyramid_px
from .program import PackedFrame, outputs
from .trace import WindowTrace


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    e2e: dict = dataclasses.field(default_factory=dict)
    judged_frames: list = dataclasses.field(default_factory=list)
    outputs: dict | None = None
    memory_peak_bytes: int = 0
    # per-layer inputs
    trace: object = None
    trace_frames: int = 0
    probe: dict | None = None
    window_solve_ms: list = dataclasses.field(default_factory=list)
    fast_px: int = 0
    layout: object = None


class _Seq:
    """Frames start .. start + n - 1 as a dataset; `fetched(i)`, where
    given, hears of each fetch (the window's tracer)."""

    def __init__(self, frames, start, n, fetched=None):
        self.frames, self.start, self.n = frames, start, n
        self.fetched = fetched

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.fetched is not None:
            self.fetched(i)
        return self.frames[self.start + i]


def layout_for(cfg_file: dict, cfg, n_frames: int, seed: int):
    """The scene's layout for a drive of n_frames frames (one more is made:
    the last frame has no forward flow); the road runs on past the last
    frame by the world's usual length."""
    sc = cfg_file["scene"]
    F = n_frames + 1
    return S.make_layout(
        num_frames=F, width=cfg.camera.width, height=cfg.camera.height,
        fx=cfg.camera.fx, fy=cfg.camera.fy, seed=seed,
        road_extra=sc["cam_speed"] * F, **sc)


def window_frames(traffic: dict, seconds: float) -> tuple:
    """(warm frames, frames in the measured window) of a run."""
    period = int(traffic["frames_multiple"])
    n = max(period, int(round(seconds * traffic["planning_fps"]
                              / period)) * period)
    return int(traffic["warm_frames"]), n


def total_frames(traffic: dict, n: int) -> int:
    """Frames of a run's drive: warm frames, the window's n and the stage
    probe's one, whether the run traces or not, so that every run of a
    seed sees the same world."""
    return int(traffic["warm_frames"]) + n + 1


def traced_stretch(traffic: dict, n: int) -> tuple:
    """(first frame, frames) of the stretch a traced run traces, counted
    from the window's start: trace_frames frames that end at least
    frames_multiple frames before the window's end (the profiler runs on
    to the end of the call, but the stretch sees no flush), starting on a
    multiple of frames_multiple."""
    m = min(int(traffic["trace_frames"]), n)
    period = int(traffic["frames_multiple"])
    return max(n - m - period, 0) // period * period, m


def _rendered(lay, cfg, device, frames, block):
    """(frame ids, gray, raw depth, flow, mask) blocks on the device."""
    import torch

    R = S.Renderer(lay, device)
    tr = cfg.tracking
    for b0 in range(0, len(frames), block):
        fs = frames[b0:b0 + block]
        out = [R.frame(f) for f in fs]
        depth = torch.stack([o["depth"] for o in out])
        yield (fs, torch.stack([o["gray"] for o in out]),
               S.depth_raw(depth, tr.depth_map_factor, cfg.camera.bf),
               torch.stack([o["flow"] for o in out]),
               torch.stack([o["mask"] for o in out]))


def packed_frames(lay, cfg, device, n: int, block: int = 16) -> list:
    """Frames 0..n-1 on the configuration's entropy wire."""
    from .wire import pack_entropy

    tr = cfg.tracking
    if not (tr.entropy and tr.flow_down == 2 and tr.flow_delta):
        raise ValueError("the drive packs the entropy wire of flow_down 2 "
                         "with flow_delta only")
    out = []
    for fs, gray, draw, flow, mask in _rendered(lay, cfg, device,
                                                list(range(n)), block):
        buf = pack_entropy(gray, draw, flow, mask,
                           256.0 / tr.depth_map_factor, tr.wire_seg_cap,
                           tr.wire_depth_exc_cap).cpu().numpy()
        for j, f in enumerate(fs):
            out.append(PackedFrame(buf[j], lay.T_wc[f].astype(np.float32),
                                   S.obj_rows_kitti(lay, f), S.timestamp(f)))
    return out


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device) -> None:
    import torch

    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    import torch

    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def _failed(reps, expected: int) -> int:
    """Frames with no report or whose camera solve kept no inlier."""
    lost = sum(1 for r in reps if int(r.get("n_inlier_cam", 0)) <= 0)
    return max(expected - len(reps), 0) + lost


def _solve_failures(tracker, since: tuple) -> int:
    """Window solves since `since` = (failures, reports) that raised or
    reported a cost that is not finite."""
    return tracker.ba_failures - since[0] + sum(
        1 for h in tracker.ba_health[since[1]:]
        if not (np.isfinite(h["cost"]) and np.isfinite(h["cost0"])))


def drive(cfg_file, cfg, traffic, seed, seconds, trace, device, t_start):
    from vdo_slam_tpu_torch.pipeline import System

    warm, n = window_frames(traffic, seconds)
    total = total_frames(traffic, n)
    lay = layout_for(cfg_file, cfg, total, seed)
    t0 = time.perf_counter()
    frames = packed_frames(lay, cfg, device, total)
    log(f"drive: {total} frames rendered and packed in "
        f"{time.perf_counter() - t0:.3f} s")
    run = Run()
    _reset_peak(device)
    sysm = System(cfg, enable_local_ba=True, enable_global_ba=False,
                  mode="fused", device=device)
    sysm.run_sequence(_Seq(frames, 0, warm))
    _sync(device)
    run.setup_s = time.perf_counter() - t_start
    n_solves = len(sysm.map.lba_times)
    since = (sysm.tracker.ba_failures, len(sysm.tracker.ba_health))

    solves_before_trace = []
    tracer = (WindowTrace(*traced_stretch(traffic, n),
                          on_start=lambda: solves_before_trace.append(
                              len(sysm.map.lba_times)))
              if trace else None)
    t0 = time.perf_counter()
    reps = sysm.run_sequence(_Seq(frames, warm, n,
                                  tracer.fetched if tracer else None))
    run.window_s = time.perf_counter() - t0
    run.memory_peak_bytes = _peak(device)
    run.window_solve_ms = list(sysm.map.lba_times[n_solves:])
    if solves_before_trace:
        # a traced run: the solves that ended before the profiler started
        run.window_solve_ms = list(
            sysm.map.lba_times[n_solves:solves_before_trace[0]])
    run.attempted = n
    run.failed = _failed(reps, n) + _solve_failures(sysm.tracker, since)
    run.e2e["frames_per_s"] = n / run.window_s
    log(f"drive: {n} frames in {run.window_s:.6f} s, "
        f"{len(run.window_solve_ms)} window solves")
    run.judged_frames = list(range(warm, warm + n))
    if trace:
        t1 = time.perf_counter()
        run.trace = tracer.result()
        run.trace_frames = tracer.n
        log(f"traced stretch: frames {warm + tracer.first} to "
            f"{warm + tracer.first + tracer.n - 1} of the window's one "
            f"call, {run.trace.window_s:.6f} s "
            f"({tracer.n / run.trace.window_s:.3f} frames/s traced, "
            f"{n / run.window_s:.3f} over the whole window), "
            f"{len(run.trace.ops)} device operations recorded, read in "
            f"{time.perf_counter() - t1:.3f} s")
        t1 = time.perf_counter()
        probe = sysm.tracker.calibrate_stage_times(frames[warm + n])
        log(f"stage probe: {time.perf_counter() - t1:.3f} s")
        run.probe = {k: float(v) for k, v in probe.items()}
        fe = cfg.frontend
        run.fast_px = pyramid_px(cfg.camera.height, cfg.camera.width,
                                 fe.n_levels, fe.scale_factor)
    run.outputs = outputs(sysm, lay.num_frames)
    run.layout = lay
    return run


KINDS = {"drive": drive}
