"""The traffic kind "room" (closed loop): one hand-held sequence in the
indoor world of benchmark/scene_room.py (boxes swinging on strings before
a swaying camera), made from the seed, packed for the configuration's
wire and fed to `System(cfg, mode="fused", enable_global_ba=False)`: warm
frames through run_sequence, then the window, ONE run_sequence call over
the rest of the sequence, as a user replays one recorded sequence.  Its
length is --seconds times the file's planning_fps.  Each frame carries its
ground-truth camera pose and its object rows in the Oxford Multimotion
encoding (scene_room.obj_rows_ox), which the program parses as the
configuration's dataset (ChooseData 1) asks.

The depth plane is packed at the configuration's own scale,
wire_depth_steps steps per pixel of disparity, so that the nearest box
comes through the wire exactly.

A traced run records the program's spans and counters over the window
(utils/profiling.py: the wire's depth exceptions per frame, the objects
with a motion estimate, the grid samples taken into the static bank;
logged), traces trace_frames frames in the middle of that same call, then
runs the stage probe.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from benchmark import loads
from benchmark import scene as S
from benchmark import scene_room as R
from benchmark.loads import log


def layout_for(cfg_file, cfg, n_frames: int, seed: int) -> R.RoomLayout:
    """The room for a sequence of n_frames frames (one more is made: the
    last frame has no forward flow)."""
    c = cfg.camera
    return R.make_layout(num_frames=n_frames + 1, width=c.width,
                         height=c.height, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
                         fps=c.fps, seed=seed, **cfg_file["scene"])


def worlds(cfg_file, cfg, traffic, seed, seconds) -> list:
    """The one stream: the room from the seed, judged over the window's
    frames."""
    warm, n = loads.window_frames(traffic, seconds)
    lay = layout_for(cfg_file, cfg, loads.total_frames(traffic, n), seed)
    return [loads.Stream(lay, list(range(warm, warm + n)))]


def packed_frames(lay: R.RoomLayout, cfg, device, n: int,
                  block: int = 16) -> list:
    """Frames 0..n-1 on the configuration's entropy wire, the depth plane
    at wire_depth_steps steps per unit of raw / depth_map_factor."""
    import torch

    from benchmark.wire import pack_entropy

    tr = cfg.tracking
    if not (tr.entropy and tr.flow_down == 2 and tr.flow_delta):
        raise ValueError("the room packs the entropy wire of flow_down 2 "
                         "with flow_delta only")
    scale = tr.wire_depth_steps / tr.depth_map_factor
    rend = R.Renderer(lay, device)
    out = []
    for b0 in range(0, n, block):
        fs = list(range(b0, min(b0 + block, n)))
        frames = [rend.frame(f) for f in fs]
        depth = torch.stack([o["depth"] for o in frames])
        buf = pack_entropy(
            torch.stack([o["gray"] for o in frames]),
            S.depth_raw(depth, tr.depth_map_factor, cfg.camera.bf),
            torch.stack([o["flow"] for o in frames]),
            torch.stack([o["mask"] for o in frames]), scale,
            tr.wire_seg_cap, tr.wire_depth_exc_cap).cpu().numpy()
        for j, f in enumerate(fs):
            out.append(loads.PackedFrame(
                buf[j], lay.T_wc[f].astype(np.float32), R.obj_rows_ox(lay, f),
                R.timestamp(lay, f)))
    return out


def _counted(rec, name: str) -> str:
    vals = [float(c.value) for c in rec.counted(name)]
    if not vals:
        return f"{name} none"
    return (f"{name} mean {np.mean(vals):.3f} min {min(vals):.0f} max "
            f"{max(vals):.0f} over {len(vals)}")


def run(cfg_file, cfg, traffic, seed, seconds, trace, device, t_start):
    from vdo_slam_tpu_torch.pipeline import System
    from vdo_slam_tpu_torch.utils import profiling

    warm, n = loads.window_frames(traffic, seconds)
    total = loads.total_frames(traffic, n)
    (stream,) = worlds(cfg_file, cfg, traffic, seed, seconds)
    lay = stream.layout
    log(f"room: {lay.num_objects} boxes, largest rotation "
        f"{lay.max_rotation_deg():.4f} deg a frame, nearest box corner "
        f"{lay.min_depth():.4f} m, {lay.params}")
    t0 = time.perf_counter()
    frames = packed_frames(lay, cfg, device, total)
    log(f"room: {total} frames rendered and packed in "
        f"{time.perf_counter() - t0:.3f} s")
    run = loads.Run()
    loads._reset_peak(device)
    sysm = System(cfg, enable_local_ba=True, enable_global_ba=False,
                  mode="fused", device=device)
    sysm.run_sequence(loads._Seq(frames, 0, warm))
    loads._sync(device)
    run.setup_s = time.perf_counter() - t_start
    n_solves = len(sysm.map.lba_times)
    since = (sysm.tracker.ba_failures, len(sysm.tracker.ba_health))

    solves_before_trace = []
    tracer = (loads.WindowTrace(*loads.traced_stretch(traffic, n),
                                on_start=lambda: solves_before_trace.append(
                                    len(sysm.map.lba_times)))
              if trace else None)
    with (profiling.recording() if trace
          else contextlib.nullcontext()) as rec:
        t0 = time.perf_counter()
        reps = sysm.run_sequence(loads._Seq(
            frames, warm, n, tracer.fetched if tracer else None))
        run.window_s = time.perf_counter() - t0
    run.memory_peak_bytes = loads._peak(device)
    run.window_solve_ms = list(sysm.map.lba_times[n_solves:])
    if solves_before_trace:
        # a traced run: the solves that ended before the profiler started
        run.window_solve_ms = list(
            sysm.map.lba_times[n_solves:solves_before_trace[0]])
    run.attempted = n
    run.failed = (loads._failed(reps, n)
                  + loads._solve_failures(sysm.tracker, since))
    run.e2e["frames_per_s"] = n / run.window_s
    log(f"room: {n} frames in {run.window_s:.6f} s, "
        f"{len(run.window_solve_ms)} window solves")
    if trace:
        log("room counters: " + "; ".join(
            _counted(rec, name) for name in
            ("wire.depth_exc", "fused.obj_active", "fused.sample_kp")))
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
    stream.outputs = loads.outputs(sysm, lay.num_frames)
    run.streams = [stream]
    return run
