"""The traffic kind "drive" (closed loop): one drive of frames made from the
seed, packed for the configuration's wire, fed to `System(cfg,
mode="fused", enable_global_ba=False)`: warm frames through run_sequence,
then the window, ONE run_sequence call over the rest of the drive, as a
user runs one sequence.  Its length is --seconds times the file's
planning_fps.  A traced run traces trace_frames frames in the middle of
that same call, then runs the stage probe.
"""

from __future__ import annotations

import time

from benchmark import loads
from benchmark.loads import log


def worlds(cfg_file, cfg, traffic, seed, seconds) -> list:
    """The one stream: the drive's layout from the seed, judged over the
    window's frames."""
    warm, n = loads.window_frames(traffic, seconds)
    lay = loads.layout_for(cfg_file, cfg, loads.total_frames(traffic, n),
                           seed)
    return [loads.Stream(lay, list(range(warm, warm + n)))]


def run(cfg_file, cfg, traffic, seed, seconds, trace, device, t_start):
    from vdo_slam_tpu_torch.pipeline import System

    warm, n = loads.window_frames(traffic, seconds)
    total = loads.total_frames(traffic, n)
    (stream,) = worlds(cfg_file, cfg, traffic, seed, seconds)
    lay = stream.layout
    t0 = time.perf_counter()
    frames = loads.packed_frames(lay, cfg, device, total)
    log(f"drive: {total} frames rendered and packed in "
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
    t0 = time.perf_counter()
    reps = sysm.run_sequence(loads._Seq(frames, warm, n,
                                        tracer.fetched if tracer else None))
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
    log(f"drive: {n} frames in {run.window_s:.6f} s, "
        f"{len(run.window_solve_ms)} window solves")
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
        run.fast_px = loads.pyramid_px(cfg.camera.height, cfg.camera.width,
                                       fe.n_levels, fe.scale_factor)
    stream.outputs = loads.outputs(sysm, lay.num_frames)
    run.streams = [stream]
    return run
