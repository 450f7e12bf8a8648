"""The traffic kind "streams" (closed loop): n_streams drives, each in a
world of its own, fed together to `MultiStreamSystem(cfg, n_streams)` on
the run's one device, window solves on, no full BA: warm frames through
one `run` call, then the window, ONE `run` call over the rest of every
drive.  Each frame of the window is one batched step for all streams (one
upload, one wire decode, one FAST launch over the streams' pyramids), and
each stream's window solves run on a thread of its own.  Every stream's
window is --seconds times the file's planning_fps frames (planned per
stream).  A traced run traces trace_frames batched steps of the window's
call, counted by stream 0's fetches, placed as the "drive" kind places
them.  The streams share the program's configuration and so its seed
(`cfg.seed`), as MultiStreamSystem draws.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import loads
from benchmark.loads import log


def stream_seed(seed: int, s: int) -> int:
    """Stream s's world seed, drawn from the pair (run seed, s)."""
    return int(np.random.SeedSequence([seed, s]).generate_state(
        1, np.uint64)[0])


def worlds(cfg_file, cfg, traffic, seed, seconds) -> list:
    """One stream per drive: stream s's layout from stream_seed(seed, s),
    each judged over the window's frames."""
    warm, n = loads.window_frames(traffic, seconds)
    total = loads.total_frames(traffic, n)
    return [loads.Stream(loads.layout_for(cfg_file, cfg, total,
                                          stream_seed(seed, s)),
                         list(range(warm, warm + n)))
            for s in range(int(traffic["n_streams"]))]


def _first_fetch(fetched):
    """fetched(i) on the first fetch of each frame only:
    MultiStreamSystem.run fetches frame i + 1 to stage it behind step i,
    and again to step it."""
    nxt = [0]

    def once(i):
        if i >= nxt[0]:
            nxt[0] = i + 1
            fetched(i)
    return once


def run(cfg_file, cfg, traffic, seed, seconds, trace, device, t_start):
    from vdo_slam_tpu_torch.parallel.multisystem import MultiStreamSystem

    warm, n = loads.window_frames(traffic, seconds)
    total = loads.total_frames(traffic, n)
    streams = worlds(cfg_file, cfg, traffic, seed, seconds)
    S = len(streams)
    t0 = time.perf_counter()
    frames = [loads.packed_frames(st.layout, cfg, device, total)
              for st in streams]
    log(f"streams: {S} drives of {total} frames rendered and packed in "
        f"{time.perf_counter() - t0:.3f} s")
    run = loads.Run()
    loads._reset_peak(device)
    sysm = MultiStreamSystem(cfg, S, enable_local_ba=True, devices=[device],
                             device=device)
    sysm.run([loads._Seq(f, 0, warm) for f in frames])
    loads._sync(device)
    run.setup_s = time.perf_counter() - t_start
    trackers = sysm.trackers
    n_solves = [len(t.map.lba_times) for t in trackers]
    since = [(t.ba_failures, len(t.ba_health)) for t in trackers]

    solves_before_trace = []
    tracer = (loads.WindowTrace(*loads.traced_stretch(traffic, n),
                                on_start=lambda: solves_before_trace.append(
                                    [len(t.map.lba_times)
                                     for t in trackers]))
              if trace else None)
    seqs = [loads._Seq(f, warm, n) for f in frames]
    if tracer:
        seqs[0].fetched = _first_fetch(tracer.fetched)
    t0 = time.perf_counter()
    reps = sysm.run(seqs)
    run.window_s = time.perf_counter() - t0
    run.memory_peak_bytes = loads._peak(device)
    # a traced run: the solves that ended before the profiler started
    ends = (solves_before_trace[0] if solves_before_trace
            else [len(t.map.lba_times) for t in trackers])
    run.window_solve_ms = [ms for t, a, b in zip(trackers, n_solves, ends)
                           for ms in t.map.lba_times[a:b]]
    run.attempted = S * n
    run.failed = sum(loads._failed(r, n) + loads._solve_failures(t, s0)
                     for r, t, s0 in zip(reps, trackers, since))
    run.e2e["frames_per_s"] = S * n / run.window_s
    log(f"streams: {S} x {n} frames in {run.window_s:.6f} s, "
        f"{len(run.window_solve_ms)} window solves")
    if trace:
        t1 = time.perf_counter()
        run.trace = tracer.result()
        run.trace_frames = tracer.n
        log(f"traced stretch: steps {warm + tracer.first} to "
            f"{warm + tracer.first + tracer.n - 1} of the window's one "
            f"call, {run.trace.window_s:.6f} s "
            f"({tracer.n / run.trace.window_s:.3f} steps/s traced, "
            f"{n / run.window_s:.3f} over the whole window), "
            f"{len(run.trace.ops)} device operations recorded, read in "
            f"{time.perf_counter() - t1:.3f} s")
        fe = cfg.frontend
        # the one batched launch scores every stream's pyramid
        run.fast_px = S * loads.pyramid_px(cfg.camera.height,
                                           cfg.camera.width, fe.n_levels,
                                           fe.scale_factor)
    for st, t in zip(streams, trackers):
        st.outputs = loads.outputs(t, st.layout.num_frames)
    run.streams = streams
    return run
