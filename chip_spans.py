#!/usr/bin/env python3
"""The host's account of the fused drive, from the port's span recorder
(vdo_slam_tpu_torch/utils/profiling.py), on one GPU.

    python3 chip_spans.py clock            # spans against the profiler
    python3 chip_spans.py cost             # what one site costs, off and on
    python3 chip_spans.py drive --seed 7 --seconds 20 --trace 1

`clock`: a span that brackets torch.cuda.synchronize() after a long
kernel, beside torch.profiler's record of that kernel: the kernel's end
must fall inside the span, which shows that spans (time.time_ns) and the
profiler's device records share one clock; prints the offsets.

`cost`: the host's ns per site with the recorder off (a null span) and
on (a span, a span with its CPU-time read, a span from given
clock reads), each the mean of many in a loop less the empty loop.

`drive`: one run of the benchmark's `kitti-drive` cell (benchmark/run.py's
run_cell, unchanged: the same scene, frames, System and traced stretch) with
the recorder on from before the System is made, then from the records:
- the tracking thread's account per frame over the window's frames
  before the traced stretch's profiler started (before the window's end
  in an untraced run): the prefetcher wait, staging, dispatch, the drain's
  wait, the archive, and the rest as run_sequence's self time; the share
  of the wall time the spans cover;
- the window solve's account per solve over the solves that ended in that
  stretch: queued, build (and its wall less CPU), dispatch, exec wait,
  fetch, write-back;
- the nine host metrics these spans give (each over the same frames or
  solves);
- flush()'s end-of-call join: the solves that ended after the window
  call's last archive, and how long after;
- the archive frames each window solve's build read (its report's
  `build_frames`), against min(N, W + 1) for a window of W ending at N;
- with --trace 1, the breakdown's ten longest idle gaps, each named by the
  innermost tracking-thread span open at its start, the solve thread's
  span open then (or "solve idle"), and the runtime call as the benchmark
  names it.
Prints the benchmark's result line, then one JSON line of these.

The readers (`host_metrics`, `labelled_gaps` and what they use) are for
the benchmark to take over as its per-layer metrics and gap labels; this
script goes once it has.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TRACKING = ("drive.input_wait", "fused.stage", "fused.dispatch",
            "fused.drain_wait", "fused.archive")
SOLVE = ("window.queued", "window.solve", "window.build",
         "window.dispatch", "window.exec_wait", "window.fetch",
         "window.writeback")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# reading the records
# --------------------------------------------------------------------------

def _clip(s, lo: int, hi: int) -> int:
    return max(0, min(s.end_ns, hi) - max(s.start_ns, lo))


def _union_ns(spans, lo: int, hi: int) -> int:
    iv = sorted((max(s.start_ns, lo), min(s.end_ns, hi)) for s in spans
                if min(s.end_ns, hi) > max(s.start_ns, lo))
    tot, cur = 0, None
    for a, b in iv:
        if cur is None or a > cur[1]:
            if cur is not None:
                tot += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        tot += cur[1] - cur[0]
    return tot


def tracking_account(spans, thread: str, lo: int, hi: int) -> dict:
    """ms per frame of each tracking span over [lo, hi] (clipped), the
    frames being those whose dispatch lies wholly inside; the rest of the
    wall time as self time; the share the spans cover."""
    mine = [s for s in spans if s.thread == thread and s.parent is None
            and s.name in TRACKING]
    frames = sum(s.n for s in mine if s.name == "fused.dispatch"
                 and lo <= s.start_ns and s.end_ns <= hi)
    if not frames:
        return {}
    out = {name: sum(_clip(s, lo, hi) for s in mine if s.name == name)
           / 1e6 / frames for name in TRACKING}
    wall = (hi - lo) / 1e6 / frames
    covered = _union_ns(mine, lo, hi) / 1e6 / frames
    out.update(frames=frames, wall_ms=wall, self_ms=wall - covered,
               covered_pct=100.0 * covered / wall)
    for name in ("fused.stage", "fused.archive"):
        inside = [s for s in mine if s.name == name and lo <= s.start_ns
                  and s.end_ns <= hi]
        out[name + ".offcpu"] = (sum(s.wall_ns - s.cpu_ns for s in inside)
                                 / 1e6 / max(sum(s.n for s in inside), 1))
    return out


def solve_account(spans, lo: int, hi: int) -> dict:
    """Mean ms per solve of each solve span, over the solves that ended in
    [lo, hi]; the build's wall less the solve thread's CPU time."""
    solves = [s for s in spans if s.name == "window.solve"
              and lo <= s.end_ns <= hi]
    if not solves:
        return {}
    ids = {s.id for s in solves}
    units = {s.unit for s in solves}
    out = {"solves": len(solves)}
    for name in SOLVE:
        if name == "window.solve":
            xs = solves
        elif name == "window.queued":
            xs = [s for s in spans if s.name == name and s.unit in units]
        else:
            xs = [s for s in spans if s.name == name and s.parent in ids]
        out[name] = (sum(s.wall_ns for s in xs) / 1e6 / len(xs)
                     if xs else None)
    builds = [s for s in spans if s.name == "window.build"
              and s.parent in ids]
    out["window.build.offcpu"] = (sum(s.wall_ns - s.cpu_ns for s in builds)
                                  / 1e6 / len(builds) if builds else None)
    return out


def host_metrics(spans, thread: str, lo: int, hi: int) -> dict:
    """The host's per-layer numbers: each tracking span's ms per frame over
    the frames of its spans inside [lo, hi]; the solve's means over the
    solves that ended in it; the set-up spans' seconds before lo."""
    def per_frame(names, offcpu=False):
        xs = [s for s in spans if s.thread == thread and s.name in names
              and lo <= s.start_ns and s.end_ns <= hi]
        tot = 0.0
        for name in names:
            ys = [s for s in xs if s.name == name]
            if not ys:
                return None
            tot += (sum((s.wall_ns - s.cpu_ns) if offcpu else s.wall_ns
                        for s in ys) / 1e6 / sum(s.n for s in ys))
        return tot

    sa = solve_account(spans, lo, hi)
    setup = [s for s in spans if s.name.startswith("setup.")
             and s.end_ns <= lo]
    return {
        "host_stage_ms": per_frame(["fused.stage"]),
        "host_dispatch_ms": per_frame(["fused.dispatch"]),
        "drain_wait_ms": per_frame(["fused.drain_wait"]),
        "archive_ms": per_frame(["fused.archive"]),
        "host_offcpu_ms": per_frame(["fused.stage", "fused.archive"],
                                    offcpu=True),
        "window_build_ms": sa.get("window.build"),
        "window_build_offcpu_ms": sa.get("window.build.offcpu"),
        "window_queue_ms": sa.get("window.queued"),
        "graph_capture_s": (sum(s.wall_ns for s in setup) / 1e9
                            if setup else None),
    }


def join_account(spans, last_ns: int) -> dict:
    """flush()'s join at the end of a call whose last archive ends at
    last_ns: the solves that ended after it, and the ms to the last one."""
    ends = [s.end_ns for s in spans if s.name == "window.solve"
            and s.end_ns > last_ns]
    return {"join_solves": len(ends),
            "join_ms": (max(ends) - last_ns) / 1e6 if ends else 0.0}


def build_frames_check(solves) -> dict:
    """`solves`: (window end N, window W, the report's build_frames) per
    window solve.  Whether every build read min(N, W + 1) frames; None
    where no report holds the count."""
    read = [b for _, _, b in solves]
    ok = (None if not solves or None in read else
          all(b == min(n, w + 1) for n, w, b in solves))
    return {"solves": len(solves),
            "build_frames": sorted({b for b in read if b is not None}),
            "build_frames_ok": ok}


def open_at(spans, thread_pred, t_ns: int):
    """The innermost span of a thread that `thread_pred` accepts open at
    t_ns, or None."""
    best = None
    for s in spans:
        if thread_pred(s.thread) and s.start_ns <= t_ns < s.end_ns and (
                best is None or s.start_ns >= best.start_ns):
            best = s
    return best


def labelled_gaps(tr, spans, thread: str, n: int = 10) -> list:
    """The trace's n longest idle gaps (as benchmark/trace.py:breakdown
    picks them), each labelled by the spans open at its start."""
    gaps = sorted(tr.idle_gaps(), key=lambda g: g[0] - g[1])[:n]
    out = []
    for s, e in gaps:
        a = open_at(spans, lambda t: t == thread, s)
        # a queued solve's span is no work of the thread it names
        b = open_at([x for x in spans if x.name != "window.queued"],
                    lambda t: t.startswith("window-ba"), s)
        label = (f"{a.name if a else '-'} | "
                 f"{b.name if b else 'solve idle'} | {tr.host_at(s)}")
        out.append([label, (e - s) / 1e9, s])
    return out


# --------------------------------------------------------------------------
# the modes
# --------------------------------------------------------------------------

def clock(n: int = 5) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vdo_slam_tpu_torch.utils import profiling

    torch.cuda.init()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profiling.recording() as rec:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        for _ in range(n):
            torch.cuda._sleep(50_000_000)      # tens of ms on the card
            with profiling.span("sync"):
                torch.cuda.synchronize()
            time.sleep(0.01)
        prof.stop()
    ks = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
                for ev in prof.profiler.kineto_results.events()
                if ev.device_type() == DeviceType.CUDA)
    sleeps = [k for k in ks if "sleep" in k[2].lower()
              or "spin" in k[2].lower()] or ks
    rows = []
    for sp, (ks_, ke, name) in zip(rec.named("sync"), sleeps[-n:]):
        rows.append({"kernel": name, "kernel_ms": (ke - ks_) / 1e6,
                     "span_ms": sp.wall_ns / 1e6,
                     "end_inside": sp.start_ns <= ke <= sp.end_ns,
                     "span_end_minus_kernel_end_us":
                         (sp.end_ns - ke) / 1e3,
                     "kernel_end_minus_span_start_ms":
                         (ke - sp.start_ns) / 1e6})
    return {"device": torch.cuda.get_device_name(0), "rows": rows,
            "all_inside": bool(rows) and all(r["end_inside"] for r in rows)}


def cost(n: int = 200_000) -> dict:
    from vdo_slam_tpu_torch.utils import profiling

    def loop(body) -> float:
        t0 = time.perf_counter_ns()
        body()
        return (time.perf_counter_ns() - t0) / n

    def empty():
        for i in range(n):
            pass

    def off_span():
        for i in range(n):
            with profiling.span("fused.stage", i, n=4, cpu=True):
                pass

    base = min(loop(empty) for _ in range(3))
    out = {"empty_loop_ns": base}
    out["off_span_ns"] = min(loop(off_span) for _ in range(3)) - base
    for cpu in (False, True):
        def on_span(cpu=cpu):
            for i in range(n):
                with profiling.span("fused.stage", i, n=4, cpu=cpu):
                    pass

        best = []
        for _ in range(3):
            with profiling.recording():
                best.append(loop(on_span))
        out[f"on_span{'_cpu' if cpu else ''}_ns"] = min(best) - base

    def on_add():
        rec = profiling.ACTIVE
        for i in range(n):
            rec.add("window.fetch", i, i + 1, 16)

    best = []
    for _ in range(3):
        with profiling.recording():
            best.append(loop(on_add))
    out["on_add_ns"] = min(best) - base
    return out


def drive(seed: int, seconds: int, trace: bool) -> dict:
    import torch

    from benchmark import loads
    from benchmark import run as brun
    from benchmark.trace import breakdown
    from vdo_slam_tpu_torch.backend import window_ba
    from vdo_slam_tpu_torch.utils import profiling

    t_start = time.perf_counter()
    kept = {}
    kind, base = loads.KINDS["drive"], loads.WindowTrace
    solve_fn, solves = window_ba.local_ba_inplace, []

    def counted(m, *a, n_frames=None, **k):
        rep = solve_fn(m, *a, n_frames=n_frames, **k)
        solves.append((m.num_frames if n_frames is None else n_frames,
                       rep["window"], rep.get("build_frames")))
        return rep

    def keep(*a, **k):
        kept["run"] = kind(*a, **k)
        return kept["run"]

    class Noted(base):
        """The benchmark's tracer, noting the clock when the profiler
        starts."""

        def __init__(self, *a, on_start=None, **k):
            def noted():
                kept["profiler_start_ns"] = time.time_ns()
                if on_start is not None:
                    on_start()
            super().__init__(*a, on_start=noted, **k)

    loads.KINDS["drive"], loads.WindowTrace = keep, Noted
    window_ba.local_ba_inplace = counted    # System imports it when made
    try:
        with profiling.recording() as rec:
            result, lines = brun.run_cell("kitti-drive", seed, seconds,
                                          trace, "cuda", t_start)
    finally:
        loads.KINDS["drive"], loads.WindowTrace = kind, base
        window_ba.local_ba_inplace = solve_fn
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    run = kept["run"]
    out = {"seed": seed, "seconds": seconds, "trace": trace,
           "device": torch.cuda.get_device_name(0),
           "frames_per_s": run.e2e.get("frames_per_s"),
           "setup_s": run.setup_s}
    spans = rec.spans
    out["spans"] = len(spans)
    thread = "MainThread"
    warm = run.judged_frames[0]
    window = [s for s in spans if s.thread == thread
              and s.name in TRACKING and isinstance(s.unit, int)
              and s.unit >= warm]
    lo = min(s.start_ns for s in window)
    hi = kept.get("profiler_start_ns", max(s.end_ns for s in window))
    out["stretch_s"] = (hi - lo) / 1e9
    out["tracking"] = tracking_account(spans, thread, lo, hi)
    out["solve"] = solve_account(spans, lo, hi)
    out["host_metrics"] = host_metrics(spans, thread, lo, hi)
    # the call's last archive is flush()'s, just before it joins the solves
    out["join"] = join_account(spans, max(s.end_ns for s in window
                                          if s.name == "fused.archive"))
    out["builds"] = build_frames_check(solves)
    n_win = sum(1 for s in spans if lo <= s.start_ns and s.end_ns <= hi)
    out["spans_per_frame"] = n_win / max(out["tracking"].get("frames", 0), 1)
    if trace and run.trace is not None:
        gaps = labelled_gaps(run.trace, spans, thread)
        out["gaps"] = [[g[0], g[1], (g[2] - run.trace.t0_ns) / 1e9]
                       for g in gaps]
        out["gaps_naming_tracking_span"] = sum(
            1 for g in gaps if not g[0].startswith("-"))
        out["breakdown"] = breakdown(run.trace)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("clock", "cost", "drive"))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=int, default=20)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    cache = ROOT / ".bench_cache"
    import os
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    import torch

    if not torch.cuda.is_available():
        log("chip_spans: no CUDA device")
        return 1
    if args.mode == "clock":
        out = clock()
    elif args.mode == "cost":
        out = cost()
    else:
        out = drive(args.seed, args.seconds, bool(args.trace))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
