"""The traffic kind "refine" (closed loop): the end-of-sequence full-batch
refine of one whole drive, as an offline user evaluating a KITTI tracking
sequence waits for it.

Set-up, untimed: the file's `frames` frames of a drive made from the seed,
packed for the configuration's wire, tracked by `System(cfg,
mode="fused", enable_global_ba=True)` with the refine held back
(`run_sequence(..., refine=False)`: warm frames, then the rest in ONE
call, window solves on), then the System's refine warmed for an archive
of that length (`System.warmup_refine`), so that a refine replays its
graphs.

The window: `System.refine()` over the whole archive, repeated on the
same archive while the window lasts under --seconds, and at least
`min_refines` times; before each, and outside the timed stretch, the
archive is put back exactly as tracking left it (cam_pose_rf,
rigid_motion_rf, stat_3d, dyn_3d, which a refine writes).  frames_per_s
is frames x refines over the refines' summed wall time: frames refined
per second, so frames / frames_per_s is the wait from the sequence's end
to a refined trajectory.  `attempted` counts the refines; one whose
full_* caps did not hold, or any of whose chunks did not replay a graph
on the card (it ran eagerly, or captured inside the window), is `failed`.

What is judged (benchmark/reference.py:judge) over every frame pair of
the drive: "cam" is cam_pose_rf after the last refine, which holds the
REFINED poses here (benchmark/program.py:outputs reads it as the tracked
pose, since in the other kinds no refine runs); "cam_ba" the window
solves' cam_pose as tracking left it; "obj" the refined motions,
rigid_motion_rf.  After every refine the objective check
(benchmark/full_batch_reference.py:check) holds the refine's reported
cost0 and cost to the plain reference's float64 evaluation of the same
factor set within the traffic file's `objective_rtol`, and cost below
cost0; a run in which any check fails withholds its refined poses (NaN),
so that frames_missing fails it.

A traced run records the program's spans over the window
(utils/profiling.py) and then traces one more refine, from a restored
archive, on the device (its Trace is `run.trace`); `run.refine` holds
what the readers of the refine_* metrics read.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from benchmark import full_batch_reference as ref
from benchmark import loads
from benchmark.loads import log
from benchmark.refine_counting import lm_floor_bytes
from benchmark.trace import Trace, WindowTrace, read_events

WRITTEN = ("cam_pose_rf", "rigid_motion_rf", "stat_3d", "dyn_3d")


def worlds(cfg_file, cfg, traffic, seed, seconds) -> list:
    """The one stream: the drive's layout from the seed, judged over every
    frame pair of the drive."""
    n = int(traffic["frames"])
    lay = loads.layout_for(cfg_file, cfg, n, seed)
    return [loads.Stream(lay, list(range(1, n)))]


def _copy(rows: list) -> list:
    """A copy of one archive list: of its arrays, or of its lists of
    arrays (rigid_motion_rf)."""
    return [_copy(r) if isinstance(r, list) else r.copy() for r in rows]


def _snapshot(m) -> dict:
    """Copies of what a refine writes into the archive."""
    return {name: _copy(getattr(m, name)) for name in WRITTEN}


def _restore(m, snap: dict) -> None:
    """The archive as the snapshot holds it, in fresh copies."""
    for name in WRITTEN:
        getattr(m, name)[:] = _copy(snap[name])


def refined_outputs(sysm, n_frames: int) -> dict:
    """loads.outputs with the objects' refined motions (rigid_motion_rf)
    in place of the tracked ones; "cam" is cam_pose_rf, which a refine
    has written."""
    out = loads.outputs(sysm, n_frames)
    m = sysm.map
    ests = []
    for i, (mots, sems, stats) in enumerate(zip(m.rigid_motion_rf,
                                                m.sem_label, m.obj_stat)):
        f = i + 1                # the archive's motions start at frame 1
        if f >= n_frames:
            break
        for H, sem, st in list(zip(mots, sems, stats))[1:]:
            if st and sem >= 1:
                ests.append((f, int(sem) - 1, np.asarray(H, np.float64)))
    out["obj"] = ests
    return out


def _failed(rep: dict, on_card: bool) -> bool:
    """A refine whose caps did not hold, or, on a card, any of whose
    chunks did not replay a graph."""
    if rep is None or not rep.get("caps_held", False):
        return True
    return on_card and any(mode != "replay"
                           for mode in rep.get("chunk_modes", ["none"]))


def run(cfg_file, cfg, traffic, seed, seconds, trace, device, t_start):
    from vdo_slam_tpu_torch.pipeline import System
    from vdo_slam_tpu_torch.utils import profiling

    if not (hasattr(System, "refine") and hasattr(System, "warmup_refine")):
        raise SystemExit("refine: this program's System has no public "
                         "refine and warm-up (System.refine, "
                         "System.warmup_refine)")
    n, warm = int(traffic["frames"]), int(traffic["warm_frames"])
    rtol = float(traffic["objective_rtol"])
    (stream,) = worlds(cfg_file, cfg, traffic, seed, seconds)
    lay = stream.layout
    t0 = time.perf_counter()
    frames = loads.packed_frames(lay, cfg, device, n)
    log(f"refine: {n} frames rendered and packed in "
        f"{time.perf_counter() - t0:.3f} s")
    run = loads.Run()
    loads._reset_peak(device)
    sysm = System(cfg, enable_local_ba=True, enable_global_ba=True,
                  mode="fused", device=device)
    t0 = time.perf_counter()
    sysm.run_sequence(loads._Seq(frames, 0, warm), refine=False)
    reps = sysm.run_sequence(loads._Seq(frames, warm, n - warm),
                             refine=False)
    log(f"refine: {n} frames tracked in {time.perf_counter() - t0:.3f} s, "
        f"{len(sysm.map.lba_times)} window solves, "
        f"{loads._failed(reps, n - warm)} frames lost")
    t0 = time.perf_counter()
    sysm.warmup_refine(n)
    loads._sync(device)
    log(f"refine: warm-up for {n} frames in "
        f"{time.perf_counter() - t0:.3f} s")
    run.setup_s = time.perf_counter() - t_start
    peak_setup = loads._peak(device)
    loads._reset_peak(device)

    m = sysm.map
    snap = _snapshot(m)
    t0 = time.perf_counter()
    settings = ref.settings(cfg_file["config"]["backend"],
                            cfg_file["config"]["camera"])
    problem = ref.build(m, settings)
    cost0_ref = ref.objective(problem, problem.poses0, problem.motions0,
                              problem.points0, device)["cost"]
    log(f"refine: the reference's factor set {problem.counts()} built and "
        f"its cost0 {cost0_ref!r} in {time.perf_counter() - t0:.3f} s")

    on_card = device.type == "cuda"
    wall, checks, failed = [], [], 0

    def refine():
        """One refine from the restored archive: (report, seconds, its
        ends on the profiler's clock)."""
        _restore(m, snap)
        loads._sync(device)
        t, t0_ns = time.perf_counter(), time.time_ns()
        rep = sysm.refine()
        return rep, time.perf_counter() - t, (t0_ns, time.time_ns())

    def check(rep, dt):
        nonlocal failed
        failed += _failed(rep, on_card)
        if rep is None:
            checks.append({"ok": False})
            log(f"refine {len(checks)}: no report")
            return
        chk = ref.check(problem, rep, m, rtol, device, cost0_ref=cost0_ref)
        checks.append(chk)
        log(f"refine {len(checks)}: {dt:.6f} s, cost0 {rep['cost0']!r} "
            f"cost {rep['cost']!r}, reference {chk['cost0_ref']!r} "
            f"{chk['cost_ref']!r}, gaps {chk['cost0_gap']:.3e} "
            f"{chk['cost_gap']:.3e}, chunks {rep['chunk_modes']}, caps "
            f"{'held' if rep['caps_held'] else 'OVERFLOWED'}, build "
            f"{rep['t_build_s']:.3f} solve {rep['t_solve_s']:.3f} "
            f"write-back {rep['t_writeback_s']:.3f} s")

    t_win = time.perf_counter()
    with (profiling.recording() if trace
          else contextlib.nullcontext()) as rec:
        while (len(wall) < int(traffic["min_refines"])
               or time.perf_counter() - t_win < seconds):
            rep, dt, _ = refine()
            wall.append(dt)
            check(rep, dt)
        if trace:
            # one more refine, traced from its call to its return
            prof = WindowTrace.profile_factory()
            prof.start()
            rep, dt, ends = refine()
            prof.stop()
            check(rep, dt)
    run.memory_peak_bytes = max(peak_setup, loads._peak(device))
    run.attempted = len(checks)
    run.failed = failed
    run.e2e["frames_per_s"] = n * len(wall) / sum(wall)
    log(f"refine: {len(wall)} refines of {n} frames in {sum(wall):.6f} s, "
        f"{run.e2e['frames_per_s']:.3f} frames/s; peak "
        f"{peak_setup} B in set-up, {loads._peak(device)} B in the window")

    if trace:
        tr = Trace(t0_ns=ends[0], t1_ns=ends[1])
        read_events(prof, tr)
        run.trace = tr
        run.refine = _layer_inputs(rec, rep, ends[0])

    stream.outputs = refined_outputs(sysm, lay.num_frames)
    if not all(c["ok"] for c in checks):
        log("refine: the objective check failed; the refined poses are "
            "withheld")
        stream.outputs["cam"][:] = np.nan
    run.streams = [stream]
    return run


def _layer_inputs(rec, rep: dict, traced_from_ns: int) -> dict:
    """What the refine_* readers read: the build and write-back spans of
    the window's refines (before the traced one), the traced refine's
    chunk spans, and its floor bytes (benchmark/refine_counting.py)."""
    def ms(name):
        return [s.wall_ns / 1e6 for s in rec.named(name)
                if s.end_ns < traced_from_ns]

    chunks = [(s.start_ns, s.end_ns) for s in rec.named("full.chunk")
              if s.start_ns >= traced_from_ns]
    return {"build_ms": ms("full.build"),
            "writeback_ms": ms("full.writeback"),
            "chunks": chunks,
            "floor_bytes": lm_floor_bytes(rep)}
