"""The fused tracker's background window solve: pipeline/fused.py
(`_finish_frame`'s trigger, `_run_ba`, `_maybe_launch_ba`, `_join_ba`,
`flush`) and `MultiStreamSystem.flush`, held to the JAX FusedTracker's
(vdo_slam_tpu/pipeline/fused.py:174-185, 308-376, 416-428).

On the 320x240 two-object scene (11 frames), window 6 / overlap 2: the
triggers fire on archived frames 5 and 9, so the window ends are 6 and 10.
The JAX tracker's triggers are read by feeding its host half the port's
own output vectors (the two packages pack them alike), so no JAX step is
compiled.  On the CPU the solve thread runs the solve with no stream; its
results are the inline solves' at atol 0.

One torch thread.  Every wait has a timeout of its own and asserts on it;
a drive that may join a solve runs on a helper thread joined with a
timeout (`_bounded`), so no test can hang the suite.
"""

import copy
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tests.test_pipeline_e2e import small_config
from tests.test_torch_slice import port_config
from vdo_slam_tpu.pipeline.fused import FusedTracker as JaxFusedTracker
from vdo_slam_tpu_torch.backend.window_ba import local_ba_inplace
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.io.synthetic import make_scene
from vdo_slam_tpu_torch.parallel import MultiStreamSystem
from vdo_slam_tpu_torch.pipeline import System
from vdo_slam_tpu_torch.pipeline.fused import FusedTracker

TIMEOUT = 120.0          # seconds for any one wait
WINDOW, OVERLAP = 6, 2
ENDS = [6, 10]           # archive lengths at the triggers of 11 frames


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs in several worker processes at once, and each worker's idle
    OpenMP threads spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bounded(fn, timeout: float = TIMEOUT):
    """fn() on a helper thread joined with a timeout; its result, or its
    exception raised here."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # re-raised on the test's thread
            out["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"{fn} still running after {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _solve_threads() -> list[threading.Thread]:
    return [t for t in threading.enumerate() if t.name.startswith(
        "window-ba")]


def _no_solve_thread_alive() -> None:
    for t in _solve_threads():
        t.join(TIMEOUT)
        assert not t.is_alive(), t.name


def _fused(cfg, enable_local_ba: bool = True) -> System:
    return System(cfg, enable_local_ba=enable_local_ba,
                  enable_global_ba=False, mode="fused", device="cpu")


def _scene_ds(seed: int):
    scene = make_scene(num_frames=12, width=320, height=240, num_objects=2,
                       seed=seed)
    return scene, SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)


@pytest.fixture(scope="module")
def runs():
    """The scene's run with window BA on (each solve's end, thread and
    intra-op thread count recorded, and every archived frame's output
    vector), and the same run with window BA off."""
    scene, ds = _scene_ds(3)
    jcfg = small_config(scene, window_size=WINDOW, overlap_size=OVERLAP)
    cfg = port_config(jcfg)
    on = _fused(cfg)
    tr = on.tracker
    solves, frames = [], []
    hook, finish = tr.local_ba_hook, tr._finish_frame

    def recording_hook(m, n_frames):
        solves.append((n_frames, threading.current_thread(),
                       torch.get_num_threads()))
        return hook(m, n_frames)

    def recording_finish(fd, T_cw_gt, fid, vec_np, t0):
        frames.append((fd, T_cw_gt, fid, np.array(vec_np)))
        return finish(fd, T_cw_gt, fid, vec_np, t0)

    tr.local_ba_hook = recording_hook
    tr._finish_frame = recording_finish
    caller = {}

    def drive():
        caller["thread"] = threading.current_thread()
        return on.run_sequence(ds)

    reports = _bounded(drive)
    off = _fused(cfg, enable_local_ba=False)
    _bounded(lambda: off.run_sequence(ds))
    return {"cfg": cfg, "jcfg": jcfg, "ds": ds, "on": on, "off": off,
            "reports": reports, "solves": solves, "frames": frames,
            "caller": caller["thread"]}


def _jax_replay(runs, hook, after=None) -> tuple[JaxFusedTracker, list]:
    """The JAX FusedTracker's host half fed the port run's archived output
    vectors in order, with `hook` as its window-BA hook; `after(fid)` runs
    after each frame.  Returns the tracker and its reports, its solves
    joined."""
    jtr = JaxFusedTracker(runs["jcfg"])
    jtr.local_ba_hook = hook
    reps = []
    for fd, T_cw_gt, fid, vec in runs["frames"]:
        reps.append(jtr._finish_frame(fd, T_cw_gt, fid, vec,
                                      time.perf_counter()))
        if after is not None:
            after(jtr, fid)
    _bounded(jtr._join_ba)
    return jtr, reps


def _join_solve(tracker) -> None:
    """Join the tracker's solve in flight, if any, with a timeout."""
    with tracker._ba_lock:
        th = tracker._ba_thread
    if th is not None:
        th.join(TIMEOUT)
        assert not th.is_alive()


def test_trigger_during_a_solve_is_queued_not_joined(runs):
    """(a) The second trigger arrives while the first solve is blocked: it
    is queued, and the tracker archives past it."""
    cfg, ds = runs["cfg"], runs["ds"]
    tr = _fused(cfg).tracker
    started, release = threading.Event(), threading.Event()
    ends = []

    def blocking_hook(m, n_frames):
        ends.append(n_frames)
        if len(ends) == 1:
            started.set()
            if not release.wait(TIMEOUT):
                raise TimeoutError("the test never released the solve")

    tr.local_ba_hook = blocking_hook

    def drive():
        # grab_frame(i) archives frame i - 1
        for i in range(len(ds)):
            tr.grab_frame(ds[i])
            if i == ENDS[0]:
                assert started.wait(TIMEOUT)

    try:
        _bounded(drive)
        with tr._ba_lock:
            queue, first = list(tr._ba_queue), tr._ba_thread
        assert queue == [ENDS[1]]
        assert first is not None and first.is_alive()
        assert tr.map.num_frames == len(ds) - 1 == ENDS[1]
        assert ends == [ENDS[0]]
    finally:
        release.set()
    _bounded(tr.flush)
    assert ends == ENDS
    first.join(TIMEOUT)
    assert not first.is_alive()
    assert tr.map.num_frames == len(ds)
    assert tr.ba_failures == 0


def test_solves_run_in_order_pinned_as_the_jax_triggers(runs):
    """(b) The solves run in trigger order on a background thread with one
    torch thread, each pinned to the n_frames the JAX tracker's triggers
    give on the same frames."""
    jends = []
    _jax_replay(runs, lambda m, n_frames: jends.append(n_frames))
    ends = [n for n, _, _ in runs["solves"]]
    assert ends == jends == ENDS
    for _, th, n_threads in runs["solves"]:
        assert th is not runs["caller"] and th.name.startswith("window-ba")
        assert n_threads == 1
    assert len(runs["on"].tracker.ba_health) == len(ENDS)
    assert len(runs["on"].map.lba_times) == len(ENDS)
    _no_solve_thread_alive()


def _assert_equal_tree(a, b) -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equal_tree(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


def test_threaded_solves_equal_inline_solves(runs):
    """(c) The run with solves on the thread equals the BA-off archive with
    each trigger's solve replayed inline, at atol 0."""
    cfg, on = runs["cfg"], runs["on"]
    m = copy.deepcopy(runs["off"].map)
    inline = [local_ba_inplace(m, cfg, n_frames=k, device="cpu")
              for k in ENDS]
    assert on.map.num_frames == m.num_frames == len(runs["ds"])
    for name in ("cam_pose", "stat_3d"):
        for a, b in zip(getattr(on.map, name), getattr(m, name)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(on.map.rigid_motion, m.rigid_motion):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert len(on.tracker.ba_health) == len(inline)
    for h, r in zip(on.tracker.ba_health, inline):
        _assert_equal_tree({k: v for k, v in h.items()
                            if not k.startswith("t_")},
                           {k: v for k, v in r.items()
                            if not k.startswith("t_")})


def test_failing_solve_is_counted_and_the_run_goes_on(runs):
    """(d) A hook that raises once: ba_failures == 1, the run finishes, the
    later solve runs, and every report archived after the failure carries
    ba_failures, on the same frames as the JAX tracker's reports."""
    cfg, ds = runs["cfg"], runs["ds"]
    tr = _fused(cfg).tracker
    hook = tr.local_ba_hook

    def failing_once(ends):
        def fn(m, n_frames):
            ends.append(n_frames)
            if len(ends) == 1:
                raise RuntimeError("injected window-solve failure")
            return hook(m, n_frames) if m is tr.map else None
        return fn

    ends = []
    tr.local_ba_hook = failing_once(ends)

    def drive():
        reps = []
        for i in range(len(ds)):
            reps.append(tr.grab_frame(ds[i]))
            if i == ENDS[0]:           # frame ENDS[0] - 1 archived
                _join_solve(tr)
                assert tr.ba_failures == 1
        reps.append(tr.flush())
        return reps[1:]                # the first is a placeholder

    reps = _bounded(drive)
    assert [r["frame_id"] for r in reps] == list(range(len(ds)))
    assert tr.ba_failures == 1
    assert ends == ENDS
    assert len(tr.ba_health) == len(tr.map.lba_times) == 1
    assert [r.get("ba_failures") for r in reps] == (
        [None] * ENDS[0] + [1] * (len(ds) - ENDS[0]))

    jends = []

    def join_after_trigger(jtr, fid):
        if fid == ENDS[0] - 1:
            _join_solve(jtr)

    jtr, jreps = _jax_replay(runs, failing_once(jends), join_after_trigger)
    assert jtr.ba_failures == 1 and jends == ENDS
    assert [r.get("ba_failures") for r in jreps] == [
        r.get("ba_failures") for r in reps]


def test_flush_joins_a_queued_solve_not_yet_launched(runs):
    """(e) A window end queued with no solve in flight (the finishing
    thread between releasing the slot and launching the next) is launched
    and joined by flush."""
    cfg = runs["cfg"]
    m = copy.deepcopy(runs["off"].map)
    tr = FusedTracker(cfg, m, device="cpu", build_step=False)
    done = []
    tr.local_ba_hook = lambda mm, n_frames: done.append(
        (n_frames, threading.current_thread().name))
    with tr._ba_lock:
        tr._ba_queue.append(ENDS[0])
    assert tr._ba_thread is None
    assert _bounded(tr.flush) is None
    assert [n for n, _ in done] == [ENDS[0]]
    assert done[0][1].startswith("window-ba")
    with tr._ba_lock:
        assert tr._ba_thread is None and tr._ba_queue == []
    assert tr.ba_failures == 0


def test_multistream_flush_joins_every_stream(runs):
    """(f) MultiStreamSystem(n_streams=2) on the CPU with window BA: no
    solve thread alive after run, no failure, one report per trigger per
    stream (JAX tests/test_multistream.py:369)."""
    dss = [runs["ds"], _scene_ds(9)[1]]
    msys = MultiStreamSystem(runs["cfg"], n_streams=2, enable_local_ba=True,
                             device="cpu")
    reps = _bounded(lambda: msys.run(dss))
    _no_solve_thread_alive()
    for s, t in enumerate(msys.trackers):
        assert t.ba_failures == 0
        assert [r["frame_id"] for r in reps[s]] == list(range(len(dss[0])))
        assert len(t.ba_health) == len(t.map.lba_times) == len(ENDS)
        with t._ba_lock:
            assert t._ba_thread is None and t._ba_queue == []


def test_triggers_from_many_threads_each_solved_once_in_turn(runs):
    """Stress: more triggering threads than cores, each queueing 40 window
    ends, with a short switch interval: every end is solved exactly once,
    one solve at a time, each thread's ends in the order it queued them."""
    tr = FusedTracker(runs["cfg"], device="cpu", build_step=False)
    guard, active, peak, done = threading.Lock(), [0], [0], []

    def hook(m, n_frames):
        with guard:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0)
        done.append(n_frames)
        with guard:
            active[0] -= 1

    tr.local_ba_hook = hook
    n_threads, per = 2 * (os.cpu_count() or 4), 40

    def trigger(k):
        for j in range(per):
            tr._queue_ba(k * per + j)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=trigger, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
        _bounded(tr._join_ba)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(done) == list(range(n_threads * per))
    assert peak[0] == 1
    for k in range(n_threads):
        mine = [n for n in done if n // per == k]
        assert mine == sorted(mine)
    assert tr.ba_failures == 0
    _no_solve_thread_alive()
