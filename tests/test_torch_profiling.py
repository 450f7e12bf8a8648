"""The port's span recorder (vdo_slam_tpu_torch/utils/
profiling.py) and its sites in the fused drive, the window-solve thread
and the set-up.

The recorder: off by default and then silent (no record, no clock read);
on, each span's name, unit, thread, parent and times on time.time_ns()'s
clock.  The sites: a fused `run_sequence` on the CPU (the 320x240
two-object scene, 11 frames, chunks of 2 drained every 2 chunks, window 6 /
overlap 2, so two window solves) yields the table's spans in the expected
counts, its map is bit-equal to the same run's with the recorder off, and
each solve's stderr line, `lba_times` entry and spans agree exactly.
"""

import contextlib
import io
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tests.test_pipeline_e2e import small_config
from tests.test_torch_slice import port_config
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.io.synthetic import make_scene
from vdo_slam_tpu_torch.pipeline import System
from vdo_slam_tpu_torch.utils import profiling

CHUNK, DRAIN = 2, 2
ENDS = [6, 10]           # window ends at the triggers of 11 frames
PHASES = ["window.build", "window.dispatch", "window.exec_wait",
          "window.fetch", "window.writeback"]
REPORT_KEYS = ["t_build_ms", "t_dispatch_ms", "t_exec_ms", "t_fetch_ms",
               "t_writeback_ms"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the recorder
# --------------------------------------------------------------------------

def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def boom():
        raise AssertionError("a clock was read with the recorder off")

    monkeypatch.setattr(time, "time_ns", boom)
    monkeypatch.setattr(time, "thread_time_ns", boom)
    assert profiling.ACTIVE is None
    with profiling.span("fused.stage", 0, n=4, cpu=True) as sp:
        assert sp is None
    assert profiling.ACTIVE is None


def test_spans_nest_by_thread_with_units_and_parents():
    lo = time.time_ns()
    with profiling.recording() as rec:
        assert profiling.ACTIVE is rec
        with profiling.span("outer", 0, n=4):
            with profiling.span("inner", "g", cpu=True):
                sum(range(20000))
            rec.add("given", 5, 7, unit=3)

        def work():
            with profiling.span("other", 1):
                with profiling.span("leaf", 1):
                    pass

        th = threading.Thread(target=work, name="w")
        th.start()
        th.join(60)
        assert not th.is_alive()
    hi = time.time_ns()
    assert profiling.ACTIVE is None
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["inner", "given", "outer",
                                           "leaf", "other"]
    assert len({s.id for s in rec.spans}) == 5
    assert by["outer"].parent is None and by["other"].parent is None
    assert by["inner"].parent == by["given"].parent == by["outer"].id
    assert by["leaf"].parent == by["other"].id
    me = threading.current_thread().name
    assert {by[k].thread for k in ("outer", "inner", "given")} == {me}
    assert by["other"].thread == by["leaf"].thread == "w"
    assert (by["outer"].unit, by["inner"].unit, by["given"].unit) \
        == (0, "g", 3)
    assert by["outer"].n == 4 and by["inner"].n == 1
    assert (by["given"].start_ns, by["given"].end_ns) == (5, 7)
    for name in ("outer", "inner", "other", "leaf"):
        s = by[name]
        assert lo <= s.start_ns <= s.end_ns <= hi
    assert by["outer"].start_ns <= by["inner"].start_ns \
        <= by["inner"].end_ns <= by["outer"].end_ns
    assert 0 <= by["inner"].cpu_ns <= by["inner"].wall_ns
    assert by["outer"].cpu_ns is None


def test_recording_blocks_nest_and_restore():
    with profiling.recording() as a:
        with profiling.recording() as b:
            with profiling.span("x"):
                pass
        assert profiling.ACTIVE is a
        with profiling.span("y"):
            pass
    assert profiling.ACTIVE is None
    assert [s.name for s in a.spans] == ["y"]
    assert [s.name for s in b.spans] == ["x"]
    with pytest.raises(RuntimeError, match="out of order"):
        x, y = a.begin("x"), a.begin("y")
        a.end(x)


def test_cpu_time_is_at_most_wall_time_off_the_cpu():
    """A span that sleeps holds the CPU for a sliver of its wall time."""
    with profiling.recording() as rec:
        for _ in range(20):
            with profiling.span("busy", cpu=True):
                sum(range(5000))
        with profiling.span("sleep", cpu=True):
            time.sleep(0.05)
    for s in rec.spans:
        assert 0 <= s.cpu_ns <= s.wall_ns
    sl = rec.named("sleep")[0]
    assert sl.wall_ns >= 50_000_000 and sl.cpu_ns < sl.wall_ns / 2


# --------------------------------------------------------------------------
# the sites, on a fused CPU drive
# --------------------------------------------------------------------------

def _bounded(fn, timeout: float = 300.0):
    """fn() on a thread named "drive", joined with a timeout: no drive
    can hang the suite."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # re-raised on the test's thread
            out["error"] = e

    th = threading.Thread(target=run, name="drive", daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"the drive still runs after {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _map_arrays(m) -> dict:
    return {"cam_pose": m.cam_pose, "cam_pose_rf": m.cam_pose_rf,
            "stat_3d": m.stat_3d, "stat_xy": m.stat_xy,
            "dyn_3d": m.dyn_3d, "rigid_motion": m.rigid_motion,
            "speed_est": m.speed_est}


@pytest.fixture(scope="module")
def drives():
    """The drive with the recorder on (stderr kept) and with it off, the
    off drive's clock reads recorded by caller."""
    scene = make_scene(num_frames=12, width=320, height=240, num_objects=2,
                       seed=3)
    ds = SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)
    cfg = port_config(small_config(scene, window_size=6, overlap_size=2,
                                   fused_chunk=CHUNK,
                                   fused_drain_chunks=DRAIN))

    def system():
        return System(cfg, enable_local_ba=True, enable_global_ba=False,
                      mode="fused", device="cpu")

    err = io.StringIO()
    with profiling.recording() as rec, contextlib.redirect_stderr(err):
        on = system()
        reports = _bounded(lambda: on.run_sequence(ds))

    reads = {"time_ns": [], "thread_time_ns": []}
    real = {k: getattr(time, k) for k in reads}

    def patched(kind):
        def clock():
            f = sys._getframe(1)
            reads[kind].append((f.f_code.co_filename, f.f_code.co_name))
            return real[kind]()
        return clock

    off = system()
    try:
        for k in reads:
            setattr(time, k, patched(k))
        with contextlib.redirect_stderr(io.StringIO()):
            _bounded(lambda: off.run_sequence(ds))
    finally:
        for k, fn in real.items():
            setattr(time, k, fn)
    return {"n": len(ds), "rec": rec, "on": on, "off": off,
            "reports": reports, "stderr": err.getvalue(), "reads": reads}


def test_drive_yields_the_spans_of_the_table(drives):
    rec, n = drives["rec"], drives["n"]
    main = "drive"
    chunks = -(-n // CHUNK)
    batches = [s for s in rec.named("fused.drain_wait")]
    assert len(rec.named("fused.stage")) == chunks
    assert len(rec.named("fused.dispatch")) == chunks
    assert len(rec.named("drive.input_wait")) == chunks
    assert len(rec.named("fused.archive")) == len(batches)
    # full batches of DRAIN chunks, the ordered drain before the tail, and
    # the tail chunk's own
    assert [s.n for s in batches] == [4, 4, 2, 1]
    assert sum(s.n for s in rec.named("fused.archive")) == n
    assert [s.unit for s in rec.named("fused.stage")] \
        == list(range(0, n, CHUNK))
    for name in ("drive.input_wait", "fused.stage", "fused.dispatch",
                 "fused.drain_wait", "fused.archive"):
        for s in rec.named(name):
            assert s.thread == main and s.parent is None
    for name in ("fused.stage", "fused.archive"):
        for s in rec.named(name):
            assert 0 <= s.cpu_ns <= s.wall_ns
    solves = rec.named("window.solve")
    assert [s.unit for s in solves] == ENDS
    assert [s.unit for s in rec.named("window.queued")] == ENDS
    for s in solves:
        assert s.thread == f"window-ba-{s.unit}" and s.parent is None
        kids = [k for k in rec.spans if k.parent == s.id]
        assert [k.name for k in kids] == PHASES
        assert all(k.unit == s.unit and k.thread == s.thread for k in kids)
        # the phases tile the solve in order
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns == b.start_ns
        assert s.start_ns <= kids[0].start_ns
        assert kids[-1].end_ns <= s.end_ns
        build = kids[0]
        assert 0 <= build.cpu_ns <= build.wall_ns
    for q, s in zip(rec.named("window.queued"), solves):
        assert q.end_ns == s.start_ns and q.start_ns <= q.end_ns
    # the triggers fire inside the archive span of the frame that fires
    archives = rec.named("fused.archive")
    for q in rec.named("window.queued"):
        assert any(a.start_ns <= q.start_ns <= a.end_ns for a in archives)


def test_solve_report_line_and_spans_share_clock_reads(drives):
    rec, on = drives["rec"], drives["on"]
    solves = rec.named("window.solve")
    health = on.tracker.ba_health
    assert len(solves) == len(health) == len(on.map.lba_times) == 2
    lines = [ln for ln in drives["stderr"].splitlines()
             if ln.startswith("[window-ba]")]
    assert len(lines) == 2
    for s, h, ms, line in zip(solves, health, on.map.lba_times, lines):
        assert ms == (s.end_ns - s.start_ns) / 1e6
        kids = [k for k in rec.spans if k.parent == s.id]
        for k, key in zip(kids, REPORT_KEYS):
            assert h[key] == (k.end_ns - k.start_ns) / 1e6
        m = re.search(r"end=(\d+) .* (\d+)ms \(build (\d+) dispatch (\d+) "
                      r"exec (\d+) fetch (\d+)\)", line)
        assert m is not None, line
        assert int(m.group(1)) == s.unit
        assert m.group(2) == f"{ms:.0f}"
        for g, k in zip(m.groups()[2:], kids[:4]):
            assert g == f"{(k.end_ns - k.start_ns) / 1e6:.0f}"


def test_recorder_off_drive_is_bit_equal_and_reads_no_clock(drives):
    on, off = drives["on"].map, drives["off"].map
    assert on.num_frames == off.num_frames == drives["n"]
    a, b = _map_arrays(on), _map_arrays(off)
    for key in a:
        assert len(a[key]) == len(b[key])
        for x, y in zip(a[key], b[key]):
            if isinstance(x, list):
                assert len(x) == len(y)
                for u, v in zip(x, y):
                    np.testing.assert_array_equal(u, v, err_msg=key)
            else:
                np.testing.assert_array_equal(x, y, err_msg=key)
    assert drives["off"].tracker.ba_failures == 0
    reads = drives["reads"]
    # with the recorder off the only wall-clock reads are those of the
    # sites that time themselves for their reports; no CPU-clock read
    assert reads["thread_time_ns"] == []
    assert {name for _, name in reads["time_ns"]} \
        == {"_run_ba", "local_ba_inplace"}
    assert not any(f == profiling.__file__ for f, _ in reads["time_ns"])


def test_threads_lose_no_span():
    """Eight threads record at once with a short switch interval: every
    span arrives, ids are unique, and each thread's spans nest under its
    own."""
    n_threads, n = 8, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            def work():
                for i in range(n):
                    with profiling.span("outer", i):
                        with profiling.span("inner", i):
                            pass
            ths = [threading.Thread(target=work, name=f"t{k}")
                   for k in range(n_threads)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(60)
                assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert len(rec.spans) == 2 * n_threads * n
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    by_id = {s.id: s for s in rec.spans}
    for s in rec.named("inner"):
        p = by_id[s.parent]
        assert p.name == "outer" and p.thread == s.thread \
            and p.unit == s.unit


def test_a_recorder_fault_still_hands_the_solve_slot_over(monkeypatch):
    """A recorder whose `window.solve` span cannot close: each solve still
    runs, hands its thread slot over and launches the next, and the join
    returns."""
    from vdo_slam_tpu_torch.pipeline.fused import FusedTracker

    class Faulty(profiling.StageTimer):
        def end(self, sp, end_ns=None, n=1):
            if sp.name == "window.solve":
                raise RuntimeError("recorder fault")
            super().end(sp, end_ns, n)

    tr = FusedTracker.__new__(FusedTracker)
    tr._ba_thread, tr._ba_queue = None, []
    tr._ba_lock, tr._ba_queued_ns = threading.Lock(), {}
    tr.ba_failures, tr.ba_health = 0, []
    tr.map = type("M", (), {"lba_times": []})()
    tr.ba_context = contextlib.nullcontext
    tr.local_ba_hook = lambda m, n: None
    rec = Faulty()
    monkeypatch.setattr(profiling, "ACTIVE", rec)
    faults = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda a: faults.append(a.exc_value))
    tr._queue_ba(6)
    tr._queue_ba(10)
    _bounded(tr._join_ba, timeout=60)
    assert len(tr.map.lba_times) == 2 and tr.ba_failures == 0
    assert [str(e) for e in faults] == ["recorder fault"] * 2
    assert [s.unit for s in rec.named("window.queued")] == [6, 10]
