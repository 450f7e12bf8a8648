"""The readers of chip_spans.py, which turn the port's spans into the host's
per-layer numbers and label the device trace's idle gaps, on spans built
by hand.

One drive, in ms on the tracking thread "MainThread" over the stretch
[0, 100]: two chunks of 4 frames (input wait, stage, dispatch each), a
batch of 8 frames drained (drain wait 20-50, archive 50-58), a dispatch
that runs past the stretch's end and an input wait that starts before
it; on the solve threads three window solves: one ending inside the
stretch (end 0), one wholly inside (end 16) and one ending after it (end
32), each with its queued span and five phases; set-up spans before the
stretch and one after its start.
"""

import pytest

import chip_spans
from benchmark.trace import Trace, breakdown
from vdo_slam_tpu_torch.utils.profiling import Span

M = 1_000_000            # ns per ms
MAIN = "MainThread"
LO, HI = 0, 100 * M

NINE = ["host_stage_ms", "host_dispatch_ms", "drain_wait_ms", "archive_ms",
        "host_offcpu_ms", "window_build_ms", "window_build_offcpu_ms",
        "window_queue_ms", "graph_capture_s"]


def _spans() -> list:
    out = []

    def sp(name, a, b, unit=None, thread=MAIN, parent=None, cpu=None, n=1):
        s = Span(len(out), name, unit, thread, parent, a * M, b * M,
                 None if cpu is None else cpu * M, n)
        out.append(s)
        return s

    # the tracking thread
    sp("drive.input_wait", -3, 1, 0)
    sp("fused.stage", 1, 4, 0, cpu=2, n=4)
    sp("fused.dispatch", 4, 10, 0, n=4)
    sp("drive.input_wait", 10, 11, 4)
    sp("fused.stage", 11, 15, 4, cpu=3, n=4)
    sp("fused.dispatch", 15, 20, 4, n=4)
    sp("fused.drain_wait", 20, 50, 0, n=8)
    sp("fused.archive", 50, 58, 0, cpu=6, n=8)
    sp("fused.dispatch", 95, 110, 8, n=4)
    # the solves: (end, queued, solve, phases, build's CPU ms)
    for end, q, s, phases, cpu in (
            (0, (-20, -10), (-10, 30), (-10, 10, 15, 20, 25, 28), 15),
            (16, (30, 40), (40, 90), (40, 70, 75, 82, 86, 89), 20),
            (32, (60, 90), (90, 130), (90, 120, 122, 125, 127, 129), 25)):
        th = f"window-ba-{end}"
        sp("window.queued", *q, end, thread=th)
        solve = sp("window.solve", *s, end, thread=th)
        for k, name in enumerate(("build", "dispatch", "exec_wait", "fetch",
                                  "writeback")):
            sp(f"window.{name}", phases[k], phases[k + 1], end, thread=th,
               parent=solve.id, cpu=cpu if name == "build" else None)
    # the set-up
    sp("setup.fast_build", -200, -150, "fast")
    sp("setup.warm", -100, -60, "step")
    sp("setup.capture", -60, -50, "step")
    sp("setup.capture", 101, 102, "late")
    return out


def _trace() -> Trace:
    """Busy 0-20, 40-60 and 65-100 ms: gaps 20-40 (in a runtime call) and
    60-65 (after one)."""
    return Trace(ops=[("k", 0, 20 * M, 7), ("k", 40 * M, 60 * M, 7),
                      ("Memcpy HtoD", 65 * M, 100 * M, 9)],
                 calls=[("cudaEventSynchronize", 19 * M, 21 * M),
                        ("cudaMemcpyAsync", 55 * M, 56 * M)],
                 t0_ns=LO, t1_ns=HI)


def test_tracking_account_by_hand():
    acc = chip_spans.tracking_account(_spans(), MAIN, LO, HI)
    # 8 frames: the dispatches wholly inside; each span clipped to the
    # stretch; covered: 0-58 and 95-100
    assert acc["frames"] == 8
    expect = {"drive.input_wait": 2 / 8, "fused.stage": 7 / 8,
              "fused.dispatch": 16 / 8, "fused.drain_wait": 30 / 8,
              "fused.archive": 8 / 8, "wall_ms": 100 / 8,
              "self_ms": (100 - 63) / 8, "covered_pct": 63.0,
              "fused.stage.offcpu": 2 / 8, "fused.archive.offcpu": 2 / 8}
    for key, v in expect.items():
        assert acc[key] == pytest.approx(v), key


def test_solve_account_by_hand():
    acc = chip_spans.solve_account(_spans(), LO, HI)
    # the solves ending at 30 and 90 ms; the third ends after the stretch
    assert acc["solves"] == 2
    expect = {"window.queued": 10, "window.solve": 45, "window.build": 25,
              "window.dispatch": 5, "window.exec_wait": 6,
              "window.fetch": 4.5, "window.writeback": 3,
              "window.build.offcpu": 7.5}
    for key, v in expect.items():
        assert acc[key] == pytest.approx(v), key


def test_host_metrics_by_hand():
    got = chip_spans.host_metrics(_spans(), MAIN, LO, HI)
    assert list(got) == NINE
    # per frame over the spans wholly inside (the late dispatch is not);
    # per solve over the two that ended inside; set-up before the stretch
    expect = {"host_stage_ms": 7 / 8, "host_dispatch_ms": 11 / 8,
              "drain_wait_ms": 30 / 8, "archive_ms": 8 / 8,
              "host_offcpu_ms": 2 / 8 + 2 / 8, "window_build_ms": 25,
              "window_build_offcpu_ms": 7.5, "window_queue_ms": 10,
              "graph_capture_s": 0.1}
    for key, v in expect.items():
        assert got[key] == pytest.approx(v), key


def test_readers_give_nothing_without_spans():
    assert chip_spans.host_metrics([], MAIN, LO, HI) \
        == dict.fromkeys(NINE)
    assert chip_spans.tracking_account([], MAIN, LO, HI) == {}
    assert chip_spans.solve_account([], LO, HI) == {}
    assert chip_spans.open_at([], lambda t: True, 0) is None
    # spans all outside the stretch, or on another thread, count as none
    late = [s for s in _spans() if s.start_ns >= 200 * M]
    assert chip_spans.host_metrics(late, MAIN, LO, HI) == dict.fromkeys(NINE)
    assert chip_spans.tracking_account(_spans(), "other", LO, HI) == {}


def test_open_at_gives_the_innermost_span():
    spans = _spans()
    solve_thread = (lambda t: t.startswith("window-ba"))
    assert chip_spans.open_at(spans, lambda t: t == MAIN, 20 * M).name \
        == "fused.drain_wait"     # the dispatch ended at 20: not open
    assert chip_spans.open_at(spans, solve_thread, 20 * M).name \
        == "window.fetch"         # inside its solve
    assert chip_spans.open_at(spans, lambda t: t == MAIN, 60 * M) is None


def test_gaps_are_labelled_by_the_spans_open_at_their_start():
    tr, spans = _trace(), _spans()
    got = chip_spans.labelled_gaps(tr, spans, MAIN)
    assert [g[0] for g in got] == [
        "fused.drain_wait | window.fetch | in cudaEventSynchronize",
        # the queued solve (end 32) opens at 60 but is no work: the
        # running solve's build is
        "- | window.build | after cudaMemcpyAsync"]
    assert [g[2] for g in got] == [20 * M, 60 * M]
    # the breakdown's gaps, in its order and durations, and its device
    # operations, are what they were
    bd = breakdown(tr)
    assert [g[1] for g in got] == [g[1] for g in bd["idle_gaps"]]
    assert all(g[0].endswith(b[0]) for g, b in zip(got, bd["idle_gaps"]))
    assert bd["device_ops"] == [["k", 0.04], ["Memcpy HtoD", 0.035]]
    assert [g[1] for g in got] == [0.02, 0.005]


def test_a_gap_with_no_solve_running_is_solve_idle():
    tr = _trace()
    tracking = [s for s in _spans() if s.thread == MAIN]
    got = chip_spans.labelled_gaps(tr, tracking, MAIN)
    assert [g[0] for g in got] == [
        "fused.drain_wait | solve idle | in cudaEventSynchronize",
        "- | solve idle | after cudaMemcpyAsync"]
    assert [g[0] for g in chip_spans.labelled_gaps(tr, [], MAIN)] == [
        "- | solve idle | in cudaEventSynchronize",
        "- | solve idle | after cudaMemcpyAsync"]


def test_join_counts_the_solves_that_end_after_the_last_archive():
    # the archive ends at 58 ms: the solves ending at 90 and 130 ms remain
    assert chip_spans.join_account(_spans(), 58 * M) == {
        "join_solves": 2, "join_ms": 72.0}
    assert chip_spans.join_account(_spans(), 130 * M) == {
        "join_solves": 0, "join_ms": 0.0}


@pytest.mark.parametrize("solves, ok", [
    ([(20, 20, 20), (36, 20, 21), (52, 20, 21)], True),
    ([(20, 20, 20), (36, 20, 36)], False),      # a whole-archive read
    ([(20, 20, None), (36, 20, None)], None),   # no count in the report
    ([], None)])
def test_build_frames_check(solves, ok):
    out = chip_spans.build_frames_check(solves)
    assert out["solves"] == len(solves) and out["build_frames_ok"] is ok
    assert out["build_frames"] == sorted({b for *_, b in solves} - {None})
