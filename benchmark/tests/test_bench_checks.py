"""The comparison that decides `correct`: the control fails it, and a run
of the harness on the CPU, with the program's answers replaced underneath
by the reference's own with a fault planted, comes out not correct for
each fault the cell can have (it runs on one chip, so it has no exchange
between chips to leave out).  The program runs for real at 320x96 and the
harness judges what the fault leaves; the program's own accuracy at that
size is not what these tests hold.  The object faults are also judged at
the cell's own size, where one object broken on one frame in 20 is under
2 % of the estimates."""

import copy
import json

import numpy as np
import pytest
import torch

from benchmark import loads
from benchmark import reference as R
from benchmark import run as harness
from benchmark.program import build_config
from benchmark.run import HERE, load_cell

CELL = "kitti-drive"
STREAMS = "kitti-streams6"


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _streams_cell():
    """The six-stream cell kitti-streams6 from its files (the "streams"
    kind, benchmark/traffic/streams6.json, its limits), which
    BENCHMARK.json does not list (PERF.md §7 says why)."""
    c = copy.deepcopy(load_cell(CELL))
    c["cell"].update(name=STREAMS, traffic="streams6")
    c["traffic"] = json.loads((HERE / "traffic" / "streams6.json")
                              .read_text())
    c["limits"] = json.loads((HERE / "limits" / f"{STREAMS}.json")
                             .read_text())
    return c


def _tiny(name):
    """The cell at a size the CPU runs in seconds: the configuration's
    camera cut to 320x96, windows of 6 / 2 frames, 4 warm frames, a window
    of 8 and a traced stretch of 4."""
    c = _streams_cell() if name == STREAMS else copy.deepcopy(load_cell(name))
    cam = c["config"]["config"]["camera"]
    cam.update(width=320, height=96, cx=160.0, cy=48.0)
    c["config"]["config"]["tracking"].update(window_size=6, overlap_size=2)
    c["traffic"].update(warm_frames=4, trace_frames=4, planning_fps=4.0,
                        frames_multiple=4)
    return c


def _cell_layout(seed, n=None):
    c = load_cell(CELL)
    warm, n_win = loads.window_frames(c["traffic"], 20)
    n = n_win if n is None else n
    lay = loads.layout_for(c["config"], build_config(c["config"]),
                           loads.total_frames(c["traffic"], n), seed)
    return c, lay, range(warm, warm + n)


def test_control_fails_the_limits():
    """The reference in bfloat16 over the cell's own window: a number it
    reads is above its limit."""
    c, lay, frames = _cell_layout(2**31 + 11)
    got = R.control(lay.T_wc, lay.L, R.corners(lay.obj_patches), frames)
    ok, lines = R.verdict(got, c["limits"])
    assert not ok, lines


def _exact(lay):
    """The reference's own answers in the program's place."""
    gt = R.truth(lay.T_wc, lay.L)
    F, K = lay.L.shape[:2]
    Lw = gt["L"]
    obj = [(f, k, Lw[f, k] @ R._inv(Lw[f - 1, k]))
           for f in range(1, F) for k in range(K)]
    return {"cam": gt["T_wc"].copy(), "cam_ba": gt["T_wc"].copy(),
            "obj": obj}


def _state_unchanged(out, warm, lay):
    for key in ("cam", "cam_ba"):
        out[key][warm:] = out[key][warm - 1]
    return out


def _half_left_out(out, warm, lay):
    """Half of each chunk's frames never archived (frames_missing)."""
    for key in ("cam", "cam_ba"):
        out[key][warm + 1::2] = np.nan
    return out


def _answer_altered(out, warm, lay):
    f = warm + 3
    out["cam"][f:, 0, 3] += 0.5         # one frame's motion off by 50 cm
    return out


def _broken_object(out, warm, lay, change):
    """Object 0's motion replaced by change(motion, its pose) on one frame
    in 20 of the window."""
    L = R.truth(lay.T_wc, lay.L)["L"]
    for i, (f, k, H) in enumerate(out["obj"]):
        if k == 0 and f >= warm and (f - warm) % 20 == 0:
            out["obj"][i] = (f, k, change(np.array(H), L[f - 1, k]))
    return out


def _object_displaced(out, warm, lay):
    """One object's motion off by 1 m on one frame in 20."""
    def change(H, Lp):
        H[:3, 3] += 1.0
        return H
    return _broken_object(out, warm, lay, change)


def _object_turned(out, warm, lay):
    """One object's motion turned by 30 degrees about the object's own
    centre on one frame in 20: its body-frame translation stays exact."""
    a = np.radians(30.0)
    Rz = np.eye(4)
    Rz[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]

    def change(H, Lp):
        Lc = H @ Lp                     # the true pose after the motion
        return Lc @ Rz @ R._inv(Lp)
    return _broken_object(out, warm, lay, change)


FAULTS = [_state_unchanged, _half_left_out, _answer_altered,
          _object_displaced, _object_turned]


@pytest.mark.parametrize("fault", [None] + FAULTS)
def test_harness_judges_a_broken_run(monkeypatch, fault):
    monkeypatch.setattr(harness, "load_cell", _tiny)
    seen = {}
    real_layout = loads.layout_for

    def layout_for(*a, **k):
        seen["lay"] = real_layout(*a, **k)
        return seen["lay"]

    def outputs(sysm, n_frames):
        out = _exact(seen["lay"])
        warm = _tiny(CELL)["traffic"]["warm_frames"]
        seen["out"] = fault(out, warm, seen["lay"]) if fault else out
        return seen["out"]

    monkeypatch.setattr(loads, "layout_for", layout_for)
    monkeypatch.setattr(loads, "outputs", outputs)
    result, lines = harness.run_cell(CELL, 2**32 + 3, 2, False, "cpu")
    assert result["correct"] is (fault is None), lines
    assert list(result)[-1] == "checks"
    for k, v in result["checks"].items():
        assert np.isfinite(float(v["value"])), k
    # one stream: the numbers are judge's own on the same outputs, bit-equal
    lay = seen["lay"]
    warm, n = loads.window_frames(_tiny(CELL)["traffic"], 2)
    want = R.judge(seen["out"], lay.T_wc, lay.L, R.corners(lay.obj_patches),
                   range(warm, warm + n))
    assert {k: v["value"] for k, v in result["checks"].items()} == {
        k: want[k] for k in result["checks"]}


@pytest.mark.parametrize("fault,number", [
    (_object_displaced, "obj_t_p99"), (_object_turned, "obj_corner_p99")])
def test_object_faults_at_the_cells_size(fault, number):
    """At the cell's own window, the exact answers pass, and one object
    broken on one frame in 20 fails its number; a turn about the object's
    centre leaves the translation gap at rounding."""
    c, lay, frames = _cell_layout(2**33 + 7)
    C = R.corners(lay.obj_patches)
    exact = R.judge(_exact(lay), lay.T_wc, lay.L, C, frames)
    assert R.verdict(exact, c["limits"])[0]
    got = R.judge(fault(_exact(lay), frames[0], lay), lay.T_wc, lay.L, C,
                  frames)
    assert got[number] > c["limits"][number], got
    if fault is _object_turned:
        assert got["obj_t_p99"] < 1e-9


# ---- a run of several streams (the "streams" kind, kitti-streams6) ----

def _stream_worlds(seed, seconds=20):
    """The streams cell's worlds: stream s's layout and judged frames."""
    c = _streams_cell()
    kind = loads.kind_module(c["traffic"]["kind"])
    return c, kind.worlds(c["config"], build_config(c["config"]),
                          c["traffic"], seed, seconds)


def _judged(streams, outs):
    return [R.judge(o, st.layout.T_wc, st.layout.L,
                    R.corners(st.layout.obj_patches), st.judged_frames)
            for st, o in zip(streams, outs)]


def test_numbers_over_streams_are_their_definitions():
    """frames_missing is the sum over the streams and every other number
    the worst stream's; one stream's numbers are judge's own, bit-equal; a
    stream that reads NaN makes the run's number NaN."""
    _, streams = _stream_worlds(2**31 + 5, seconds=2)
    streams = streams[:3]
    warm = streams[0].judged_frames[0]
    outs = [_exact(st.layout) for st in streams]
    _half_left_out(outs[1], warm, streams[1].layout)
    _answer_altered(outs[2], warm, streams[2].layout)
    _object_displaced(outs[2], warm, streams[2].layout)
    per = _judged(streams, outs)
    got = R.worst(per)
    assert set(got) == set(per[0])
    assert got["frames_missing"] == sum(p["frames_missing"] for p in per) > 0
    for k in got:
        if k != "frames_missing":
            assert got[k] == max(p[k] for p in per), k
    assert got["cam_t_max"] == per[2]["cam_t_max"] > per[0]["cam_t_max"]
    for p in per:
        assert R.worst([p]) == p
    i = next(i for i, e in enumerate(outs[0]["obj"]) if e[0] == warm)
    outs[0]["obj"][i] = (warm, outs[0]["obj"][i][1], np.full((4, 4), np.nan))
    assert np.isnan(R.worst(_judged(streams, outs))["obj_t_p99"])


def _streams_left_out(outs, warm, streams):
    """Half of the batch, streams 3-5, never archived."""
    for out in outs[3:]:
        for key in ("cam", "cam_ba"):
            out[key][:] = np.nan
        out["obj"] = []


def _in_stream(s, fault):
    def planted(outs, warm, streams):
        fault(outs[s], warm, streams[s].layout)
    planted.__name__ = f"{fault.__name__}_in_stream_{s}"
    return planted


# faults in one stream, never stream 0: its camera moved 50 cm on one
# frame, half its frames without a pose, its state never advancing, one
# object moved 1 m or turned 30 degrees on one frame in 20; and half of
# the batch left out
STREAM_FAULTS = [_in_stream(5, _answer_altered), _in_stream(3, _half_left_out),
                 _in_stream(2, _state_unchanged),
                 _in_stream(4, _object_displaced),
                 _in_stream(4, _object_turned), _streams_left_out]


@pytest.mark.parametrize("fault", STREAM_FAULTS,
                         ids=lambda f: f.__name__)
def test_stream_faults_at_the_cells_size(fault):
    """At the cell's own window the exact answers in every stream pass,
    and a fault in one stream fails.  An object turned in one stream of
    six hides under the pooled estimates' 99th percentile, which the worst
    stream's does not."""
    c, streams = _stream_worlds(2**33 + 17)
    outs = [_exact(st.layout) for st in streams]
    assert R.verdict(R.worst(_judged(streams, outs)), c["limits"])[0]
    fault(outs, streams[0].judged_frames[0], streams)
    ok, lines = R.verdict(R.worst(_judged(streams, outs)), c["limits"])
    assert not ok, lines
    if fault.__name__ == "_object_turned_in_stream_4":
        gt = [R.truth(st.layout.T_wc, st.layout.L) for st in streams]
        corner = np.concatenate([
            R.obj_errors([e for e in o["obj"] if e[0] in st.judged_frames],
                         g["L"], R.corners(st.layout.obj_patches))[2]
            for st, o, g in zip(streams, outs, gt)])
        assert np.percentile(corner, 99) < c["limits"]["obj_corner_p99"]


@pytest.fixture(scope="module")
def streams_run():
    """One run of the streams cell at 320x96 on the CPU (six streams of 4
    warm frames and a window of 8, window solves on), the program's
    answers replaced by the reference's own: the kind's Run and the
    run's result."""
    import itertools

    lays, kept = [], {}
    real_layout = loads.layout_for
    real_kind = loads.kind_module("streams").run

    def layout_for(*a, **k):
        lays.append(real_layout(*a, **k))
        return lays[-1]

    order = itertools.count()

    def keep(*a, **k):
        kept["run"] = real_kind(*a, **k)
        return kept["run"]

    kinds = loads.Kinds()
    kinds["streams"] = keep
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(harness, "load_cell", _tiny)
            mp.setattr(loads, "layout_for", layout_for)
            mp.setattr(loads, "outputs",
                       lambda tracker, n_frames: _exact(lays[next(order)]))
            mp.setattr(loads, "KINDS", kinds)
            result, lines = harness.run_cell(STREAMS, 2**32 + 21, 2, False,
                                             "cpu")
    finally:
        torch.set_num_threads(n)
    return kept["run"], result, lines


def test_a_streams_run_judges_every_stream(streams_run):
    run, result, lines = streams_run
    assert result["correct"], lines
    assert len(run.streams) == 6 and result["attempted"] == 6 * 8
    assert [st.judged_frames for st in run.streams] == [list(range(4, 12))] * 6
    assert len({st.layout.L.tobytes() for st in run.streams}) == 6
    assert run.e2e["frames_per_s"] == 48 / run.window_s
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", STREAM_FAULTS, ids=lambda f: f.__name__)
def test_harness_judges_a_broken_stream(monkeypatch, streams_run, fault):
    """The rest of a run of the streams cell, with one stream's answers
    (or half of the batch) broken underneath: not correct."""
    run = streams_run[0]

    def broken(*a, **k):
        r = copy.deepcopy(run)
        fault([st.outputs for st in r.streams], r.judged_frames[0],
              r.streams)
        return r

    kinds = loads.Kinds()
    kinds["streams"] = broken
    monkeypatch.setattr(loads, "KINDS", kinds)
    monkeypatch.setattr(harness, "load_cell", _tiny)
    result, lines = harness.run_cell(STREAMS, 2**32 + 21, 2, False, "cpu")
    assert result["correct"] is False, lines
