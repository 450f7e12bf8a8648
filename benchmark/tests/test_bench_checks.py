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

import numpy as np
import pytest
import torch

from benchmark import loads
from benchmark import reference as R
from benchmark import run as harness
from benchmark.program import build_config
from benchmark.run import load_cell

CELL = "kitti-drive"


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny(name):
    """The cell at a size the CPU runs in seconds: the configuration's
    camera cut to 320x96, windows of 6 / 2 frames, 4 warm frames, a window
    of 8 and a traced stretch of 4."""
    c = copy.deepcopy(load_cell(name))
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
        return fault(out, warm, seen["lay"]) if fault else out

    monkeypatch.setattr(loads, "layout_for", layout_for)
    monkeypatch.setattr(loads, "outputs", outputs)
    result, lines = harness.run_cell(CELL, 2**32 + 3, 2, False, "cpu")
    assert result["correct"] is (fault is None), lines
    assert list(result)[-1] == "checks"
    for k, v in result["checks"].items():
        assert np.isfinite(float(v["value"])), k


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
