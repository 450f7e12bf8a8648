"""The "refine" kind (benchmark/kinds/refine.py) and its cell
kitti-refine-1000 on the CPU at a tiny size: the kind runs through
loads.KINDS with no edit to the harness, the window is the System's
refine repeated on a restored archive, a traced run's refine_* metrics
are read, and each planted fault makes a run not correct: the refine
skipped, one frame's refined camera moved 50 cm, one object's refined
motion turned 30 degrees on one frame in 20, refined points written back
to the wrong frames, the reported cost altered.  A forced cap overflow
counts as failed.

The program runs for real at 320x96 over 10 frames; where the judge's
numbers are the point, the refined answers it reads are replaced by the
reference's exact ones (the program's own accuracy at that size is not
what these tests hold), so that only the planted fault can fail the
run."""

import copy

import numpy as np
import pytest
import torch

from benchmark import loads
from benchmark import reference as R
from benchmark import run as harness
from benchmark.run import load_cell
from benchmark.trace import WindowTrace
from benchmark.tests.test_bench_yardstick import _FakeProfile
from vdo_slam_tpu_torch.pipeline import system as sysmod

CELL = "kitti-refine-1000"
FRAMES = 10


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny(name, **backend):
    """The cell at 320x96, windows of 6 / 2, a drive of FRAMES frames, 4
    warm, at least 2 refines, and full_* caps that fit it."""
    c = copy.deepcopy(load_cell(name))
    conf = c["config"]["config"]
    conf["camera"].update(width=320, height=96, cx=160.0, cy=48.0)
    conf["tracking"].update(window_size=6, overlap_size=2)
    conf["backend"].update({"full_obs_cap": 16384, "full_ter_cap": 8192,
                            "full_point_cap": 16384, "full_motion_cap": 64,
                            "full_smo_cap": 64, **backend})
    c["traffic"].update(frames=FRAMES, warm_frames=4, min_refines=2)
    return c


def _exact(lay):
    """The reference's own answers in the program's place."""
    gt = R.truth(lay.T_wc, lay.L)
    F, K = lay.L.shape[:2]
    Lw = gt["L"]
    obj = [(f, k, Lw[f, k] @ R._inv(Lw[f - 1, k]))
           for f in range(1, F) for k in range(K)]
    return {"cam": gt["T_wc"].copy(), "cam_ba": gt["T_wc"].copy(),
            "obj": obj}


def _camera_moved(out, lay):
    out["cam"][5:, 0, 3] += 0.5        # one frame's motion off by 50 cm
    return out


def _object_turned(out, lay):
    """Object 0's refined motion turned by 30 degrees about its centre on
    one frame in 20."""
    L = R.truth(lay.T_wc, lay.L)["L"]
    a = np.radians(30.0)
    Rz = np.eye(4)
    Rz[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    for i, (f, k, H) in enumerate(out["obj"]):
        if k == 0 and f % 20 == 1:
            Lp = L[f - 1, k]
            out["obj"][i] = (f, k, (H @ Lp) @ Rz @ R._inv(Lp))
    return out


def _run(monkeypatch, answers=None, trace=False, **backend):
    """One run of the tiny cell: (result, lines, the kind's Run).  With
    `answers`, the kind's refined outputs are the reference's exact ones
    passed through answers(out, layout)."""
    mod = loads.kind_module("refine")
    kept = {}
    if answers is not None:
        def outputs(sysm, n_frames):
            lay = kept["lay"]
            return answers(_exact(lay), lay)
        monkeypatch.setattr(mod, "refined_outputs", outputs)
        real_worlds = mod.worlds

        def worlds(*a, **k):
            out = real_worlds(*a, **k)
            kept["lay"] = out[0].layout
            return out
        monkeypatch.setattr(mod, "worlds", worlds)

    def keep(*a, **k):
        kept["run"] = mod.run(*a, **k)
        return kept["run"]

    kinds = loads.Kinds()
    kinds["refine"] = keep
    monkeypatch.setattr(loads, "KINDS", kinds)
    monkeypatch.setattr(harness, "load_cell",
                        lambda name: _tiny(name, **backend))
    monkeypatch.setattr(WindowTrace, "profile_factory", _FakeProfile)
    result, lines = harness.run_cell(CELL, 2**32 + 41, 0, trace, "cpu")
    return result, lines, kept["run"]


def test_the_kind_runs_through_kinds_with_no_edit(monkeypatch):
    """loads.KINDS finds the kind by its file; the window repeats the
    refine on the restored archive, each reading the same costs, and a
    run of the exact answers is correct."""
    assert set(loads.kind_module("refine").__dict__) >= {"run", "worlds"}
    seen = []
    real = sysmod.System.refine

    def refine(self):
        rep = real(self)
        seen.append((rep["cost0"], rep["cost"],
                     self.map.cam_pose_rf[FRAMES - 1].copy()))
        return rep

    monkeypatch.setattr(sysmod.System, "refine", refine)
    result, lines, run = _run(monkeypatch, answers=lambda o, lay: o)
    assert result["correct"], lines
    assert result["attempted"] == len(seen) >= 2 and result["failed"] == 0
    assert len({(a, b) for a, b, _ in seen}) == 1
    for _, _, pose in seen[1:]:
        np.testing.assert_array_equal(pose, seen[0][2])
    assert result["metrics"]["frames_per_s"]["value"] == \
        run.e2e["frames_per_s"] > 0
    assert run.judged_frames == list(range(1, FRAMES))


def test_a_traced_run_reads_the_refine_metrics(monkeypatch):
    _FakeProfile.made.clear()
    result, lines, run = _run(monkeypatch, answers=lambda o, lay: o,
                              trace=True)
    assert result["correct"], lines
    got = result["metrics"]
    assert set(got) == {"refine_build_ms", "refine_writeback_ms",
                        "refine_lm_device_ms", "refine_lm_roofline_pct",
                        "refine_idle_pct"}
    assert 0 < got["refine_lm_roofline_pct"]["value"] <= 100
    # the traced refine is one more than the window's
    assert len(run.refine["build_ms"]) == result["attempted"] - 1
    assert len(run.refine["chunks"]) == 1
    assert run.trace.t0_ns < run.trace.t1_ns


def _skipped(self):
    """The refine skipped: the archive left as tracking left it, and the
    report of an earlier refine handed back."""
    if self.full_ba_report is None:
        return _real_refine(self)
    return dict(self.full_ba_report)


def _points_elsewhere(self):
    """The refined static points written back one frame later."""
    rep = _real_refine(self)
    m = self.map
    m.stat_3d[:] = m.stat_3d[-1:] + m.stat_3d[:-1]
    return rep


def _cost_altered(self):
    rep = _real_refine(self)
    rep["cost"] *= 1.001
    return rep


_real_refine = sysmod.System.refine


@pytest.mark.parametrize("fault", [_skipped, _points_elsewhere,
                                   _cost_altered], ids=lambda f: f.__name__)
def test_the_objective_check_catches(monkeypatch, fault):
    monkeypatch.setattr(sysmod.System, "refine", fault)
    result, lines, _ = _run(monkeypatch, answers=lambda o, lay: o)
    assert result["correct"] is False, lines
    assert result["checks"]["frames_missing"]["value"] == FRAMES - 1


@pytest.mark.parametrize("fault", [_camera_moved, _object_turned],
                         ids=lambda f: f.__name__)
def test_the_judge_catches(monkeypatch, fault):
    result, lines, _ = _run(monkeypatch, answers=fault)
    assert result["correct"] is False, lines


def test_a_refine_that_returns_nothing_fails(monkeypatch):
    monkeypatch.setattr(sysmod.System, "refine", lambda self: None)
    result, lines, _ = _run(monkeypatch, answers=lambda o, lay: o)
    assert result["correct"] is False
    assert result["failed"] == result["attempted"] >= 2


def test_a_cap_overflow_counts_as_failed(monkeypatch):
    result, lines, _ = _run(monkeypatch, answers=lambda o, lay: o,
                            full_obs_cap=64)
    assert result["failed"] == result["attempted"] >= 2


def test_control_fails_the_limits():
    """The reference in bfloat16 over the cell's own 1,028-frame drive: a
    number it reads is above its limit."""
    from benchmark.program import build_config

    c = load_cell(CELL)
    kind = loads.kind_module("refine")
    (st,) = kind.worlds(c["config"], build_config(c["config"]), c["traffic"],
                        2**31 + 11, 20)
    assert st.judged_frames == list(range(1, c["traffic"]["frames"]))
    got = R.control(st.layout.T_wc, st.layout.L,
                    R.corners(st.layout.obj_patches), st.judged_frames)
    ok, lines = R.verdict(got, c["limits"])
    assert not ok, lines
