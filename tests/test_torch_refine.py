"""The end-of-sequence full-batch refine against its plain reference
(vdo_slam_tpu_torch/eval/plain_full_batch.py), and the refine on the
System's normal path, on the CPU.

The archive: the port's fused System over the synthetic two-object scene
at 160x120, 12 frames, window 6 / overlap 2 (two window solves), with
the refine held back (run_sequence(refine=False)); 878 points, 2,668
observation, 559 ternary and 9 smoothness edges, 10 motions, so that the
reference's dense LM solves its ~2,800 unknowns exactly in well under a
second per iteration.

  * the reference's factor set has the program's edge and vertex counts;
  * the program's reported cost0 and cost equal the reference's float64
    objective within FLOAT32_RTOL, and poses held in bfloat16 move the
    objective by more than that;
  * with a budget that converges (30 LM iterations of 200 PCG steps),
    full_ba_inplace and the reference's dense LM reach the same objective
    and the same poses;
  * a planted change to one factor's weight, or to one edge type's, is
    caught by the objective;
  * the reference imports torch and numpy only, and the benchmark's copy
    is this file byte for byte;
  * System.refine, run_sequence(refine=False), System.warmup_refine (the
    refine then makes no graph of its own), the spans and counters of a
    refine, silence with the recorder off, and a cap that overflows.
"""

import ast
import contextlib
import copy
import dataclasses
import io
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_pipeline_e2e import small_config
from tests.test_torch_slice import port_config
from vdo_slam_tpu_torch.backend import full_ba as pfull
from vdo_slam_tpu_torch.backend.builders import build_full_graph
from vdo_slam_tpu_torch.eval import plain_full_batch as ref
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.io.synthetic import make_scene
from vdo_slam_tpu_torch.pipeline import System
from vdo_slam_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
# The program sums the Huber cost of every edge in float32: each
# residual T^-1 X - meas loses ~6e-8 of X's tens of metres against a
# residual of ~1e-2 m, ~1e-4 of that edge's cost at worst, with signs
# that average out over thousands of edges; read 1.3e-8 to 2.8e-6 here
# and at 320x96 (PERF.md).  bfloat16 poses move it by 1e-2 or more.
FLOAT32_RTOL = 2e-5
SPANS = ["full.build", "full.upload", "full.chunk", "full.fetch",
         "full.writeback"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**backend):
    scene = make_scene(num_frames=12, width=160, height=120, num_objects=2,
                       seed=3)
    cfg = small_config(scene, window_size=6, overlap_size=2,
                       max_track_points_obj=60)
    cfg = cfg.replace(
        shapes=dataclasses.replace(cfg.shapes, max_static=200),
        frontend=dataclasses.replace(cfg.frontend, n_features=600))
    cfg = port_config(cfg)
    cfg = dataclasses.replace(cfg, backend=dataclasses.replace(cfg.backend,
                                                                **backend))
    return scene, cfg


@pytest.fixture(scope="module")
def tracked():
    """The System after tracking, its refine held back, and a copy of its
    map as tracking left it."""
    scene, cfg = _config()
    sysm = System(cfg, enable_local_ba=True, enable_global_ba=True,
                  mode="fused", device="cpu")
    with contextlib.redirect_stderr(io.StringIO()):
        sysm.run_sequence(SyntheticDataset(scene, depth_map_factor=1.0,
                                           bf=40.0), refine=False)
    return sysm, copy.deepcopy(sysm.map), cfg


def _settings(cfg):
    return ref.settings(dataclasses.asdict(cfg.backend),
                        dataclasses.asdict(cfg.camera))


def _initial(p):
    return ref.objective(p, p.poses0, p.motions0, p.points0)["cost"]


def _gap(a, b):
    return abs(a - b) / abs(b)


# --------------------------------------------------------------------------
# the plain reference
# --------------------------------------------------------------------------

def test_reference_counts_the_programs_edges(tracked):
    _, m, cfg = tracked
    _, _, meta = build_full_graph(m, cfg)
    got = ref.build(m, _settings(cfg)).counts()
    assert {k: c["n"] for k, c in meta.caps.items()} == {
        k: got[k] for k in meta.caps}
    assert got["odo"] == m.num_frames - 1 and got["alt"] == 0
    assert got["ternary"] > 100 and got["smooth"] > 0


def test_reported_costs_are_the_references_objective(tracked):
    _, m0, cfg = tracked
    m = copy.deepcopy(m0)
    p = ref.build(m, _settings(cfg))
    rep = pfull.full_ba_inplace(m, cfg, device="cpu")
    chk = ref.check(p, rep, m, FLOAT32_RTOL)
    assert chk["ok"], chk
    assert chk["cost0_gap"] <= FLOAT32_RTOL and chk["cost_gap"] <= FLOAT32_RTOL
    assert rep["cost"] < rep["cost0"]
    # the same readings from the objective's own evaluation
    assert chk["cost0_ref"] == _initial(p)


def test_bfloat16_poses_fail_the_tolerance(tracked):
    """The control: the archive's poses held in bfloat16 move the
    objective by more than FLOAT32_RTOL."""
    _, m, cfg = tracked
    p = ref.build(m, _settings(cfg))
    bf = torch.from_numpy(p.poses0).to(torch.bfloat16).double().numpy()
    held = ref.objective(p, bf, p.motions0, p.points0)["cost"]
    assert _gap(held, _initial(p)) > 10 * FLOAT32_RTOL


def test_converged_refine_matches_the_dense_lm(tracked):
    """30 LM iterations of 200 PCG steps in one chunk, no gain stop,
    against the reference's dense LM for 30 iterations: the same
    objective to 1e-5, the same poses to 1e-5 m, the motions to 1e-4."""
    _, m0, cfg = tracked
    m = copy.deepcopy(m0)
    p = ref.build(m, _settings(cfg))
    cfg = dataclasses.replace(cfg, backend=dataclasses.replace(
        cfg.backend, full_iters=30, cg_iters=200, full_ba_chunk=30,
        full_gain_thres=0.0))
    rep = pfull.full_ba_inplace(m, cfg, device="cpu")
    poses, motions, _ = ref.refined(p, m)
    d_poses, d_motions, _, history = ref.dense_lm(p, 30)
    got = ref.objective(p, *ref.refined(p, m))["cost"]
    assert _gap(got, history[-1]) < 1e-5
    assert _gap(rep["cost"], history[-1]) < 1e-5
    assert history[-1] < 0.5 * history[0]
    assert np.abs(poses - d_poses).max() < 1e-5
    assert np.abs(motions - d_motions).max() < 1e-4


@pytest.mark.parametrize("plant", ["one_edge", "one_type"])
def test_a_planted_weight_is_caught(tracked, plant):
    """The reference with one factor's weight changed reads the program's
    cost0 outside the tolerance: the edge of the largest cost, its weight
    doubled, or every ternary edge's (sigma2_obj halved; a dynamic
    observation costs nothing at the start, its point being its own
    back-projection)."""
    _, m0, cfg = tracked
    m = copy.deepcopy(m0)
    rep = pfull.full_ba_inplace(m, cfg, device="cpu")
    p = ref.build(m0, _settings(cfg))
    assert _gap(rep["cost0"], _initial(p)) <= FLOAT32_RTOL
    if plant == "one_edge":
        r = np.einsum("fij,fj->fi", np.linalg.inv(p.poses0[p.obs_pose])[
            :, :3, :3], p.points0[p.obs_point]) + np.linalg.inv(
            p.poses0[p.obs_pose])[:, :3, 3] - p.obs_meas
        worst = np.argmax(p.obs_w * np.sum(r * r, 1))
        p.obs_w = p.obs_w.copy()
        p.obs_w[worst] *= 2.0
    else:
        s = _settings(cfg)
        p = ref.build(m0, dataclasses.replace(s,
                                              sigma2_obj=s.sigma2_obj / 2))
    assert _gap(rep["cost0"], _initial(p)) > FLOAT32_RTOL


def test_reference_imports_torch_and_numpy_only():
    src = (ROOT / "vdo_slam_tpu_torch/eval/plain_full_batch.py").read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0] or ".")
    assert names <= {"__future__", "dataclasses", "math", "numpy", "torch"}


def test_benchmarks_copy_is_the_reference():
    assert (ROOT / "benchmark/full_batch_reference.py").read_bytes() == (
        ROOT / "vdo_slam_tpu_torch/eval/plain_full_batch.py").read_bytes()


# --------------------------------------------------------------------------
# the refine on the System's normal path
# --------------------------------------------------------------------------

def _system_with(m0, cfg):
    """A System whose map is a copy of the tracked archive."""
    sysm = System(cfg, enable_local_ba=False, enable_global_ba=True,
                  mode="fused", device="cpu")
    sysm.map = copy.deepcopy(m0)
    return sysm


def test_refine_held_back_then_public(tracked):
    sysm, m0, cfg = tracked
    assert sysm.full_ba_report is None
    s = _system_with(m0, cfg)
    rep = s.refine()
    assert rep is s.full_ba_report and rep["cost"] < rep["cost0"]
    # the held-back archive kept the tracked poses, which the refine moves
    assert max(np.abs(a - b).max() for a, b in zip(s.map.cam_pose_rf,
                                                   m0.cam_pose_rf)) > 1e-6
    assert rep["caps_held"] and rep["chunk_modes"] == ["eager"]
    # the same solve as full_ba_inplace on the same archive
    m = copy.deepcopy(m0)
    want = pfull.full_ba_inplace(m, cfg, device="cpu")
    assert (rep["cost0"], rep["cost"]) == (want["cost0"], want["cost"])
    for a, b in zip(s.map.cam_pose_rf, m.cam_pose_rf):
        np.testing.assert_array_equal(a, b)


def test_warmup_makes_every_graph_the_refine_runs(tracked):
    """After warmup_refine for the archive's length, the refine's chunks
    run from graphs the warm-up made (on a card they replay): the refine
    adds no graph of its own."""
    _, m0, cfg = tracked
    _, cfg = _config(full_obs_cap=4096, full_ter_cap=1024,
                     full_point_cap=2048, full_motion_cap=16,
                     full_smo_cap=16)
    s = _system_with(m0, cfg)
    s.warmup_refine(m0.num_frames)
    made = set(s.full_graphs._calls)
    assert made
    rep = s.refine()
    assert rep["caps_held"]
    assert set(s.full_graphs._calls) == made
    assert len(rep["chunk_modes"]) == 1


def test_refine_spans_nest_and_counters_are_the_reports(tracked):
    _, m0, cfg = tracked
    s = _system_with(m0, cfg)
    with profiling.recording() as rec:
        rep = s.refine()
    (top,) = rec.named("full.refine")
    assert top.parent is None and top.unit == m0.num_frames
    kids = [sp for sp in rec.spans if sp.parent == top.id]
    assert [k.name for k in kids] == SPANS
    assert [k.unit for k in rec.named("full.chunk")] == [0]
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    assert top.start_ns <= kids[0].start_ns and kids[-1].end_ns <= top.end_ns
    assert 0 <= kids[0].cpu_ns <= kids[0].wall_ns
    got = {c.name: c.value for c in rec.counts if c.name != "full.chunk"}
    want = {f"full.{k}": c["n"] for k, c in rep["caps"].items()}
    want.update({f"full.{k}_padded": c["padded"]
                 for k, c in rep["caps"].items()})
    want.update({"full.caps_held": True, "full.cg_iters": rep["cg_iters"],
                 "full.iters_run": rep["iters_run"]})
    assert got == want
    assert [(c.value, c.unit) for c in rec.counted("full.chunk")] == [
        (mode, i) for i, mode in enumerate(rep["chunk_modes"])]
    assert all(c.parent == top.id for c in rec.counts)


def test_refine_off_reads_no_clock(tracked, monkeypatch):
    _, m0, cfg = tracked
    s = _system_with(m0, cfg)

    def boom():
        raise AssertionError("a clock was read with the recorder off")

    monkeypatch.setattr(time, "time_ns", boom)
    monkeypatch.setattr(time, "thread_time_ns", boom)
    assert profiling.ACTIVE is None
    assert s.refine()["caps_held"]


def test_an_overflowing_cap_shows_in_report_and_counter(tracked):
    _, m0, _ = tracked
    _, cfg = _config(full_obs_cap=64)
    s = _system_with(m0, cfg)
    err = io.StringIO()
    with profiling.recording() as rec, contextlib.redirect_stderr(err):
        rep = s.refine()
    assert rep["caps_held"] is False
    c = rep["caps"]["obs"]
    assert c["cap"] == 64 and c["n"] > 64 and c["padded"] >= c["n"]
    assert [x.value for x in rec.counted("full.caps_held")] == [False]
    assert "obs" in err.getvalue() and "exceeds configured cap 64" in \
        err.getvalue()
