"""The port's BA passes against the JAX package's on a real tracked map: the
8-frame, 320x240, 2-object sequence of tests/conftest.py (tracked by the
JAX package), copied field by field into the port's MapState.

  * Builders: build_window_graph and build_full_graph give the same arrays
    and the same GraphMeta, at atol=0; empty_window_graph gives the JAX
    package's arrays for both tiers, and the real window build's shapes.
  * In-place passes on deep copies of the map: local_ba_inplace(window=6)
    and full_ba_inplace in both packages.  The written-back cam_pose,
    cam_pose_rf and rigid_motion(_rf) entries within 1e-4; stat_3d and
    dyn_3d within 1e-3 m plus 2e-4 of the coordinate (far points are the
    least constrained); costs within 1e-4 relative; edge counts exact;
    metric_report within 2e-6 m / 2e-5 deg absolute (5 % relative where
    larger): fp32 solves summed in another order.
  * System level: the port's System with both passes on, on the CPU, over
    the same scene with window 6 / overlap 2 (one window trigger, at
    archived frame 5); its refined metrics stay under the bounds of
    tests/test_torch_slice.py's test_system_metrics_within_e2e_bounds,
    taken against the JAX tracker's numbers on that map.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_slice import port_config
from vdo_slam_tpu.backend import builders as jbuilders
from vdo_slam_tpu.backend import full_ba as jfull
from vdo_slam_tpu.backend import window_ba as jwindow
from vdo_slam_tpu.eval import results as jresults
from vdo_slam_tpu_torch.backend import builders as pbuilders
from vdo_slam_tpu_torch.backend import full_ba as pfull
from vdo_slam_tpu_torch.backend import window_ba as pwindow
from vdo_slam_tpu_torch.eval import results as presults
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.io.synthetic import make_scene
from vdo_slam_tpu_torch.pipeline import System
from vdo_slam_tpu_torch.pipeline import map_state as pmap_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs in several worker processes at once, and each worker's idle
    OpenMP threads spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CAPS = dict(full_obs_cap=16384, full_ter_cap=8192, full_point_cap=16384,
            full_motion_cap=64, full_smo_cap=64)


def _host(x):
    if isinstance(x, list):
        return [_host(y) for y in x]
    if hasattr(x, "__array__") and not isinstance(x, np.ndarray):
        return np.array(x)
    return copy.deepcopy(x)


def port_map(jm):
    """The JAX package's MapState, field by field, as the port's."""
    pm = pmap_state.MapState()
    for f in dataclasses.fields(jm):
        setattr(pm, f.name, _host(getattr(jm, f.name)))
    return pm


@pytest.fixture(scope="module")
def session(tracked_session):
    jcfg = tracked_session["cfg"]
    return tracked_session["sysm"].map, jcfg, port_config(jcfg)


def _same_arrays(a, b, names):
    for n in names:
        x, y = np.asarray(getattr(a, n)), np.asarray(getattr(b, n))
        assert x.dtype == y.dtype and x.shape == y.shape, n
        np.testing.assert_array_equal(x, y, err_msg=n)


def _same_meta(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, (tuple, list)) and y and isinstance(y[0], np.ndarray):
            assert len(x) == len(y), f.name
            for u, w in zip(x, y):
                np.testing.assert_array_equal(u, w, err_msg=f.name)
        else:
            assert x == y, f.name


def _same_stat_obs(a, b):
    """The write-back's (frames, feats, pids), dtypes included."""
    assert len(a.stat_obs) == len(b.stat_obs) == 3
    for u, w in zip(a.stat_obs, b.stat_obs):
        assert u.dtype == w.dtype
        np.testing.assert_array_equal(u, w, err_msg="stat_obs")


GRAPH = [f.name for f in dataclasses.fields(jbuilders.Graph)]
VARS = ("poses", "motions", "points")


@pytest.mark.parametrize("kw", [dict(), dict(window=6),
                                dict(window=6, n_frames=7),
                                dict(window=5, n_frames=7),
                                dict(window=4, n_frames=7),
                                dict(window=3, n_frames=7)],
                         ids=["default", "window6", "window6_pinned",
                              "window5_start2", "window4_start3",
                              "window3_start4"])
def test_build_window_graph_identical(session, kw):
    jm, jcfg, pcfg = session
    gj, vj, mj = jbuilders.build_window_graph(jm, jcfg, **kw)
    gp, vp, mp = pbuilders.build_window_graph(port_map(jm), pcfg, **kw)
    _same_arrays(gp, gj, GRAPH)
    _same_arrays(vp, vj, VARS)
    _same_meta(mp, mj)
    _same_stat_obs(mp, mj)
    assert mp.n_static_points > 20


@pytest.mark.parametrize("caps", [False, True], ids=["buckets", "caps"])
def test_build_full_graph_identical(session, caps):
    jm, jcfg, pcfg = session
    if caps:
        jcfg = jcfg.replace(backend=dataclasses.replace(jcfg.backend, **CAPS))
        pcfg = pcfg.replace(backend=dataclasses.replace(pcfg.backend, **CAPS))
    gj, vj, mj = jbuilders.build_full_graph(jm, jcfg)
    gp, vp, mp = pbuilders.build_full_graph(port_map(jm), pcfg)
    _same_arrays(gp, gj, GRAPH)
    _same_arrays(vp, vj, VARS)
    _same_meta(mp, mj)
    assert mp.n_motions >= 2 and int(np.sum(np.asarray(gp.ter_w) > 0)) > 20


def test_empty_window_graph_tiers(session):
    jm, jcfg, pcfg = session
    assert pbuilders.WINDOW_TIERS == jbuilders.WINDOW_TIERS
    assert (pbuilders.P_CAP, pbuilders.E_CAP) == (jbuilders.P_CAP,
                                                 jbuilders.E_CAP)
    W = min(pcfg.tracking.window_size, jm.num_frames)
    g_real, v_real, _ = pbuilders.build_window_graph(port_map(jm), pcfg)
    shapes = [np.shape(getattr(g_real, n)) for n in GRAPH]
    matches = []
    for t in range(len(pbuilders.WINDOW_TIERS)):
        gp, vp = pbuilders.empty_window_graph(pcfg, window=W, tier=t)
        gj, vj = jbuilders.empty_window_graph(jcfg, window=W, tier=t)
        _same_arrays(gp, gj, GRAPH)
        _same_arrays(vp, vj, VARS)
        if [np.shape(getattr(gp, n)) for n in GRAPH] == shapes:
            assert np.shape(vp.points) == np.shape(v_real.points)
            matches.append(t)
    assert matches == [0]


def _metrics_close(a, b):
    assert a["n_obj_estimates"] == b["n_obj_estimates"]
    for k, atol in (("cam_t_rpe", 2e-6), ("cam_r_rpe_deg", 2e-5),
                    ("obj_t_rpe", 2e-6), ("obj_r_rpe_deg", 2e-5)):
        assert abs(a[k] - b[k]) <= max(atol, 0.05 * abs(b[k])), (k, a, b)


def _poses_close(a, b, atol, rtol=0.0):
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=atol,
                                   rtol=rtol)


def _reports_close(ip, ij):
    assert ip["cost0"] == pytest.approx(ij["cost0"], rel=1e-5)
    assert abs(ip["cost"] - ij["cost"]) <= 1e-4 * ij["cost0"]
    assert ip["cost"] <= ip["cost0"]
    for name, s in ij["edge_stats"].items():
        assert int(ip["edge_stats"][name]["n"]) == int(s["n"])


def test_local_ba_inplace_agrees(session):
    jm0, jcfg, pcfg = session
    jm, pm = copy.deepcopy(jm0), port_map(jm0)
    ij = jwindow.local_ba_inplace(jm, jcfg, window=6, iters=6)
    ip = pwindow.local_ba_inplace(pm, pcfg, window=6, iters=6, device="cpu")
    _reports_close(ip, ij)
    for k in ("n_points", "window", "n_tracks_dropped"):
        assert ip[k] == ij[k]
    assert ip["build_frames"] == min(jm.num_frames, 6 + 1)
    for k in ("t_build_ms", "t_dispatch_ms", "t_exec_ms", "t_fetch_ms",
              "t_writeback_ms"):
        assert ip[k] >= 0.0
    assert ip["cost"] < ip["cost0"]
    _poses_close(pm.cam_pose, jm.cam_pose, 1e-4)
    _poses_close([r[0] for r in pm.rigid_motion],
                 [r[0] for r in jm.rigid_motion], 1e-4)
    _poses_close(pm.stat_3d, jm.stat_3d, 1e-3, 2e-4)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(pm.cam_pose, jm0.cam_pose))
    assert moved > 1e-6
    _metrics_close(presults.metric_report(pm), jresults.metric_report(jm))


def test_local_ba_pcg_solver(session):
    """solver="pcg" (the matrix-free LM of the full BA on the window
    graph) lowers the cost and lands near the Schur solve, as the JAX
    package's test_window_ba_schur_on_tracked_map asks of its own."""
    jm, _, pcfg = session
    schur = pwindow.local_ba_inplace(port_map(jm), pcfg, window=6, iters=6,
                                     device="cpu")
    pcg = pwindow.local_ba_inplace(port_map(jm), pcfg, window=6, iters=6,
                                   solver="pcg", device="cpu")
    assert pcg["cost"] < pcg["cost0"] == pytest.approx(schur["cost0"])
    assert schur["cost"] <= pcg["cost"] * 1.5 + 1e-3


def test_full_ba_inplace_agrees(session):
    jm0, jcfg, pcfg = session
    jm, pm = copy.deepcopy(jm0), port_map(jm0)
    ij = jfull.full_ba_inplace(jm, jcfg)
    ip = pfull.full_ba_inplace(pm, pcfg, device="cpu")
    _reports_close(ip, ij)
    for k in ("n_static", "n_dyn", "n_motions", "iters_run"):
        assert ip[k] == ij[k]
    assert len(ip["chunk_times"]) >= 1 and ip["t_solve_s"] > 0
    _poses_close(pm.cam_pose_rf, jm.cam_pose_rf, 1e-4)
    for a, b in zip(pm.rigid_motion_rf, jm.rigid_motion_rf):
        _poses_close(a, b, 1e-4)
    _poses_close(pm.stat_3d, jm.stat_3d, 1e-3, 2e-4)
    _poses_close(pm.dyn_3d, jm.dyn_3d, 1e-3, 2e-4)
    _metrics_close(presults.metric_report(pm, refined=True),
                   jresults.metric_report(jm, refined=True))
    assert pm.g2o_dump["n_points"] == jm.g2o_dump["n_points"]
    assert pfull.scaled_lm_params(pcfg, 245760).cg_iters == 12
    assert pfull.scaled_lm_params(pcfg, 16384).cg_iters == 48


def test_system_with_both_passes(session):
    """The port's System, both passes on, on the CPU (window 6, overlap 2:
    the trigger fires at archived frame 5 only)."""
    jm, jcfg, _ = session
    scene = make_scene(num_frames=8, width=320, height=240, num_objects=2,
                       seed=3)
    pcfg = port_config(jcfg)
    pcfg = pcfg.replace(tracking=dataclasses.replace(
        pcfg.tracking, window_size=6, overlap_size=2))
    sysm = System(pcfg, enable_local_ba=True, enable_global_ba=True,
                  mode="fused", device="cpu")
    reports = sysm.run_sequence(SyntheticDataset(scene, depth_map_factor=1.0,
                                                 bf=40.0))
    assert len(reports) == 7
    assert [h["window"] for h in sysm.tracker.ba_health] == [6]
    assert len(sysm.map.lba_times) == 1 and sysm.map.lba_times[0] > 0
    assert sysm.timing()["local_ba_ms"] == sysm.map.lba_times[0]
    h = sysm.tracker.ba_health[0]
    assert h["cost"] <= h["cost0"] and h["n_points"] > 20
    full = sysm.full_ba_report
    assert full is not None and full["cost"] < full["cost0"]
    rep, ref = sysm.metrics(refined=True), jresults.metric_report(jm)
    assert rep["cam_t_rpe"] < max(3.0 * ref["cam_t_rpe"], 0.005), (rep, ref)
    assert rep["cam_r_rpe_deg"] < max(3.0 * ref["cam_r_rpe_deg"], 0.01)
    assert rep["obj_t_rpe"] < 0.02, rep
    assert rep["n_obj_estimates"] > 0 and ref["n_obj_estimates"] > 0
