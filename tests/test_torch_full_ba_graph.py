"""The full BA's compiled program in the port (backend/full_ba.py:
FullBAGraphs, warmup_full_ba; builders.empty_full_graph) on its CPU path:
the graphs run eagerly on the same static buffers the card's graphs run
on, so the buffer handling is reached here.  The map is the JAX-tracked
8-frame, 320x240 session map of tests/conftest.py, as in
tests/test_torch_backend.py, under that file's small full-graph caps.

  * empty_full_graph against the JAX package's at atol=0, against
    build_full_graph's shapes under the same caps, and its ValueError
    without caps;
  * warmup_full_ba then full_ba_inplace(graphs=...) bit-equal to the eager
    full_ba_inplace, and within test_torch_backend.py's bounds of the JAX
    package's full_ba_inplace;
  * chunks of one LM iteration over three: the reported cost0 and stats0
    are chunk 0's, although every later chunk's replay overwrites the
    graph's outputs;
  * the edge-sharded solve through FullBAGraphs over ["cpu"] * n
    (warmup_full_ba, then full_ba_inplace) bit-equal to the eager sharded
    full_ba_inplace over the same list; graphs made for another device
    list than the solve's, and graphs over distinct cards, raise.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_backend import (CAPS, GRAPH, VARS, _metrics_close,
                                      _poses_close, _reports_close,
                                      _same_arrays, port_map)
from tests.test_torch_slice import port_config
from vdo_slam_tpu.backend import builders as jbuilders
from vdo_slam_tpu.backend import full_ba as jfull
from vdo_slam_tpu.eval import results as jresults
from vdo_slam_tpu_torch.backend import builders as pbuilders
from vdo_slam_tpu_torch.backend import full_ba as pfull
from vdo_slam_tpu_torch.eval import results as presults


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs this file in one of several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def capped(tracked_session):
    """(JAX map, JAX config, port config), both configs with CAPS."""
    jcfg = tracked_session["cfg"]
    jcfg = jcfg.replace(backend=dataclasses.replace(jcfg.backend, **CAPS))
    return tracked_session["sysm"].map, jcfg, port_config(jcfg)


def _same_map(a, b):
    """Every array full_ba_inplace writes back, bit for bit."""
    for name in ("cam_pose_rf", "stat_3d", "dyn_3d"):
        for x, y in zip(getattr(a, name), getattr(b, name), strict=True):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=name)
    for ra, rb in zip(a.rigid_motion_rf, b.rigid_motion_rf, strict=True):
        for x, y in zip(ra, rb, strict=True):
            np.testing.assert_array_equal(x, y)


def _same_stats(a, b):
    for name, s in b.items():
        for k, v in s.items():
            assert np.asarray(a[name][k]) == np.asarray(v), (name, k)


def test_empty_full_graph_matches_jax_and_build_shapes(capped):
    jm, jcfg, pcfg = capped
    n = jm.num_frames
    gp, vp = pbuilders.empty_full_graph(pcfg, n)
    gj, vj = jbuilders.empty_full_graph(jcfg, n)
    _same_arrays(gp, gj, GRAPH)
    _same_arrays(vp, vj, VARS)
    g_real, v_real, _ = pbuilders.build_full_graph(port_map(jm), pcfg)
    for names, a, b in ((GRAPH, gp, g_real), (VARS, vp, v_real)):
        for name in names:
            x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
            assert x.shape == y.shape and x.dtype == y.dtype, name
    assert float(np.abs(np.asarray(gp.obs_w)).max()) == 0.0
    uncapped = pcfg.replace(
        backend=dataclasses.replace(pcfg.backend, full_obs_cap=None))
    with pytest.raises(ValueError, match="caps"):
        pbuilders.empty_full_graph(uncapped, n)


@pytest.fixture(scope="module")
def solved(capped):
    """The capped map refined by the eager and the graphed full_ba_inplace
    (after warmup_full_ba) and by the JAX package's."""
    jm0, jcfg, pcfg = capped
    eager_map, graph_map, jm = port_map(jm0), port_map(jm0), copy.deepcopy(
        jm0)
    eager = pfull.full_ba_inplace(eager_map, pcfg, device="cpu")
    graphs = pfull.FullBAGraphs("cpu")
    pfull.warmup_full_ba(pcfg, jm0.num_frames, graphs)
    keys = set(graphs._calls)
    graphed = pfull.full_ba_inplace(graph_map, pcfg, device="cpu",
                                    graphs=graphs)
    return {"eager": (eager, eager_map), "graphed": (graphed, graph_map),
            "jax": (jfull.full_ba_inplace(jm, jcfg), jm),
            "warm_keys": keys, "keys": set(graphs._calls), "cfg": pcfg}


def test_graphed_full_ba_equals_eager(solved):
    (ie, me), (ig, mg) = solved["eager"], solved["graphed"]
    for k in ("cost0", "cost", "iters_run", "n_static", "n_dyn",
              "n_motions"):
        assert ig[k] == ie[k], k
    _same_stats(ig["edge_stats0"], ie["edge_stats0"])
    _same_stats(ig["edge_stats"], ie["edge_stats"])
    _same_map(mg, me)
    assert ig["cost"] < ig["cost0"]
    # the solve ran from the graphs the warm-up made, and made no other
    assert solved["keys"] == solved["warm_keys"] and solved["keys"]


def test_graphed_full_ba_matches_jax(solved):
    (ig, mg), (ij, jm) = solved["graphed"], solved["jax"]
    _reports_close(ig, ij)
    assert ig["iters_run"] == ij["iters_run"]
    _poses_close(mg.cam_pose_rf, jm.cam_pose_rf, 1e-4)
    for a, b in zip(mg.rigid_motion_rf, jm.rigid_motion_rf):
        _poses_close(a, b, 1e-4)
    _poses_close(mg.stat_3d, jm.stat_3d, 1e-3, 2e-4)
    _poses_close(mg.dyn_3d, jm.dyn_3d, 1e-3, 2e-4)
    _metrics_close(presults.metric_report(mg, refined=True),
                   jresults.metric_report(jm, refined=True))


def test_warmup_covers_the_full_chunk_and_the_tail(capped):
    """full_iters = 5 in chunks of 3: the warm-up makes the graphs of the
    3-iteration chunk and of the 2-iteration tail, and the solve runs
    both, making no other."""
    jm0, _, pcfg = capped
    cfg = pcfg.replace(backend=dataclasses.replace(
        pcfg.backend, full_iters=5, full_ba_chunk=3, full_gain_thres=0.0))
    graphs = pfull.FullBAGraphs("cpu")
    pfull.warmup_full_ba(cfg, jm0.num_frames, graphs)
    assert sorted(p.iters for _, p in graphs._calls) == [2, 3]
    keys = set(graphs._calls)
    rep = pfull.full_ba_inplace(port_map(jm0), cfg, device="cpu",
                                graphs=graphs)
    assert rep["iters_run"] == 5 and set(graphs._calls) == keys
    eager = pfull.full_ba_inplace(port_map(jm0), cfg, device="cpu")
    assert (rep["cost0"], rep["cost"]) == (eager["cost0"], eager["cost"])


def test_first_chunk_cost_survives_later_replays(capped):
    """Chunks of one LM iteration, three of them, the gain test off: each
    chunk's call overwrites the graph's outputs, cost0 and stats0 among
    them, yet the report's cost0 and stats0 are chunk 0's."""
    jm0, _, pcfg = capped
    cfg = pcfg.replace(backend=dataclasses.replace(
        pcfg.backend, full_iters=3, full_ba_chunk=1, full_gain_thres=0.0))
    graphs = pfull.FullBAGraphs("cpu")
    seen = []
    real = pfull._chunked

    def spy(solve, v0, p, chunk, callback):
        def mark(i, info):
            seen.append((float(info["cost0"]),
                         int(info["stats0"]["obs"]["n_inlier"]),
                         info["cost0"]))
            callback(i, info)
        return real(solve, v0, p, chunk, mark)

    pfull._chunked = spy
    try:
        rep = pfull.full_ba_inplace(port_map(jm0), cfg, device="cpu",
                                    graphs=graphs)
    finally:
        pfull._chunked = real
    assert rep["iters_run"] == 3 and len(seen) == 3
    # every chunk wrote the same static output: chunk 0's value is gone
    assert all(s[2] is seen[0][2] for s in seen)
    assert float(seen[0][2]) == seen[2][0] != seen[0][0]
    assert rep["cost0"] == seen[0][0]
    assert int(rep["edge_stats0"]["obs"]["n_inlier"]) == seen[0][1]
    eager = pfull.full_ba_inplace(port_map(jm0), cfg, device="cpu")
    assert (rep["cost0"], rep["cost"]) == (eager["cost0"], eager["cost"])
    _same_stats(rep["edge_stats0"], eager["edge_stats0"])


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_solve_from_graphs_equals_eager_sharded(capped, n):
    """full_ba_inplace over ["cpu"] * n from FullBAGraphs over the same
    list (warmed by warmup_full_ba, which captures every graph the solve
    then replays) against the eager sharded full_ba_inplace: the report
    and the written-back map bit-equal.  A solve over another list than
    the graphs' raises."""
    jm0, _, pcfg = capped
    cfg = pcfg.replace(backend=dataclasses.replace(
        pcfg.backend, full_iters=5, full_ba_chunk=3, full_gain_thres=0.0))
    devices = ["cpu"] * n
    graphs = pfull.FullBAGraphs(devices)
    pfull.warmup_full_ba(cfg, jm0.num_frames, graphs)
    assert sorted(p.iters for _, p in graphs._calls) == [2, 3]
    keys = set(graphs._calls)
    gm, em = port_map(jm0), port_map(jm0)
    rep = pfull.full_ba_inplace(gm, cfg, device="cpu", devices=devices,
                                graphs=graphs)
    assert rep["iters_run"] == 5 and set(graphs._calls) == keys
    eager = pfull.full_ba_inplace(em, cfg, device="cpu", devices=devices)
    assert (rep["cost0"], rep["cost"]) == (eager["cost0"], eager["cost"])
    assert rep["cost"] < rep["cost0"]
    _same_stats(rep["edge_stats0"], eager["edge_stats0"])
    _same_stats(rep["edge_stats"], eager["edge_stats"])
    _same_map(gm, em)
    with pytest.raises(ValueError, match="graphs for"):
        pfull.full_ba_inplace(port_map(jm0), cfg, device="cpu",
                              graphs=graphs)


@pytest.mark.parametrize("devices", [["cpu", "cuda:0"],
                                     ["cuda:0", "cuda:1", "cuda:0"]])
def test_graphs_over_distinct_cards_raise(devices):
    """FullBAGraphs over a list that names distinct cards raises (their
    sharded solve stays eager), and graphs_for gives no graphs there."""
    with pytest.raises(ValueError, match="distinct cards"):
        pfull.FullBAGraphs(devices)
    assert pfull.graphs_for("cpu", devices) is None
    assert pfull.graphs_for("cpu", ["cpu"] * 3).devices == [
        torch.device("cpu")] * 3
