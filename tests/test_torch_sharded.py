"""The edge-sharded full BA of the port: factor_graph.lm_solve_sharded and
lm_solve_sharded_chunked, and full_ba_inplace(devices=[...]).

The port shards over a list of devices driven from one process; a list
that repeats "cpu" runs every line of that code on the CPU, as the JAX
package's tests reach its shard_map through conftest's 8 virtual CPU
devices.  On the mixed graph of tests/test_torch_factor_graph.py:

  * the padding equals the JAX package's _pad_edges_for_mesh (atol = 0);
  * one shard (padding only) equals the port's lm_solve within 1e-6;
  * 2, 3 and 4 shards equal lm_solve up to summation order: pose entries
    within 1e-5, points within 1e-4 m, the final cost within rtol 1e-4,
    edge counts exact (measured here, 3 LM iterations: 7.5e-9, 2.0e-5 m
    and 5.0e-5 at most).  The object motions, which three points each
    hold, and the per-type chi2 sums, some of them ~1e-9, are held as the
    JAX-vs-port solves are: motion entries within 1e-4 (3.4e-5 measured),
    each chi2 within 1e-4 of the starting cost;
  * 4 shards against the JAX lm_solve within that file's bounds (pose
    entries 1e-4 relative, points 1e-3, cost within 1e-4 of cost0);
  * the chunked variant runs the iterations lm_solve_chunked runs, and
    stops at the same chunk on the gain test; poses within 1e-5, the
    final cost within 1e-4 of the starting cost (after 6 iterations the
    final cost is 1.4e-4 apart relative to itself).

full_ba_inplace over ["cpu"] * 2 on the JAX-tracked 8-frame map of
tests/conftest.py against the one-device call, with the bounds of the JAX
package's own sharded check (__graft_entry__.py:253-256): cost within
10 %, refined poses within 1e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_backend import port_map
from tests.test_torch_factor_graph import _check_solve, make_problem
from tests.test_torch_slice import port_config
from vdo_slam_tpu.backend import factor_graph as J
from vdo_slam_tpu_torch.backend import factor_graph as T
from vdo_slam_tpu_torch.backend import full_ba as pfull
from vdo_slam_tpu_torch.devices import device_list


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs in several worker processes at once, and each worker's idle
    OpenMP threads spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P3 = dict(iters=3, cg_iters=24)


@pytest.fixture(scope="module")
def mixed():
    """(numpy graph, JAX graph, JAX variables, port graph, port variables,
    the port's one-device lm_solve of P3)."""
    graph, v = make_problem(dyn=True)
    jg = J.Graph(**{k: jnp.asarray(a) for k, a in graph.items()})
    jv = J.Variables(**{k: jnp.asarray(a) for k, a in v.items()})
    tg, tv = T.upload(T.Graph(**graph), T.Variables(**v), "cpu")
    return graph, jg, jv, tg, tv, T.lm_solve(tg, tv, T.LMParams(**P3))


@pytest.mark.parametrize("n_dev", [1, 3, 4])
def test_padding_equals_jax(mixed, n_dev):
    graph, jg, _, tg, _, _ = mixed
    jp = J._pad_edges_for_mesh(jg, n_dev)
    tp = T._pad_edges_for_mesh(tg, n_dev)
    for k, a in graph.items():
        got = getattr(tp, k)
        assert got.shape[0] % n_dev == 0
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jp, k)))
    # the shards are the contiguous blocks, in order
    shards = T._shard_edges(tg, ["cpu"] * n_dev)
    for k in graph:
        assert torch.equal(torch.cat([getattr(s, k) for s in shards]),
                           getattr(tp, k))


def test_one_shard_equals_lm_solve(mixed):
    tg, tv, (vs, is_) = mixed[3], mixed[4], mixed[5]
    vh, ih = T.lm_solve_sharded(tg, tv, T.LMParams(**P3), ["cpu"])
    for k in ("poses", "motions", "points"):
        np.testing.assert_allclose(getattr(vh, k).numpy(),
                                   getattr(vs, k).numpy(), atol=1e-6)
    assert float(ih["cost"]) == pytest.approx(float(is_["cost"]), rel=1e-6)


@pytest.mark.parametrize("n_dev", [2, 3, 4])
def test_shards_equal_lm_solve(mixed, n_dev):
    tg, tv, (vs, is_) = mixed[3], mixed[4], mixed[5]
    vh, ih = T.lm_solve_sharded(tg, tv, T.LMParams(**P3), ["cpu"] * n_dev)
    np.testing.assert_allclose(vh.poses.numpy(), vs.poses.numpy(), atol=1e-5)
    np.testing.assert_allclose(vh.motions.numpy(), vs.motions.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(vh.points.numpy(), vs.points.numpy(),
                               atol=1e-4)
    for k in ("cost0", "cost"):
        assert float(ih[k]) == pytest.approx(float(is_[k]), rel=1e-4)
    c0 = float(is_["cost0"])
    np.testing.assert_allclose(ih["history"].numpy(),
                               is_["history"].numpy(), rtol=1e-4)
    assert float(ih["lam"]) == pytest.approx(float(is_["lam"]), rel=1e-6)
    for name in T.EDGE_TYPES:
        for s in ("stats0", "stats"):
            assert int(ih[s][name]["n"]) == int(is_[s][name]["n"])
            assert int(ih[s][name]["n_inlier"]) == int(
                is_[s][name]["n_inlier"])
            assert abs(float(ih[s][name]["chi2"])
                       - float(is_[s][name]["chi2"])) <= 1e-4 * c0


def test_four_shards_against_jax_lm_solve(mixed):
    _, jg, jv, tg, tv, _ = mixed
    vj, ij = J.lm_solve(jg, jv, J.LMParams(**P3), lam0=jnp.float32(1e-4))
    vh, ih = T.lm_solve_sharded(tg, tv, T.LMParams(**P3), ["cpu"] * 4)
    _check_solve(vh, ih, vj, ij)


@pytest.mark.parametrize("kw,chunk,want", [
    (dict(iters=5, cg_iters=24), 3, 5),
    (dict(iters=12, cg_iters=24, gain_eps=0.05), 3, 6)])
def test_chunked_runs_the_same_iterations(mixed, kw, chunk, want):
    """The remainder chunk and the gain stop of lm_solve_chunked, over 4
    shards: the same iterations run, the same callbacks, the same poses
    up to summation order."""
    tg, tv = mixed[3], mixed[4]
    p = T.LMParams(**kw)
    calls = {"one": [], "sharded": []}
    vo, io = T.lm_solve_chunked(
        tg, tv, p, chunk=chunk,
        callback=lambda i, _: calls["one"].append(i))
    vh, ih = T.lm_solve_sharded_chunked(
        tg, tv, p, ["cpu"] * 4, chunk=chunk,
        callback=lambda i, _: calls["sharded"].append(i))
    assert ih["iters_run"] == io["iters_run"] == want
    assert calls["sharded"] == calls["one"]
    np.testing.assert_allclose(vh.poses.numpy(), vo.poses.numpy(), atol=1e-5)
    c0 = float(io["cost0"])
    assert float(ih["cost0"]) == pytest.approx(c0, rel=1e-4)
    assert abs(float(ih["cost"]) - float(io["cost"])) <= 1e-4 * c0


def test_device_list():
    assert device_list(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert device_list(None, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="empty"):
        device_list([])
    with pytest.raises(ValueError, match="empty"):
        T.lm_solve_sharded(None, None, T.LMParams(), [])


@pytest.fixture(scope="module")
def full_runs(tracked_session):
    """full_ba_inplace on copies of the JAX-tracked map: one device, and
    the edges sharded over ["cpu"] * 2."""
    jm, jcfg = tracked_session["sysm"].map, tracked_session["cfg"]
    pcfg = port_config(jcfg)
    out = {}
    for name, devices in (("one", None), ("two", ["cpu"] * 2)):
        m = port_map(jm)
        rep = pfull.full_ba_inplace(m, pcfg, device="cpu", devices=devices)
        out[name] = (m, rep)
    return out


def test_full_ba_sharded_against_one_device(full_runs):
    (m1, r1), (m2, r2) = full_runs["one"], full_runs["two"]
    assert r2["cost"] <= r2["cost0"]
    assert abs(r2["cost"] - r1["cost"]) <= 0.1 * max(r1["cost"], 1e-6) + 1e-6
    assert r2["cost0"] == pytest.approx(r1["cost0"], rel=1e-5)
    gap = max(float(np.abs(np.asarray(a, np.float64)
                           - np.asarray(b, np.float64)).max())
              for a, b in zip(m2.cam_pose_rf, m1.cam_pose_rf))
    assert gap < 1e-3
    for a, b in zip(m2.rigid_motion_rf, m1.rigid_motion_rf):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, atol=1e-3)


def test_full_ba_sharded_report_and_dump(full_runs):
    """The same report keys, counts and write-back as the one-device call;
    the g2o dump keeps the unpadded graph."""
    (m1, r1), (m2, r2) = full_runs["one"], full_runs["two"]
    assert set(r2) == set(r1)
    for k in ("n_static", "n_dyn", "n_motions", "iters_run"):
        assert r2[k] == r1[k]
    assert len(r2["chunk_times"]) == len(r1["chunk_times"]) >= 1
    assert r2["t_solve_s"] > 0
    for name, s in r1["edge_stats"].items():
        assert int(r2["edge_stats"][name]["n"]) == int(s["n"])
    g1, g2 = m1.g2o_dump["graph"], m2.g2o_dump["graph"]
    for f in dataclasses.fields(g1):
        np.testing.assert_array_equal(getattr(g2, f.name),
                                      getattr(g1, f.name))
    assert m2.g2o_dump["n_points"] == m1.g2o_dump["n_points"]
    for a, b in zip(m2.stat_3d, m1.stat_3d):
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=2e-4)
