"""The port's factor-graph solver (vdo_slam_tpu_torch/backend/factor_graph.py)
against the JAX package's, piece by piece and as whole solves, on small
hand-built graphs: the same numpy arrays go to both packages
(`graph_from_numpy` carries them to the port).

The graphs: a chain of poses observing static points, with odometry and a
prior; the mixed graph adds two object-motion vertices, dynamic points
with ternary edges, a smoothness edge and an altitude edge.  Both carry
zero-weight padding edges and unused padding points, as the builders' do.

Tolerances (fp32 arithmetic in another order on each side): residuals,
Jacobian blocks, weights and stats within 1e-5 relative to each array's
largest entry; the normal-equation products (matvec, gradient, block
diagonal, the Schur pose blocks Hcc) within 1e-4 relative; costs within
1e-5 relative; edge counts exact.  Whole solves: pose entries within 1e-4,
points within 1e-3, final cost within 1e-4 of the starting cost, and the
same number of LM iterations run.

The edge Hessian-vector wrapper (vdo_slam_tpu_torch/ops/edge_hessian_cuda.py)
takes its plain version on the CPU: that path is held to a dense J^T W J t
(and J^T W J t + damp * t) assembled in float64 from the same blocks, on a
small random graph of the full builder's shape with zero-weight padding
edges at index 0, for each edge type alone, all six, and all but one left
empty, within 1e-5 relative to each output's largest entry (float32 sums
against float64); the block-Jacobi apply likewise; and its host-side
checks raise on wrong dtypes and shapes.

The obs and ter edges' linearisation and evaluation (`linearize`,
`evaluate`, plain on the CPU) give exactly what the solver's own ops give:
_lin_sums the weights, blocks, gradient and block diagonal of _linearize,
_gradient and _block_diag, _evaluate the cost and statistics of
robust_cost and edge_type_stats, bit for bit, on the same random graph with
padding edges, every live edge robustified, edges on both sides of
delta^2, and not robust; a solve's statistics are those of the variables
it returns, through accepted and rejected steps; and the wrapper's checks
raise on wrong dtypes, shapes and devices.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hv_graphs
from vdo_slam_tpu.backend import factor_graph as J
from vdo_slam_tpu_torch.backend import factor_graph as T
from vdo_slam_tpu_torch.ops import edge_hessian_cuda as EH


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs in several worker processes at once, and each worker's idle
    OpenMP threads spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = [f.name for f in dataclasses.fields(T.Graph)]


def _rot(w):
    th = np.linalg.norm(w)
    k = w / max(th, 1e-12)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _pose(w, t):
    P = np.eye(4)
    P[:3, :3] = _rot(np.asarray(w, np.float64))
    P[:3, 3] = t
    return P


def _inv(P):
    out = np.eye(4)
    out[:3, :3] = P[:3, :3].T
    out[:3, 3] = -P[:3, :3].T @ P[:3, 3]
    return out


def make_problem(F=3, P=30, seed=0, dyn=False, pad=2):
    """(graph dict, variables dict) of numpy arrays, the initial estimate
    perturbed from the truth the measurements were made from."""
    rng = np.random.default_rng(seed)
    step = _pose([0.0, 0.02, 0.0], [0.05, 0.0, 0.4])
    poses = [np.eye(4)]
    for _ in range(F - 1):
        poses.append(poses[-1] @ step)
    X = np.stack([rng.uniform(-8, 8, P), rng.uniform(-3, 3, P),
                  rng.uniform(6, 28, P)], -1)
    obs_pose, obs_point, obs_meas = [], [], []
    for j in range(P):                    # sorted by point, as the builders
        for f in range(F):
            obs_pose.append(f)
            obs_point.append(j)
            Xc = _inv(poses[f])[:3, :3] @ X[j] + _inv(poses[f])[:3, 3]
            obs_meas.append(Xc + rng.normal(0, 0.01, 3))
    odo = [_inv(_inv(poses[f]) @ poses[f + 1]) for f in range(F - 1)]
    g = dict(
        obs_pose=obs_pose, obs_point=obs_point, obs_meas=obs_meas,
        obs_w=[1 / 16.0] * len(obs_pose),
        odo_a=list(range(F - 1)), odo_b=list(range(1, F)), odo_meas_inv=odo,
        odo_w=[1e4] * (F - 1),
        pri_idx=[0], pri_meas_inv=[np.eye(4)], pri_w=[1e5],
        smo_a=[], smo_b=[], smo_w=[], ter_prev=[], ter_cur=[], ter_mot=[],
        ter_w=[], alt_mot=[], alt_w=[])
    points = list(X)
    motions = [np.eye(4)]
    if dyn:
        # two motions moving 3 object points over 3 frames; a point vertex
        # per observation, ternary edges between consecutive ones
        Hs = [_pose([0.0, 0.03, 0.0], [0.3, 0.0, 0.6]),
              _pose([0.0, 0.025, 0.01], [0.28, 0.01, 0.62])]
        Y = [np.asarray([[1.0, 0.5, 9.0], [-1.0, 0.2, 10.0], [0.3, -0.4, 11.]])]
        for H in Hs:
            Y.append(Y[-1] @ H[:3, :3].T + H[:3, 3])
        base = len(points)
        for f in range(3):
            for k in range(3):
                pid = base + 3 * f + k
                g["obs_pose"].append(f)
                g["obs_point"].append(pid)
                Yc = _inv(poses[f])[:3, :3] @ Y[f][k] + _inv(poses[f])[:3, 3]
                g["obs_meas"].append(Yc + rng.normal(0, 0.01, 3))
                g["obs_w"].append(1 / 80.0)
                points.append(Y[f][k])
                if f:
                    g["ter_prev"].append(pid - 3)
                    g["ter_cur"].append(pid)
                    g["ter_mot"].append(f - 1)
                    g["ter_w"].append(1 / 100.0)
        g.update(smo_a=[0], smo_b=[1], smo_w=[1e3], alt_mot=[1], alt_w=[10.0])
        motions = [H @ _pose(rng.normal(0, 0.01, 3), rng.normal(0, 0.02, 3))
                   for H in Hs]
    # zero-weight padding edges; obs padding points at the last point
    # (sorted), SE(3) measurement padding is the identity
    n_pts = len(points)
    for k in ("obs", "odo", "smo", "ter", "alt"):
        for _ in range(pad):
            for f in FIELDS:
                if not f.startswith(k + "_"):
                    continue
                if f.endswith("_w"):
                    g[f].append(0.0)
                elif f.endswith("meas_inv"):
                    g[f].append(np.eye(4))
                elif f == "obs_meas":
                    g[f].append(np.zeros(3))
                elif f == "obs_point":
                    g[f].append(n_pts - 1)
                else:
                    g[f].append(0)
    graph = {}
    for f in FIELDS:
        is_idx = not (f.endswith("_w") or "meas" in f)
        shape = {"obs_meas": (-1, 3)}.get(f, (-1, 4, 4) if "meas_inv" in f
                                          else (-1,))
        graph[f] = np.asarray(g[f], np.int32 if is_idx else np.float32
                              ).reshape(shape)
    dpose = rng.uniform(-0.02, 0.02, (F, 6))
    dpose[0] = 0.0
    pts = np.asarray(points) + rng.normal(0, 0.1, (n_pts, 3))
    v = dict(
        poses=np.stack([p @ _pose(d[:3], d[3:]) for p, d in zip(poses, dpose)]
                       ).astype(np.float32),
        motions=np.stack(motions).astype(np.float32),
        points=np.concatenate([pts, np.zeros((pad, 3))]).astype(np.float32))
    return graph, v


def both(graph, v):
    """The same arrays as the JAX package's and the port's types."""
    jg = J.Graph(**{k: jnp.asarray(a) for k, a in graph.items()})
    jv = J.Variables(**{k: jnp.asarray(a) for k, a in v.items()})
    tg = T.graph_from_numpy(jg, "cpu")
    tv = T.variables_from_numpy(jv, "cpu")
    return jg, jv, tg, tv


def close(port, ref, rtol):
    ref = np.asarray(ref, np.float64)
    port = np.asarray(port.detach() if torch.is_tensor(port) else port,
                      np.float64)
    assert port.shape == ref.shape
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * scale)


def _jax_reduced_pose_system(g, resid, weights, blocks, F):
    """The JAX package's inline assembly of Hcc and bc
    (factor_graph.py:693-724), with its Hcc.at[ii, :, jj, :].add scatter."""
    Jo_pose, w, r = blocks["Jo_pose"], weights["obs"], resid["obs"]
    seg = jax.ops.segment_sum
    Hcc = jnp.zeros((F, 6, F, 6))
    diag_pose = seg(jnp.einsum("eij,eik,e->ejk", Jo_pose, Jo_pose, w),
                    g.obs_pose, num_segments=F)
    Hcc = Hcc + jnp.einsum("fij,fg->figj", diag_pose, jnp.eye(F))
    bc = -seg(jnp.einsum("eij,ei->ej", Jo_pose, r * w[:, None]), g.obs_pose,
              num_segments=F)

    def acc(Hcc, bc, Ji, Jj, ii, jj, we, re):
        Hcc = Hcc.at[ii, :, jj, :].add(jnp.einsum("eij,eik,e->ejk", Ji, Jj,
                                                  we))
        bi = -jnp.einsum("eij,ei,e->ej", Ji, re, we)
        return Hcc, bc + seg(bi, ii, num_segments=F)

    Jd_a, Jd_b = blocks["Jd_a"], blocks["Jd_b"]
    wo, ro = weights["odo"], resid["odo"]
    Hcc, bc = acc(Hcc, bc, Jd_a, Jd_a, g.odo_a, g.odo_a, wo, ro)
    Hcc, bc = acc(Hcc, bc, Jd_b, Jd_b, g.odo_b, g.odo_b, wo, ro)
    Hcc, _ = acc(Hcc, bc, Jd_a, Jd_b, g.odo_a, g.odo_b, wo, 0 * ro)
    Hcc, _ = acc(Hcc, bc, Jd_b, Jd_a, g.odo_b, g.odo_a, wo, 0 * ro)
    Hcc, bc = acc(Hcc, bc, blocks["Jp"], blocks["Jp"], g.pri_idx, g.pri_idx,
                  weights["pri"], resid["pri"])
    return Hcc, bc


@jax.jit
def _jax_pieces(g, v, t):
    """Every solver piece of the JAX package on (g, v), in one program (one
    compile instead of hundreds of eager ones)."""
    p = J.LMParams()
    F, M, P = v.poses.shape[0], v.motions.shape[0], v.points.shape[0]
    resid, weights, blocks = J._linearize(g, v, p)
    return {
        "residuals": J.residuals(g, v),
        "cost": {r: J.robust_cost(g, v, dataclasses.replace(p, robust=r))
                 for r in (True, False)},
        "stats": J.edge_type_stats(g, v, p),
        "weights": weights, "blocks": blocks,
        "matvec": J._matvec(g, blocks, weights, J.Tangent(*t), p),
        "gradient": J._gradient(g, blocks, weights, resid, F, M, P, p),
        "block_diag": J._block_diag(g, blocks, weights, F, M, P, p),
        "Hcc": _jax_reduced_pose_system(g, resid, weights, blocks, F),
    }


def _with_ref(graph, v):
    """(JAX graph, JAX variables, port graph, port variables, a random
    tangent, the JAX pieces on them)."""
    jg, jv, tg, tv = both(graph, v)
    rng = np.random.default_rng(4)
    t = [rng.normal(size=(a.shape[0], k)).astype(np.float32)
         for a, k in ((v["poses"], 6), (v["motions"], 6), (v["points"], 3))]
    ref = jax.device_get(_jax_pieces(jg, jv, [jnp.asarray(x) for x in t]))
    return jg, jv, tg, tv, t, ref


@pytest.fixture(scope="module")
def mixed():
    return _with_ref(*make_problem(dyn=True))


@pytest.fixture(scope="module")
def chain():
    return _with_ref(*make_problem(F=3, P=40, seed=1))


@pytest.mark.parametrize("robust", [True, False])
def test_residuals_and_cost(mixed, robust):
    _, _, tg, tv, _, ref = mixed
    for rp, rj in zip(T.residuals(tg, tv), ref["residuals"]):
        close(rp, rj, 1e-5)
    ct = float(T.robust_cost(tg, tv, T.LMParams(robust=robust)))
    assert ct == pytest.approx(float(ref["cost"][robust]), rel=1e-5)


def test_edge_type_stats(mixed):
    _, _, tg, tv, _, ref = mixed
    sj = ref["stats"]
    st = T.edge_type_stats(tg, tv, T.LMParams())
    assert set(st) == set(sj) == set(T.EDGE_TYPES)
    for name in T.EDGE_TYPES:
        assert int(st[name]["n"]) == int(sj[name]["n"])
        assert int(st[name]["n_inlier"]) == int(sj[name]["n_inlier"])
        assert float(st[name]["chi2"]) == pytest.approx(
            float(sj[name]["chi2"]), rel=1e-5, abs=1e-30)
    assert int(st["smo"]["n"]) == 1 and int(st["obs"]["n"]) == 99
    assert T.format_edge_stats(st, st) == J.format_edge_stats(sj, sj)


def test_jacobian_blocks(mixed):
    """Each block function against the JAX blocks of the same edges (the
    JAX package's _linearize calls its functions of the same names)."""
    _, _, tg, tv, _, ref = mixed
    bj = ref["blocks"]
    ports = {
        ("Jo_pose", "Jo_pt"): EH.obs_blocks(tg, tv),
        ("Jt_prev", "Jt_cur", "Jt_mot"): EH.ter_blocks(tg, tv),
        ("Jd_a", "Jd_b"): T._rel_blocks(tg.odo_meas_inv, tv.poses[tg.odo_a],
                                        tv.poses[tg.odo_b]),
        ("Jp",): (T._pri_blocks(tg.pri_meas_inv, tv.poses[tg.pri_idx]),),
        ("Ja",): (T._alt_blocks(tg, tv),),
    }
    for names, blocks in ports.items():
        for k, b in zip(names, blocks):
            assert b.dtype == torch.float32
            close(b, bj[k], 1e-5)
    # every block through _linearize, the smoothness ones included
    _, _, bt = T._linearize(tg, tv, T.LMParams())
    assert set(bt) == set(bj)
    for k in bj:
        close(bt[k], bj[k], 1e-5)
    assert float(np.abs(bj["Js_a"]).max()) > 0.5


def test_normal_equation_pieces(mixed):
    _, _, tg, tv, t, ref = mixed
    rt, wt, bt = T._linearize(tg, tv, T.LMParams())
    for k in ref["weights"]:
        close(wt[k], ref["weights"][k], 1e-5)
    F, M, P = (x.shape[0] for x in t)
    mt = T._matvec(tg, bt, wt, T.Tangent(*map(torch.from_numpy, t)))
    gt = T._gradient(tg, bt, wt, rt, F, M, P)
    for k in ("poses", "motions", "points"):
        close(getattr(mt, k), getattr(ref["matvec"], k), 1e-4)
        close(getattr(gt, k), getattr(ref["gradient"], k), 1e-4)
    for a, b in zip(T._block_diag(tg, bt, wt, F, M, P), ref["block_diag"]):
        close(a, b, 1e-4)


def test_reduced_pose_system_on_3_pose_chain(chain):
    _, _, tg, tv, _, ref = chain
    rt, wt, bt = T._linearize(tg, tv, T.LMParams())
    Ht, bct = T._reduced_pose_system(tg, rt, wt, bt, 3)
    assert Ht.shape == (3, 6, 3, 6)
    close(Ht, ref["Hcc"][0], 1e-4)
    close(bct, ref["Hcc"][1], 1e-4)
    # the off-diagonal odometry blocks really are there, and symmetric
    H = Ht.reshape(18, 18)
    assert float(H[0:6, 6:12].abs().max()) > 1.0
    close(H, H.T, 1e-6)


def _check_solve(vt, it, vj, ij):
    close(vt.poses, vj.poses, 1e-4)
    np.testing.assert_allclose(vt.points.numpy(), np.asarray(vj.points),
                               atol=1e-3)
    c0 = float(ij["cost0"])
    assert float(it["cost0"]) == pytest.approx(c0, rel=1e-5)
    assert abs(float(it["cost"]) - float(ij["cost"])) <= 1e-4 * c0
    assert float(it["cost"]) < 0.5 * c0


def test_lm_solve(mixed):
    jg, jv, tg, tv = mixed[:4]
    kw = dict(iters=3, cg_iters=24)
    # lam0 given: the JAX program is then the one the chunked tests below
    # run for their first chunk (one compile)
    vj, ij = J.lm_solve(jg, jv, J.LMParams(**kw), lam0=jnp.float32(1e-4))
    vt, it = T.lm_solve(tg, tv, T.LMParams(**kw))
    _check_solve(vt, it, vj, ij)
    close(vt.motions, vj.motions, 1e-4)
    close(it["history"], ij["history"], 1e-4)
    assert float(it["lam"]) == pytest.approx(float(ij["lam"]), rel=1e-6)


def test_lm_solve_chunked_remainder_chunk(mixed):
    """5 iterations in chunks of 3: a chunk of 3, then the remainder of 2;
    the same trajectory as one lm_solve of 5."""
    jg, jv, tg, tv = mixed[:4]
    kw = dict(iters=5, cg_iters=24)
    vj, ij = J.lm_solve_chunked(jg, jv, J.LMParams(**kw), chunk=3)
    calls = []
    vt, it = T.lm_solve_chunked(tg, tv, T.LMParams(**kw), chunk=3,
                                callback=lambda i, info: calls.append(i))
    assert it["iters_run"] == ij["iters_run"] == 5 and calls == [0, 1]
    _check_solve(vt, it, vj, ij)
    vs, _ = T.lm_solve(tg, tv, T.LMParams(**kw))
    np.testing.assert_allclose(vt.poses.numpy(), vs.poses.numpy(), atol=1e-6)


def test_lm_solve_chunked_gain_stop(mixed):
    """The g2o gain threshold, tested at chunk boundaries: the second chunk
    of 3 gains less than gain_eps, so both packages stop after 6 of 12."""
    jg, jv, tg, tv = mixed[:4]
    kw = dict(iters=12, cg_iters=24, gain_eps=0.05)
    vj, ij = J.lm_solve_chunked(jg, jv, J.LMParams(**kw), chunk=3)
    vt, it = T.lm_solve_chunked(tg, tv, T.LMParams(**kw), chunk=3)
    assert it["iters_run"] == ij["iters_run"] == 6
    _check_solve(vt, it, vj, ij)


def test_lm_solve_schur(chain):
    jg, jv, tg, tv = chain[:4]
    p = dict(iters=2)
    vj, ij = J.lm_solve_schur(jg, jv, J.LMParams(**p))
    vt, it = T.lm_solve_schur(tg, tv, T.LMParams(**p))
    _check_solve(vt, it, vj, ij)
    close(it["history"], ij["history"], 1e-4)
    # the padding points have no edges: their 1e-8 I blocks stay unused
    np.testing.assert_array_equal(vt.points[-2:].numpy(), 0.0)
    for name in T.EDGE_TYPES:
        assert int(it["stats"][name]["n"]) == int(ij["stats"][name]["n"])


def test_lm_params_match_and_axis_name_is_inert(mixed):
    """The fields of both packages' LMParams are the same.  axis_name, the
    original's shard_map axis, changes nothing in the port (a device list
    shards a solve, tests/test_torch_sharded.py): the solve with it set is
    the solve without it, bit for bit."""
    assert ([(f.name, f.default) for f in dataclasses.fields(T.LMParams)]
            == [(f.name, f.default) for f in dataclasses.fields(J.LMParams)])
    tg, tv = mixed[2], mixed[3]
    kw = dict(iters=2, cg_iters=8)
    v0, i0 = T.lm_solve(tg, tv, T.LMParams(**kw))
    v1, i1 = T.lm_solve(tg, tv, T.LMParams(axis_name="ba", **kw))
    assert torch.equal(v0.poses, v1.poses)
    assert torch.equal(v0.points, v1.points)
    assert torch.equal(i0["cost"], i1["cost"])


def test_upload_and_fetch_roundtrip():
    graph, v = make_problem(dyn=True)
    tg, tv = T.upload(T.Graph(**graph), T.Variables(**v), "cpu")
    for k, a in graph.items():
        t = getattr(tg, k)
        assert t.dtype == (torch.int64 if a.dtype == np.int32
                           else torch.float32)
        np.testing.assert_array_equal(t.numpy(), a)
    np.testing.assert_array_equal(tv.points.numpy(), v["points"])
    moved = tg.to("cpu"), tv.to("cpu")
    assert torch.equal(moved[0].obs_meas, tg.obs_meas)
    assert torch.equal(moved[1].poses, tv.poses)
    tree = {"a": tv.poses, "b": [torch.tensor(7), (tg.obs_w,)], "c": "x"}
    out = T.fetch(tree)
    np.testing.assert_array_equal(out["a"], v["poses"])
    assert out["b"][0] == 7 and out["b"][0].dtype == np.int64
    np.testing.assert_array_equal(out["b"][1][0], graph["obs_w"])
    assert out["c"] == "x"


# --------------------------------------------------------------------------
# the edge Hessian-vector wrapper's plain path against float64
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hv_graph():
    """A small random graph of the full builder's shape on the CPU (with
    zero-weight padding edges at index 0 and at the last sorted index),
    its variables, a random tangent and a positive damping tangent."""
    g, v = hv_graphs.upload(*hv_graphs.make_graph(seed=3), "cpu")
    for edge in ("obs", "odo", "smo", "ter", "alt"):
        w = getattr(g, edge + "_w")
        assert float(w[-1]) == 0.0 and float(w.max()) > 0 or edge == "alt"
    assert int(g.obs_pose[-1]) == int(g.ter_mot[-1]) == 0
    t = hv_graphs.random_tangent(v, seed=2)
    r = hv_graphs.random_tangent(v, seed=5)
    damp = T.Tangent(*[x.abs() + 0.1 for x in (r.poses, r.motions, r.points)])
    return g, t, damp


HV_CASES = [(e,) for e in T.EDGE_TYPES] + [
    tuple(T.EDGE_TYPES), tuple(e for e in T.EDGE_TYPES if e != "ter")]


@pytest.mark.parametrize("edges", HV_CASES,
                         ids=list(T.EDGE_TYPES) + ["all", "ter_empty"])
def test_hessian_vector_plain_equals_dense_float64(hv_graph, edges):
    g, t, damp = hv_graph
    g = hv_graphs.keep_only(g, edges)
    blocks, weights = hv_graphs.random_blocks(g, seed=1)
    for d in (None, damp):
        got = EH.hessian_vector(g, blocks, weights, t, d)
        want = hv_graphs.dense_product(g, blocks, weights, t, d)
        for a, b in zip(got, want, strict=True):
            assert a.dtype == torch.float32
            close(a, b.numpy(), 1e-5)
        # the solver's product is the wrapper's
        mt = T._matvec(g, blocks, weights, t, d)
        for k, a in zip(EH.KINDS, got):
            assert torch.equal(getattr(mt, k), a)


def test_block_jacobi_plain_equals_float64(hv_graph):
    _, t, _ = hv_graph
    gen = torch.Generator().manual_seed(7)
    # the inverted blocks in a batched inverse's column-major layout
    Dinv = tuple(torch.randn(x.shape[0], w, w, generator=gen).transpose(-1, -2)
                 for x, w in ((t.poses, 6), (t.motions, 6), (t.points, 3)))
    got = EH.block_jacobi(Dinv, t)
    for a, A, x in zip(got, Dinv, (t.poses, t.motions, t.points)):
        close(a, (A.double() @ x.double()[..., None])[..., 0].numpy(), 1e-5)
    assert all(torch.equal(a, getattr(T._apply_precond(Dinv, t), k))
               for a, k in zip(got, EH.KINDS))


def _bad(g, blocks, weights, t, damp, what):
    """One argument of hessian_vector spoiled."""
    blocks, weights = dict(blocks), dict(weights)
    if what == "weight_float64":
        weights["obs"] = weights["obs"].double()
    elif what == "block_width":
        blocks["Jo_pose"] = blocks["Jo_pose"][..., :5]
    elif what == "block_edges":
        blocks["Jt_mot"] = blocks["Jt_mot"][1:]
    elif what == "index_int32":
        g = dataclasses.replace(g, obs_pose=g.obs_pose.int())
    elif what == "index_length":
        g = dataclasses.replace(g, ter_cur=g.ter_cur[:-1])
    elif what == "tangent_width":
        t = T.Tangent(t.poses, t.motions, torch.zeros(t.points.shape[0], 4))
    elif what == "tangent_float64":
        t = T.Tangent(t.poses.double(), t.motions, t.points)
    elif what == "damp_rows":
        damp = T.Tangent(damp.poses[1:], damp.motions, damp.points)
    elif what == "meta_device":
        t = T.Tangent(*[x.to("meta") for x in (t.poses, t.motions,
                                                 t.points)])
    return g, blocks, weights, t, damp


@pytest.mark.parametrize("what,err", [
    ("weight_float64", TypeError), ("block_width", ValueError),
    ("block_edges", ValueError), ("index_int32", TypeError),
    ("index_length", ValueError), ("tangent_width", ValueError),
    ("tangent_float64", TypeError), ("damp_rows", ValueError),
    ("meta_device", ValueError)])
def test_hessian_vector_rejects(hv_graph, what, err):
    g, t, damp = hv_graph
    blocks, weights = hv_graphs.random_blocks(g, seed=1)
    with pytest.raises(err):
        EH.hessian_vector(*_bad(g, blocks, weights, t, damp, what))


def test_block_jacobi_rejects_a_wrong_block(hv_graph):
    _, t, _ = hv_graph
    good = (torch.zeros(t.poses.shape[0], 6, 6),
            torch.zeros(t.motions.shape[0], 6, 6),
            torch.zeros(t.points.shape[0], 3, 3))
    with pytest.raises(ValueError):
        EH.block_jacobi((good[0], good[1], good[2][1:]), t)
    with pytest.raises(TypeError):
        EH.block_jacobi((good[0].double(), good[1], good[2]), t)
    assert all(float(x.abs().max()) == 0.0
               for x in EH.block_jacobi(good, t))


# --------------------------------------------------------------------------
# the obs and ter edges' linearisation and evaluation (plain path)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lin_graph():
    """hv_graph's graph (zero-weight padding edges included) with its
    variables."""
    return hv_graphs.upload(*hv_graphs.make_graph(seed=3), "cpu")


# delta 2.0 leaves live obs and ter edges on both sides of delta^2 here
LIN_PARAMS = [T.LMParams(), T.LMParams(huber_delta=2.0),
              T.LMParams(robust=False)]
LIN_IDS = ["all_robust", "both_sides", "not_robust"]


@pytest.mark.parametrize("p", LIN_PARAMS, ids=LIN_IDS)
def test_linearize_sums_equal_the_solver_ops(lin_graph, p):
    g, v = lin_graph
    F, M, P = (x.shape[0] for x in (v.poses, v.motions, v.points))
    resid, weights, blocks = T._linearize(g, v, p)
    grad = T._gradient(g, blocks, weights, resid, F, M, P)
    diag = T._block_diag(g, blocks, weights, F, M, P)
    w2, b2, g2, d2 = T._lin_sums(g, v, p)
    assert set(w2) == set(weights) == set(T.EDGE_TYPES)
    assert set(b2) == set(blocks)
    assert all(torch.equal(w2[k], weights[k]) for k in weights)
    assert all(torch.equal(b2[k], blocks[k]) for k in blocks)
    assert all(torch.equal(getattr(g2, k), getattr(grad, k))
               for k in EH.KINDS)
    assert all(torch.equal(a, b) for a, b in zip(d2, diag, strict=True))
    wl, bl, _, _ = EH.linearize(g, v, p.huber_delta, p.robust)
    for edge in EH.LARGE:
        w = getattr(g, edge + "_w")
        live = w != 0
        assert int((~live).sum()) > 0
        assert torch.equal(wl[edge], weights[edge])
        assert float(wl[edge][~live].abs().max()) == 0.0
        cut = int((wl[edge][live] < w[live]).sum())
        if not p.robust:
            assert cut == 0
        elif p.huber_delta == 2.0:
            assert 0 < cut < int(live.sum())
        else:
            assert cut == int(live.sum())


@pytest.mark.parametrize("p", LIN_PARAMS, ids=LIN_IDS)
def test_evaluate_equals_cost_and_stats(lin_graph, p):
    g, v = lin_graph
    ev = T._evaluate(g, v, p)
    assert torch.equal(ev["cost"], T.robust_cost(g, v, p))
    stats = T.edge_type_stats(g, v, p)
    assert list(ev["stats"]) == list(stats)
    for name, st in stats.items():
        assert all(torch.equal(ev["stats"][name][k], x)
                   for k, x in st.items())
    sums = EH.evaluate(g, v, p.huber_delta, p.robust)
    for edge in EH.LARGE:
        assert sums[edge]["n"].dtype == torch.int64
        assert all(torch.equal(sums[edge][k], stats[edge][k])
                   for k in ("n", "chi2", "n_inlier"))


def test_lm_statistics_are_those_of_its_variables(lin_graph, monkeypatch):
    """_lm evaluates once at v0 and once a step, and carries the accepted
    variables' statistics: its cost0, cost, stats0 and stats equal
    robust_cost and edge_type_stats at v0 and at the variables it returns,
    through rejected steps (steps blown up 10x, so that the damping has to
    rise before one is accepted) and accepted ones."""
    g, v0 = lin_graph
    retract = T._retract_vars
    monkeypatch.setattr(T, "_retract_vars",
                        lambda v, t: retract(v, t.scale(10.0)))
    p = T.LMParams(iters=8, cg_iters=3, huber_delta=2.0)
    v, info = T.lm_solve(g, v0, p)
    hist = torch.cat([info["cost0"][None], info["history"]])
    assert bool((hist[1:] == hist[:-1]).any())      # rejected
    assert bool((hist[1:] < hist[:-1]).any())       # accepted
    for vv, cost, st in ((v0, info["cost0"], info["stats0"]),
                         (v, info["cost"], info["stats"])):
        assert torch.equal(cost, T.robust_cost(g, vv, p))
        want = T.edge_type_stats(g, vv, p)
        assert all(torch.equal(st[n][k], want[n][k])
                   for n in want for k in want[n])


def _bad_lin(g, v, what):
    """One input of linearize and evaluate spoiled."""
    if what == "weight_float64":
        g = dataclasses.replace(g, ter_w=g.ter_w.double())
    elif what == "index_int32":
        g = dataclasses.replace(g, obs_point=g.obs_point.int())
    elif what == "index_length":
        g = dataclasses.replace(g, ter_mot=g.ter_mot[:-1])
    elif what == "meas_width":
        g = dataclasses.replace(g, obs_meas=g.obs_meas[:, :2])
    elif what == "poses_float64":
        v = dataclasses.replace(v, poses=v.poses.double())
    elif what == "points_width":
        v = dataclasses.replace(v, points=torch.zeros(v.points.shape[0], 4))
    elif what == "motions_shape":
        v = dataclasses.replace(v, motions=v.motions[:, :3])
    elif what == "meta_device":
        v = T.Variables(*[x.to("meta") for x in (v.poses, v.motions,
                                                 v.points)])
    elif what == "edge_on_meta":
        g = dataclasses.replace(g, ter_cur=g.ter_cur.to("meta"))
    return g, v


@pytest.mark.parametrize("what,err", [
    ("weight_float64", TypeError), ("index_int32", TypeError),
    ("index_length", ValueError), ("meas_width", ValueError),
    ("poses_float64", TypeError), ("points_width", ValueError),
    ("motions_shape", ValueError), ("meta_device", ValueError),
    ("edge_on_meta", ValueError)])
def test_linearize_and_evaluate_reject(lin_graph, what, err):
    g, v = _bad_lin(*lin_graph, what)
    with pytest.raises(err):
        EH.linearize(g, v, 1e-4, True)
    with pytest.raises(err):
        EH.evaluate(g, v, 1e-4, True)
