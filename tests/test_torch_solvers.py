"""RANSAC and the joint flow-pose LM of the port against the JAX package's.

The random picks are drawn with jax.random exactly where ransac.py:164
draws them (per slot from jax.random.split, as stages.py:384 does) and fed
to the port.  Inlier masks and counts must be identical; poses agree
within 1e-5 (m for translations, rad for rotations) after the same fixed
number of LM iterations.  The object-slot solves are held instead to the
port's own float64 solve of the same problem, within a bound taken from how
far JAX's fp32 solves lie from it (`assert_fp32_close`): there a late LM
step's accept test sits within fp32 rounding of the cost, so either
package may take or skip it, depending on the host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdo_slam_tpu.geometry import camera as jcam
from vdo_slam_tpu.geometry import se3 as jse3
from vdo_slam_tpu.solvers import flow_lm as jlm
from vdo_slam_tpu.solvers import ransac as jransac
from vdo_slam_tpu_torch.solvers import flow_lm, ransac

POSE_TOL = 1e-5
POSE_CAP = 1e-4     # m / rad: the widest bound fp32 scatter may justify
UV_CAP = 1e-2       # px, the same for uv_cur (floor 1e-3)
N_PERM = 8          # seeded correspondence orders of each JAX solo solve
K_INT = np.asarray([320.0, 320.0, 160.0, 120.0], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def pose_err(T, T_ref):
    """(translation m, rotation rad) between two (..., 4, 4) poses."""
    T, T_ref = np.asarray(T, np.float64), np.asarray(T_ref, np.float64)
    R = np.swapaxes(T_ref[..., :3, :3], -1, -2) @ T[..., :3, :3]
    # the skew-part angle: linear in fp32 rounding, unlike acos of the trace
    s = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], -1)
    return (np.abs(T[..., :3, 3] - T_ref[..., :3, 3]).max(),
            np.arcsin(np.clip(0.5 * np.linalg.norm(s, axis=-1), 0, 1)).max())


def assert_pose_close(T, T_ref, tol=POSE_TOL):
    dt, dr = pose_err(T, T_ref)
    assert dt < tol and dr < tol, (dt, dr)


def _f64(x):
    return torch.from_numpy(np.array(x, np.float64))


def jax_solo_runs(T0, shared, T_last, valid, jp):
    """JAX's fp32 solve of one slot, on its correspondences in their own
    order and in N_PERM seeded permutations: only the order of the sums
    differs, so the spread of these results samples how far fp32 rounding
    alone moves this problem's.  Each run: {"T", "uv_cur"}, rows in the
    original order."""
    n = valid.shape[0]
    runs = []
    for o in [np.arange(n)] + [np.random.default_rng(s).permutation(n)
                               for s in range(1, N_PERM + 1)]:
        r = jlm.solve(jnp.asarray(T0), *(jnp.asarray(x[o]) for x in shared),
                      jnp.asarray(T_last), jnp.asarray(valid[o]),
                      jnp.asarray(K_INT), jp)
        flow = np.empty_like(shared[2])
        flow[o] = np.asarray(r["flow"])
        runs.append({"T": np.asarray(r["T"]), "uv_cur": shared[0] + flow})
    return runs


def uv_err(uv, uv_ref):
    return np.abs(np.asarray(uv, np.float64) - np.asarray(uv_ref)).max()


def assert_fp32_close(port, jax_runs, ref64, err=pose_err, floor=POSE_TOL,
                      cap=POSE_CAP):
    """The port's fp32 result and each of JAX's (a list) against the port's
    float64 solve ref64, within max(floor, 4 d_jax) capped at `cap`, per
    component of `err` (poses: m and rad); d_jax is the farthest JAX result
    from ref64.  An algorithmic departure of the port moves ref64 away from
    every JAX result, so it fails once it passes the cap."""
    d_jax = np.max([err(x, ref64) for x in jax_runs], axis=0)
    bound = np.clip(4 * d_jax, floor, cap)
    for x in [port, *jax_runs]:
        e = np.asarray(err(x, ref64))
        assert (e < bound).all(), (e, bound, d_jax)


def make_problem(n, seed, outlier_frac=0.2):
    """World points seen from T_last and from a moved T_cur, with flow
    measurements and gross outliers."""
    rng = np.random.default_rng(seed)
    Xw = np.stack([rng.uniform(-6, 6, n), rng.uniform(-2, 2, n),
                   rng.uniform(6, 30, n)], -1).astype(np.float32)
    T_last = np.asarray(jse3.exp(jnp.asarray(
        [0.01, -0.02, 0.005, 0.1, 0.0, 0.3], jnp.float32)))
    T_cur = np.asarray(jse3.exp(jnp.asarray(
        [0.012, -0.015, 0.004, 0.15, 0.02, 0.55], jnp.float32)))
    K = jnp.asarray(K_INT)
    uv_last = np.asarray(jcam.project_from_world(jnp.asarray(Xw), K,
                                                 jnp.asarray(T_last)))
    depth_last = np.asarray(jse3.apply(jnp.asarray(T_last), Xw))[:, 2]
    X_tgt = np.asarray(jse3.apply(jnp.asarray(T_cur), Xw))
    uv_cur = np.asarray(jcam.project(jnp.asarray(X_tgt), K))
    flow = (uv_cur - uv_last + rng.normal(0, 0.05, (n, 2))).astype(np.float32)
    bad = rng.random(n) < outlier_frac
    flow[bad] += rng.uniform(-8, 8, (int(bad.sum()), 2)).astype(np.float32)
    uv_obs = (uv_last + flow).astype(np.float32)
    valid = rng.random(n) > 0.1
    return dict(Xw=Xw, X_tgt=X_tgt.astype(np.float32), uv_last=uv_last,
                depth_last=depth_last.astype(np.float32), flow=flow,
                uv_obs=uv_obs, valid=valid, T_last=T_last, T_cur=T_cur)


class TestRansac:
    def test_rigid_from_triangle(self):
        rng = np.random.default_rng(0)
        P = rng.normal(size=(16, 3, 3)).astype(np.float32)
        T = np.asarray(jse3.exp(jnp.asarray(rng.normal(size=(16, 6)) * 0.3,
                                            jnp.float32)))
        Q = np.einsum("sij,skj->ski", T[:, :3, :3], P) + T[:, None, :3, 3]
        port = ransac.rigid_from_triangle(_t(P), _t(Q.astype(np.float32)))
        ref = jax.vmap(jransac.rigid_from_triangle)(jnp.asarray(P),
                                                    jnp.asarray(Q, jnp.float32))
        np.testing.assert_allclose(port, np.asarray(ref), rtol=1e-5, atol=2e-5)
        assert_pose_close(port, T)

    def test_ransac_rigid_single(self):
        pr = make_problem(400, 1)
        key = jax.random.PRNGKey(3)
        S = 64
        args = (pr["Xw"], pr["X_tgt"], pr["uv_obs"], pr["valid"])
        T_j, m_j, n_j = jransac.ransac_rigid(*map(jnp.asarray, args),
                                             jnp.asarray(K_INT), key,
                                             n_samples=S, thres=0.4)

        def sample(n_valid):  # ransac.py:164
            return _t(np.asarray(jax.random.randint(key, (S, 3), 0,
                                                    int(n_valid)))).long()

        T_p, m_p, n_p = ransac.ransac_rigid(*map(_t, args), _t(K_INT), sample,
                                            thres=0.4)
        np.testing.assert_array_equal(m_p, np.asarray(m_j))
        assert int(n_p) == int(n_j) > 100
        assert_pose_close(T_p, T_j)

    def test_ransac_rigid_batched_slots(self):
        """Three slots with different member masks, keys split per slot."""
        pr = make_problem(300, 2)
        rng = np.random.default_rng(4)
        masks = np.stack([pr["valid"] & (rng.random(300) > f)
                          for f in (0.0, 0.5, 0.97)])
        key = jax.random.PRNGKey(5)
        keys = jax.random.split(key, 3)
        S = 32
        K = jnp.asarray(K_INT)
        ref = jax.vmap(lambda m, k: jransac.ransac_rigid(
            jnp.asarray(pr["Xw"]), jnp.asarray(pr["X_tgt"]),
            jnp.asarray(pr["uv_obs"]), m, K, k, n_samples=S, thres=0.4))(
                jnp.asarray(masks), keys)

        def sample(n_valid):
            return _t(np.stack([np.asarray(jax.random.randint(
                keys[i], (S, 3), 0, int(n_valid[i]))) for i in range(3)])).long()

        rep = lambda x: _t(np.broadcast_to(x, (3,) + x.shape))  # noqa: E731
        T_p, m_p, n_p = ransac.ransac_rigid(
            rep(pr["Xw"]), rep(pr["X_tgt"]), rep(pr["uv_obs"]), _t(masks),
            _t(K_INT), sample, thres=0.4)
        np.testing.assert_array_equal(m_p, np.asarray(ref[1]))
        np.testing.assert_array_equal(n_p, np.asarray(ref[2]))
        assert_pose_close(T_p, ref[0])

    def test_choose_init_and_refit(self):
        pr = make_problem(300, 6)
        K = jnp.asarray(K_INT)
        mask_r = pr["valid"] & (np.arange(300) % 3 == 0)
        T_model = pr["T_cur"] @ pr["T_last"] @ np.linalg.inv(pr["T_last"])
        T_r = np.asarray(jse3.exp(jnp.asarray([0, 0, 0, 0.3, 0, 0.1],
                                              jnp.float32))) @ pr["T_cur"]
        args = (pr["Xw"], pr["uv_obs"], pr["valid"])
        ref = jransac.choose_init(jnp.asarray(T_r), jnp.asarray(mask_r),
                                  jnp.asarray(mask_r.sum()),
                                  jnp.asarray(T_model.astype(np.float32)),
                                  *map(jnp.asarray, args), K, thres=0.4)
        port = ransac.choose_init(_t(T_r), _t(mask_r), torch.tensor(
            int(mask_r.sum())), _t(T_model.astype(np.float32)),
            *map(_t, args), _t(K_INT), thres=0.4)
        np.testing.assert_array_equal(port[1], np.asarray(ref[1]))
        assert int(port[2]) == int(ref[2]) and bool(port[3]) == bool(ref[3])
        assert_pose_close(port[0], ref[0])
        inl = np.asarray(ref[1])
        refit = ransac.refine_with_inliers(port[0], _t(pr["Xw"]),
                                           _t(pr["X_tgt"]), _t(inl))
        jrefit = jransac.refine_with_inliers(ref[0], jnp.asarray(pr["Xw"]),
                                             jnp.asarray(pr["X_tgt"]),
                                             jnp.asarray(inl))
        assert_pose_close(refit, jrefit)
        assert_pose_close(refit, pr["T_cur"], tol=1e-2)

    def test_polar_and_degenerate_fallback(self):
        rng = np.random.default_rng(7)
        M = rng.normal(size=(8, 3, 3)).astype(np.float32)
        np.testing.assert_allclose(ransac._polar3(_t(M)),
                                   np.asarray(jransac._polar3(jnp.asarray(M))),
                                   rtol=1e-5, atol=1e-5)
        P = rng.normal(size=(10, 3)).astype(np.float32)
        w = np.zeros(10, np.float32)
        w[:2] = 1.0  # fewer than 3 points: the fallback
        fb = np.eye(4, dtype=np.float32) * 2
        out = ransac.kabsch_polar(_t(P), _t(P), _t(w), _t(fb))
        np.testing.assert_array_equal(out, fb)


class TestKabsch:
    """The port's SVD Kabsch (solvers/ransac.py:kabsch): the JAX tests of
    tests/test_solvers.py:137-172 on the port, with the same jax.random
    inputs, and the port against JAX's kabsch on seeded inputs."""

    @staticmethod
    def _se3_err(T_a, T_b):
        from vdo_slam_tpu_torch.geometry import se3

        return float(torch.linalg.vector_norm(
            se3.log(se3.inv(T_a) @ T_b)))

    def test_kabsch_exact(self):
        from vdo_slam_tpu_torch.geometry import se3

        P = _t(jax.random.normal(jax.random.PRNGKey(0), (10, 3)) * 5.0)
        T_true = se3.exp(torch.tensor([0.3, -0.2, 0.5, 1.0, 2.0, -0.5]))
        Q = se3.apply(T_true, P)
        T = ransac.kabsch(P, Q, torch.ones(10))
        assert self._se3_err(T, T_true) < 1e-4

    def test_kabsch_polar_matches_svd_kabsch(self):
        from vdo_slam_tpu_torch.geometry import se3

        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
        P = _t(jax.random.normal(k1, (64, 3)) * 4.0)
        T_true = se3.exp(torch.tensor([-0.4, 0.25, 0.6, 0.5, -1.5, 2.0]))
        Q = se3.apply(T_true, P) + 0.05 * _t(jax.random.normal(k2, (64, 3)))
        w = _t(jax.random.uniform(k3, (64,), minval=0.0, maxval=1.0))
        T_svd = ransac.kabsch(P, Q, w)
        T_pol = ransac.kabsch_polar(P, Q, w, torch.eye(4))
        assert self._se3_err(T_svd, T_pol) < 1e-4
        assert self._se3_err(T_pol, T_true) < 0.05

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_kabsch_matches_jax(self, seed):
        rng = np.random.default_rng(seed)
        P = rng.normal(size=(40, 3)).astype(np.float32) * 3.0
        R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        R *= np.sign(np.linalg.det(R))
        Q = (P @ R.T + rng.normal(size=3) + 0.02 * rng.normal(size=(40, 3))
             ).astype(np.float32)
        w = rng.uniform(0.0, 1.0, 40).astype(np.float32)
        got = ransac.kabsch(_t(P), _t(Q), _t(w)).numpy()
        want = np.asarray(jransac.kabsch(jnp.asarray(P), jnp.asarray(Q),
                                         jnp.asarray(w)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


class TestFlowLM:
    @pytest.mark.parametrize("iters", [4, 10])
    def test_camera_solve(self, iters):
        pr = make_problem(500, 8)
        T0 = np.asarray(jse3.exp(jnp.asarray([0.002, 0, -0.001, 0.02, -0.01,
                                              0.03], jnp.float32))) @ pr["T_cur"]
        jp = jlm.FlowLMParams(info_flow=0.3, iters=iters, lambda_init=1e-5,
                              unroll=2)
        pp = flow_lm.FlowLMParams(info_flow=0.3, iters=iters, lambda_init=1e-5)
        args = (pr["uv_last"], pr["depth_last"], pr["flow"], pr["T_last"],
                pr["valid"])
        ref = jlm.solve(jnp.asarray(T0), *map(jnp.asarray, args),
                        jnp.asarray(K_INT), jp)
        out = flow_lm.solve(_t(T0), *map(_t, args), _t(K_INT), pp)
        np.testing.assert_array_equal(out["inlier"], np.asarray(ref["inlier"]))
        assert int(out["n_inlier"]) == int(ref["n_inlier"]) > 300
        assert_pose_close(out["T"], ref["T"])
        np.testing.assert_allclose(out["flow"], np.asarray(ref["flow"]),
                                   rtol=0, atol=1e-3)
        if iters == 10:  # and it converged: near the truth, up to the noise
            assert_pose_close(out["T"], pr["T_cur"], tol=1e-2)

    def test_batched_object_slots(self):
        """K=3 slots as one batched solve == vmap of the JAX solve in its
        inliers; one slot has fewer than 3 correspondences and keeps its
        init.  Poses: each slot against the port's float64 solve
        (`assert_fp32_close`), with JAX's vmap and solo solves as its fp32
        spread.  Slot 1 (82 correspondences) is 3.6e-5 m from float64 in
        the port and in JAX's own solo solve, 7e-7 m in JAX's vmap."""
        pr = make_problem(256, 9)
        rng = np.random.default_rng(10)
        valid = np.stack([pr["valid"], pr["valid"] & (rng.random(256) > 0.6),
                          np.arange(256) < 2])
        T0 = np.stack([np.asarray(jse3.exp(jnp.asarray(
            rng.normal(size=6) * 0.01, jnp.float32))) @ pr["T_cur"]
            for _ in range(3)]).astype(np.float32)
        jp = jlm.FlowLMParams(info_flow=0.5, iters=6, lambda_init=1e-5,
                              unroll=2)
        pp = flow_lm.FlowLMParams(info_flow=0.5, iters=6, lambda_init=1e-5)
        K = jnp.asarray(K_INT)
        ref = jax.vmap(lambda T, v: jlm.solve(
            T, jnp.asarray(pr["uv_last"]), jnp.asarray(pr["depth_last"]),
            jnp.asarray(pr["flow"]), jnp.asarray(pr["T_last"]), v, K, jp))(
                jnp.asarray(T0), jnp.asarray(valid))
        rep = lambda x: _t(np.broadcast_to(x, (3,) + x.shape))  # noqa: E731
        out = flow_lm.solve(_t(T0), rep(pr["uv_last"]), rep(pr["depth_last"]),
                            rep(pr["flow"]), _t(pr["T_last"]), _t(valid),
                            _t(K_INT), pp)
        np.testing.assert_array_equal(out["inlier"], np.asarray(ref["inlier"]))
        np.testing.assert_array_equal(out["n_inlier"],
                                      np.asarray(ref["n_inlier"]))
        o64 = flow_lm.solve(_f64(T0), rep(pr["uv_last"].astype(np.float64)),
                            rep(pr["depth_last"].astype(np.float64)),
                            rep(pr["flow"].astype(np.float64)),
                            _f64(pr["T_last"]), _t(valid), _f64(K_INT), pp)
        np.testing.assert_array_equal(o64["inlier"], out["inlier"])
        shared = (pr["uv_last"], pr["depth_last"], pr["flow"])
        for k in range(3):
            solo = jax_solo_runs(T0[k], shared, pr["T_last"], valid[k], jp)
            assert_fp32_close(out["T"][k], [ref["T"][k]]
                              + [r["T"] for r in solo], o64["T"][k])
        np.testing.assert_array_equal(out["T"][2], T0[2])


class TestFlowLMWrappers:
    """solve_camera / solve_objects (flow_lm.py:224-252): the solve plus
    uv_cur = uv_last + refined flow, and the per-slot batch."""

    def test_solve_camera(self):
        # test_camera_solve's problem, through the wrapper
        pr = make_problem(500, 8)
        xi = jnp.asarray([0.002, 0, -0.001, 0.02, -0.01, 0.03], jnp.float32)
        T0 = np.asarray(jse3.exp(xi)) @ pr["T_cur"]
        jp = jlm.FlowLMParams(info_flow=0.3, iters=4, lambda_init=1e-5,
                              unroll=2)
        pp = flow_lm.FlowLMParams(info_flow=0.3, iters=4, lambda_init=1e-5)
        args = (pr["uv_last"], pr["depth_last"], pr["flow"], pr["T_last"],
                pr["valid"])
        ref = jlm.solve_camera(jnp.asarray(T0), *map(jnp.asarray, args),
                               jnp.asarray(K_INT), jp)
        out = flow_lm.solve_camera(_t(T0), *map(_t, args), _t(K_INT), pp)
        assert set(out) == set(ref)
        np.testing.assert_array_equal(out["inlier"], np.asarray(ref["inlier"]))
        assert_pose_close(out["T"], ref["T"])
        np.testing.assert_allclose(out["uv_cur"], np.asarray(ref["uv_cur"]),
                                   rtol=0, atol=1e-3)

    def test_solve_objects(self):
        """The batched wrapper, held as test_batched_object_slots holds the
        solve.  Slot 0 (182 correspondences): the last of the 4 steps gains
        3.6e-7 of the cost, within the rounding of its fp32 sum, so fp32
        takes it or not with the summation order; the port's batch skips
        it (2.7e-5 m and 1.45e-3 px of uv_cur from float64), as JAX does
        on one of the N_PERM orders."""
        pr = make_problem(200, 12)
        rng = np.random.default_rng(13)
        valid = np.stack([pr["valid"], pr["valid"] & (rng.random(200) > 0.5)])
        G0 = np.stack([np.asarray(jse3.exp(jnp.asarray(
            rng.normal(size=6) * 0.01, jnp.float32))) @ pr["T_cur"]
            for _ in range(2)]).astype(np.float32)
        jp = jlm.FlowLMParams(info_flow=0.5, iters=4, lambda_init=1e-5,
                              unroll=2)
        pp = flow_lm.FlowLMParams(info_flow=0.5, iters=4, lambda_init=1e-5)
        shared = (pr["uv_last"], pr["depth_last"], pr["flow"], pr["T_last"])
        ref = jlm.solve_objects(jnp.asarray(G0), *map(jnp.asarray, shared),
                                jnp.asarray(valid), jnp.asarray(K_INT), jp)
        out = flow_lm.solve_objects(_t(G0), *map(_t, shared), _t(valid),
                                    _t(K_INT), pp)
        assert set(out) == set(ref)
        assert out["uv_cur"].shape == (2, 200, 2)
        np.testing.assert_array_equal(out["n_inlier"],
                                      np.asarray(ref["n_inlier"]))
        o64 = flow_lm.solve_objects(_f64(G0), *map(_f64, shared), _t(valid),
                                    _f64(K_INT), pp)
        for k in range(2):
            solo = jax_solo_runs(G0[k], shared[:3], pr["T_last"], valid[k],
                                 jp)
            assert_fp32_close(out["T"][k], [ref["T"][k]]
                              + [r["T"] for r in solo], o64["T"][k])
            assert_fp32_close(out["uv_cur"][k], [ref["uv_cur"][k]]
                              + [r["uv_cur"] for r in solo],
                              o64["uv_cur"][k], uv_err, 1e-3, UV_CAP)
