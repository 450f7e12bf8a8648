"""RANSAC and the joint flow-pose LM of the port against the JAX package's.

The random picks are drawn with jax.random exactly where ransac.py:164
draws them (per slot from jax.random.split, as stages.py:384 does) and fed
to the port.  Inlier masks and counts must be identical; poses agree
within 1e-5 (m for translations, rad for rotations) after the same fixed
number of LM iterations.
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
        """K=3 slots as one batched solve == vmap of the JAX solve; one slot
        has fewer than 3 correspondences and keeps its init."""
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
        assert_pose_close(out["T"], ref["T"])
        np.testing.assert_array_equal(out["T"][2], T0[2])
