"""solvers/reproj_lm.py of the port against the JAX package's, on the same
seeded problems: the robust camera solve (with and without the depth
noise, which the port is fed as the same standard normals the JAX solve
draws) and the per-slot object solve without a robust kernel.

Tolerances: poses within 1e-4 m and 1e-3 deg; inlier masks equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_slice import pose_gap
from vdo_slam_tpu.solvers import reproj_lm as jlm
from vdo_slam_tpu_torch.solvers import reproj_lm as plm

T_TOL_M, R_TOL_DEG = 1e-4, 1e-3
K = np.array([320.0, 320.0, 160.0, 120.0], np.float32)
N = 400


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pose(rng, rot, trans):
    w = rng.normal(size=3) * rot
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    T[:3, 3] = rng.normal(size=3) * trans
    return T


def problem(seed, n_out=40):
    """Last-frame pixels and depths seen from T_cw_last; current
    observations from T_true with pixel noise and gross outliers; an init
    perturbed from T_true."""
    rng = np.random.default_rng(seed)
    T_last = _pose(rng, 0.02, 0.3)
    T_true = _pose(rng, 0.03, 0.5) @ T_last
    uv_last = rng.uniform([10, 10], [310, 230], (N, 2))
    z = rng.uniform(4.0, 30.0, N)
    Xc = np.stack([(uv_last[:, 0] - K[2]) / K[0] * z,
                   (uv_last[:, 1] - K[3]) / K[1] * z, z], -1)
    Xw = (np.linalg.inv(T_last) @ np.c_[Xc, np.ones(N)].T).T[:, :3]
    Y = (T_true @ np.c_[Xw, np.ones(N)].T).T[:, :3]
    uv_obs = np.stack([K[0] * Y[:, 0] / Y[:, 2] + K[2],
                       K[1] * Y[:, 1] / Y[:, 2] + K[3]], -1)
    uv_obs += rng.normal(0, 0.03, uv_obs.shape)
    uv_obs[:n_out] += rng.uniform(-8, 8, (n_out, 2))
    valid = rng.random(N) > 0.05
    T_init = _pose(rng, 0.002, 0.02) @ T_true
    f32 = np.float32
    return (T_init.astype(f32), uv_obs.astype(f32), uv_last.astype(f32),
            z.astype(f32), T_last.astype(f32), valid)


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("seed,noise", [(0, False), (1, True), (2, True)])
def test_solve_pose_matches_jax(seed, noise):
    args = problem(seed)
    p_port = plm.ReprojLMParams(iters=10)
    p_jax = jlm.ReprojLMParams(iters=10)
    scale = 0.15 / (725.0 * 0.5) if noise else 0.0
    key = jax.random.PRNGKey(seed)
    normals = np.array(jax.random.normal(key, (N,)))
    ref = jlm.solve_pose(*_j(*args), jnp.asarray(K), p_jax,
                         noise_key=key if noise else None, noise_scale=scale)
    out = plm.solve_pose(*_t(*args), torch.from_numpy(K), p_port,
                         noise=torch.from_numpy(normals) if noise else None,
                         noise_scale=scale)
    dt, dr = pose_gap(out["T"].numpy(), np.asarray(ref["T"]))
    assert dt < T_TOL_M and dr < R_TOL_DEG, (dt, dr)
    np.testing.assert_array_equal(out["inlier"].numpy(),
                                  np.asarray(ref["inlier"]))
    assert int(out["n_inlier"]) == int(ref["n_inlier"]) > N // 2
    # the solve moved the pose: the init is off by more than the tolerance
    assert pose_gap(args[0], np.asarray(ref["T"]))[0] > 10 * T_TOL_M


def test_solve_pose_too_few_keeps_init():
    T_init, uv_obs, uv_last, z, T_last, valid = problem(3)
    valid = np.zeros_like(valid)
    valid[:2] = True
    out = plm.solve_pose(*_t(T_init, uv_obs, uv_last, z, T_last, valid),
                         torch.from_numpy(K), plm.ReprojLMParams(iters=5))
    assert torch.equal(out["T"], torch.from_numpy(T_init))


def test_solve_objects_matches_jax():
    """Three slots over one shared bank, each its own subset and init."""
    T_init, uv_obs, uv_last, z, T_last, _ = problem(4, n_out=0)
    rng = np.random.default_rng(4)
    slot = rng.integers(0, 3, N)
    valid = np.stack([slot == k for k in range(3)])
    valid[2] = False                                # an empty slot
    G0 = np.stack([T_init, _pose(rng, 0.001, 0.01).astype(np.float32)
                   @ T_init, T_init])
    p_port = plm.ReprojLMParams(iters=6, robust=False)
    p_jax = jlm.ReprojLMParams(iters=6, robust=False)
    ref = jlm.solve_objects(*_j(G0, uv_obs, uv_last, z, T_last, valid),
                            jnp.asarray(K), p_jax)
    out = plm.solve_objects(*_t(G0, uv_obs, uv_last, z, T_last, valid),
                            torch.from_numpy(K), p_port)
    assert out["T"].shape == (3, 4, 4)
    for k in range(3):
        dt, dr = pose_gap(out["T"][k].numpy(), np.asarray(ref["T"][k]))
        assert dt < T_TOL_M and dr < R_TOL_DEG, (k, dt, dr)
    np.testing.assert_array_equal(out["inlier"].numpy(),
                                  np.asarray(ref["inlier"]))
    np.testing.assert_array_equal(out["n_inlier"].numpy(),
                                  np.asarray(ref["n_inlier"]))
    assert torch.equal(out["T"][2], torch.from_numpy(G0[2]))
