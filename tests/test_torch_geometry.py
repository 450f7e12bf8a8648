"""The port's geometry (vdo_slam_tpu_torch/geometry) against the JAX
package's, on the same numpy inputs.

Tolerance: 1e-5 relative (plus a 1e-6 absolute floor for entries near
zero) — both sides are fp32 with the same formulas, differing only in the
order of a few sums.  The cases of tests/test_se3.py are ported below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdo_slam_tpu.geometry import camera as jcam
from vdo_slam_tpu.geometry import metrics as jmet
from vdo_slam_tpu.geometry import se3 as jse3
from vdo_slam_tpu_torch.geometry import camera, metrics, se3

RTOL, ATOL = 1e-5, 1e-6


def close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def random_tangents(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    xi = rng.uniform(-scale, scale, (n, 6)).astype(np.float32)
    # near-identity rotations inside the 1e-4 Taylor windows
    xi[: n // 4, :3] *= 1e-4
    xi[n // 4: n // 2, :3] = rng.uniform(-3e-3, 3e-3, (n // 4, 3))
    return xi


def random_poses(n, seed):
    return np.asarray(jse3.exp(jnp.asarray(random_tangents(n, seed))))


class TestSE3Parity:
    @pytest.mark.parametrize("fn", ["exp", "so3_exp", "hat"])
    def test_tangent_maps(self, fn):
        xi = random_tangents(64, 0)
        x = xi if fn == "exp" else xi[:, :3]
        close(getattr(se3, fn)(_t(x)), getattr(jse3, fn)(jnp.asarray(x)))

    @pytest.mark.parametrize("fn", ["log", "inv", "orthonormalize"])
    def test_pose_maps(self, fn):
        T = random_poses(64, 1)
        close(getattr(se3, fn)(_t(T)), getattr(jse3, fn)(jnp.asarray(T)),
              atol=2e-6)

    def test_so3_log_and_vee(self):
        R = random_poses(64, 2)[:, :3, :3]
        close(se3.so3_log(_t(R)), jse3.so3_log(jnp.asarray(R)), atol=2e-6)
        close(se3.vee(_t(R)), jse3.vee(jnp.asarray(R)))

    def test_from_Rt_apply_compose_retract(self):
        T = random_poses(16, 3)
        rng = np.random.default_rng(4)
        X = rng.normal(size=(16, 3)).astype(np.float32)
        xi = random_tangents(16, 5, 0.1)
        close(se3.from_Rt(_t(T[:, :3, :3]), _t(T[:, :3, 3])),
              jse3.from_Rt(jnp.asarray(T[:, :3, :3]), jnp.asarray(T[:, :3, 3])))
        close(se3.apply(_t(T), _t(X)), jse3.apply(jnp.asarray(T), jnp.asarray(X)))
        close(se3.compose(_t(T), _t(T[::-1].copy())),
              jse3.compose(jnp.asarray(T), jnp.asarray(T[::-1])))
        close(se3.retract(_t(T), _t(xi)),
              jse3.retract(jnp.asarray(T), jnp.asarray(xi)))

    # the cases of tests/test_se3.py, on the port
    def test_exp_log_roundtrip(self):
        xi = np.random.default_rng(0).uniform(-1, 1, (64, 6)).astype(np.float32)
        close(se3.log(se3.exp(_t(xi))), xi, rtol=0, atol=2e-4)

    def test_exp_zero_is_identity(self):
        close(se3.exp(torch.zeros(6)), np.eye(4), rtol=0, atol=1e-7)

    def test_exp_small_angle_stable(self):
        T = se3.exp(torch.tensor([1e-9, 0, 0, 1.0, 2.0, 3.0]))
        close(T[:3, 3], [1.0, 2.0, 3.0], rtol=0, atol=1e-5)
        assert torch.isfinite(T).all()

    def test_inverse_analytic(self):
        T = _t(random_poses(16, 6))
        close(T @ se3.inv(T), np.broadcast_to(np.eye(4), (16, 4, 4)),
              rtol=0, atol=1e-5)

    def test_so3_log_roundtrip(self):
        w = torch.tensor([[0.3, -0.2, 0.9], [1e-7, 0, 0], [0, 3.0, 0]])
        close(se3.so3_log(se3.so3_exp(w)), w, rtol=0, atol=1e-4)

    def test_orthonormalize(self):
        T = _t(random_poses(1, 7))[0]
        T[:3, :3] *= 1.001
        R = se3.orthonormalize(T)[:3, :3]
        close(R @ R.T, np.eye(3), rtol=0, atol=1e-5)


class TestCameraParity:
    K = np.asarray([721.5377, 721.5377, 609.5593, 172.854], np.float32)

    def test_project_unproject(self):
        rng = np.random.default_rng(8)
        uv = rng.uniform(0, 1200, (32, 2)).astype(np.float32)
        z = rng.uniform(2, 40, (32,)).astype(np.float32)
        z[:4] = [0.0, 1e-7, -1e-7, -3.0]       # the eps guard of project
        K = self.K
        Xc = camera.unproject(_t(uv), _t(z), _t(K))
        close(Xc, jcam.unproject(jnp.asarray(uv), jnp.asarray(z), jnp.asarray(K)))
        close(camera.project(Xc, _t(K)),
              jcam.project(jnp.asarray(np.asarray(Xc)), jnp.asarray(K)))
        T = random_poses(1, 9)[0]
        close(camera.unproject_to_world(_t(uv), _t(z), _t(K), _t(T)),
              jcam.unproject_to_world(jnp.asarray(uv), jnp.asarray(z),
                                      jnp.asarray(K), jnp.asarray(T)),
              atol=1e-4)
        assert np.array_equal(
            np.asarray(camera.in_bounds(_t(uv), 1242, 375)),
            np.asarray(jcam.in_bounds(jnp.asarray(uv), 1242, 375)))


class TestMetricsParity:
    def test_angle_rpe_speed(self):
        T = random_poses(4, 10)
        Tj = [jnp.asarray(x) for x in T]
        Tt = [_t(x) for x in T]
        for p, r in zip(metrics.camera_rpe(*Tt), jmet.camera_rpe(*Tj)):
            close(p, r, atol=1e-5)
        close(metrics.clamped_trace_angle_deg(_t(T)),
              jmet.clamped_trace_angle_deg(jnp.asarray(T)), atol=1e-5)
        c = np.asarray([[5.0, 0.0, 20.0]] * 4, np.float32)
        close(metrics.object_speed(_t(T), _t(c)),
              jmet.object_speed(jnp.asarray(T), jnp.asarray(c)), atol=1e-4)

    def test_small_angle_no_fp32_floor(self):
        ang = 2e-4
        T = se3.from_Rt(se3.so3_exp(torch.tensor([0.0, 0.0, ang])),
                        torch.zeros(3))
        close(metrics.clamped_trace_angle_deg(T), np.degrees(ang), rtol=0.02)
        assert float(metrics.clamped_trace_angle_deg(torch.eye(4))) < 1e-5

    def test_object_speed_pure_translation(self):
        H = se3.from_Rt(torch.eye(3), torch.tensor([1.0, 0.0, 0.0]))
        close(metrics.object_speed(H, torch.tensor([5.0, 0.0, 20.0])), 36.0,
              rtol=0, atol=1e-4)
