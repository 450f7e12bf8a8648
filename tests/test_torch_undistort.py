"""ops/undistort.py of the port against the JAX package's on the same
seeded pixels and coefficients: distort_points and
undistorted_image_bounds within 1e-4 px plus one float32 rounding of the
coordinate (RTOL: an ulp of a coordinate above 1024 px is 1.2e-4 px);
undistort_points over the whole 1242x375 image within 2e-4 px, because
each package is itself 1.7e-4 px off the float64 result near the corners
of the strong barrel model and the two round the 8 fixed-point iterations
differently (1.5e-4 px apart at most); and undistort(distort(x)) back to x
within 1e-3 px where the 8 iterations converge.  Also the stages' warps:
none for a camera without distortion, and the pair (to_pinhole, to_raw)
the JAX package builds otherwise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdo_slam_tpu.ops import undistort as jud
from vdo_slam_tpu.pipeline import stages as jstages
from vdo_slam_tpu_torch.config import VDOConfig
from vdo_slam_tpu_torch.ops import undistort as pud
from vdo_slam_tpu_torch.pipeline import stages

ATOL_PX, RTOL, ROUND_TRIP_PX = 1e-4, 1.2e-7, 1e-3
UNDISTORT_ATOL_PX = 2e-4
K = np.array([721.5377, 721.5377, 621.0, 187.5], np.float32)
W, H = 1242, 375
COEFFS = {
    "barrel": (-0.28, 0.07, 0.0, 0.0, 0.0),
    "tangential": (-0.1, 0.02, 1e-3, -5e-4, 0.0),
    "k3": (-0.2, 0.05, 2e-4, 1e-4, -0.01),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pixels(seed):
    rng = np.random.default_rng(seed)
    return (rng.random((500, 2)) * [W, H]).astype(np.float32)


def _both(name):
    d = np.array(COEFFS[name], np.float32)
    return (torch.from_numpy(K), torch.from_numpy(d)), (jnp.asarray(K),
                                                        jnp.asarray(d))


@pytest.mark.parametrize("name", list(COEFFS))
def test_distort_and_undistort_match_jax(name):
    (Kt, dt), (Kj, dj) = _both(name)
    uv = _pixels(1)
    np.testing.assert_allclose(
        pud.distort_points(torch.from_numpy(uv), Kt, dt).numpy(),
        np.asarray(jud.distort_points(jnp.asarray(uv), Kj, dj)),
        atol=ATOL_PX, rtol=RTOL)
    np.testing.assert_allclose(
        pud.undistort_points(torch.from_numpy(uv), Kt, dt).numpy(),
        np.asarray(jud.undistort_points(jnp.asarray(uv), Kj, dj)),
        atol=UNDISTORT_ATOL_PX, rtol=0)
    xy = _pixels(2)[:, None, :] * 0.5  # a leading batch dimension
    np.testing.assert_allclose(
        pud.distort_normalized(torch.from_numpy(xy / 1000.0), dt).numpy(),
        np.asarray(jud.distort_normalized(jnp.asarray(xy / 1000.0), dj)),
        atol=1e-7, rtol=0)


@pytest.mark.parametrize("name", list(COEFFS))
def test_round_trip(name):
    (Kt, dt), _ = _both(name)
    # pinhole points in the central half of the image, where 8 fixed-point
    # iterations invert even the strong barrel model
    uv = torch.from_numpy(_pixels(3) * 0.5 + np.float32([0.25 * W, 0.25 * H]))
    back = pud.undistort_points(pud.distort_points(uv, Kt, dt), Kt, dt)
    assert float((back - uv).abs().max()) < ROUND_TRIP_PX


@pytest.mark.parametrize("name", list(COEFFS))
def test_image_bounds_match_jax(name):
    (Kt, dt), (Kj, dj) = _both(name)
    port = pud.undistorted_image_bounds(W, H, Kt, dt)
    ref = jud.undistorted_image_bounds(W, H, Kj, dj)
    for a, b in zip(port, ref):
        assert abs(float(a) - float(b)) <= ATOL_PX + RTOL * abs(float(b))


def test_stage_warps():
    cfg = VDOConfig()
    assert stages._warps(cfg, "cpu") is None
    cfg = cfg.replace(camera=dataclasses.replace(
        cfg.camera, fx=float(K[0]), fy=float(K[1]), cx=float(K[2]),
        cy=float(K[3]), k1=-0.28, k2=0.07))
    from vdo_slam_tpu.config import VDOConfig as JConfig

    jcfg = JConfig()
    jcfg = jcfg.replace(camera=dataclasses.replace(
        jcfg.camera, **dataclasses.asdict(cfg.camera)))
    to_pin, to_raw = stages._warps(cfg, "cpu")
    j_pin, j_raw = jstages._warps(jcfg)
    uv = _pixels(4)
    np.testing.assert_allclose(to_pin(torch.from_numpy(uv)).numpy(),
                               np.asarray(j_pin(jnp.asarray(uv))),
                               atol=UNDISTORT_ATOL_PX, rtol=0)
    np.testing.assert_allclose(to_raw(torch.from_numpy(uv)).numpy(),
                               np.asarray(j_raw(jnp.asarray(uv))),
                               atol=ATOL_PX, rtol=RTOL)
