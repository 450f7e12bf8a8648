"""Reprojection-only pose/motion LM, the reference's non-joint path — port
of vdo_slam_tpu/solvers/reproj_lm.py.

  * Optimizer::PoseOptimizationNew (camera, Optimizer.cc:2177-2331): unary
    residuals obs - pi(T X_w), Huber delta^2 = 0.01, chi2 gate 0.01,
    optional Gaussian depth noise on the anchor unprojection
    (Frame.cc:489-493);
  * Optimizer::PoseOptimizationObjMot (object, Optimizer.cc:2544-2753): the
    same residual with the vertex G = T_cw H and no robust kernel.

Selected by TrackingConfig.joint_flow=False.  The JAX lax.scan is a loop of
`iters` steps with accept/reject by torch.where; nothing reads the device.
Leading batch dimensions of T_init and valid solve several poses at once
(the object slots; the JAX vmap).  H and g are summed through
flow_lm._normal_sum, so in float64 on a CUDA device (see that module).
The depth noise is an input (standard normals), so a test can feed the
JAX package's draws.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry import camera as cam
from ..geometry import se3
from .flow_lm import (_f32_sqrt, _huber_weight, _normal_sum,
                      _pose_point_jacobian, _proj_jacobian)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ReprojLMParams:
    rp_thres: float = 0.01        # chi2 gate + Huber delta^2 (Optimizer.cc:2187)
    info: float = 1.0             # unit information (Optimizer.cc:2259)
    iters: int = 30
    lambda_init: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.5
    robust: bool = True           # camera: Huber; object: no kernel (ref)
    min_corres: int = 3


def _depth_noise(normals: Tensor, z: Tensor, scale: float) -> Tensor:
    """The reference's fault-injection model: sigma = z^2 * scale
    (Frame.cc:492: z^2/(725*0.5)*0.15)."""
    return z + z * z * scale * normals


def solve_pose(T_init, uv_obs, uv_last, depth_last, T_cw_last, valid, K,
               p: ReprojLMParams, noise: Tensor | None = None,
               noise_scale: float = 0.0):
    """Pose-only LM: minimize Huber(|uv_obs - pi(T X_w)|^2 * info).

    X_w = last-frame unprojection through inv(T_cw_last), with the
    reference's synthetic depth noise where `noise` (standard normals of
    depth_last's shape) is given and noise_scale > 0.  T_init (..., 4, 4),
    valid (..., N); the points are shared.  Returns dict(T, inlier, chi2,
    n_inlier).
    """
    z = depth_last
    if noise is not None and noise_scale > 0:
        z = _depth_noise(noise, z, noise_scale)
    X_w = cam.unproject_to_world(uv_last, z, K, se3.inv(T_cw_last))
    vf = valid.to(torch.float32)
    batch = T_init.shape[:-2]
    dev = T_init.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def residual(T):
        Y = se3.apply(T[..., None, :, :], X_w)
        r = uv_obs - cam.project(Y, K)
        return r, p.info * torch.sum(r * r, dim=-1), Y

    def cost(T):
        _, chi2, _ = residual(T)
        if p.robust:
            d = _f32_sqrt(p.rp_thres)
            rho = torch.where(chi2 <= p.rp_thres, chi2,
                              2 * d * torch.sqrt(torch.clamp(chi2, min=1e-12))
                              - p.rp_thres)
        else:
            rho = chi2
        return torch.sum(rho * vf, dim=-1)

    T = T_init
    lam = torch.full(batch, p.lambda_init, dtype=torch.float32, device=dev)
    c = cost(T_init)
    for _ in range(p.iters):
        r, chi2, Y = residual(T)
        w = (_huber_weight(chi2, p.rp_thres) if p.robust
             else torch.ones_like(chi2)) * p.info * vf
        J = -(_proj_jacobian(Y, K) @ _pose_point_jacobian(Y))  # (..., N, 2, 6)
        H = _normal_sum("...n,...nij,...nik->...jk", w, J, J)
        g = -_normal_sum("...n,...nij,...ni->...j", w, J, r)
        d = torch.sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1),
                                   min=1e-12))
        Hs = H / d[..., :, None] / d[..., None, :] + lam[..., None, None] * eye6
        dxi = torch.linalg.solve_ex(Hs, (g / d)[..., None])[0][..., 0] / d
        T_new = se3.retract(T, dxi)
        c_new = cost(T_new)
        ok = c_new < c
        T = torch.where(ok[..., None, None], T_new, T)
        lam = torch.clamp(torch.where(ok, lam * p.lambda_down,
                                      lam * p.lambda_up), 1e-9, 1e6)
        c = torch.where(ok, c_new, c)
    _, chi2, _ = residual(T)
    inlier = valid & (chi2 <= p.rp_thres)
    enough = valid.sum(dim=-1) >= p.min_corres
    T = torch.where(enough[..., None, None], T, T_init)
    return {"T": T, "inlier": inlier, "chi2": chi2,
            "n_inlier": inlier.sum(dim=-1)}


def solve_camera(T_init, uv_obs, uv_last, depth_last, T_cw_last, valid, K,
                 p: ReprojLMParams):
    return solve_pose(T_init, uv_obs, uv_last, depth_last, T_cw_last, valid,
                      K, p)


def solve_objects(G_init, uv_obs, uv_last, depth_last, T_cw_last, valid, K,
                  p: ReprojLMParams):
    """The object-motion variant over the slots (PoseOptimizationObjMot:
    vertex = G, residual through the current projection; the reference
    runs it without a robust kernel).  G_init (K, 4, 4), valid (K, N)."""
    return solve_pose(G_init, uv_obs, uv_last, depth_last, T_cw_last, valid,
                      K, p)
