"""Joint optical-flow + SE(3) Levenberg-Marquardt — port of
vdo_slam_tpu/solvers/flow_lm.py.

Per correspondence i (last-frame pixel uv_i and depth z_i fixed, anchoring
the world point X_i = T_wl unproject(uv_i, z_i)) the unknowns are the pose
T and a 2-DoF flow f_i with residuals r_p = (uv_i + f_i) - pi(T X_i) and
r_f = f_i - m_i.  The flow blocks are isotropic scalars, so the Schur
complement onto the 6-DoF pose is closed form (see the JAX module's
docstring for the derivation).

`solve` runs the fixed-length, stall-masked iteration of the JAX package's
scan mode (flow_lm.py:193-200): every one of `p.iters` iterations runs, and
lanes that have stalled twice become no-ops.  The JAX while_loop mode stops
at the same point with the same state, so both settings of `unroll` give
this result.  Leading batch dimensions of T_init and valid solve several
poses at once (the K object slots); the 6x6 systems are one batched
`torch.linalg.solve_ex`.

One deliberate difference, on a CUDA device only: the normal equations
(H and g, weighted sums over up to ~1000 correspondences) are accumulated
in float64 and rounded to float32 before the solve.  For a planar object
the 6x6 system is ill-conditioned; with the card's float32 summation order
the object errors of the 100-frame bench scene grew to 1.5-3x the JAX
package's, depending on the random draws, while float32 on the CPU (both
packages) and float64 sums on the card match it (PERF.md).  On the
CPU the sums stay float32, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import camera as cam
from ..geometry import se3

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FlowLMParams:
    info_proj: float = 0.1        # projection information (Optimizer.cc:2405)
    info_flow: float = 0.3        # flow-prior information (0.3 cam / 0.5 obj)
    rp_thres: float = 0.04        # Huber delta^2 and outlier chi2 threshold
    iters: int = 30
    lambda_init: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.5
    min_corres: int = 3           # the reference bails below 3 (2450)
    gain_eps: float = 1e-5        # two accepted sub-eps gains in a row stop


def _proj_jacobian(Y: Tensor, K: Tensor) -> Tensor:
    """d pi / d Y for camera-frame points Y (..., 3) -> (..., 2, 3)."""
    fx, fy = K[0], K[1]
    x, y, z = Y[..., 0], Y[..., 1], Y[..., 2]
    inv_z = 1.0 / torch.clamp(torch.abs(z), min=1e-6) * torch.sign(z + 1e-12)
    zeros = torch.zeros_like(x)
    row0 = torch.stack([fx * inv_z, zeros, -fx * x * inv_z * inv_z], dim=-1)
    row1 = torch.stack([zeros, fy * inv_z, -fy * y * inv_z * inv_z], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _pose_point_jacobian(Y: Tensor) -> Tensor:
    """d(exp(xi) T X)/d xi at 0, xi = (omega, upsilon): (..., 3, 6)."""
    W = -se3.hat(Y)
    eye = torch.eye(3, dtype=Y.dtype, device=Y.device).expand(W.shape)
    return torch.cat([W, eye], dim=-1)


def _residuals(T, f, X_w, uv_last, flow_meas, K):
    Y = se3.apply(T[..., None, :, :], X_w)
    r_p = (uv_last + f) - cam.project(Y, K)
    return r_p, f - flow_meas, Y


def _normal_sum(equation: str, *operands: Tensor) -> Tensor:
    """einsum of the normal equations; on a CUDA device accumulated in
    float64 and rounded to float32 (see the module docstring)."""
    if not operands[0].is_cuda:
        return torch.einsum(equation, *operands)
    return torch.einsum(equation, *[x.double() for x in operands]).float()


def _f32_sqrt(x: float) -> float:
    """sqrt taken in float32, as jnp.sqrt of a Python float is."""
    return float(np.sqrt(np.float32(x)))


def _huber_weight(chi2, delta2):
    """g2o RobustKernelHuber weight rho'(chi2)."""
    delta = torch.full_like(chi2, _f32_sqrt(delta2))  # not reciprocal * delta
    return torch.where(chi2 <= delta2, 1.0,
                       delta / torch.sqrt(torch.clamp(chi2, min=1e-12)))


def _cost(T, f, X_w, uv_last, flow_meas, valid, K, p: FlowLMParams):
    r_p, r_f, _ = _residuals(T, f, X_w, uv_last, flow_meas, K)
    chi2_p = p.info_proj * torch.sum(r_p * r_p, dim=-1)
    delta2 = p.rp_thres
    delta = _f32_sqrt(delta2)
    rho = torch.where(chi2_p <= delta2, chi2_p,
                      2.0 * delta * torch.sqrt(torch.clamp(chi2_p, min=1e-12))
                      - delta2)
    chi2_f = p.info_flow * torch.sum(r_f * r_f, dim=-1)
    return torch.sum(torch.where(valid, rho + chi2_f, 0.0), dim=-1)


def solve(T_init: Tensor, uv_last: Tensor, depth_last: Tensor,
          flow_meas: Tensor, T_cw_last: Tensor, valid: Tensor, K: Tensor,
          p: FlowLMParams):
    """Run the joint flow-pose LM.

    T_init (..., 4, 4); uv_last (..., N, 2); depth_last (..., N);
    flow_meas (..., N, 2); T_cw_last (4, 4); valid (..., N); K (4,).
    Returns dict(T, flow, inlier, chi2, n_inlier, repro_err).
    """
    T_wl = se3.inv(T_cw_last)
    X_w = cam.unproject_to_world(uv_last, depth_last, K, T_wl)
    nf = flow_meas.to(torch.float32)
    vf = valid.to(torch.float32)
    s_p, s_f = p.info_proj, p.info_flow
    dev = T_init.device
    batch = T_init.shape[:-2]
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    T, f = T_init, nf
    lam = torch.full(batch, p.lambda_init, dtype=torch.float32, device=dev)
    cost = _cost(T_init, nf, X_w, uv_last, nf, valid, K, p)
    stall = torch.zeros(batch, dtype=torch.int32, device=dev)
    for _ in range(p.iters):
        active = stall < 2
        r_p, r_f, Y = _residuals(T, f, X_w, uv_last, nf, K)
        chi2_p = s_p * torch.sum(r_p * r_p, dim=-1)
        w = _huber_weight(chi2_p, p.rp_thres) * vf
        Jxi = -(_proj_jacobian(Y, K) @ _pose_point_jacobian(Y))  # (..., N, 2, 6)
        spw = s_p * w
        a = spw + s_f * vf + lam[..., None]
        gamma = spw * (1.0 - spw / a)
        H = (_normal_sum("...n,...nij,...nik->...jk", gamma, Jxi, Jxi)
             + lam[..., None, None] * eye6)
        b_f = -(spw[..., None] * r_p + (s_f * vf)[..., None] * r_f)
        b_xi = -_normal_sum("...n,...nij,...ni->...j", spw, Jxi, r_p)
        g = b_xi - _normal_sum("...n,...nij,...ni->...j", spw / a, Jxi, b_f)
        # Jacobi-scaled solve for fp32 conditioning
        d = torch.sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1),
                                   min=1e-12))
        Hs = H / d[..., :, None] / d[..., None, :]
        dxi = torch.linalg.solve_ex(Hs + 1e-7 * eye6,
                                    (g / d)[..., None])[0][..., 0] / d
        df = (b_f - spw[..., None] * torch.einsum("...nij,...j->...ni", Jxi,
                                                  dxi)) / a[..., None]
        T_new = se3.retract(T, dxi)
        f_new = f + df
        new_cost = _cost(T_new, f_new, X_w, uv_last, nf, valid, K, p)
        accept = active & (new_cost < cost)
        rel_gain = (cost - new_cost) / torch.clamp(cost, min=1e-20)
        small = accept & (rel_gain < p.gain_eps)
        stall = torch.where(small, stall + 1, torch.where(accept, 0, stall))
        T = torch.where(accept[..., None, None], T_new, T)
        f = torch.where(accept[..., None, None], f_new, f)
        lam = torch.where(active, torch.where(accept, lam * p.lambda_down,
                                              lam * p.lambda_up), lam)
        lam = torch.clamp(lam, 1e-9, 1e6)
        cost = torch.where(accept, new_cost, cost)

    # outlier classification on the unrobustified chi2 (Optimizer.cc:2484-2506)
    r_p, _, _ = _residuals(T, f, X_w, uv_last, nf, K)
    chi2 = s_p * torch.sum(r_p * r_p, dim=-1)
    inlier = valid & (chi2 <= p.rp_thres)
    n_inlier = inlier.sum(dim=-1)
    # too few correspondences: keep the init (the reference returns early)
    enough = valid.sum(dim=-1) >= p.min_corres
    T = torch.where(enough[..., None, None], T, T_init)
    repro = (torch.sum(torch.where(inlier, torch.sqrt(chi2), 0.0), dim=-1)
             / torch.clamp(n_inlier, min=1))
    return {"T": T, "flow": f, "inlier": inlier, "chi2": chi2,
            "n_inlier": n_inlier, "repro_err": repro}
