"""SE(3) algebra on batched 4x4 float32 matrices — port of
vdo_slam_tpu/geometry/se3.py.

Same formulas, same 1e-4 Taylor windows and the same double-where guards
(the untaken branch gets a safe denominator, so no NaN is ever formed).
All functions broadcast over leading batch dimensions.  Tangent
convention: xi = (omega, upsilon), rotation first (g2o SE3Quat::exp).
"""

from __future__ import annotations

import functools

import torch

Tensor = torch.Tensor


def hat(omega: Tensor) -> Tensor:
    """Skew-symmetric matrix [omega]_x of (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W: Tensor) -> Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye3(like: Tensor, batch_shape) -> Tensor:
    eye = torch.eye(3, dtype=like.dtype, device=like.device)
    return eye.expand(tuple(batch_shape) + (3, 3))


def _sinc_coeffs(theta2: Tensor):
    """(A, B, C) = (sin t / t, (1 - cos t)/t^2, (1 - A)/t^2), with Taylor
    branches below theta^2 = 1e-4 (fp32 cancels well above 1e-8) and the
    half-angle identity 1 - cos t = 2 sin^2(t/2)."""
    small = theta2 < 1e-4
    t2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2_safe)
    half_sin = torch.sin(0.5 * theta)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    2.0 * half_sin * half_sin / t2_safe)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / t2_safe)
    return A, B, C


def so3_exp(omega: Tensor) -> Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(omega * omega, dim=-1)
    A, B, _ = _sinc_coeffs(theta2)
    W = hat(omega)
    W2 = W @ W
    eye = _eye3(omega, W.shape[:-2])
    return eye + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R: Tensor) -> Tensor:
    """Log map of (..., 3, 3) rotations -> (..., 3) axis-angle, through the
    skew part (= 2 sin(theta) axis) with a Taylor scale near identity."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_raw = (trace - 1.0) * 0.5
    skew = vee(R - R.transpose(-1, -2))
    s2 = torch.sum(skew * skew, dim=-1)
    small = cos_raw > 1.0 - 1e-4
    cos_t = torch.clamp(torch.where(small, torch.full_like(cos_raw, 0.5),
                                    cos_raw), -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    sin_t = torch.sin(theta)
    t2 = s2 * 0.25
    taylor = 0.5 + t2 / 12.0 + 7.0 * t2 * t2 / 720.0
    scale = torch.where(small, taylor, theta / (2.0 * sin_t))
    return skew * scale[..., None]


def exp(xi: Tensor) -> Tensor:
    """se(3) exp: (..., 6) tangent (omega, upsilon) -> (..., 4, 4)."""
    omega, ups = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(omega * omega, dim=-1)
    A, B, C = _sinc_coeffs(theta2)
    W = hat(omega)
    W2 = W @ W
    eye = _eye3(xi, W.shape[:-2])
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    t = torch.einsum("...ij,...j->...i", V, ups)
    return from_Rt(R, t)


def log(T: Tensor) -> Tensor:
    """se(3) log: (..., 4, 4) -> (..., 6) tangent (omega, upsilon)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    omega = so3_log(R)
    theta2 = torch.sum(omega * omega, dim=-1)
    A, B, _ = _sinc_coeffs(theta2)
    W = hat(omega)
    W2 = W @ W
    small = theta2 < 1e-4
    t2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - A / (2.0 * B)) / t2_safe)
    eye = _eye3(T, W.shape[:-2])
    Vinv = eye - 0.5 * W + coef[..., None, None] * W2
    ups = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([omega, ups], dim=-1)


def from_Rt(R: Tensor, t: Tensor) -> Tensor:
    """Assemble (..., 4, 4) from (..., 3, 3) and (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = _bottom_row(R.dtype, R.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


@functools.lru_cache(maxsize=None)
def _bottom_row(dtype, device) -> Tensor:
    """[0, 0, 0, 1], made once per device: a tensor built from a list is a
    host-to-device copy, which waits for the stream on every call."""
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def inv(T: Tensor) -> Tensor:
    """Analytic SE(3) inverse [R^T, -R^T t] (reference Converter.cc:151-166)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return from_Rt(Rt, -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3]))


def apply(T: Tensor, X: Tensor) -> Tensor:
    """Apply (..., 4, 4) transform to (..., 3) points."""
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], X) + T[..., :3, 3]


def compose(*Ts: Tensor) -> Tensor:
    """Chain matrix products T1 @ T2 @ ... (broadcasting over batches)."""
    out = Ts[0]
    for T in Ts[1:]:
        out = out @ T
    return out


def retract(T: Tensor, xi: Tensor) -> Tensor:
    """Left-multiplicative update exp(xi) @ T (g2o VertexSE3Expmap oplus)."""
    return exp(xi) @ T


def orthonormalize(T: Tensor) -> Tensor:
    """Gram-Schmidt the rotation rows back onto SO(3) (fp32 drift control
    on long composed pose chains)."""
    R = T[..., :3, :3]
    r0 = R[..., 0, :]
    r0 = r0 / (torch.linalg.vector_norm(r0, dim=-1, keepdim=True) + 1e-12)
    r1 = R[..., 1, :]
    r1 = r1 - torch.sum(r1 * r0, dim=-1, keepdim=True) * r0
    r1 = r1 / (torch.linalg.vector_norm(r1, dim=-1, keepdim=True) + 1e-12)
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    return from_Rt(torch.stack([r0, r1, r2], dim=-2), T[..., :3, 3])
