"""Error metrics — port of vdo_slam_tpu/geometry/metrics.py.

The rotation angle is the skew-norm atan2 form of the reference's
clamped-trace angle (Tracking.cc:3268-3276): identical on exact rotations,
but linear rather than quadratic in fp32 input rounding.
"""

from __future__ import annotations

import torch

from . import se3

Tensor = torch.Tensor

_RAD2DEG = 180.0 / 3.1415926  # the reference's literal, not numpy pi


def clamped_trace_angle_deg(T: Tensor) -> Tensor:
    """Rotation magnitude of (..., 4, 4) in degrees."""
    s_vec = torch.stack([
        T[..., 2, 1] - T[..., 1, 2],
        T[..., 0, 2] - T[..., 2, 0],
        T[..., 1, 0] - T[..., 0, 1],
    ], dim=-1)
    sin_t = 0.5 * torch.linalg.vector_norm(s_vec, dim=-1)
    diag = torch.stack([T[..., 0, 0], T[..., 1, 1], T[..., 2, 2]], dim=-1)
    clamped = torch.where(diag > 1.0, 2.0 - diag, diag)
    trace = torch.sum(clamped, dim=-1)
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    return torch.atan2(sin_t, cos_t) * _RAD2DEG


def translation_norm(T: Tensor) -> Tensor:
    return torch.linalg.vector_norm(T[..., :3, 3], dim=-1)


def camera_rpe(T_cw_cur, T_cw_last, T_cw_gt_cur, T_cw_gt_last):
    """Per-frame camera relative pose error (Tracking.cc:715-736):
    err = (Tcw_cur Twc_last)(Tcw_gt_last Twc_gt_cur).  Returns (t, r_deg)."""
    err = (T_cw_cur @ se3.inv(T_cw_last)) @ (T_cw_gt_last @ se3.inv(T_cw_gt_cur))
    return translation_norm(err), clamped_trace_angle_deg(err)


def object_speed(H: Tensor, centroid_prev: Tensor) -> Tensor:
    """||t_H - (I - R_H) c|| * 36 in km/h (Tracking.cc:952-964)."""
    R = H[..., :3, :3]
    t = H[..., :3, 3]
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    v = t - torch.einsum("...ij,...j->...i", eye - R, centroid_prev)
    return torch.linalg.vector_norm(v, dim=-1) * 36.0
