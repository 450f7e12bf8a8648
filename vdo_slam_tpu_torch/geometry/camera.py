"""Pinhole projection / unprojection — port of
vdo_slam_tpu/geometry/camera.py.

Intrinsics are a (4,) tensor (fx, fy, cx, cy); every op broadcasts over
leading batch dimensions.
"""

from __future__ import annotations

import torch

from . import se3

Tensor = torch.Tensor


def intrinsics(fx: float, fy: float, cx: float, cy: float,
               device="cpu") -> Tensor:
    return torch.tensor([fx, fy, cx, cy], dtype=torch.float32, device=device)


def unproject(uv: Tensor, z: Tensor, K: Tensor) -> Tensor:
    """Back-project pixels (..., 2) with depth (...,) to camera frame
    (..., 3): x = (u - cx) z / fx, y = (v - cy) z / fy (Frame.cc:475-477)."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    x = (uv[..., 0] - cx) * z / fx
    y = (uv[..., 1] - cy) * z / fy
    return torch.stack([x, y, z], dim=-1)


def project(X_cam: Tensor, K: Tensor, eps: float = 1e-6) -> Tensor:
    """Project camera-frame points (..., 3) to pixels (..., 2)."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    z = X_cam[..., 2]
    safe = torch.where(torch.abs(z) < eps,
                       torch.where(z < 0, -eps, eps).to(z.dtype), z)
    inv_z = 1.0 / safe
    u = fx * X_cam[..., 0] * inv_z + cx
    v = fy * X_cam[..., 1] * inv_z + cy
    return torch.stack([u, v], dim=-1)


def unproject_to_world(uv: Tensor, z: Tensor, K: Tensor,
                       T_wc: Tensor) -> Tensor:
    """Pixel + depth -> world point through camera->world pose T_wc."""
    return se3.apply(T_wc, unproject(uv, z, K))


def project_from_world(X_w: Tensor, K: Tensor, T_cw: Tensor) -> Tensor:
    """World point -> pixel through world->camera pose T_cw."""
    return project(se3.apply(T_cw, X_w), K)


def in_bounds(uv: Tensor, width: int, height: int,
              margin: float = 0.0) -> Tensor:
    """Strict boundary predicate (Frame.cc:121,159,214; Tracking.cc:277)."""
    u, v = uv[..., 0], uv[..., 1]
    return ((u > margin) & (u < width - 1 - margin)
            & (v > margin) & (v < height - 1 - margin))
