"""Radial/tangential keypoint undistortion — port of
vdo_slam_tpu/ops/undistort.py.

Iterative inversion of the Brown-Conrady model (k1, k2, p1, p2[, k3]) with
re-projection through K, the cv::undistortPoints of Frame::UndistortKeyPoints
and ComputeImageBounds (Frame.cc:381-441).  The order of operations is the
JAX package's.  The intrinsics are divided out as elements of the K
tensor: on a CUDA device a tensor divided by a Python float is a multiply
by its reciprocal, one rounding more than the JAX division.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def distort_normalized(xy: Tensor, dist: Tensor) -> Tensor:
    """Apply the Brown-Conrady model to normalized coords (..., 2)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def _normalize(uv: Tensor, K: Tensor) -> Tensor:
    return torch.stack([(uv[..., 0] - K[2]) / K[0],
                        (uv[..., 1] - K[3]) / K[1]], dim=-1)


def _to_pixels(xn: Tensor, K: Tensor) -> Tensor:
    return torch.stack([xn[..., 0] * K[0] + K[2],
                        xn[..., 1] * K[1] + K[3]], dim=-1)


def distort_points(uv: Tensor, K: Tensor, dist: Tensor) -> Tensor:
    """Forward distortion of PINHOLE pixel coords (..., 2), the exact
    inverse direction of undistort_points: pinhole-space keypoints back to
    raw image coordinates for gathers into the raw depth/flow/mask maps."""
    return _to_pixels(distort_normalized(_normalize(uv, K), dist), K)


def undistort_points(uv: Tensor, K: Tensor, dist: Tensor,
                     iters: int = 8) -> Tensor:
    """Undistort pixel coords (..., 2) by `iters` fixed-point iterations,
    then re-project through K (cv::undistortPoints(..., P=K))."""
    xd = _normalize(uv, K)
    xu = xd
    for _ in range(iters):
        xu = xd - (distort_normalized(xu, dist) - xu)
    return _to_pixels(xu, K)


def undistorted_image_bounds(width: int, height: int, K: Tensor,
                             dist: Tensor):
    """Min/max bounds of the undistorted image corners
    (Frame::ComputeImageBounds, Frame.cc:413-441)."""
    corners = torch.tensor(
        [[0.0, 0.0], [width, 0.0], [0.0, height], [width, height]],
        dtype=torch.float32, device=K.device)
    und = undistort_points(corners, K, dist)
    return (torch.minimum(und[0, 0], und[2, 0]),
            torch.maximum(und[1, 0], und[3, 0]),
            torch.minimum(und[0, 1], und[1, 1]),
            torch.maximum(und[2, 1], und[3, 1]))
