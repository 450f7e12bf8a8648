"""Image-plane tensor ops — port of vdo_slam_tpu/ops/image.py
(preprocess_depth, gather_int, gather_bilinear, rgb_to_gray)."""

from __future__ import annotations

import torch

from ..config import KITTI, OMD, VIRTUAL_KITTI

Tensor = torch.Tensor


def preprocess_depth(depth_raw: Tensor, dataset: int, bf: float,
                     depth_map_factor: float) -> Tensor:
    """Disparity/scaled-depth -> metric depth, negatives zeroed
    (Tracking.cc:188-201)."""
    raw = torch.clamp(depth_raw, min=0.0)
    zero = torch.zeros_like(raw)
    if dataset in (OMD, KITTI):
        denom = raw / depth_map_factor
        # full_like: `scalar / tensor` is reciprocal-then-multiply in torch,
        # one rounding more than the JAX division
        depth = torch.where(denom > 0, torch.full_like(denom, bf)
                            / torch.clamp(denom, min=1e-9), zero)
    elif dataset == VIRTUAL_KITTI:
        depth = raw / depth_map_factor
    else:
        depth = raw
    return torch.where(depth_raw < 0, zero, depth).to(torch.float32)


def gather_int(img: Tensor, uv: Tensor, fill=0.0) -> Tensor:
    """img[(int)v, (int)u] with out-of-bounds -> fill (the reference's
    int-truncation lookups).  img: (H, W) or (H, W, C); uv: (..., 2)."""
    H, W = img.shape[0], img.shape[1]
    u = uv[..., 0].to(torch.int64)
    v = uv[..., 1].to(torch.int64)
    inb = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    vals = img[v.clamp(0, H - 1), u.clamp(0, W - 1)]
    # a Python scalar fill: a tensor made from it would be a host-to-device
    # copy, which waits for the stream
    if img.ndim == 3:
        return torch.where(inb[..., None], vals, fill)
    return torch.where(inb, vals, fill)


def gather_bilinear(img: Tensor, uv: Tensor, fill=0.0) -> Tensor:
    """Bilinear sampling of (H, W) or (H, W, C) at float uv (..., 2);
    out-of-bounds neighbours read `fill`."""
    H, W = img.shape[0], img.shape[1]
    u, v = uv[..., 0], uv[..., 1]
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0
    if img.ndim == 3:
        du, dv = du[..., None], dv[..., None]

    def at(vi, ui):
        inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        vals = img[vi.clamp(0, H - 1).to(torch.int64),
                   ui.clamp(0, W - 1).to(torch.int64)]
        return torch.where(inb[..., None] if img.ndim == 3 else inb, vals,
                           fill)

    top = at(v0, u0) * (1 - du) + at(v0, u0 + 1) * du
    bot = at(v0 + 1, u0) * (1 - du) + at(v0 + 1, u0 + 1) * du
    return top * (1 - dv) + bot * dv


def rgb_to_gray(img: Tensor) -> Tensor:
    """(H, W, 3) float in [0, 1] -> (H, W) grayscale (ITU-R 601)."""
    if img.ndim == 2:
        return img
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype, device=img.device)
    return img[..., :3] @ w
