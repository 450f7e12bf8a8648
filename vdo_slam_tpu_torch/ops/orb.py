"""ORB orientation + binary descriptors (optional front-end extras) — port
of vdo_slam_tpu/ops/orb.py.

The reference's ORBextractor computes intensity-centroid orientations
(IC_Angle, ORBextractor.cc:66-93) and carries the rBRIEF machinery
(computeOrbDescriptor, 97-137) but ships with descriptors disabled
(ORBextractor.cc:1091): matching is optical-flow based.  Nothing on a path
of either package calls these; they exist for capability parity and for
descriptor-based matching extensions.

  * orientation: the intensity-centroid angle over a 31x31 patch with the
    circular row-extent mask (umax), for all keypoints at once by a gather
    and masked moments;
  * descriptor: 256 steered binary tests on a deterministic pseudo-random
    Gaussian pattern (numpy's default_rng(1234), the original's, not
    OpenCV's learned table), packed to (N, 32) uint8.

Every function runs on the device of its inputs.  The constants are this
module's own copies of the original's (the port imports nothing of the
JAX package), built with numpy as the original builds them.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

PATCH_R = 15  # half patch size (31x31), ORBextractor HALF_PATCH_SIZE


def _circle_umax(radius: int = PATCH_R) -> np.ndarray:
    """Row extents of the circular patch (ORBextractor ctor umax table)."""
    umax = np.zeros(radius + 1, np.int32)
    for v in range(radius + 1):
        umax[v] = int(np.floor(np.sqrt(radius * radius - v * v) + 0.5))
    return umax


_UMAX = _circle_umax()


def _patch_mask() -> np.ndarray:
    ys, xs = np.meshgrid(np.arange(-PATCH_R, PATCH_R + 1),
                         np.arange(-PATCH_R, PATCH_R + 1), indexing="ij")
    m = np.abs(xs) <= _UMAX[np.minimum(np.abs(ys), PATCH_R)]
    return m.astype(np.float32)


_MASK = _patch_mask()
_DY, _DX = np.meshgrid(np.arange(-PATCH_R, PATCH_R + 1),
                       np.arange(-PATCH_R, PATCH_R + 1), indexing="ij")


def _brief_pattern(seed: int = 1234, n_bits: int = 256) -> np.ndarray:
    """Deterministic Gaussian test pattern (n_bits, 4) = (x1, y1, x2, y2),
    clipped to the patch."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH_R / 2.5, size=(n_bits, 4))
    return np.clip(np.round(pts), -PATCH_R + 1, PATCH_R - 1).astype(np.float32)


_PATTERN = _brief_pattern()
_POPCOUNT = np.asarray([bin(i).count("1") for i in range(256)], np.int32)


def _const(a: np.ndarray, like: Tensor) -> Tensor:
    return torch.from_numpy(a).to(like.device)


def _gather_patches(gray: Tensor, xy: Tensor) -> Tensor:
    """(N, 31, 31) intensity patches at the keypoints' integer locations
    (truncated toward zero, then clamped to the image)."""
    H, W = gray.shape
    cx = xy[:, 0].to(torch.int64)[:, None, None]
    cy = xy[:, 1].to(torch.int64)[:, None, None]
    px = torch.clamp(cx + _const(_DX, xy)[None], 0, W - 1)
    py = torch.clamp(cy + _const(_DY, xy)[None], 0, H - 1)
    return gray[py, px]


def orientations(gray: Tensor, xy: Tensor) -> Tensor:
    """Intensity-centroid angle (radians) per keypoint — IC_Angle
    vectorized: m01 = sum y*I, m10 = sum x*I over the circular patch.
    gray (H, W) float32, xy (N, 2) pixel (x, y); returns (N,)."""
    patches = _gather_patches(gray, xy) * _const(_MASK, gray)[None]
    m10 = torch.sum(patches * _const(_DX.astype(np.float32), gray)[None],
                    dim=(1, 2))
    m01 = torch.sum(patches * _const(_DY.astype(np.float32), gray)[None],
                    dim=(1, 2))
    return torch.atan2(m01, m10)


def descriptors(gray: Tensor, xy: Tensor,
                angle: Tensor | None = None) -> Tensor:
    """256-bit steered binary descriptors, packed to (N, 32) uint8 (bit j
    of byte i is test 8 i + j).

    The tests are rotated by each keypoint's orientation (rBRIEF steering,
    computeOrbDescriptor's a=cos, b=sin rotation of the pattern); `angle`
    defaults to orientations(gray, xy).
    """
    H, W = gray.shape
    if angle is None:
        angle = orientations(gray, xy)
    ca, sa = torch.cos(angle), torch.sin(angle)  # (N,)
    p = _const(_PATTERN, gray)                   # (256, 4)

    def rot(px, py):
        # (N, 256) rotated offsets
        rx = ca[:, None] * px[None] - sa[:, None] * py[None]
        ry = sa[:, None] * px[None] + ca[:, None] * py[None]
        return rx, ry

    x1, y1 = rot(p[:, 0], p[:, 1])
    x2, y2 = rot(p[:, 2], p[:, 3])

    def sample(dx, dy):
        gx = torch.clamp((xy[:, 0:1] + dx).to(torch.int64), 0, W - 1)
        gy = torch.clamp((xy[:, 1:2] + dy).to(torch.int64), 0, H - 1)
        return gray[gy, gx]

    bits = (sample(x1, y1) < sample(x2, y2)).to(torch.int32)  # (N, 256)
    weights = 2 ** torch.arange(8, dtype=torch.int32, device=gray.device)
    return torch.sum(bits.reshape(-1, 32, 8) * weights, dim=-1).to(
        torch.uint8)


def match_hamming(desc_a: Tensor, desc_b: Tensor, valid_a: Tensor,
                  valid_b: Tensor, k: int = 1):
    """Brute-force Hamming matching: for each descriptor of a, the index
    of the nearest valid descriptor of b (the first on ties) and its
    distance; 10**6 where a is invalid or b has no valid entry.
    Returns (best (N_a,) int32, distance (N_a,) int32)."""
    lut = _const(_POPCOUNT, desc_a)
    diff = torch.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    dist = torch.sum(lut[diff.to(torch.int64)], dim=-1, dtype=torch.int32)
    big = torch.full_like(dist, 10 ** 6)
    dist = torch.where(valid_b[None, :], dist, big)
    best = torch.argmin(dist, dim=-1)
    bd = torch.gather(dist, 1, best[:, None])[:, 0]
    return (best.to(torch.int32),
            torch.where(valid_a, bd, torch.full_like(bd, 10 ** 6)))
