"""FAST-9/16 corners over an image pyramid — port of
vdo_slam_tpu/ops/fast.py.

`fast_score` is the plain PyTorch version of the corner score (16 rolled
views and the unrolled 9-arc reductions, as in the JAX package).  It is the
reference the CUDA kernel (ops/fast_cuda.py) is held to bit for bit, and
what the kernel's wrapper runs for a tensor on the CPU.  `score_pyramid`
scores all levels through that wrapper at once, so on a CUDA device a
frame's pyramid is one kernel launch; given (S, H, W) gray it scores the
pyramids of S frames in that one launch.  `select_pyramid` turns one
frame's score maps into keypoints and can run under `torch.func.vmap`;
`detect_pyramid` is the two in a row.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import select as _select
from .fast_cuda import fast_score_pair, fast_score_pyramid

Tensor = torch.Tensor

# FAST circle of radius 3 (dx, dy), clockwise from 12 o'clock (fast.py:32-35).
_CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
_ARC = 9  # FAST-9


def border_mask(H: int, W: int, device=None) -> Tensor:
    """True on the 3 px border, where the circle is incomplete."""
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys < 3) | (ys >= H - 3) | (xs < 3) | (xs >= W - 3)


def fast_score(gray: Tensor, threshold: float) -> Tensor:
    """FAST-9/16 corner score map of (..., H, W); 0 where the test fails.

    Score = max over qualifying 9-arcs of (min |circle - centre| over the
    arc).  The threshold is compared as float32, as the JAX package does:
    torch casts a Python scalar to the tensor's dtype for a compare.
    """
    d = torch.stack([torch.roll(gray, shifts=(-dy, -dx), dims=(-2, -1)) - gray
                     for dx, dy in _CIRCLE])          # (16, ..., H, W)
    bright = d > threshold
    dark = d < -threshold

    def arc_reduce(mask, mag):
        best = torch.zeros_like(gray)
        for s in range(16):
            ok = mask[s]
            mn = mag[s]
            for j in range(1, _ARC):
                i = (s + j) % 16
                ok = ok & mask[i]
                mn = torch.minimum(mn, mag[i])
            best = torch.maximum(best, torch.where(ok, mn, 0.0))
        return best

    score = torch.maximum(arc_reduce(bright, d), arc_reduce(dark, -d))
    H, W = gray.shape[-2:]
    return torch.where(border_mask(H, W, gray.device), 0.0, score)


def nms3(score: Tensor) -> Tensor:
    """3x3 non-maximum suppression of one (H, W) map (keep local maxima
    > 0)."""
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where((score == m) & (score > 0.0), score, 0.0)


def _cell_max(score: Tensor, cell: int) -> Tensor:
    """Per-cell max of one (H, W) map, broadcast back to pixels
    (non-overlapping cells)."""
    H, W = score.shape
    padded = F.pad(score, (0, (-W) % cell, 0, (-H) % cell), value=0.0)
    Hc, Wc = padded.shape
    cmax = padded.reshape(Hc // cell, cell, Wc // cell, cell).amax(dim=(1, 3))
    back = cmax[:, None, :, None].expand(Hc // cell, cell, Wc // cell, cell)
    return back.reshape(Hc, Wc)[:H, :W]


def detect_level(gray: Tensor, ini_th: float, min_th: float, cell: int,
                 k: int):
    """Detect up to k corners at one pyramid level.  Returns (xy (k, 2)
    f32, score (k,), valid (k,))."""
    return select_corners(*fast_score_pair(gray, ini_th, min_th), cell, k)


def select_corners(s_ini: Tensor, s_min: Tensor, cell: int, k: int):
    """Up to k corners of one level from its two score maps.

    Inside each cell the ini-threshold response is used if the cell fired
    at all, else the min-threshold one (ORBextractor.cc:789-822).  Returns
    (xy (k, 2) f32, score (k,), valid (k,)).
    """
    has_ini = _cell_max(s_ini, cell) > 0.0
    score = nms3(torch.where(has_ini, s_ini, s_min))

    H, W = score.shape
    ph, pw = (-H) % cell, (-W) % cell
    padded = F.pad(score, (0, pw, 0, ph), value=0.0)
    Hc, Wc = (H + ph) // cell, (W + pw) // cell
    n_cells = Hc * Wc
    quota = max(-(-k // n_cells), 1)
    cells = padded.reshape(Hc, cell, Wc, cell).permute(0, 2, 1, 3)
    cells = cells.reshape(n_cells, cell * cell)
    # per-cell top quota; ties to the lowest in-cell index (lax.top_k order)
    top_i = _select.stable_desc_order(cells, dim=1)[:, :quota]
    top_v = torch.gather(cells, 1, top_i)
    cell_id = torch.arange(n_cells, device=score.device)
    cy = (cell_id // Wc)[:, None] * cell
    cx = (cell_id % Wc)[:, None] * cell
    yy = (cy + top_i // cell).reshape(-1).to(torch.float32)
    xx = (cx + top_i % cell).reshape(-1).to(torch.float32)
    vv = top_v.reshape(-1)
    idx, ok = _select.masked_top_k(vv, vv > 0.0, k)
    val = torch.where(ok, vv[idx], 0.0)
    return torch.stack([xx[idx], yy[idx]], dim=-1), val, ok


def level_shapes(H: int, W: int, n_levels: int, scale_factor: float):
    """(H_l, W_l) of every pyramid level (fast.py:181-185)."""
    inv = 1.0 / scale_factor
    return [(H, W)] + [(max(int(round(H * inv ** l)), 16),
                        max(int(round(W * inv ** l)), 16))
                       for l in range(1, n_levels)]


def pyramid(gray: Tensor, n_levels: int = 8,
            scale_factor: float = 1.2) -> list[Tensor]:
    """The detector's image pyramid of (H, W) or (S, H, W) gray; every
    level is contiguous.  Level l > 0 resizes level 0 directly, bilinear
    with antialiasing, as jax.image.resize does (fast.py:185).  Each level
    is within 2e-6 of the float64 product of that resize's weights;
    jax.image.resize on the CPU is up to ~3e-5 off it."""
    H, W = gray.shape[-2:]
    lead = gray.shape[:-2]
    out = [gray.contiguous()]
    for Hl, Wl in level_shapes(H, W, n_levels, scale_factor)[1:]:
        out.append(F.interpolate(gray.reshape(-1, 1, H, W), size=(Hl, Wl),
                                 mode="bilinear", align_corners=False,
                                 antialias=True).reshape(lead + (Hl, Wl)))
    return out


def level_budgets(n_features: int, n_levels: int, scale_factor: float):
    """Per-level feature budgets, n_l proportional to (1/scale)^l, summing
    to n_features exactly (ORBextractor ctor)."""
    inv = 1.0 / scale_factor
    raw_w = [inv ** l for l in range(n_levels)]
    total_w = sum(raw_w)
    budgets = [max(int(w / total_w * n_features), 8) for w in raw_w]
    budgets[0] += n_features - sum(budgets)
    return budgets


def score_pyramid(gray: Tensor, n_levels: int = 8,
                  scale_factor: float = 1.2, ini_th: float = 20.0,
                  min_th: float = 7.0):
    """The FAST score maps of every pyramid level of (H, W) or (S, H, W)
    gray in [0, 1], thresholds in 8-bit units: one (s_ini, s_min) pair per
    level, each of the level's shape.  One kernel launch on a CUDA device,
    whatever S."""
    t_scale = 1.0 / 255.0
    return fast_score_pyramid(pyramid(gray, n_levels, scale_factor),
                              ini_th * t_scale, min_th * t_scale)


def select_pyramid(scores, n_features: int = 2500,
                   scale_factor: float = 1.2, cell: int = 30):
    """One frame's keypoints from its per-level (s_ini, s_min) score maps,
    with per-level budgets.  Returns dict(xy (N, 2) level-0 coords, score,
    octave, valid)."""
    inv = 1.0 / scale_factor
    budgets = level_budgets(n_features, len(scores), scale_factor)
    xs, ss, os_, vs = [], [], [], []
    for l, (s_ini, s_min) in enumerate(scores):
        cell_l = max(int(cell * inv ** l), 8)
        xy, sc, va = select_corners(s_ini, s_min, cell_l, budgets[l])
        xs.append(xy * (scale_factor ** l))
        ss.append(sc)
        os_.append(torch.full((budgets[l],), l, dtype=torch.int32,
                              device=s_ini.device))
        vs.append(va)
    return {"xy": torch.cat(xs), "score": torch.cat(ss),
            "octave": torch.cat(os_), "valid": torch.cat(vs)}


def sample_cells(n: int, n_div: int) -> int:
    """Keypoints drawn per grid cell by grid_sample_keypoints."""
    return -(-n // (n_div * n_div))


def grid_sample_keypoints(offsets: Tensor, height: int, width: int,
                          n: int = 3000, n_div: int = 20):
    """Uniform-in-grid random keypoints — the UseSampleFeature path
    (Frame::SampleKeyPoints, Frame.cc:672-740; fast.py:203-220).
    `offsets` (2, n_div, n_div, per_cell): the x and y uniform [0, 1)
    draws, x on the first grid axis.  Returns ((n, 2) xy float32, valid)."""
    x_step = width // n_div
    y_step = height // n_div
    dev = offsets.device
    gx = torch.arange(n_div, device=dev) * x_step
    gy = torch.arange(n_div, device=dev) * y_step
    xs = (gx[:, None, None] + offsets[0] * x_step).reshape(-1)
    ys = (gy[None, :, None] + offsets[1] * y_step).reshape(-1)
    xy = torch.stack([xs, ys], dim=-1)[:n].to(torch.float32)
    valid = ((xy[:, 0] > 0) & (xy[:, 0] < width) & (xy[:, 1] > 0)
             & (xy[:, 1] < height))
    return xy, valid


def detect_pyramid(gray: Tensor, n_features: int = 2500, n_levels: int = 8,
                   scale_factor: float = 1.2, ini_th: float = 20.0,
                   min_th: float = 7.0, cell: int = 30):
    """Pyramid detection of one (H, W) frame with per-level budgets.
    Intensities in [0, 1]; thresholds in 8-bit units.  Returns dict(xy
    (N, 2) level-0 coords, score, octave, valid)."""
    scores = score_pyramid(gray, n_levels, scale_factor, ini_th, min_th)
    return select_pyramid(scores, n_features, scale_factor, cell)
