"""The yardstick's arithmetic: the table of peaks, the FAST kernel's bytes,
and the reductions the per-layer readers share."""

from __future__ import annotations

import numpy as np

# NVIDIA's data sheet, H100 SXM, at its full 700 W power limit
H100_HBM_BYTES_PER_S = 3.35e12

# csrc/fast_score.cu reads each pixel's float32 once and writes two float32
# scores (the two thresholds' maps): 12 bytes per pixel of the pyramid
FAST_BYTES_PER_PX = 12


def pyramid_px(height: int, width: int, n_levels: int,
               scale_factor: float) -> int:
    """Pixels of an ORB pyramid: level l is round(size / scale^l), at
    least 16 (ops/fast.py:level_shapes of the port)."""
    inv = 1.0 / scale_factor
    px = height * width
    for l in range(1, n_levels):
        px += (max(int(round(height * inv ** l)), 16)
               * max(int(round(width * inv ** l)), 16))
    return px


def fast_pyramid_bytes(px: int) -> int:
    return FAST_BYTES_PER_PX * px


def mean_or_none(xs):
    return float(np.mean(xs)) if len(xs) else None


def idle_pct(trace):
    """100 x the share of a trace's window with no device operation."""
    if trace is None or trace.window_s <= 0:
        return None
    busy = trace.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / trace.window_s)
