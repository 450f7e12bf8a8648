"""Feature grid for spatial queries — port of vdo_slam_tpu/ops/grid.py.

Rebuild of Frame's 48x64 keypoint grid (AssignFeaturesToGrid /
GetFeaturesInArea, Frame.cc:263-379) as fixed-shape tensors: the reference
uses it for radius matching; here, as in the original, the grid is a
padded (rows, cols, cap) index table plus a vectorized radius query for
descriptor matchers and users of the API.  Nothing on a path of either
package calls them.

Against the original: `jax.lax.associative_scan(jnp.maximum, ...)` is
`torch.cummax`, the sorts are stable where the original's are, the scatter
with mode="drop" writes its overflow into a spare row that is cut off, and
the division by the image size is elementwise (torch's tensor / scalar
may take a reciprocal first).  Every function runs on the device of its
inputs.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

GRID_ROWS = 48
GRID_COLS = 64


def _cell_index(v: Tensor, n: int, size: int) -> Tensor:
    """clip(int(v * n / size), 0, n - 1), with a true division."""
    q = (v * n) / torch.full_like(v, size)
    return torch.clamp(q.to(torch.int32), 0, n - 1)


def assign_to_grid(xy: Tensor, valid: Tensor, width: int, height: int,
                   cap: int = 16):
    """Bucket keypoints into the reference's 48x64 grid.

    Returns (table (GRID_ROWS, GRID_COLS, cap) int32 feature indices, -1
    padding, in index order within a cell; counts (GRID_ROWS, GRID_COLS)
    int32, which count past `cap`).
    """
    n_cells = GRID_ROWS * GRID_COLS
    gx = _cell_index(xy[:, 0], GRID_COLS, width)
    gy = _cell_index(xy[:, 1], GRID_ROWS, height)
    cell = torch.where(valid, gy * GRID_COLS + gx,
                       torch.full_like(gx, n_cells))
    order = torch.argsort(cell, stable=True)
    cell_sorted = cell[order]
    # rank within cell
    idx = torch.arange(cell.shape[0], dtype=torch.int32, device=xy.device)
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=xy.device),
                      cell_sorted[1:] == cell_sorted[:-1]])
    run_start = torch.cummax(torch.where(same, 0, idx), dim=0).values
    rank = idx - run_start
    slot = torch.where(
        rank < cap,
        torch.clamp(cell_sorted, max=n_cells) * cap
        + torch.clamp(rank, max=cap - 1),
        torch.full_like(rank, n_cells * cap))
    # the lanes past a cell's cap, and the invalid ones, land in the spare
    # row past the table, which is cut off
    flat = torch.full(((n_cells + 1) * cap,), -1, dtype=torch.int32,
                      device=xy.device)
    flat = flat.scatter(0, slot.to(torch.int64), order.to(torch.int32))
    table = flat[:n_cells * cap].reshape(GRID_ROWS, GRID_COLS, cap)
    counts = torch.zeros(n_cells + 1, dtype=torch.int32, device=xy.device)
    counts = counts.index_add(0, torch.clamp(cell, max=n_cells).to(
        torch.int64), valid.to(torch.int32))
    return table, counts[:-1].reshape(GRID_ROWS, GRID_COLS)


def features_in_area(xy: Tensor, valid: Tensor, center: Tensor,
                     radius: float, k: int = 64):
    """Indices of up to k valid features within an L_inf radius of `center`
    (GetFeaturesInArea semantics, Frame.cc:314-367: |dx|<r and |dy|<r),
    nearest first (squared distance; ties in index order).  Returns (idx
    (min(k, N),) int32, ok: which of them are within the radius)."""
    d = torch.abs(xy - center[None, :])
    ok = valid & (d[:, 0] < radius) & (d[:, 1] < radius)
    dist = torch.where(ok, torch.sum(d * d, dim=-1),
                       torch.full_like(d[:, 0], float("inf")))
    idx = torch.argsort(dist, stable=True)[:k]
    return idx.to(torch.int32), ok[idx]
