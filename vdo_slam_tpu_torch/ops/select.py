"""Fixed-shape selection primitives — port of vdo_slam_tpu/ops/select.py.

Tie-breaking is the reference's: equal keys keep their index order.
`torch.topk` promises no tie order, so every top-k here is a stable
descending sort followed by a slice; `jnp.lexsort` becomes two stable
sorts (minor key first); `lax.associative_scan(max)` becomes `cummax`;
JAX's `.at[].set(mode="drop")` becomes a scatter into a k+1 buffer whose
last slot takes the dropped lanes.  Indices are int64.  Scatters are
out-of-place (`scatter`, not indexed assignment), so every function here
also runs under `torch.func.vmap`, which the S-stream step uses.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

_F32_MIN = torch.finfo(torch.float32).min


def stable_desc_order(x: Tensor, dim: int = -1) -> Tensor:
    """Indices sorting x descending along dim; ties keep index order (the
    order jax.lax.top_k returns)."""
    return torch.sort(x, dim=dim, descending=True, stable=True).indices


def masked_top_k(score: Tensor, valid: Tensor, k: int):
    """Indices of the k highest-scoring valid entries along the last axis.

    Returns (idx (..., k) int64, out_valid (..., k) bool); ties go to the
    lowest index.  Batched over leading dimensions.
    """
    n = score.shape[-1]
    masked = torch.where(valid, score.to(torch.float32),
                         torch.full_like(score, _F32_MIN, dtype=torch.float32))
    idx = stable_desc_order(masked)[..., :k]
    out_valid = torch.gather(valid, -1, idx)
    if n < k:  # more slots requested than candidates: pad
        pad = idx.new_zeros(idx.shape[:-1] + (k - n,))
        idx = torch.cat([idx, pad], dim=-1)
        out_valid = torch.cat([out_valid, torch.zeros_like(pad, dtype=torch.bool)],
                              dim=-1)
    return idx, out_valid


def compact(valid: Tensor):
    """Stable permutation moving valid entries (last axis) to the front.
    Returns (perm int64, n_valid int64)."""
    order = torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices
    return order, valid.sum(dim=-1)


def per_label_rank(labels: Tensor, valid: Tensor) -> Tensor:
    """Rank of each entry among the valid entries of its label, in index
    order; invalid entries get rank N (never selected)."""
    n = labels.shape[0]
    dev = labels.device
    key = torch.where(valid, labels.to(torch.int64),
                      torch.full_like(labels, 2**30, dtype=torch.int64))
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    idx = torch.arange(n, device=dev)
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      sk[1:] == sk[:-1]])
    run_start = torch.cummax(torch.where(same, 0, idx), dim=0).values
    rank = torch.zeros(n, dtype=torch.int64, device=dev).scatter(
        0, order, idx - run_start)
    return torch.where(valid, rank, n)


def quota_select(labels: Tensor, valid: Tensor, priority: Tensor,
                 quota: int, k: int):
    """Up to `quota` entries per label (highest priority first), then the
    first k accepted entries in index order.  Returns (idx (k,), valid (k,)).
    Replaces the per-object top-up loops (Tracking.cc:2838-2896)."""
    n = labels.shape[0]
    dev = labels.device
    lab_key = torch.where(valid, labels.to(torch.int64),
                          torch.full_like(labels, 2**30, dtype=torch.int64))
    # lexsort((-priority, lab_key)): primary lab_key, secondary -priority
    order = torch.sort(-priority, stable=True).indices
    order = order[torch.sort(lab_key[order], stable=True).indices]
    sl = lab_key[order]
    sv = valid[order]
    idx_ar = torch.arange(n, device=dev)
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      sl[1:] == sl[:-1]])
    run_start = torch.cummax(torch.where(same, 0, idx_ar), dim=0).values
    accept_sorted = sv & ((idx_ar - run_start) < quota)
    accept = torch.zeros(n, dtype=torch.bool, device=dev).scatter(
        0, order, accept_sorted)
    pos = torch.cumsum(accept.to(torch.int64), dim=0) - 1
    target = torch.where(accept & (pos < k), pos, k)
    idx = torch.zeros(k + 1, dtype=torch.int64, device=dev).scatter(
        0, target, idx_ar)
    out_valid = torch.zeros(k + 1, dtype=torch.bool, device=dev).scatter(
        0, target, torch.ones(n, dtype=torch.bool, device=dev))
    return idx[:k], out_valid[:k]


def gather_rows(arr: Tensor, idx: Tensor, valid: Tensor, fill=0) -> Tensor:
    """arr[idx] along axis 0 with invalid slots replaced by `fill`."""
    out = arr[idx]
    shape = valid.shape + (1,) * (out.ndim - valid.ndim)
    return torch.where(valid.reshape(shape), out, fill)


def min_dist_to_set(points: Tensor, ref_points: Tensor,
                    ref_valid: Tensor) -> Tensor:
    """Min Euclidean distance from each point (N, 2) to the valid rows of
    ref_points (M, 2) (Tracking.cc:2730-2744, 2856-2868).  Returns (N,)."""
    d2 = torch.sum((points[:, None, :] - ref_points[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(ref_valid[None, :], d2,
                     torch.full_like(d2, float("inf")))
    return torch.sqrt(torch.amin(d2, dim=-1))
