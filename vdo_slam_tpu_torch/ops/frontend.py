"""Front-end feature construction as fixed-shape tensor ops — port of
vdo_slam_tpu/ops/frontend.py.

The random priority of `object_candidates` (frontend.py:85) is an input
here, so tests can feed the JAX package's own draws.  Segment sums are
`scatter_add` into an overflow bucket that is sliced off; like every
scatter here it is out-of-place, so the functions also run under
`torch.func.vmap` (the S-stream step).  The lost-mask
repair of `propagate_mask` runs unconditionally and is selected with
`torch.where` (the JAX `lax.cond`), so the step never reads the device.
"""

from __future__ import annotations

import torch

from ..geometry import camera as cam
from ..geometry import se3
from . import select
from .image import gather_int

Tensor = torch.Tensor


def static_candidates(xy, xy_valid, score, depth_img, flow_img, mask_img,
                      th_depth: float, k: int):
    """Detected keypoints filtered into the static background set
    (Frame.cc:100-168).  Returns dict(xy, depth, flow, corres, valid)."""
    H, W = depth_img.shape
    d = gather_int(depth_img, xy)
    m = gather_int(mask_img, xy)
    f = gather_int(flow_img, xy)
    corres = xy + f
    ok = (xy_valid & (m == 0) & (d > 0) & (d <= th_depth)
          & (f[..., 0] != 0) & (f[..., 1] != 0)
          & cam.in_bounds(corres, W, H) & cam.in_bounds(xy, W, H))
    idx, valid = select.masked_top_k(score, ok, k)
    return {
        "xy": select.gather_rows(xy, idx, valid),
        "depth": torch.where(valid, d[idx], -1.0),
        "flow": select.gather_rows(f, idx, valid),
        "corres": select.gather_rows(corres, idx, valid),
        "valid": valid,
    }


def _grid_axis(n: int, step: int) -> range:
    return range(0, n - (n % step) if n % step else n, step)


def object_grid_size(H: int, W: int, step: int) -> int:
    """Number of object sample sites, one priority draw each."""
    return len(_grid_axis(H, step)) * len(_grid_axis(W, step))


def object_grid(H: int, W: int, step: int, device=None) -> Tensor:
    """Every `step`-th pixel (x, y), row-major — the object sample sites."""
    ry, rx = _grid_axis(H, step), _grid_axis(W, step)
    ys = torch.arange(ry.start, ry.stop, ry.step, device=device)
    xs = torch.arange(rx.start, rx.stop, rx.step, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1).to(torch.float32)


def object_candidates(depth_img, flow_img, mask_img, th_depth_obj: float,
                      step: int, k: int, quota: int, priority: Tensor):
    """Semi-dense object features: every `step`-th pixel inside a mask with
    0 < depth < th_depth_obj and in-bounds flow (Frame.cc:200-228), at most
    `quota` per label by `priority` (one uniform draw per grid site).
    Returns dict(xy, depth, flow, corres, sem_label, valid)."""
    H, W = depth_img.shape
    xy = object_grid(H, W, step, depth_img.device)
    d = gather_int(depth_img, xy)
    m = gather_int(mask_img, xy)
    f = gather_int(flow_img, xy)
    corres = xy + f
    ok = (m > 0) & (d > 0) & (d < th_depth_obj) & cam.in_bounds(corres, W, H)
    idx, valid = select.quota_select(m, ok, priority, quota, k)
    return {
        "xy": select.gather_rows(xy, idx, valid),
        "depth": torch.where(valid, d[idx], -1.0),
        "flow": select.gather_rows(f, idx, valid),
        "corres": select.gather_rows(corres, idx, valid),
        "sem_label": torch.where(valid, m[idx], 0).to(torch.int32),
        "valid": valid,
    }


def inherit_static(last_corres, last_valid, depth_img, corres_raw=None):
    """Current static keys = last frame's correspondences with depth
    re-gathered; bad lookups get depth -1 (Tracking.cc:252-273).
    corres_raw: the raw-image coordinates of the gathers where the banks
    hold pinhole (undistorted) coordinates; defaults to last_corres."""
    H, W = depth_img.shape
    at = last_corres if corres_raw is None else corres_raw
    d = gather_int(depth_img, at)
    good = last_valid & cam.in_bounds(at, W, H) & (d > 0)
    return {"xy": last_corres, "depth": torch.where(good, d, -1.0),
            "valid": last_valid}


def inherit_objects(last_obj_corres, last_obj_valid, depth_img, mask_img,
                    th_depth_obj: float, corres_raw=None):
    """Current object keys = last frame's object correspondences, depth and
    label re-gathered, with the reference's fallback depth 0.1 / label 0
    (Tracking.cc:277-300).  corres_raw: as in inherit_static."""
    H, W = depth_img.shape
    at = last_obj_corres if corres_raw is None else corres_raw
    d = gather_int(depth_img, at)
    m = gather_int(mask_img, at)
    good = cam.in_bounds(at, W, H) & (d < th_depth_obj) & (d > 0)
    return {
        "xy": last_obj_corres,
        "depth": torch.where(good, d, 0.1),
        "sem_label": torch.where(good, m, 0).to(torch.int32),
        "valid": last_obj_valid,
    }


def scene_flow_world(xy_last, depth_last, T_cw_last, xy_cur, depth_cur,
                     T_cw_cur, K):
    """World-frame 3D scene flow of object points (GetSceneFlowObj,
    Tracking.cc:1278-1364).  Returns (flow3d (N, 3), X_w_prev (N, 3))."""
    Xp = cam.unproject_to_world(xy_last, depth_last, K, se3.inv(T_cw_last))
    Xc = cam.unproject_to_world(xy_cur, depth_cur, K, se3.inv(T_cw_cur))
    return Xc - Xp, Xp


def label_slots(sem_label, label_table):
    """Map labels (N,) to their first slot in label_table (L,), or -1."""
    eq = sem_label[:, None] == label_table[None, :]
    slot = torch.argmax(eq.to(torch.uint8), dim=1)
    return torch.where(eq.any(dim=1), slot, -1)


def segment_sum(x: Tensor, seg: Tensor, n: int) -> Tensor:
    """Sums of x over segment ids 0..n-1 along the last axis; ids equal to n
    fall in a bucket that is dropped (jax.ops.segment_sum on an overflow
    bucket, sliced)."""
    out = x.new_zeros(x.shape[:-1] + (n + 1,))
    return out.scatter_add(-1, seg.expand(x.shape), x)[..., :n]


def zero_first(x: Tensor) -> Tensor:
    """x with entry 0 of its last axis zeroed (JAX's `.at[0].set(0)`)."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., 1:]], dim=-1)


def per_label_stats(slots, valid, xy, depth, sf3d, width: int, height: int,
                    n_slots: int, sf_mg_thres: float, shrink_row: int,
                    shrink_col: int):
    """Segment reductions for the dynamic classifier (Tracking.cc:1366-1612):
    per label slot the count, boundary count, small-|sf| count (x, z only,
    Tracking.cc:1446) and depth sum."""
    sl = torch.where(valid & (slots >= 0), slots, n_slots)
    ones = valid.to(torch.float32)
    u, v = xy[..., 0], xy[..., 1]
    on_boundary = ((v < shrink_row) | (v > height - shrink_row)
                   | (u < shrink_col) | (u > width - shrink_col)).float() * ones
    sf_norm = torch.sqrt(sf3d[..., 0] ** 2 + sf3d[..., 2] ** 2)
    sf_small = (sf_norm < sf_mg_thres).float() * ones
    return {
        "count": segment_sum(ones, sl, n_slots),
        "boundary": segment_sum(on_boundary, sl, n_slots),
        "sf_small": segment_sum(sf_small, sl, n_slots),
        "depth_sum": segment_sum(depth * ones, sl, n_slots),
    }


def propagate_mask(seg_cur, seg_last, flow_last, obj_corres_last,
                   obj_sem_last, obj_valid_last, label_table,
                   min_points: int = 100):
    """Recover instance masks the segmenter lost (UpdateMask,
    Tracking.cc:2997-3241): a last-frame label whose features now mostly
    land on background is scattered into seg_cur at pixel + flow_last.
    Returns (seg_out, lost (L,))."""
    H, W = seg_cur.shape
    L = label_table.shape[0]
    slots = label_slots(obj_sem_last, label_table)
    inb = cam.in_bounds(obj_corres_last, W, H)
    observed = gather_int(seg_cur, obj_corres_last).to(torch.int32)
    ok = obj_valid_last & inb & (slots >= 0)
    sl = torch.where(ok, slots, L)

    total = segment_sum(ok.float(), sl, L)
    zeros = segment_sum((ok & (observed == 0)).float(), sl, L)
    # votes[a, b]: features of slot b observed with label_table[a]
    votes = segment_sum(
        (ok[None, :] & (observed[None, :] == label_table[:, None])).float(),
        sl, L)
    votes = torch.where((label_table > 0)[:, None], votes, 0.0)
    max_nonzero = votes.amax(dim=0)
    lost = (total >= min_points) & (zeros > max_nonzero) & (label_table > 0)

    # the repair scatter, computed every frame and kept only if a label was
    # lost (the lax.cond of the JAX package, without a host read)
    lost_labels = torch.where(lost, label_table,
                              torch.full_like(label_table, -999999))
    is_lost_pixel = (seg_last[..., None] == lost_labels).any(dim=-1)
    ys, xs = torch.meshgrid(torch.arange(H, device=seg_cur.device),
                            torch.arange(W, device=seg_cur.device),
                            indexing="ij")
    tx = xs + flow_last[..., 0].to(torch.int64)
    ty = ys + flow_last[..., 1].to(torch.int64)
    inb_t = (tx > 0) & (tx < W) & (ty > 0) & (ty < H) & is_lost_pixel
    flat_idx = torch.where(inb_t, ty * W + tx, H * W).reshape(-1)
    flat = torch.cat([seg_cur.reshape(-1), seg_cur.new_zeros(1)])
    flat = flat.scatter(0, flat_idx, torch.where(inb_t, seg_last, 0).reshape(
        -1).to(flat.dtype))
    repaired = flat[:H * W].reshape(H, W)
    return torch.where(lost.any(), repaired, seg_cur), lost
