"""Copy of vdo_slam_tpu/backend/builders.py without JAX: the same graphs,
the same shapes and the same arrays (tests/test_torch_backend.py and
tests/test_torch_full_build.py hold them equal at atol=0), but for two
builds.  The window build reads only the window's frames of the archive
and gives the original's arrays from them.  The full build
(build_full_graph_on) runs as tensor ops on the device that solves it:
the archive copied there in one transfer, the tracklets chained by
pointer jumping, the graph assembled and padded there; build_full_graph
runs it on the CPU and gives the original's numpy arrays.  Graph and
Variables are the port's (backend/factor_graph.py), filled with numpy
arrays by the window build and the empty graphs, which the solver entries
upload to the device in one copy.  The fixed shapes that the
original's compiled executables need are what the port's CUDA graphs need:
`empty_window_graph` and `empty_full_graph` feed the warm-ups of
backend/window_ba.py and backend/full_ba.py, which capture the graphs.

Host-side graph assembly from the MapState archive.

Replicates the graph construction of Optimizer::PartialBatchOptimization
(Optimizer.cc:42-1230, static-only window) and FullBatchOptimization
(Optimizer.cc:1232-2175, full dynamic graph) as padded numpy index arrays
consumed by factor_graph.lm_solve.  Shapes are bucket-rounded so repeated
window solves reuse the same compiled executable.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np
import torch
from torch import Tensor

from ..config import VDOConfig
from ..pipeline.map_state import MapState, build_tracklets
from .factor_graph import Graph, Variables


def _bucket(n: int, step: int = 1024) -> int:
    return max(step, ((n + step - 1) // step) * step)


# fixed window-graph capacities: every window solve (and the warmup dummy)
# shares ONE compiled executable
P_CAP = 4096
E_CAP = 24576
# two-tier window shapes: the FIRST window of a sequence carries every
# tracklet born since frame 0 (bench: 2117 points / 23.3k edges — near the
# big caps), but every LATER window only sees tracklets born inside it
# (bench: 510-1119 points / 4.7-11k edges), so padding those solves to the
# big caps wastes ~half the window-BA device time (exec is linear in the
# PADDED edge/point counts — fixed shapes).  build_window_graph picks the
# smallest tier that fits and warmup_window_ba pre-compiles BOTH tiers on
# the background warmup thread (compile cost off the critical path).
WINDOW_TIERS = ((2048, 12288), (P_CAP, E_CAP))


def _unproject_np(xy, depth, cfg: VDOConfig):
    c = cfg.camera
    x = (xy[..., 0] - c.cx) * depth / c.fx
    y = (xy[..., 1] - c.cy) * depth / c.fy
    return np.stack([x, y, depth], axis=-1).astype(np.float32)


@dataclasses.dataclass
class GraphMeta:
    """Bookkeeping to write optimized values back into the MapState."""

    frame_ids: list               # graph pose idx -> map frame id
    static_tracks: list           # window: per point-vertex [(frame, feat),..]
    n_static_points: int
    dyn_obs: tuple | list         # full: (frames, feats) arrays, pid implicit
    motion_slots: list            # per motion vertex: (frame_pair_idx, obj_j)
    n_poses: int
    n_motions: int
    n_tracks_dropped: int = 0     # tracklets over P_CAP/E_CAP (window only)
    stat_obs: tuple | None = None  # full: (frames, feats, pids) arrays
    build_frames: int | None = None  # window: archive frames the build read
    # full: per full_* cap, {"n": real count, "cap": configured cap or
    # None, "padded": the graph's size}; caps_held is False where a
    # configured cap overflowed (its shapes then fall back to buckets)
    caps: dict | None = None
    caps_held: bool = True
    # full: the archive's bytes staged and copied to the build's device,
    # and the pointer-jumping rounds of each chaining (chain_rounds)
    h2d_bytes: int | None = None
    chain_rounds: int | None = None


def _pad_graph(parts: dict, n_pose: int, n_mot: int, bucket: int,
               sizes: dict | None = None) -> Graph:
    """Pad edge lists to bucketed sizes with zero-weight dummy edges.

    `sizes` overrides the bucket-derived count for individual edge types
    ({"E": obs, "Et": ternary, "Es": smoothness}) — used by the full graph
    when fixed capacities are configured so shapes are deterministic."""
    def pad_idx(a, n, keep_sorted=False):
        a = np.asarray(a, np.int32).reshape(-1)
        fill = (a[-1] if (keep_sorted and a.size) else 0)
        out = np.full(n, fill, np.int32)
        out[: a.size] = a
        return out

    def pad_f(a, n, shape=()):
        a = np.asarray(a, np.float32).reshape((-1,) + shape)
        out = np.zeros((n,) + shape, np.float32)
        if shape == (4, 4):
            out[:] = np.eye(4, dtype=np.float32)
        out[: a.shape[0]] = a
        return out

    sizes = sizes or {}
    E = sizes.get("E") or _bucket(len(parts["obs_pose"]), bucket)
    Eo = _bucket(len(parts["odo_a"]), 64)
    Ep = max(len(parts["pri_idx"]), 1)
    Es = sizes.get("Es") or _bucket(len(parts["smo_a"]), 64)
    Et = sizes.get("Et") or _bucket(len(parts["ter_prev"]), bucket)
    Ea = max(len(parts["alt_mot"]), 1)

    return Graph(
        obs_pose=pad_idx(parts["obs_pose"], E),
        obs_point=pad_idx(parts["obs_point"], E, keep_sorted=True),
        obs_meas=pad_f(parts["obs_meas"], E, (3,)),
        obs_w=pad_f(parts["obs_w"], E),
        odo_a=pad_idx(parts["odo_a"], Eo),
        odo_b=pad_idx(parts["odo_b"], Eo),
        odo_meas_inv=pad_f(parts["odo_meas_inv"], Eo, (4, 4)),
        odo_w=pad_f(parts["odo_w"], Eo),
        pri_idx=pad_idx(parts["pri_idx"], Ep),
        pri_meas_inv=pad_f(parts["pri_meas_inv"], Ep, (4, 4)),
        pri_w=pad_f(parts["pri_w"], Ep),
        smo_a=pad_idx(parts["smo_a"], Es),
        smo_b=pad_idx(parts["smo_b"], Es),
        smo_w=pad_f(parts["smo_w"], Es),
        ter_prev=pad_idx(parts["ter_prev"], Et, keep_sorted=True),
        ter_cur=pad_idx(parts["ter_cur"], Et, keep_sorted=True),
        ter_mot=pad_idx(parts["ter_mot"], Et),
        ter_w=pad_f(parts["ter_w"], Et),
        alt_mot=pad_idx(parts["alt_mot"], Ea),
        alt_w=pad_f(parts["alt_w"], Ea),
    )


def _apply_cap(cap: int | None, n: int, name: str) -> int | None:
    """Fixed capacity if configured and sufficient, else None (bucket mode).

    A None return on an overfull cap also voids shape determinism for this
    solve — the warmup executable compiled at cap shapes won't be reused —
    but correctness is preserved via the bucket fallback."""
    if cap is None:
        return None
    if n > cap:
        print(f"[full-graph] {name}: {n} exceeds configured cap {cap}; "
              f"falling back to bucket-rounded shapes", file=sys.stderr)
        return None
    return cap


def _np_inv(T):
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def _empty_parts():
    return {k: [] for k in (
        "obs_pose obs_point obs_meas obs_w odo_a odo_b odo_meas_inv odo_w "
        "pri_idx pri_meas_inv pri_w smo_a smo_b smo_w "
        "ter_prev ter_cur ter_mot ter_w alt_mot alt_w".split()
    )}


def build_window_graph(m: MapState, cfg: VDOConfig, window: int | None = None,
                       n_frames: int | None = None):
    """Static-only windowed graph (PartialBatchOptimization semantics:
    camera chain + prior + static points of tracklets that START inside the
    window with length >= 3; STATIC_ONLY=true per Optimizer.cc:211).

    n_frames pins the window end to a specific archive length so the build
    can run on a background thread while the tracker keeps appending frames
    (appends never disturb indices < n_frames).

    Unlike the original, which chains and stacks the whole archive, this
    copy reads only frames lo = max(start - 1, 0) .. N - 1 (W + 1 frames
    once the archive is longer than the window; `meta.build_frames`), so
    a build no longer grows with the drive.  It gives the original's
    arrays: whether a feature of frame f starts a tracklet depends only on
    assoc[f - 1] and valid[f], so frames lo .. N - 1 decide every tracklet
    born at or after `start`; those chained from frame lo that were alive
    before `start` fall to the same first-frame filter, and track ids
    keep their creation order (tests/test_torch_window_build.py and
    tests/test_torch_backend.py hold the arrays equal at atol=0)."""
    be = cfg.backend
    N = n_frames if n_frames is not None else m.num_frames
    W = min(window or cfg.tracking.window_size, N)
    start = N - W
    lo = max(start - 1, 0)
    frames = list(range(start, N))

    # flat (track, frame, feat) arrays over frames lo .. N - 1, sorted by
    # (track, frame), frames made absolute again
    (tid, frm, fea), _ = build_tracklets(m.stat_assoc[lo: N - 1],
                                         m.stat_valid[lo:N], flat=True)
    frm = frm + lo
    n_tracks = int(tid.max()) + 1 if tid.size else 1
    counts = np.bincount(tid, minlength=n_tracks)
    is_first = np.ones(tid.size, bool)
    if tid.size:
        is_first[1:] = tid[1:] != tid[:-1]
    first_frame = np.full(n_tracks, -1, np.int64)
    first_feat = np.zeros(n_tracks, np.int64)
    first_frame[tid[is_first]] = frm[is_first]
    first_feat[tid[is_first]] = fea[is_first]
    keep = (counts >= be.track_len_thres) & (first_frame >= start)
    kept_ids = np.nonzero(keep)[0]
    lens = counts[kept_ids]
    # fixed capacities (module constants) so every window solve reuses ONE
    # compiled executable: prefer long tracklets (most informative) over cap
    n_candidates = kept_ids.size
    if n_candidates > P_CAP:
        order = np.argsort(-lens, kind="stable")[:P_CAP]
        kept_ids, lens = kept_ids[order], lens[order]
    while lens.sum() > E_CAP:
        k = int(kept_ids.size * 0.9)
        kept_ids, lens = kept_ids[:k], lens[:k]
    n_dropped = n_candidates - kept_ids.size
    if n_dropped:
        print(
            f"[window-ba] capacity truncation: kept {kept_ids.size}/"
            f"{n_candidates} tracklets (P_CAP={P_CAP}, E_CAP={E_CAP}) — "
            f"quality on this window degrades with the dropped tracklets",
            file=sys.stderr,
        )
    n_pts = kept_ids.size

    pid_of = np.full(n_tracks, -1, np.int64)
    pid_of[kept_ids] = np.arange(n_pts)
    sel = pid_of[tid] >= 0 if tid.size else np.zeros(0, bool)
    s_pid, s_frm, s_fea = pid_of[tid[sel]], frm[sel], fea[sel]
    # order rows by (pid, frame): identical to the per-track append order
    order = np.lexsort((s_frm, s_pid))
    s_pid, s_frm, s_fea = s_pid[order], s_frm[order], s_fea[order]

    parts = _empty_parts()
    stat_xy = np.stack(m.stat_xy[lo:N]) if N else np.zeros((0, 0, 2))
    stat_depth = np.stack(m.stat_depth[lo:N])
    xy = stat_xy[s_frm - lo, s_fea]
    z = stat_depth[s_frm - lo, s_fea]
    c = cfg.camera
    parts["obs_pose"] = (s_frm - start).astype(np.int32)
    parts["obs_point"] = s_pid.astype(np.int32)
    parts["obs_meas"] = np.stack([
        (xy[:, 0] - c.cx) * z / c.fx, (xy[:, 1] - c.cy) * z / c.fy, z,
    ], axis=-1).astype(np.float32)
    parts["obs_w"] = np.full(s_frm.size, 1.0 / be.local_sigma2_3d_sta,
                             np.float32)

    for i in range(1, W):
        f = frames[i]
        parts["odo_a"].append(i - 1)
        parts["odo_b"].append(i)
        parts["odo_meas_inv"].append(_np_inv(m.rigid_motion[f - 1][0]))
        parts["odo_w"].append(1.0 / be.local_sigma2_cam)

    # gauge anchor on the first window pose (the reference only anchors the
    # very first window, Optimizer.cc:186-196; an anchor at the current
    # estimate is gauge-equivalent and better conditioned for PCG)
    parts["pri_idx"].append(0)
    parts["pri_meas_inv"].append(_np_inv(m.cam_pose[frames[0]]))
    parts["pri_w"].append(be.prior_information)

    # pad to the smallest tier that fits (two stable executables total;
    # both warmed by warmup_window_ba)
    p_cap, e_cap = next((pc, ec) for pc, ec in WINDOW_TIERS
                        if n_pts <= pc and s_pid.size <= ec)
    stat_3d = np.stack(m.stat_3d[lo:N])
    pad_p = np.zeros((p_cap, 3), np.float32)
    if n_pts:
        pad_p[:n_pts] = stat_3d[first_frame[kept_ids] - lo,
                                first_feat[kept_ids]].astype(np.float32)
    variables = Variables(
        poses=np.stack([m.cam_pose[f] for f in frames]).astype(np.float32),
        motions=np.eye(4, dtype=np.float32)[None],
        points=pad_p,
    )
    graph = _pad_graph(parts, W, 1, e_cap)  # tier bucket: stable shapes
    # static_tracks in flat form for the write-back (frame, feat, pid)
    meta = GraphMeta(
        frame_ids=frames, static_tracks=[], n_static_points=n_pts,
        dyn_obs=[], motion_slots=[], n_poses=W, n_motions=1,
        n_tracks_dropped=n_dropped,
    )
    meta.stat_obs = (s_frm, s_fea, s_pid)
    meta.build_frames = N - lo
    return graph, variables, meta


def empty_window_graph(cfg: VDOConfig, window: int | None = None,
                       tier: int = -1):
    """A zero-weight window graph with EXACTLY the shapes build_window_graph
    produces once the archive holds >= window frames (the WINDOW_TIERS caps
    are fixed, so shapes depend only on the window length and tier).  Used
    to compile + first-execute the window-BA programs before the first real
    trigger — program load costs seconds on the remote worker and would
    otherwise land mid-tracking.  tier indexes WINDOW_TIERS (-1 = the big
    tier); warmup_window_ba warms every tier."""
    W = window or cfg.tracking.window_size
    p_cap, e_cap = WINDOW_TIERS[tier]
    be = cfg.backend
    parts = _empty_parts()
    for i in range(1, W):
        parts["odo_a"].append(i - 1)
        parts["odo_b"].append(i)
        parts["odo_meas_inv"].append(np.eye(4, dtype=np.float32))
        parts["odo_w"].append(1.0 / be.local_sigma2_cam)
    parts["pri_idx"].append(0)
    parts["pri_meas_inv"].append(np.eye(4, dtype=np.float32))
    parts["pri_w"].append(be.prior_information)
    variables = Variables(
        poses=np.tile(np.eye(4, dtype=np.float32), (W, 1, 1)),
        motions=np.eye(4, dtype=np.float32)[None],
        points=np.zeros((p_cap, 3), np.float32),
    )
    return _pad_graph(parts, W, 1, e_cap), variables


def _np_inv_batch(T: np.ndarray) -> np.ndarray:
    """_np_inv of each 4x4 in T (n, 4, 4), in one batched product: numpy's
    BLAS contracts each 3-term dot product into fused multiply-adds, so
    the inverses stay on the host, where they equal _np_inv's bit for
    bit."""
    out = np.tile(np.eye(4, dtype=np.float32), (T.shape[0], 1, 1))
    Rt = np.swapaxes(T[:, :3, :3], 1, 2)
    out[:, :3, :3] = Rt
    out[:, :3, 3] = (-Rt @ T[:, :3, 3:])[..., 0]
    return out


def _stage(parts: dict, device: torch.device) -> tuple[dict, int]:
    """Each part (an array, or a list of equal-shape arrays to stack) as a
    tensor on `device`, in its own dtype: all stacked into ONE byte buffer
    (pinned on a card; torch's caching host allocator hands the same block
    to the next build of an archive of this size) and copied in ONE
    transfer.  Returns the tensors by name and the bytes staged."""
    specs, total = {}, 0
    for name, x in parts.items():
        if isinstance(x, np.ndarray):
            dt, shape = x.dtype, x.shape
        else:
            dt = functools.reduce(np.promote_types, {r.dtype for r in x})
            shape = (len(x),) + np.shape(x[0])
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        specs[name] = (dt, shape, total, nbytes)
        total += -(-nbytes // 64) * 64
    host = torch.empty(max(total, 64), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    buf = host.numpy()
    for name, x in parts.items():
        dt, shape, o, nbytes = specs[name]
        out = buf[o:o + nbytes].view(dt).reshape(shape)
        wide = _WIDE.get(shape[-1] * dt.itemsize) if len(shape) > 2 else None
        if isinstance(x, np.ndarray):
            out[...] = x
        elif wide and all(r.dtype == dt and r.strides[-1] == dt.itemsize
                          for r in x):
            np.stack([r.view(wide)[..., 0] for r in x],
                     out=out.view(wide)[..., 0])
        else:
            np.stack(x, out=out)
    flat = host.to(device, non_blocking=True)
    return {name: flat[o:o + nbytes].view(_TORCH_DTYPE[dt]).view(shape)
            for name, (dt, shape, o, nbytes) in specs.items()}, total


# a row whose last axis is contiguous and 2, 4 or 8 bytes wide is copied
# as one integer a row: numpy copies a strided (n, 2) float32 view (the xy
# columns of fused.unpack_host's archive) with a 2-element inner loop per
# row, and the same bytes as an (n,) int64 view in one loop, ~2x faster
_WIDE = {2: np.int16, 4: np.int32, 8: np.int64}

_TORCH_DTYPE = {np.dtype(d): t for d, t in (
    (np.bool_, torch.bool), (np.uint8, torch.uint8), (np.int8, torch.int8),
    (np.int16, torch.int16), (np.int32, torch.int32),
    (np.int64, torch.int64), (np.float16, torch.float16),
    (np.float32, torch.float32), (np.float64, torch.float64))}


def chain_rounds(n_frames: int) -> int:
    """Pointer-jumping rounds that resolve every chain of an n_frames
    archive: a track's first new feature is at frame >= 1, so a feature
    is at most n_frames - 2 links from it, and each round doubles the
    links a pointer spans (ceil(log2(n_frames - 2)), 0 below 4 frames)."""
    return max(n_frames - 3, 0).bit_length()


def _chain(assoc: Tensor, valid: Tensor, rounds: int):
    """build_tracklets' flat records, on the device of its inputs.

    assoc (N - 1, J): feature j of frame g >= 1 continues feature
    assoc[g - 1, j] of frame g - 1; valid (N, J).  A feature of frame g
    "has" when its assoc is >= 0 and it is valid; it continues its
    parent's track when the parent has (frame 0 never does), else it
    starts a new track, anchored at the parent.  Tracks are named by their
    new feature (its flat index g * J + j, the root): roots in flat order
    are build_tracklets' track ids in order.  `rounds` of pointer jumping
    (chain_rounds) take every feature to its root.

    Returns (root, frame, feat) of every record, each track's anchor and
    then its features, sorted by (root, frame, feat): build_tracklets'
    lexsort by (track, frame), whose ties (two features of one frame that
    continue one track) keep feature order; and `new` (N * J,), the roots.
    """
    N, J = valid.shape
    dev = valid.device
    if N * J == 0:
        e = torch.zeros(0, dtype=torch.int64, device=dev)
        return e, e, e, torch.zeros(N * J, dtype=torch.bool, device=dev)
    a = assoc.long()
    h = ((a >= 0) & valid[1:]).reshape(-1)
    parent = (torch.arange(N - 1, device=dev)[:, None] * J
              + a.clamp_min(0)).reshape(-1)
    has = torch.cat([torch.zeros(J, dtype=torch.bool, device=dev), h])
    cont = h & has[parent]
    new = torch.cat([torch.zeros(J, dtype=torch.bool, device=dev),
                     h & ~cont])
    ptr = torch.arange(N * J, device=dev)
    ptr[J:] = torch.where(cont, parent, ptr[J:])
    for _ in range(rounds):
        ptr = ptr[ptr]
    node = torch.nonzero(has).squeeze(1)
    root = torch.nonzero(new).squeeze(1)
    r = torch.cat([ptr[node], root])
    f = torch.cat([node // J, root // J - 1])
    j = torch.cat([node % J, parent[root - J] % J])
    key = torch.sort((r * N + f) * J + j).values
    return key // (N * J), key // J % N, key % J, new


def build_full_graph_on(m: MapState, cfg: VDOConfig, device):
    """Full dynamic graph (FullBatchOptimization semantics, Optimizer.cc:
    1232-1935), built on `device`: all camera poses + prior, static
    tracklets (len >= 3), per-frame-per-object motion vertices, a NEW
    dynamic point vertex per observation, ternary motion edges along
    dynamic tracklets, smoothness between consecutive motions of one
    object.

    The archive is read anew, stacked and copied to the device in one
    transfer (_stage); the tracklets are chained there (_chain) and every
    later step runs as tensor ops, in numpy's op order and dtypes, so the
    graph equals the original's numpy build bit for bit.  Returns (graph,
    variables, meta): a Graph and Variables of tensors on `device` in the
    dtypes factor_graph.upload gives (int64 indices, float32 values), and
    the GraphMeta, whose stat_obs and dyn_obs come back in one copy, which
    waits for the build to end."""
    device = torch.device(device)
    be, c = cfg.backend, cfg.camera
    N = m.num_frames
    R = len(m.rigid_motion)

    # ---- motion vertices: one per (frame pair fp, object j >= 1), from
    # the labels on the host (Optimizer.cc:1575-1582)
    motion_slots = [(fp, j) for fp in range(R)
                    for j in range(1, len(m.rm_label[fp]))]
    S = len(motion_slots)
    slot_fp = np.array([fp for fp, _ in motion_slots], np.int64)
    slot_lab = np.array([m.rm_label[fp][j] for fp, j in motion_slots],
                        np.int64)
    n_motions = max(S, 1)
    # label axis sized to the data (labels are small ints): the original's
    # lookup table, which skips negative labels, is this one's columns
    # 0 .. L_SPACE - 1; smoothness, which does not, reads all of it
    L_SPACE = max(int(slot_lab.max()) if S else 0, 0) + 1
    l_min = min(int(slot_lab.min()) if S else 0, 0)
    W = L_SPACE - l_min

    def rows_or_empty(rows, shape, dtype):
        return rows if rows else np.zeros((0,) + shape, dtype)

    Js, Jd = np.shape(m.stat_valid[0])[0], np.shape(m.dyn_valid[0])[0]
    t, nbytes = _stage({
        "stat_xy": m.stat_xy[:N], "stat_depth": m.stat_depth[:N],
        "stat_3d": m.stat_3d[:N], "stat_valid": m.stat_valid[:N],
        "stat_assoc": rows_or_empty(m.stat_assoc[:N - 1], (Js,), np.int32),
        "dyn_xy": m.dyn_xy[:N], "dyn_depth": m.dyn_depth[:N],
        "dyn_3d": m.dyn_3d[:N], "dyn_valid": m.dyn_valid[:N],
        "dyn_assoc": rows_or_empty(m.dyn_assoc[:N - 1], (Jd,), np.int32),
        "dyn_obj_label": m.dyn_obj_label[:N],
        "cam_pose": m.cam_pose[:N],
        "motions": rows_or_empty(
            [m.rigid_motion[fp][j] for fp, j in motion_slots], (4, 4),
            np.float32),
        "odo_inv": _np_inv_batch(np.stack(
            [m.rigid_motion[f][0] for f in range(N - 1)])
            if N > 1 else np.zeros((0, 4, 4), np.float32)),
        "pri_inv": _np_inv(m.cam_pose[0])[None],
        "slot_fp": slot_fp, "slot_lab": slot_lab,
    }, device)
    rounds = chain_rounds(N)
    i64, f32 = torch.int64, torch.float32

    def arange(n, start=0):
        return torch.arange(start, start + n, device=device)

    def const(n, value):
        return torch.full((n,), value, dtype=f32, device=device)

    def unproject(xy, depth):
        # constants as device tensors of xy's dtype: numpy rounds a Python
        # float to the array's dtype, and CUDA would turn a division by a
        # host scalar into a product with its reciprocal
        def k(v):
            return torch.tensor(v, dtype=xy.dtype, device=device)
        x = (xy[:, 0] - k(c.cx)) * depth / k(c.fx)
        y = (xy[:, 1] - k(c.cy)) * depth / k(c.fy)
        return torch.stack([x.to(f32), y.to(f32), depth.to(f32)], dim=-1)

    # ---- static points: kept tracks (len >= track_len_thres) renumbered
    # densely in track order; each point starts at its track's anchor
    r, s_frm, s_fea, new = _chain(t["stat_assoc"], t["stat_valid"], rounds)
    count = torch.zeros(N * Js, dtype=i64, device=device).index_add_(
        0, r, torch.ones_like(r))
    keep = new & (count >= be.track_len_thres)
    sel = keep[r]
    r, s_frm, s_fea = r[sel], s_frm[sel], s_fea[sel]
    s_pid = (torch.cumsum(keep, 0) - 1)[r]
    roots = torch.nonzero(keep).squeeze(1)
    n_static = roots.numel()
    a_stat = t["stat_assoc"].reshape(-1).long()
    pts_static = t["stat_3d"][roots // Js - 1, a_stat[roots - Js]]
    stat_meas = unproject(t["stat_xy"][s_frm, s_fea],
                          t["stat_depth"][s_frm, s_fea])

    # ---- motion vertices: the last slot of each (frame pair, label), for
    # the dynamic observations and the smoothness edges (1593-1623)
    mids = arange(S)
    slot_fp, slot_lab = t["slot_fp"], t["slot_lab"]
    table = torch.full((max(R, 1) * W,), -1, dtype=i64, device=device)
    table.scatter_reduce_(0, slot_fp * W + slot_lab - l_min, mids, "amax")
    smo_a = smo_b = arange(0)
    if be.smooth_constraint:
        prev = table[(slot_fp - 1).clamp_min(0) * W + slot_lab - l_min]
        has_prev = (slot_fp > 0) & (prev >= 0)
        smo_a, smo_b = prev[has_prev], mids[has_prev]
    alt_mot = mids if be.altitude_constraint else arange(0)

    # ---- dynamic points: a NEW vertex per observation (never merged,
    # Optimizer.cc:1672-1746), obs edge to its frame, ternary edge to the
    # previous observation through the motion vertex
    r, d_frm, d_fea, new = _chain(t["dyn_assoc"], t["dyn_valid"], rounds)
    count = torch.zeros(N * Jd, dtype=i64, device=device).index_add_(
        0, r, torch.ones_like(r))
    label = t["dyn_obj_label"].reshape(-1).long()
    ok = new & (count >= be.track_len_thres) & (label > 0)
    sel = ok[r]
    r, d_frm, d_fea = r[sel], d_frm[sel], d_fea[sel]
    d_obj = label[r]
    is_first = torch.ones(r.numel(), dtype=torch.bool, device=device)
    is_first[1:] = r[1:] != r[:-1]
    # the motion vertex of the (f-1 -> f) transition; labels beyond the
    # table read column 0, the camera's, which only a label-0 slot writes,
    # so such an observation is skipped like any other with no motion
    # vertex: the reference skips a non-first observation without one and
    # breaks the chain there (Optimizer.cc:1786-1789)
    safe_obj = torch.where(d_obj < L_SPACE, d_obj, 0)
    mid = torch.where(is_first, -1,
                      table[(d_frm - 1).clamp_min(0) * W + safe_obj - l_min])
    kept = is_first | (mid >= 0)
    d_frm, d_fea, mid, is_first = (d_frm[kept], d_fea[kept], mid[kept],
                                   is_first[kept])
    n_dyn = d_frm.numel()
    d_pid = arange(n_dyn, n_static)
    # ternary edge iff this obs and the chain predecessor (= previous kept
    # obs of the same track at the previous frame) both exist
    prev_kept = torch.zeros_like(is_first)
    prev_kept[1:] = ~is_first[1:] & (d_frm[1:] == d_frm[:-1] + 1)
    ter_cur = d_pid[prev_kept]
    ter_mot = mid[prev_kept]
    dyn_meas = unproject(t["dyn_xy"][d_frm, d_fea],
                         t["dyn_depth"][d_frm, d_fea])
    pts_dyn = t["dyn_3d"][d_frm, d_fea]

    # ---- sizes: the configured caps where they hold, else buckets
    n_obs, n_ter = s_frm.numel() + n_dyn, ter_cur.numel()
    n_smo = smo_a.numel()
    n_pts = n_static + n_dyn
    P_pad = _apply_cap(be.full_point_cap, max(n_pts, 1), "points") \
        or max(n_pts, 1)
    M_pad = _apply_cap(be.full_motion_cap, n_motions, "motions") \
        or n_motions
    E = (_apply_cap(be.full_obs_cap, n_obs, "obs")
         or _bucket(n_obs, 4096))
    Et = (_apply_cap(be.full_ter_cap, n_ter, "ternary")
          or _bucket(n_ter, 4096))
    Es = _apply_cap(be.full_smo_cap, n_smo, "smooth") or _bucket(n_smo, 64)
    Eo = _bucket(N - 1, 64)

    def pad(x, n, fill=0):
        """x padded to n rows with `fill` (a number, or "last": x's last
        row, 0 if it has none; the sorted index arrays)."""
        if fill == "last":
            fill = x[-1:] if x.numel() else 0
        rest = (n - x.shape[0],) + tuple(x.shape[1:])
        tail = (fill.expand(rest) if torch.is_tensor(fill)
                else torch.full(rest, fill, dtype=x.dtype, device=device))
        return torch.cat([x, tail])

    def pad_eye(x, n):
        return torch.cat([x.to(f32), torch.eye(4, device=device).expand(
            n - x.shape[0], 4, 4)])

    w_obs = torch.cat([const(s_frm.numel(), 1.0 / be.full_sigma2_3d_sta),
                       const(n_dyn, 1.0 / be.full_sigma2_3d_dyn)])
    graph = Graph(
        obs_pose=pad(torch.cat([s_frm, d_frm]), E),
        obs_point=pad(torch.cat([s_pid, d_pid]), E, "last"),
        obs_meas=pad(torch.cat([stat_meas, dyn_meas]), E),
        obs_w=pad(w_obs, E),
        odo_a=pad(arange(N - 1), Eo),
        odo_b=pad(arange(N - 1, 1), Eo),
        odo_meas_inv=pad_eye(t["odo_inv"], Eo),
        odo_w=pad(const(N - 1, 1.0 / be.full_sigma2_cam), Eo),
        pri_idx=arange(1),
        pri_meas_inv=t["pri_inv"].clone(),
        pri_w=const(1, be.prior_information),
        smo_a=pad(smo_a, Es),
        smo_b=pad(smo_b, Es),
        smo_w=pad(const(n_smo, 1.0 / be.full_sigma2_obj_smo), Es),
        ter_prev=pad(ter_cur - 1, Et, "last"),
        ter_cur=pad(ter_cur, Et, "last"),
        ter_mot=pad(ter_mot, Et),
        ter_w=pad(const(n_ter, 1.0 / be.full_sigma2_obj), Et),
        alt_mot=pad(alt_mot, max(alt_mot.numel(), 1)),
        alt_w=pad(const(alt_mot.numel(), 1.0 / be.full_sigma2_alti),
                  max(alt_mot.numel(), 1)),
    )
    # Motion vertices start from the TRACKED per-frame estimates rather than
    # the reference's identity init (Optimizer.cc:1575-1582).  g2o runs up to
    # 300 exact-Cholesky LM iterations from identity; under this solver's
    # fixed chunked budget the identity init converges into a worse basin
    # (measured: refined obj-rotation RPE 12x worse than tracked, while the
    # tracked init lands in the same basin a GT init reaches and refines
    # BELOW the tracked error).  The tracked motions are available by
    # construction at full-BA time, so this is strictly more information.
    variables = Variables(
        poses=t["cam_pose"].to(f32, copy=True),
        motions=pad_eye(t["motions"], M_pad),
        points=pad(torch.cat([pts_static, pts_dyn]).to(f32), P_pad),
    )
    caps = {name: {"n": n, "cap": cap, "padded": padded}
            for name, n, cap, padded in (
                ("obs", n_obs, be.full_obs_cap, E),
                ("ternary", n_ter, be.full_ter_cap, Et),
                ("smooth", n_smo, be.full_smo_cap, Es),
                ("points", n_pts, be.full_point_cap, P_pad),
                ("motions", S, be.full_motion_cap, M_pad))}
    # the write-back's indices: ONE device-to-host copy, into pinned
    # memory on a card (pageable runs at a tenth of the rate), the build's
    # last step, which waits for the graph
    obs = torch.cat([s_frm, s_fea, s_pid, d_frm, d_fea])
    if device.type == "cuda":
        obs = torch.empty(obs.shape, dtype=obs.dtype,
                          pin_memory=True).copy_(obs)
    obs = obs.numpy()
    n_s = s_frm.numel()
    meta = GraphMeta(
        frame_ids=list(range(N)), static_tracks=[],
        n_static_points=n_static,
        dyn_obs=(obs[3 * n_s:3 * n_s + n_dyn], obs[3 * n_s + n_dyn:]),
        motion_slots=motion_slots, n_poses=N, n_motions=n_motions,
        caps=caps, caps_held=all(c["cap"] is None or c["n"] <= c["cap"]
                                 for c in caps.values()),
        h2d_bytes=nbytes, chain_rounds=rounds,
    )
    meta.stat_obs = (obs[:n_s], obs[n_s:2 * n_s], obs[2 * n_s:3 * n_s])
    return graph, variables, meta


def build_full_graph(m: MapState, cfg: VDOConfig):
    """build_full_graph_on the CPU, as the original's numpy arrays: int32
    indices and float32 values, (graph, variables, meta)."""
    graph, variables, meta = build_full_graph_on(m, cfg, "cpu")

    def host(x):
        return x.numpy().astype(np.int32 if x.dtype == torch.int64
                                else np.float32)

    return (Graph(**{f.name: host(getattr(graph, f.name))
                     for f in dataclasses.fields(Graph)}),
            Variables(*(host(getattr(variables, n))
                        for n in ("poses", "motions", "points"))),
            meta)


def empty_full_graph(cfg: VDOConfig, n_frames: int):
    """A zero-weight full graph with EXACTLY the shapes build_full_graph
    produces for an n_frames archive when the full_* caps are configured.

    Used to warm and capture the full-BA graphs before the real solve
    (full_ba.warmup_full_ba), which then replays them."""
    be = cfg.backend
    for cap in (be.full_obs_cap, be.full_ter_cap, be.full_point_cap,
                be.full_motion_cap, be.full_smo_cap):
        if cap is None:
            raise ValueError("empty_full_graph requires all full_* caps set "
                             "(shapes are data-dependent otherwise)")
    parts = _empty_parts()
    for f in range(1, n_frames):
        parts["odo_a"].append(f - 1)
        parts["odo_b"].append(f)
        parts["odo_meas_inv"].append(np.eye(4, dtype=np.float32))
        parts["odo_w"].append(1.0 / be.full_sigma2_cam)
    parts["pri_idx"].append(0)
    parts["pri_meas_inv"].append(np.eye(4, dtype=np.float32))
    parts["pri_w"].append(be.prior_information)
    sizes = {"E": be.full_obs_cap, "Et": be.full_ter_cap,
             "Es": be.full_smo_cap}
    graph = _pad_graph(parts, n_frames, be.full_motion_cap, 4096, sizes=sizes)
    variables = Variables(
        poses=np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1)),
        motions=np.tile(np.eye(4, dtype=np.float32),
                        (be.full_motion_cap, 1, 1)),
        points=np.zeros((be.full_point_cap, 3), np.float32),
    )
    return graph, variables
