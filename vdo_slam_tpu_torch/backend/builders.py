"""Copy of vdo_slam_tpu/backend/builders.py without JAX: the same numpy
graph assembly, the same shapes and the same arrays (tests/
test_torch_backend.py holds them equal at atol=0), but for the window
build, which reads only the window's frames of the archive and gives the
original's arrays from them.  Graph and Variables are
the port's (backend/factor_graph.py), filled with numpy arrays; the solver
entries upload them to the device in one copy.  The fixed shapes that the
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
import sys

import numpy as np

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


def build_full_graph(m: MapState, cfg: VDOConfig):
    """Full dynamic graph (FullBatchOptimization semantics, Optimizer.cc:
    1232-1935): all camera poses + prior, static tracklets (len >= 3),
    identity-initialized per-frame-per-object motion vertices, a NEW dynamic
    point vertex per observation, ternary motion edges along dynamic
    tracklets, smoothness between consecutive motions of one object.

    Assembly is fully vectorized over the flat tracklet arrays (a 100-frame
    archive has ~230k observations; the per-observation python loop this
    replaces cost ~3 s of host time on the full-BA critical path)."""
    be = cfg.backend
    N = m.num_frames
    parts = _empty_parts()

    # ---- poses: chain + prior
    for f in range(1, N):
        parts["odo_a"].append(f - 1)
        parts["odo_b"].append(f)
        parts["odo_meas_inv"].append(_np_inv(m.rigid_motion[f - 1][0]))
        parts["odo_w"].append(1.0 / be.full_sigma2_cam)
    parts["pri_idx"].append(0)
    parts["pri_meas_inv"].append(_np_inv(m.cam_pose[0]))
    parts["pri_w"].append(be.prior_information)

    def unproject_cols(xy, depth):
        c = cfg.camera
        x = (xy[:, 0] - c.cx) * depth / c.fx
        y = (xy[:, 1] - c.cy) * depth / c.fy
        return np.stack([x, y, depth], axis=-1).astype(np.float32)

    # ---- static points (flat arrays, sorted by (track, frame))
    (s_tid, s_frm, s_fea), _ = build_tracklets(m.stat_assoc, m.stat_valid,
                                               flat=True)
    counts = np.bincount(s_tid, minlength=s_tid.max() + 1 if s_tid.size else 1)
    keep_track = counts >= be.track_len_thres
    sel = keep_track[s_tid]
    s_tid, s_frm, s_fea = s_tid[sel], s_frm[sel], s_fea[sel]
    # dense renumber of kept tracks -> point ids (order preserved)
    pid_of_track = np.cumsum(keep_track) - 1
    s_pid = pid_of_track[s_tid].astype(np.int64)
    n_static = int(keep_track.sum())

    stat_xy = np.stack(m.stat_xy) if N else np.zeros((0, 0, 2))
    stat_depth = np.stack(m.stat_depth)
    stat_3d = np.stack(m.stat_3d)
    parts["obs_pose"] = s_frm.astype(np.int32)
    parts["obs_point"] = s_pid.astype(np.int32)
    parts["obs_meas"] = unproject_cols(stat_xy[s_frm, s_fea],
                                       stat_depth[s_frm, s_fea])
    parts["obs_w"] = np.full(s_frm.size, 1.0 / be.full_sigma2_3d_sta,
                             np.float32)
    # track anchors: first obs of each kept track initializes its point
    first = np.ones(s_tid.size, bool)
    first[1:] = s_tid[1:] != s_tid[:-1]
    anchor_f, anchor_j = s_frm[first], s_fea[first]
    pts_static = (stat_3d[anchor_f, anchor_j] if anchor_f.size
                  else np.zeros((0, 3), np.float32))

    # ---- motion vertices: one per (frame f>=1, object j>=1), init identity
    # (Optimizer.cc:1575-1582) + smoothness to the previous frame's vertex of
    # the same label (1593-1623) + optional altitude prior
    # label axis sized to the data (labels are small ints, but a dense 2^16
    # axis cost ~50 MB of 1-core host time per build and silently dropped
    # labels above it); int32 halves the table again
    max_label = 0
    for fp in range(len(m.rigid_motion)):
        labels = m.rm_label[fp]
        if len(labels) > 1:
            max_label = max(max_label, int(max(labels[1:])))
    L_SPACE = max_label + 1 if max_label > 0 else 1
    mot_lookup = np.full((max(len(m.rigid_motion), 1), L_SPACE), -1, np.int32)
    motion_slots = []
    motion_of = {}
    for fp in range(len(m.rigid_motion)):        # fp = frame pair (fp -> fp+1)
        labels = m.rm_label[fp]
        for j in range(1, len(labels)):
            mid = len(motion_slots)
            motion_of[(fp, labels[j])] = mid
            if 0 <= labels[j] < L_SPACE:
                mot_lookup[fp, labels[j]] = mid
            motion_slots.append((fp, j))
            if be.altitude_constraint:
                parts["alt_mot"].append(mid)
                parts["alt_w"].append(1.0 / be.full_sigma2_alti)
            if be.smooth_constraint and fp > 0:
                prev = motion_of.get((fp - 1, labels[j]))
                if prev is not None:
                    parts["smo_a"].append(prev)
                    parts["smo_b"].append(mid)
                    parts["smo_w"].append(1.0 / be.full_sigma2_obj_smo)
    n_motions = max(len(motion_slots), 1)

    # ---- dynamic points: a NEW vertex per observation (never merged,
    # Optimizer.cc:1672-1746), obs edge to its frame, ternary edge to the
    # previous observation through the motion vertex
    (d_tid, d_frm, d_fea), dobj = build_tracklets(
        m.dyn_assoc, m.dyn_valid, m.dyn_obj_label, flat=True)
    dcounts = np.bincount(d_tid, minlength=d_tid.max() + 1 if d_tid.size else 1)
    track_ok = (dcounts >= be.track_len_thres) & (np.asarray(dobj) > 0) \
        if d_tid.size else np.zeros(1, bool)
    sel = track_ok[d_tid] if d_tid.size else np.zeros(0, bool)
    d_tid, d_frm, d_fea = d_tid[sel], d_frm[sel], d_fea[sel]
    d_obj = np.asarray(dobj)[d_tid] if d_tid.size else d_tid
    is_first = np.ones(d_tid.size, bool)
    if d_tid.size:
        is_first[1:] = d_tid[1:] != d_tid[:-1]
    # the motion vertex for the (f-1 -> f) transition; first obs needs none
    # labels beyond the table map to column 0 (the camera slot, never
    # written -> -1 -> the observation is skipped like any other with no
    # motion vertex, the reference's semantics at Optimizer.cc:1786-1789)
    safe_obj = np.where(d_obj < L_SPACE, d_obj, 0) if d_tid.size else d_obj
    mid = np.where(
        is_first, -1,
        mot_lookup[np.maximum(d_frm - 1, 0), safe_obj] if d_tid.size else 0,
    )
    # reference semantics (Optimizer.cc:1786-1789): a non-first observation
    # with no motion vertex is skipped entirely and breaks the chain
    kept = is_first | (mid >= 0)
    d_frm, d_fea, mid = d_frm[kept], d_fea[kept], mid[kept]
    is_first = is_first[kept]
    kept_any = d_frm.size > 0
    d_pid = n_static + np.arange(d_frm.size, dtype=np.int64)
    # ternary edge iff this obs and the chain predecessor (= previous kept
    # obs of the same track at the previous frame) both exist
    prev_kept = np.zeros(d_frm.size, bool)
    if kept_any:
        prev_kept[1:] = ~is_first[1:] & (d_frm[1:] == d_frm[:-1] + 1)

    dyn_xy = np.stack(m.dyn_xy)
    dyn_depth = np.stack(m.dyn_depth)
    dyn_3d = np.stack(m.dyn_3d)
    if kept_any:
        parts["obs_pose"] = np.concatenate(
            [parts["obs_pose"], d_frm.astype(np.int32)])
        parts["obs_point"] = np.concatenate(
            [parts["obs_point"], d_pid.astype(np.int32)])
        parts["obs_meas"] = np.concatenate([
            parts["obs_meas"],
            unproject_cols(dyn_xy[d_frm, d_fea], dyn_depth[d_frm, d_fea]),
        ])
        parts["obs_w"] = np.concatenate([
            parts["obs_w"],
            np.full(d_frm.size, 1.0 / be.full_sigma2_3d_dyn, np.float32),
        ])
        parts["ter_prev"] = (d_pid[prev_kept] - 1).astype(np.int32)
        parts["ter_cur"] = d_pid[prev_kept].astype(np.int32)
        parts["ter_mot"] = mid[prev_kept].astype(np.int32)
        parts["ter_w"] = np.full(int(prev_kept.sum()),
                                 1.0 / be.full_sigma2_obj, np.float32)
        pts_dyn = dyn_3d[d_frm, d_fea]
    else:
        pts_dyn = np.zeros((0, 3), np.float32)

    pts = np.concatenate([pts_static.reshape(-1, 3),
                          pts_dyn.reshape(-1, 3)]).astype(np.float32)
    if not pts.size:
        pts = np.zeros((1, 3), np.float32)
    P_pad = _apply_cap(be.full_point_cap, pts.shape[0], "points") \
        or pts.shape[0]
    M_pad = _apply_cap(be.full_motion_cap, n_motions, "motions") \
        or n_motions
    pts = np.concatenate(
        [pts, np.zeros((P_pad - pts.shape[0], 3), np.float32)])
    # Motion vertices start from the TRACKED per-frame estimates rather than
    # the reference's identity init (Optimizer.cc:1575-1582).  g2o runs up to
    # 300 exact-Cholesky LM iterations from identity; under this solver's
    # fixed chunked budget the identity init converges into a worse basin
    # (measured: refined obj-rotation RPE 12x worse than tracked, while the
    # tracked init lands in the same basin a GT init reaches and refines
    # BELOW the tracked error).  The tracked motions are available by
    # construction at full-BA time, so this is strictly more information.
    mots = np.tile(np.eye(4, dtype=np.float32), (M_pad, 1, 1))
    for mid, (fp, j) in enumerate(motion_slots):
        mots[mid] = np.asarray(m.rigid_motion[fp][j], np.float32)
    variables = Variables(
        poses=np.stack(m.cam_pose).astype(np.float32),
        motions=mots,
        points=pts,
    )
    sizes = {
        "E": _apply_cap(be.full_obs_cap, len(parts["obs_pose"]), "obs"),
        "Et": _apply_cap(be.full_ter_cap, len(parts["ter_prev"]), "ternary"),
        "Es": _apply_cap(be.full_smo_cap, len(parts["smo_a"]), "smooth"),
    }
    graph = _pad_graph(parts, N, M_pad, 4096, sizes=sizes)
    meta = GraphMeta(
        frame_ids=list(range(N)), static_tracks=[],
        n_static_points=n_static,
        dyn_obs=(d_frm.astype(np.int64), d_fea.astype(np.int64)),
        motion_slots=motion_slots, n_poses=N, n_motions=n_motions,
    )
    meta.stat_obs = (s_frm.astype(np.int64), s_fea.astype(np.int64),
                     s_pid.astype(np.int64))
    return graph, variables, meta


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
