"""Windowed (local) bundle adjustment — port of
vdo_slam_tpu/backend/window_ba.py (PartialBatchOptimization, Optimizer.cc:
42-1230, STATIC_ONLY=true at :211).

Refines the last WINDOW_SIZE camera poses and the static points of the
tracklets born inside the window, writes them back in place and recomputes
the camera motions (Optimizer.cc:1055-1144).  The fused tracker calls it
every WINDOW_SIZE - OVERLAP_SIZE archived frames (Tracking.cc:1168-1183).
`warmup_window_ba` is not ported: it compiled and first-executed the XLA
programs, and the eager port compiles nothing.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import VDOConfig
from ..pipeline.map_state import MapState
from .builders import _np_inv, build_window_graph
from .factor_graph import LMParams, fetch, lm_solve, lm_solve_schur, upload


def _lm_params(cfg: VDOConfig, iters: int | None = None) -> LMParams:
    be = cfg.backend
    return LMParams(
        iters=iters if iters is not None else min(be.local_iters, 12),
        cg_iters=be.cg_iters,
        cg_tol=be.cg_tol,
        lm_unroll=be.local_unroll,
        huber_delta=be.huber_delta,
        pose_huber_delta=be.pose_huber_delta,
        robust=be.robust_kernel,
    )


def _sync(device: torch.device) -> None:
    """Wait for the work queued on torch's current stream of `device`, the
    stream the solve was queued on, and for nothing else: a solve on a
    thread and stream of its own must not wait for the tracking steps."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def local_ba_inplace(m: MapState, cfg: VDOConfig, window: int | None = None,
                     iters: int | None = None, solver: str = "schur",
                     n_frames: int | None = None, device="cuda") -> dict:
    """n_frames pins the window end (see build_window_graph); write-back
    touches only frames < n_frames.  The solve's work goes to torch's
    current stream of `device`.  The report's phases: host graph build,
    upload and dispatch of the solve, the wait for that stream, the fetch
    of the results, and the write-back."""
    device = torch.device(device)
    t0 = time.perf_counter()
    graph, v0, meta = build_window_graph(m, cfg, window, n_frames=n_frames)
    p = _lm_params(cfg, iters)
    t1 = time.perf_counter()
    # static-only window: points couple only through obs edges, so the exact
    # dense-Schur direct solver applies
    solve = lm_solve_schur if solver == "schur" else lm_solve
    v, info = solve(*upload(graph, v0, device), p)
    t2 = time.perf_counter()
    _sync(device)
    t2b = time.perf_counter()
    # ONE device-to-host copy for everything the write-back and report need
    poses, points, cost0, cost, stats0, stats = fetch(
        (v.poses, v.points, info["cost0"], info["cost"], info["stats0"],
         info["stats"]))
    t3 = time.perf_counter()

    # write back refined camera poses and recomputed camera motions
    # (Optimizer.cc:1055-1082): vmCameraPose in place, motion = inv(P_a) P_b
    for i, f in enumerate(meta.frame_ids):
        m.cam_pose[f] = poses[i].astype(np.float32)
        if i > 0:
            m.rigid_motion[f - 1][0] = (
                _np_inv(poses[i - 1]) @ poses[i]
            ).astype(np.float32)

    # write back refined static points at every in-window observation
    # (Optimizer.cc:1107-1121); an archived array may be read-only
    s_frm, s_fea, s_pid = meta.stat_obs
    for f in meta.frame_ids:
        if not m.stat_3d[f].flags.writeable:
            m.stat_3d[f] = m.stat_3d[f].copy()
    for f in np.unique(s_frm):
        sel = s_frm == f
        m.stat_3d[f][s_fea[sel]] = points[s_pid[sel]]
    t4 = time.perf_counter()
    # per-edge-type chi2 + inlier breakdown (Optimizer.cc:640-970 analog)
    return {
        "cost0": float(cost0),
        "cost": float(cost),
        "n_points": meta.n_static_points,
        "window": len(meta.frame_ids),
        "n_tracks_dropped": meta.n_tracks_dropped,
        "edge_stats0": stats0,
        "edge_stats": stats,
        "t_build_ms": (t1 - t0) * 1e3,
        "t_dispatch_ms": (t2 - t1) * 1e3,
        "t_exec_ms": (t2b - t2) * 1e3,
        "t_fetch_ms": (t3 - t2b) * 1e3,
        "t_writeback_ms": (t4 - t3) * 1e3,
    }
