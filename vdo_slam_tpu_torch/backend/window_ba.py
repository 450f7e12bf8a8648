"""Windowed (local) bundle adjustment — port of
vdo_slam_tpu/backend/window_ba.py (PartialBatchOptimization, Optimizer.cc:
42-1230, STATIC_ONLY=true at :211).

Refines the last WINDOW_SIZE camera poses and the static points of the
tracklets born inside the window, writes them back in place and recomputes
the camera motions (Optimizer.cc:1055-1144).  The fused tracker calls it
every WINDOW_SIZE - OVERLAP_SIZE archived frames (Tracking.cc:1168-1183).

The solve runs as the JAX package's compiled window solve runs: each
window shape (one per builders.WINDOW_TIERS entry at the configured
window) and LM setting gets ONE CUDA graph of `lm_solve_schur`
(`WindowGraphs`, utils/cuda_graph.py), into whose static buffers the host
graph is copied in one transfer, and which is replayed on the caller's
stream; the results are fetched in one copy before the graph is free for
the next solve.  `warmup_window_ba` warms and captures every tier before
tracking starts, as the original compiles and first-executes them.  The
solver "lm" (matrix-free PCG) stays eager.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from ..config import VDOConfig
from ..pipeline.map_state import MapState
from ..utils.cuda_graph import GraphedCall, StaticTree, tree_flatten
from .builders import (WINDOW_TIERS, _np_inv, build_window_graph,
                       empty_window_graph)
from .factor_graph import (LMParams, device_like, fetch, lm_solve,
                           lm_solve_schur, upload)


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


class WindowGraphs:
    """The window solves' graphs on one device: one `lm_solve_schur` graph
    per window shape and LM setting, each with static input buffers, made
    at a shape's first solve (which runs eagerly, as the warm-up) and
    captured at its second.  One object serves every tracker that solves on
    `device` (the streams of a MultiStreamSystem group share it): a solve
    holds its graph's lock from the upload to the fetch, so the solves of
    two trackers on one shape take turns, and no graph replays while it
    runs."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._solves: dict = {}
        self._lock = threading.Lock()

    def _entry(self, graph, v0, p: LMParams):
        like = device_like(graph, v0)
        key = (tuple((x.dtype, tuple(x.shape))
                     for x in tree_flatten(like)[0]), p)
        with self._lock:
            if key not in self._solves:
                inputs = StaticTree(like, self.device)
                call = GraphedCall(
                    lambda: lm_solve_schur(*inputs.tree, p), self.device,
                    f"window solve P={v0.points.shape[0]} "
                    f"E={graph.obs_w.shape[0]} F={v0.poses.shape[0]} "
                    f"iters={p.iters}")
                self._solves[key] = (inputs, call)
            return self._solves[key]

    @contextlib.contextmanager
    def solve(self, graph, v0, p: LMParams):
        """Solve a builder's (graph, variables) on torch's current stream;
        yields (variables, info) as lm_solve_schur returns them, valid
        until the block ends."""
        inputs, call = self._entry(graph, v0, p)
        with call.lock:
            inputs.load_host((graph, v0))
            yield call()

    def records(self) -> list[dict]:
        """What each capture cost (GraphedCall.record), in capture order."""
        return [c.record for _, c in self._solves.values()
                if c.record is not None]


def warmup_window_ba(cfg: VDOConfig, graphs: WindowGraphs,
                     window: int | None = None,
                     iters: int | None = None) -> None:
    """Warm and capture the window solve at every builders.WINDOW_TIERS
    entry before tracking starts (vdo_slam_tpu/backend/window_ba.py:43-56
    compiles and first-executes them): each tier's zero-weight graph
    (builders.empty_window_graph, the shapes real window solves use) is
    solved twice, eagerly and then from its new graph."""
    p = _lm_params(cfg, iters)
    for tier in range(len(WINDOW_TIERS)):
        g, v = empty_window_graph(cfg, window, tier=tier)
        for _ in range(2):
            with graphs.solve(g, v, p):
                _sync(graphs.device)


def _sync(device: torch.device) -> None:
    """Wait for the work queued on torch's current stream of `device`, the
    stream the solve was queued on, and for nothing else: a solve on a
    thread and stream of its own must not wait for the tracking steps."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@contextlib.contextmanager
def _eager_lm(graph, v0, p: LMParams, device):
    yield lm_solve(*upload(graph, v0, device), p)


def local_ba_inplace(m: MapState, cfg: VDOConfig, window: int | None = None,
                     iters: int | None = None, solver: str = "schur",
                     n_frames: int | None = None, device="cuda",
                     graphs: WindowGraphs | None = None) -> dict:
    """n_frames pins the window end (see build_window_graph); write-back
    touches only frames < n_frames.  The solve's work goes to torch's
    current stream of `device`; solver "schur" runs from `graphs` (the
    caller's, shared by its solves; a WindowGraphs of this call's own if
    None, whose one solve runs eagerly as its warm-up).  The report's
    phases: host graph build, upload and dispatch of the solve, the wait
    for that stream, the fetch of the results, and the write-back."""
    device = torch.device(device)
    t0 = time.perf_counter()
    graph, v0, meta = build_window_graph(m, cfg, window, n_frames=n_frames)
    p = _lm_params(cfg, iters)
    t1 = time.perf_counter()
    # static-only window: points couple only through obs edges, so the exact
    # dense-Schur direct solver applies
    if solver == "schur":
        solving = (graphs or WindowGraphs(device)).solve(graph, v0, p)
    else:
        solving = _eager_lm(graph, v0, p, device)
    with solving as (v, info):
        t2 = time.perf_counter()
        _sync(device)
        t2b = time.perf_counter()
        # ONE device-to-host copy for everything the write-back and report
        # need, made before the graph may run the next solve
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
