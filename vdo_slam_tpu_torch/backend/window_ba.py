"""Windowed (local) bundle adjustment — port of
vdo_slam_tpu/backend/window_ba.py (PartialBatchOptimization, Optimizer.cc:
42-1230, STATIC_ONLY=true at :211).

Refines the last WINDOW_SIZE camera poses and the static points of the
tracklets born inside the window, writes them back in place and recomputes
the camera motions (Optimizer.cc:1055-1144).  The fused tracker calls it
every WINDOW_SIZE - OVERLAP_SIZE archived frames (Tracking.cc:1168-1183).

The solve runs as the JAX package's compiled window solve runs: each
window shape (one per builders.WINDOW_TIERS entry at the configured
window), solver and LM setting gets ONE CUDA graph (`WindowGraphs`,
utils/cuda_graph.py) of `lm_solve_schur` (solver "schur", the dense-Schur
direct solve every System uses) or `lm_solve` (solver "lm", matrix-free
PCG), into whose static buffers the host graph is copied in one transfer,
and which is replayed on the caller's stream; the results are fetched in
one copy before the graph is free for the next solve.  `warmup_window_ba`
warms and captures every "schur" tier before tracking starts, as the
original compiles and first-executes them; an "lm" tier runs eagerly at
its first solve and captures at its second, as `jax.jit` compiles at the
first call.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from ..config import VDOConfig
from ..pipeline.map_state import MapState
from ..utils import profiling
from ..utils.cuda_graph import GraphedCall, StaticTree, tree_flatten
from .builders import (WINDOW_TIERS, _np_inv, build_window_graph,
                       empty_window_graph)
from .factor_graph import (LMParams, device_like, fetch, lm_solve,
                           lm_solve_schur)


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


# the window solvers, each (graph, variables, LMParams) -> (v, info): as in
# the JAX package (window_ba.py:74), "schur" names the dense-Schur solve
# and any other name ("lm", "pcg") the matrix-free LM
SOLVERS = {"schur": lm_solve_schur, "lm": lm_solve}


def _solver_name(solver: str) -> str:
    return "schur" if solver == "schur" else "lm"


class WindowGraphs:
    """The window solves' graphs on one device: one graph of a SOLVERS
    entry per window shape, solver and LM setting, each with static input
    buffers, made at a key's first solve (which runs eagerly, as the
    warm-up) and captured at its second.  One object serves every tracker
    that solves on `device` (the streams of a MultiStreamSystem group
    share it): a solve
    holds its graph's lock from the upload to the fetch, so the solves of
    two trackers on one shape take turns, and no graph replays while it
    runs."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._solves: dict = {}
        self._lock = threading.Lock()

    def _entry(self, graph, v0, p: LMParams, solver: str):
        solver = _solver_name(solver)
        fn = SOLVERS[solver]
        like = device_like(graph, v0)
        key = (tuple((x.dtype, tuple(x.shape))
                     for x in tree_flatten(like)[0]), solver, p)
        with self._lock:
            if key not in self._solves:
                inputs = StaticTree(like, self.device)
                call = GraphedCall(
                    lambda: fn(*inputs.tree, p), self.device,
                    f"window solve P={v0.points.shape[0]} "
                    f"E={graph.obs_w.shape[0]} F={v0.poses.shape[0]} "
                    f"iters={p.iters}"
                    + ("" if solver == "schur" else f" solver={solver}"))
                self._solves[key] = (inputs, call)
            return self._solves[key]

    @contextlib.contextmanager
    def solve(self, graph, v0, p: LMParams, solver: str = "schur"):
        """Solve a builder's (graph, variables) with the solver named
        `solver` (SOLVERS) on torch's current stream; yields (variables,
        info) as the solver returns them, valid until the block ends."""
        inputs, call = self._entry(graph, v0, p, solver)
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


def local_ba_inplace(m: MapState, cfg: VDOConfig, window: int | None = None,
                     iters: int | None = None, solver: str = "schur",
                     n_frames: int | None = None, device="cuda",
                     graphs: WindowGraphs | None = None) -> dict:
    """n_frames pins the window end (see build_window_graph); write-back
    touches only frames < n_frames.  The solve's work goes to torch's
    current stream of `device`; the solver (SOLVERS: "schur", else "lm")
    runs from `graphs` (the caller's, shared by its solves; a WindowGraphs
    of this call's own if None, whose one solve runs eagerly as its
    warm-up).  The report's phases: host graph build, upload and dispatch
    of the solve, the wait for that stream, the fetch of the results, and
    the write-back; while a recorder is on (utils/profiling.py) each is
    also a span of the same clock reads, `window.build` (with the
    thread's CPU time) .. `window.writeback`, a child of the span open on
    the calling thread (the solve thread's `window.solve`).  The report's
    `build_frames` is the number of archive frames the build read."""
    device = torch.device(device)
    rec = profiling.ACTIVE
    end = m.num_frames if n_frames is None else n_frames   # the spans' unit
    t0 = time.time_ns()
    cpu0 = time.thread_time_ns() if rec is not None else 0
    graph, v0, meta = build_window_graph(m, cfg, window, n_frames=n_frames)
    p = _lm_params(cfg, iters)
    cpu1 = time.thread_time_ns() if rec is not None else 0
    t1 = time.time_ns()
    # static-only window: points couple only through obs edges, so the exact
    # dense-Schur direct solver applies
    solving = (graphs or WindowGraphs(device)).solve(graph, v0, p, solver)
    with solving as (v, info):
        t2 = time.time_ns()
        _sync(device)
        t2b = time.time_ns()
        # ONE device-to-host copy for everything the write-back and report
        # need, made before the graph may run the next solve
        poses, points, cost0, cost, stats0, stats = fetch(
            (v.poses, v.points, info["cost0"], info["cost"], info["stats0"],
             info["stats"]))
    t3 = time.time_ns()

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
    t4 = time.time_ns()
    if rec is not None:
        rec.add("window.build", t0, t1, end, cpu_ns=cpu1 - cpu0)
        rec.add("window.dispatch", t1, t2, end)
        rec.add("window.exec_wait", t2, t2b, end)
        rec.add("window.fetch", t2b, t3, end)
        rec.add("window.writeback", t3, t4, end)
    # per-edge-type chi2 + inlier breakdown (Optimizer.cc:640-970 analog)
    return {
        "cost0": float(cost0),
        "cost": float(cost),
        "n_points": meta.n_static_points,
        "window": len(meta.frame_ids),
        "n_tracks_dropped": meta.n_tracks_dropped,
        "build_frames": meta.build_frames,
        "edge_stats0": stats0,
        "edge_stats": stats,
        "t_build_ms": (t1 - t0) / 1e6,
        "t_dispatch_ms": (t2 - t1) / 1e6,
        "t_exec_ms": (t2b - t2) / 1e6,
        "t_fetch_ms": (t3 - t2b) / 1e6,
        "t_writeback_ms": (t4 - t3) / 1e6,
    }
