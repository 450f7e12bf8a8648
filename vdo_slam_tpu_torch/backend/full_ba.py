"""Full-batch dynamic-SLAM optimization — port of
vdo_slam_tpu/backend/full_ba.py (FullBatchOptimization, Optimizer.cc:
1232-2175).

End-of-run refinement over the whole archive: camera chain + static
structure + per-frame-per-object motion vertices with ternary point-motion
factors and smoothness, solved by matrix-free LM+PCG in chunks of
BackendConfig.full_ba_chunk iterations (the chunk boundaries are where the
g2o gain threshold is tested; factor_graph.lm_solve_chunked).  Refined
camera poses go to cam_pose_rf and motions to rigid_motion_rf
(Optimizer.cc:2094-2172); points are refined in place.

With more than one device the edges are sharded over all of them
(factor_graph.lm_solve_sharded_chunked), as the original shards them over
`jax.devices()`; the devices are a list driven from this one process (the
factor_graph module says why).  With one device the plain chunked solve
runs.  Not ported: `warmup_full_ba`, which compiled the XLA program ahead
of time.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..config import VDOConfig
from ..devices import device_list
from ..pipeline.map_state import MapState
from .builders import build_full_graph
from .factor_graph import (LMParams, Variables, fetch, lm_solve_chunked,
                           lm_solve_sharded_chunked, upload)

# LM iterations per chunk by default (BackendConfig.full_ba_chunk): the
# gain test runs at chunk boundaries only (full_ba.py:25-34)
FULL_BA_CHUNK = 3


def _lm_params(cfg: VDOConfig, iters: int | None = None) -> LMParams:
    be = cfg.backend
    return LMParams(
        iters=iters if iters is not None else be.full_iters,
        cg_iters=be.cg_iters,
        cg_tol=be.cg_tol,
        cg_unroll=be.cg_unroll,
        huber_delta=be.huber_delta,
        pose_huber_delta=be.pose_huber_delta,
        robust=be.robust_kernel,
        gain_eps=be.full_gain_thres * 10,  # cross-chunk stop
    )


def _scaled_cg(cg: int, n_obs: int) -> int:
    """The PCG budget stepped up as the graph shrinks (the original's
    rule): small graphs under-converge at the bench graph's budget, and
    their CG iterations are cheap.  n_obs is the PADDED observation count,
    so the full-graph caps change the budget."""
    if n_obs < 32768:
        return max(cg, 48)
    if n_obs < 131072:
        return max(cg, 24)
    return cg


def scaled_lm_params(cfg: VDOConfig, n_obs: int,
                     iters: int | None = None) -> LMParams:
    """LMParams with the size-scaled CG budget for a graph whose (padded)
    camera-observation edge count is n_obs."""
    p = _lm_params(cfg, iters)
    return dataclasses.replace(p, cg_iters=_scaled_cg(p.cg_iters, n_obs))


def full_ba_inplace(m: MapState, cfg: VDOConfig, iters: int | None = None,
                    device="cuda", devices=None) -> dict:
    """The full-batch solve of the map `m`, written back in place; returns
    its report.  `devices` (devices.py:device_list; None takes every
    visible card when `device` is CUDA): more than one shards the edges
    over them, one runs the single-device solve on it."""
    devices = device_list(devices, device)
    t0 = time.perf_counter()
    graph_host, v0, meta = build_full_graph(m, cfg)
    p = scaled_lm_params(cfg, graph_host.obs_w.shape[0], iters)
    # one copy for all chunks; the sharded solve pads and shards it once
    graph, v0 = upload(graph_host, v0, devices[0])
    chunk = min(cfg.backend.full_ba_chunk, p.iters)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    chunk_times = []

    def mark(i, _):
        chunk_times.append(time.perf_counter())

    if len(devices) > 1:
        v, info = lm_solve_sharded_chunked(graph, v0, p, devices,
                                           chunk=chunk, callback=mark)
    else:
        v, info = lm_solve_chunked(graph, v0, p, chunk=chunk, callback=mark)
    # ONE device-to-host copy
    poses, motions, points, cost0, cost, stats0, stats = fetch(
        (v.poses, v.motions, v.points, info["cost0"], info["cost"],
         info["stats0"], info["stats"]))
    t_solve = time.perf_counter() - t0
    t0 = time.perf_counter()

    for f in range(m.num_frames):
        m.cam_pose_rf[f] = poses[f].astype(np.float32)
    for mid, (fp, j) in enumerate(meta.motion_slots):
        m.rigid_motion_rf[fp][j] = motions[mid].astype(np.float32)
    # vectorized point write-back over the flat observation arrays
    s_frm, s_fea, s_pid = meta.stat_obs
    big = np.stack(m.stat_3d)
    big[s_frm, s_fea] = points[s_pid]
    for f in range(m.num_frames):
        m.stat_3d[f] = big[f]
    d_frm, d_fea = meta.dyn_obs
    big = np.stack(m.dyn_3d)
    big[d_frm, d_fea] = points[meta.n_static_points:
                               meta.n_static_points + d_frm.size]
    for f in range(m.num_frames):
        m.dyn_3d[f] = big[f]
    t_wb = time.perf_counter() - t0
    # the optimized graph for save_results' dynamic_slam_graph_after_opt.g2o
    # (Optimizer.cc:1935-1936)
    m.g2o_dump = {
        "graph": graph_host,
        "v": Variables(poses=poses, motions=motions, points=points),
        "n_poses": m.num_frames,
        "n_motions": meta.n_motions,
        "n_points": meta.n_static_points + int(meta.dyn_obs[0].size),
    }
    # per-edge-type chi2 + inlier breakdown (Optimizer.cc:1938-2091 analog)
    return {
        "cost0": float(cost0),
        "cost": float(cost),
        "n_static": meta.n_static_points,
        "n_dyn": int(meta.dyn_obs[0].size),
        "n_motions": meta.n_motions,
        "edge_stats0": stats0,
        "edge_stats": stats,
        "iters_run": info.get("iters_run"),
        "t_build_s": t_build,
        "t_solve_s": t_solve,
        "t_writeback_s": t_wb,
        "chunk_times": [t - chunk_times[0] for t in chunk_times],
    }
