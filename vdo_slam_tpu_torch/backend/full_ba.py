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
runs.  Either runs from CUDA graphs where the caller passes a
`FullBAGraphs` made for the same device list: one graph of the LM chunk
(factor_graph._lm over the edge shards, `lm_solve` for one device) per
input shape, shard count and chunk length, as the original compiles one
executable per shape (`warmup_full_ba` warms and captures them on a
zero-weight graph of the configured caps, as the original compiles and
first-executes its program).  A list that names distinct cards gets no
graphs (a capture would have to fork every other card's stream into the
first one's, which has not been run on a machine with several cards):
its sharded solve runs eagerly, and only there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

from ..config import VDOConfig
from ..devices import device_list
from ..ops import edge_hessian_cuda
from ..pipeline.map_state import MapState
from ..utils import profiling
from ..utils.cuda_graph import GraphedCall, StaticTree, tree_flatten
from .builders import build_full_graph_on, empty_full_graph
from .factor_graph import (LMParams, Variables, _chunked, _lam, _lm,
                           _shard_edges, fetch, lm_solve, upload)

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


def _card(d: torch.device) -> tuple:
    """The card (or the CPU) a device names: "cuda" is the current card."""
    if d.type == "cuda" and d.index is None:
        return d.type, (torch.cuda.current_device()
                        if torch.cuda.is_available() else 0)
    return d.type, d.index


def one_card(devices) -> bool:
    """Whether a device list (devices.py:device_list) names one card or
    the CPU only, however often."""
    return len({_card(d) for d in devices}) == 1


class FullBAGraphs:
    """The full BA's graphs on a device list that names one card (or the
    CPU), repeated or not: one graph of the LM chunk per input shape,
    shard count and chunk LMParams (the full chunk and the tail chunk of a
    solve), made at a key's first chunk (which runs eagerly, as the
    warm-up) and captured at its second.  Over n > 1 devices the edges are
    padded and sharded once per solve, on the card, into static buffers,
    and the graph runs factor_graph._lm over the n shards, as
    lm_solve_sharded_chunked does; over one, `lm_solve`.  The graphs of
    one shape read one set of static inputs: the edge arrays, loaded once
    per solve, and the variables and the damping, loaded for each chunk
    (the last chunk's outputs, which the next replay overwrites).  A solve
    holds the object's lock from its upload to its fetch.  A list that
    names distinct cards raises ValueError: their sharded solve stays
    eager (full_ba_inplace without graphs)."""

    def __init__(self, devices):
        self.devices = device_list(
            devices if isinstance(devices, (list, tuple)) else [devices])
        if not one_card(self.devices):
            raise ValueError(
                f"FullBAGraphs over {[str(d) for d in self.devices]}: "
                f"distinct cards are not captured into one graph; call "
                f"full_ba_inplace without graphs (the eager sharded solve)")
        self.device = self.devices[0]
        self._inputs: dict = {}
        self._calls: dict = {}
        self._lock = threading.Lock()
        # what each chunk call did (GraphedCall.next_call), in call order
        self.modes: list[str] = []

    @contextlib.contextmanager
    def solver(self, graph, v0, p: LMParams):
        """Load a (graph, variables) into the static inputs of their shape:
        a builder's device tensors on this object's card (build_full_graph_on)
        by one copy on the card, a builder's host arrays (empty_full_graph)
        by one transfer first (factor_graph.upload); the edges sharded over
        the device list on the card, the damping set to p.lambda_init.
        Yields (v0, solve): v0 the variables' static buffers, and solve(v,
        p_chunk, lam) -> (v, info) for factor_graph._chunked, the LM chunk
        from the graph of p_chunk, whose outputs are valid until its next
        call or the block's end."""
        n = len(self.devices)
        if not torch.is_tensor(graph.obs_w):
            graph, v0 = upload(graph, v0, self.device)
        # the shards as lm_solve_sharded_chunked makes them
        shards = [graph] if n == 1 else _shard_edges(graph,
                                                     [self.device] * n)
        key = tuple((x.dtype, tuple(x.shape))
                    for x in tree_flatten((shards, v0))[0])
        with self._lock:
            if key not in self._inputs:
                self._inputs[key] = (
                    StaticTree(shards, self.device),
                    StaticTree((v0, torch.empty(())), self.device))
            edges, state = self._inputs[key]
            edges.load(shards)
            state.load((v0, torch.full((), p.lambda_init,
                                       dtype=torch.float32,
                                       device=self.device)))

            def solve(v, pc: LMParams, lam):
                state.load((v, lam))
                if (key, pc) not in self._calls:
                    self._calls[key, pc] = GraphedCall(
                        lambda: _lm(list(edges.tree), state.tree[0], pc,
                                    lam0=state.tree[1]),
                        self.device,
                        f"full BA F={v0.poses.shape[0]} "
                        f"P={v0.points.shape[0]} "
                        f"E={graph.obs_w.shape[0]} iters={pc.iters}"
                        + (f" shards={n}" if n > 1 else ""))
                call = self._calls[key, pc]
                self.modes.append(call.next_call())
                return call()

            yield state.tree[0], solve

    def records(self) -> list[dict]:
        """What each capture cost (GraphedCall.record), in capture order."""
        return [c.record for c in self._calls.values()
                if c.record is not None]


def _chunk_lengths(p: LMParams, chunk: int) -> list[int]:
    """The distinct chunk lengths of a p.iters solve in chunks of `chunk`:
    the full chunk, and the tail where p.iters is not a multiple."""
    return [chunk] + ([p.iters % chunk] if p.iters % chunk else [])


def warmup_full_ba(cfg: VDOConfig, n_frames: int,
                   graphs: FullBAGraphs) -> None:
    """Warm and capture the full-BA graphs on a zero-weight graph with the
    exact shapes full_ba_inplace will use for an n_frames archive
    (vdo_slam_tpu/backend/full_ba.py:73-88 compiles and first-executes the
    program), sharded over the graphs' device list as the real solve is:
    each chunk length of the solve is solved twice, eagerly and then from
    its new graph, with the LMParams of the real solve (the CG budget
    scaled by the padded observation count), so that the real solve
    replays them.  Raises ValueError if the full_* caps are unset."""
    g, v = empty_full_graph(cfg, n_frames)
    p = scaled_lm_params(cfg, g.obs_w.shape[0])
    with graphs.solver(g, v, p) as (v0, solve):
        for n in _chunk_lengths(p, min(cfg.backend.full_ba_chunk, p.iters)):
            for _ in range(2):
                _, info = solve(v0, dataclasses.replace(p, iters=n),
                                _lam(p, v0.points))
                fetch(info["cost"])     # waits for the solve


def graphs_for(device="cuda", devices=None) -> FullBAGraphs | None:
    """A FullBAGraphs for full_ba_inplace(device=device, devices=devices):
    over the device list that call solves on, or None where that list
    names distinct cards (its sharded solve runs eagerly)."""
    devices = device_list(devices, device)
    return FullBAGraphs(devices) if one_card(devices) else None


def full_ba_inplace(m: MapState, cfg: VDOConfig, iters: int | None = None,
                    device="cuda", devices=None,
                    graphs: FullBAGraphs | None = None) -> dict:
    """The full-batch solve of the map `m`, written back in place; returns
    its report.  `devices` (devices.py:device_list; None takes every
    visible card when `device` is CUDA): more than one shards the edges
    over them, one runs the single-device solve on it.  Each chunk runs
    from `graphs` where given, which must be made for this device list
    (`graphs_for`; ValueError otherwise); without, eagerly.  The graph
    is built on the first device (builders.build_full_graph_on) and
    stays there; the g2o dump holds it.

    The report says whether every configured full_* cap held (`caps_held`,
    each cap's counts under `caps`) and how each chunk ran
    (`chunk_modes`: "replay", "capture" or "warm" from a graph, "eager"
    without one or off a card).  While a recorder is on
    (utils/profiling.py) the solve is the span full.refine (unit: the
    archive's frames) over full.build (which ends once the graph is
    complete on the device), full.upload, one full.chunk per
    LM chunk (unit: its index; it ends after the chunk's gain test, which
    waits for the card where full_gain_thres > 0), full.fetch and
    full.writeback, and it counts the graph's sizes (full.<caps key>,
    real, and full.<caps key>_padded), full.caps_held, full.iters_run,
    full.cg_iters (CG iterations per LM iteration), full.build_h2d_bytes
    (the archive's bytes the build copied to the device), full.chain_rounds
    (the build's pointer-jumping rounds per chaining) and full.chunk (how
    each chunk ran, unit: its index); on a card also full.hv_launches, the
    edge Hessian kernel's launches while the solve ran (one per edge type
    with edges, per CG step, per shard: edge types x cg_iters x iters_run
    on one device), and full.lin_launches, the linearise and evaluate
    kernels' (one per large edge type with edges, per linearisation and
    per evaluation, per shard: 2 x (2 x iters_run + chunks) on one
    device)."""
    devices = device_list(devices, device)
    if graphs is not None and [_card(d) for d in graphs.devices] != [
            _card(d) for d in devices]:
        raise ValueError(f"graphs for {[str(d) for d in graphs.devices]}, "
                         f"a solve over {[str(d) for d in devices]}")
    with profiling.span("full.refine", m.num_frames):
        return _full_ba(m, cfg, iters, devices, graphs)


def _full_ba(m: MapState, cfg: VDOConfig, iters, devices,
             graphs: FullBAGraphs | None) -> dict:
    t0 = time.perf_counter()
    # the last refine's graph goes before this one is built; this one is
    # built on the solve's (first) device, and the span ends with the
    # build's copy of the write-back's indices, which waits for the graph
    m.g2o_dump = None
    with profiling.span("full.build", m.num_frames, cpu=True):
        graph, v0, meta = build_full_graph_on(m, cfg, devices[0])
    p = scaled_lm_params(cfg, graph.obs_w.shape[0], iters)
    chunk = min(cfg.backend.full_ba_chunk, p.iters)
    for name, c in meta.caps.items():
        profiling.count(f"full.{name}", c["n"])
        profiling.count(f"full.{name}_padded", c["padded"])
    profiling.count("full.caps_held", meta.caps_held)
    profiling.count("full.cg_iters", p.cg_iters)
    profiling.count("full.build_h2d_bytes", meta.h2d_bytes)
    profiling.count("full.chain_rounds", meta.chain_rounds)
    chunk_times = []
    modes = []
    hv0 = edge_hessian_cuda.KERNEL.launches
    lin0 = edge_hessian_cuda.LIN.launches
    rec = profiling.ACTIVE
    open_chunk = []

    def mark(i, _):
        chunk_times.append(time.perf_counter())
        if rec is not None:
            rec.end(open_chunk.pop())

    with contextlib.ExitStack() as held:
        # the graphs load the graph into their static inputs (one copy on
        # the card) and hold their lock until the fetch; the sharded solve
        # pads and shards it once
        with profiling.span("full.upload", m.num_frames):
            if graphs is not None:
                v0, solve = held.enter_context(graphs.solver(graph, v0, p))
            else:
                if len(devices) > 1:
                    # eager: no graphs passed, as over distinct cards
                    shards = _shard_edges(graph, devices)

                    def solve(v, pc, lam):
                        return _lm(shards, v, pc, lam)
                else:
                    def solve(v, pc, lam):
                        return lm_solve(graph, v, pc, lam0=lam)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()

        def chunk_solve(v, pc, lam):
            if rec is not None:
                open_chunk.append(rec.begin("full.chunk", len(chunk_times)))
            out = solve(v, pc, lam)
            modes.append(graphs.modes[-1] if graphs is not None
                         else "eager")
            return out

        v, info = _chunked(chunk_solve, v0, p, chunk, mark)
        # ONE device-to-host copy
        with profiling.span("full.fetch", m.num_frames):
            poses, motions, points, cost0, cost, stats0, stats = fetch(
                (v.poses, v.motions, v.points, info["cost0"], info["cost"],
                 info["stats0"], info["stats"]))
    t_solve = time.perf_counter() - t0
    profiling.count("full.iters_run", info["iters_run"])
    if devices[0].type == "cuda":
        profiling.count("full.hv_launches",
                        edge_hessian_cuda.KERNEL.launches - hv0)
        profiling.count("full.lin_launches",
                        edge_hessian_cuda.LIN.launches - lin0)
    for i, mode in enumerate(modes):
        profiling.count("full.chunk", mode, i)
    t0 = time.perf_counter()

    with profiling.span("full.writeback", m.num_frames):
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
    # (Optimizer.cc:1935-1936), on the solve's device until written
    m.g2o_dump = {
        "graph": graph,
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
        "cg_iters": p.cg_iters,
        # every edge type's size in the solved (padded) graph
        "edges": {name: int(getattr(graph, w).shape[0])
                  for name, w in (("obs", "obs_w"), ("odo", "odo_w"),
                                  ("pri", "pri_w"), ("smo", "smo_w"),
                                  ("ter", "ter_w"), ("alt", "alt_w"))},
        "caps": meta.caps,
        "caps_held": meta.caps_held,
        "build_h2d_bytes": meta.h2d_bytes,
        "chain_rounds": meta.chain_rounds,
        "chunk_modes": list(modes),
        "t_build_s": t_build,
        "t_solve_s": t_solve,
        "t_writeback_s": t_wb,
        "chunk_times": [t - chunk_times[0] for t in chunk_times],
    }
