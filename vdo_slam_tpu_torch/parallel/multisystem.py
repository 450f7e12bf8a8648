"""MultiStreamSystem — the whole pipeline for S camera streams at once;
port of vdo_slam_tpu/parallel/multisystem.py.

Every stream has its own append-only MapState archive, window-BA triggers
(Tracking.cc:1168-1183), metric reports and result files, so S-stream mode
behaves like S independent single-stream systems, while the per-frame
device work of all streams on a device is ONE batched step: one
(S, wire_len) upload, one wire decode, one FAST kernel launch, one mapped
body, one (S, n) output copy.

Each group steps as the fused tracker steps (pipeline/fused.py): its
stacked state lives in static buffers, frame 0 initializes eagerly, the
first tracked frame runs the batched track body eagerly as the warm-up,
the next one captures it into a CUDA graph (the JAX package's
`jax.jit(vmap(one))`, multisystem.py:55), and every later frame replays
it: the group's frame is one input copy per staged array, one draws
transfer and one graph launch (utils/cuda_graph.py:StepGraph).  Each
group captures its own graph on its own device.

Each stream owns a FusedTracker for its HOST half (staging of GT, archive,
window-BA trigger, reports), built without a step or a device state of its
own.  Stream s therefore archives what a solo FusedTracker on the same
frames archives: the same draws (a function of cfg.seed and the frame
index) and the same archive code; tests/test_torch_multistream.py holds
them together.

Streams over several devices (`devices`): the JAX package spreads the S
streams over a mesh of the largest divisor of S that is at most the number
of devices, with every stream's data sharded over it (multisystem.py:
62-76).  Here the same divisor n_dev splits the streams into n_dev
contiguous groups of S / n_dev, and group k's stacked state, upload,
batched step (one FAST launch) and output copy all live on devices[k]; one
process drives every group, as one JAX process drives the mesh
(vdo_slam_tpu_torch/devices.py says why not a process group).  The list
may repeat a device: one card (or the CPU) then runs the groups one after
another.  devices=None takes every visible card on a CUDA `device` (the
JAX package's jax.devices()), else [device].

Window solves run as in the JAX package: each stream's tracker queues its
solves on a background thread of its own (pipeline/fused.py), so S
streams that trigger on the same frame solve on S threads at once, each
on its group's device and on a CUDA stream of its own; `flush` joins
them all.  The solves replay the group's window-solve graphs
(backend/window_ba.py:WindowGraphs, warmed and captured when the system is
made), one solve of a shape at a time.

Against the JAX package besides: the drainer and uploader threads are
replaced by asynchronous pinned copies and CUDA events on the calling
thread, as in pipeline/fused.py: staging waited 0.02-0.04 ms per chunk on
the card and archiving takes ~0.5 ms a frame (PERF.md §5), so a thread
would have nothing to overlap.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from ..config import VDOConfig
from ..devices import device_list, on_device
from ..pipeline import draws as draws_mod
from ..utils.cuda_graph import StepGraph
from .multistream import (StreamState, _make_batched_step, make_stream_state,
                          stack_states)


def make_multistream_packed_step(cfg: VDOConfig, device="cuda"):
    """Batched packed-wire step: (states, inputs (S, ...), uniforms
    (S, ...), initialized) -> (states, vecs (S, n)), `vecs` the streams'
    packed output vectors (pipeline/fused.py:pack_outputs)."""
    # imported here: pipeline.fused imports parallel.multistream
    from ..pipeline.fused import pack_outputs

    return _make_batched_step(cfg, device, packed=True, finish=pack_outputs)


def stream_groups(n_streams: int, devices) -> list[tuple[torch.device,
                                                          range]]:
    """(device, streams) per group: n_dev, the largest divisor of
    n_streams that is at most len(devices) (the JAX package's rule,
    multisystem.py:71-74), contiguous groups of n_streams / n_dev, group k
    on devices[k]."""
    n_dev = max(d for d in range(1, len(devices) + 1) if n_streams % d == 0)
    per = n_streams // n_dev
    return [(devices[k], range(k * per, (k + 1) * per))
            for k in range(n_dev)]


@dataclasses.dataclass
class _Group:
    """The streams of one device: their host trackers, their eager batched
    step and its graph, which holds their stacked state, all on
    `device`."""

    device: torch.device
    streams: range
    trackers: list
    step: object
    graph: StepGraph

    @property
    def states(self) -> StreamState:
        """A copy of the group's stacked state."""
        return self.graph.state.snapshot()


class MultiStreamSystem:
    """S end-to-end pipelines over a list of devices (one group of streams
    per device; see the module docstring).

    datasets: one dataset per stream (lengths may differ; the run stops at
    the shortest).
    """

    def __init__(self, cfg: VDOConfig, n_streams: int,
                 enable_local_ba: bool = True, devices=None, device="cuda"):
        from ..pipeline.fused import FusedTracker

        self.cfg = cfg
        self.S = n_streams
        self.groups: list[_Group] = []
        # one host-side tracker per stream: staging, archive, window-BA
        # trigger, reports; none builds a step or a device state
        self.trackers = []
        for dev, streams in stream_groups(n_streams,
                                          device_list(devices, device)):
            trackers = [FusedTracker(cfg, device=dev, build_step=False)
                        for _ in streams]
            self.trackers += trackers
            states = stack_states([make_stream_state(cfg, dev)
                                   for _ in streams])
            step = make_multistream_packed_step(cfg, dev)
            self.groups.append(_Group(
                dev, streams, trackers, step,
                StepGraph(step, states, dev,
                          f"S-stream step, streams {streams.start}-"
                          f"{streams.stop - 1}", streams=len(streams))))
        self.device = self.groups[0].device
        # per device, the window solves' graphs, which the trackers solving
        # there share (backend/window_ba.py:WindowGraphs)
        self.window_graphs: dict = {}
        if enable_local_ba:
            from ..backend.window_ba import (WindowGraphs, local_ba_inplace,
                                             warmup_window_ba)

            for g in self.groups:
                graphs = self.window_graphs.get(g.device)
                if graphs is None:
                    graphs = self.window_graphs[g.device] = WindowGraphs(
                        g.device)
                    if g.device.type == "cuda":
                        with on_device(g.device):
                            warmup_window_ba(cfg, graphs)
                for t in g.trackers:
                    t.local_ba_hook = (
                        lambda m, n_frames=None, dev=g.device, wg=graphs:
                        local_ba_inplace(m, cfg, n_frames=n_frames,
                                         device=dev, graphs=wg))
        self.initialized = False
        self.frame_id = 0
        self._generator = torch.Generator()   # CPU: pipeline/draws.py
        # frames whose output copies are queued but not archived yet
        self._pending: deque = deque()
        self.drain_every = max(int(cfg.tracking.fused_drain_chunks), 1)

    @property
    def maps(self):
        return [t.map for t in self.trackers]

    def _stage(self, fds) -> list[dict]:
        """Per group, one stacked (S / n_dev, wire_len) packed upload of its
        streams to its device."""
        out = []
        for g in self.groups:
            lead = g.trackers[0]
            mine = [fds[s] for s in g.streams]
            gts = [t._gt_pose(fd.pose_gt_raw)
                   for t, fd in zip(g.trackers, mine)]
            sems = [t._stage_gt_sems(fd) for t, fd in zip(g.trackers, mine)]
            out.append({
                "packed": lead._put(np.stack([lead.wire(fd) for fd in mine]),
                                    np.int16),
                "T_cw_gt": lead._put(np.stack(gts), np.float32),
                "gt_sems": lead._put(np.stack(sems), np.int32),
                "_gts_host": gts,
            })
        return out

    def _frame_draws(self, fid: int) -> list[dict]:
        """Frame fid's draws, per group on its device, for the eager
        batched step (`_Group.step`).  The trackers share
        one config, hence one seed, so all streams draw the same numbers,
        as a solo tracker on each stream would: drawn once per group and
        broadcast over its streams."""
        out = []
        for g in self.groups:
            u = g.trackers[0].frame_draws(fid)
            out.append({k: v.expand((len(g.streams),) + tuple(v.shape))
                        for k, v in u.items()})
        return out

    def step_frame(self, fds, staged: list | None = None,
                   sync: bool = True) -> list:
        """One frame of every stream, ONE batched step per group; archives
        per stream and returns the per-stream reports.

        sync=False pipelines the output drain: the frame's (S, n) vectors
        start an asynchronous copy per group, every `drain_every`-th frame
        the accumulated frames are archived, and the return value is the
        list of the frames archived by this call (a list of per-stream
        report lists).  Call flush() at the end of the run."""
        t0 = time.perf_counter()
        staged = staged if staged is not None else self._stage(fds)
        fid = self.frame_id
        # one draw for every stream, as a solo tracker on each would draw
        u = draws_mod.frame_uniforms(self.cfg, fid, self._generator)
        gts, vecs = [], []
        for g, st in zip(self.groups, staged):
            st = dict(st)
            gts += st.pop("_gts_host")
            with on_device(g.device):
                vecs.append(g.graph(st, u, self.initialized))
        self.initialized = True
        self.frame_id += 1
        for t in self.trackers:
            t.frame_id = fid + 1
        if sync:
            return self._archive_frame(
                fds, gts, fid, np.concatenate([v.cpu().numpy() for v in vecs]),
                t0)
        copies = [g.trackers[0]._to_host(v) for g, v in zip(self.groups, vecs)]
        self._pending.append((list(fds), gts, fid, copies, t0))
        if len(self._pending) >= self.drain_every:
            return self._drain_batch()
        return []

    def _archive_frame(self, fds, gts, fid, vecs_np, t0) -> list[dict]:
        return [t._finish_frame(fds[s], gts[s], fid, vecs_np[s], t0)
                for s, t in enumerate(self.trackers)]

    def _drain_batch(self) -> list[list[dict]]:
        """Archive every pending frame, per stream, in frame order.  Each
        group's copies were queued in order on its device's stream, so the
        last frame's events cover all."""
        batch = list(self._pending)
        self._pending.clear()
        if batch:
            for _, done in batch[-1][3]:
                if done is not None:
                    done.synchronize()
        return [self._archive_frame(
                    fds, gts, fid,
                    np.concatenate([host.numpy() for host, _ in copies]), t0)
                for fds, gts, fid, copies, t0 in batch]

    def flush(self) -> list[list[dict]]:
        """Archive every in-flight frame, in order, and join every stream's
        window solves."""
        done = self._drain_batch()
        for t in self.trackers:
            t._join_ba()
        return done

    def run(self, datasets, max_frames: int | None = None,
            verbose: bool = False) -> list[list[dict]]:
        """Drive all streams to the shortest dataset's end; returns
        per-stream report lists."""
        assert len(datasets) == self.S, (len(datasets), self.S)
        n = min(len(d) for d in datasets)
        if max_frames is not None:
            n = min(n, max_frames)
        all_reps: list[list[dict]] = [[] for _ in range(self.S)]

        def show(frame_reps):
            for s, r in enumerate(frame_reps):
                all_reps[s].append(r)
            if verbose and "t_rpe" in frame_reps[0]:
                print(f"frame {frame_reps[0]['frame_id']}: " + "  ".join(
                    f"s{s}: t={r['t_rpe']:.4f}"
                    for s, r in enumerate(frame_reps)))

        staged = self._stage([d[0] for d in datasets]) if n else None
        for i in range(n):
            fds = [d[i] for d in datasets]
            done = self.step_frame(fds, staged, sync=False)
            # the next frame's upload queues behind the step just queued
            staged = (self._stage([d[i + 1] for d in datasets])
                      if i + 1 < n else None)
            for frame_reps in done:
                show(frame_reps)
        for frame_reps in self.flush():
            show(frame_reps)
        return all_reps

    def metrics(self, refined: bool = False) -> dict:
        """Per-stream metric reports + cross-stream aggregate."""
        from ..eval.results import metric_report

        per = [metric_report(t.map, refined=refined) for t in self.trackers]
        agg = {}
        for k in per[0]:
            vals = [p[k] for p in per]
            agg[k] = (float(np.sum(vals)) if k == "n_obj_estimates"
                      else float(np.mean(vals)))
        return {"per_stream": per, "aggregate": agg}

    def save_results(self, out_dir) -> None:
        """One reference-format results directory per stream."""
        from ..eval.results import save_results

        for s, t in enumerate(self.trackers):
            save_results(t.map, Path(out_dir) / f"stream_{s}")
