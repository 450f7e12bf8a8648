"""MultiStreamSystem — the whole pipeline for S camera streams at once;
port of vdo_slam_tpu/parallel/multisystem.py.

Every stream has its own append-only MapState archive, window-BA triggers
(Tracking.cc:1168-1183), metric reports and result files, so S-stream mode
behaves like S independent single-stream systems, while the per-frame
device work of all streams is ONE batched step: one (S, wire_len) upload,
one wire decode, one FAST kernel launch, one mapped body, one (S, n)
output copy.

Each stream owns a FusedTracker for its HOST half (staging of GT, archive,
window-BA trigger, reports), built without a step or a device state of its
own.  Stream s therefore archives what a solo FusedTracker on the same
frames archives: the same draws (a function of cfg.seed and the frame
index) and the same archive code; tests/test_torch_multistream.py holds
them together.

Against the JAX package: one device holds all S streams (no Mesh, nothing
is sharded; `devices` with more than one entry raises); the drainer and
uploader threads are replaced by asynchronous pinned copies and CUDA
events on the calling thread, as in pipeline/fused.py.
"""

from __future__ import annotations

import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from ..config import VDOConfig
from .multistream import (_make_batched_step, make_stream_state,
                          stack_states)


def make_multistream_packed_step(cfg: VDOConfig, device="cuda"):
    """Batched packed-wire step: (states, inputs (S, ...), uniforms
    (S, ...), initialized) -> (states, vecs (S, n)), `vecs` the streams'
    packed output vectors (pipeline/fused.py:pack_outputs)."""
    # imported here: pipeline.fused imports parallel.multistream
    from ..pipeline.fused import pack_outputs

    return _make_batched_step(cfg, device, packed=True, finish=pack_outputs)


class MultiStreamSystem:
    """S end-to-end pipelines on one device.

    datasets: one dataset per stream (lengths may differ; the run stops at
    the shortest).
    """

    def __init__(self, cfg: VDOConfig, n_streams: int,
                 enable_local_ba: bool = True, devices=None, device="cuda"):
        from ..pipeline.fused import FusedTracker

        if devices is not None:
            if len(devices) > 1:
                raise NotImplementedError(
                    f"MultiStreamSystem(devices={list(devices)}): spreading "
                    f"streams over several devices (the JAX package's Mesh "
                    f"and NamedSharding) is not ported; it waits for the "
                    f"torch.distributed work.  One device holds all streams")
            device = devices[0]
        self.cfg = cfg
        self.S = n_streams
        self.device = torch.device(device)
        # one host-side tracker per stream: staging, archive, window-BA
        # trigger, reports; none builds a step or a device state
        self.trackers = [FusedTracker(cfg, device=self.device,
                                      build_step=False)
                         for _ in range(n_streams)]
        self.step = make_multistream_packed_step(cfg, self.device)
        if enable_local_ba:
            from ..backend.window_ba import local_ba_inplace

            dev = self.device
            for t in self.trackers:
                t.local_ba_hook = (
                    lambda m, n_frames=None: local_ba_inplace(
                        m, cfg, n_frames=n_frames, device=dev))
        self.states = stack_states([make_stream_state(cfg, self.device)
                                    for _ in range(n_streams)])
        self.initialized = False
        self.frame_id = 0
        # frames whose output copy is queued but not archived yet
        self._pending: deque = deque()
        self.drain_every = max(int(cfg.tracking.fused_drain_chunks), 1)

    @property
    def maps(self):
        return [t.map for t in self.trackers]

    def _stage(self, fds) -> dict:
        """One stacked (S, wire_len) packed upload for all streams."""
        lead = self.trackers[0]
        gts = [t._gt_pose(fd.pose_gt_raw)
               for t, fd in zip(self.trackers, fds)]
        sems = [t._stage_gt_sems(fd) for t, fd in zip(self.trackers, fds)]
        return {
            "packed": lead._put(np.stack([lead.wire(fd) for fd in fds]),
                                np.int16),
            "T_cw_gt": lead._put(np.stack(gts), np.float32),
            "gt_sems": lead._put(np.stack(sems), np.int32),
            "_gts_host": gts,
        }

    def _frame_draws(self, fid: int) -> dict:
        """Frame fid's draws for every stream.  The trackers share one
        config, hence one seed, so all streams draw the same numbers, as a
        solo tracker on each stream would: drawn once and broadcast."""
        u = self.trackers[0].frame_draws(fid)
        return {k: v.expand((self.S,) + tuple(v.shape)) for k, v in u.items()}

    def step_frame(self, fds, staged: dict | None = None,
                   sync: bool = True) -> list:
        """One frame of every stream in ONE batched step; archives per
        stream and returns the per-stream reports.

        sync=False pipelines the output drain: the frame's (S, n) vectors
        start an asynchronous copy, every `drain_every`-th frame the
        accumulated frames are archived, and the return value is the list
        of the frames archived by this call (a list of per-stream report
        lists).  Call flush() at the end of the run."""
        t0 = time.perf_counter()
        staged = dict(staged) if staged is not None else self._stage(fds)
        gts = staged.pop("_gts_host")
        fid = self.frame_id
        self.states, vecs = self.step(self.states, staged,
                                      self._frame_draws(fid),
                                      self.initialized)
        self.initialized = True
        self.frame_id += 1
        for t in self.trackers:
            t.frame_id = fid + 1
        if sync:
            return self._archive_frame(fds, gts, fid, vecs.cpu().numpy(), t0)
        host, done = self.trackers[0]._to_host(vecs)
        self._pending.append((list(fds), gts, fid, host, done, t0))
        if len(self._pending) >= self.drain_every:
            return self._drain_batch()
        return []

    def _archive_frame(self, fds, gts, fid, vecs_np, t0) -> list[dict]:
        return [t._finish_frame(fds[s], gts[s], fid, vecs_np[s], t0)
                for s, t in enumerate(self.trackers)]

    def _drain_batch(self) -> list[list[dict]]:
        """Archive every pending frame, per stream, in frame order.  The
        copies were queued in order on one stream, so the last frame's
        event covers all."""
        batch = list(self._pending)
        self._pending.clear()
        if batch and batch[-1][4] is not None:
            batch[-1][4].synchronize()
        return [self._archive_frame(fds, gts, fid, host.numpy(), t0)
                for fds, gts, fid, host, _, t0 in batch]

    def flush(self) -> list[list[dict]]:
        """Archive every in-flight frame, in order."""
        return self._drain_batch()

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
