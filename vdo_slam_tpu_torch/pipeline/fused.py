"""Fused-mode tracker — port of vdo_slam_tpu/pipeline/fused.py.

Drives the fused frame step (parallel/multistream.py) and archives every
frame into MapState on the host.  A frame goes to the device as ONE pinned
int16 wire buffer (io/packing.py; a pre-packed frame's buffer is taken as
it is) and is decoded there.  Each frame's outputs are packed on the
device into one float32 vector.

`grab_frame` runs one frame per call: the output vector's copy to a pinned
host buffer is queued right behind the step, and the previous frame is
archived while the device works, so a call reports the frame before the
one it was given and `flush` reports the last.

The step runs as the JAX package's jitted step runs: compiled once and
replayed.  The tracker holds its state in static buffers and steps it
through a `StepGraph` (utils/cuda_graph.py): frame 0 runs the
initialization eagerly (the JAX step's lax.cond picks it by the state's
flag, here a host bool), the first tracked frame runs the track body
eagerly as the warm-up, the next one captures it into a CUDA graph, and
every later frame copies its staged inputs and draws into the graph's
input buffers and replays the graph: the step and `pack_outputs` in one
host call.  On the CPU the same buffers are stepped eagerly.
`tracker.state` reads a copy of the state buffers and assigning it
copies into them (a checkpoint's resume).

`grab_chunk` runs `fused_chunk` frames per call.  The JAX package unrolls
a lax.scan over the chunk inside one program; here the chunk goes up in
one (C, wire_len) transfer, its frames are stepped in a Python loop with
no host sync between them (`step_chunk`, the counterpart of the JAX
tracker's jitted scan), one graph replay per frame, and the C output
vectors are gathered on the device and copied back in one transfer.  Finished chunks
wait in a batch; every `fused_drain_chunks`-th chunk the batch is archived
in frame order.  The JAX package fetches and archives a batch on a drainer
thread and hands out its reports when the thread is done; here the copies
were queued asynchronously when each chunk was dispatched, so the drain
waits on the batch's last CUDA event and archives on the calling thread.
Which frames are archived, their order and the reports returned (by
`grab_chunk` and `flush` together) are the JAX package's.

The window-BA trigger (fused.py:310-323) fires on the archived frame and
queues the window end, pinned to the archive's length; it never waits for
a solve.  As in the original, the solves run strictly in order on ONE
background thread (`_maybe_launch_ba` starts the next under a lock), a
solve that raises is counted in `ba_failures` and the run goes on, and
`flush` joins them.  On a card the solve thread issues its work on a CUDA
stream of its own (`ba_stream`, a pool stream, which does not synchronize
with the legacy default stream the tracker steps on), so the solve's
kernels and copies overlap the tracking steps.  A solve writes back only
frames < its n_frames, and archiving reads no refined value, so the run's
results do not depend on when the solves finish.

Frame f's random draws depend on (cfg.seed, f mod MAX_FRAMES) only
(pipeline/draws.py), the port's form of the JAX tracker's pre-split key
ring.

Every archived frame carries the reference's five stage times: zeros until
`calibrate_stage_times` measures them, then the measured split, for the
frames archived before it too.  On a card each is the device time per
frame of its span of the graphed packed step, the host's dispatch netted
out (parallel/multistream.py:make_scan_probe); on the CPU the host clock's
time of the span.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
import traceback

import numpy as np
import torch

from ..config import OMD, VDOConfig
from ..devices import on_device
from ..io.dataset import FrameData
from ..io.packing import pack_frame, wire_kwargs
from ..parallel.multistream import make_frame_step, make_stream_state
from ..utils import profiling
from ..utils.cuda_graph import StepGraph
from . import draws as draws_mod
from .map_state import MapState
from .tracking import (_np_inv, obj_pose_parsing_kt, obj_pose_parsing_ox,
                       upload)

# cap on per-frame GT-object semantic labels fed to the bObjStat gate
_K_GT = 32


def _rows_sems(rows) -> set[int]:
    r = np.asarray(rows, np.float32).reshape(-1, 10)
    return {int(x) for x in r[:, 1]}


def pack_outputs(state, metrics) -> torch.Tensor:
    """The frame's outputs as ONE float32 vector, in the layout of the JAX
    package's _pack_outputs (fused.py:43-78).  Exact: every int < 2^24."""
    fs = state.frame
    s, d, m = fs.static, fs.dynamic, metrics
    f32 = torch.float32

    def col(x):
        return x.to(f32)[:, None]

    stat = torch.cat([s.xy, s.depth[:, None], s.point_w, col(s.valid),
                      col(s.assoc)], dim=1)                        # (B, 8)
    dyn = torch.cat([d.xy, d.depth[:, None], d.point_w, col(d.valid),
                     col(d.assoc), col(d.obj_label), col(d.sem_label)],
                    dim=1)                                         # (D, 10)
    slots = torch.cat([
        col(m["slot_sem"]), col(m["slot_model"]), col(m["slot_active"]),
        m["slot_H"].reshape(-1, 16), m["slot_centroid"],
        col(m["slot_n_init"]), col(m["slot_n_inlier"]), col(m["speeds"]),
    ], dim=1)                                                      # (K, 25)
    mats = torch.stack([fs.T_cw, fs.velocity])                     # (2, 4, 4)
    scal = torch.stack([m["t_rpe"].to(f32), m["r_rpe"].to(f32),
                        m["n_inlier"].to(f32), m["n_objects"].to(f32),
                        m["used_motion_model"].to(f32)])           # (5,)
    return torch.cat([stat.reshape(-1), dyn.reshape(-1), slots.reshape(-1),
                      mats.reshape(-1), scal])


def unpack_host(vec: np.ndarray, B: int, D: int, K: int) -> dict:
    """Inverse of pack_outputs on the host vector -> the archive's view."""
    o = 0
    stat = vec[o:o + B * 8].reshape(B, 8); o += B * 8
    dyn = vec[o:o + D * 10].reshape(D, 10); o += D * 10
    slots = vec[o:o + K * 25].reshape(K, 25); o += K * 25
    mats = vec[o:o + 32].reshape(2, 4, 4); o += 32
    scal = vec[o:o + 5]
    host_stat = (stat[:, 0:2], stat[:, 2], stat[:, 3:6],
                 stat[:, 6] > 0.5, stat[:, 7].astype(np.int32))
    host_dyn = (dyn[:, 0:2], dyn[:, 2], dyn[:, 3:6], dyn[:, 6] > 0.5,
                dyn[:, 7].astype(np.int32), dyn[:, 8].astype(np.int32),
                dyn[:, 9].astype(np.int32))
    metrics = {
        "t_rpe": scal[0], "r_rpe": scal[1], "n_inlier": scal[2],
        "n_objects": scal[3], "used_motion_model": scal[4],
        "slot_sem": slots[:, 0].astype(np.int32),
        "slot_model": slots[:, 1].astype(np.int32),
        "slot_active": slots[:, 2] > 0.5,
        "slot_H": slots[:, 3:19].reshape(-1, 4, 4),
        "slot_centroid": slots[:, 19:22],
        "slot_n_init": slots[:, 22].astype(np.int32),
        "slot_n_inlier": slots[:, 23].astype(np.int32),
        "speeds": slots[:, 24],
    }
    return {"stat": host_stat, "dyn": host_dyn, "T_cw": mats[0],
            "velocity": mats[1], "metrics": metrics}


class FusedTracker:
    """Single-stream tracker built on the fused frame step.

    build_step=False makes a tracker that only stages, archives and
    triggers window solves (the host half the S-stream system uses, one per
    stream): it builds no step and no device state.

    `step` is the eager packed step (parallel/multistream.py:
    make_frame_step); the tracker runs it through its StepGraph.
    """

    MAX_FRAMES = draws_mod.MAX_FRAMES

    def __init__(self, cfg: VDOConfig, game_map: MapState | None = None,
                 device="cuda", build_step: bool = True):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "FusedTracker(device='cuda'): no CUDA device; pass "
                "device='cpu' to run on the CPU")
        self.map = game_map if game_map is not None else MapState()
        self.chunk = max(int(cfg.tracking.fused_chunk), 1)
        self.drain_chunks = max(int(cfg.tracking.fused_drain_chunks), 1)
        if build_step:
            self.step = make_frame_step(cfg, self.device, packed=True)
            self._graph = StepGraph(self._packed_step,
                                    make_stream_state(cfg, self.device),
                                    self.device, "fused packed step")
        self.initialized = False  # the JAX state's flag, kept on the host
        self._generator = torch.Generator()   # CPU: pipeline/draws.py
        self.frame_id = 0
        self.origin_inv: np.ndarray | None = None
        # GT sem labels of the last STAGED frame (staging runs strictly in
        # frame order); None until frame 0 is staged
        self._stage_last_sems: set[int] | None = None
        self._last_obj_rows = np.zeros((0, 10), np.float32)
        self._last_T_wc_gt = np.eye(4, dtype=np.float32)
        # per-frame stage times archived with every frame: zeros until
        # calibrate_stage_times() measures the split
        self._stage_ms = np.zeros(5, np.float32)
        self._probe_rtt_ms = 0.0
        self.probe_report: dict | None = None
        self._pending = None
        self._pending_chunk = None
        self._pending_batch: list = []
        # window BA: System sets the hook, (map, n_frames) -> report dict
        self.local_ba_hook = None
        # pending window ends (archive lengths) not launched yet: the solves
        # run strictly in order on ONE background thread, and a trigger
        # that arrives while a solve is in flight is queued, not joined
        self._ba_thread: threading.Thread | None = None
        self._ba_queue: list[int] = []
        self._ba_lock = threading.Lock()
        # while a recorder is on: when each queued window end was queued
        self._ba_queued_ns: dict[int, int] = {}
        self.ba_failures = 0  # background window solves that raised
        # per-solve reports (cost0 / cost, points, edge stats, phase ms);
        # one stderr line is logged per solve
        self.ba_health: list[dict] = []
        # the solves' stream on this tracker's card, taken once
        self.ba_stream = (torch.cuda.Stream(self.device)
                          if self.device.type == "cuda" else None)

    @property
    def state(self):
        """A copy of the stream state: later steps leave it alone."""
        return self._graph.state.snapshot()

    @state.setter
    def state(self, state) -> None:
        """Copy `state` into the state buffers the step runs on."""
        self._graph.state.load(state)

    def _packed_step(self, state, inputs, uniforms, initialized):
        """The eager step of one frame, its outputs packed: what the step
        graph captures."""
        state, metrics = self.step(state, inputs,
                                   draws_mod.UniformDraws(uniforms),
                                   initialized)
        return state, pack_outputs(state, metrics)

    def _step_frame(self, inputs: dict, frame_id: int) -> torch.Tensor:
        """Step the state buffers by one staged frame with frame
        `frame_id`'s draws; returns its output vector, which the next step
        overwrites."""
        vec = self._graph(inputs, draws_mod.frame_uniforms(
            self.cfg, frame_id, self._generator), self.initialized)
        self.initialized = True
        return vec

    def _gt_pose(self, raw):
        # rebased so the first frame's GT is exactly I, even mid-sequence
        if self.origin_inv is None:
            self.origin_inv = np.asarray(raw, np.float32)
        return _np_inv(np.asarray(raw, np.float32)) @ self.origin_inv

    def _stage_gt_sems(self, fd: FrameData) -> np.ndarray:
        """(K_GT,) -1-padded sem labels with GT in BOTH the previous and
        this frame — the bObjStat gate's input (Tracking.cc:831-841).
        Called once per frame, in frame order."""
        cur = _rows_sems(fd.obj_gt_rows)
        last = self._stage_last_sems
        both = sorted(cur & last)[:_K_GT] if last is not None else []
        self._stage_last_sems = cur
        out = np.full((_K_GT,), -1, np.int32)
        out[:len(both)] = both
        return out

    def _gt_obj(self, rows, T_wc_gt):
        out = {}
        for r in np.asarray(rows, np.float32).reshape(-1, 10):
            if self.cfg.tracking.dataset == OMD:
                out[int(r[1])] = obj_pose_parsing_ox(r, self.origin_inv)
            else:
                out[int(r[1])] = T_wc_gt @ obj_pose_parsing_kt(r)
        return out

    def wire(self, fd) -> np.ndarray:
        """The frame's int16 wire buffer: a pre-packed frame's own
        (io/packed_dataset.py), else packed here under the config's wire."""
        pre = getattr(fd, "packed", None)
        if pre is not None:
            return np.asarray(pre)
        return pack_frame(np.asarray(fd.rgb, np.float32),
                          np.asarray(fd.depth_raw, np.float32),
                          np.asarray(fd.flow, np.float32),
                          np.asarray(fd.mask),
                          **wire_kwargs(self.cfg.tracking))

    def _put(self, x, dtype) -> torch.Tensor:
        return upload(x, dtype, self.device)

    def device_inputs(self, fd: FrameData) -> dict:
        """Stage a frame on the device: ONE packed int16 transfer plus its
        GT pose and labels; callable ahead of time, so the upload queues
        behind the previous frame's step."""
        with profiling.span("fused.stage", self.frame_id, cpu=True):
            T_cw_gt = self._gt_pose(fd.pose_gt_raw)
            return {
                "packed": self._put(self.wire(fd), np.int16),
                "T_cw_gt": self._put(T_cw_gt, np.float32),
                "gt_sems": self._put(self._stage_gt_sems(fd), np.int32),
                "_T_cw_gt_host": T_cw_gt,
            }

    def device_inputs_chunk(self, fds) -> dict:
        """Stage a CHUNK of frames on the device in one (C, wire_len)
        transfer."""
        with profiling.span("fused.stage", self.frame_id, n=len(fds),
                            cpu=True):
            gts = [self._gt_pose(fd.pose_gt_raw) for fd in fds]
            sems = [self._stage_gt_sems(fd) for fd in fds]
            return {
                "packed": self._put(np.stack([self.wire(fd) for fd in fds]),
                                    np.int16),
                "T_cw_gt": self._put(np.stack(gts), np.float32),
                "gt_sems": self._put(np.stack(sems), np.int32),
                "_T_cw_gt_host": gts,
            }

    def frame_draws(self, frame_id: int) -> dict:
        """The uniform draws of frame `frame_id` (pipeline/draws.py)."""
        return draws_mod.frame_uniforms(self.cfg, frame_id, self._generator,
                                        self.device)

    def probe_inputs(self, fd: FrameData):
        """(staged inputs, draws) of `fd` as the tracker's next frame, for
        the stage probe: staged as device_inputs stages it, without
        advancing the staging-order GT labels (the probe runs off the
        sequence); drawn for the current frame id from a generator of its
        own, so no generator the run uses moves."""
        saved_sems = self._stage_last_sems
        staged = self.device_inputs(fd)
        self._stage_last_sems = saved_sems
        staged.pop("_T_cw_gt_host")
        draws = draws_mod.UniformDraws(draws_mod.frame_uniforms(
            self.cfg, self.frame_id, torch.Generator(), self.device))
        return staged, draws

    def calibrate_stage_times(self, fd: FrameData, rounds: int = 2,
                              n_iters: int = 8) -> dict:
        """Measure the reference's 5-span stage split (Map.h:83-84,
        System.cc:204-237) on the fused path (JAX fused.py:248-287).

        Captures each span of the packed step, and the frame program, as
        a graph over a copy of the tracker's state with `fd` as the next
        frame, replays each n_iters times per round, and keeps the least of
        `rounds` rounds (parallel/multistream.py:make_scan_probe has the
        method and what the times mean: on a card, device time per frame).
        Returns {span: ms for span in PROBE_SPANS}, "_frame_ms" (the packed
        step plus pack_outputs, its state carried) and "_rtt_ms" (the
        baseline, an empty timed region).  The five STAGE_SPANS, each
        clamped at 0, are archived with every frame, past and future;
        `probe_report` keeps the probe's seconds, its graphs' records and
        replays and its pool's bytes.  The probe changes nothing the run
        reads: the state, the frame counter, the staging-order GT labels
        and the draws of the next frame (its draws come from a generator
        of its own)."""
        from ..parallel.multistream import STAGE_SPANS, make_scan_probe

        staged, draws = self.probe_inputs(fd)
        probe = make_scan_probe(self.cfg, self.device, n_iters=n_iters)
        times, rtt = probe(self._graph.state.tree, staged, draws,
                           rounds=rounds)
        self.probe_report = probe.report
        self._stage_ms = np.asarray([max(times[k], 0.0) for k in STAGE_SPANS],
                                    np.float32)
        self._probe_rtt_ms = rtt
        # backfill the frames archived before calibration (they hold zeros)
        for i in range(len(self.map.timings)):
            self.map.timings[i] = self._stage_ms.copy()
        return dict(times, _rtt_ms=rtt)

    def _to_host(self, vec: torch.Tensor):
        """Queue the copy of an output tensor to a pinned host buffer;
        returns (host tensor, event to wait on or None).  The copy is the
        caller's: the next step may overwrite `vec`."""
        if vec.device.type != "cuda":
            return vec.clone(), None
        host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
        host.copy_(vec, non_blocking=True)
        done = torch.cuda.Event()
        # the copy's stream: that of vec's card, which need not be the
        # current one (streams spread over cards, parallel/multisystem.py)
        done.record(torch.cuda.current_stream(vec.device))
        return host, done

    def grab_frame(self, fd: FrameData, staged: dict | None = None) -> dict:
        """Queue this frame's step and its output copy, then archive the
        PREVIOUS frame; returns that frame's report (or a placeholder with
        "pipelining" on the first call).  `staged`: the frame's
        `device_inputs`, where the caller staged them ahead."""
        t0 = time.perf_counter()
        inputs = dict(staged) if staged is not None \
            else self.device_inputs(fd)
        T_cw_gt = inputs.pop("_T_cw_gt_host")
        with profiling.span("fused.dispatch", self.frame_id):
            host, done = self._to_host(self._step_frame(inputs,
                                                        self.frame_id))
        rep_prev = self._drain_pending()
        self._pending = (fd, T_cw_gt, self.frame_id, host, done, t0)
        self.frame_id += 1
        if rep_prev is None:
            rep_prev = {"frame_id": -1, "pipelining": True}
        return rep_prev

    def step_chunk(self, state, inputs: dict, first_frame_id: int):
        """Step a staged chunk (`device_inputs_chunk` without its
        "_T_cw_gt_host") from `state`, frame first_frame_id + c taking
        that frame's draws, with no host sync between frames: the
        counterpart of the JAX tracker's jitted scan (fused.py:133-145).
        `state` is copied into the tracker's state buffers, which the chunk
        then steps.  Returns (a copy of the new state, the (C, n) output
        vectors, still on the device); neither changes with later steps.
        The first frame starts uninitialized only if the tracker has
        stepped no frame yet."""
        self.state = state
        vecs = self._step_chunk(inputs, first_frame_id)
        return self.state, vecs

    def _step_chunk(self, inputs: dict, first_frame_id: int):
        """step_chunk on the state buffers as they are; returns the (C, n)
        output vectors in a tensor of their own."""
        C = inputs["packed"].shape[0]
        vecs = None
        for c in range(C):
            vec = self._step_frame({k: v[c] for k, v in inputs.items()},
                                   first_frame_id + c)
            if vecs is None:
                vecs = vec.new_empty((C,) + tuple(vec.shape))
            vecs[c].copy_(vec)
        return vecs

    def grab_chunk(self, fds, staged: dict | None = None,
                   n_real: int | None = None) -> list[dict]:
        """len(fds) == fused_chunk frames in one call; returns the reports
        of the frames archived by this call (every fused_drain_chunks-th
        call archives the batch of chunks before this one).  Call flush()
        for the rest.

        n_real < chunk marks a PADDED tail chunk (trailing entries repeat
        the last real frame, as the JAX package pads its tail); only the
        first n_real frames are archived and reported."""
        if len(fds) != self.chunk:
            raise ValueError(f"grab_chunk takes fused_chunk = {self.chunk} "
                             f"frames, got {len(fds)}")
        if n_real is None:
            n_real = self.chunk
        t0 = time.perf_counter()
        inputs = dict(staged) if staged is not None \
            else self.device_inputs_chunk(fds)
        gts = inputs.pop("_T_cw_gt_host")
        with profiling.span("fused.dispatch", self.frame_id, n=self.chunk):
            vecs = self._step_chunk(inputs, self.frame_id)
            host, done = self._to_host(vecs)   # one (C, n) copy
        if self._pending_chunk is not None:
            self._pending_batch.append(self._pending_chunk)
            self._pending_chunk = None
        reps = []
        if len(self._pending_batch) >= self.drain_chunks:
            batch, self._pending_batch = self._pending_batch, []
            reps = self._drain_batch_now(batch)
        self._pending_chunk = (list(fds), gts, self.frame_id, host, done, t0,
                               n_real)
        self.frame_id += self.chunk
        return reps

    def _drain_pending(self):
        if self._pending is None:
            return None
        fd, T_cw_gt, fid, host, done, t0 = self._pending
        self._pending = None
        with profiling.span("fused.drain_wait", fid):
            if done is not None:
                done.synchronize()
        with profiling.span("fused.archive", fid, cpu=True):
            return self._finish_frame(fd, T_cw_gt, fid, host.numpy(), t0)

    def _drain_batch_now(self, batch) -> list[dict]:
        """Archive a batch of chunks in frame order.  Their copies were
        queued in order on one stream, so the last one's event covers all."""
        first, frames = batch[0][2], sum(b[6] for b in batch)
        with profiling.span("fused.drain_wait", first, n=frames):
            if batch[-1][4] is not None:
                batch[-1][4].synchronize()
        reps = []
        with profiling.span("fused.archive", first, n=frames, cpu=True):
            for fds, gts, fid0, host, _, t0, n_real in batch:
                vecs_np = host.numpy()
                reps.extend(self._finish_frame(fds[c], gts[c], fid0 + c,
                                               vecs_np[c], t0)
                            for c in range(n_real))
        return reps

    def _drain_pending_chunk(self) -> list[dict]:
        """Archive every chunk still in flight, in order."""
        if self._pending_chunk is not None:
            self._pending_batch.append(self._pending_chunk)
            self._pending_chunk = None
        if not self._pending_batch:
            return []
        batch, self._pending_batch = self._pending_batch, []
        return self._drain_batch_now(batch)

    def flush(self) -> dict | list | None:
        """Archive the last in-flight frame or chunks and join the window
        solves (call once after the loop); returns a chunked drive's
        remaining reports as a list, else the last frame's report."""
        rep = self._drain_pending()
        reps = self._drain_pending_chunk()
        self._join_ba()
        return reps if reps else rep

    def _finish_frame(self, fd, T_cw_gt, fid, vec_np, t0):
        sh = self.cfg.shapes
        host = unpack_host(vec_np, sh.max_static, sh.max_dynamic,
                           sh.max_objects)
        self._archive(fd, host, T_cw_gt, fid)
        hm = host["metrics"]
        rep = {
            "frame_id": fid,
            "T_cw": host["T_cw"],
            "t_rpe": float(hm["t_rpe"]),
            "r_rpe": float(hm["r_rpe"]),
            "n_inlier_cam": int(hm["n_inlier"]),
            "n_objects": int(hm["n_objects"]),
            "wall_time": time.perf_counter() - t0,
        }
        if self.ba_failures:
            rep["ba_failures"] = self.ba_failures
        # windowed BA trigger on the archived frame (Tracking.cc:1168-1183),
        # queued with the window end pinned to the archive's length
        tr = self.cfg.tracking
        w, o = tr.window_size, tr.overlap_size
        if (self.local_ba_hook is not None and fid >= w - 1
                and (fid - o + 1) % (w - o) == 0):
            self._queue_ba(self.map.num_frames)
        return rep

    def _queue_ba(self, n_frames: int) -> None:
        """Queue the window solve ending at archive length n_frames and
        launch it if no solve is in flight; never waits for a solve.  While
        a recorder is on, the solve's `window.queued` span starts here."""
        if profiling.ACTIVE is not None:
            self._ba_queued_ns[n_frames] = time.time_ns()
        with self._ba_lock:
            self._ba_queue.append(n_frames)
        self._maybe_launch_ba()

    @contextlib.contextmanager
    def ba_context(self):
        """This tracker's card and its solve stream as torch's current ones
        (nothing on the CPU): where its window solves run, and where a
        warm-up solve must run to warm their allocator pool."""
        with on_device(self.device), torch.cuda.stream(self.ba_stream):
            yield

    def _run_ba(self, n_frames: int):
        """One window solve on the solve thread.  Its `lba_times` entry,
        its stderr line and its `window.solve` span take the same clock
        reads."""
        rec = profiling.ACTIVE
        t5 = time.time_ns()
        queued = self._ba_queued_ns.pop(n_frames, None)
        if rec is not None:
            if queued is not None:
                rec.add("window.queued", queued, t5, n_frames)
            solve = rec.begin("window.solve", n_frames, start_ns=t5)
        t6 = None
        try:
            with self.ba_context():
                health = self.local_ba_hook(self.map, n_frames)
            t6 = time.time_ns()
            ms = (t6 - t5) / 1e6
            self.map.lba_times.append(ms)
            if isinstance(health, dict):
                self.ba_health.append(health)
                obs = health.get("edge_stats", {}).get("obs", {})
                print(
                    f"[window-ba] end={n_frames} cost "
                    f"{health['cost0']:.3e} -> {health['cost']:.3e}"
                    f"  points={health['n_points']}"
                    f"  obs_inliers={int(obs.get('n_inlier', 0))}/"
                    f"{int(obs.get('n', 0))}"
                    f"  tracks_dropped={health['n_tracks_dropped']}"
                    f"  {ms:.0f}ms (build "
                    f"{health.get('t_build_ms', 0):.0f} dispatch "
                    f"{health.get('t_dispatch_ms', 0):.0f} exec "
                    f"{health.get('t_exec_ms', 0):.0f} fetch "
                    f"{health.get('t_fetch_ms', 0):.0f})",
                    file=sys.stderr)
        except Exception:
            # a lost window solve degrades refinement only: report it and
            # go on, as the original does
            traceback.print_exc()
            self.ba_failures += 1
        finally:
            # the span is recorded before the slot is handed over, so
            # flush() returns with every solve's span; a fault of the
            # recorder still hands the slot over, or flush() would wait on
            # it for ever
            try:
                if rec is not None:
                    rec.end(solve, end_ns=t6)
            finally:
                # hand the thread slot over and launch the next queued window
                with self._ba_lock:
                    self._ba_thread = None
                self._maybe_launch_ba()

    def _maybe_launch_ba(self):
        """Launch the next queued window solve iff none is in flight: the
        write-back of window k ends before window k+1's graph build reads
        the refined poses, and the trigger never blocks on a solve."""
        with self._ba_lock:
            if self._ba_thread is not None or not self._ba_queue:
                return
            n_frames = self._ba_queue.pop(0)
            t = threading.Thread(target=self._run_ba, args=(n_frames,),
                                 name=f"window-ba-{n_frames}", daemon=True)
            self._ba_thread = t
            # started under the lock: a concurrent trigger must never see a
            # claimed-but-unstarted slot as free
            t.start()

    def _join_ba(self):
        """Wait for every queued and in-flight window solve."""
        while True:
            with self._ba_lock:
                t = self._ba_thread
                if t is None and not self._ba_queue:
                    return
            if t is not None:
                t.join()
            else:
                # queued but not launched: the finishing thread is between
                # releasing the slot and its trailing _maybe_launch_ba
                self._maybe_launch_ba()

    def _archive(self, fd: FrameData, host: dict, T_cw_gt, fid: int):
        """Append one frame to MapState (fused.py:541-636)."""
        m = self.map
        s_xy, s_d, s_3d, s_v, s_a = host["stat"]
        d_xy, d_d, d_3d, d_v, d_a, d_ol, d_sl = host["dyn"]
        metrics = host["metrics"]
        m.stat_xy.append(s_xy)
        m.stat_depth.append(s_d)
        m.stat_3d.append(s_3d)
        m.stat_valid.append(s_v)
        m.dyn_xy.append(d_xy)
        m.dyn_depth.append(d_d)
        m.dyn_3d.append(d_3d)
        m.dyn_valid.append(d_v)
        m.dyn_obj_label.append(d_ol)
        m.dyn_sem_label.append(d_sl)
        T_wc = _np_inv(host["T_cw"])
        m.cam_pose.append(T_wc)
        m.cam_pose_rf.append(T_wc.copy())
        m.cam_pose_gt.append(_np_inv(np.asarray(T_cw_gt)))
        m.timings.append(self._stage_ms.copy())

        T_wc_gt = _np_inv(np.asarray(T_cw_gt))
        if fid == 0:
            self._last_obj_rows = fd.obj_gt_rows
            self._last_T_wc_gt = T_wc_gt
            return
        m.stat_assoc.append(s_a)
        m.dyn_assoc.append(d_a)

        gt_cur = self._gt_obj(fd.obj_gt_rows, T_wc_gt)
        gt_last = self._gt_obj(self._last_obj_rows, self._last_T_wc_gt)
        cam_motion = _np_inv(host["velocity"])
        mots = [cam_motion]
        # GT camera motion = Tcw_gt_last @ Twc_gt_cur (Tracking.cc:1136)
        mots_gt = [_np_inv(self._last_T_wc_gt) @ T_wc_gt]
        poses_pre = [cam_motion]
        labels, sems, stats = [0], [0], [True]
        sp_gt, sp_est = [1.0], [0.0]
        cents = [np.zeros(3, np.float32)]
        for k in range(metrics["slot_active"].shape[0]):
            sem = int(metrics["slot_sem"][k])
            # a slot without GT in both frames was already deactivated on
            # the device (bObjStat); the check stays as a defensive skip
            if (not metrics["slot_active"][k] or sem not in gt_cur
                    or sem not in gt_last):
                continue
            L_w_p = gt_last[sem]
            L_w_c = gt_cur[sem]
            H_p_c = L_w_c @ _np_inv(L_w_p)
            v_gt = (H_p_c[:3, 3]
                    - (np.eye(3) - H_p_c[:3, :3]) @ metrics["slot_centroid"][k])
            mots.append(metrics["slot_H"][k])
            mots_gt.append(_np_inv(L_w_p) @ L_w_c)
            poses_pre.append(L_w_p)
            labels.append(int(metrics["slot_model"][k]))
            sems.append(sem)
            stats.append(True)
            sp_gt.append(float(np.linalg.norm(v_gt) * 36.0))
            sp_est.append(float(metrics["speeds"][k]))
            cents.append(metrics["slot_centroid"][k])

        m.rigid_motion.append(mots)
        m.rigid_motion_rf.append([x.copy() for x in mots])
        m.rigid_motion_gt.append(mots_gt)
        m.obj_pose_pre.append(poses_pre)
        m.rm_label.append(labels)
        m.sem_label.append(sems)
        m.obj_stat.append(stats)
        m.speed_gt.append(sp_gt)
        m.speed_est.append(sp_est)
        m.centres.append(cents)
        m.sm_label_gt.append(
            [int(r[1]) for r in np.asarray(fd.obj_gt_rows).reshape(-1, 10)])
        self._last_obj_rows = fd.obj_gt_rows
        self._last_T_wc_gt = T_wc_gt
