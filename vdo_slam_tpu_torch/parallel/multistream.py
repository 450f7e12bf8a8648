"""The fused per-frame tracking step, for one stream and for S, and the
probe that times its spans — port of make_stream_state, make_frame_step,
make_multistream_step and make_scan_probe of
vdo_slam_tpu/parallel/multistream.py.

One step runs the whole frame: the wire decode (packed=True), mask
propagation, front end, inheritance, camera RANSAC + joint flow-pose LM,
scene flow, the on-device classifier, the per-slot object solves and
renewal.  The JAX step branches on its `initialized` flag with lax.cond;
here the tracker keeps that flag as a host bool and passes it in, so the
step never reads the device.

The S-stream step is the JAX package's `jax.vmap(step)` on one device:
states and inputs carry a leading S, the wire of all streams is decoded
in one pass, the FAST kernel scores the pyramids of all streams in ONE
launch (S in the kernel's grid), and the rest of the body runs once under
`torch.func.vmap`.  The draws come in as tensors (pipeline/draws.py).
Where the JAX package shards the S streams over a mesh (Mesh and
NamedSharding), make_multistream_step takes a list of devices: each holds
a contiguous block of the streams and runs the batched step on it, one
process driving them all (vdo_slam_tpu_torch/devices.py says why), and the
fleet reductions are gathered onto the first device.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from ..config import VDOConfig
from ..devices import device_list, on_device
from ..ops import frontend, select
from ..pipeline import stages
from ..pipeline.draws import FrameDraws, UniformDraws
from ..pipeline.state import (DynamicBank, FrameState, StaticBank, field,
                              frame_state_from_numpy, to_tensor)
from ..utils.cuda_graph import GraphedCall, StaticTree

Tensor = torch.Tensor


@dataclasses.dataclass
class StreamState:
    """FrameState plus the object-track slot tables (multistream.py:32-48);
    the JAX state's `initialized` flag lives on the host in the tracker."""

    frame: FrameState
    slot_sem: Tensor     # (K,) int32
    slot_model: Tensor   # (K,) int32
    slot_active: Tensor  # (K,) bool
    slot_H: Tensor       # (K, 4, 4)
    max_id: Tensor       # () int32


def make_stream_state(cfg: VDOConfig, device="cuda") -> StreamState:
    sh = cfg.shapes
    K = sh.max_objects
    return StreamState(
        frame=FrameState.empty(sh.max_static, sh.max_dynamic,
                               cfg.camera.height, cfg.camera.width, device),
        slot_sem=torch.zeros(K, dtype=torch.int32, device=device),
        slot_model=torch.zeros(K, dtype=torch.int32, device=device),
        slot_active=torch.zeros(K, dtype=torch.bool, device=device),
        slot_H=torch.eye(4, device=device).repeat(K, 1, 1),
        max_id=torch.tensor(1, dtype=torch.int32, device=device),
    )


def stack_states(states: list[StreamState]) -> StreamState:
    """S stream states as one with a leading S on every leaf (the JAX
    package's jax.tree.map(jnp.stack, ...), multisystem.py:86-89)."""
    return _unflatten([torch.stack(leaves) for leaves in
                       zip(*(_flatten(st) for st in states))])


def _flatten(obj) -> list[Tensor]:
    """The tensors of a (nested) state dataclass, in field order."""
    if torch.is_tensor(obj):
        return [obj]
    return [leaf for f in dataclasses.fields(obj)
            for leaf in _flatten(getattr(obj, f.name))]


_NESTED = {"frame": FrameState, "static": StaticBank, "dynamic": DynamicBank}


def _unflatten(leaves: list[Tensor], cls=StreamState) -> StreamState:
    """Inverse of _flatten."""
    it = iter(leaves)

    def build(c):
        return c(**{f.name: (build(_NESTED[f.name]) if f.name in _NESTED
                             else next(it))
                    for f in dataclasses.fields(c)})

    return build(cls)


def state_from_numpy(tree, device="cuda"):
    """A JAX stream state pulled to numpy (`jax.device_get` of the dict of
    make_stream_state) -> (StreamState, initialized).  Leaves are read by
    name, from dict keys or attributes, so no JAX type is needed here.  A
    stacked state (a leading S on every leaf) gives a StreamState with that
    leading S and `initialized` as a list of S bools; a single state gives
    one bool."""
    state = StreamState(
        frame=frame_state_from_numpy(field(tree, "frame"), device),
        **{f.name: to_tensor(field(tree, f.name), device)
           for f in dataclasses.fields(StreamState) if f.name != "frame"})
    init = np.asarray(field(tree, "initialized"))
    return state, (bool(init) if init.ndim == 0 else [bool(x) for x in init])


def make_frame_step(cfg: VDOConfig, device="cuda", packed: bool = False):
    """One fused tracking step for one stream.

    Returns step(state, inputs, draws, initialized) -> (state, metrics),
    where inputs = dict(rgb, depth_raw, flow, seg, T_cw_gt[, gt_sems]) are
    tensors on `device` — or, with packed=True, dict(packed, T_cw_gt[,
    gt_sems]) with the frame's int16 wire buffer (io/packing.py), decoded
    on the device first.  initialized=False runs frame-0 initialization.
    `inputs` may carry "fast_scores", the frame's FAST score maps, where
    the caller has scored them already (the S-stream step).
    """
    init_body, track_body, _ = _make_bodies(cfg, device)
    unpack = stages.make_unpack(cfg)

    def step(state: StreamState, inputs, draws: FrameDraws,
             initialized: bool):
        if packed:
            inputs = unpack(inputs)
        body = track_body if initialized else init_body
        return body(state, inputs, draws)

    return step


def _make_bodies(cfg: VDOConfig, device):
    """(init_body, track_body, track_spans) of the step: the bodies each
    (state, dense inputs, draws) -> (state, metrics); track_spans the
    (name, span) pairs track_body composes, in STAGE_SPANS order."""
    tr = cfg.tracking
    Kobj = cfg.shapes.max_objects
    L_tab = cfg.shapes.max_sem_labels
    prep_fn = stages.make_prepare(cfg, device)
    mask_prop_fn = stages.make_mask_prop(cfg, device)
    inherit_fn = stages.make_inherit(cfg, device)
    camera_fn = stages.make_camera_stage(cfg, device)
    sflow_fn = stages.make_scene_flow(cfg, device)
    objects_fn = stages.make_objects_stage(cfg, device)
    renew_s_fn, renew_d_fn = stages.make_renew_stage(cfg, device)
    init_fn = stages.make_init_stage(cfg, device)
    classify_fn = stages.make_device_classifier(cfg, device)
    eye4 = torch.eye(4, dtype=torch.float32, device=device)

    def _label_table(dyn_last: DynamicBank) -> Tensor:
        """The distinct positive sem labels of the last frame's valid
        dynamic features, most populous first (tracking.py:204-206)."""
        ok = dyn_last.valid & (dyn_last.sem_label > 0)
        lab = torch.clamp(dyn_last.sem_label, 0, 255)
        counts = frontend.segment_sum(
            ok.to(torch.float32), torch.where(ok, lab, 0).to(torch.int64), 256)
        counts = frontend.zero_first(counts)
        idx, tv = select.masked_top_k(counts, counts > 0, L_tab)
        return torch.where(tv, idx, 0).to(torch.int32)

    # The track body as the reference's spans (multistream.py:279-289 of
    # the JAX package), each ctx -> the entries it adds to ctx.  ctx starts
    # as {"state", "inputs", "draws"}; the stage probe times them one by
    # one (make_scan_probe).
    def mask_update(ctx):
        last, inputs = ctx["state"].frame, ctx["inputs"]
        # mask-propagation repair (UpdateMask, Tracking.cc:2997-3241)
        if tr.fused_mask_prop:
            seg, _ = mask_prop_fn(inputs["seg"], last.seg, last.flow_map,
                                  last.dynamic, _label_table(last.dynamic))
        else:
            seg = inputs["seg"]
        prep = prep_fn(inputs["rgb"], inputs["depth_raw"], inputs["flow"],
                       seg, ctx["draws"], inputs.get("fast_scores"))
        stat_cur, dyn_cur = inherit_fn(last.static, last.dynamic,
                                       prep["depth"], seg)
        return {"seg": seg, "prep": prep, "stat_cur": stat_cur,
                "dyn_cur": dyn_cur}

    def camera_est(ctx):
        last, stat_cur = ctx["state"].frame, ctx["stat_cur"]
        return {"cam_out": camera_fn(
            last.static, stat_cur["xy"], stat_cur["depth"], last.T_cw,
            last.velocity, ctx["inputs"]["T_cw_gt"], last.T_cw_gt,
            ctx["draws"])}

    def obj_track(ctx):
        state, dyn_cur = ctx["state"], ctx["dyn_cur"]
        last, T_cw = state.frame, ctx["cam_out"]["T_cw"]
        sf = sflow_fn(last.dynamic, dyn_cur["xy"], dyn_cur["depth"],
                      dyn_cur["sem_label"], last.T_cw, T_cw)
        cls = classify_fn(
            dyn_cur["sem_label"], dyn_cur["valid"] & sf["sem_ok"],
            sf["sf_norm"], dyn_cur["depth"], dyn_cur["xy"],
            last.dynamic.sem_label, state.slot_sem, state.slot_model,
            state.slot_H, state.slot_active, state.max_id)
        return {"sf": sf, "cls": cls}

    def obj_est(ctx):
        last, dyn_cur, cls = ctx["state"].frame, ctx["dyn_cur"], ctx["cls"]
        return {"obj_out": objects_fn(
            last.dynamic, dyn_cur["xy"], dyn_cur["depth"],
            dyn_cur["sem_label"], cls["slot_sem"], cls["slot_active"],
            cls["slot_has_mm"], cls["slot_H_prev"], cls["member_ok"],
            last.T_cw, ctx["cam_out"]["T_cw"], ctx["draws"])}

    def map_update(ctx):
        inputs, seg, prep = ctx["inputs"], ctx["seg"], ctx["prep"]
        cam_out, cls, obj_out = ctx["cam_out"], ctx["cls"], ctx["obj_out"]
        depth, T_cw = prep["depth"], cam_out["T_cw"]
        ok_slot = cls["slot_active"] & (obj_out["n_init"]
                                        >= tr.min_init_inliers)
        gt_sems = inputs.get("gt_sems")
        if gt_sems is not None:
            # bObjStat: an object without GT in both frames fails and its
            # track dies (Tracking.cc:831-841)
            ok_slot = ok_slot & (cls["slot_sem"][:, None]
                                 == gt_sems[None, :]).any(dim=1)
        stat_new = renew_s_fn(
            cam_out["uv_cur"], cam_out["inlier"], prep["det_xy"],
            prep["det_valid"], prep["det_score"], depth, inputs["flow"],
            seg, T_cw)
        # failed slots carry no features into renewal (Tracking.cc:2829-2841)
        carry_dyn = (cls["obj_label"] > 0) & (
            obj_out["inlier"] & ok_slot[:, None]).any(dim=0)
        dyn_new = renew_d_fn(
            obj_out["uv_cur"], cls["obj_label"], carry_dyn, prep["obj_cand"],
            cls["slot_sem"], cls["slot_model"], ok_slot, depth,
            inputs["flow"], seg, T_cw, ctx["draws"])
        new_state = StreamState(
            frame=FrameState(
                static=stat_new, dynamic=dyn_new, T_cw=T_cw,
                T_cw_gt=inputs["T_cw_gt"], velocity=cam_out["velocity"],
                seg=seg, flow_map=inputs["flow"], depth_map=depth),
            slot_sem=cls["slot_sem"],
            slot_model=cls["slot_model"],
            slot_active=ok_slot,
            slot_H=torch.where(ok_slot[:, None, None], obj_out["H"], eye4),
            max_id=cls["max_id"],
        )
        metrics = {
            "t_rpe": cam_out["t_rpe"],
            "r_rpe": cam_out["r_rpe"],
            "n_inlier": cam_out["n_inlier"],
            "n_objects": ok_slot.sum(),
            "speeds": torch.where(ok_slot, obj_out["speed"], 0.0),
            "slot_sem": cls["slot_sem"],
            "slot_model": cls["slot_model"],
            "slot_active": ok_slot,
            "slot_H": obj_out["H"],
            "slot_centroid": obj_out["centroid"],
            "slot_n_init": obj_out["n_init"],
            "slot_n_inlier": obj_out["n_inlier"],
            "used_motion_model": cam_out["used_motion_model"],
        }
        return {"new_state": new_state, "metrics": metrics}

    track_spans = (("mask_update", mask_update), ("camera_est", camera_est),
                   ("obj_track", obj_track), ("obj_est", obj_est),
                   ("map_update", map_update))

    def track_body(state: StreamState, inputs, draws: FrameDraws):
        ctx = {"state": state, "inputs": inputs, "draws": draws}
        for _, span in track_spans:
            ctx.update(span(ctx))
        return ctx["new_state"], ctx["metrics"]

    def init_body(state: StreamState, inputs, draws: FrameDraws):
        prep = prep_fn(inputs["rgb"], inputs["depth_raw"], inputs["flow"],
                       inputs["seg"], draws, inputs.get("fast_scores"))
        stat, dyn = init_fn(prep["stat_cand"], prep["obj_cand"])
        new_state = dataclasses.replace(state, frame=FrameState(
            static=stat, dynamic=dyn, T_cw=eye4, T_cw_gt=eye4, velocity=eye4,
            seg=inputs["seg"], flow_map=inputs["flow"],
            depth_map=prep["depth"]))

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        metrics = {
            "t_rpe": zeros(()), "r_rpe": zeros(()),
            "n_inlier": zeros((), torch.int64),
            "n_objects": zeros((), torch.int64),
            "speeds": zeros((Kobj,)),
            "slot_sem": zeros((Kobj,), torch.int32),
            "slot_model": zeros((Kobj,), torch.int32),
            "slot_active": zeros((Kobj,), torch.bool),
            "slot_H": eye4.repeat(Kobj, 1, 1),
            "slot_centroid": zeros((Kobj, 3)),
            "slot_n_init": zeros((Kobj,), torch.int64),
            "slot_n_inlier": zeros((Kobj,), torch.int64),
            "used_motion_model": zeros((), torch.bool),
        }
        return new_state, metrics

    return init_body, track_body, track_spans


def _make_batched_step(cfg: VDOConfig, device, packed: bool, finish):
    """step(states, inputs, uniforms, initialized) over a leading stream
    dimension; `finish(state, metrics)` maps one stream's results to the
    tensors the step returns for it."""
    init_body, track_body, _ = _make_bodies(cfg, device)
    unpack = stages.make_unpack(cfg)
    score = stages.make_score_pyramid(cfg)
    detect = not cfg.frontend.use_sample_feature

    def step(states: StreamState, inputs: dict, uniforms: dict,
             initialized: bool):
        if packed:
            inputs = unpack(inputs)          # all streams in one pass
        if detect:
            # the kernel call sits at batch level: one launch for all
            # streams (grid-sampled keypoints need no score)
            inputs = dict(inputs,
                          fast_scores=score(inputs["rgb"], batched=True))
        body = track_body if initialized else init_body

        def one(leaves, inp, u):
            state, metrics = body(_unflatten(leaves), inp, UniformDraws(u))
            return _flatten(state), finish(state, metrics)

        leaves, out = torch.func.vmap(one)(_flatten(states), inputs, uniforms)
        return _unflatten(leaves), out

    return step


STAGE_SPANS = ("mask_update", "camera_est", "obj_track", "obj_est",
               "map_update")
# the probe's spans: the 5 reference spans plus the fused path's own wire
# decode before them and output flattening after them, so that the spans
# account for the whole packed step
PROBE_SPANS = ("wire_unpack",) + STAGE_SPANS + ("output_pack",)


class _Clock:
    """Timed regions on one timeline: on a card two CUDA events on torch's
    current stream around the region's calls, the stream first held by a
    spin kernel (`torch.cuda._sleep`) for twice as long as the host took
    to queue a region so far, so that the region's work is queued before
    the device reaches its first event and the events see the device's
    time alone, with no wait on the host's dispatch; on the CPU two reads
    of the host clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.hold_ms = 1.0
        self._cycles_per_ms: float | None = None

    def _hold(self) -> None:
        if self._cycles_per_ms is None:
            cycles = 1 << 22
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            torch.cuda._sleep(cycles)
            b.record()
            b.synchronize()
            self._cycles_per_ms = cycles / max(a.elapsed_time(b), 1e-3)
        torch.cuda._sleep(int(self.hold_ms * self._cycles_per_ms))

    def region(self, fn, n: int) -> float:
        """ms of one region of n calls of fn()."""
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return (time.perf_counter() - t0) * 1e3
        self._hold()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        queued = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        self.hold_ms = max(self.hold_ms, 2.0 * queued + 1.0)
        return a.elapsed_time(b)


class ProbePrograms:
    """The probe's programs over static copies of its own of one frame's
    state, staged inputs and draws (`StaticTree`s; a graph bakes in every
    address it reads):

      * `spans`: one GraphedCall per PROBE_SPANS entry, in that order,
        span k+1 reading span k's outputs (`chain` runs them);
      * `frame`: one packed step plus pack_outputs, the production frame
        program, its state carried in `frame_state`, which each call
        steps (`reset_frame` copies the probe's state back in).

    `build` runs the frame program and the chain eagerly (the warm-up),
    then captures them in the same order: span k+1 is captured over span
    k's captured outputs, the static buffers span k's replays write.  On a
    card every graph lies in one shared memory pool, the spans' captures
    reusing what the frame program's frees; that is safe because no two
    replay at once and the chain is always replayed from its first span
    on, in capture order, so every span reads outputs replayed after any
    replay that may have overwritten them.  On the CPU every call runs
    eagerly on the same buffers."""

    def __init__(self, probe: "ScanProbe", state: StreamState,
                 packed_inputs: dict, draws: UniformDraws):
        from ..pipeline.fused import pack_outputs

        dev = probe.device
        self._step, self._pack = probe._step, pack_outputs
        self.pool = (torch.cuda.graph_pool_handle() if dev.type == "cuda"
                     else None)
        self.state = StaticTree(state, dev)
        self.state.load(state)
        self.frame_state = StaticTree(state, dev)
        self.inputs = StaticTree(packed_inputs, dev)
        self.inputs.load(packed_inputs)
        self.draws = StaticTree(draws.u, dev)
        self.draws.load(draws.u)
        self._draws = UniformDraws(self.draws.tree)
        self.ctx: dict = {}
        self.spans = [GraphedCall(functools.partial(self._span, span), dev,
                                  f"probe span {name}", pool=self.pool)
                      for name, span in probe.spans]
        self.frame = GraphedCall(self._frame, dev, "probe frame program",
                                 pool=self.pool)

    def _span(self, span):
        return span(self.ctx)

    def _frame(self):
        state, metrics = self._step(self.frame_state.tree, self.inputs.tree,
                                    self._draws, True)
        self.frame_state.write(state)
        return self._pack(state, metrics)

    def chain(self) -> Tensor:
        """Every span once, in order, each over the outputs of the ones
        before it; returns the last one's output vector (static on a card
        once captured: the next chain overwrites it)."""
        self.ctx = {"state": self.state.tree,
                    "packed_inputs": self.inputs.tree, "draws": self._draws}
        for call in self.spans:
            self.ctx.update(call())
        return self.ctx["vec"]

    def reset_frame(self) -> None:
        """The frame program's state back to the probe's state."""
        self.frame_state.load(self.state.tree)

    def build(self) -> None:
        """The warm-up of every program, then (on a card) its capture."""
        for _ in range(2):
            self.reset_frame()
            self.frame()
            self.chain()

    def calls(self) -> list[GraphedCall]:
        return self.spans + [self.frame]

    def close(self) -> None:
        """Drop the graphs and their outputs, and with them the pool, now
        rather than whenever the garbage collector reaches this object (its
        calls hold its bound methods: a cycle)."""
        for call in self.calls():
            call.graph = call.out = None
        self.ctx = {}


class ScanProbe:
    """The per-span timing probe of the fused path (make_scan_probe)."""

    def __init__(self, cfg: VDOConfig, device, n_iters: int):
        from ..pipeline.fused import pack_outputs

        self.n_iters = max(int(n_iters), 1)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "make_scan_probe(device='cuda'): no CUDA device; pass "
                "device='cpu' to run on the CPU")
        _, _, track_spans = _make_bodies(cfg, self.device)
        unpack = stages.make_unpack(cfg)
        self._step = make_frame_step(cfg, self.device, packed=True)
        self.spans = (
            (("wire_unpack",
              lambda ctx: {"inputs": unpack(ctx["packed_inputs"])}),)
            + track_spans
            + (("output_pack", lambda ctx: {"vec": pack_outputs(
                ctx["new_state"], ctx["metrics"])}),))
        if tuple(name for name, _ in self.spans) != PROBE_SPANS:
            raise AssertionError("the step's spans are not PROBE_SPANS")
        # what the last call built and spent (see __call__)
        self.report: dict | None = None

    def contexts(self, state: StreamState, packed_inputs: dict,
                 draws: FrameDraws):
        """Yield (name, span, ctx) in order, ctx holding what the spans
        before this one made: a span can be run (or profiled) alone and
        eagerly as span(ctx)."""
        ctx = {"state": state, "packed_inputs": packed_inputs,
               "draws": draws}
        for name, span in self.spans:
            yield name, span, ctx
            ctx = dict(ctx, **span(ctx))

    def programs(self, state: StreamState, packed_inputs: dict,
                 draws: UniformDraws) -> ProbePrograms:
        """The probe's programs over copies of (state, packed_inputs,
        draws), not built yet."""
        return ProbePrograms(self, state, packed_inputs, draws)

    def __call__(self, state: StreamState, packed_inputs: dict,
                 draws: UniformDraws, rounds: int = 2):
        """(times, rtt_ms): times maps each of PROBE_SPANS, and
        "_frame_ms", to ms per frame; rtt_ms is the baseline, an empty
        timed region.  A span is the least of `rounds` regions of n_iters
        replays of its program, less the baseline, over n_iters;
        "_frame_ms" likewise from the frame program, its state carried
        from the probe's state in each region.  One untimed pass of every
        region comes first; the chain's regions always run all spans in
        order.  `self.report` then holds the wall seconds, each graph's
        record with its replays and the shared pool's bytes; the graphs
        themselves are dropped."""
        t0 = time.perf_counter()
        rounds, n = max(int(rounds), 1), self.n_iters
        clock = _Clock(self.device)
        progs = self.programs(state, packed_inputs, draws)

        def spans():
            return [clock.region(call, n) for call in progs.spans]

        def frame():
            progs.reset_frame()
            return clock.region(progs.frame, n)

        try:
            progs.build()
            frame()
            spans()
            frame_ms = min(frame() for _ in range(rounds))
            span_ms = [spans() for _ in range(rounds)]
            rtt = min(clock.region(None, 0) for _ in range(rounds))
        finally:
            graphs = [dict(c.record, replays=c.replays)
                      for c in progs.calls() if c.record is not None]
            progs.close()
        times = {name: (min(r[k] for r in span_ms) - rtt) / n
                 for k, name in enumerate(PROBE_SPANS)}
        times["_frame_ms"] = max(frame_ms - rtt, 0.0) / n
        self.report = {
            "seconds": time.perf_counter() - t0, "graphs": graphs,
            "pool_reserved_bytes": sum(g["pool_reserved_bytes"]
                                       for g in graphs)}
        return times, rtt


def make_scan_probe(cfg: VDOConfig, device="cuda",
                    n_iters: int = 8) -> ScanProbe:
    """Per-span device-time probe of the fused path — the reference's
    5-span timing harness (Map.h:83-84, System.cc:204-237), port of the
    JAX package's make_scan_probe (multistream.py:256-488).

    The production step is one CUDA graph (utils/cuda_graph.py:
    StepGraph), which cannot be timed from inside.  The JAX package times
    prefix programs, prefix k running spans 1..k n_iters times in one
    executable, and takes span k as (T_k - T_{k-1}) / n_iters, in which the
    dispatch cancels.  Here each span of the packed step is a program of
    its own, a CUDA graph captured over the previous span's captured
    outputs (ProbePrograms), and span k is n_iters back-to-back replays of
    its graph between two CUDA events, less an empty region, over n_iters:
    for programs that run one after another on one stream that is
    T_k - T_{k-1}.  The stream is held until the region is queued
    (`_Clock`), so the host's dispatch is netted out.  A span is thus the
    device time per frame of its part of the production program, as in
    the JAX package.  The spans, in the JAX span map:
      wire_unpack  -> the int16 wire decode (stages.make_unpack)
      mask_update  -> mask propagation + prepare + inheritance
      camera_est   -> camera RANSAC + flow LM
      obj_track    -> scene flow + the device classifier
      obj_est      -> the per-object motion solves
      map_update   -> static + dynamic renewal, the new state
      output_pack  -> pipeline/fused.py:pack_outputs
    They are the spans that the step's track body composes
    (`_make_bodies`), so the probe times the code the step runs.
    "_frame_ms" is the production frame program (the packed step and
    pack_outputs), its state carried from replay to replay, per frame, less
    the baseline: the JAX package's scan of n_iters frame bodies is here
    n_iters replays of one frame's graph, as the tracker replays it.

    Unlike the JAX package, the wire is not perturbed by z * checksum of
    the previous outputs: that term keeps XLA from hoisting or eliminating
    work across the scan, and a captured stream is a fixed chain of
    kernels in which nothing is hoisted or eliminated.

    On the CPU the same programs run eagerly on the same buffers, timed by
    the host clock.  Nothing in the caller's state changes: the programs
    run on the probe's copies.

    Returns a ScanProbe: probe(state, packed_inputs, draws, rounds) ->
    (times_ms incl. "_frame_ms", rtt_ms)."""
    return ScanProbe(cfg, device, n_iters)


def shard_streams(tree, devices) -> list:
    """A stacked tree (a StreamState, or a dict of tensors, with a leading
    S) as one tree per device: device k holds the k-th contiguous block of
    S / len(devices) streams (the JAX package's shard_tree over a mesh of
    `devices`).  S must be a multiple of len(devices)."""
    devices = device_list(devices)
    n = len(devices)
    leaves = _flatten(tree) if isinstance(tree, StreamState) else None
    S = (leaves or list(tree.values()))[0].shape[0]
    if S % n:
        raise ValueError(f"{S} streams do not split evenly over {n} devices")
    per = S // n

    def block(x, k):
        return x[k * per:(k + 1) * per].to(devices[k])

    if leaves is not None:
        return [_unflatten([block(x, k) for x in leaves]) for k in range(n)]
    return [{key: block(x, k) for key, x in tree.items()} for k in range(n)]


def _gather(parts: list[Tensor], device) -> Tensor:
    """Per-device tensors of streams as one, on `device`."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([x.to(device) for x in parts])


def make_multistream_step(cfg: VDOConfig, device="cuda", devices=None):
    """The step for S streams (multistream.py:491-520).

    Returns pstep(states, inputs, uniforms, initialized) -> (states,
    metrics, fleet): `states` a StreamState with a leading S
    (`stack_states`), `inputs` the dense inputs with a leading S,
    `uniforms` the draws of pipeline/draws.py:frame_uniforms with a leading
    S, `initialized` one host bool for all streams.  `metrics` holds every
    stream's; `fleet` the cross-stream reductions: the means of t_rpe and
    r_rpe and the sum of n_objects.

    With `devices` (a list, which may repeat a device) the streams are
    spread over them as the JAX package spreads them over its mesh: pstep
    then takes and returns `states`, `inputs`, `uniforms` and `metrics` as
    lists with one entry per device, device k's block of streams on
    devices[k] (`shard_streams` splits a stacked tree so), runs one batched
    step per device, and gathers every stream's metrics onto devices[0]
    for `fleet`.  Without, everything lies on `device`.
    """
    def metrics_only(state, metrics):
        return metrics

    targets = ([torch.device(device)] if devices is None
               else device_list(devices))
    steps = [_make_batched_step(cfg, d, packed=False, finish=metrics_only)
             for d in targets]

    def pstep(states, inputs, uniforms, initialized: bool):
        if devices is None:
            states, inputs, uniforms = [states], [inputs], [uniforms]
        out = []
        for d, step, st, inp, u in zip(targets, steps, states, inputs,
                                       uniforms):
            with on_device(d):
                out.append(step(st, inp, u, initialized))
        states = [o[0] for o in out]
        metrics = [o[1] for o in out]
        fleet = {"mean_t_rpe": _gather([m["t_rpe"] for m in metrics],
                                       targets[0]).mean(),
                 "mean_r_rpe": _gather([m["r_rpe"] for m in metrics],
                                       targets[0]).mean(),
                 "total_objects": _gather([m["n_objects"] for m in metrics],
                                          targets[0]).sum()}
        if devices is None:
            return states[0], metrics[0], fleet
        return states, metrics, fleet

    return pstep
