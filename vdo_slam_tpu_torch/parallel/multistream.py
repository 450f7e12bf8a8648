"""The fused per-frame tracking step, for one stream and for S — port of
make_stream_state, make_frame_step and make_multistream_step of
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
Spreading streams over several devices (the JAX package's Mesh and
NamedSharding) is not ported: one device holds all S.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import VDOConfig
from ..ops import frontend, select
from ..pipeline import stages
from ..pipeline.draws import FrameDraws, UniformDraws
from ..pipeline.state import (DynamicBank, FrameState, StaticBank, field,
                              frame_state_from_numpy, to_tensor)

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
    init_body, track_body = _make_bodies(cfg, device)
    unpack = stages.make_unpack(cfg)

    def step(state: StreamState, inputs, draws: FrameDraws,
             initialized: bool):
        if packed:
            inputs = unpack(inputs)
        body = track_body if initialized else init_body
        return body(state, inputs, draws)

    return step


def _make_bodies(cfg: VDOConfig, device):
    """(init_body, track_body) of the step, each (state, dense inputs,
    draws) -> (state, metrics)."""
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

    def track_body(state: StreamState, inputs, draws: FrameDraws):
        last = state.frame
        # mask-propagation repair (UpdateMask, Tracking.cc:2997-3241)
        if tr.fused_mask_prop:
            seg, _ = mask_prop_fn(inputs["seg"], last.seg, last.flow_map,
                                  last.dynamic, _label_table(last.dynamic))
        else:
            seg = inputs["seg"]
        prep = prep_fn(inputs["rgb"], inputs["depth_raw"], inputs["flow"],
                       seg, draws, inputs.get("fast_scores"))
        depth = prep["depth"]
        stat_cur, dyn_cur = inherit_fn(last.static, last.dynamic, depth, seg)
        cam_out = camera_fn(last.static, stat_cur["xy"], stat_cur["depth"],
                            last.T_cw, last.velocity, inputs["T_cw_gt"],
                            last.T_cw_gt, draws)
        T_cw = cam_out["T_cw"]
        sf = sflow_fn(last.dynamic, dyn_cur["xy"], dyn_cur["depth"],
                      dyn_cur["sem_label"], last.T_cw, T_cw)
        cls = classify_fn(
            dyn_cur["sem_label"], dyn_cur["valid"] & sf["sem_ok"],
            sf["sf_norm"], dyn_cur["depth"], dyn_cur["xy"],
            last.dynamic.sem_label, state.slot_sem, state.slot_model,
            state.slot_H, state.slot_active, state.max_id)
        obj_out = objects_fn(
            last.dynamic, dyn_cur["xy"], dyn_cur["depth"],
            dyn_cur["sem_label"], cls["slot_sem"], cls["slot_active"],
            cls["slot_has_mm"], cls["slot_H_prev"], cls["member_ok"],
            last.T_cw, T_cw, draws)
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
            inputs["flow"], seg, T_cw, draws)
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
        return new_state, metrics

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

    return init_body, track_body


def _make_batched_step(cfg: VDOConfig, device, packed: bool, finish):
    """step(states, inputs, uniforms, initialized) over a leading stream
    dimension; `finish(state, metrics)` maps one stream's results to the
    tensors the step returns for it."""
    init_body, track_body = _make_bodies(cfg, device)
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


def make_multistream_step(cfg: VDOConfig, device="cuda"):
    """The step for S streams on one device (multistream.py:491-520).

    Returns pstep(states, inputs, uniforms, initialized) -> (states,
    metrics, fleet): `states` a StreamState with a leading S
    (`stack_states`), `inputs` the dense inputs with a leading S,
    `uniforms` the draws of pipeline/draws.py:frame_uniforms with a leading
    S, `initialized` one host bool for all streams.  `metrics` holds every
    stream's; `fleet` the cross-stream reductions, plain means and sums on
    the one device.
    """
    step = _make_batched_step(cfg, device, packed=False,
                              finish=lambda state, metrics: metrics)

    def pstep(states, inputs, uniforms, initialized: bool):
        states, metrics = step(states, inputs, uniforms, initialized)
        fleet = {"mean_t_rpe": metrics["t_rpe"].mean(),
                 "mean_r_rpe": metrics["r_rpe"].mean(),
                 "total_objects": metrics["n_objects"].sum()}
        return states, metrics, fleet

    return pstep
