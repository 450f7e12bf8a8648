"""The fused per-frame tracking step — port of make_stream_state and
make_frame_step (packed=False) of vdo_slam_tpu/parallel/multistream.py.

One step runs the whole frame: mask propagation, front end, inheritance,
camera RANSAC + joint flow-pose LM, scene flow, the on-device classifier,
the per-slot object solves and renewal.  The JAX step branches on its
`initialized` flag with lax.cond; here the tracker keeps that flag as a
host bool and passes it in, so the step never reads the device.  One
stream per step: multistream (S > 1) is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import VDOConfig
from ..ops import frontend, select
from ..pipeline import stages
from ..pipeline.draws import FrameDraws
from ..pipeline.stages import check_slice
from ..pipeline.state import DynamicBank, FrameState, StaticBank

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


def state_from_numpy(tree, device="cuda") -> tuple[StreamState, bool]:
    """A JAX stream state pulled to numpy (`jax.device_get` of the dict of
    make_stream_state) -> (StreamState, initialized).  Leaves are read by
    name, from dict keys or attributes, so no JAX type is needed here."""
    def get(obj, name):
        leaf = obj[name] if isinstance(obj, dict) else getattr(obj, name)
        if isinstance(leaf, dict) or dataclasses.is_dataclass(leaf):
            return leaf
        return torch.from_numpy(np.array(leaf)).to(device)  # writable copy

    def conv(obj, cls):
        return cls(**{f.name: get(obj, f.name)
                      for f in dataclasses.fields(cls)})

    fr = get(tree, "frame")
    frame = FrameState(
        static=conv(get(fr, "static"), StaticBank),
        dynamic=conv(get(fr, "dynamic"), DynamicBank),
        **{name: get(fr, name) for name in ("T_cw", "T_cw_gt", "velocity",
                                            "seg", "flow_map", "depth_map")})
    state = StreamState(frame=frame, **{
        f.name: get(tree, f.name)
        for f in dataclasses.fields(StreamState) if f.name != "frame"})
    return state, bool(get(tree, "initialized"))


def make_frame_step(cfg: VDOConfig, device="cuda"):
    """One fused tracking step for one stream.

    Returns step(state, inputs, draws, initialized) -> (state, metrics),
    where inputs = dict(rgb, depth_raw, flow, seg, T_cw_gt[, gt_sems]) are
    tensors on `device`.  initialized=False runs frame-0 initialization.
    """
    check_slice(cfg)
    tr = cfg.tracking
    Kobj = cfg.shapes.max_objects
    L_tab = cfg.shapes.max_sem_labels
    prep_fn = stages.make_prepare(cfg)
    mask_prop_fn = stages.make_mask_prop(cfg)
    inherit_fn = stages.make_inherit(cfg)
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
        counts[0] = 0.0
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
                       seg, draws)
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
                       inputs["seg"], draws)
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

    def step(state: StreamState, inputs, draws: FrameDraws,
             initialized: bool):
        body = track_body if initialized else init_body
        return body(state, inputs, draws)

    return step
