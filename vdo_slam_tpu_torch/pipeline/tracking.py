"""The host-orchestrated tracker (System mode "reference") — port of
vdo_slam_tpu/pipeline/tracking.py.

Host-side equivalent of the reference Tracking class (src/Tracking.cc): a
per-frame state machine that sequences the device stages
(pipeline/stages.py) and does the small label bookkeeping between them on
the host.  Everything per pixel or per feature runs on the device; the
host touches only O(labels) metadata and the append-only MapState archive.
The numpy helpers (`_np_inv`, the GT pose parsers), the host classifier
and the label association are the JAX package's, copied verbatim: the same
`np.unique`, `Counter.most_common` and tie order.

Against the JAX package:
  * the five timed spans end with `torch.cuda.synchronize(device)` where
    the JAX tracker calls `block_until_ready`, so `timing_summary` means
    the same thing;
  * each span's host reads are gathered into ONE copy to a pinned buffer
    (`_fetch`), where the JAX tracker makes one `np.asarray` read per
    array; the values are the same;
  * a frame's random draws come from `_frame_draws()`, the per-frame draws
    of pipeline/draws.py (a function of cfg.seed and the frame index, as
    in the fused tracker), where the JAX tracker splits one key chain; a
    test overrides `_frame_draws` to replay that chain.

State machine (Tracking.h:119-123): NO_IMAGES_YET -> NOT_INITIALIZED -> OK.
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np
import torch

from ..config import KITTI, OMD, VDOConfig
from . import draws as draws_mod
from . import stages
from .map_state import MapState
from .state import FrameState

Tensor = torch.Tensor


def _np_inv(T: np.ndarray) -> np.ndarray:
    out = np.eye(4, dtype=np.float32)
    R = T[:3, :3]
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ T[:3, 3]
    return out


def obj_pose_parsing_kt(row: np.ndarray) -> np.ndarray:
    """KITTI object_pose row -> camera-frame object pose
    (Tracking::ObjPoseParsingKT, Tracking.cc:2010-2118): translation row[6:9],
    rotation = R_y(yaw + pi/2) with the reference's Ry*Rx*Rz composition at
    x=z=0."""
    t = row[6:9]
    y = row[9] + np.pi / 2.0
    cy, sy = np.cos(y), np.sin(y)
    R = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def obj_pose_parsing_ox(row: np.ndarray, origin_inv: np.ndarray) -> np.ndarray:
    """OMD object_pose row -> world object pose (ObjPoseParsingOX,
    Tracking.cc:2120-2182): axis-angle row[5:8], translation row[2:5],
    normalized by the first camera pose."""
    t = row[2:5]
    rvec = row[5:8].astype(np.float64)
    angle = np.linalg.norm(rvec)
    if angle > 0:
        k = rvec / angle
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * (Kx @ Kx)
    else:
        R = np.eye(3)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R.astype(np.float32)
    T[:3, 3] = t
    return _np_inv(origin_inv) @ T


def upload(x, dtype, device) -> Tensor:
    """A host array on `device`: through a pinned buffer and an
    asynchronous copy on a CUDA device, so the upload queues behind the
    work in flight instead of waiting for it."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=dtype))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


class ObjectTrack:
    """Per-slot metadata carried across frames (host side)."""

    __slots__ = ("model_label", "sem_label", "H", "active")

    def __init__(self, model_label: int, sem_label: int, H: np.ndarray):
        self.model_label = model_label
        self.sem_label = sem_label
        self.H = H
        self.active = True


class Tracker:
    def __init__(self, cfg: VDOConfig, game_map: MapState | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Tracker(device='cuda'): no CUDA device; pass device='cpu' "
                "to run on the CPU")
        self.map = game_map if game_map is not None else MapState()
        self.state: FrameState | None = None
        self.frame_id = 0
        self.max_id = 1                    # global object-track id counter
        self.origin_inv: np.ndarray | None = None
        self._generator = torch.Generator(device=self.device)
        # host mirrors of last-frame label arrays (for association)
        self._last_sem: np.ndarray | None = None
        self._last_tracks: list[ObjectTrack] = []
        self._last_obj_rows: np.ndarray = np.zeros((0, 10), np.float32)
        self._last_seg: Tensor | None = None
        self._last_flow: Tensor | None = None
        # host mirror of state.T_cw_gt (the GT pose this tracker uploaded)
        self._T_cw_gt_host = np.eye(4, dtype=np.float32)
        dev = self.device
        self._prepare = stages.make_prepare(cfg, dev)
        self._mask_prop = stages.make_mask_prop(cfg, dev)
        self._inherit = stages.make_inherit(cfg, dev)
        self._camera = stages.make_camera_stage(cfg, dev)
        self._scene_flow = stages.make_scene_flow(cfg, dev)
        self._objects = stages.make_objects_stage(cfg, dev)
        self._renew_static, self._renew_dynamic = stages.make_renew_stage(
            cfg, dev)
        self._init_banks = stages.make_init_stage(cfg, dev)
        self.local_ba_hook = None          # set by System (backend trigger)

    # -- helpers ----------------------------------------------------------

    def _frame_draws(self) -> draws_mod.FrameDraws:
        """The random draws of frame `self.frame_id`, taken once per frame
        by every stage of it."""
        return draws_mod.UniformDraws(draws_mod.frame_uniforms(
            self.cfg, self.frame_id, self._generator))

    def _put(self, x, dtype) -> Tensor:
        return upload(x, dtype, self.device)

    def _fetch(self, *tensors: Tensor) -> list[np.ndarray]:
        """The tensors as numpy arrays, in ONE device-to-host copy on a
        CUDA device: their bytes concatenated, copied to a pinned buffer,
        one wait, split again.  The values are unchanged."""
        if self.device.type != "cuda":
            return [t.numpy() for t in tensors]
        flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                          for t in tensors])
        host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        raw, out, o = host.numpy(), [], 0
        for t in tensors:
            n = t.numel() * t.element_size()
            dt = torch.empty(0, dtype=t.dtype).numpy().dtype
            out.append(raw[o:o + n].view(dt).reshape(tuple(t.shape)).copy())
            o += n
        return out

    def _sync(self) -> None:
        """End of a timed span: wait for the device (block_until_ready)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _upload_frame(self, fd):
        return (self._put(fd.rgb, np.float32),
                self._put(fd.depth_raw, np.float32),
                self._put(fd.flow, np.float32), self._put(fd.mask, np.int32))

    def _gt_pose(self, T_cw_gt_raw: np.ndarray) -> np.ndarray:
        """Origin-normalized GT world->camera (Tracking.cc:320-331).

        The first frame's GT is exactly I (matching the pose-chain init)
        even when the run starts mid-sequence (raw origin != I)."""
        if self.origin_inv is None:
            self.origin_inv = np.asarray(T_cw_gt_raw, np.float32)
        return _np_inv(np.asarray(T_cw_gt_raw, np.float32)) @ self.origin_inv

    def _parse_obj_rows(self, rows: np.ndarray, T_wc_gt: np.ndarray):
        """Object GT poses in WORLD frame keyed by semantic id
        (Tracking.cc:334-342 + 789-865)."""
        out = {}
        boxes = {}
        for r in np.asarray(rows, np.float32).reshape(-1, 10):
            sem = int(r[1])
            if self.cfg.tracking.dataset == OMD:
                out[sem] = obj_pose_parsing_ox(r, self.origin_inv)
            else:
                out[sem] = T_wc_gt @ obj_pose_parsing_kt(r)
            boxes[sem] = r[2:6]
        return out, boxes

    # -- public API --------------------------------------------------------

    def grab_frame(self, fd) -> dict:
        """Process one RGB-D(+flow+mask) frame; the TrackRGBD equivalent."""
        t_start = time.perf_counter()
        if self.frame_id == 0:
            out = self._initialize(fd)
        else:
            out = self._track(fd)
        out["frame_id"] = self.frame_id
        out["wall_time"] = time.perf_counter() - t_start
        self.frame_id += 1
        return out

    # -- frame 0 -----------------------------------------------------------

    def _initialize(self, fd) -> dict:
        rgb, depth_raw, flow, seg = self._upload_frame(fd)
        prep = self._prepare(rgb, depth_raw, flow, seg, self._frame_draws())
        stat, dyn = self._init_banks(prep["stat_cand"], prep["obj_cand"])
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        self.state = FrameState(
            static=stat, dynamic=dyn, T_cw=eye, T_cw_gt=eye, velocity=eye,
            seg=seg, flow_map=flow, depth_map=prep["depth"],
        )
        self._T_cw_gt_host = np.eye(4, dtype=np.float32)
        self._gt_pose(fd.pose_gt_raw)  # records origin
        (s_xy, s_d, s_3d, s_v, d_xy, d_d, d_3d, d_v, d_ol,
         d_sl) = self._fetch(stat.xy, stat.depth, stat.point_w, stat.valid,
                             dyn.xy, dyn.depth, dyn.point_w, dyn.valid,
                             dyn.obj_label, dyn.sem_label)
        self._last_sem = d_sl
        self._last_obj_rows = fd.obj_gt_rows
        self._last_seg = seg
        self._last_flow = flow

        # archive frame 0 (Tracking::Initialization, Tracking.cc:1215-1276)
        m = self.map
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
        m.cam_pose.append(np.eye(4, dtype=np.float32))
        m.cam_pose_rf.append(np.eye(4, dtype=np.float32))
        m.cam_pose_gt.append(np.eye(4, dtype=np.float32))
        m.timings.append(np.zeros(5, np.float32))
        return {"T_cw": np.eye(4, dtype=np.float32), "objects": []}

    # -- frame >= 1 ---------------------------------------------------------

    def _track(self, fd) -> dict:
        cfg = self.cfg
        tr = cfg.tracking
        Kobj = cfg.shapes.max_objects
        last = self.state
        timings = np.zeros(5, np.float32)
        draws = self._frame_draws()

        # ---- (0) mask propagation (UpdateMask) ---------------------------
        t0 = time.perf_counter()
        rgb, depth_raw, flow, seg = self._upload_frame(fd)
        uniq_last = np.unique(self._last_sem[self._last_sem > 0])
        table = np.zeros(cfg.shapes.max_sem_labels, np.int32)
        table[: min(len(uniq_last), len(table))] = uniq_last[: len(table)]
        seg, _lost = self._mask_prop(
            seg, self._last_seg, self._last_flow, last.dynamic,
            self._put(table, np.int32),
        )
        prep = self._prepare(rgb, depth_raw, flow, seg, draws)
        depth = prep["depth"]
        stat_cur, dyn_cur = self._inherit(last.static, last.dynamic, depth, seg)
        self._sync()
        timings[0] = (time.perf_counter() - t0) * 1e3

        # ---- (1) camera pose ---------------------------------------------
        t1 = time.perf_counter()
        T_cw_gt_host = self._gt_pose(fd.pose_gt_raw)
        T_cw_gt = self._put(T_cw_gt_host, np.float32)
        cam_out = self._camera(
            last.static, stat_cur["xy"], stat_cur["depth"], last.T_cw,
            last.velocity, T_cw_gt, last.T_cw_gt, draws,
        )
        T_cw = cam_out["T_cw"]
        self._sync()
        timings[1] = (time.perf_counter() - t1) * 1e3

        # ---- (2) scene flow + dynamic classification ----------------------
        t2 = time.perf_counter()
        sf = self._scene_flow(
            last.dynamic, dyn_cur["xy"], dyn_cur["depth"],
            dyn_cur["sem_label"], last.T_cw, T_cw,
        )
        # host gating over <=L labels (DynObjTracking, Tracking.cc:1366-1612)
        cur_sem, dyn_valid, sem_ok, sf_norm, depths, xy = self._fetch(
            dyn_cur["sem_label"], dyn_cur["valid"], sf["sem_ok"],
            sf["sf_norm"], dyn_cur["depth"], dyn_cur["xy"])
        valid = dyn_valid & sem_ok
        H_img, W_img = fd.rgb.shape[:2]
        sr = tr.boundary_shrink_row if tr.dataset == KITTI else 0
        sc = tr.boundary_shrink_col if tr.dataset == KITTI else 0

        feat_class = np.full(cur_sem.shape, -2, np.int64)  # device obj_label draft
        feat_class[~valid & dyn_valid] = -1
        active: list[tuple[int, np.ndarray]] = []  # (sem_label, member_mask)
        for lab in np.unique(cur_sem[valid & (cur_sem > 0)]):
            mask = valid & (cur_sem == lab)
            n = int(mask.sum())
            if n == 0:
                continue
            u, v = xy[mask, 0], xy[mask, 1]
            frac_boundary = np.mean(
                (v < sr) | (v > H_img - sr) | (u < sc) | (u > W_img - sc)
            )
            if frac_boundary > tr.boundary_frac_thres:
                feat_class[mask] = -1
                continue
            frac_static = np.mean(sf_norm[mask] < tr.sf_mg_thres)
            if frac_static > tr.sf_ds_thres:
                feat_class[mask] = 0          # static object
                continue
            if depths[mask].mean() > tr.th_depth_obj or n < tr.min_obj_points:
                feat_class[mask] = -1         # too far / too small
                continue
            active.append((int(lab), mask))

        # label association with last frame (Tracking.cc:1537-1596)
        slot_sem = np.zeros(Kobj, np.int32)
        slot_model = np.zeros(Kobj, np.int32)
        slot_active = np.zeros(Kobj, bool)
        slot_has_mm = np.zeros(Kobj, bool)
        slot_H_prev = np.tile(np.eye(4, dtype=np.float32), (Kobj, 1, 1))
        last_by_sem = {t.sem_label: t for t in self._last_tracks if t.active}
        new_tracks: list[ObjectTrack] = []
        for k, (lab, mask) in enumerate(active[:Kobj]):
            lb_last = self._last_sem[mask]
            lb_last = lb_last[lb_last > 0]
            new_lab = int(Counter(lb_last.tolist()).most_common(1)[0][0]) \
                if lb_last.size else lab
            if new_lab in last_by_sem:
                model = last_by_sem[new_lab].model_label
                slot_has_mm[k] = True
                slot_H_prev[k] = last_by_sem[new_lab].H
            else:
                model = self.max_id
                self.max_id += 1
            slot_sem[k] = lab
            slot_model[k] = model
            slot_active[k] = True
            feat_class[mask] = model
            new_tracks.append(ObjectTrack(model, lab, np.eye(4, dtype=np.float32)))
        self._sync()
        timings[2] = (time.perf_counter() - t2) * 1e3

        # ---- (3) object motion estimation ---------------------------------
        t3 = time.perf_counter()
        slot_sem_d = self._put(slot_sem, np.int32)
        obj_out = self._objects(
            last.dynamic, dyn_cur["xy"], dyn_cur["depth"],
            dyn_cur["sem_label"], slot_sem_d,
            self._put(slot_active, bool), self._put(slot_has_mm, bool),
            self._put(slot_H_prev, np.float32),
            self._put(feat_class > 0, bool), last.T_cw, T_cw, draws,
        )
        (n_init, inlier, H_est, speeds, centroids, members,
         n_inlier) = self._fetch(
            obj_out["n_init"], obj_out["inlier"], obj_out["H"],
            obj_out["speed"], obj_out["centroid"], obj_out["members"],
            obj_out["n_inlier"])
        self._sync()
        timings[3] = (time.perf_counter() - t3) * 1e3

        # GT motion lookup + failure marking (Tracking.cc:89-191)
        T_wc_gt_cur = _np_inv(T_cw_gt_host)
        T_wc_gt_last = _np_inv(self._T_cw_gt_host)
        gt_cur, _ = self._parse_obj_rows(fd.obj_gt_rows, T_wc_gt_cur)
        gt_last, _ = self._parse_obj_rows(self._last_obj_rows, T_wc_gt_last)

        objects = []
        final_class = feat_class.copy()
        for k, trk in enumerate(new_tracks):
            sem = slot_sem[k]
            ok_gt = (sem in gt_cur) and (sem in gt_last)
            ok_init = n_init[k] >= tr.min_init_inliers
            stat_ok = bool(ok_gt and ok_init)
            trk.active = stat_ok
            trk.H = H_est[k] if stat_ok else np.eye(4, dtype=np.float32)
            if stat_ok:
                L_w_p = gt_last[sem]
                L_w_c = gt_cur[sem]
                H_gt_body = _np_inv(L_w_p) @ L_w_c
                H_p_c = L_w_c @ _np_inv(L_w_p)
                v_gt = H_p_c[:3, 3] - (np.eye(3) - H_p_c[:3, :3]) @ centroids[k]
                speed_gt = float(np.linalg.norm(v_gt) * 36.0)
                # reject LM outliers from the track (Optimizer.cc:2961-2968)
                final_class[members[k] & ~inlier[k]] = -1
            else:
                H_gt_body = np.eye(4, dtype=np.float32)
                L_w_p = np.eye(4, dtype=np.float32)
                speed_gt = 0.0
                final_class[members[k]] = -1
            objects.append({
                "slot": k,
                "model_label": int(slot_model[k]),
                "sem_label": int(sem),
                "H": H_est[k] if stat_ok else np.eye(4, dtype=np.float32),
                "H_gt_body": H_gt_body,
                "obj_pose_pre": L_w_p,
                "centroid": centroids[k],
                "speed": float(speeds[k]) if stat_ok else 0.0,
                "speed_gt": speed_gt,
                "status": stat_ok,
                "n_inlier": int(n_inlier[k]),
                "n_init": int(n_init[k]),
            })
        self._last_tracks = new_tracks

        # ---- (4) renewal ---------------------------------------------------
        t4 = time.perf_counter()
        stat_new = self._renew_static(
            cam_out["uv_cur"], cam_out["inlier"], prep["det_xy"],
            prep["det_valid"], prep["det_score"], depth, flow, seg, T_cw,
        )
        carry_dyn = self._put(final_class > 0, bool) & obj_out["inlier"].any(
            dim=0)
        track_ok = np.array([t.active for t in new_tracks]
                            + [False] * (Kobj - len(new_tracks)), bool)
        dyn_new = self._renew_dynamic(
            obj_out["uv_cur"], self._put(final_class, np.int32), carry_dyn,
            prep["obj_cand"], slot_sem_d, self._put(slot_model, np.int32),
            self._put(slot_active & track_ok, bool),
            depth, flow, seg, T_cw, draws,
        )
        self._sync()
        timings[4] = (time.perf_counter() - t4) * 1e3

        # ---- archive -------------------------------------------------------
        host = self._fetch(
            stat_new.xy, stat_new.depth, stat_new.point_w, stat_new.valid,
            stat_new.assoc, dyn_new.xy, dyn_new.depth, dyn_new.point_w,
            dyn_new.valid, dyn_new.assoc, dyn_new.obj_label,
            dyn_new.sem_label, T_cw, cam_out["velocity"], cam_out["t_rpe"],
            cam_out["r_rpe"], cam_out["n_inlier"],
            cam_out["used_motion_model"])
        self._archive(fd, host, T_cw_gt_host, objects, timings)

        # ---- advance state -------------------------------------------------
        self.state = FrameState(
            static=stat_new, dynamic=dyn_new, T_cw=T_cw, T_cw_gt=T_cw_gt,
            velocity=cam_out["velocity"], seg=seg, flow_map=flow,
            depth_map=depth,
        )
        self._T_cw_gt_host = T_cw_gt_host
        self._last_sem = host[11]
        self._last_obj_rows = fd.obj_gt_rows
        self._last_seg = seg
        self._last_flow = flow

        # ---- windowed BA trigger (Tracking.cc:1168-1183) -------------------
        f_id = self.frame_id
        w, o = tr.window_size, tr.overlap_size
        if (self.local_ba_hook is not None and f_id >= w - 1
                and (f_id - o + 1) % (w - o) == 0):
            t5 = time.perf_counter()
            self.local_ba_hook(self.map)
            self.map.lba_times.append((time.perf_counter() - t5) * 1e3)

        return {
            "T_cw": host[12],
            "t_rpe": float(host[14]),
            "r_rpe": float(host[15]),
            "n_inlier_cam": int(host[16]),
            "used_motion_model": bool(host[17]),
            "objects": objects,
            "timings_ms": timings,
        }

    # -- map archive --------------------------------------------------------

    def _archive(self, fd, host, T_cw_gt, objects, timings):
        """Push per-frame results (Track 'Save Graph Structure',
        Tracking.cc:1050-1161).  `host`: the new banks, T_cw and velocity
        as numpy, in the order `_track` fetches them."""
        (s_xy, s_d, s_3d, s_v, s_a, d_xy, d_d, d_3d, d_v, d_a, d_ol, d_sl,
         T_cw, velocity) = host[:14]
        m = self.map
        m.stat_xy.append(s_xy)
        m.stat_depth.append(s_d)
        m.stat_3d.append(s_3d)
        m.stat_valid.append(s_v)
        m.stat_assoc.append(s_a)
        m.dyn_xy.append(d_xy)
        m.dyn_depth.append(d_d)
        m.dyn_3d.append(d_3d)
        m.dyn_valid.append(d_v)
        m.dyn_assoc.append(d_a)
        m.dyn_obj_label.append(d_ol)
        m.dyn_sem_label.append(d_sl)

        T_wc = _np_inv(T_cw)
        m.cam_pose.append(T_wc)
        m.cam_pose_rf.append(T_wc.copy())
        m.cam_pose_gt.append(_np_inv(T_cw_gt))

        cam_motion = _np_inv(velocity)
        mots = [cam_motion]
        mots_gt = [self._T_cw_gt_host @ _np_inv(T_cw_gt)]
        poses_pre = [cam_motion]
        labels = [0]
        sems = [0]
        stats = [True]
        sp_gt = [1.0]
        sp_est = [0.0]
        cents = [np.zeros(3, np.float32)]
        for ob in objects:
            if not ob["status"]:
                continue
            mots.append(ob["H"])
            mots_gt.append(ob["H_gt_body"])
            poses_pre.append(ob["obj_pose_pre"])
            labels.append(ob["model_label"])
            sems.append(ob["sem_label"])
            stats.append(True)
            sp_gt.append(ob["speed_gt"])
            sp_est.append(ob["speed"])
            cents.append(ob["centroid"])
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
            [int(r[1]) for r in np.asarray(fd.obj_gt_rows).reshape(-1, 10)]
        )
        m.timings.append(timings)
