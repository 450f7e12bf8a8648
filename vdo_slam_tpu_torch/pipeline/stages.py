"""Device stages of the per-frame tracking step — port of
vdo_slam_tpu/pipeline/stages.py.

Each `make_*` builds a stage for one configuration and device.  The vmaps
of the JAX package over object slots and RANSAC hypotheses are leading
batch dimensions; the random draws come from a `FrameDraws` object
(pipeline/draws.py).  Every option of the JAX stages is here: camera
distortion (the banks in pinhole space, the maps in raw space, `_warps`),
grid-sampled keypoints (use_sample_feature), and the reprojection-only
camera and object solves (joint_flow=False), which take the JAX package's
uncompacted object route.  The stages serve the host Tracker
(pipeline/tracking.py) and the fused step alike.  Every stage also runs
under `torch.func.vmap` over a leading stream dimension, except the FAST
scoring (`make_score_pyramid`), which takes the streams as a batch: a
kernel launch cannot be mapped.
"""

from __future__ import annotations

import torch

from ..config import VDOConfig
from ..geometry import camera as cam
from ..geometry import metrics, se3
from ..io.packing import unpack_frame, wire_kwargs
from ..ops import fast, frontend, select
from ..ops.image import gather_int, preprocess_depth, rgb_to_gray
from ..ops import undistort
from ..solvers import FlowLMParams, flow_lm, ransac, reproj_lm
from .draws import FrameDraws
from .state import DynamicBank, StaticBank

Tensor = torch.Tensor


def _K(cfg: VDOConfig, device) -> Tensor:
    c = cfg.camera
    return torch.tensor([c.fx, c.fy, c.cx, c.cy], dtype=torch.float32,
                        device=device)


def _lm_params(cfg: VDOConfig, for_objects: bool) -> FlowLMParams:
    s = cfg.solver
    return FlowLMParams(
        info_proj=s.info_proj,
        info_flow=s.info_flow_obj if for_objects else s.info_flow_cam,
        rp_thres=s.rp_thres,
        iters=(s.lm_iters_obj if for_objects and s.lm_iters_obj is not None
               else s.lm_iters),
        lambda_init=s.lm_lambda_init,
    )


def _warps(cfg: VDOConfig, device):
    """(to_pinhole, to_raw) pixel-coordinate warps, or None when the camera
    has zero distortion (every shipped config; the reference's early-out at
    Frame.cc:383-387).

    With nonzero coefficients the feature banks live in PINHOLE
    (undistorted) coordinates, where pi and unproject are exact (the
    reference's mvKeysUn, Frame.cc:233, 381-410), while the depth, flow and
    mask maps stay in RAW image space, so every map gather converts with
    the exact forward model to_raw (stages.py:38-58).
    """
    c = cfg.camera
    coeffs = (c.k1, c.k2, c.p1, c.p2, c.k3)
    if not any(coeffs):
        return None
    K = _K(cfg, device)
    dvec = torch.tensor(coeffs, dtype=torch.float32, device=device)
    return (lambda uv: undistort.undistort_points(uv, K, dvec),
            lambda uv: undistort.distort_points(uv, K, dvec))


def obj_solver_cap(cfg: VDOConfig) -> int:
    """Per-slot bank size M of the compacted object solve (stages.py:290-294);
    renewal's per-label quota bounds slot membership, so gathering each
    slot's members into (K, M) is exact."""
    cap = cfg.shapes.obj_solver_cap
    if cap is None:
        cap = max(-(-(cfg.tracking.max_track_points_obj * 5 // 4) // 128) * 128,
                  256)
    return min(cfg.shapes.max_dynamic, cap)


# --------------------------------------------------------------------------
# wire decode (the step's first stage when it is fed packed frames)
# --------------------------------------------------------------------------

def make_unpack(cfg: VDOConfig):
    """inputs {"packed", "T_cw_gt"[, "gt_sems"]} -> the dense inputs of
    the step (multistream.py:221-232).  Leading dimensions of the buffer
    (a chunk's frames, the S streams) are decoded in one pass."""
    kw = wire_kwargs(cfg.tracking)
    hw = (cfg.camera.height, cfg.camera.width)

    def unpack(inputs: dict) -> dict:
        gray, depth_raw, flow, seg = unpack_frame(inputs["packed"], hw=hw,
                                                  **kw)
        dense = {k: v for k, v in inputs.items() if k != "packed"}
        dense.update(rgb=gray, depth_raw=depth_raw, flow=flow, seg=seg)
        return dense

    return unpack


# --------------------------------------------------------------------------
# prepare
# --------------------------------------------------------------------------

def make_score_pyramid(cfg: VDOConfig):
    """rgb (H, W[, 3]), or (S, H, W[, 3]) with batched=True -> the FAST
    score maps of every pyramid level, the detector's only kernel: one
    launch for all levels of all S frames."""
    fe = cfg.frontend

    def score(rgb, batched: bool = False):
        gray = rgb if rgb.ndim == 2 + batched else rgb_to_gray(rgb)
        return fast.score_pyramid(
            gray, n_levels=fe.n_levels,
            scale_factor=fe.scale_factor, ini_th=float(fe.ini_th_fast),
            min_th=float(fe.min_th_fast))

    return score


def make_prepare(cfg: VDOConfig, device):
    B = cfg.shapes.max_static
    D = cfg.shapes.max_dynamic
    fe = cfg.frontend
    tr = cfg.tracking
    score_fn = make_score_pyramid(cfg)
    warps = _warps(cfg, device)

    def _to_pinhole(cand):
        """A candidate bank detected in raw image space, in pinhole
        coordinates (xy, corres and flow consistent; gathers done)."""
        xy_un = warps[0](cand["xy"])
        corres_un = warps[0](cand["corres"])
        return dict(cand, xy=xy_un, corres=corres_un, flow=corres_un - xy_un)

    def prepare(rgb, depth_raw, flow, seg, draws: FrameDraws, scores=None):
        """`scores`: the frame's FAST score maps where the caller already
        has them (the S-stream step scores all streams in one launch
        before it maps this body over them).  With use_sample_feature the
        keypoints are grid samples and no FAST score is computed."""
        depth = preprocess_depth(depth_raw, tr.dataset, cfg.camera.bf,
                                 tr.depth_map_factor)
        H, W = depth.shape
        if fe.use_sample_feature:
            n_div = fe.sample_grid_div
            xy, v = fast.grid_sample_keypoints(
                draws.sample_offsets(
                    n_div, fast.sample_cells(fe.n_sample_points, n_div)),
                H, W, n=fe.n_sample_points, n_div=n_div)
            score = torch.ones(xy.shape[0], dtype=torch.float32,
                               device=xy.device)
        else:
            if scores is None:
                scores = score_fn(rgb)
            det = fast.select_pyramid(scores, n_features=fe.n_features,
                                      scale_factor=fe.scale_factor,
                                      cell=fe.fast_cell)
            xy, v, score = det["xy"], det["valid"], det["score"]
        stat = frontend.static_candidates(xy, v, score, depth, flow, seg,
                                          tr.th_depth_bg, B)
        pri = draws.object_priority(
            frontend.object_grid_size(H, W, fe.obj_sample_step))
        obj = frontend.object_candidates(
            depth, flow, seg, tr.th_depth_obj, fe.obj_sample_step, D,
            tr.max_track_points_obj, pri)
        if warps is not None:
            stat = _to_pinhole(stat)
            obj = _to_pinhole(obj)
            xy = warps[0](xy)  # detections feed renewal's pinhole dedupe
        return {"depth": depth, "stat_cand": stat, "obj_cand": obj,
                "det_xy": xy, "det_valid": v, "det_score": score}

    return prepare


# --------------------------------------------------------------------------
# mask propagation (frame >= 1, before prepare)
# --------------------------------------------------------------------------

def make_mask_prop(cfg: VDOConfig, device):
    warps = _warps(cfg, device)

    def mask_prop(seg_cur, seg_last, flow_last, dyn_last: DynamicBank,
                  label_table):
        corres = dyn_last.corres
        if warps is not None:
            corres = warps[1](corres)  # the seg maps are in raw space
        return frontend.propagate_mask(
            seg_cur, seg_last, flow_last, corres,
            dyn_last.sem_label, dyn_last.valid, label_table,
            min_points=cfg.tracking.mask_recover_min_points)

    return mask_prop


# --------------------------------------------------------------------------
# inherit
# --------------------------------------------------------------------------

def make_inherit(cfg: VDOConfig, device):
    tr = cfg.tracking
    warps = _warps(cfg, device)

    def inherit(stat_last: StaticBank, dyn_last: DynamicBank, depth, seg):
        s_raw = warps[1](stat_last.corres) if warps is not None else None
        d_raw = warps[1](dyn_last.corres) if warps is not None else None
        s = frontend.inherit_static(stat_last.corres, stat_last.valid, depth,
                                    corres_raw=s_raw)
        d = frontend.inherit_objects(dyn_last.corres, dyn_last.valid, depth,
                                     seg, tr.th_depth_obj, corres_raw=d_raw)
        return s, d

    return inherit


# --------------------------------------------------------------------------
# camera tracking
# --------------------------------------------------------------------------

def make_camera_stage(cfg: VDOConfig, device):
    K = _K(cfg, device)
    p = _lm_params(cfg, for_objects=False)
    s = cfg.solver
    tr = cfg.tracking
    n_samples = cfg.shapes.ransac_samples

    def camera(stat_last: StaticBank, cur_xy, cur_depth, T_cw_last, velocity,
               T_cw_gt_cur, T_cw_gt_last, draws: FrameDraws):
        valid = stat_last.valid & (stat_last.depth > 0) & (cur_depth > 0)
        X_w = cam.unproject_to_world(stat_last.xy, stat_last.depth, K,
                                     se3.inv(T_cw_last))
        X_tgt = cam.unproject(cur_xy, cur_depth, K)
        T_r, mask_r, n_r = ransac.ransac_rigid(
            X_w, X_tgt, cur_xy, valid, K,
            lambda n: draws.camera_picks(n_samples, n),
            thres=s.ransac_reproj_thres)
        T0, init_inlier, _, used_mm = ransac.choose_init(
            T_r, mask_r, n_r, velocity @ T_cw_last, X_w, cur_xy, valid, K,
            thres=s.ransac_reproj_thres)
        if s.refit_init:
            T0 = ransac.refine_with_inliers(T0, X_w, X_tgt, init_inlier)
        if tr.joint_flow:
            out = flow_lm.solve(T0, stat_last.xy, stat_last.depth,
                                stat_last.flow, T_cw_last, init_inlier, K, p)
            uv_cur = torch.where(out["inlier"][:, None],
                                 stat_last.xy + out["flow"], cur_xy)
        else:
            # the non-joint path (PoseOptimizationNew), with the
            # reference's synthetic depth-noise fault injection
            noise = (draws.depth_noise(stat_last.depth.shape[-1])
                     if tr.depth_noise else None)
            out = dict(reproj_lm.solve_pose(
                T0, cur_xy, stat_last.xy, stat_last.depth, T_cw_last,
                init_inlier, K, reproj_lm.ReprojLMParams(iters=p.iters),
                noise=noise, noise_scale=tr.depth_noise_scale))
            out["repro_err"] = torch.sqrt(
                torch.clamp(out["chi2"], min=0.0)).mean()
            uv_cur = cur_xy
        # fp32 drift control on the composed pose chain
        T_cw = se3.orthonormalize(out["T"])
        t_rpe, r_rpe = metrics.camera_rpe(T_cw, T_cw_last, T_cw_gt_cur,
                                          T_cw_gt_last)
        return {
            "T_cw": T_cw,
            "velocity": T_cw @ se3.inv(T_cw_last),
            "inlier": out["inlier"],
            "init_inlier": init_inlier,
            "n_inlier": out["n_inlier"],
            "uv_cur": uv_cur,
            "used_motion_model": used_mm,
            "repro_err": out["repro_err"],
            "t_rpe": t_rpe,
            "r_rpe": r_rpe,
        }

    return camera


# --------------------------------------------------------------------------
# scene flow
# --------------------------------------------------------------------------

def make_scene_flow(cfg: VDOConfig, device):
    K = _K(cfg, device)

    def scene_flow(dyn_last: DynamicBank, cur_xy, cur_depth, cur_sem,
                   T_cw_last, T_cw_cur):
        sf, X_w_prev = frontend.scene_flow_world(
            dyn_last.xy, dyn_last.depth, T_cw_last, cur_xy, cur_depth,
            T_cw_cur, K)
        # a feature without a label in either frame is not classified
        # (Tracking.cc:1389-1394)
        sem_ok = (cur_sem > 0) & (dyn_last.sem_label > 0)
        sf_norm = torch.sqrt(sf[..., 0] ** 2 + sf[..., 2] ** 2)
        return {"sf_norm": sf_norm, "sem_ok": sem_ok, "X_w_prev": X_w_prev,
                "sf3d": sf}

    return scene_flow


# --------------------------------------------------------------------------
# object motion
# --------------------------------------------------------------------------

def make_objects_stage(cfg: VDOConfig, device):
    """Per-slot object motion.

    With joint_flow, the compacted solve (stages.py:299-364) on (K, M)
    banks of each slot's members.  The JAX package takes it whenever
    M < D; with M = D its uncompacted route gives the same inliers and
    motions (the members keep their index order either way), so the joint
    path has only this one.  With joint_flow=False, the JAX package's
    uncompacted route (stages.py:391-455) over the whole (K, D) bank with
    the reprojection-only LM.
    """
    K = _K(cfg, device)
    p = _lm_params(cfg, for_objects=True)
    s = cfg.solver
    n_samples = cfg.shapes.ransac_samples
    M = obj_solver_cap(cfg)
    thres = s.ransac_reproj_thres

    def init(X_src, X_tgt, uv, valid, slot_has_mm, slot_H_prev, T_cw_cur,
             draws):
        """RANSAC against the motion model per slot (stages.py:315-329,
        391-406): (G0, init_inlier, n_init)."""
        T_r, mask_r, n_r = ransac.ransac_rigid(
            X_src, X_tgt, uv, valid, K,
            lambda n: draws.object_picks(n_samples, n), thres=thres)
        G_mm = T_cw_cur @ slot_H_prev   # MotionModel = Tcw * vObjMod (1786)
        mask_mm, n_mm = ransac.reprojection_inliers(G_mm, X_src, uv, valid, K,
                                                    thres)
        use_mm = slot_has_mm & (n_mm >= n_r)
        G0 = torch.where(use_mm[:, None, None], G_mm, T_r)
        init_in = torch.where(use_mm[:, None], mask_mm, mask_r)
        n_init = torch.where(use_mm, n_mm, n_r)
        if s.refit_init:
            G0 = ransac.refine_with_inliers(G0, X_src, X_tgt, init_in)
        return G0, init_in, n_init

    def objects(dyn_last: DynamicBank, cur_xy, cur_depth, cur_sem,
                slot_sem, slot_active, slot_has_mm, slot_H_prev,
                member_ok, T_cw_last, T_cw_cur, draws: FrameDraws):
        X_w = cam.unproject_to_world(dyn_last.xy, dyn_last.depth, K,
                                     se3.inv(T_cw_last))
        X_tgt = cam.unproject(cur_xy, cur_depth, K)
        feat_ok = (member_ok & dyn_last.valid & (dyn_last.depth > 0)
                   & (cur_depth > 0))
        members = ((cur_sem[None, :] == slot_sem[:, None]) & feat_ok[None, :]
                   & slot_active[:, None])                         # (Kobj, D)
        if not cfg.tracking.joint_flow:
            return objects_full(dyn_last, cur_xy, members, X_w, X_tgt,
                                slot_has_mm, slot_H_prev, T_cw_last,
                                T_cw_cur, draws)
        idx, okm = select.masked_top_k(members.to(torch.float32), members, M)
        uv_l = dyn_last.xy[idx]                                     # (Kobj, M, 2)
        uv_c = cur_xy[idx]
        Xw_s = X_w[idx]
        Xt_s = X_tgt[idx]

        G0, init_in, n_init = init(Xw_s, Xt_s, uv_c, okm, slot_has_mm,
                                   slot_H_prev, T_cw_cur, draws)
        out = flow_lm.solve(G0, uv_l, dyn_last.depth[idx], dyn_last.flow[idx],
                            T_cw_last, init_in, K, p)
        G = se3.orthonormalize(out["T"])
        H = se3.orthonormalize(se3.inv(T_cw_cur)[None] @ G)  # vObjMod (933)

        mem_f = members.to(torch.float32)
        cnt = torch.clamp(mem_f.sum(-1), min=1.0)
        centroid = (mem_f @ X_w) / cnt[:, None]
        speed = metrics.object_speed(H, centroid)

        # per-feature results back to D-space; pad lanes land in column D
        Dn = cur_xy.shape[0]
        tgt = torch.where(okm, idx, Dn)
        empty = torch.zeros(idx.shape[0], Dn + 1, dtype=torch.bool,
                            device=idx.device)
        inl = empty.scatter(1, tgt, out["inlier"])[:, :Dn]
        init_inlier = empty.scatter(1, tgt, init_in)[:, :Dn]
        # flow-refined current positions for inliers (Optimizer.cc:2942-2954)
        flat_t = torch.where(okm & out["inlier"], idx, Dn).reshape(-1)
        uv_new = torch.cat([cur_xy, cur_xy.new_zeros(1, 2)]).index_put(
            (flat_t,), (uv_l + out["flow"]).reshape(-1, 2))
        return {
            "G": G, "H": H, "init_inlier": init_inlier,
            "n_init": n_init, "inlier": inl, "n_inlier": inl.sum(dim=-1),
            "members": members, "centroid": centroid, "speed": speed,
            "uv_cur": uv_new[:Dn], "repro_err": out["repro_err"],
        }

    def objects_full(dyn_last, cur_xy, members, X_w, X_tgt, slot_has_mm,
                     slot_H_prev, T_cw_last, T_cw_cur, draws):
        """The uncompacted non-joint route (stages.py:391-455): every slot
        over the whole bank, PoseOptimizationObjMot without a robust kernel
        and without flow refinement."""
        Kn, Dn = members.shape

        def each(x):  # the shared (D, ...) bank, one view per slot
            return x.expand((Kn,) + tuple(x.shape))

        G0, init_inlier, n_init = init(each(X_w), each(X_tgt), each(cur_xy),
                                       members, slot_has_mm, slot_H_prev,
                                       T_cw_cur, draws)
        out = reproj_lm.solve_objects(
            G0, cur_xy, dyn_last.xy, dyn_last.depth, T_cw_last, init_inlier,
            K, reproj_lm.ReprojLMParams(iters=p.iters, robust=False))
        G = se3.orthonormalize(out["T"])
        H = se3.orthonormalize(se3.inv(T_cw_cur)[None] @ G)  # vObjMod (933)
        mem_f = members.to(torch.float32)
        cnt = torch.clamp(mem_f.sum(-1), min=1.0)
        centroid = (mem_f @ X_w) / cnt[:, None]
        # no flow refinement here: inliers keep their current positions,
        # computed as the JAX package computes them
        inl = out["inlier"]
        flow_ref = (inl.to(torch.float32)[..., None]
                    * (cur_xy - dyn_last.xy)).sum(dim=0)
        uv_new = torch.where(inl.any(dim=0)[:, None], dyn_last.xy + flow_ref,
                             cur_xy)
        return {
            "G": G, "H": H, "init_inlier": init_inlier,
            "n_init": n_init, "inlier": inl, "n_inlier": out["n_inlier"],
            "members": members, "centroid": centroid,
            "speed": metrics.object_speed(H, centroid),
            "uv_cur": uv_new,
            "repro_err": torch.zeros(Kn, dtype=torch.float32,
                                     device=cur_xy.device),
        }

    return objects


# --------------------------------------------------------------------------
# renewal
# --------------------------------------------------------------------------

def make_renew_stage(cfg: VDOConfig, device):
    K = _K(cfg, device)
    tr = cfg.tracking
    B = cfg.shapes.max_static
    D = cfg.shapes.max_dynamic
    warps = _warps(cfg, device)

    def _maps(xy, depth_map, flow_map, seg_map):
        """Gathers at xy, warped to raw space where the banks are pinhole:
        (depth, label, raw flow, corres in the banks' space, in bounds)."""
        H_img, W_img = depth_map.shape
        raw = xy if warps is None else warps[1](xy)
        d = gather_int(depth_map, raw)
        m = gather_int(seg_map, raw)
        f = gather_int(flow_map, raw)
        corres_raw = raw + f
        corres = corres_raw if warps is None else warps[0](corres_raw)
        inb = (cam.in_bounds(raw, W_img, H_img)
               & cam.in_bounds(corres_raw, W_img, H_img))
        return d, m, f, corres, inb

    def renew_static(cur_xy, carry_ok, det_xy, det_valid, det_score,
                     depth_map, flow_map, seg_map, T_cw):
        """RenewFrameInfo static half (Tracking.cc:2660-2790)."""
        def criteria(xy):
            d, m, f, corres, inb = _maps(xy, depth_map, flow_map, seg_map)
            ok = ((m == 0) & (d > 0) & (d <= tr.renew_depth_gate_bg)
                  & (f[..., 0] != 0) & (f[..., 1] != 0) & inb)
            return ok, d, corres - xy, corres

        carry = carry_ok & criteria(cur_xy)[0]
        d_ok = criteria(det_xy)[0]
        # drop detections within 1 px of a kept carryover
        dist = select.min_dist_to_set(det_xy, cur_xy, carry)
        new_ok = det_valid & d_ok & (dist >= 1.0)

        all_xy = torch.cat([cur_xy, det_xy])
        all_ok = torch.cat([carry, new_ok])
        all_pri = torch.cat([
            torch.where(carry, 2e9, float("-inf")), det_score])
        all_assoc = torch.cat([
            torch.arange(cur_xy.shape[0], dtype=torch.int32, device=device),
            torch.full((det_xy.shape[0],), -1, dtype=torch.int32,
                       device=device)])
        idx, valid = select.masked_top_k(all_pri, all_ok, B)
        xy = select.gather_rows(all_xy, idx, valid)
        _, d, f, corres = criteria(xy)
        return StaticBank(
            xy=xy, depth=torch.where(valid, d, -1.0), flow=f, corres=corres,
            point_w=cam.unproject_to_world(xy, d, K, se3.inv(T_cw)),
            assoc=torch.where(valid, all_assoc[idx], -1),
            valid=valid,
        )

    def renew_dynamic(cur_xy, cur_obj_label, carry_ok, cand: dict,
                      slot_sem, slot_model, slot_active,
                      depth_map, flow_map, seg_map, T_cw, draws: FrameDraws):
        """RenewFrameInfo dynamic half (Tracking.cc:2795-2930)."""
        def criteria(xy):
            d, m, f, corres, inb = _maps(xy, depth_map, flow_map, seg_map)
            ok = (m > 0) & (d > 0) & (d < tr.renew_depth_gate_obj) & inb
            return ok, d, m, corres - xy, corres

        c_ok, _, c_m, _, _ = criteria(cur_xy)
        carry = carry_ok & c_ok
        # a candidate on an active object's label takes that object's model
        # label; an unclaimed label is a new object (-2)
        k_ok, _, k_m, _, _ = criteria(cand["xy"])
        cl = ((cand["sem_label"][None, :] == slot_sem[:, None])
              & slot_active[:, None])                               # (K, Dc)
        claimed = cl.any(dim=0)
        model_of = (slot_model.to(torch.float32) @ cl.to(torch.float32)
                    ).to(torch.int32)
        cand_label = torch.where(claimed, model_of, -2)
        dist = select.min_dist_to_set(cand["xy"], cur_xy, carry)
        cand_ok = cand["valid"] & k_ok & (dist >= 1.0)

        n_cand = cand["xy"].shape[0]
        all_xy = torch.cat([cur_xy, cand["xy"]])
        all_ok = torch.cat([carry, cand_ok])
        all_sem = torch.cat([c_m, k_m])
        all_lab = torch.cat([cur_obj_label, cand_label])
        all_assoc = torch.cat([
            torch.arange(cur_xy.shape[0], dtype=torch.int32, device=device),
            torch.full((n_cand,), -1, dtype=torch.int32, device=device)])
        pri = torch.cat([
            torch.where(carry, 3.0, float("-inf")),
            torch.where(claimed, 2.0, 1.0)
            + 0.5 * draws.renew_priority(n_cand)])
        idx, valid = select.quota_select(all_sem, all_ok, pri,
                                         tr.max_track_points_obj, D)
        xy = select.gather_rows(all_xy, idx, valid)
        _, d, m, f, corres = criteria(xy)
        return DynamicBank(
            xy=xy, depth=torch.where(valid, d, 0.1), flow=f, corres=corres,
            point_w=cam.unproject_to_world(xy, d, K, se3.inv(T_cw)),
            sem_label=torch.where(valid, m, 0).to(torch.int32),
            obj_label=torch.where(valid, all_lab[idx], -2),
            assoc=torch.where(valid, all_assoc[idx], -1),
            valid=valid,
        )

    return renew_static, renew_dynamic


# --------------------------------------------------------------------------
# frame-0 initialization
# --------------------------------------------------------------------------

def make_init_stage(cfg: VDOConfig, device):
    K = _K(cfg, device)

    def init_banks(stat_cand, obj_cand):
        """Initialization (Tracking.cc:1215-1276): pose = I, points are
        camera-frame unprojections (= world at the origin frame)."""
        minus1 = torch.full(stat_cand["valid"].shape, -1, dtype=torch.int32,
                            device=device)
        stat = StaticBank(
            xy=stat_cand["xy"], depth=stat_cand["depth"],
            flow=stat_cand["flow"], corres=stat_cand["corres"],
            point_w=cam.unproject(stat_cand["xy"], stat_cand["depth"], K),
            assoc=minus1, valid=stat_cand["valid"])
        shape = obj_cand["valid"].shape
        dyn = DynamicBank(
            xy=obj_cand["xy"], depth=obj_cand["depth"], flow=obj_cand["flow"],
            corres=obj_cand["corres"],
            point_w=cam.unproject(obj_cand["xy"], obj_cand["depth"], K),
            sem_label=obj_cand["sem_label"],
            obj_label=torch.full(shape, -2, dtype=torch.int32, device=device),
            assoc=torch.full(shape, -1, dtype=torch.int32, device=device),
            valid=obj_cand["valid"])
        return stat, dyn

    return init_banks


# --------------------------------------------------------------------------
# the on-device dynamic-object classifier (stages.py:629-738)
# --------------------------------------------------------------------------

LABEL_SPACE = 256  # instance-segmentation ids are assumed < 256


def make_device_classifier(cfg: VDOConfig, device):
    """DynObjTracking (Tracking.cc:1366-1612) on the device, with the
    object tracks carried as fixed-size slot tables and a max_id counter."""
    tr = cfg.tracking
    Kobj = cfg.shapes.max_objects
    H_img, W_img = cfg.camera.height, cfg.camera.width
    eye4 = torch.eye(4, dtype=torch.float32, device=device)

    def classify(cur_sem, valid, sf_norm, depth, xy,
                 last_sem, last_slot_sem, last_slot_model, last_slot_H,
                 last_slot_active, max_id):
        lab = torch.clamp(cur_sem, 0, LABEL_SPACE - 1)
        ok = valid & (cur_sem > 0) & (lab == cur_sem)
        labf = torch.where(ok, lab, 0).to(torch.int64)

        def count(pred):
            return frontend.segment_sum((ok & pred).to(torch.float32), labf,
                                        LABEL_SPACE)

        ones = count(torch.ones_like(ok))
        u, v = xy[..., 0], xy[..., 1]
        sr, sc = tr.boundary_shrink_row, tr.boundary_shrink_col
        n_boundary = count((v < sr) | (v > H_img - sr) | (u < sc)
                           | (u > W_img - sc))
        n_static = count(sf_norm < tr.sf_mg_thres)
        d_sum = frontend.segment_sum(torch.where(ok, depth, 0.0), labf,
                                     LABEL_SPACE)
        ones_safe = torch.clamp(ones, min=1.0)
        is_obj = ((ones >= tr.min_obj_points)
                  & (n_boundary / ones_safe <= tr.boundary_frac_thres)
                  & (n_static / ones_safe <= tr.sf_ds_thres)
                  & (d_sum / ones_safe <= tr.th_depth_obj))
        is_obj = frontend.zero_first(is_obj)
        # per-label class for features: 2 active object, 0 static, -1 dropped
        lab_class = torch.where(
            is_obj, 2, torch.where(n_static / ones_safe > tr.sf_ds_thres, 0, -1))

        # the Kobj most populous object labels -> slots (stable argsort)
        score = torch.where(is_obj, ones, -1.0)
        slot_lab = torch.sort(-score, stable=True).indices[:Kobj]
        slot_active = score[slot_lab] > 0

        # association: majority last-frame label among a slot's members,
        # matched against the last slot labels
        members = (cur_sem[None, :] == slot_lab[:, None]) & ok[None, :]
        last_lab = torch.clamp(last_sem, 0, LABEL_SPACE - 1).to(torch.int64)
        votes = frontend.segment_sum(
            (members & (last_sem > 0)[None, :]).to(torch.float32), last_lab,
            LABEL_SPACE)                                          # (K, 256)
        major = torch.argmax(votes, dim=-1)                       # first max
        has_major = torch.gather(votes, 1, major[:, None])[:, 0] > 0
        maj_lab = torch.where(has_major, major, slot_lab)
        match = ((maj_lab[:, None] == last_slot_sem[None, :])
                 & last_slot_active[None, :])
        matched = match.any(dim=-1) & slot_active
        match_idx = torch.argmax(match.to(torch.uint8), dim=-1)
        is_new = slot_active & ~matched
        new_rank = torch.cumsum(is_new.to(torch.int32), dim=0) - 1
        slot_model = torch.where(
            matched, last_slot_model[match_idx],
            torch.where(is_new, max_id + new_rank, 0)).to(torch.int32)
        new_max_id = max_id + is_new.sum().to(torch.int32)
        slot_H_prev = torch.where(matched[:, None, None],
                                  last_slot_H[match_idx], eye4)
        per_lab_class = lab_class[labf]
        feat_model = (slot_model.to(torch.float32)
                      @ members.to(torch.float32)).to(torch.int32)
        obj_label = torch.where(
            ~valid, -2,
            torch.where(~ok, -1,
                        torch.where(per_lab_class == 2,
                                    torch.where(feat_model > 0, feat_model, -1),
                                    per_lab_class))).to(torch.int32)
        return {
            "slot_sem": torch.where(slot_active, slot_lab, 0).to(torch.int32),
            "slot_model": slot_model,
            "slot_active": slot_active,
            "slot_has_mm": matched,
            "slot_H_prev": slot_H_prev,
            "max_id": new_max_id,
            "obj_label": obj_label,
            "member_ok": obj_label > 0,
        }

    return classify
