"""Copy of vdo_slam_tpu/eval/results.py (metric_report, timing_summary,
save_results), unchanged apart from this line and the g2o dump, whose
graph save_results copies to the host (the refine builds it on its
device).

Result file writers + end-of-run metric reports.

Produces the same text artifacts as System::SaveResults (System.cc:66-244):
  obj_mot_stereo_new.txt / obj_mot_stereo_rf_new.txt / obj_mot_gt.txt /
  obj_centre.txt         : per frame/object body-frame motions + centres
  initial_stereo_new.txt / refined_stereo_new.txt / cam_pose_gt_stereo.txt
                         : camera trajectories (frame id + flattened 4x4)
plus the track-distribution files (Tracking.cc:2293-2304) and the console
metric summary of GetMetricError (Tracking.cc:3243-3386).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..pipeline.map_state import MapState, build_tracklets, track_length_histogram


def _inv(T):
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def _stable_angle_deg(T) -> float:
    """The reference's clamped-trace rotation angle (Tracking.cc:3268-3276)
    via the skew-norm atan2 form — algebraically identical on exact rotation
    matrices, but linear (not quadratic) in input rounding, so f32-stored
    pose chains don't read a sqrt(eps) ~ 0.03 deg phantom angle (DESIGN.md;
    same extraction as geometry.metrics.clamped_trace_angle_deg)."""
    sin_t = 0.5 * float(np.linalg.norm([
        T[2, 1] - T[1, 2], T[0, 2] - T[2, 0], T[1, 0] - T[0, 1]]))
    diag = np.diag(T)[:3]
    tr_c = float(np.sum(np.where(diag > 1.0, 2.0 - diag, diag)))
    return float(np.degrees(np.arctan2(sin_t, np.clip((tr_c - 1) / 2, -1, 1))))


def _fmt_pose_row(prefix: str, T: np.ndarray) -> str:
    vals = " ".join(f"{T[i, j]:.9f}" for i in range(3) for j in range(4))
    return f"{prefix} {vals} 0.000000000 0.000000000 0.000000000 1.000000000"


def save_results(m: MapState, out_dir: str | Path) -> None:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    # --- object motions (body frame: L_prev^-1 H L_prev, System.cc:92-105)
    rows_est, rows_rf, rows_gt, rows_c = [], [], [], []
    for f, mots in enumerate(m.rigid_motion):
        for j in range(1, len(mots)):
            L = m.obj_pose_pre[f][j]
            body = _inv(L) @ mots[j] @ L
            body_rf = _inv(L) @ m.rigid_motion_rf[f][j] @ L
            lab = m.rm_label[f][j]
            rows_est.append(_fmt_pose_row(f"{f + 1} {lab}", body))
            rows_rf.append(_fmt_pose_row(f"{f + 1} {lab}", body_rf))
            rows_gt.append(_fmt_pose_row(f"{f + 1} {lab}", m.rigid_motion_gt[f][j]))
            c = m.centres[f][j]
            rows_c.append(f"{f + 1} {lab} {c[0]:.9f} {c[1]:.9f} {c[2]:.9f}")
    (out / "obj_mot_stereo_new.txt").write_text("\n".join(rows_est) + "\n" if rows_est else "")
    (out / "obj_mot_stereo_rf_new.txt").write_text("\n".join(rows_rf) + "\n" if rows_rf else "")
    (out / "obj_mot_gt.txt").write_text("\n".join(rows_gt) + "\n" if rows_gt else "")
    (out / "obj_centre.txt").write_text("\n".join(rows_c) + "\n" if rows_c else "")

    # --- camera trajectories (System.cc:128-179)
    for name, poses in (
        ("initial_stereo_new.txt", m.cam_pose),
        ("refined_stereo_new.txt", m.cam_pose_rf),
        ("cam_pose_gt_stereo.txt", m.cam_pose_gt),
    ):
        lines = [_fmt_pose_row(str(i), T) for i, T in enumerate(poses)]
        (out / name).write_text("\n".join(lines) + "\n" if lines else "")

    # --- tracklet length distributions (Tracking.cc:2293-2304, 2407-2418)
    if m.stat_assoc:
        tr_s, _ = build_tracklets(m.stat_assoc, m.stat_valid)
        hist = track_length_histogram(tr_s, m.num_frames)
        (out / "track_distribution_static.txt").write_text(
            "\n".join(str(h) for h in hist[2:] if h) + "\n"
        )
        tr_d, _ = build_tracklets(m.dyn_assoc, m.dyn_valid, m.dyn_obj_label)
        hist_d = track_length_histogram(tr_d, m.num_frames)
        (out / "track_distribution.txt").write_text(
            "\n".join(str(h) for h in hist_d[2:] if h) + "\n"
        )

    # --- per-object tracking counts (GetObjTrackTime, Tracking.cc:2423-2495)
    if m.rm_label:
        from ..pipeline.map_state import object_track_time

        max_id = max((max(labs[1:]) + 1 for labs in m.rm_label
                      if len(labs) > 1), default=1)
        cnt, cnt_gt, sem = object_track_time(
            m.rm_label, m.sem_label, m.sm_label_gt, max_id)
        rows = [f"{i + 1} {sem[i]} {cnt[i]} {cnt_gt[i]}"
                for i in range(len(cnt))]
        (out / "obj_track_time.txt").write_text(
            "# label semantic tracked_frames gt_frames\n"
            + ("\n".join(rows) + "\n" if rows else ""))

    # --- optimized full-batch graph (dynamic_slam_graph_after_opt.g2o,
    # Optimizer.cc:1935-1936); present once full_ba_inplace has run
    if m.g2o_dump is not None:
        from ..backend.factor_graph import graph_on_host
        from ..backend.g2o_io import save_g2o

        d = m.g2o_dump
        save_g2o(graph_on_host(d["graph"]), d["v"],
                 out / "dynamic_slam_graph_after_opt.g2o",
                 n_poses=d["n_poses"], n_motions=d["n_motions"],
                 n_points=d["n_points"])


def timing_summary(m: MapState) -> dict:
    """Average per-stage times (System.cc:204-237)."""
    if not m.timings:
        return {}
    t = np.stack(m.timings)
    obj_rows = t[:, 3] != 0
    return {
        "mask_update_ms": float(t[:, 0].mean()),
        "camera_est_ms": float(t[:, 1].mean()),
        "obj_track_ms": float(t[:, 2].mean()),
        "obj_est_ms": float(t[obj_rows, 3].mean()) if obj_rows.any() else 0.0,
        "map_update_ms": float(t[:, 4].mean()),
        "local_ba_ms": float(np.mean(m.lba_times)) if m.lba_times else 0.0,
    }


def metric_report(m: MapState, refined: bool = False, rms: bool = False) -> dict:
    """GetMetricError (Tracking.cc:3243-3386): camera RPE over the pose chain
    + object body-frame RPE, mean (reference default bRMSError=false)."""
    poses = m.cam_pose_rf if refined else m.cam_pose
    mots = m.rigid_motion_rf if refined else m.rigid_motion
    gt = m.cam_pose_gt

    t_sum = r_sum = 0.0
    n = 0
    for i in range(1, len(poses)):
        # err = (CamPose[i] CamPose[i-1]^-1)(CamPose_gt[i-1] CamPose_gt[i]^-1)
        # with CamPose = camera->world (Tracking.cc:3256-3259)
        ate = _np4(poses[i]) @ np.linalg.inv(_np4(poses[i - 1])) @ \
            _np4(gt[i - 1]) @ np.linalg.inv(_np4(gt[i]))
        t_err = float(np.linalg.norm(ate[:3, 3]))
        r_err = _stable_angle_deg(ate)
        if rms:
            t_sum += t_err ** 2
            r_sum += r_err ** 2
        else:
            t_sum += t_err
            r_sum += r_err
        n += 1
    if n:
        t_cam = (t_sum / n) ** 0.5 if rms else t_sum / n
        r_cam = (r_sum / n) ** 0.5 if rms else r_sum / n
    else:
        t_cam = r_cam = 0.0

    to_sum = ro_sum = 0.0
    n_obj = 0
    for f in range(len(mots)):
        for j in range(1, len(mots[f])):
            if not m.obj_stat[f][j]:
                continue
            L = m.obj_pose_pre[f][j]
            body = _inv(L) @ mots[f][j] @ L
            err = _inv(body) @ m.rigid_motion_gt[f][j]
            t_err = float(np.linalg.norm(err[:3, 3]))
            r_err = _stable_angle_deg(err)
            if rms:
                to_sum += t_err ** 2
                ro_sum += r_err ** 2
            else:
                to_sum += t_err
                ro_sum += r_err
            n_obj += 1
    if n_obj:
        t_obj = (to_sum / n_obj) ** 0.5 if rms else to_sum / n_obj
        r_obj = (ro_sum / n_obj) ** 0.5 if rms else ro_sum / n_obj
    else:
        t_obj = r_obj = 0.0

    return {
        "cam_t_rpe": t_cam,
        "cam_r_rpe_deg": r_cam,
        "obj_t_rpe": t_obj,
        "obj_r_rpe_deg": r_obj,
        "n_obj_estimates": n_obj,
    }


def _np4(T):
    return np.asarray(T, np.float64).reshape(4, 4)
