"""Object velocity evaluation — GetVelocityError (Tracking.cc:3646-3787);
a copy of vdo_slam_tpu/eval/velocity.py (numpy only).

Speed per (frame, object) from the estimated rigid motion and the centroid of
the object's PREVIOUS-frame 3D points (matched features only), compared to
the GT speeds collected during tracking; writes the reference's text files
(speed_error.txt / speed_estimated.txt / speed_groundtruth.txt /
tracking_id.txt).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..pipeline.map_state import MapState


def velocity_report(m: MapState, out_dir: str | Path | None = None,
                    rms: bool = True) -> dict:
    rows_err, rows_est, rows_gt, rows_id = [], [], [], []
    s_sum = 0.0
    s_gt_sum = 0.0
    count = 0
    per_obj_est: dict[int, list] = {}
    per_obj_gt: dict[int, list] = {}

    for fp in range(len(m.rigid_motion)):  # pair fp -> fp+1
        mots = m.rigid_motion[fp]
        labels = m.rm_label[fp]
        if len(mots) <= 1 or fp + 1 >= len(m.dyn_obj_label):
            continue
        feat_lab = m.dyn_obj_label[fp + 1]
        assoc = m.dyn_assoc[fp] if fp < len(m.dyn_assoc) else None
        pts_prev = m.dyn_3d[fp]
        err_row, est_row, gt_row, id_row = [], [], [], [str(fp)]
        for j in range(1, len(mots)):
            if not m.obj_stat[fp][j]:
                continue
            lab = labels[j]
            sel = (feat_lab == lab)
            if assoc is not None:
                sel = sel & (assoc >= 0)
                idx = assoc[sel]
            else:
                continue
            if idx.size == 0:
                continue
            centre = pts_prev[idx].mean(axis=0)
            H = mots[j]
            v = H[:3, 3] - (np.eye(3) - H[:3, :3]) @ centre
            sp_est = float(np.linalg.norm(v) * 36.0)
            sp_gt = float(m.speed_gt[fp][j]) if j < len(m.speed_gt[fp]) else 0.0
            e = sp_est - sp_gt
            if rms:
                s_sum += e * e
            else:
                s_sum += e
            s_gt_sum += sp_gt
            count += 1
            per_obj_est.setdefault(lab, []).append(sp_est)
            per_obj_gt.setdefault(lab, []).append(sp_gt)
            err_row.append(f"{e:.6f}")
            est_row.append(f"{sp_est:.6f}")
            gt_row.append(f"{sp_gt:.6f}")
            id_row.append(str(lab))
        rows_err.append(" ".join(err_row))
        rows_est.append(" ".join(est_row))
        rows_gt.append(" ".join(gt_row))
        rows_id.append(" ".join(id_row))

    if out_dir is not None:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / "speed_error.txt").write_text("\n".join(rows_err) + "\n")
        (out / "speed_estimated.txt").write_text("\n".join(rows_est) + "\n")
        (out / "speed_groundtruth.txt").write_text("\n".join(rows_gt) + "\n")
        (out / "tracking_id.txt").write_text("\n".join(rows_id) + "\n")

    if count:
        avg = (s_sum / count) ** 0.5 if rms else abs(s_sum / count)
        gt_avg = s_gt_sum / count
    else:
        avg = gt_avg = 0.0
    return {
        "speed_err_kmh": avg,
        "gt_avg_speed_kmh": gt_avg,
        "n_estimates": count,
        "per_object_est": {k: float(np.mean(v)) for k, v in per_obj_est.items()},
        "per_object_gt": {k: float(np.mean(v)) for k, v in per_obj_gt.items()},
    }
