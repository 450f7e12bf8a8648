"""Error-curve plotting — the PlotMetricError / cvplot replacement; a copy
of vdo_slam_tpu/eval/plots.py (numpy; matplotlib is imported inside the
function, so the package does not need it).

The reference vendors an OpenCV plotting library (include/cvplot) solely to
draw live camera/object translation & rotation error curves
(Tracking.cc:3388-3644).  Here: headless matplotlib figures written to disk.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..pipeline.map_state import MapState
from .results import _inv, _stable_angle_deg


def _pose_errors(m: MapState, refined: bool):
    poses = m.cam_pose_rf if refined else m.cam_pose
    gt = m.cam_pose_gt
    t_err, r_err = [], []
    for i in range(1, len(poses)):
        ate = (poses[i].astype(np.float64)
               @ np.linalg.inv(poses[i - 1].astype(np.float64))
               @ gt[i - 1].astype(np.float64)
               @ np.linalg.inv(gt[i].astype(np.float64)))
        t_err.append(float(np.linalg.norm(ate[:3, 3])))
        # stable extraction (atan2 of skew vs trace): plain acos((tr-1)/2)
        # shows a 0.02-0.04 deg phantom floor on f32-stored chains
        r_err.append(_stable_angle_deg(ate))
    return t_err, r_err


def _object_errors(m: MapState, refined: bool):
    mots = m.rigid_motion_rf if refined else m.rigid_motion
    curves_t: dict[int, list] = {}
    curves_r: dict[int, list] = {}
    for f in range(len(mots)):
        for j in range(1, len(mots[f])):
            if not m.obj_stat[f][j]:
                continue
            L = m.obj_pose_pre[f][j]
            body = _inv(L) @ mots[f][j] @ L
            err = _inv(body) @ m.rigid_motion_gt[f][j]
            lab = m.rm_label[f][j]
            curves_t.setdefault(lab, []).append(float(np.linalg.norm(err[:3, 3])))
            curves_r.setdefault(lab, []).append(_stable_angle_deg(err))
    return curves_t, curves_r


def plot_metric_error(m: MapState, out_dir: str | Path,
                      refined: bool = False) -> list[str]:
    """Write translation/rotation error curve figures; returns file paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    t_err, r_err = _pose_errors(m, refined)
    obj_t, obj_r = _object_errors(m, refined)

    paths = []
    for name, cam_curve, obj_curves, unit in (
        ("translation_error", t_err, obj_t, "meters"),
        ("rotation_error", r_err, obj_r, "degrees"),
    ):
        fig, ax = plt.subplots(figsize=(10, 3))
        ax.plot(cam_curve, "o-", ms=3, label="Camera", color="tab:red")
        for lab, curve in sorted(obj_curves.items()):
            ax.plot(curve, "o-", ms=3, label=f"Object {lab}")
        ax.set_xlabel("frame")
        ax.set_ylabel(unit)
        ax.set_title(name.replace("_", " ").title()
                     + (" (refined)" if refined else ""))
        ax.legend(loc="upper right", fontsize=8)
        fig.tight_layout()
        p = out / f"{name}{'_rf' if refined else ''}.png"
        fig.savefig(p, dpi=100)
        plt.close(fig)
        paths.append(str(p))
    return paths
