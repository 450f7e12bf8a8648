"""Copy of vdo_slam_tpu/eval/visualize.py, unchanged apart from this line.

Frame / trajectory visualization (headless PNG).

Replaces the reference's imshow windows (Tracking.cc:362-600): the feature
overlay ("Static Background and Object Points"), the speed-annotated boxes
("Object Speed"), and the bird's-eye trajectory canvas ("Camera and Object
Trajectories") — rendered with matplotlib instead of OpenCV highgui.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_OBJ_COLORS = ["tab:purple", "tab:green", "tab:cyan", "tab:blue", "tab:pink",
               "tab:orange", "tab:olive", "tab:brown", "tab:red", "tab:gray"]


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_frame(rgb: np.ndarray, stat_xy: np.ndarray, stat_valid: np.ndarray,
               dyn_xy: np.ndarray, dyn_label: np.ndarray,
               dyn_valid: np.ndarray, out_path: str | Path,
               speeds: dict | None = None) -> str:
    """Feature overlay: static points black, object points colored by track
    id (the reference's per-label color switch, Tracking.cc:375-470)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 10 * rgb.shape[0] / rgb.shape[1]))
    ax.imshow(rgb, cmap="gray", vmin=0, vmax=1)
    sv = np.asarray(stat_valid)
    ax.scatter(stat_xy[sv, 0], stat_xy[sv, 1], s=2, c="black", marker=".")
    lv = np.asarray(dyn_valid) & (np.asarray(dyn_label) > 0)
    for lab in np.unique(np.asarray(dyn_label)[lv]):
        sel = lv & (dyn_label == lab)
        c = _OBJ_COLORS[int(lab) % len(_OBJ_COLORS)]
        ax.scatter(dyn_xy[sel, 0], dyn_xy[sel, 1], s=3, c=c, marker=".")
        if speeds and int(lab) in speeds:
            cx, cy = dyn_xy[sel, 0].mean(), dyn_xy[sel, 1].min()
            ax.text(cx, cy - 5, f"{speeds[int(lab)]:.1f} km/h", color=c,
                    fontsize=9, ha="center", weight="bold")
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return str(out_path)


def draw_trajectory(m, out_path: str | Path) -> str:
    """Bird's-eye canvas: camera path (red squares) + object centres
    (colored circles) — the reference's imTraj (Tracking.cc:520-593)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 7))
    cam = np.stack(m.cam_pose)
    ax.plot(cam[:, 0, 3], cam[:, 2, 3], "s-", ms=3, color="tab:red",
            label="camera")
    seen = set()
    for f in range(len(m.centres)):
        for j in range(1, len(m.centres[f])):
            lab = m.rm_label[f][j]
            c = _OBJ_COLORS[lab % len(_OBJ_COLORS)]
            kw = {}
            if lab not in seen:
                kw["label"] = f"object {lab}"
                seen.add(lab)
            cen = m.centres[f][j]
            ax.plot(cen[0], cen[2], "o", ms=3, color=c, **kw)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("z (m)")
    ax.set_title("Camera and Object Trajectories")
    ax.legend(fontsize=8)
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return str(out_path)


def draw_scene_flow_birdeye(points_w: np.ndarray, flow3d: np.ndarray,
                            valid: np.ndarray, out_path: str | Path,
                            x_range=(-15.0, 15.0), z_range=(0.0, 30.0)) -> str:
    """Bird's-eye sparse scene-flow arrows (DrawSparseFlowBirdeye,
    Tracking.cc:1851-2008): x/z positions with velocity arrows."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 6))
    v = np.asarray(valid)
    P = np.asarray(points_w)[v]
    F = np.asarray(flow3d)[v]
    sel = ((P[:, 0] > x_range[0]) & (P[:, 0] < x_range[1])
           & (P[:, 2] > z_range[0]) & (P[:, 2] < z_range[1]))
    P, F = P[sel], F[sel]
    ax.quiver(P[:, 0], P[:, 2], F[:, 0], F[:, 2], angles="xy",
              scale_units="xy", scale=1.0, width=0.003, color="tab:red")
    ax.scatter(P[:, 0], P[:, 2], s=4, c="tab:blue")
    ax.set_xlim(*x_range)
    ax.set_ylim(*z_range)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("z (m)")
    ax.set_title("Scene flow (bird's eye)")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return str(out_path)
