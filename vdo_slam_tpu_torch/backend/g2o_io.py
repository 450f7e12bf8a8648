"""Copy of vdo_slam_tpu/backend/g2o_io.py, unchanged apart from this
line.

g2o text-format graph dump.

The reference saves its full-batch graph as dynamic_slam_graph_after_opt.g2o
(Optimizer.cc:1935-1936) for offline inspection.  This writes the same
factor-graph content in standard g2o text tags:

  VERTEX_SE3:QUAT id x y z qx qy qz qw        (poses & motion vertices)
  VERTEX_TRACKXYZ id x y z                     (points)
  EDGE_SE3:QUAT a b  dx dy dz qx qy qz qw  <info upper-tri 6x6>
  EDGE_SE3_TRACKXYZ pose pt  x y z  <info upper-tri 3x3>
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .factor_graph import Graph, Variables


def _quat_from_R(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (qx, qy, qz, qw)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        qx, qy, qz, qw = q
    return np.asarray([qx, qy, qz, qw])


def _se3_line(tag: str, ids: list[int], T: np.ndarray, info_diag: float,
              dim: int = 6) -> str:
    q = _quat_from_R(np.asarray(T[:3, :3], np.float64))
    t = T[:3, 3]
    vals = [f"{v:.9f}" for v in (*t, *q)]
    info = []
    for i in range(dim):
        for j in range(i, dim):
            info.append(f"{info_diag if i == j else 0.0:.6f}")
    return " ".join([tag, *map(str, ids), *vals, *info])


def save_g2o(graph: Graph, v: Variables, path: str | Path,
             n_poses: int, n_motions: int, n_points: int) -> None:
    poses = np.asarray(v.poses)
    motions = np.asarray(v.motions)
    points = np.asarray(v.points)
    lines = []
    # vertex ids: poses [0, F), motions [F, F+M), points [F+M, ...)
    for i in range(n_poses):
        q = _quat_from_R(poses[i][:3, :3].astype(np.float64))
        t = poses[i][:3, 3]
        lines.append(
            "VERTEX_SE3:QUAT %d %.9f %.9f %.9f %.9f %.9f %.9f %.9f"
            % (i, *t, *q)
        )
    for i in range(n_motions):
        q = _quat_from_R(motions[i][:3, :3].astype(np.float64))
        t = motions[i][:3, 3]
        lines.append(
            "VERTEX_SE3:QUAT %d %.9f %.9f %.9f %.9f %.9f %.9f %.9f"
            % (n_poses + i, *t, *q)
        )
    for i in range(n_points):
        lines.append(
            "VERTEX_TRACKXYZ %d %.9f %.9f %.9f"
            % (n_poses + n_motions + i, *points[i])
        )

    odo_a = np.asarray(graph.odo_a)
    odo_w = np.asarray(graph.odo_w)
    odo_m = np.asarray(graph.odo_meas_inv)
    for e in range(odo_a.shape[0]):
        if odo_w[e] <= 0:
            continue
        M = np.linalg.inv(odo_m[e].astype(np.float64))
        lines.append(_se3_line(
            "EDGE_SE3:QUAT", [int(odo_a[e]), int(np.asarray(graph.odo_b)[e])],
            M, float(odo_w[e]),
        ))
    obs_p = np.asarray(graph.obs_pose)
    obs_x = np.asarray(graph.obs_point)
    obs_w = np.asarray(graph.obs_w)
    obs_m = np.asarray(graph.obs_meas)
    for e in range(obs_p.shape[0]):
        if obs_w[e] <= 0:
            continue
        info = " ".join(
            f"{float(obs_w[e]) if i == j else 0.0:.6f}"
            for i in range(3) for j in range(i, 3)
        )
        lines.append(
            "EDGE_SE3_TRACKXYZ %d %d %.9f %.9f %.9f %s"
            % (int(obs_p[e]), n_poses + n_motions + int(obs_x[e]),
               *obs_m[e], info)
        )
    Path(path).write_text("\n".join(lines) + "\n")
