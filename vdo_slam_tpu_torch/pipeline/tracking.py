"""The numpy pose helpers of vdo_slam_tpu/pipeline/tracking.py, copied
jax-free: `_np_inv`, `obj_pose_parsing_kt` and `obj_pose_parsing_ox`.

The host `Tracker` of that file (mode="reference") is not ported; the
fused tracker needs only these three helpers to archive GT.
"""

from __future__ import annotations

import numpy as np


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
