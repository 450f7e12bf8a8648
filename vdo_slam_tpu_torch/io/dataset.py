"""Copy of vdo_slam_tpu/io/dataset.py (FrameData, SequenceDataset,
SyntheticDataset, SyntheticOMDDataset), unchanged apart from this line.

Dataset readers for the reference's on-disk sequence layout.

Mirrors example/vdo_slam.cc LoadData/LoadMask (lines 150-450):

  seq_dir/
    times.txt            one timestamp per line
    image_0/%06d.png     RGB (or gray)
    depth/%06d.png       16-bit disparity (KITTI) / stereo depth (OMD)
    semantic/%06d.txt    per-pixel int instance-label matrix
    flow/%06d.flo        dense forward optical flow
    pose_gt.txt          frame_id + 12 floats (3x4 row-major camera pose)
    object_pose.txt      10 floats per row: [frame obj_id box(4) t(3) yaw]
                         (KITTI parsing, Tracking::ObjPoseParsingKT)

Image decode uses PIL; everything is returned as numpy with the same dtypes
the pipeline's device path expects.  A SyntheticScene can also be wrapped so
tests/benches run with zero downloads.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .flo import read_flo
from .synthetic import SyntheticScene


@dataclasses.dataclass
class FrameData:
    """One frame's raw inputs (the TrackRGBD argument tuple, System.h:49-51)."""

    rgb: np.ndarray          # (H, W) float32 grayscale
    depth_raw: np.ndarray    # (H, W) float32 (pre depth-map-factor transform)
    flow: np.ndarray         # (H, W, 2) float32
    mask: np.ndarray         # (H, W) int32
    pose_gt_raw: np.ndarray  # (4, 4) float32 RAW pose_gt.txt row, i.e.
                             # camera->world; the tracker inverts and
                             # origin-normalizes it (Tracking.cc:320-331)
    obj_gt_rows: np.ndarray  # (n_obj, 10) float32 raw object_pose.txt rows
    timestamp: float


class SequenceDataset:
    """Reference-layout sequence reader (example/vdo_slam.cc:150-450)."""

    def __init__(self, seq_dir: str | Path):
        self.dir = Path(seq_dir)
        self.timestamps = self._read_times()
        self.poses_gt = self._read_pose_gt()
        self.obj_rows = self._read_obj_pose()
        n = len(self.timestamps)
        self.obj_by_frame: list[np.ndarray] = []
        for f in range(n):
            if self.obj_rows.size:
                sel = self.obj_rows[self.obj_rows[:, 0].astype(int) == f]
            else:
                sel = np.zeros((0, 10), np.float32)
            self.obj_by_frame.append(sel.astype(np.float32))

    def __len__(self) -> int:
        # the demo loop runs nImages = len-1 frames (vdo_slam.cc:87)
        return max(len(self.timestamps) - 1, 0)

    def _read_times(self):
        lines = (self.dir / "times.txt").read_text().split()
        return [float(t) for t in lines]

    def _read_pose_gt(self):
        poses = []
        for line in (self.dir / "pose_gt.txt").read_text().splitlines():
            vals = line.split()
            if not vals:
                continue
            m = np.eye(4, dtype=np.float32)
            nums = [float(v) for v in vals[1:]]
            m_flat = np.asarray(nums, dtype=np.float32)
            m[: m_flat.size // 4, :] = m_flat.reshape(-1, 4)
            poses.append(m)
        return poses

    def _read_obj_pose(self):
        p = self.dir / "object_pose.txt"
        if not p.exists():
            return np.zeros((0, 10), np.float32)
        rows = []
        for line in p.read_text().splitlines():
            vals = [float(v) for v in line.split()]
            if vals:
                rows.append((vals + [0.0] * 10)[:10])
        return np.asarray(rows, dtype=np.float32)

    def _read_semantic_txt(self, path: Path, shape):
        flat = np.loadtxt(path, dtype=np.int32)
        return flat.reshape(shape)

    def __getitem__(self, i: int) -> FrameData:
        from PIL import Image

        name = f"{i:06d}"
        rgb = np.asarray(Image.open(self.dir / "image_0" / f"{name}.png"))
        if rgb.ndim == 3:
            rgb = rgb @ np.asarray([0.299, 0.587, 0.114])
        rgb = rgb.astype(np.float32) / 255.0
        depth = np.asarray(
            Image.open(self.dir / "depth" / f"{name}.png")
        ).astype(np.float32)
        flow = read_flo(self.dir / "flow" / f"{name}.flo").astype(np.float32)
        mask = self._read_semantic_txt(
            self.dir / "semantic" / f"{name}.txt", rgb.shape
        )
        return FrameData(
            rgb=rgb,
            depth_raw=depth,
            flow=flow,
            mask=mask,
            pose_gt_raw=self.poses_gt[i],
            obj_gt_rows=self.obj_by_frame[i],
            timestamp=self.timestamps[i],
        )


class SyntheticDataset:
    """Wraps a SyntheticScene in the SequenceDataset interface.

    Object GT rows are emitted in the KITTI object_pose.txt encoding that
    Tracking::ObjPoseParsingKT expects: [frame, obj_id, box(4), t(3), yaw]
    with the pose given in the CAMERA frame of that frame (the reference
    converts to world via Last_Twc_gt * L, Tracking.cc:849-865).
    """

    def __init__(self, scene: SyntheticScene, depth_map_factor: float = 1.0,
                 bf: float = 1.0):
        self.scene = scene
        # pipeline transforms raw depth via bf / (raw / factor); invert here so
        # the metric GT depth survives the round-trip.
        self._depth_raw = np.where(
            scene.depth > 0, depth_map_factor * bf / np.maximum(scene.depth, 1e-6), 0.0
        ).astype(np.float32)

    def __len__(self) -> int:
        return self.scene.rgb.shape[0] - 1

    def __getitem__(self, i: int) -> FrameData:
        s = self.scene
        T_wc = s.T_wc_gt[i].astype(np.float64)
        T_cw = np.eye(4, dtype=np.float64)
        T_cw[:3, :3] = T_wc[:3, :3].T
        T_cw[:3, 3] = -T_wc[:3, :3].T @ T_wc[:3, 3]
        rows = []
        for k, lab in enumerate(s.obj_labels):
            L_w = s.obj_pose_gt[i, k].astype(np.float64)
            L_c = T_cw @ L_w  # pose in this frame's camera coordinates
            yaw = np.arctan2(L_c[0, 2], L_c[2, 2]) - np.pi / 2.0
            rows.append(
                [i, float(lab), 0, 0, 10, 10,
                 L_c[0, 3], L_c[1, 3], L_c[2, 3], yaw]
            )
        return FrameData(
            rgb=s.rgb[i],
            depth_raw=self._depth_raw[i],
            flow=s.flow[i],
            mask=s.mask[i],
            pose_gt_raw=T_wc.astype(np.float32),
            obj_gt_rows=np.asarray(rows, dtype=np.float32).reshape(-1, 10),
            timestamp=0.1 * i if i > 0 else 1e-3,
        )


class SyntheticOMDDataset(SyntheticDataset):
    """SyntheticScene wrapped with OMD conventions: object GT rows in the
    ObjPoseParsingOX encoding ([frame, label, t(3), axis-angle(3), 0, 0],
    poses in the RAW world frame; the tracker origin-normalizes them,
    Tracking.cc:2120-2182)."""

    def __getitem__(self, i: int) -> FrameData:
        fd = super().__getitem__(i)
        s = self.scene
        rows = []
        for k, lab in enumerate(s.obj_labels):
            L_w = s.obj_pose_gt[i, k].astype(np.float64)
            # raw frame = first camera frame (origin_inv = T_wc[0]):
            # ObjPoseParsingOX returns inv(origin) @ pose, so pass
            # origin @ L_w_normalized... here GT already lives in the
            # normalized world (frame-0 camera), so pre-compose with T_wc[0].
            L_raw = s.T_wc_gt[0].astype(np.float64) @ L_w
            R = L_raw[:3, :3]
            # rotation matrix -> axis-angle
            cos_t = np.clip((np.trace(R) - 1) / 2, -1, 1)
            th = np.arccos(cos_t)
            if th > 1e-8:
                axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                                 R[1, 0] - R[0, 1]]) / (2 * np.sin(th))
            else:
                axis = np.zeros(3)
            rvec = axis * th
            rows.append([i, float(lab), L_raw[0, 3], L_raw[1, 3], L_raw[2, 3],
                         rvec[0], rvec[1], rvec[2], 0.0, 0.0])
        return FrameData(
            rgb=fd.rgb, depth_raw=fd.depth_raw, flow=fd.flow, mask=fd.mask,
            pose_gt_raw=fd.pose_gt_raw,
            obj_gt_rows=np.asarray(rows, np.float32).reshape(-1, 10),
            timestamp=fd.timestamp,
        )
