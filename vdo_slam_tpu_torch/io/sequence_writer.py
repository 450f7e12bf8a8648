"""Copy of vdo_slam_tpu/io/sequence_writer.py, unchanged apart from this line.

Write a SyntheticScene to disk in the reference's sequence layout.

Produces exactly the directory structure example/vdo_slam.cc LoadData/
LoadMask consume (lines 150-450) — times.txt, image_0/%06d.png (8-bit gray),
depth/%06d.png (16-bit raw disparity), semantic/%06d.txt, flow/%06d.flo,
pose_gt.txt (frame + 12 floats, 3x4 row-major), object_pose.txt (KITTI rows:
[frame obj_id box(4) t(3) yaw], Tracking::ObjPoseParsingKT) — so the repo's
own readers (SequenceDataset / NativeSequenceDataset) and the reference
binary can both run the same synthetic sequence from disk.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .flo import write_flo
from .synthetic import SyntheticScene


def write_reference_sequence(scene: SyntheticScene, root: str | Path,
                             depth_map_factor: float = 256.0,
                             bf: float = 387.5744) -> Path:
    """Write `scene` under `root` in the reference on-disk layout.

    Depth is stored as the KITTI-style raw value `depth_map_factor * bf / z`
    rounded to uint16 (the pipeline's disparity->metric transform inverts
    this, Tracking.cc:188-201); pick depth_map_factor*bf large enough that
    quantization is small relative to scene depth (e.g. >= 2e4 for z<=50 m).
    Returns `root` as a Path.
    """
    from PIL import Image

    root = Path(root)
    for sub in ("image_0", "depth", "semantic", "flow"):
        (root / sub).mkdir(parents=True, exist_ok=True)

    n = scene.rgb.shape[0]
    times, pose_lines, obj_lines = [], [], []
    for i in range(n):
        name = f"{i:06d}"
        Image.fromarray(
            np.clip(scene.rgb[i] * 255.0, 0, 255).astype(np.uint8)
        ).save(root / "image_0" / f"{name}.png")
        z = scene.depth[i]
        raw = np.where(z > 0, depth_map_factor * bf / np.maximum(z, 1e-6), 0.0)
        Image.fromarray(
            np.clip(np.rint(raw), 0, 65535).astype(np.uint16)
        ).save(root / "depth" / f"{name}.png")
        np.savetxt(root / "semantic" / f"{name}.txt", scene.mask[i], fmt="%d")
        write_flo(root / "flow" / f"{name}.flo", scene.flow[i])
        times.append(f"{0.1 * i if i else 1e-3:.6f}")

        T_wc = scene.T_wc_gt[i].astype(np.float64)
        pose_lines.append(
            str(i) + " " + " ".join(f"{v:.9f}" for v in T_wc[:3].reshape(-1))
        )
        # object_pose.txt rows in camera coordinates of frame i (KITTI
        # convention; the tracker converts to world via Last_Twc_gt * L,
        # Tracking.cc:849-865)
        T_cw = np.eye(4)
        T_cw[:3, :3] = T_wc[:3, :3].T
        T_cw[:3, 3] = -T_wc[:3, :3].T @ T_wc[:3, 3]
        for k, lab in enumerate(scene.obj_labels):
            L_c = T_cw @ scene.obj_pose_gt[i, k].astype(np.float64)
            yaw = np.arctan2(L_c[0, 2], L_c[2, 2]) - np.pi / 2.0
            vals = [i, float(lab), 0, 0, 10, 10,
                    L_c[0, 3], L_c[1, 3], L_c[2, 3], yaw]
            obj_lines.append(" ".join(f"{v:.9f}" for v in vals))

    (root / "times.txt").write_text("\n".join(times) + "\n")
    (root / "pose_gt.txt").write_text("\n".join(pose_lines) + "\n")
    (root / "object_pose.txt").write_text("\n".join(obj_lines) + "\n")
    return root
