"""Two stream groups against one, on the CPU, frame by frame: the runs that
tests/test_torch_multistream.py::test_two_devices_equal_one_device holds,
built without jax so that the gap can be measured on a host that has none.

    python tests/torch_two_groups.py      # from the repository root

Prints one JSON line: the host, and for each stream the largest gap of
each archived frame's camera pose entries (cam_pose and cam_pose_rf) over
two groups ["cpu", "cpu"] against one group ["cpu"].
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import sys
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":       # run as a script: the repository root
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vdo_slam_tpu_torch.config import (KITTI, ShapeConfig, TrackingConfig,
                                       VDOConfig)
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.io.synthetic import make_scene
from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL
from vdo_slam_tpu_torch.parallel import MultiStreamSystem

# tpu_fast's wire (tests/test_torch_slice.py:WIRE)
WIRE = dict(wire_flow_half=True, wire_flow_delta=True, wire_entropy=True,
            wire_seg_cap=1024, wire_depth_exc_cap=2048)


def tiny_wire_config(w: int = 96, h: int = 64) -> VDOConfig:
    """tests/test_multistream.py:tiny_config in the port's dataclasses,
    under tpu_fast's wire, window BA every 2 frames from frame 3, drains of
    3 frames."""
    cfg = VDOConfig()
    return cfg.replace(
        camera=dataclasses.replace(cfg.camera, fx=float(w), fy=float(w),
                                   cx=w / 2.0, cy=h / 2.0, width=w, height=h,
                                   bf=40.0),
        tracking=dataclasses.replace(
            TrackingConfig(), dataset=KITTI, depth_map_factor=1.0,
            boundary_shrink_row=4, boundary_shrink_col=6, min_obj_points=20,
            min_init_inliers=10, window_size=4, overlap_size=2,
            fused_drain_chunks=3, **WIRE),
        shapes=ShapeConfig(max_static=128, max_dynamic=256, max_objects=4,
                           ransac_samples=32),
        frontend=dataclasses.replace(cfg.frontend, n_features=200,
                                     n_levels=2))


def two_group_runs(cfg: VDOConfig) -> dict:
    """S = 2 on two 96x64 scenes (seeds 1, 2), window BA on: on one device
    ("one") and over ["cpu", "cpu"], one stream per device ("two").  Each:
    (system, reports, FAST kernel launches)."""
    dss = [SyntheticDataset(make_scene(num_frames=7, width=96, height=64,
                                       num_objects=1, seed=s),
                            depth_map_factor=1.0, bf=40.0) for s in (1, 2)]
    runs = {}
    for name, devices in (("one", ["cpu"]), ("two", ["cpu", "cpu"])):
        msys = MultiStreamSystem(cfg, n_streams=2, enable_local_ba=True,
                                 devices=devices)
        launches = KERNEL.launches
        runs[name] = (msys, msys.run(dss), KERNEL.launches - launches)
    return runs


def frame_gaps(one, two, s: int) -> list[float]:
    """Stream s: per archived frame, the largest absolute difference of any
    camera pose entry (cam_pose and cam_pose_rf) between the two runs."""
    a, b = two.maps[s], one.maps[s]
    return [float(max(np.abs(np.asarray(a.cam_pose[f])
                             - np.asarray(b.cam_pose[f])).max(),
                      np.abs(np.asarray(a.cam_pose_rf[f])
                             - np.asarray(b.cam_pose_rf[f])).max()))
            for f in range(a.num_frames)]


def main() -> None:
    torch.set_num_threads(1)      # as the test runs
    runs = two_group_runs(tiny_wire_config())
    one, two = runs["one"][0], runs["two"][0]
    print(json.dumps({
        "host": {"machine": platform.machine(),
                 "processor": platform.processor(),
                 "cpus": os.cpu_count(), "torch": torch.__version__,
                 "cpu_capability": torch.backends.cpu.get_cpu_capability()},
        "gaps": [frame_gaps(one, two, s) for s in range(2)]}))


if __name__ == "__main__":
    main()
