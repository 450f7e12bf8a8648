#!/usr/bin/env python3
"""The JAX package's accuracy digits on the bench scene under bench.py's
config, the numbers chip_smoke.py holds the PyTorch port's wire path to.

    JAX_PLATFORMS=cpu python tools/jax_wire_reference.py [--frames 100]

Builds the scene and config as bench.py does (make_scene 1242x375, 3
objects, seed 7; tpu_fast's wire flags, fused_chunk=4, the full-graph
caps), packs the frames into an InMemoryPackedDataset, and runs
System(mode="fused", enable_local_ba=True, enable_global_ba=True)
.run_sequence.  Prints one JSON object: the metrics before and after the
full BA and each window solve's cost before and after.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

W, H = 1242, 375


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--chunk", type=int, default=4)
    args = ap.parse_args()

    from vdo_slam_tpu.config import (KITTI, ShapeConfig, TrackingConfig,
                                     VDOConfig, tpu_fast)
    from vdo_slam_tpu.io.dataset import SyntheticDataset
    from vdo_slam_tpu.io.packed_dataset import InMemoryPackedDataset
    from vdo_slam_tpu.io.synthetic import make_scene
    from vdo_slam_tpu.pipeline import System

    scene = make_scene(num_frames=args.frames + 1, width=W, height=H,
                       num_objects=3, fx=721.5377, seed=7)
    cfg = VDOConfig()
    cfg = tpu_fast(cfg.replace(
        camera=dataclasses.replace(
            cfg.camera, fx=721.5377, fy=721.5377, cx=W / 2.0, cy=H / 2.0,
            width=W, height=H, bf=387.5744),
        tracking=dataclasses.replace(
            TrackingConfig(), dataset=KITTI, depth_map_factor=256.0,
            fused_chunk=args.chunk),
        shapes=ShapeConfig(),
        backend=dataclasses.replace(
            cfg.backend, full_obs_cap=245760, full_ter_cap=131072,
            full_point_cap=122880, full_motion_cap=192, full_smo_cap=192)))
    tr = cfg.tracking
    ds = SyntheticDataset(scene, depth_map_factor=256.0, bf=387.5744)
    pds = InMemoryPackedDataset(
        ds, depth_map_factor=256.0, flow_down=tr.flow_down,
        flow_delta=tr.flow_delta, depth_down=tr.depth_down,
        depth_resid=tr.depth_resid, entropy=tr.entropy,
        seg_cap=tr.wire_seg_cap, depth_exc_cap=tr.wire_depth_exc_cap)
    sysm = System(cfg, enable_local_ba=True, enable_global_ba=True,
                  mode="fused")
    reports = sysm.run_sequence(pds)
    # metrics(refined=False) reads the poses the window solves wrote back
    out = {
        "frames": len(reports),
        "wire_bytes_per_frame": int(pds[0].packed.nbytes),
        "initial": sysm.metrics(),
        "refined": sysm.metrics(refined=True),
        "window_cost": [(float(h["cost0"]), float(h["cost"]))
                        for h in sysm.tracker.ba_health],
        "ba_failures": sysm.tracker.ba_failures,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
