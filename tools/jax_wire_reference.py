#!/usr/bin/env python3
"""The JAX package's accuracy digits on the bench scene under bench.py's
config, the numbers chip_smoke.py holds the PyTorch port's wire path and
the port's bench (vdo_slam_tpu_torch/bench.py) to.

    JAX_PLATFORMS=cpu python tools/jax_wire_reference.py [--frames 100]
    JAX_PLATFORMS=cpu python tools/jax_wire_reference.py --hard
    JAX_PLATFORMS=cpu python tools/jax_wire_reference.py --streams 6

Builds the scene and config as bench.py does (make_scene 1242x375, 3
objects, seed 7; tpu_fast's wire flags, fused_chunk=4, the full-graph
caps), packs the frames into an InMemoryPackedDataset, and runs
System(mode="fused", enable_local_ba=True, enable_global_ba=True)
.run_sequence.  Prints one JSON object: the metrics before and after the
full BA and each window solve's cost before and after.

--hard runs the same on bench.py --hard's degraded scene (bench.py:246-259:
flow sigma 0.75 px, 1 % outliers, masks eroded and jittered by 1 px, seed
13).  --streams S runs bench.py's bench_multistream instead (bench.py:
40-162): its config (no full-graph caps, fused_chunk 1), S windows of
--stream-frames frames at offsets (7 s) mod (len - n), MultiStreamSystem
with window BA, 3 frames stepped in sync, the rest with sync=False, then
flush; prints each stream's metrics, the aggregate and the window solves.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

W, H = 1242, 375


class _View:
    """n frames of a dataset from `start` (bench.py:100-108)."""

    def __init__(self, base, start, n):
        self.base, self.start, self.n = base, start, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.base[self.start + i]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--hard", action="store_true")
    ap.add_argument("--streams", type=int, default=0)
    ap.add_argument("--stream-frames", type=int, default=40)
    args = ap.parse_args()

    from vdo_slam_tpu.config import (KITTI, ShapeConfig, TrackingConfig,
                                     VDOConfig, tpu_fast)
    from vdo_slam_tpu.io.dataset import SyntheticDataset
    from vdo_slam_tpu.io.packed_dataset import InMemoryPackedDataset
    from vdo_slam_tpu.io.synthetic import degrade_scene, make_scene
    from vdo_slam_tpu.pipeline import System

    scene = make_scene(num_frames=args.frames + 1, width=W, height=H,
                       num_objects=3, fx=721.5377, seed=7)
    if args.hard:
        scene = degrade_scene(scene, flow_noise_px=0.75,
                              flow_outlier_frac=0.01, mask_erode_px=1,
                              mask_jitter_px=1, seed=13)
    cfg = VDOConfig()
    camera = dataclasses.replace(
        cfg.camera, fx=721.5377, fy=721.5377, cx=W / 2.0, cy=H / 2.0,
        width=W, height=H, bf=387.5744)
    if args.streams:
        cfg = tpu_fast(cfg.replace(
            camera=camera,
            tracking=dataclasses.replace(TrackingConfig(), dataset=KITTI,
                                         depth_map_factor=256.0),
            shapes=ShapeConfig()))
    else:
        cfg = tpu_fast(cfg.replace(
            camera=camera,
            tracking=dataclasses.replace(
                TrackingConfig(), dataset=KITTI, depth_map_factor=256.0,
                fused_chunk=args.chunk),
            shapes=ShapeConfig(),
            backend=dataclasses.replace(
                cfg.backend, full_obs_cap=245760, full_ter_cap=131072,
                full_point_cap=122880, full_motion_cap=192,
                full_smo_cap=192)))
    tr = cfg.tracking
    ds = SyntheticDataset(scene, depth_map_factor=256.0, bf=387.5744)
    pds = InMemoryPackedDataset(
        ds, depth_map_factor=256.0, flow_down=tr.flow_down,
        flow_delta=tr.flow_delta, depth_down=tr.depth_down,
        depth_resid=tr.depth_resid, entropy=tr.entropy,
        seg_cap=tr.wire_seg_cap, depth_exc_cap=tr.wire_depth_exc_cap)
    if args.streams:
        print(json.dumps(_streams(cfg, pds, args.streams,
                                  args.stream_frames)))
        return 0
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


def _streams(cfg, pds, n_streams: int, n_frames: int) -> dict:
    """bench.py's bench_multistream drive (bench.py:110-146), without its
    timing and uploader thread."""
    from vdo_slam_tpu.parallel import MultiStreamSystem

    offsets = [(7 * s) % (len(pds) - n_frames) for s in range(n_streams)]
    views = [_View(pds, off, n_frames) for off in offsets]
    msys = MultiStreamSystem(cfg, n_streams=n_streams, enable_local_ba=True)
    warm = 3
    staged = msys._stage([d[0] for d in views])
    for i in range(warm):
        msys.step_frame([d[i] for d in views], staged)
        staged = msys._stage([d[i + 1] for d in views])
    for i in range(warm, n_frames):
        nxt = (msys._stage([d[i + 1] for d in views])
               if i + 1 < n_frames else None)
        msys.step_frame([d[i] for d in views], staged, sync=False)
        staged = nxt
    msys.flush()
    m = msys.metrics()
    return {
        "streams": n_streams,
        "frames": n_frames,
        "offsets": offsets,
        "per_stream": m["per_stream"],
        "aggregate": m["aggregate"],
        "window_solves": [len(t.ba_health) for t in msys.trackers],
        "ba_failures": [t.ba_failures for t in msys.trackers],
    }


if __name__ == "__main__":
    sys.exit(main())
