#!/usr/bin/env python3
"""Frame by frame, the distorted runs of chip_smoke.py phase 9 on the card
against the same runs on the host's CPU.

    python3 chip_distortion_scatter.py     # from the repository root; one GPU

The bench scene rendered through the barrel lens chip_smoke uses (DIST,
25 frames), with k1/k2 configured, through System(mode="reference") and
System(mode="fused"), BA off, once with device="cuda" and once with
device="cpu".  Prints, per mode and frame, the camera pose gap between
the two devices (m, deg), the camera inliers on each, and what the two
archives show about the banks: rows valid on one device only; rows valid
on both whose keypoints lie 1e-2 px or more apart; and of the rows within
1e-2 px, how many sit in different pixels (a pixel edge between them, so
the int-truncating gathers read different pixels) and how many carry a
different depth or label.  Then the first frame past 1e-3 m / 0.01 deg
and the first frame with such a gather flip, one JSON line per mode.
Both devices draw the same random numbers (pipeline/draws.py).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

T_TOL_M, R_TOL_DEG = 1e-3, 0.01       # the undistorted step's bound
XY_CLOSE_PX = 1e-2


def _bank_flips(xy_a, xy_b, valid_a, valid_b, vals_a, vals_b):
    """(rows valid on one device only, rows valid on both at least
    XY_CLOSE_PX apart, rows within XY_CLOSE_PX in different pixels, rows
    within XY_CLOSE_PX with any gathered value differing)."""
    both = valid_a & valid_b
    close = both & (np.abs(xy_a - xy_b).max(-1) < XY_CLOSE_PX)
    edge = close & (np.floor(xy_a) != np.floor(xy_b)).any(-1)
    diff = np.zeros_like(close)
    for a, b in zip(vals_a, vals_b):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        diff |= d.reshape(len(close), -1).max(-1) > 1e-3 * np.maximum(
            np.abs(np.asarray(b, np.float64)).reshape(len(close), -1).max(-1),
            1.0)
    return (int((valid_a != valid_b).sum()), int((both & ~close).sum()),
            int(edge.sum()), int((close & diff).sum()))


def frame_table(card_map, cpu_map, card_reps, cpu_reps) -> list[dict]:
    from chip_smoke import _pose_gap

    rows = []
    for f in range(cpu_map.num_frames):
        t, r = _pose_gap(card_map.cam_pose[f], cpu_map.cam_pose[f])
        stat = _bank_flips(card_map.stat_xy[f], cpu_map.stat_xy[f],
                           card_map.stat_valid[f], cpu_map.stat_valid[f],
                           [card_map.stat_depth[f]], [cpu_map.stat_depth[f]])
        dyn = _bank_flips(card_map.dyn_xy[f], cpu_map.dyn_xy[f],
                          card_map.dyn_valid[f], cpu_map.dyn_valid[f],
                          [card_map.dyn_depth[f], card_map.dyn_obj_label[f],
                           card_map.dyn_sem_label[f]],
                          [cpu_map.dyn_depth[f], cpu_map.dyn_obj_label[f],
                           cpu_map.dyn_sem_label[f]])
        rows.append({"frame": f, "cam_t_m": t, "cam_r_deg": r,
                     "inliers": [card_reps[f].get("n_inlier_cam"),
                                 cpu_reps[f].get("n_inlier_cam")],
                     "static": stat, "dynamic": dyn})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_distortion_scatter: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import DIST, N_OPT_FRAMES, W, H, bench_config, card_line
    from vdo_slam_tpu_torch.bench import _View
    from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
    from vdo_slam_tpu_torch.io.synthetic import make_scene
    from vdo_slam_tpu_torch.pipeline import System

    card = card_line()
    print(f"card: {card}")
    dscene = make_scene(num_frames=N_OPT_FRAMES + 1, width=W, height=H,
                        num_objects=3, fx=721.5377, seed=7, dist=DIST)
    dds = SyntheticDataset(dscene, depth_map_factor=256.0, bf=387.5744)
    cfg = bench_config()
    dcfg = cfg.replace(camera=dataclasses.replace(cfg.camera, k1=DIST[0],
                                                  k2=DIST[1]))
    for mode in ("reference", "fused"):
        maps, reps = {}, {}
        for device in ("cuda", "cpu"):
            sysm = System(dcfg, enable_local_ba=False,
                          enable_global_ba=False, mode=mode, device=device)
            t0 = time.perf_counter()
            reps[device] = sysm.run_sequence(_View(dds, 0, N_OPT_FRAMES))
            m = sysm.metrics()
            print(f"mode {mode} on {device}: {N_OPT_FRAMES} frames in "
                  f"{time.perf_counter() - t0:.1f} s, cam_t "
                  f"{m['cam_t_rpe']:.4e} m, cam_r {m['cam_r_rpe_deg']:.4e} "
                  f"deg [{card}]")
            maps[device] = sysm.map
        rows = frame_table(maps["cuda"], maps["cpu"], reps["cuda"],
                           reps["cpu"])
        print(f"mode {mode}, card against CPU per frame: t (m), r (deg), "
              f"camera inliers card / CPU, static / dynamic rows (valid on "
              f"one only, apart, edge, value)")
        for row in rows:
            print(f"  {row['frame']:2d} {row['cam_t_m']:.3e} "
                  f"{row['cam_r_deg']:.3e}  {row['inliers']}  "
                  f"{row['static']}  {row['dynamic']}")
        past = [r["frame"] for r in rows if r["cam_t_m"] > T_TOL_M
                or r["cam_r_deg"] > R_TOL_DEG]
        flips = [r["frame"] for r in rows
                 if sum(r["static"][2:]) + sum(r["dynamic"][2:])]
        print(json.dumps({"mode": mode, "card": card,
                          "first_past_bound": past[0] if past else None,
                          "first_gather_flip": flips[0] if flips else None,
                          "frames": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
