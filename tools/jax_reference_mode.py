#!/usr/bin/env python3
"""The JAX package's accuracy digits for the default entry point, System
mode "reference", the numbers chip_smoke.py holds the PyTorch port's
phases 8 and 9 to.

    JAX_PLATFORMS=cpu python tools/jax_reference_mode.py [--runs NAME ...]

Runs (the scenes and configs chip_smoke.py builds):
  reference     100 frames of the bench scene (make_scene 1242x375, 3
                objects, fx 721.5377, seed 7) under chip_smoke's
                bench_ba_config, System(mode="reference") with the window
                BA and the full BA: the metrics before and after the full
                BA, and the number of window solves;
  omd           configs/omd.yaml through load_settings (principal point
                set to the synthetic scene's image centre) on 25 frames of
                a 640x480 SyntheticOMDDataset scene (2 objects, fx/fy from
                the yaml, seed 7), BA off;
  nonjoint      25 bench frames, bench_config with joint_flow=False and
                depth_noise=True, BA off;
  distorted     25 frames of the bench scene rendered through
                dist=(-0.28, 0.07, 0, 0, 0), k1/k2 configured, BA off;
  control       the same frames with the coefficients left at zero;
  distorted_fused  the distorted run in System(mode="fused").
Prints one JSON object, run name -> metrics.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

W, H = 1242, 375
N_REF, N_OPT = 100, 25
DIST = (-0.28, 0.07, 0.0, 0.0, 0.0)
RUNS = ("reference", "omd", "nonjoint", "distorted", "control",
        "distorted_fused")


def bench_config(**tracking):
    from vdo_slam_tpu.config import (KITTI, ShapeConfig, TrackingConfig,
                                     VDOConfig)

    cfg = VDOConfig()
    return cfg.replace(
        camera=dataclasses.replace(
            cfg.camera, fx=721.5377, fy=721.5377, cx=W / 2.0, cy=H / 2.0,
            width=W, height=H, bf=387.5744),
        tracking=dataclasses.replace(TrackingConfig(), dataset=KITTI,
                                     depth_map_factor=256.0, **tracking),
        shapes=ShapeConfig(),
        solver=dataclasses.replace(cfg.solver, lm_iters=10, lm_iters_obj=6))


def bench_ba_config():
    cfg = bench_config()
    return cfg.replace(backend=dataclasses.replace(
        cfg.backend, full_obs_cap=245760, full_ter_cap=131072,
        full_point_cap=122880, full_motion_cap=192, full_smo_cap=192,
        local_iters=4))


def omd_scene_config():
    """(scene, config): configs/omd.yaml, the scene rendered with its
    focal lengths, the principal point set to the scene's image centre."""
    from vdo_slam_tpu.config import load_settings
    from vdo_slam_tpu.io.synthetic import make_scene

    cfg = load_settings(REPO / "configs" / "omd.yaml")
    scene = make_scene(num_frames=N_OPT + 1, width=cfg.camera.width,
                       height=cfg.camera.height, num_objects=2,
                       fx=cfg.camera.fx, fy=cfg.camera.fy, seed=7)
    K = scene.K_mat
    return scene, cfg.replace(camera=dataclasses.replace(
        cfg.camera, cx=float(K[0, 2]), cy=float(K[1, 2])))


def run(cfg, ds, n, mode="reference", ba=False):
    from vdo_slam_tpu.pipeline import System

    sysm = System(cfg, enable_local_ba=ba, enable_global_ba=ba, mode=mode)
    reports = sysm.run_sequence(ds, max_frames=n)
    out = {"frames": len(reports), "initial": sysm.metrics()}
    if ba:
        out["refined"] = sysm.metrics(refined=True)
        out["window_solves"] = len(sysm.map.lba_times)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", nargs="*", default=list(RUNS), choices=RUNS)
    args = ap.parse_args()

    from vdo_slam_tpu.io.dataset import SyntheticDataset, SyntheticOMDDataset
    from vdo_slam_tpu.io.synthetic import make_scene

    out = {}
    todo = set(args.runs)
    if todo & {"reference", "nonjoint"}:
        n = N_REF + 1 if "reference" in todo else N_OPT + 1
        scene = make_scene(num_frames=n, width=W, height=H, num_objects=3,
                           fx=721.5377, seed=7)
        ds = SyntheticDataset(scene, depth_map_factor=256.0, bf=387.5744)
        if "reference" in todo:
            out["reference"] = run(bench_ba_config(), ds, N_REF, ba=True)
        if "nonjoint" in todo:
            out["nonjoint"] = run(bench_config(joint_flow=False,
                                               depth_noise=True), ds, N_OPT)
    if "omd" in todo:
        scene, cfg = omd_scene_config()
        ds = SyntheticOMDDataset(scene, depth_map_factor=1000.0,
                                 bf=cfg.camera.bf)
        out["omd"] = run(cfg, ds, N_OPT)
    if todo & {"distorted", "control", "distorted_fused"}:
        scene = make_scene(num_frames=N_OPT + 1, width=W, height=H,
                           num_objects=3, fx=721.5377, seed=7, dist=DIST)
        ds = SyntheticDataset(scene, depth_map_factor=256.0, bf=387.5744)
        cfg = bench_config()
        dcfg = cfg.replace(camera=dataclasses.replace(cfg.camera, k1=DIST[0],
                                                      k2=DIST[1]))
        if "distorted" in todo:
            out["distorted"] = run(dcfg, ds, N_OPT)
        if "control" in todo:
            out["control"] = run(cfg, ds, N_OPT)
        if "distorted_fused" in todo:
            out["distorted_fused"] = run(dcfg, ds, N_OPT, mode="fused")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
