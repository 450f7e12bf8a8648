"""Demo driver CLI — port of vdo_slam_tpu/run.py (example/vdo_slam.cc).

    python -m vdo_slam_tpu_torch.run <settings.yaml> <sequence_dir> [--out DIR]
    python -m vdo_slam_tpu_torch.run --synthetic [--frames N] [--out DIR]

Loads a reference-layout sequence (times.txt, image_0/, depth/, semantic/,
flow/, pose_gt.txt, object_pose.txt — example/vdo_slam.cc:150-450) or a
generated synthetic scene, runs the full pipeline, prints the metric and
timing summaries as JSON, and writes the reference-format result files.
Runs on the CUDA device unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("settings", nargs="?", help="reference-format yaml")
    ap.add_argument("sequence", nargs="?", help="sequence directory")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default=None, help="results output directory")
    ap.add_argument("--no-local-ba", action="store_true")
    ap.add_argument("--no-global-ba", action="store_true")
    ap.add_argument("--checkpoint", default=None,
                    help="save a resumable checkpoint here at the end")
    ap.add_argument("--plots", action="store_true", help="write error curves")
    ap.add_argument("--mode", choices=["reference", "fused"],
                    default="reference",
                    help="reference = stage-by-stage host orchestration; "
                         "fused = whole frame in one device step")
    ap.add_argument("--fast", action="store_true",
                    help="apply the tpu_fast preset (split LM budget, "
                         "5 B/px wire, 6-iteration window BA)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    from .config import load_settings
    from .pipeline import System

    if args.synthetic:
        import dataclasses

        from .config import KITTI, TrackingConfig, VDOConfig
        from .io.dataset import SyntheticDataset
        from .io.synthetic import make_scene

        scene = make_scene(num_frames=(args.frames or 20) + 1, width=640,
                           height=256, num_objects=2, seed=0)
        cfg = VDOConfig()
        cfg = cfg.replace(
            camera=dataclasses.replace(
                cfg.camera, fx=640.0, fy=640.0, cx=320.0, cy=128.0,
                width=640, height=256, bf=40.0,
            ),
            tracking=dataclasses.replace(TrackingConfig(), dataset=KITTI,
                                         depth_map_factor=1.0),
        )
        dataset = SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)
    else:
        if not args.settings or not args.sequence:
            ap.error("settings yaml and sequence dir required "
                     "(or use --synthetic)")
        from .io.dataset import SequenceDataset

        cfg = load_settings(args.settings)
        dataset = SequenceDataset(args.sequence)

    if args.fast:
        from .config import tpu_fast

        cfg = tpu_fast(cfg)
    sysm = System(cfg, enable_local_ba=not args.no_local_ba,
                  enable_global_ba=not args.no_global_ba, mode=args.mode,
                  device=args.device)
    sysm.run_sequence(dataset, max_frames=args.frames,
                      verbose=not args.quiet)

    report = {
        "metrics_initial": sysm.metrics(refined=False),
        "metrics_refined": sysm.metrics(refined=True),
        "timing": sysm.timing(),
        "frames": sysm.map.num_frames,
    }
    from .eval.velocity import velocity_report

    report["velocity"] = velocity_report(sysm.map, args.out)
    print(json.dumps(report, indent=2, default=float))

    if args.out:
        sysm.save_results(args.out)
        if args.plots:
            from .eval.plots import plot_metric_error

            plot_metric_error(sysm.map, args.out, refined=False)
            plot_metric_error(sysm.map, args.out, refined=True)
    if args.checkpoint:
        from .utils import checkpoint

        save = (checkpoint.save_checkpoint if args.mode == "reference"
                else checkpoint.save_fused_checkpoint)
        save(sysm.tracker, args.checkpoint)
    return 0


if __name__ == "__main__":
    sys.exit(main())
