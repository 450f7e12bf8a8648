"""The control's readings at a cell's own size: the reference put in the
program's place in bfloat16 (benchmark/reference.py:control), judged over
the frames a run of the cell judges.

    python3 -m benchmark.control --workload kitti-drive --seconds 20 \
        --seeds 11 12 13

The benchmark's own runs do not run it; it sets the upper reading of each
limit in benchmark/limits/ (PERF.md gives the readings).
"""

from __future__ import annotations

import argparse
import json


def readings(workload: str, seed: int, seconds: float) -> dict:
    from . import loads
    from .program import build_config
    from .reference import control, corners
    from .run import load_cell

    c = load_cell(workload)
    cfg, tr = build_config(c["config"]), c["traffic"]
    warm, n = loads.window_frames(tr, seconds)
    lay = loads.layout_for(c["config"], cfg, loads.total_frames(tr, n),
                           seed)
    return control(lay.T_wc, lay.L, corners(lay.obj_patches),
                   range(warm, warm + n))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for s in args.seeds:
        print(json.dumps({"seed": s, **readings(args.workload, s,
                                                args.seconds)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
