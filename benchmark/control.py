"""The control's readings at a cell's own size: the reference put in the
program's place in bfloat16 (benchmark/reference.py:control), judged over
the frames a run of the cell judges, in every stream of the cell's
traffic kind (its `worlds`).

    python3 -m benchmark.control --workload kitti-drive --seconds 20 \
        --seeds 11 12 13

One JSON line per seed: the numbers over the streams as a run takes them
(reference.py:worst), and with several streams each stream's own under
"per_stream".  The benchmark's own runs do not run it; it sets the upper
reading of each limit in benchmark/limits/ (PERF.md gives the readings).
"""

from __future__ import annotations

import argparse
import json


def readings(workload: str, seed: int, seconds: float) -> dict:
    from . import loads
    from .program import build_config
    from .reference import control, corners, worst
    from .run import load_cell

    c = load_cell(workload)
    cfg, tr = build_config(c["config"]), c["traffic"]
    kind = loads.kind_module(tr["kind"])
    per_stream = [control(st.layout.T_wc, st.layout.L,
                          corners(st.layout.obj_patches), st.judged_frames)
                  for st in kind.worlds(c["config"], cfg, tr, seed, seconds)]
    out = worst(per_stream)
    if len(per_stream) > 1:
        out["per_stream"] = per_stream
    return out


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
