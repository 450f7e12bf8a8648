#!/usr/bin/env python3
"""One run of the port's probe or bench from a given tree, with its peak
device memory, on one GPU: the unit of a parent-against-change comparison
of the fused tracker's window solves.

    python3 chip_window_ab.py <tree> probe_loop|bench|bench_s4

Imports vdo_slam_tpu_torch from <tree> (this checkout, or an unpacked `git
archive` of another commit) and runs, on the card:
  probe_loop  tools.probe_loop.main(n_frames=48): upload, dispatch and
              device ms per frame, run_sequence with window BA off and on;
  bench       bench.main(): the default mode's fps (`python -m
              vdo_slam_tpu_torch.bench`);
  bench_s4    bench.bench_multistream(4): `--streams 4`'s aggregate fps.
The tool's own output goes to stderr.  The last line of stdout is one JSON
object: the tree, the mode, the card's nvidia-smi name and power limit,
torch.cuda.max_memory_allocated() over the run, and the run's numbers.
Run each in a fresh process, alternating the trees (parent, change,
change, parent): the host's speed drifts within a call.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time


def main(argv) -> int:
    if len(argv) != 2 or argv[1] not in ("probe_loop", "bench", "bench_s4"):
        print(__doc__, file=sys.stderr)
        return 2
    tree, mode = os.path.abspath(argv[0]), argv[1]
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_window_ab: no CUDA device", file=sys.stderr)
        return 1
    from vdo_slam_tpu_torch import bench

    if not bench.__file__.startswith(tree):
        raise RuntimeError(f"imported {bench.__file__}, not from {tree}")
    device = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        if mode == "probe_loop":
            from vdo_slam_tpu_torch.tools import probe_loop

            res = probe_loop.main(n_frames=48, device=device)
            out = {k: v for k, v in res.items() if isinstance(v, float)}
            out["ba_on_minus_off_ms_frame"] = (res["loop_ms_frame_ba_on"]
                                               - res["loop_ms_frame_ba_off"])
            out["drives"] = res["drives"]
        elif mode == "bench":
            res = bench.main(device=device)
            sysm = res["system"]
            solves = res["window_solve_ms"]
            out = {"fps": res["record"]["value"],
                   "window_solve_ms": solves,
                   "window_solve_median_ms": float(np.median(solves)),
                   "window_solves": len(sysm.tracker.ba_health),
                   "ba_failures": getattr(sysm.tracker, "ba_failures", 0),
                   "full_ba_s": res["full_ba"]["t_solve_s"]}
        else:
            res = bench.bench_multistream(4, device=device)
            trackers = res["system"].trackers
            out = {"fps": res["record"]["value"],
                   "window_solves": [len(t.ba_health) for t in trackers],
                   "ba_failures": [getattr(t, "ba_failures", 0)
                                   for t in trackers]}
    torch.cuda.synchronize()
    out.update(tree=tree, mode=mode, card=bench.card_line(device),
               seconds=time.perf_counter() - t0,
               peak_bytes=torch.cuda.max_memory_allocated(device))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
