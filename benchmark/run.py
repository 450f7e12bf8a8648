"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 -m benchmark.run --workload kitti-drive --seed 7 --seconds 20 \
        --trace 0

From the root of a checkout, on a machine with the chips the cell asks for.
The cell names a configuration file (benchmark/configs/) and a traffic file
(benchmark/traffic/); the traffic file's "kind" is the loop in
benchmark/kinds/<kind>.py, and each per-layer metric is read by
benchmark/metrics/<name>.py.  The limits that decide `correct` are in
benchmark/limits/<cell>.json.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the end-to-end metrics with --trace 0, the per-layer ones
with --trace 1), device, with --trace 1 a breakdown, and last the numbers
compared with their limits; the same comparisons are the last lines of
standard error.  A run without the chips, or with jax or the JAX package
loaded, exits with code 3 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "vdo_slam_tpu"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell's entry, its configuration file, traffic file and limits."""
    spec = _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    return {"spec": spec, "cell": cell,
            "config": _json(ROOT / conf["file"]),
            "traffic": _json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "limits": _json(HERE / "limits" / f"{name}.json")}


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_metric(name: str, run):
    """The per-layer metric `name` from its reader, or None where the
    reader finds nothing to read."""
    from .loads import load_file

    return load_file(HERE / "metrics" / f"{name}.py", "benchmark_metric_"
                     + name.replace(".", "_").replace("-", "_")).read(run)


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that the port must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def run_cell(name: str, seed: int, seconds: int, trace: bool,
             device: str = "cuda", t_start: float | None = None) -> tuple:
    """One run of a cell: (result line as a dict, comparison lines).  The
    caller has checked the device."""
    import torch

    from . import loads
    from .program import build_config
    from .reference import corners, describe, judge, verdict, worst
    from .trace import breakdown

    t_start = time.perf_counter() if t_start is None else t_start
    c = load_cell(name)
    cell, spec = c["cell"], c["spec"]
    cfg = build_config(c["config"], log)
    kind = loads.KINDS[c["traffic"]["kind"]]
    run = kind(c["config"], cfg, c["traffic"], seed % 2**63, seconds, trace,
               torch.device(device), t_start)

    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            if _applies(m, name):
                v = read_metric(m["name"], run)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
    else:
        vals = dict(run.e2e, setup_s=run.setup_s)
        for m in spec["end_to_end"]:
            if _applies(m, name) and m["name"] in vals:
                metrics[m["name"]] = {"value": float(vals[m["name"]]),
                                      "unit": m["unit"]}
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(torch.device(device))
                    if on_card else device),
           "count": int(cell["chips"]),
           "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": False, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = breakdown(run.trace)

    per_stream = []
    for s, st in enumerate(run.streams):
        lay = st.layout
        C = corners(lay.obj_patches)
        for line in describe(st.outputs, lay.T_wc, lay.L, C,
                             st.judged_frames):
            log(line if len(run.streams) == 1 else f"stream {s}: {line}")
        per_stream.append(judge(st.outputs, lay.T_wc, lay.L, C,
                                st.judged_frames))
    numbers = worst(per_stream)
    correct, lines = verdict(numbers, c["limits"])
    result["correct"] = correct
    # the numbers compared, last in the line; one that is not finite is
    # written as a string, which every JSON reader takes
    result["checks"] = {k: {"value": numbers[k] if math.isfinite(numbers[k])
                            else str(numbers[k]), "limit": lim}
                        for k, lim in c["limits"].items()}
    return result, lines


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch

    chips = int(load_cell(args.workload)["cell"]["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); this machine "
            f"has {have}")
        return 3
    log(f"card: {card_line()}")
    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", t_start)
    bad = forbidden_loaded()
    if bad:
        log(f"the run loaded {bad}: the port and the benchmark must not")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
