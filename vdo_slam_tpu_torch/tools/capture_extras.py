"""Run the bench's non-default modes and keep their JSON lines in one
file; a jax-free port of tools/capture_extras.py.

    python -m vdo_slam_tpu_torch.tools.capture_extras --round N \
        [--streams 4 8] [--skip-hard] [--timeout 3600] [--device cpu]

Runs `python -m vdo_slam_tpu_torch.bench` with --hard, with --streams S
for each S, and with --throughput, one after another, each in a fresh
process (never two at once: each mode times its own run), with
VDO_BENCH_NO_PROBE=1 unless the environment sets it.  For each it keeps
the arguments, exit code, wall seconds, parsed JSON line and the last
lines of stderr, and writes them with the card's nvidia-smi line to
BENCH_torch_extra_r<NN>.json at the repository root.  It never writes the
original tool's BENCH_extra_r<NN>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from datetime import datetime, timezone
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def parse_json_line(stdout: str) -> dict | None:
    """The last line of stdout that parses as a JSON object, else None."""
    found = None
    for ln in stdout.strip().splitlines():
        ln = ln.strip()
        if ln.startswith("{"):
            try:
                found = json.loads(ln)
            except json.JSONDecodeError:
                pass
    return found


def run_mode(args: list[str], timeout: int, device: str) -> dict:
    """Run one bench mode in a fresh process; its JSON line, exit code,
    wall seconds and stderr tail."""
    env = dict(os.environ)
    env.setdefault("VDO_BENCH_NO_PROBE", "1")   # the probe is the default
    argv = [*args, "--device", device]           # mode's, which is not run
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vdo_slam_tpu_torch.bench", *argv],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)
    wall = time.perf_counter() - t0
    line = parse_json_line(proc.stdout)
    print(f"[capture] {' '.join(args)}: rc={proc.returncode} {wall:.0f}s "
          f"-> {line}", file=sys.stderr, flush=True)
    return {"args": args, "rc": proc.returncode, "wall_s": round(wall, 1),
            "result": line,
            "stderr_tail": proc.stderr.strip().splitlines()[-12:]}


def modes(streams, skip_hard: bool) -> list[list[str]]:
    """The modes in the order they run."""
    out = [] if skip_hard else [["--hard"]]
    out += [["--streams", str(s)] for s in streams]
    return out + [["--throughput"]]    # S = 6, bench.py's most throughput


def card(device: str) -> str:
    """nvidia-smi's name and power limit of the card; raises without one
    unless the device is the CPU."""
    import torch

    from ..bench import card_line

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run the "
                           "bench's modes on the CPU")
    return card_line(dev)


def main(argv=None, root: Path = REPO) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--round", type=int, required=True)
    ap.add_argument("--streams", type=int, nargs="*", default=[4])
    ap.add_argument("--skip-hard", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    line = card(args.device)
    runs = [run_mode(m, args.timeout, args.device)
            for m in modes(args.streams, args.skip_hard)]
    artifact = {
        "captured_utc": datetime.now(timezone.utc).isoformat(
            timespec="seconds"),
        "card": line,
        "runs": runs,
    }
    out = Path(root) / f"BENCH_torch_extra_r{args.round:02d}.json"
    out.write_text(json.dumps(artifact, indent=2) + "\n")
    print(f"[capture] wrote {out}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
