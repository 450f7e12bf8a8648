"""Tracing / profiling utilities — port of vdo_slam_tpu/utils/profiling.py.

The reference instruments 5 pipeline stages with clock() spans (Map.h:83-84);
the trackers keep those wall-clock spans (MapState.timings).  Here: a
stage timer that waits for the device of the tensors it is given, the
PyTorch profiler in place of the JAX one, and a timed call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from pathlib import Path

import torch


def _tensors(tree):
    """The tensors of a (nested) dict, list, tuple or dataclass."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def sync(tree) -> None:
    """Wait until the devices of every tensor in `tree` are done (the JAX
    block_until_ready)."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulating wall-clock timer with device synchronization."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                sync(sync_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            k: {"total_s": v, "count": self.counts[k],
                "mean_ms": 1e3 * v / max(self.counts[k], 1)}
            for k, v in sorted(self.totals.items())
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the CPU and, where present, the CUDA device;
    written to log_dir/trace.json (Chrome trace format) on exit."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


def timed_call(fn, *args, **kwargs):
    """Run fn, sync all outputs, return (outputs, seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    sync(out)
    return out, time.perf_counter() - t0
