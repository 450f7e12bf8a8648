"""The full-batch refine's LM solve on the device, per refine: the summed
time of the kernels of the traced refine (`run.trace`), clipped to the
program's `full.chunk` spans of that refine (one per LM chunk, from its
launch to the gain test after it; benchmark/refine_counting.py:
lm_device_ns)."""

from benchmark.refine_counting import lm_device_ns


def read(run):
    ns = lm_device_ns(run)
    return ns / 1e6 if ns else None
