"""The full-batch refine's write-back into the archive
(backend/full_ba.py:full_ba_inplace) per refine: the mean wall time of
the program's `full.writeback` spans over the window's refines of a
traced run, before the traced one (`run.refine`)."""

from benchmark.counting import mean_or_none


def read(run):
    r = getattr(run, "refine", None)
    return mean_or_none(r["writeback_ms"]) if r else None
