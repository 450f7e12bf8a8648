"""The full-batch refine's host build (backend/builders.py:
build_full_graph) per refine: the mean wall time of the program's
`full.build` spans over the window's refines of a traced run, before the
traced one (`run.refine`, benchmark/kinds/refine.py)."""

from benchmark.counting import mean_or_none


def read(run):
    r = getattr(run, "refine", None)
    return mean_or_none(r["build_ms"]) if r else None
