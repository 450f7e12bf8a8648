"""The floor count of the full-batch refine's LM solve
(backend/factor_graph.py:lm_solve): the bytes of every stored edge field,
read once per linearisation and once per CG iteration, for
refine_lm_roofline_pct.  The solve reads them again for each cost and
statistic it takes and reads each edge's Jacobian blocks too, so this is
a floor: its share of the LM's device time cannot pass 100 %."""

from __future__ import annotations

# bytes of one stored edge of each type as the solve holds it on the card
# (factor_graph.upload: indices int64, the rest float32)
EDGE_BYTES = {
    "obs": 8 + 8 + 12 + 4,        # pose, point, measurement (3), weight
    "odo": 8 + 8 + 64 + 4,        # poses a, b, inverse measurement (4x4), w
    "pri": 8 + 64 + 4,            # pose, inverse measurement, weight
    "smo": 8 + 8 + 4,             # motions a, b, weight
    "ter": 8 + 8 + 8 + 4,         # points prev, cur, motion, weight
    "alt": 8 + 4,                 # motion, weight
}


def lm_floor_bytes(report: dict | None) -> int | None:
    """The floor bytes of one refine from its report (full_ba_inplace's):
    the padded edges of each type ("edges") x EDGE_BYTES, times
    iters_run x (cg_iters + 1) passes.  None where the report lacks them."""
    if not report or "edges" not in report or not report.get("iters_run"):
        return None
    per_pass = sum(EDGE_BYTES[k] * int(n) for k, n in report["edges"].items())
    return per_pass * int(report["iters_run"]) * (int(report["cg_iters"]) + 1)


def lm_device_ns(run) -> int | None:
    """The summed time of the traced refine's kernels (`run.trace`)
    clipped to the program's `full.chunk` spans of that refine
    (`run.refine["chunks"]`), in ns; None where a run has neither."""
    r = getattr(run, "refine", None)
    tr = run.trace
    if not r or tr is None or not r["chunks"]:
        return None
    ns = 0
    for _, s, e, _ in tr.kernels():
        for a, b in r["chunks"]:
            ns += max(0, min(e, b) - max(s, a))
    return ns or None
