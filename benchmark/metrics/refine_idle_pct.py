"""The share of the traced refine (`run.trace`, from the call of
System.refine to its return) in which no operation ran on the device:
100 less the union of kernel, copy and fill intervals.  The host's build
and write-back hold the card idle."""

from benchmark.counting import idle_pct


def read(run):
    if getattr(run, "refine", None) is None:
        return None
    return idle_pct(run.trace)
