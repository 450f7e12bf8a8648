"""The share of the traced stretch of the window's one call in which no
operation ran on the device (100 less the union of kernel, copy and fill
intervals)."""

from benchmark.counting import idle_pct


def read(run):
    return idle_pct(run.trace)
