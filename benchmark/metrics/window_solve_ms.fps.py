"""The window solve's wall time on its thread, mean over the measured
window's solves (`MapState.lba_times`, every stream's) that ended before
the traced stretch's profiler started, which no tracing slowed."""

from benchmark.counting import mean_or_none


def read(run):
    return mean_or_none(run.window_solve_ms)
