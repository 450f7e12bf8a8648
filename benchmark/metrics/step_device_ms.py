"""The frame step's device time per step: the summed duration of the
kernels on the stream that ran the most of them (the tracker's step),
clipped to the traced stretch of the window's one call, divided by the
steps in that stretch (`run.trace_frames`: frames of a drive, batched
steps of all streams in a "streams" cell)."""


def read(run):
    tr = run.trace
    if tr is None or not run.trace_frames:
        return None
    stream = tr.main_stream()
    ns = sum(e - s for _, s, e, st in tr.kernels() if st == stream)
    return ns / 1e6 / run.trace_frames if ns else None
