"""The port's span recorder — port of
vdo_slam_tpu/utils/profiling.py.

The reference instruments 5 pipeline stages with clock() spans (Map.h:83-84);
the trackers keep those as per-frame stage times (MapState.timings).  This
module records where the HOST's time goes: the fused drive's staging,
dispatch, drain and archive, the window-solve thread's phases, and the
set-up's graph captures and kernel build.

Off by default.  `recording()` turns it on for the block it encloses and
yields the `StageTimer` that collects the records, which stay in memory:

    with profiling.recording() as rec:
        System(cfg, mode="fused").run_sequence(frames)
    rec.spans

A site is `with profiling.span(name, unit):`.
Off, a site reads the module's `ACTIVE` reference and branches: it reads no
clock, allocates nothing and never waits for the device.  On, each span
records its name, its start and end on `time.time_ns()` (the clock
torch.profiler stamps device operations with, so spans and device
operations line up with no conversion), the thread, the unit of work (the
first frame of a chunk or batch, a window solve's end, a graph's name),
its parent (the innermost span open on the same thread) and, where the site
asks (`cpu=True`, pure host work), the thread's CPU time over the span:
wall less CPU is the time the work was ready but off the CPU, held by the
interpreter lock or the scheduler.  A site that already times itself hands
its own clock reads to `StageTimer.add`, so its report and its span agree
exactly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from collections import defaultdict

# the recorder that is on, else None: read once by every site
ACTIVE: StageTimer | None = None


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span; times in ns on time.time_ns()'s clock."""

    id: int
    name: str
    unit: object            # the first frame, window end or graph name
    thread: str             # the name of the thread that ran it
    parent: int | None      # id of the innermost span open on its thread
    start_ns: int
    end_ns: int = 0
    cpu_ns: int | None = None   # the thread's CPU time over it, if asked
    n: int = 1              # frames it covers

    @property
    def wall_ns(self) -> int:
        return self.end_ns - self.start_ns


class _Off:
    """The null span of a site while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """A span in a `with` block: opened on entry, recorded on exit."""

    __slots__ = ("rec", "name", "unit", "n", "cpu", "span")

    def __init__(self, rec, name, unit, n, cpu):
        self.rec, self.name, self.unit, self.n, self.cpu = (rec, name, unit,
                                                            n, cpu)

    def __enter__(self) -> Span:
        self.span = self.rec.begin(self.name, self.unit, cpu=self.cpu)
        return self.span

    def __exit__(self, *exc):
        self.rec.end(self.span, n=self.n)
        return False


class StageTimer:
    """The records of one `recording()` block: `spans` in the order they
    ended.  Safe to use from several threads: each thread keeps its own
    stack of open spans, and a span is one atomic append."""

    def __init__(self):
        self.spans: list[Span] = []
        self._ids = itertools.count()
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def begin(self, name: str, unit=None, start_ns: int | None = None,
              cpu: bool = False) -> Span:
        """Open a span on this thread, at start_ns (a clock read the caller
        made) or now; cpu=True reads the thread's CPU clock too."""
        st = self._stack()
        sp = Span(next(self._ids), name, unit,
                  threading.current_thread().name,
                  st[-1].id if st else None,
                  time.time_ns() if start_ns is None else start_ns)
        # the CPU clock is read inside the wall clock's reads, so a span's
        # CPU time never exceeds its wall time
        if cpu:
            sp.cpu_ns = time.thread_time_ns()
        st.append(sp)
        return sp

    def end(self, sp: Span, end_ns: int | None = None, n: int = 1) -> None:
        """Close this thread's innermost span `sp`, at end_ns or now."""
        if sp.cpu_ns is not None:
            sp.cpu_ns = time.thread_time_ns() - sp.cpu_ns
        sp.end_ns = time.time_ns() if end_ns is None else end_ns
        sp.n = n
        st = self._stack()
        if not st or st[-1] is not sp:
            raise RuntimeError(f"span {sp.name!r} closed out of order")
        st.pop()
        self.spans.append(sp)

    def span(self, name: str, unit=None, n: int = 1, cpu: bool = False):
        """begin() on entry and end() on exit of a `with` block."""
        return _Open(self, name, unit, n, cpu)

    def add(self, name: str, start_ns: int, end_ns: int, unit=None,
            n: int = 1, cpu_ns: int | None = None) -> Span:
        """Record a span from the caller's own clock reads, a child of the
        innermost span open on this thread."""
        st = self._stack()
        sp = Span(next(self._ids), name, unit,
                  threading.current_thread().name,
                  st[-1].id if st else None, start_ns, end_ns, cpu_ns, n)
        self.spans.append(sp)
        return sp

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def summary(self) -> dict:
        """Per span name: seconds in all, the number of spans, mean ms."""
        tot: dict = defaultdict(int)
        cnt: dict = defaultdict(int)
        for s in self.spans:
            tot[s.name] += s.wall_ns
            cnt[s.name] += 1
        return {k: {"total_s": v / 1e9, "count": cnt[k],
                    "mean_ms": v / 1e6 / cnt[k]}
                for k, v in sorted(tot.items())}


@contextlib.contextmanager
def recording():
    """Record every site's spans inside the block; yields the
    StageTimer that holds them."""
    global ACTIVE
    prev, rec = ACTIVE, StageTimer()
    ACTIVE = rec
    try:
        yield rec
    finally:
        ACTIVE = prev


def span(name: str, unit=None, n: int = 1, cpu: bool = False):
    """A site's span: the recorder's, or a null one while nothing
    records."""
    rec = ACTIVE
    if rec is None:
        return _OFF
    return rec.span(name, unit, n, cpu)
