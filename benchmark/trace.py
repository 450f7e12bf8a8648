"""The device trace of a stretch of a run's measured window:
torch.profiler's CUDA activity (kernels, copies, fills, and the CUDA
runtime calls the host made), reduced to intervals that the per-layer
readers and the breakdown read.

The stretch lies inside the one call that the window times (a drive's
run_sequence, the streams' MultiStreamSystem.run): `WindowTrace` is told of each frame as the program's reader fetches it,
starts the profiler some frames before the stretch, marks the stretch's
ends on the host clock, and stops the profiler once the call has
returned, with no synchronisation, so the stretch sees the drive as it
runs.  Everything is read over the stretch alone, each operation clipped
to it.

Only CUDA activity is recorded: with the host's operators recorded too,
a stretch of ~10^5 kernels takes a minute to trace and read.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field


@dataclass
class Trace:
    """Device operations as (name, start_ns, end_ns, stream), host runtime
    calls as (name, start_ns, end_ns), and the traced stretch's ends on
    the same clock (the profiler's and time.time_ns, the Unix epoch)."""

    ops: list = field(default_factory=list)
    calls: list = field(default_factory=list)
    t0_ns: int = 0
    t1_ns: int = 0

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def clipped(self) -> list:
        """The operations that overlap the stretch, clipped to it."""
        out = []
        for name, s, e, st in self.ops:
            s, e = max(s, self.t0_ns), min(e, self.t1_ns)
            if e > s:
                out.append((name, s, e, st))
        return out

    def kernels(self, whole: bool = False) -> list:
        """The kernels in the stretch: clipped to it, or with whole=True
        only those that start and end inside it, unclipped."""
        ops = ([o for o in self.ops
                if o[1] >= self.t0_ns and o[2] <= self.t1_ns]
               if whole else self.clipped())
        return [o for o in ops if not o[0].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self) -> list:
        """The union of every device operation's interval, clipped to the
        stretch, as sorted disjoint (start_ns, end_ns)."""
        out: list = []
        for _, s, e, _ in sorted(self.clipped(), key=lambda o: o[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_gaps(self) -> list:
        """(start_ns, end_ns) of every part of the stretch in which no
        device operation ran."""
        gaps, t = [], self.t0_ns
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.t1_ns > t:
            gaps.append((t, self.t1_ns))
        return gaps

    def main_stream(self):
        """The stream that ran the most kernels: the tracker's step."""
        count: dict = {}
        for _, _, _, st in self.kernels():
            count[st] = count.get(st, 0) + 1
        return max(count, key=count.get) if count else None

    def host_at(self, t_ns: int) -> str:
        """What the host was doing at t_ns: the runtime call that covered
        it (the one that started last), else the call that ended last
        before it."""
        starts = [c[1] for c in self.calls]
        i = bisect.bisect_right(starts, t_ns)
        for name, s, e in reversed(self.calls[max(0, i - 64):i]):
            if e >= t_ns:
                return f"in {name}"
        if i:
            return f"after {self.calls[i - 1][0]}"
        return "before the first runtime call"


def _cuda_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


class WindowTrace:
    """Traces frames first .. first + n - 1 of a sequence from inside the
    call that runs it.  `fetched(i)` is called as the program's reader
    fetches frame i.  At frame first - lead the profiler is started on a
    thread of its own (its start-up stalls the reader there, before the
    stretch, and nothing inside it); the stretch runs from the fetch of
    frame `first` to that of frame first + n; `result()`, called once the
    sequence has ended, stops the profiler on the same thread, so that
    reading out its hundreds of thousands of records stalls nothing the
    program runs, and returns the Trace.  `on_start()`, where given, is
    called at frame first - lead, before the profiler starts."""

    profile_factory = staticmethod(_cuda_profile)

    def __init__(self, first: int, n: int, lead: int = 16,
                 on_start=None):
        import threading

        self.first, self.n = first, n
        self.start_at = max(first - lead, 0)
        self.on_start = on_start
        self.t0_ns = self.t1_ns = None
        self._prof = None
        self._go = threading.Event()
        self._running = threading.Event()
        self._halt = threading.Event()
        self._thread = threading.Thread(target=self._hold, daemon=True)
        self._thread.start()

    def _hold(self) -> None:
        self._go.wait()
        if not self._halt.is_set():
            self._prof = self.profile_factory()
            self._prof.start()
        self._running.set()
        self._halt.wait()
        if self._prof is not None:
            self._prof.stop()

    def fetched(self, i: int) -> None:
        if i == self.start_at:
            if self.on_start is not None:
                self.on_start()
            self._go.set()
        if i == self.first:
            self._running.wait()
            self.t0_ns = time.time_ns()
        if i == self.first + self.n:
            self.t1_ns = time.time_ns()

    def result(self) -> Trace:
        self._halt.set()
        self._go.set()
        self._thread.join()
        if self.t0_ns is None or self._prof is None:
            raise RuntimeError("the sequence ended before the traced "
                               "stretch began")
        if self.t1_ns is None:
            self.t1_ns = time.time_ns()
        tr = Trace(t0_ns=self.t0_ns, t1_ns=self.t1_ns)
        read_events(self._prof, tr)
        return tr


def read_events(prof, tr: Trace) -> None:
    """The profiler's device operations and CUDA runtime calls into tr."""
    from torch.autograd import DeviceType

    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            tr.ops.append((ev.name(), s, e, ev.device_resource_id()))
        elif ev.name().startswith("cuda"):
            tr.calls.append((ev.name(), s, e))
    tr.ops.sort(key=lambda o: o[1])
    tr.calls.sort(key=lambda c: c[1])


def breakdown(tr: Trace, n: int = 10) -> dict:
    """The device operations that took most time in the stretch, summed by
    name, and its longest idle gaps, each named by what the host was
    doing."""
    by: dict = {}
    for name, s, e, _ in tr.clipped():
        by[name] = by.get(name, 0) + (e - s)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(tr.idle_gaps(), key=lambda g: g[0] - g[1])[:n]
    return {"device_ops": [[k[:200], v / 1e9] for k, v in ops],
            "idle_gaps": [[tr.host_at(s), (e - s) / 1e9] for s, e in gaps]}
