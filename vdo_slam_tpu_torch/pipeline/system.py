"""Public API — port of vdo_slam_tpu/pipeline/system.py:

    sys = System(cfg_or_settings_yaml)  # mode="reference", on "cuda"
                                        # unless device="cpu"
    sys.run_sequence(dataset)           # tracking, window BA, then full BA
    sys.metrics(); sys.metrics(refined=True); sys.save_results(out_dir)

The defaults are the JAX package's, so the same call means the same run in
both packages.  mode "reference" (the default) drives the host-orchestrated
Tracker of pipeline/tracking.py, one frame per call; mode "fused" drives
the FusedTracker (one device step per frame, frames or an
InMemoryPackedDataset / PackedDataset of wire buffers, chunks).  With
enable_local_ba the tracker runs a window solve every WINDOW_SIZE -
OVERLAP_SIZE frames: in mode "reference" at once on the tracking thread,
in mode "fused" on the tracker's background solve thread, which the
tracker's flush joins (at the end of run_sequence, and before metrics(),
timing() and save_results() read the map), as in the JAX package.  With
enable_global_ba, run_sequence ends with the full-batch solve, after the
window solves, and keeps its report in `full_ba_report`.  On a card the
window solves run from CUDA graphs (backend/window_ba.py:WindowGraphs),
one per shape tier, warmed and captured when the System is made
(`warmup_window_ba`), before tracking starts.  The full BA runs from the
System's `full_graphs` (backend/full_ba.py:FullBAGraphs, over the device
list the solve takes; None over distinct cards, whose sharded solve runs
eagerly), which the System does not warm, as the JAX package's System
does not: without the full_* caps the full graph's shapes vary from run
to run, so a run's one full BA
is its graphs' warm-up (a key's second chunk captures, later ones
replay); a caller that knows the caps warms them first
(`warmup_full_ba`, as the bench does).
"""

from __future__ import annotations

import itertools
from pathlib import Path

from ..config import VDOConfig, load_settings
from ..eval import results as results_mod
from ..io.dataset import FrameData
from ..io.prefetch import ThreadedPrefetcher
from ..utils import profiling
from .map_state import MapState
from .tracking import Tracker


class _Limit:
    """The first k items of a dataset."""

    def __init__(self, base, k: int):
        self.base, self.k = base, k

    def __len__(self):
        return self.k

    def __getitem__(self, i):
        return self.base[i]


class System:
    def __init__(self, cfg: VDOConfig | str | Path, enable_local_ba: bool = True,
                 enable_global_ba: bool = True, mode: str = "reference",
                 device="cuda"):
        """mode: 'reference' = host-orchestrated stage-by-stage tracking
        with the reference's bookkeeping; 'fused' = the whole frame in one
        device step (device-side classifier)."""
        if not isinstance(cfg, VDOConfig):
            cfg = load_settings(cfg)
        # imported here: parallel/ and backend/ import pipeline/
        from ..backend.full_ba import graphs_for
        from ..backend.window_ba import (WindowGraphs, local_ba_inplace,
                                         warmup_window_ba)
        from .fused import FusedTracker

        self.cfg = cfg
        self.map = MapState()
        if mode == "fused":
            self.tracker = FusedTracker(cfg, self.map, device=device)
        else:
            self.tracker = Tracker(cfg, self.map, device=device)
        self.enable_global_ba = enable_global_ba
        self.full_ba_report: dict | None = None
        self.window_graphs: WindowGraphs | None = None
        self.full_graphs = (graphs_for(self.tracker.device)
                            if enable_global_ba else None)
        if enable_local_ba:
            dev = self.tracker.device
            graphs = self.window_graphs = WindowGraphs(dev)
            if dev.type == "cuda":
                warmup_window_ba(cfg, graphs)
            self.tracker.local_ba_hook = (
                lambda m, n_frames=None: local_ba_inplace(
                    m, cfg, n_frames=n_frames, device=dev, graphs=graphs))

    def track_rgbd(self, fd: FrameData) -> dict:
        """Feed one frame.  Mode "reference" returns its report; mode
        "fused" the report of the frame before it (that tracker archives
        one frame behind, see pipeline/fused.py)."""
        return self.tracker.grab_frame(fd)

    def run_sequence(self, dataset, max_frames: int | None = None,
                     verbose: bool = False) -> list[dict]:
        """Demo loop (example/vdo_slam.cc:98-141).

        Frames are read ahead on a background thread (io/prefetch.py) and
        the next frame's or chunk's upload is queued right behind the
        current step.  With fused_chunk = C > 1 and at least C frames, the
        chunked drive: C frames per tracker call, then a tail of n mod C
        frames as ONE chunk padded by repeating its last frame, of which
        only the real frames are archived.  The JAX package stages the
        next chunk from a dedicated uploader thread, because there an
        upload made by the dispatching thread waits for the running
        program; a pinned non_blocking copy does not, so here the same
        thread stages it."""
        n = len(dataset) if max_frames is None else min(len(dataset),
                                                        max_frames)
        tracker = self.tracker
        if isinstance(tracker, Tracker):
            reports = self._drive_reference(dataset, n, verbose)
            self._full_ba()
            return reports
        reports: list[dict] = []

        def show(rep):
            if rep is None or rep.get("pipelining"):
                return
            if verbose:
                print(f"frame {rep['frame_id']}: rpe t={rep['t_rpe']:.4f} "
                      f"r={rep['r_rpe']:.4f} inliers={rep['n_inlier_cam']}")
            reports.append(rep)

        if n:
            pf = ThreadedPrefetcher(_Limit(dataset, n))
            it = iter(pf)
            try:
                if tracker.chunk > 1 and n >= tracker.chunk:
                    self._drive_chunks(it, show)
                else:
                    self._drive_frames(it, n, show)
            finally:
                pf.close()
        final = tracker.flush()
        for rep in ([final] if isinstance(final, dict) else (final or [])):
            show(rep)
        self._full_ba()
        return reports

    def _full_ba(self) -> None:
        """Final-frame global refinement (Tracking.cc:1190-1208, KITTI only
        in the reference; here gated by enable_global_ba)."""
        if self.enable_global_ba and self.map.num_frames > 2:
            from ..backend.full_ba import full_ba_inplace

            self.full_ba_report = full_ba_inplace(
                self.map, self.cfg, device=self.tracker.device,
                graphs=self.full_graphs)

    def _drive_reference(self, dataset, n: int, verbose: bool) -> list[dict]:
        """The host Tracker's loop (system.py:193-201): one frame per
        call, each report returned as its frame is tracked."""
        reports = []
        for i in range(n):
            rep = self.track_rgbd(dataset[i])
            if verbose and "t_rpe" in rep:
                objs = [(o["model_label"], round(o["speed"], 1))
                        for o in rep["objects"] if o["status"]]
                print(f"frame {i}: rpe t={rep['t_rpe']:.4f} "
                      f"r={rep['r_rpe']:.4f} inliers={rep['n_inlier_cam']} "
                      f"objs={objs}")
            reports.append(rep)
        return reports

    def _drive_chunks(self, it, show) -> None:
        """The chunked drive (system.py:85-141)."""
        tracker = self.tracker
        C = tracker.chunk

        def take():
            # waiting on the prefetcher for the next chunk
            with profiling.span("drive.input_wait", tracker.frame_id, n=C):
                return list(itertools.islice(it, C))

        fds = take()
        staged = tracker.device_inputs_chunk(fds)
        while staged is not None:
            reps = tracker.grab_chunk(fds, staged)
            # the next chunk's upload queues behind the steps just queued
            fds = take()
            staged = (tracker.device_inputs_chunk(fds) if len(fds) == C
                      else None)
            for rep in reps:
                show(rep)
        # ordered drain before the tail
        for rep in tracker._drain_pending_chunk():
            show(rep)
        if fds:
            pad = fds + [fds[-1]] * (C - len(fds))
            for rep in tracker.grab_chunk(pad, n_real=len(fds)):
                show(rep)

    def _drive_frames(self, it, n: int, show) -> None:
        """The staged single-frame drive (system.py:155-192)."""
        tracker = self.tracker

        def take():
            # waiting on the prefetcher for the next frame
            with profiling.span("drive.input_wait", tracker.frame_id):
                return next(it, None)

        fd = take()
        staged = tracker.device_inputs(fd)
        for _ in range(n):
            rep = tracker.grab_frame(fd, staged)
            fd = take()
            staged = tracker.device_inputs(fd) if fd is not None else None
            show(rep)

    def _flush(self) -> None:
        if hasattr(self.tracker, "flush"):
            self.tracker.flush()

    def metrics(self, refined: bool = False) -> dict:
        self._flush()
        return results_mod.metric_report(self.map, refined=refined)

    def timing(self) -> dict:
        self._flush()
        return results_mod.timing_summary(self.map)

    def save_results(self, out_dir: str | Path) -> None:
        self._flush()
        results_mod.save_results(self.map, out_dir)
