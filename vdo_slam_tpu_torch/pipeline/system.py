"""Public API — port of vdo_slam_tpu/pipeline/system.py, mode "fused":

    sys = System(cfg, enable_local_ba=True, enable_global_ba=True,
                 mode="fused")        # on "cuda" unless device="cpu"
    sys.run_sequence(dataset)          # tracking, window BA, then full BA
                                       # (frames, or an InMemoryPackedDataset
                                       # / PackedDataset of wire buffers)
    sys.metrics(); sys.metrics(refined=True); sys.save_results(out_dir)

The defaults are the JAX package's, so the same call means the same run in
both packages or raises here: mode "reference" and the configurations
`check_slice` names are not ported and raise NotImplementedError.  With
enable_local_ba the tracker runs a window solve every WINDOW_SIZE -
OVERLAP_SIZE frames; with enable_global_ba, run_sequence ends with the
full-batch solve, whose report it keeps in `full_ba_report`.
"""

from __future__ import annotations

import itertools
from pathlib import Path

from ..config import VDOConfig, load_settings
from ..eval import results as results_mod
from ..io.dataset import FrameData
from ..io.prefetch import ThreadedPrefetcher
from .map_state import MapState
from .stages import check_slice


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
        if not isinstance(cfg, VDOConfig):
            cfg = load_settings(cfg)
        if mode != "fused":
            raise NotImplementedError(
                f"mode={mode!r}: only mode='fused' is ported (the host "
                f"Tracker of pipeline/tracking.py is not)")
        check_slice(cfg)
        # imported here: parallel/ and backend/ import pipeline/
        from ..backend.window_ba import local_ba_inplace
        from .fused import FusedTracker

        self.cfg = cfg
        self.map = MapState()
        self.tracker = FusedTracker(cfg, self.map, device=device)
        self.enable_global_ba = enable_global_ba
        self.full_ba_report: dict | None = None
        if enable_local_ba:
            dev = self.tracker.device
            self.tracker.local_ba_hook = (
                lambda m, n_frames=None: local_ba_inplace(
                    m, cfg, n_frames=n_frames, device=dev))

    def track_rgbd(self, fd: FrameData) -> dict:
        """Feed one frame; returns the report of the frame before it (the
        tracker archives one frame behind, see pipeline/fused.py)."""
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
        reports: list[dict] = []
        tracker = self.tracker

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
        # final-frame global refinement (Tracking.cc:1190-1208)
        if self.enable_global_ba and self.map.num_frames > 2:
            from ..backend.full_ba import full_ba_inplace

            self.full_ba_report = full_ba_inplace(self.map, self.cfg,
                                                  device=tracker.device)
        return reports

    def _drive_chunks(self, it, show) -> None:
        """The chunked drive (system.py:85-141)."""
        tracker = self.tracker
        C = tracker.chunk
        fds = list(itertools.islice(it, C))
        staged = tracker.device_inputs_chunk(fds)
        while staged is not None:
            reps = tracker.grab_chunk(fds, staged)
            # the next chunk's upload queues behind the steps just queued
            fds = list(itertools.islice(it, C))
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
        fd = next(it)
        staged = tracker.device_inputs(fd)
        for _ in range(n):
            rep = tracker.grab_frame(fd, staged)
            fd = next(it, None)
            staged = tracker.device_inputs(fd) if fd is not None else None
            show(rep)

    def metrics(self, refined: bool = False) -> dict:
        self.tracker.flush()
        return results_mod.metric_report(self.map, refined=refined)

    def timing(self) -> dict:
        self.tracker.flush()
        return results_mod.timing_summary(self.map)

    def save_results(self, out_dir: str | Path) -> None:
        self.tracker.flush()
        results_mod.save_results(self.map, out_dir)
