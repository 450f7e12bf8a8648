"""Public API — port of vdo_slam_tpu/pipeline/system.py, mode "fused":

    sys = System(cfg, enable_local_ba=True, enable_global_ba=True,
                 mode="fused")        # on "cuda" unless device="cpu"
    sys.run_sequence(dataset)          # tracking, window BA, then full BA
    sys.metrics(); sys.metrics(refined=True); sys.save_results(out_dir)

The defaults are the JAX package's, so the same call means the same run in
both packages or raises here: mode "reference" and the configurations
`check_slice` names are not ported and raise NotImplementedError.  With
enable_local_ba the tracker runs a window solve every WINDOW_SIZE -
OVERLAP_SIZE frames; with enable_global_ba, run_sequence ends with the
full-batch solve, whose report it keeps in `full_ba_report`.
"""

from __future__ import annotations

from pathlib import Path

from ..config import VDOConfig, load_settings
from ..eval import results as results_mod
from ..io.dataset import FrameData
from .map_state import MapState
from .stages import check_slice


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
        """Demo-driver loop (example/vdo_slam.cc:98-141)."""
        n = len(dataset) if max_frames is None else min(len(dataset),
                                                        max_frames)
        reports = []
        for i in range(n):
            reports.append(self.track_rgbd(dataset[i]))
        reports.append(self.tracker.flush())
        reports = [r for r in reports if r is not None
                   and not r.get("pipelining")]
        # final-frame global refinement (Tracking.cc:1190-1208)
        if self.enable_global_ba and self.map.num_frames > 2:
            from ..backend.full_ba import full_ba_inplace

            self.full_ba_report = full_ba_inplace(self.map, self.cfg,
                                                  device=self.tracker.device)
        if verbose:
            for rep in reports:
                print(f"frame {rep['frame_id']}: rpe t={rep['t_rpe']:.4f} "
                      f"r={rep['r_rpe']:.4f} inliers={rep['n_inlier_cam']}")
        return reports

    def metrics(self, refined: bool = False) -> dict:
        self.tracker.flush()
        return results_mod.metric_report(self.map, refined=refined)

    def timing(self) -> dict:
        self.tracker.flush()
        return results_mod.timing_summary(self.map)

    def save_results(self, out_dir: str | Path) -> None:
        self.tracker.flush()
        results_mod.save_results(self.map, out_dir)
