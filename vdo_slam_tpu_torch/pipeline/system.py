"""Public API — port of vdo_slam_tpu/pipeline/system.py, mode "fused":

    sys = System(cfg, enable_local_ba=False, enable_global_ba=False,
                 mode="fused")        # on "cuda" unless device="cpu"
    sys.run_sequence(dataset)          # or sys.track_rgbd(frame) per frame
    sys.metrics(); sys.timing(); sys.save_results(out_dir)

The defaults are the JAX package's, so the same call means the same run in
both packages or raises here: window BA, full BA, mode "reference" and the
configurations `check_slice` names are not ported and raise
NotImplementedError.
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
        if enable_local_ba:
            raise NotImplementedError(
                "enable_local_ba=True: window BA (backend/window_ba.py) is "
                "not ported; pass enable_local_ba=False")
        if enable_global_ba:
            raise NotImplementedError(
                "enable_global_ba=True: full BA (backend/full_ba.py) is not "
                "ported; pass enable_global_ba=False")
        check_slice(cfg)
        from .fused import FusedTracker  # imports parallel/, which imports us

        self.cfg = cfg
        self.map = MapState()
        self.tracker = FusedTracker(cfg, self.map, device=device)

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
