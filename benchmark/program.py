"""Where the benchmark meets the program: the port's configuration built
from a configuration file, the frames handed to it, and its outputs read
back for the reference.  Only this module and benchmark/loads.py import the
port (`vdo_slam_tpu_torch`), through its public entry points.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PackedFrame:
    """A frame already on the wire: what the fused tracker stages (the
    port's PackedFrameData holds the same four fields)."""

    packed: np.ndarray       # (wire_len,) int16
    pose_gt_raw: np.ndarray  # (4, 4) float32 camera -> world
    obj_gt_rows: np.ndarray  # (k, 10) float32
    timestamp: float


def build_config(cfg_file: dict, log=None):
    """The port's VDOConfig from the "config" sections of a configuration
    file.  The file gives every field the program had when the file was
    written, so a default that changes later does not change the
    benchmark's configuration; a field the file does not know (one the
    program added since) takes the program's default and is logged, and
    a field the program does not know is refused."""
    from vdo_slam_tpu_torch import config as C

    sections = {"camera": C.CameraConfig, "frontend": C.FrontendConfig,
                "tracking": C.TrackingConfig, "solver": C.SolverConfig,
                "backend": C.BackendConfig, "shapes": C.ShapeConfig}
    given = cfg_file["config"]
    kw = {}
    for name, cls in sections.items():
        fields = {f.name for f in dataclasses.fields(cls)}
        vals = given[name]
        unknown = sorted(set(vals) - fields)
        if unknown:
            raise ValueError(f"configuration section {name!r}: the program "
                             f"has no field {unknown}")
        omitted = sorted(fields - set(vals))
        if omitted and log is not None:
            log(f"configuration section {name!r}: {omitted} not in the "
                f"file, the program's defaults taken")
        kw[name] = cls(**vals)
    return C.VDOConfig(seed=int(given["seed"]), **kw)


def outputs(sysm, n_frames: int) -> dict:
    """The program's answers for the reference, read from its map after
    the run: the camera->world poses as tracked and after the window
    solves' write-back ((F, 4, 4), NaN where a frame has none), and every
    object motion estimate as (frame, object index, 4x4 world motion).
    The window solves write back into `cam_pose`; `cam_pose_rf` keeps the
    tracked pose as archived, since no full BA runs.  The scene labels
    object k as k + 1."""
    m = sysm.map
    cam = np.full((n_frames, 4, 4), np.nan)
    ba = np.full((n_frames, 4, 4), np.nan)
    n = min(len(m.cam_pose), n_frames)
    if n:
        cam[:n] = np.stack([np.asarray(p, np.float64) for p in
                            m.cam_pose_rf[:n]])
        ba[:n] = np.stack([np.asarray(p, np.float64) for p in
                           m.cam_pose[:n]])
    ests = []
    for i, (mots, sems, stats) in enumerate(zip(m.rigid_motion,
                                                m.sem_label, m.obj_stat)):
        f = i + 1                # the archive's motions start at frame 1
        if f >= n_frames:
            break
        for H, sem, st in list(zip(mots, sems, stats))[1:]:
            if st and sem >= 1:
                ests.append((f, int(sem) - 1, np.asarray(H, np.float64)))
    return {"cam": cam, "cam_ba": ba, "obj": ests}
