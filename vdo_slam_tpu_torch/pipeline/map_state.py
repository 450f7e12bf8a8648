"""Copy of vdo_slam_tpu/pipeline/map_state.py, unchanged apart from this
line.

Host-side global map archive + tracklet extraction.

The functional equivalent of the reference Map (include/Map.h: append-only
per-frame std::vector archives, no pruning, no keyframes) plus the tracklet
builders Tracking::GetStaticTrack / GetDynamicTrackNew (Tracking.cc:
2201-2421).  Lives on host as numpy — it is bookkeeping, not compute; the
batch optimizer consumes it as padded index arrays.

Conventions (matching the reference exactly):
  * frame f arrays are the RENEWED feature banks of frame f (vpFeatSta[f]...)
  * assoc[f][j] (f>=1) = index into frame f-1's bank continuing as feature j
    of frame f's bank, or -1 (vnAssoSta/vnAssoDyn semantics)
  * rigid_motions[f] (f>=1) = [camera motion, object motions...] in world
    frame (vmRigidMotion), labels[f] = [0, model ids...] (vnRMLabel)
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class MapState:
    # static features per frame
    stat_xy: List[np.ndarray] = dataclasses.field(default_factory=list)
    stat_depth: List[np.ndarray] = dataclasses.field(default_factory=list)
    stat_3d: List[np.ndarray] = dataclasses.field(default_factory=list)
    stat_valid: List[np.ndarray] = dataclasses.field(default_factory=list)
    stat_assoc: List[np.ndarray] = dataclasses.field(default_factory=list)  # f>=1
    # dynamic features per frame
    dyn_xy: List[np.ndarray] = dataclasses.field(default_factory=list)
    dyn_depth: List[np.ndarray] = dataclasses.field(default_factory=list)
    dyn_3d: List[np.ndarray] = dataclasses.field(default_factory=list)
    dyn_valid: List[np.ndarray] = dataclasses.field(default_factory=list)
    dyn_assoc: List[np.ndarray] = dataclasses.field(default_factory=list)   # f>=1
    dyn_obj_label: List[np.ndarray] = dataclasses.field(default_factory=list)
    dyn_sem_label: List[np.ndarray] = dataclasses.field(default_factory=list)
    # camera poses (camera->world, vmCameraPose conventions)
    cam_pose: List[np.ndarray] = dataclasses.field(default_factory=list)
    cam_pose_rf: List[np.ndarray] = dataclasses.field(default_factory=list)
    cam_pose_gt: List[np.ndarray] = dataclasses.field(default_factory=list)
    # rigid motions per frame f>=1: index 0 = camera, then objects
    rigid_motion: List[List[np.ndarray]] = dataclasses.field(default_factory=list)
    rigid_motion_rf: List[List[np.ndarray]] = dataclasses.field(default_factory=list)
    rigid_motion_gt: List[List[np.ndarray]] = dataclasses.field(default_factory=list)
    obj_pose_pre: List[List[np.ndarray]] = dataclasses.field(default_factory=list)
    rm_label: List[List[int]] = dataclasses.field(default_factory=list)
    sem_label: List[List[int]] = dataclasses.field(default_factory=list)
    sm_label_gt: List[List[int]] = dataclasses.field(default_factory=list)
    obj_stat: List[List[bool]] = dataclasses.field(default_factory=list)
    speed_gt: List[List[float]] = dataclasses.field(default_factory=list)
    speed_est: List[List[float]] = dataclasses.field(default_factory=list)
    centres: List[List[np.ndarray]] = dataclasses.field(default_factory=list)
    # observability (SURVEY §5.1): per-frame stage timings + local BA times
    timings: List[np.ndarray] = dataclasses.field(default_factory=list)
    lba_times: List[float] = dataclasses.field(default_factory=list)
    # tracklets (built lazily)
    tracklets_static: list | None = None
    tracklets_dynamic: list | None = None
    tracklet_obj_id: list | None = None
    # full-BA graph snapshot for the g2o dump (Optimizer.cc:1935-1936):
    # set by full_ba_inplace, written by save_results
    g2o_dump: dict | None = None

    @property
    def num_frames(self) -> int:
        return len(self.cam_pose)


def build_tracklets(assoc: List[np.ndarray], valid: List[np.ndarray],
                    obj_label: List[np.ndarray] | None = None,
                    flat: bool = False):
    """Chain per-frame associations into tracklets.

    Equivalent to GetStaticTrack / GetDynamicTrackNew (Tracking.cc:2201-2421)
    but vectorized per frame: track ids propagate through assoc indices.

    assoc[f] (f=0..F-2) maps features of frame f+1 to indices of frame f
    (i.e. MapState.*_assoc[1:]).  Returns (tracklets, obj_ids):
    tracklets = list of [(frame, feat_idx), ...]; obj_ids = per-tracklet
    object label (first feature's label) or None for static.

    flat=True instead returns ((tids, frames, feats), obj_ids_array): the
    observation arrays sorted by (track, frame) — the zero-Python-loop form
    the full-graph builder consumes (a 100-frame KITTI archive has ~230k
    observations; per-track python lists cost seconds to build and walk).
    """
    F = len(assoc) + 1
    rec_tid: list[np.ndarray] = []
    rec_frame: list[np.ndarray] = []
    rec_feat: list[np.ndarray] = []
    new_tid_chunks: list[np.ndarray] = []
    new_lab_chunks: list[np.ndarray] = []
    tid_prev: np.ndarray | None = None
    next_tid = 0

    for f in range(F - 1):
        a = np.asarray(assoc[f])
        v = (np.asarray(valid[f + 1]) if valid is not None
             else np.ones_like(a, bool))
        has = (a >= 0) & v
        safe_a = np.where(has, a, 0)
        if f > 0 and tid_prev is not None:
            prev_tid = np.where(has, tid_prev[safe_a], -1)
        else:
            prev_tid = np.full(a.shape, -1, np.int64)
        cont = has & (prev_tid >= 0)
        new = has & (prev_tid < 0)
        new_ids = next_tid + np.cumsum(new) - 1
        tid_cur = np.where(cont, prev_tid, np.where(new, new_ids, -1))

        nj = np.nonzero(new)[0]
        if nj.size:
            ntids = tid_cur[nj]
            # each new track starts with its frame-f anchor then frame f+1
            rec_tid += [ntids, ntids]
            rec_frame += [np.full(nj.size, f), np.full(nj.size, f + 1)]
            rec_feat += [a[nj], nj]
            new_tid_chunks.append(ntids)
            if obj_label is not None:
                new_lab_chunks.append(np.asarray(obj_label[f + 1])[nj])
        cj = np.nonzero(cont)[0]
        if cj.size:
            rec_tid.append(tid_cur[cj])
            rec_frame.append(np.full(cj.size, f + 1))
            rec_feat.append(cj)
        next_tid += int(new.sum())
        tid_prev = tid_cur

    if not rec_tid:
        if flat:
            e = np.zeros(0, np.int64)
            return (e, e, e), (e if obj_label is not None else None)
        return [], ([] if obj_label is not None else None)
    tids = np.concatenate(rec_tid)
    frames = np.concatenate(rec_frame)
    feats = np.concatenate(rec_feat)
    order = np.lexsort((frames, tids))
    tids, frames, feats = tids[order], frames[order], feats[order]
    obj_arr = None
    if obj_label is not None:
        labs = np.concatenate(new_lab_chunks) if new_lab_chunks else np.zeros(0)
        key = np.concatenate(new_tid_chunks) if new_tid_chunks else np.zeros(0)
        obj_arr = np.zeros(next_tid, np.int64)
        obj_arr[key.astype(int)] = labs.astype(int)
    if flat:
        return (tids, frames, feats), obj_arr
    # split into per-track lists
    boundaries = np.nonzero(np.diff(tids))[0] + 1
    fsplit = np.split(frames, boundaries)
    jsplit = np.split(feats, boundaries)
    tracks = [list(zip(fs.tolist(), js.tolist()))
              for fs, js in zip(fsplit, jsplit)]
    obj_ids = obj_arr.tolist() if obj_arr is not None else None
    return tracks, obj_ids


def track_length_histogram(tracks: list, max_frames: int) -> np.ndarray:
    """Tracklet-length distribution (written to track_distribution*.txt by the
    reference, Tracking.cc:2293-2304)."""
    hist = np.zeros(max_frames + 1, np.int64)
    for t in tracks:
        hist[min(len(t), max_frames)] += 1
    return hist


def object_track_time(rm_label: List[List[int]], sem_label: List[List[int]],
                      sm_label_gt: List[List[int]], max_id: int):
    """Per-object tracking counts (GetObjTrackTime, Tracking.cc:2423-2495).

    Returns (track_count, track_count_gt, semantic_label) arrays of length
    max_id-1 (per unique motion label).
    """
    track_count = np.zeros(max(max_id - 1, 0), np.int64)
    track_count_gt = np.zeros_like(track_count)
    semantic = np.zeros_like(track_count)
    for frame_labels, frame_sems in zip(rm_label, sem_label):
        for lab, sem in zip(frame_labels[1:], frame_sems[1:]):
            if 1 <= lab <= len(track_count):
                track_count[lab - 1] += 1
                semantic[lab - 1] = sem
    for gts in sm_label_gt:
        for g in gts:
            hits = np.nonzero(semantic == g)[0]
            if hits.size:
                track_count_gt[hits[0]] += 1
    return track_count, track_count_gt, semantic
