"""Checkpoint / resume of a tracking session — port of
vdo_slam_tpu/utils/checkpoint.py.

The payload holds only numpy arrays, plain containers and the port's
MapState: the device state is pulled to numpy, field by field.  A frame's
random draws depend on (cfg.seed, frame index) alone (pipeline/draws.py),
so no generator state is saved: a resumed tracker draws what the
uninterrupted one would have.

`tracker_from_numpy` builds a host Tracker from such a payload, and also
from the JAX package's Tracker state pulled to numpy (the same names: its
FrameState fields, the label mirrors, the tracks, the counters), which is
how a session is carried from one package to the other.
"""

from __future__ import annotations

import copy
import dataclasses
import pickle
from pathlib import Path

import numpy as np
import torch

from ..pipeline.state import field, frame_state_from_numpy, to_tensor
from ..pipeline.tracking import ObjectTrack, Tracker


def _to_numpy(obj):
    """A state dataclass of tensors -> nested dict of numpy arrays."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    return {f.name: _to_numpy(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _tensor(x, device):
    return None if x is None else to_tensor(x, device)


def _restore(tracker: Tracker, payload: dict) -> Tracker:
    dev = tracker.device
    tracker.frame_id = int(payload["frame_id"])
    tracker.max_id = int(payload["max_id"])
    origin = payload["origin_inv"]
    tracker.origin_inv = (None if origin is None
                          else np.asarray(origin, np.float32))
    st = payload["state"]
    tracker.state = None if st is None else frame_state_from_numpy(st, dev)
    tracker._T_cw_gt_host = (np.eye(4, dtype=np.float32) if st is None else
                             np.array(field(st, "T_cw_gt"), np.float32))
    last_sem = payload["last_sem"]
    tracker._last_sem = None if last_sem is None else np.array(last_sem)
    tracker._last_obj_rows = np.asarray(payload["last_obj_rows"], np.float32)
    tracker._last_seg = _tensor(payload["last_seg"], dev)
    tracker._last_flow = _tensor(payload["last_flow"], dev)
    tracker._last_tracks = []
    for model, sem, H, active in payload["tracks"]:
        t = ObjectTrack(int(model), int(sem), np.asarray(H, np.float32))
        t.active = bool(active)
        tracker._last_tracks.append(t)
    if payload.get("map") is not None:
        tracker.map.__dict__.update(copy.deepcopy(vars(payload["map"])))
    return tracker


def tracker_from_numpy(payload: dict, cfg, device="cuda") -> Tracker:
    """A host Tracker on `device` in the state `payload` holds: keys
    frame_id, max_id, origin_inv, state (the FrameState fields by name),
    last_sem, last_obj_rows, last_seg, last_flow, tracks ((model_label,
    sem_label, H, active) each) and, optionally, map."""
    return _restore(Tracker(cfg, device=device), payload)


def save_checkpoint(tracker: Tracker, path: str | Path) -> None:
    payload = {
        "version": 1,
        "kind": "reference",
        "frame_id": tracker.frame_id,
        "max_id": tracker.max_id,
        "origin_inv": tracker.origin_inv,
        "state": (_to_numpy(tracker.state) if tracker.state is not None
                  else None),
        "last_sem": tracker._last_sem,
        "last_obj_rows": tracker._last_obj_rows,
        "last_seg": (_to_numpy(tracker._last_seg)
                     if tracker._last_seg is not None else None),
        "last_flow": (_to_numpy(tracker._last_flow)
                      if tracker._last_flow is not None else None),
        "tracks": [(t.model_label, t.sem_label, np.asarray(t.H), t.active)
                   for t in tracker._last_tracks],
        "map": tracker.map,
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_checkpoint(tracker: Tracker, path: str | Path) -> Tracker:
    """Restore a Tracker in place (its config must match the saved one)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return _restore(tracker, payload)


def save_fused_checkpoint(tracker, path: str | Path) -> None:
    """Checkpoint of a FusedTracker: its device state, its host
    bookkeeping and the archive, after draining the frames in flight."""
    tracker.flush()
    state = _to_numpy(tracker.state)
    state["initialized"] = tracker.initialized
    payload = {
        "version": 1,
        "kind": "fused",
        "frame_id": tracker.frame_id,
        "origin_inv": tracker.origin_inv,
        "state": state,
        "last_obj_rows": tracker._last_obj_rows,
        "last_T_wc_gt": tracker._last_T_wc_gt,
        "stage_last_sems": tracker._stage_last_sems,
        "map": tracker.map,
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_fused_checkpoint(tracker, path: str | Path):
    from ..parallel.multistream import state_from_numpy

    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("kind") != "fused":
        raise ValueError(f"{path}: not a fused-tracker checkpoint")
    tracker.state, tracker.initialized = state_from_numpy(payload["state"],
                                                          tracker.device)
    tracker.frame_id = payload["frame_id"]
    tracker.origin_inv = payload["origin_inv"]
    tracker._last_obj_rows = payload["last_obj_rows"]
    tracker._last_T_wc_gt = payload["last_T_wc_gt"]
    tracker._stage_last_sems = payload["stage_last_sems"]
    tracker.map.__dict__.update(copy.deepcopy(vars(payload["map"])))
    return tracker
