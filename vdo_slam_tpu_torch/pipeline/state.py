"""Per-frame device state — port of vdo_slam_tpu/pipeline/state.py.

The flax.struct pytrees become plain dataclasses of tensors with the same
fields, shapes and dtypes (int32 labels and associations, as in the JAX
package; indexing code converts to int64 where torch wants it).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def _full(shape, value, dtype, device):
    return torch.full(shape, value, dtype=dtype, device=device)


@dataclasses.dataclass
class StaticBank:
    """Background features (capacity B = MaxTrackPointBG)."""

    xy: Tensor        # (B, 2) pixel positions in this frame
    depth: Tensor     # (B,)   metric depth at xy
    flow: Tensor      # (B, 2) measured flow this -> next frame
    corres: Tensor    # (B, 2) xy + flow
    point_w: Tensor   # (B, 3) world point
    assoc: Tensor     # (B,)   int32 index into the previous bank, -1 new
    valid: Tensor     # (B,)   slot occupancy

    @staticmethod
    def empty(B: int, device=None) -> "StaticBank":
        f32 = torch.float32
        return StaticBank(
            xy=_zeros((B, 2), f32, device), depth=_full((B,), -1.0, f32, device),
            flow=_zeros((B, 2), f32, device),
            corres=_zeros((B, 2), f32, device),
            point_w=_zeros((B, 3), f32, device),
            assoc=_full((B,), -1, torch.int32, device),
            valid=_zeros((B,), torch.bool, device),
        )


@dataclasses.dataclass
class DynamicBank:
    """Object features (capacity D)."""

    xy: Tensor         # (D, 2)
    depth: Tensor      # (D,)
    flow: Tensor       # (D, 2)
    corres: Tensor     # (D, 2)
    point_w: Tensor    # (D, 3)
    sem_label: Tensor  # (D,) int32 instance-segmentation label
    obj_label: Tensor  # (D,) int32: -2 new, -1 outlier, 0 static, >0 object
    assoc: Tensor      # (D,) int32 index into the previous bank, -1 new
    valid: Tensor      # (D,)

    @staticmethod
    def empty(D: int, device=None) -> "DynamicBank":
        f32, i32 = torch.float32, torch.int32
        return DynamicBank(
            xy=_zeros((D, 2), f32, device), depth=_full((D,), -1.0, f32, device),
            flow=_zeros((D, 2), f32, device),
            corres=_zeros((D, 2), f32, device),
            point_w=_zeros((D, 3), f32, device),
            sem_label=_zeros((D,), i32, device),
            obj_label=_full((D,), -2, i32, device),
            assoc=_full((D,), -1, i32, device),
            valid=_zeros((D,), torch.bool, device),
        )


@dataclasses.dataclass
class FrameState:
    """Everything the tracker carries frame to frame on the device."""

    static: StaticBank
    dynamic: DynamicBank
    T_cw: Tensor       # (4, 4) current world->camera estimate
    T_cw_gt: Tensor    # (4, 4) origin-normalized GT
    velocity: Tensor   # (4, 4) T_cw_cur @ T_wc_last
    seg: Tensor        # (H, W) int32 current (possibly repaired) masks
    flow_map: Tensor   # (H, W, 2) current forward flow
    depth_map: Tensor  # (H, W) current metric depth

    @staticmethod
    def empty(B: int, D: int, H: int, W: int, device=None) -> "FrameState":
        eye = torch.eye(4, dtype=torch.float32, device=device)
        return FrameState(
            static=StaticBank.empty(B, device),
            dynamic=DynamicBank.empty(D, device),
            T_cw=eye, T_cw_gt=eye.clone(), velocity=eye.clone(),
            seg=_zeros((H, W), torch.int32, device),
            flow_map=_zeros((H, W, 2), torch.float32, device),
            depth_map=_zeros((H, W), torch.float32, device),
        )


def field(obj, name: str):
    """A field by name, of a dict or of any object with attributes."""
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def to_tensor(x, device) -> Tensor:
    """A writable copy of an array on `device`."""
    return torch.from_numpy(np.array(x)).to(device)


def frame_state_from_numpy(tree, device) -> FrameState:
    """A FrameState from its fields by name (dict keys or attributes), as a
    state pulled to numpy holds them, the JAX package's included."""
    def build(obj, cls):
        return cls(**{f.name: (build(field(obj, f.name), _BANKS[f.name])
                               if f.name in _BANKS
                               else to_tensor(field(obj, f.name), device))
                      for f in dataclasses.fields(cls)})

    return build(tree, FrameState)


_BANKS = {"static": StaticBank, "dynamic": DynamicBank}
