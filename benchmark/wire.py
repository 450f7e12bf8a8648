"""A frozen PyTorch copy of the port's host packer for the lossless entropy
wire (`io/packing.py:pack_frame` with flow_down 2, flow_delta and entropy
on: KITTI's tpu_fast wire), run on the device over a block of frames.

The port's pack_frame is numpy on the host; packing a 1242x375 drive of
more than a thousand frames there would be most of a run's set-up.  This
copy gives the same int16 buffers (benchmark/tests/test_bench_wire.py holds
it to pack_frame byte for byte), so the program receives exactly what its
own packer would have made.  It is frozen here, apart from the program, so
that a change to the program's packer cannot move the benchmark's inputs.
"""

from __future__ import annotations

import torch


def _as_i16(x: torch.Tensor) -> torch.Tensor:
    """Integers in [0, 65535] (any int dtype) as the int16 of the same 16
    bits."""
    x = x.to(torch.int32) & 0xFFFF
    return torch.where(x >= 32768, x - 65536, x).to(torch.int16)


def _u8_pairs(a: torch.Tensor) -> torch.Tensor:
    """(B, n) values in [0, 255] -> (B, ceil(n / 2)) int16, two per lane."""
    a = a.to(torch.int32)
    if a.shape[1] % 2:
        a = torch.cat([a, a[:, -1:]], dim=1)
    return _as_i16(a[:, 0::2] | (a[:, 1::2] << 8))


def _row_delta(a: torch.Tensor) -> torch.Tensor:
    """Row-wise bit-pattern delta, mod 2^16, of (B, h, w) int16 planes."""
    u = a.to(torch.int32) & 0xFFFF
    d = u.clone()
    d[..., 1:] = u[..., 1:] - u[..., :-1]
    return _as_i16(d)


def _sparse(big: torch.Tensor, val: torch.Tensor, cap: int, what: str):
    """(B, cap) int64 indices and values of the True entries of `big`, in
    raveled order, padded with (0, 0); more than cap entries raise."""
    n = big.sum(dim=1)
    worst = int(n.max()) if n.numel() else 0
    if worst > cap:
        raise ValueError(f"entropy wire: a frame needs {worst} {what} "
                         f"entries > cap {cap}")
    B = big.shape[0]
    idx = torch.zeros(B, cap, dtype=torch.int64, device=big.device)
    out = torch.zeros_like(idx)
    b, j = big.nonzero(as_tuple=True)
    rank = (torch.cumsum(big.to(torch.int64), dim=1) - 1)[b, j]
    idx[b, rank] = j
    out[b, rank] = val[b, j]
    return idx, out


def _planes(idx: torch.Tensor, val: torch.Tensor) -> list[torch.Tensor]:
    return [_as_i16(idx & 0xFFFF), _as_i16((idx >> 16) & 0xFFFF),
            _as_i16(val & 0xFFFF), _as_i16((val >> 16) & 0xFFFF)]


def _diff0(v: torch.Tensor) -> torch.Tensor:
    """(B, n) int64 -> differences with a leading 0 (np.diff of [0, v])."""
    return torch.diff(v, dim=1, prepend=torch.zeros_like(v[:, :1]))


def pack_entropy(gray: torch.Tensor, depth_raw: torch.Tensor,
                 flow: torch.Tensor, seg: torch.Tensor, depth_scale: float,
                 seg_cap: int, depth_exc_cap: int) -> torch.Tensor:
    """(B, H, W) gray in [0, 1], raw depth, (B, H, W, 2) flow and integer
    labels -> (B, wire_len) int16: pack_frame(..., flow_down=2,
    flow_delta=True, entropy=True) of each frame."""
    B = gray.shape[0]
    g8 = torch.clamp(torch.round(gray * 255.0), 0, 255).to(torch.int32)
    s8 = torch.clamp(seg, 0, 255).to(torch.int64)
    d16 = torch.clamp(torch.round(depth_raw * depth_scale), 0,
                      65535).to(torch.int64)
    dd = _diff0(d16.reshape(B, -1))
    big = dd.abs() > 127
    dep_idx, dep_exc = _sparse(big, dd, depth_exc_cap, "depth_exc")
    dep_i8 = torch.where(big, 0, dd) & 0xFF
    sd = _diff0(s8.reshape(B, -1))
    tr_idx, tr_val = _sparse(sd != 0, sd, seg_cap, "seg transition")
    fh = flow[:, 0::2, 0::2].to(torch.float16).view(torch.int16)
    parts = [_u8_pairs(g8.reshape(B, -1)), _u8_pairs(dep_i8),
             _row_delta(fh[..., 0]).reshape(B, -1),
             _row_delta(fh[..., 1]).reshape(B, -1)]
    parts += _planes(dep_idx, dep_exc)
    parts += _planes(tr_idx, tr_val)
    return torch.cat(parts, dim=1)
