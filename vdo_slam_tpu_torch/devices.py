"""The device lists of the multi-device paths: the edge-sharded full BA
(backend/full_ba.py, backend/factor_graph.py) and streams spread over
devices (parallel/multisystem.py, parallel/multistream.py).

The JAX package is single-controller: one process drives every device of
`jax.devices()`, and these paths take a `Mesh` of them.  The port keeps
that API and its semantics with one process that places shards and stream
groups on a list of `torch.device`s and adds each reduction's per-device
parts in a fixed order, rather than a process group (`torch.distributed`),
which would need a launcher and a rank on every call.  A list may repeat a
device: that is how one card (or the CPU) runs the multi-device code.
"""

from __future__ import annotations

import contextlib

import torch


def device_list(devices=None, device="cuda") -> list[torch.device]:
    """`devices` as torch devices, in order (a device may repeat).  None:
    every visible card where `device` is a CUDA device (as the JAX package
    takes jax.devices()), else [device].  An empty list raises."""
    if devices is None:
        device = torch.device(device)
        n = torch.cuda.device_count() if device.type == "cuda" else 0
        return ([torch.device("cuda", i) for i in range(n)] if n > 1
                else [device])
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("an empty device list")
    return devices


def on_device(device: torch.device):
    """A context in which `device` is torch's current CUDA device (nothing
    on the CPU): a group's step and its copies then take that card's
    current stream, whichever card was current before."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())
