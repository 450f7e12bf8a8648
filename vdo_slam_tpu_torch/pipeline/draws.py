"""The random draws of one frame step.

The JAX step splits a PRNG key and draws in four places: the object
candidates' priority (vdo_slam_tpu/ops/frontend.py:85), the camera RANSAC
picks (solvers/ransac.py:164, via stages.py:194), the per-slot object
RANSAC picks (stages.py:384) and the renewal priority (stages.py:570).  Here
the step asks an object with those four methods, so the tracker can draw
from a seeded torch.Generator and a test can replay the JAX package's
draws exactly.
"""

from __future__ import annotations

from typing import Protocol

import torch

Tensor = torch.Tensor


class FrameDraws(Protocol):
    def object_priority(self, n: int) -> Tensor:
        """(n,) uniform [0, 1) priorities of the object sample sites."""

    def camera_picks(self, n_samples: int, n_valid: Tensor) -> Tensor:
        """(n_samples, 3) int64 in [0, n_valid), n_valid a 0-d tensor."""

    def object_picks(self, n_samples: int, n_valid: Tensor) -> Tensor:
        """(K, n_samples, 3) int64, row k in [0, n_valid[k])."""

    def renew_priority(self, n: int) -> Tensor:
        """(n,) uniform [0, 1) priorities of the renewal candidates."""


class TorchDraws:
    """FrameDraws from one torch.Generator on the step's device.  Picks are
    floor(u * n_valid) of uniform u, so no draw reads the device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def _uniform(self, shape) -> Tensor:
        return torch.rand(shape, generator=self.generator, device=self.device)

    def _picks(self, shape, n_valid: Tensor) -> Tensor:
        n = n_valid.reshape(n_valid.shape + (1,) * len(shape))
        u = self._uniform(n_valid.shape + tuple(shape))
        picks = (u * n.to(torch.float32)).to(torch.int64)
        return torch.minimum(picks, n - 1)

    def object_priority(self, n: int) -> Tensor:
        return self._uniform((n,))

    def camera_picks(self, n_samples: int, n_valid: Tensor) -> Tensor:
        return self._picks((n_samples, 3), n_valid)

    def object_picks(self, n_samples: int, n_valid: Tensor) -> Tensor:
        return self._picks((n_samples, 3), n_valid)

    def renew_priority(self, n: int) -> Tensor:
        return self._uniform((n,))
