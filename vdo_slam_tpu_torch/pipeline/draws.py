"""The random draws of one frame step.

The JAX step splits a PRNG key and draws in four places: the object
candidates' priority (vdo_slam_tpu/ops/frontend.py:85), the camera RANSAC
picks (solvers/ransac.py:164, via stages.py:194), the per-slot object
RANSAC picks (stages.py:384) and the renewal priority (stages.py:570).  Two
options draw more: grid-sampled keypoints (use_sample_feature,
fast.py:211-215) and the depth noise of the non-joint camera solve
(joint_flow=False with depth_noise, stages.py:221).  Here the step asks an
object with those six methods, so a test can replay the JAX package's
draws exactly.

The trackers draw a frame's tensors up front (`frame_uniforms`) from a
generator re-seeded for that frame, and hand the step a `UniformDraws`
over them: the four uniform tensors every step uses, then the optional
draws, only where the configuration uses them (so a configuration without
them draws what it drew before they existed).  The JAX tracker
pre-splits MAX_FRAMES keys and frame f uses key f % MAX_FRAMES
(fused.py:160-164, 445, 501-506);
here frame f's draws are a function of (cfg.seed, f % MAX_FRAMES) alone:
they do not depend on the chunk size, on a padded tail chunk, or on
whether the frame runs alone or as one stream of a batch.  Drawn outside
the step, they can also be mapped over streams by `torch.func.vmap`,
which a generator cannot.
"""

from __future__ import annotations

from typing import Protocol

import torch

from ..config import VDOConfig
from ..ops.fast import sample_cells
from ..ops.frontend import object_grid_size

Tensor = torch.Tensor

MAX_FRAMES = 8192  # length of the draw ring (FusedTracker.MAX_FRAMES)


class FrameDraws(Protocol):
    def object_priority(self, n: int) -> Tensor:
        """(n,) uniform [0, 1) priorities of the object sample sites."""

    def camera_picks(self, n_samples: int, n_valid: Tensor) -> Tensor:
        """(n_samples, 3) int64 in [0, n_valid), n_valid a 0-d tensor."""

    def object_picks(self, n_samples: int, n_valid: Tensor) -> Tensor:
        """(K, n_samples, 3) int64, row k in [0, n_valid[k])."""

    def renew_priority(self, n: int) -> Tensor:
        """(n,) uniform [0, 1) priorities of the renewal candidates."""

    def sample_offsets(self, n_div: int, per_cell: int) -> Tensor:
        """(2, n_div, n_div, per_cell) uniform [0, 1): the x and y offsets
        of the grid-sampled keypoints in their cells."""

    def depth_noise(self, n: int) -> Tensor:
        """(n,) standard normals of the non-joint camera's depth noise."""


def uniform_shapes(cfg: VDOConfig) -> dict:
    """The shapes of the uniform tensors one frame step consumes: the four
    of every configuration, then grid sampling's offsets where
    use_sample_feature is set."""
    sh, fe = cfg.shapes, cfg.frontend
    n_grid = object_grid_size(cfg.camera.height, cfg.camera.width,
                              fe.obj_sample_step)
    shapes = {"object_priority": (n_grid,),
              "camera_picks": (sh.ransac_samples, 3),
              "object_picks": (sh.max_objects, sh.ransac_samples, 3),
              "renew_priority": (sh.max_dynamic,)}
    if fe.use_sample_feature:
        n_div = fe.sample_grid_div
        shapes["sample_offsets"] = (
            2, n_div, n_div, sample_cells(fe.n_sample_points, n_div))
    return shapes


def normal_shapes(cfg: VDOConfig) -> dict:
    """The shapes of the standard-normal tensors one frame step consumes:
    the depth noise of the non-joint camera solve, where it is on."""
    tr = cfg.tracking
    if not tr.joint_flow and tr.depth_noise:
        return {"depth_noise": (cfg.shapes.max_static,)}
    return {}


def frame_uniforms(cfg: VDOConfig, frame_id: int,
                   generator: torch.Generator) -> dict:
    """The draws of frame `frame_id`, in a fixed order from `generator`
    re-seeded with (cfg.seed, frame_id mod MAX_FRAMES): the uniform [0, 1)
    tensors of `uniform_shapes`, then the normals of `normal_shapes`."""
    generator.manual_seed(cfg.seed * MAX_FRAMES + frame_id % MAX_FRAMES)
    out = {name: torch.rand(shape, generator=generator,
                            device=generator.device)
           for name, shape in uniform_shapes(cfg).items()}
    out.update({name: torch.randn(shape, generator=generator,
                                  device=generator.device)
                for name, shape in normal_shapes(cfg).items()})
    return out


class UniformDraws:
    """FrameDraws over pre-drawn tensors (`frame_uniforms`).  Picks are
    floor(u * n_valid), so no draw reads the device."""

    def __init__(self, uniforms: dict):
        self.u = uniforms

    def _take(self, name: str, shape) -> Tensor:
        u = self.u[name]
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"{name}: the step asks for {tuple(shape)}, "
                             f"{tuple(u.shape)} were drawn")
        return u

    def _picks(self, name: str, shape, n_valid: Tensor) -> Tensor:
        n = n_valid.reshape(n_valid.shape + (1,) * len(shape))
        u = self._take(name, tuple(n_valid.shape) + tuple(shape))
        picks = (u * n.to(torch.float32)).to(torch.int64)
        return torch.minimum(picks, n - 1)

    def object_priority(self, n: int) -> Tensor:
        return self._take("object_priority", (n,))

    def camera_picks(self, n_samples: int, n_valid: Tensor) -> Tensor:
        return self._picks("camera_picks", (n_samples, 3), n_valid)

    def object_picks(self, n_samples: int, n_valid: Tensor) -> Tensor:
        return self._picks("object_picks", (n_samples, 3), n_valid)

    def renew_priority(self, n: int) -> Tensor:
        return self._take("renew_priority", (n,))

    def sample_offsets(self, n_div: int, per_cell: int) -> Tensor:
        return self._take("sample_offsets", (2, n_div, n_div, per_cell))

    def depth_noise(self, n: int) -> Tensor:
        return self._take("depth_noise", (n,))
