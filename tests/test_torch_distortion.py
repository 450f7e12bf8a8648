"""Why the card and the CPU part on the distorted bench scene, shown on the
CPU.

On the card, the first array of frame 0 that differs from the CPU's is the
detector's pyramid: F.interpolate(antialias=True) rounds differently there
(levels up to 2.7e-5 apart on an H100).  Every later stage, given the
CPU's levels, is bit-equal on the card (tests/test_torch_kernel_cuda.py,
chip_distortion_scatter.py).  The scene is noise-free: its gray levels take
three values, so FAST scores tie exactly, and a rounding-level change of
the levels reorders the ties inside the per-cell top-k.  Here a second
resize, the float64 product of the same weights rounded once
(chip_distortion_scatter.f64_pyramid, at most 1.5e-6 from the port's
levels on this frame), stands in for the card's:

* noise-free, the detections of frame 0 differ as sets (95 keypoints each
  way on the CPU), and so do the static candidates;
* with seeded gray noise (sigma 0.02) the ties are gone: the detections and
  both candidate banks are the same sets of keypoints under either resize.
  This is the test the explanation predicts, and the card passes it too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_distortion_scatter import f64_pyramid
from vdo_slam_tpu_torch.config import KITTI, ShapeConfig, VDOConfig
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.io.synthetic import make_scene
from vdo_slam_tpu_torch.ops import fast
from vdo_slam_tpu_torch.pipeline import stages
from vdo_slam_tpu_torch.pipeline.draws import UniformDraws, frame_uniforms

DIST = (-0.28, 0.07, 0.0, 0.0, 0.0)    # tests/test_pipeline_e2e.py:258
NOISE_SIGMA = 0.02
LEVEL_TOL = 2e-6     # the two resizes (tests/test_torch_fast.py holds 2e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs in several worker processes at once, and each worker's idle
    OpenMP threads spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def distorted_config():
    """chip_smoke.py's bench config (1242x375) with the lens's k1/k2."""
    cfg = VDOConfig()
    return cfg.replace(
        camera=dataclasses.replace(
            cfg.camera, fx=721.5377, fy=721.5377, cx=621.0, cy=187.5,
            width=1242, height=375, bf=387.5744, k1=DIST[0], k2=DIST[1]),
        tracking=dataclasses.replace(cfg.tracking, dataset=KITTI,
                                     depth_map_factor=256.0),
        shapes=ShapeConfig(),
        solver=dataclasses.replace(cfg.solver, lm_iters=10, lm_iters_obj=6))


@pytest.fixture(scope="module")
def frame0():
    scene = make_scene(num_frames=2, width=1242, height=375, num_objects=3,
                       fx=721.5377, seed=7, dist=DIST)
    return SyntheticDataset(scene, depth_map_factor=256.0, bf=387.5744)[0]


def _frame0(fd, cfg, noise_seed):
    """(levels, detections, static and object candidates) of frame 0."""
    rgb = np.asarray(fd.rgb, np.float32)
    if noise_seed is not None:
        rgb = np.clip(rgb + NOISE_SIGMA * np.random.default_rng(
            noise_seed).standard_normal(rgb.shape), 0.0, 1.0).astype(
                np.float32)
    fe = cfg.frontend
    gray = torch.from_numpy(rgb)
    levels = fast.pyramid(gray, fe.n_levels, fe.scale_factor)
    scores = stages.make_score_pyramid(cfg)(gray)
    det = fast.select_pyramid(scores, fe.n_features, fe.scale_factor,
                              fe.fast_cell)
    draws = UniformDraws(frame_uniforms(cfg, 0, torch.Generator()))
    prep = stages.make_prepare(cfg, "cpu")(
        gray, torch.from_numpy(fd.depth_raw), torch.from_numpy(fd.flow),
        torch.from_numpy(fd.mask.astype(np.int32)), draws, scores=scores)
    return levels, det, prep["stat_cand"], prep["obj_cand"]


def _keyset(xy, valid, level=None):
    xy, valid = xy.numpy(), valid.numpy()
    lev = np.zeros(len(xy)) if level is None else level.numpy()
    return {(int(o), float(x), float(y))
            for o, (x, y) in zip(lev[valid], xy[valid])}


def _both(fd, monkeypatch, noise_seed):
    cfg = distorted_config()
    port = _frame0(fd, cfg, noise_seed)
    monkeypatch.setattr(fast, "pyramid", f64_pyramid)
    other = _frame0(fd, cfg, noise_seed)
    gap = max(float((a - b).abs().max()) for a, b in zip(port[0], other[0]))
    assert 0.0 < gap <= LEVEL_TOL, gap
    return port, other


def test_noise_free_ties_move_with_the_resize(frame0, monkeypatch):
    """The mechanism: a rounding-level change of the levels moves the
    noise-free frame's detections and static candidates."""
    (_, det, stat, _), (_, det2, stat2, _) = _both(frame0, monkeypatch, None)
    a = _keyset(det["xy"], det["valid"], det["octave"])
    b = _keyset(det2["xy"], det2["valid"], det2["octave"])
    assert len(a) == len(b) and a != b
    assert _keyset(stat["xy"], stat["valid"]) != _keyset(stat2["xy"],
                                                          stat2["valid"])


@pytest.mark.parametrize("noise_seed", [0, 1])
def test_seeded_noise_makes_frame0_banks_resize_proof(frame0, monkeypatch,
                                                      noise_seed):
    """The prediction: with seeded gray noise the detections and both
    candidate banks are the same sets of keypoints under either resize
    (row for row here; on the card a few rows come in another order)."""
    (_, det, stat, obj), (_, det2, stat2, obj2) = _both(frame0, monkeypatch,
                                                        noise_seed)
    assert _keyset(det["xy"], det["valid"], det["octave"]) == _keyset(
        det2["xy"], det2["valid"], det2["octave"])
    for x, y in ((stat, stat2), (obj, obj2)):
        assert _keyset(x["xy"], x["valid"]) == _keyset(y["xy"], y["valid"])
    assert int(stat["valid"].sum()) == distorted_config().shapes.max_static

