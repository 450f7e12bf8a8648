"""The port under degraded inputs: tests/test_degradation.py's robustness
tests on the same scenes and configs, each with the JAX test's own
assertions (tests/test_torch_degradation_recovery.py has its mask-drop
recovery tests).  Every whole-sequence run is also held to the JAX
package's run of the same degraded scene, made once per scene here (JAX on
the CPU; the fused runs of one config share one compiled step):

  * each error metric at most JAX_RATIO x the JAX package's, or under the
    floors chip_smoke.py gates the card's runs with, whichever is looser;
  * at least ESTIMATE_FRAC of its object estimates.  Under flow outliers
    the two packages' RANSAC draws pick other samples (the port draws from
    its own generator, pipeline/draws.py), so the counts may differ by one
    or two of 5-16.

The degraded scenes themselves come from each package's own
`degrade_scene` and are checked equal first.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from tests.test_pipeline_e2e import small_config
from tests.test_torch_slice import port_config
from vdo_slam_tpu.io import synthetic as jax_synthetic
from vdo_slam_tpu.io.dataset import SyntheticDataset as JaxSyntheticDataset
from vdo_slam_tpu.pipeline import System as JaxSystem
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.io.synthetic import degrade_scene, make_scene
from vdo_slam_tpu_torch.pipeline import System

JAX_RATIO = 2.0
FLOORS = {"cam_t_rpe": 1e-3, "cam_r_rpe_deg": 0.01, "obj_t_rpe": 5e-3,
          "obj_r_rpe_deg": 0.05}
ESTIMATE_FRAC = 0.75


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxRuns:
    """The JAX package's System over a scene, once per name; fused runs
    with one config reuse the first one's compiled step."""

    def __init__(self):
        self._steps = {}
        self._metrics = {}

    def metrics(self, name: str, scene, cfg_scene=None, mode="fused",
                **tracking_overrides) -> dict:
        if name not in self._metrics:
            cfg = small_config(cfg_scene if cfg_scene is not None else scene,
                               **tracking_overrides)
            sysm = JaxSystem(cfg, enable_local_ba=False,
                             enable_global_ba=False, mode=mode)
            if mode == "fused":
                sysm.tracker.step = self._steps.setdefault(repr(cfg),
                                                           sysm.tracker.step)
            sysm.run_sequence(JaxSyntheticDataset(scene, depth_map_factor=1.0,
                                                  bf=40.0))
            self._metrics[name] = sysm.metrics()
        return self._metrics[name]


def hold_to_jax(rep: dict, ref: dict) -> None:
    for k, floor in FLOORS.items():
        assert np.isfinite(rep[k]), (k, rep)
        assert rep[k] <= max(JAX_RATIO * ref[k], floor), (k, rep, ref)
    assert rep["n_obj_estimates"] >= ESTIMATE_FRAC * ref["n_obj_estimates"], \
        (rep, ref)


@pytest.fixture(scope="module")
def jax_runs():
    return JaxRuns()


@pytest.fixture(scope="module")
def clean_scene():
    return make_scene(num_frames=10, width=320, height=240, num_objects=2,
                      seed=3)


def degraded(clean_scene, **kw):
    """(port scene, JAX scene): each package's degrade_scene, checked
    equal."""
    ours = degrade_scene(clean_scene, **kw)
    theirs = jax_synthetic.degrade_scene(clean_scene, **kw)
    for f in ("rgb", "depth", "flow", "mask"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
    return ours, theirs


def _run(scene, cfg_scene=None, **sys_kw):
    cfg = port_config(small_config(cfg_scene if cfg_scene is not None
                                   else scene))
    ds = SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)
    sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  mode="fused", device="cpu", **sys_kw)
    reports = sysm.run_sequence(ds)
    return sysm, reports


class TestDegradedInputs:
    def test_flow_noise_and_outliers(self, clean_scene, jax_runs):
        """sigma=0.75 px flow noise + 1% gross outliers: the robust solvers
        must keep camera RPE bounded and still produce object estimates."""
        hard, jhard = degraded(clean_scene, flow_noise_px=0.75,
                               flow_outlier_frac=0.01, seed=1)
        sysm, _ = _run(hard, cfg_scene=clean_scene)
        rep = sysm.metrics()
        assert np.isfinite(rep["cam_t_rpe"])
        assert rep["cam_t_rpe"] < 0.08, rep
        assert rep["cam_r_rpe_deg"] < 0.3, rep
        assert rep["n_obj_estimates"] >= 3, rep
        hold_to_jax(rep, jax_runs.metrics("flow", jhard, clean_scene))

    def test_mask_erosion_jitter_and_flow_noise(self, clean_scene, jax_runs):
        """The full Mask-R-CNN-like corruption stack (erode 1 px, jitter
        ±1 px, flow noise + outliers) at once."""
        hard, jhard = degraded(clean_scene, flow_noise_px=0.75,
                               flow_outlier_frac=0.01, mask_erode_px=1,
                               mask_jitter_px=1, seed=1)
        sysm, reports = _run(hard, cfg_scene=clean_scene)
        rep = sysm.metrics()
        assert np.isfinite(rep["cam_t_rpe"])
        assert rep["cam_t_rpe"] < 0.08, rep
        assert rep["cam_r_rpe_deg"] < 0.3, rep
        assert rep["n_obj_estimates"] >= 3, rep
        assert sysm.map.num_frames == len(reports)
        hold_to_jax(rep, jax_runs.metrics("stack", jhard, clean_scene))

    def test_label_merge(self, clean_scene, jax_runs):
        """Instance-segmentation merge failure (two objects share a label):
        must not crash; camera unaffected."""
        hard, jhard = degraded(clean_scene, merge_labels={2: 1}, seed=1)
        sysm, _ = _run(hard, cfg_scene=clean_scene)
        rep = sysm.metrics()
        assert rep["cam_t_rpe"] < 0.01, rep
        hold_to_jax(rep, jax_runs.metrics("merge", jhard, clean_scene))

    def test_depth_noise(self, clean_scene, jax_runs):
        """The reference's own stereo-depth noise model (sigma ~ z^2,
        Frame.cc:489-493) applied to the input depth map."""
        hard, jhard = degraded(clean_scene, depth_noise_scale=2e-4, seed=1)
        sysm, _ = _run(hard, cfg_scene=clean_scene)
        rep = sysm.metrics()
        assert rep["cam_t_rpe"] < 0.05, rep
        assert rep["n_obj_estimates"] >= 3, rep
        hold_to_jax(rep, jax_runs.metrics("depth", jhard, clean_scene))


class TestCrowdedScene:
    def test_ten_objects_with_occlusion_crossings(self, jax_runs):
        """10 objects (over the max_objects=8 slot budget) with lateral
        crossings that occlude each other: slots saturate gracefully, far
        objects are depth-gated like the reference (Tracking.cc:2849), no
        crash, camera unaffected."""
        kw = dict(num_frames=10, width=320, height=240, num_objects=10,
                  obj_spacing=2.5, obj_cross_frac=0.5, seed=7)
        scene = make_scene(**kw)
        # the render must actually contain a crowded frame
        vis = max(len(np.unique(scene.mask[f])) - 1 for f in range(10))
        assert vis >= 8, vis
        sysm, reports = _run(scene)
        rep = sysm.metrics()
        assert rep["cam_t_rpe"] < 0.01, rep
        assert rep["n_obj_estimates"] >= 5, rep
        K = sysm.cfg.shapes.max_objects
        assert all(r.get("n_objects", 0) <= K for r in reports)
        hold_to_jax(rep, jax_runs.metrics(
            "crowd", jax_synthetic.make_scene(**kw)))


@pytest.fixture(scope="module")
def tracked_map():
    """The port's run of tests/conftest.py:tracked_session's scene and
    config (reference mode, BA off): (map, config)."""
    scene = make_scene(num_frames=8, width=320, height=240, num_objects=2,
                       seed=3)
    cfg = port_config(small_config(scene))
    sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  device="cpu")
    sysm.run_sequence(SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0))
    return sysm.map, cfg


class TestCapacityOverflow:
    def test_window_ba_truncation_is_logged_not_fatal(self, tracked_map,
                                                      monkeypatch, capsys):
        """Tracklet counts over P_CAP/E_CAP must truncate (keep the longest
        tracks), log it, and still solve (builders.py:173-183)."""
        import vdo_slam_tpu_torch.backend.builders as builders
        from vdo_slam_tpu_torch.backend.window_ba import local_ba_inplace

        monkeypatch.setattr(builders, "P_CAP", 32)
        monkeypatch.setattr(builders, "E_CAP", 128)
        m = copy.deepcopy(tracked_map[0])
        info = local_ba_inplace(m, tracked_map[1], window=6, iters=5,
                                device="cpu")
        err = capsys.readouterr().err
        assert "capacity truncation" in err
        assert info["cost"] <= info["cost0"]
        assert np.isfinite(info["cost"])

    def test_full_ba_cap_overflow_falls_back_to_buckets(self, tracked_map,
                                                        capsys):
        """full_* caps smaller than the graph must fall back to
        bucket-rounded shapes with a logged message and still refine
        (builders.py:_apply_cap)."""
        from vdo_slam_tpu_torch.backend.full_ba import full_ba_inplace

        cfg = tracked_map[1]
        cfg = cfg.replace(backend=dataclasses.replace(
            cfg.backend, full_obs_cap=64, full_ter_cap=16,
            full_point_cap=32, full_motion_cap=2, full_smo_cap=2))
        m = copy.deepcopy(tracked_map[0])
        info = full_ba_inplace(m, cfg, iters=3, device="cpu")
        err = capsys.readouterr().err
        assert "exceeds configured cap" in err
        assert info["cost"] <= info["cost0"]
        assert np.isfinite(info["cost"])


class TestLongSequence:
    @pytest.mark.slow  # 120 tracked frames + window BA in both packages
    def test_long_sequence_bounded_drift(self):
        """A sequence an order of magnitude past the usual fixtures, WITH
        windowed BA triggering repeatedly: the archive grows unbounded (the
        reference's append-only Map), per-frame RPE stays bounded (no error
        feedback loop), and the window solves keep succeeding."""
        scene = make_scene(num_frames=120, width=160, height=120,
                           num_objects=2, seed=11)

        def long_config(cfg):
            return cfg.replace(
                shapes=dataclasses.replace(cfg.shapes, max_static=300,
                                           max_dynamic=1024),
                frontend=dataclasses.replace(cfg.frontend, n_features=600),
                tracking=dataclasses.replace(cfg.tracking,
                                             boundary_shrink_row=4,
                                             boundary_shrink_col=6,
                                             min_obj_points=20,
                                             min_init_inliers=10))

        jcfg = long_config(small_config(scene))
        cfg = port_config(jcfg)
        ds = SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)
        sysm = System(cfg, enable_local_ba=True, enable_global_ba=False,
                      mode="fused", device="cpu")
        reports = sysm.run_sequence(ds)
        n = len(ds)  # scene frames - 1 (last frame has no forward flow)
        assert sysm.map.num_frames == n
        rep = sysm.metrics()
        assert rep["cam_t_rpe"] < 0.02, rep
        # windowed BA fired on schedule (every window-overlap frames)
        tr = cfg.tracking
        expected = (n - tr.overlap_size) // (tr.window_size
                                             - tr.overlap_size)
        assert len(sysm.map.lba_times) >= expected - 1
        # a solve that raises fails the port's run (pipeline/fused.py), so
        # the JAX test's ba_failures == 0 is: every trigger has its report
        assert len(sysm.tracker.ba_health) == len(sysm.map.lba_times)
        # per-frame error must not trend upward (no feedback loop): the
        # last-quarter mean stays within 3x the first-quarter mean
        rpes = np.array([r["t_rpe"] for r in reports if "t_rpe" in r])
        q = len(rpes) // 4
        assert rpes[-q:].mean() < 3.0 * rpes[:q].mean() + 1e-3
        jsys = JaxSystem(jcfg, enable_local_ba=True, enable_global_ba=False,
                         mode="fused")
        jsys.run_sequence(JaxSyntheticDataset(scene, depth_map_factor=1.0,
                                              bf=40.0))
        hold_to_jax(rep, jsys.metrics())
