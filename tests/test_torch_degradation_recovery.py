"""The port's mask-drop recovery: tests/test_degradation.py's
TestMaskDropRecovery on the same scene and configs, with the JAX test's
own assertions, and each run held to the JAX package's run of the same
scene as tests/test_torch_degradation.py holds its runs (`hold_to_jax`).

Total instance-mask dropout is the failure UpdateMask exists for
(Tracking.cc:3049-3066): the segmenter loses an object for 1-2 frames; the
mask-propagation repair must re-synthesize it from the last frame's mask
warped by flow, so the track survives with the same id.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_pipeline_e2e import small_config
from tests.test_torch_degradation import JaxRuns, hold_to_jax
from tests.test_torch_slice import port_config
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.io.synthetic import make_scene
from vdo_slam_tpu_torch.pipeline import System


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs():
    return JaxRuns()


@pytest.fixture(scope="module")
def clean_scene():
    return make_scene(num_frames=10, width=320, height=240, num_objects=2,
                      seed=3)


class TestMaskDropRecovery:
    """Runs on the fused path (stages.make_mask_prop inside the step) and
    on the host Tracker."""

    DROP_FRAMES = (4, 5)
    DROP_LABEL = 1

    def _dropped_scene(self, clean_scene):
        mask = clean_scene.mask.copy()
        for f in self.DROP_FRAMES:
            mask[f] = np.where(mask[f] == self.DROP_LABEL, 0, mask[f])
        return dataclasses.replace(clean_scene, mask=mask)

    def _sem_tracks(self, sysm):
        """frame -> {sem_label: model_label} from the archive."""
        out = {}
        for f in range(len(sysm.map.sem_label)):
            sems = sysm.map.sem_label[f]
            labs = sysm.map.rm_label[f]
            out[f + 1] = {int(s): int(l) for s, l in zip(sems[1:], labs[1:])}
        return out

    def _run(self, clean_scene, mode="fused", **tracking_overrides):
        scene = self._dropped_scene(clean_scene)
        cfg = port_config(small_config(clean_scene, **tracking_overrides))
        ds = SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)
        sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                      mode=mode, device="cpu")
        sysm.run_sequence(ds)
        return sysm, scene

    def test_track_survives_mask_drop(self, clean_scene, jax_runs):
        sysm, scene = self._run(clean_scene)
        tracks = self._sem_tracks(sysm)
        # the object is estimated THROUGH the dropped frames...
        ids = {f: tracks[f].get(self.DROP_LABEL) for f in (3, 4, 5, 6)}
        assert all(i is not None for i in ids.values()), tracks
        # ...with the SAME persistent model id (no re-seed as a new object)
        assert len(set(ids.values())) == 1, ids
        # and accuracy on the repaired frames stays in the clean regime
        rep = sysm.metrics()
        assert rep["obj_t_rpe"] < 0.15, rep
        hold_to_jax(rep, jax_runs.metrics("drop", scene, clean_scene))

    def test_without_repair_the_track_dies(self, clean_scene, jax_runs):
        """Control: with fused_mask_prop off, the dropped mask loses the
        object on those frames — proves the test exercises the repair."""
        sysm, scene = self._run(clean_scene, fused_mask_prop=False)
        tracks = self._sem_tracks(sysm)
        assert any(tracks[f].get(self.DROP_LABEL) is None
                   for f in self.DROP_FRAMES), tracks
        hold_to_jax(sysm.metrics(), jax_runs.metrics(
            "no repair", scene, clean_scene, fused_mask_prop=False))

    def test_host_path_parity(self, clean_scene, jax_runs):
        """The host Tracker (reference-bookkeeping path) recovers the same
        way — host-vs-fused behavioral parity under mask dropout."""
        sysm, scene = self._run(clean_scene, mode="reference")
        tracks = self._sem_tracks(sysm)
        ids = {f: tracks[f].get(self.DROP_LABEL) for f in (3, 4, 5, 6)}
        assert all(i is not None for i in ids.values()), tracks
        assert len(set(ids.values())) == 1, ids
        hold_to_jax(sysm.metrics(), jax_runs.metrics(
            "host", scene, clean_scene, mode="reference"))
