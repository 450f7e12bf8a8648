"""The slice end to end: the JAX fused step (make_frame_step, packed=False,
under jax.jit) and the port's step over the 8-frame, 320x240, 2-object
scene of tests/conftest.py with `small_config`, fed the same inputs and the
same random draws (JaxDraws replays the JAX key splits of
multistream.py:93, stages.py:101, ransac.py:164, stages.py:384 and
stages.py:570).

Tolerances, per frame: the same set of active slot labels; T_cw within
1e-3 m and 0.01 deg; each active slot's H translation within 5e-3 m.  A
port step started from the JAX state of the frame before
(`state_from_numpy`, the state that plays the part of weights here) is held
to the same bounds.  The port's System must stay under the bounds of
tests/test_pipeline_e2e.py:382-385, taken against the JAX step's numbers
archived the same way.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.test_pipeline_e2e import small_config
from vdo_slam_tpu.parallel.multistream import make_frame_step as jax_step
from vdo_slam_tpu.parallel.multistream import make_stream_state as jax_state
from vdo_slam_tpu_torch import config as pconfig
from vdo_slam_tpu_torch.eval.results import metric_report
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.io.synthetic import make_scene
from vdo_slam_tpu_torch.parallel.multistream import (make_frame_step,
                                                     make_stream_state,
                                                     state_from_numpy)
from vdo_slam_tpu_torch.pipeline import System
from vdo_slam_tpu_torch.pipeline.fused import (FusedTracker, pack_outputs,
                                               unpack_host)

T_TOL_M, R_TOL_DEG, H_TOL_M = 1e-3, 0.01, 5e-3


def port_config(cfg):
    """The same configuration, built from the port's dataclasses."""
    d = dataclasses.asdict(cfg)
    return pconfig.VDOConfig(
        camera=pconfig.CameraConfig(**d["camera"]),
        frontend=pconfig.FrontendConfig(**d["frontend"]),
        tracking=pconfig.TrackingConfig(**d["tracking"]),
        solver=pconfig.SolverConfig(**d["solver"]),
        backend=pconfig.BackendConfig(**d["backend"]),
        shapes=pconfig.ShapeConfig(**d["shapes"]), seed=d["seed"])


class JaxDraws:
    """The port's FrameDraws, drawing what the JAX step draws from `key`."""

    def __init__(self, key, initialized: bool, n_slots: int):
        if initialized:
            k1, self.k2, self.k3, self.k4 = jax.random.split(key, 4)
        else:
            k1 = key
        self.k_obj = jax.random.split(k1)[1]
        self.n_slots = n_slots

    @staticmethod
    def _t(x):
        return torch.from_numpy(np.array(x))

    def object_priority(self, n):
        return self._t(jax.random.uniform(self.k_obj, (n,)))

    def camera_picks(self, n_samples, n_valid):
        return self._t(jax.random.randint(self.k2, (n_samples, 3), 0,
                                          int(n_valid))).long()

    def object_picks(self, n_samples, n_valid):
        keys = jax.random.split(self.k3, self.n_slots)
        return self._t(np.stack([
            np.asarray(jax.random.randint(keys[i], (n_samples, 3), 0,
                                          int(n_valid[i])))
            for i in range(self.n_slots)])).long()

    def renew_priority(self, n):
        return self._t(jax.random.uniform(self.k4, (n,)))


def to_port_host(cfg, jstate_np, jmetrics_np):
    """The JAX step's outputs in the archive's host layout, through the
    port's own pack/unpack."""
    state, _ = state_from_numpy(jstate_np, "cpu")
    metrics = {k: torch.from_numpy(np.array(v)) for k, v in jmetrics_np.items()}
    sh = cfg.shapes
    return unpack_host(pack_outputs(state, metrics).numpy(), sh.max_static,
                       sh.max_dynamic, sh.max_objects)


def pose_gap(T, T_ref):
    """(translation m, rotation deg) between two 4x4 poses."""
    E = np.linalg.inv(np.asarray(T_ref, np.float64)) @ np.asarray(T, np.float64)
    s = np.asarray([E[2, 1] - E[1, 2], E[0, 2] - E[2, 0], E[1, 0] - E[0, 1]])
    ang = np.degrees(np.arctan2(0.5 * np.linalg.norm(s),
                                0.5 * (np.trace(E[:3, :3]) - 1.0)))
    return (float(np.linalg.norm(np.asarray(T)[:3, 3]
                                 - np.asarray(T_ref)[:3, 3])), float(ang))


def active_slots(metrics):
    act = np.asarray(metrics["slot_active"])
    sem = np.asarray(metrics["slot_sem"])
    H = np.asarray(metrics["slot_H"])
    return {int(s): H[k] for k, s in enumerate(sem) if act[k]}


@pytest.fixture(scope="module")
def run():
    scene = make_scene(num_frames=8, width=320, height=240, num_objects=2,
                       seed=3)
    jcfg = small_config(scene)
    cfg = port_config(jcfg)
    ds = SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)
    keys = jax.random.split(jax.random.PRNGKey(jcfg.seed), len(ds))
    n_slots = cfg.shapes.max_objects

    jstep = jax.jit(jax_step(jcfg, packed=False))
    pstep = make_frame_step(cfg, "cpu")
    # host staging (GT pose, gt_sems), and the JAX outputs' MapState
    stager = FusedTracker(cfg, device="cpu")
    jarchive = FusedTracker(cfg, device="cpu")
    jst, pst = jax_state(jcfg), make_stream_state(cfg, "cpu")
    out = {"jax": [], "port": [], "carried": []}
    jstate_prev = None
    for f in range(len(ds)):
        fd = ds[f]
        inputs = stager.device_inputs(fd)
        T_cw_gt = inputs.pop("_T_cw_gt_host")
        jin = {k: v.numpy() for k, v in inputs.items()}
        jst, jm = jstep(jst, jin, keys[f])
        jst_np, jm_np = jax.device_get((jst, jm))
        out["jax"].append(jm_np)
        jarchive._archive(fd, to_port_host(cfg, jst_np, jm_np), T_cw_gt, f)
        pst, pm = pstep(pst, inputs, JaxDraws(keys[f], f > 0, n_slots), f > 0)
        out["port"].append(pm | {"T_cw": pst.frame.T_cw})
        if jstate_prev is not None:
            st, init = state_from_numpy(jstate_prev, "cpu")
            cst, cm = pstep(st, inputs, JaxDraws(keys[f], init, n_slots), init)
            out["carried"].append(cm | {"T_cw": cst.frame.T_cw})
        out["jax"][-1]["T_cw"] = jst_np["frame"].T_cw
        jstate_prev = jst_np

    sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  mode="fused", device="cpu")
    out["reports"] = sysm.run_sequence(ds)
    out["port_metrics"] = sysm.metrics()
    out["jax_metrics"] = metric_report(jarchive.map)
    out["n_frames"] = len(ds)
    return out


def _check_frame(port, ref):
    assert set(active_slots(port)) == set(active_slots(ref))
    dt, dr = pose_gap(port["T_cw"], ref["T_cw"])
    assert dt < T_TOL_M and dr < R_TOL_DEG, (dt, dr)
    ref_H = active_slots(ref)
    for sem, H in active_slots(port).items():
        gap = np.linalg.norm(np.asarray(H)[:3, 3] - ref_H[sem][:3, 3])
        assert gap < H_TOL_M, (sem, gap)


class TestSlice:
    def test_free_running_steps_agree(self, run):
        for f, (port, ref) in enumerate(zip(run["port"], run["jax"])):
            _check_frame(port, ref)
        # objects really are tracked on both sides
        assert sum(len(active_slots(m)) for m in run["jax"]) >= 8

    def test_camera_inliers_agree(self, run):
        for port, ref in zip(run["port"][1:], run["jax"][1:]):
            n_p, n_j = int(port["n_inlier"]), int(ref["n_inlier"])
            assert abs(n_p - n_j) <= 0.01 * n_j, (n_p, n_j)

    def test_step_from_jax_state(self, run):
        """One port step from each JAX state against the JAX next step."""
        assert len(run["carried"]) == run["n_frames"] - 1
        for port, ref in zip(run["carried"], run["jax"][1:]):
            _check_frame(port, ref)

    def test_system_metrics_within_e2e_bounds(self, run):
        rep, ref = run["port_metrics"], run["jax_metrics"]
        assert len(run["reports"]) == run["n_frames"]
        assert rep["cam_t_rpe"] < max(3.0 * ref["cam_t_rpe"], 0.005), (rep, ref)
        assert rep["cam_r_rpe_deg"] < max(3.0 * ref["cam_r_rpe_deg"], 0.01)
        assert rep["obj_t_rpe"] < 0.02, rep
        assert rep["n_obj_estimates"] > 0 and ref["n_obj_estimates"] > 0
