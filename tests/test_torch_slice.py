"""The slice end to end: the JAX fused step (make_frame_step, packed=False,
under jax.jit) and the port's step over the 8-frame, 320x240, 2-object
scene of tests/conftest.py with `small_config`, fed the same inputs and the
same random draws (JaxDraws replays the JAX key splits of
multistream.py:93, stages.py:101, ransac.py:164, stages.py:384 and
stages.py:570).  The packed steps (packed=True, as the JAX tracker always
steps) are compared the same way: one port step from each state of the JAX
packed run on that scene's (4, H, W) wire, and free-running on tpu_fast's
wire (entropy, half-res delta flow) at 96x64.

The chunked drive: chunk = 4 and chunk = 3 archives equal the chunk = 1
archive at atol = 0 on the CPU, on a 7-frame sequence (a padded tail for
both), and a frame's draws do not depend on the chunk or the tail.

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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs in several worker processes at once, and each worker's idle
    OpenMP threads spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
        keys = (jax.random.split(key, 4) if initialized
                else (key, None, None, None))
        self._set(*keys, n_slots)

    @classmethod
    def from_keys(cls, n_slots: int, k1=None, k2=None, k3=None, k4=None):
        """The draws of stages handed these keys, as the host Tracker hands
        them: prepare k1, camera k2, objects k3, renewal k4."""
        self = cls.__new__(cls)
        self._set(k1, k2, k3, k4, n_slots)
        return self

    def _set(self, k1, k2, k3, k4, n_slots):
        self.k1, self.k2, self.k3, self.k4 = k1, k2, k3, k4
        if k1 is not None:
            self.k_det, self.k_obj = jax.random.split(k1)
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

    def sample_offsets(self, n_div, per_cell):
        """fast.py:211-215: x from the first half of k_det, y the second."""
        kx, ky = jax.random.split(self.k_det)
        return self._t(np.stack([
            np.asarray(jax.random.uniform(k, (n_div, n_div, per_cell)))
            for k in (kx, ky)]))

    def depth_noise(self, n):
        """stages.py:221 with reproj_lm.py:45."""
        return self._t(jax.random.normal(jax.random.fold_in(self.k2, 1),
                                         (n,)))


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
    jstep_w = jax.jit(jax_step(jcfg, packed=True))
    pstep_w = make_frame_step(cfg, "cpu", packed=True)
    # host staging (GT pose, gt_sems), and the JAX outputs' MapState
    stager = FusedTracker(cfg, device="cpu")
    jarchive = FusedTracker(cfg, device="cpu")
    jst, pst = jax_state(jcfg), make_stream_state(cfg, "cpu")
    jst_w = jax_state(jcfg)
    out = {"jax": [], "port": [], "carried": [], "jax_wire": [],
           "carried_wire": []}
    jstate_prev = None
    for f in range(len(ds)):
        fd = ds[f]
        wire = stager.device_inputs(fd)
        T_cw_gt = wire.pop("_T_cw_gt_host")
        inputs = {"rgb": torch.from_numpy(fd.rgb),
                  "depth_raw": torch.from_numpy(fd.depth_raw),
                  "flow": torch.from_numpy(fd.flow),
                  "seg": torch.from_numpy(fd.mask.astype(np.int32)),
                  "T_cw_gt": wire["T_cw_gt"], "gt_sems": wire["gt_sems"]}
        jin = {k: v.numpy() for k, v in inputs.items()}
        # the packed steps: one port step from each state of the JAX run
        jst_w_prev = jax.device_get(jst_w)
        jst_w, jm_w = jstep_w(jst_w, {k: v.numpy() for k, v in wire.items()},
                              keys[f])
        out["jax_wire"].append(jax.device_get(jm_w) | {
            "T_cw": np.asarray(jst_w["frame"].T_cw)})
        st, init = state_from_numpy(jst_w_prev, "cpu")
        cst, cm = pstep_w(st, wire, JaxDraws(keys[f], init, n_slots), init)
        out["carried_wire"].append(cm | {"T_cw": cst.frame.T_cw})
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

    def test_packed_step_from_jax_state(self, run):
        """One port packed step from each state of the JAX packed run, on
        the same (4, H, W) wire buffers."""
        assert len(run["carried_wire"]) == run["n_frames"]
        for port, ref in zip(run["carried_wire"], run["jax_wire"]):
            _check_frame(port, ref)
        assert sum(len(active_slots(m)) for m in run["jax_wire"]) >= 8

    def test_system_metrics_within_e2e_bounds(self, run):
        rep, ref = run["port_metrics"], run["jax_metrics"]
        assert len(run["reports"]) == run["n_frames"]
        assert rep["cam_t_rpe"] < max(3.0 * ref["cam_t_rpe"], 0.005), (rep, ref)
        assert rep["cam_r_rpe_deg"] < max(3.0 * ref["cam_r_rpe_deg"], 0.01)
        assert rep["obj_t_rpe"] < 0.02, rep
        assert rep["n_obj_estimates"] > 0 and ref["n_obj_estimates"] > 0


# --------------------------------------------------------------------------
# tpu_fast's wire, the chunked drive, the draw ring
# --------------------------------------------------------------------------

WIRE = dict(wire_flow_half=True, wire_flow_delta=True, wire_entropy=True,
            wire_seg_cap=1024, wire_depth_exc_cap=2048)


def tiny_pair(**tracking):
    """(JAX config, port config) of tests/test_multistream.py:tiny_config
    with tracking fields replaced."""
    from tests.test_multistream import tiny_config

    jcfg = tiny_config()
    jcfg = jcfg.replace(tracking=dataclasses.replace(jcfg.tracking,
                                                     **tracking))
    return jcfg, port_config(jcfg)


@pytest.fixture(scope="module")
def tiny_ds():
    scene = make_scene(num_frames=8, width=96, height=64, num_objects=1,
                       seed=1)
    return SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)


def test_packed_step_matches_jax_on_entropy_wire(tiny_ds):
    """The port's packed step against the JAX packed step on the lossy
    half-res-flow entropy wire, replayed draws, 5 frames."""
    jcfg, cfg = tiny_pair(**WIRE)
    keys = jax.random.split(jax.random.PRNGKey(jcfg.seed), 5)
    jstep = jax.jit(jax_step(jcfg, packed=True))
    pstep = make_frame_step(cfg, "cpu", packed=True)
    stager = FusedTracker(cfg, device="cpu", build_step=False)
    jst, pst = jax_state(jcfg), make_stream_state(cfg, "cpu")
    n_slots = cfg.shapes.max_objects
    for f in range(5):
        inputs = stager.device_inputs(tiny_ds[f])
        inputs.pop("_T_cw_gt_host")
        assert inputs["packed"].ndim == 1
        assert inputs["packed"].dtype == torch.int16
        jst, jm = jstep(jst, {k: v.numpy() for k, v in inputs.items()},
                        keys[f])
        pst, pm = pstep(pst, inputs, JaxDraws(keys[f], f > 0, n_slots), f > 0)
        jm = jax.device_get(jm)
        _check_frame(pm | {"T_cw": pst.frame.T_cw},
                     jm | {"T_cw": np.asarray(jst["frame"].T_cw)})
        np.testing.assert_array_equal(pst.frame.seg.numpy(),
                                      np.asarray(jst["frame"].seg))
        if f:
            assert abs(int(pm["n_inlier"]) - int(jm["n_inlier"])) <= 2


def test_dense_step_equals_packed_step(tiny_ds):
    """packed=True is the wire decode in front of the packed=False step."""
    from vdo_slam_tpu_torch.pipeline import draws as draws_mod
    from vdo_slam_tpu_torch.pipeline.stages import make_unpack

    _, cfg = tiny_pair(**WIRE)
    stager = FusedTracker(cfg, device="cpu", build_step=False)
    packed_step = make_frame_step(cfg, "cpu", packed=True)
    dense_step = make_frame_step(cfg, "cpu")
    unpack = make_unpack(cfg)
    st_p, st_d = make_stream_state(cfg, "cpu"), make_stream_state(cfg, "cpu")
    for f in range(3):
        inputs = stager.device_inputs(tiny_ds[f])
        inputs.pop("_T_cw_gt_host")
        u = draws_mod.UniformDraws(stager.frame_draws(f))
        st_p, m_p = packed_step(st_p, inputs, u, f > 0)
        st_d, m_d = dense_step(st_d, unpack(inputs), u, f > 0)
        assert torch.equal(pack_outputs(st_p, m_p), pack_outputs(st_d, m_d))


def _archive_arrays(m):
    return {k: np.stack(getattr(m, k)) for k in
            ("cam_pose", "cam_pose_gt", "stat_xy", "stat_3d", "dyn_xy",
             "dyn_3d", "dyn_obj_label", "stat_assoc", "dyn_assoc")}


@pytest.fixture(scope="module")
def chunk_runs(tiny_ds):
    """7 frames under tpu_fast's wire at chunk 1, 4 and 3 (drain every 2
    chunks), pre-packed for chunk 4."""
    from vdo_slam_tpu_torch.io.packed_dataset import InMemoryPackedDataset

    out = {}
    for C in (1, 4, 3):
        _, cfg = tiny_pair(fused_chunk=C, fused_drain_chunks=2, **WIRE)
        ds = tiny_ds
        if C == 4:
            tr = cfg.tracking
            ds = InMemoryPackedDataset(
                tiny_ds, depth_map_factor=1.0, flow_down=tr.flow_down,
                flow_delta=tr.flow_delta, entropy=tr.entropy,
                seg_cap=tr.wire_seg_cap, depth_exc_cap=tr.wire_depth_exc_cap)
        sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                      mode="fused", device="cpu")
        out[C] = (sysm, sysm.run_sequence(ds))
    return out


@pytest.mark.parametrize("C", [4, 3])
def test_chunked_archive_equals_unchunked(chunk_runs, C):
    """7 = 4 + a tail of 3 padded to 4 = 3 + 3 + a tail of 1 padded to 3."""
    (ref, ref_reps), (sysm, reps) = chunk_runs[1], chunk_runs[C]
    assert sysm.tracker.chunk == C and sysm.map.num_frames == 7
    assert [r["frame_id"] for r in reps] == list(range(7))
    assert [r["frame_id"] for r in ref_reps] == list(range(7))
    a, b = _archive_arrays(ref.map), _archive_arrays(sysm.map)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert sysm.metrics() == ref.metrics()
    # the padded tail advanced the frame counter past the padding frames
    assert sysm.tracker.frame_id == -(-7 // C) * C


def test_grab_chunk_reports_and_drain_order(tiny_ds):
    """grab_chunk archives a batch every fused_drain_chunks-th call, in
    frame order, and flush returns the rest; n_real cuts a padded tail."""
    _, cfg = tiny_pair(fused_chunk=2, fused_drain_chunks=2, **WIRE)
    tr = FusedTracker(cfg, device="cpu")
    fds = [tiny_ds[i] for i in range(7)]
    got = [tr.grab_chunk(fds[0:2]), tr.grab_chunk(fds[2:4]),
           tr.grab_chunk(fds[4:6])]
    assert [[r["frame_id"] for r in reps] for reps in got] == [[], [],
                                                               [0, 1, 2, 3]]
    assert tr.map.num_frames == 4
    tail = tr.grab_chunk([fds[6], fds[6]], n_real=1)
    assert tail == []
    rest = tr.flush()
    assert [r["frame_id"] for r in rest] == [4, 5, 6]
    assert tr.map.num_frames == 7 and tr.frame_id == 8
    with pytest.raises(ValueError):
        tr.grab_chunk(fds[:3])


def test_draws_depend_on_seed_and_frame_only():
    from vdo_slam_tpu_torch.pipeline import draws as draws_mod

    _, cfg = tiny_pair()
    a = FusedTracker(cfg, device="cpu", build_step=False)
    b = FusedTracker(cfg, device="cpu", build_step=False)
    for f in (5, 0, 3):           # b draws other frames, in another order
        b.frame_draws(f)
    ua, ub = a.frame_draws(3), b.frame_draws(3)
    assert set(ua) == set(draws_mod.uniform_shapes(cfg))
    for k, shape in draws_mod.uniform_shapes(cfg).items():
        assert tuple(ua[k].shape) == shape
        assert torch.equal(ua[k], ub[k])
        assert not torch.equal(ua[k], a.frame_draws(4)[k])
        # the ring: frame f and f + MAX_FRAMES draw the same
        assert torch.equal(ua[k], a.frame_draws(3 + a.MAX_FRAMES)[k])
    other = FusedTracker(dataclasses.replace(cfg, seed=cfg.seed + 1),
                         device="cpu", build_step=False)
    assert not torch.equal(other.frame_draws(3)["camera_picks"],
                           ua["camera_picks"])
    picks = draws_mod.UniformDraws(ua).camera_picks(
        cfg.shapes.ransac_samples, torch.tensor(7))
    assert picks.dtype == torch.int64 and 0 <= int(picks.min()) \
        and int(picks.max()) <= 6
    with pytest.raises(ValueError):
        draws_mod.UniformDraws(ua).object_priority(3)


OPTIONS = {
    "wire_and_chunks": dict(tracking=dict(fused_chunk=4, **WIRE)),
    "tpu_fast": None,
    "distortion": dict(camera=dict(k1=-0.28, k2=0.07)),
    "sample_feature": dict(frontend=dict(use_sample_feature=True,
                                         n_sample_points=300)),
    "non_joint": dict(tracking=dict(joint_flow=False)),
    "non_joint_depth_noise": dict(tracking=dict(joint_flow=False,
                                                depth_noise=True)),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_every_option_builds_both_modes_and_streams(tiny_ds, option):
    """Every option the JAX stages take builds a System in both modes and a
    MultiStreamSystem on the CPU, and each tracks two frames."""
    from vdo_slam_tpu_torch.parallel import MultiStreamSystem

    _, cfg = tiny_pair()
    change = OPTIONS[option]
    if change is None:
        cfg = pconfig.tpu_fast(cfg)
    else:
        cfg = cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                             for k, v in change.items()})
    for mode in ("reference", "fused"):
        sysm = System(cfg, enable_local_ba=True, enable_global_ba=False,
                      mode=mode, device="cpu")
        reps = sysm.run_sequence(tiny_ds, max_frames=2)
        assert [r["frame_id"] for r in reps] == [0, 1]
        assert np.isfinite(reps[1]["T_cw"]).all()
    msys = MultiStreamSystem(cfg, n_streams=2, enable_local_ba=False,
                             device="cpu")
    reps = msys.run([tiny_ds, tiny_ds], max_frames=2)
    assert [len(r) for r in reps] == [2, 2]


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    from vdo_slam_tpu_torch import run
    from vdo_slam_tpu_torch.parallel import MultiStreamSystem
    from vdo_slam_tpu_torch.pipeline import Tracker

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg = tiny_pair()
    with pytest.raises(RuntimeError):
        FusedTracker(cfg)
    with pytest.raises(RuntimeError):
        Tracker(cfg)
    with pytest.raises(RuntimeError):
        System(cfg, mode="fused")
    with pytest.raises(RuntimeError):
        System(cfg)                  # mode "reference", the default
    with pytest.raises(RuntimeError):
        MultiStreamSystem(cfg, n_streams=2)
    with pytest.raises(RuntimeError):
        run.main(["--synthetic", "--frames", "2", "--quiet"])
