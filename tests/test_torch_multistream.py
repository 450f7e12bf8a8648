"""The S-stream system: vdo_slam_tpu_torch/parallel/multisystem.py and the
batched step of parallel/multistream.py.

Stream s of MultiStreamSystem(S=2, device="cpu") against a solo System on
the same frames (the assertion of tests/test_multistream.py:323, with its
tolerances: camera poses atol 2e-4, cam_t_rpe within 1e-4, equal object
estimate counts), window BA on, on the 320x240 two-object scenes.  The
batched body runs under torch.func.vmap, which reorders float sums, so the
streams are not bit-equal to solo runs; the draws are.

Against the JAX MultiStreamSystem at 96x64: the two packages draw from
different generators inside their systems (the batched step takes its
draws as tensors, which cannot replay jax.random.randint), so the runs are
held to the bounds of tests/test_pipeline_e2e.py:382-385 on each stream's
metrics, and one port batched step from the JAX system's stacked state
(`state_from_numpy`) to the slice test's per-frame bounds.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_e2e import small_config
from tests.test_torch_slice import (R_TOL_DEG, T_TOL_M, WIRE, port_config,
                                    pose_gap, tiny_pair)
from vdo_slam_tpu.parallel.multistream import make_stream_state as jax_state
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.io.synthetic import make_scene
from vdo_slam_tpu_torch.ops import fast
from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL
from vdo_slam_tpu_torch.parallel import (MultiStreamSystem, StreamState,
                                         make_frame_step,
                                         make_multistream_step,
                                         make_stream_state, shard_streams,
                                         stack_states, state_from_numpy,
                                         stream_groups)
from vdo_slam_tpu_torch.parallel.multistream import _flatten
from vdo_slam_tpu_torch.pipeline import System
from vdo_slam_tpu_torch.pipeline import draws as draws_mod
from vdo_slam_tpu_torch.pipeline.fused import FusedTracker


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs in several worker processes at once, and each worker's idle
    OpenMP threads spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_runs():
    """S = 2 on the 320x240 scenes, window BA every 2 frames from frame 3,
    and a solo System per stream."""
    scenes = [make_scene(num_frames=7, width=320, height=240, num_objects=2,
                         seed=s) for s in (3, 9)]
    cfg = port_config(small_config(scenes[0], window_size=4, overlap_size=2,
                                   fused_drain_chunks=3))
    dss = [SyntheticDataset(s, depth_map_factor=1.0, bf=40.0) for s in scenes]
    launches = KERNEL.launches
    msys = MultiStreamSystem(cfg, n_streams=2, enable_local_ba=True,
                             device="cpu")
    reps = msys.run(dss)
    solos = []
    for ds in dss:
        solo = System(cfg, enable_local_ba=True, enable_global_ba=False,
                      mode="fused", device="cpu")
        solo.run_sequence(ds)
        solos.append(solo)
    return {"cfg": cfg, "dss": dss, "msys": msys, "reps": reps,
            "solos": solos, "launches": KERNEL.launches - launches}


class TestMultiStreamSystem:
    def test_every_stream_has_its_own_archive_and_reports(self, small_runs):
        msys, reps = small_runs["msys"], small_runs["reps"]
        n = len(small_runs["dss"][0])
        for s in range(2):
            assert msys.maps[s].num_frames == n
            assert [r["frame_id"] for r in reps[s]] == list(range(n))
            assert msys.trackers[s].frame_id == n
        assert msys.maps[0] is not msys.maps[1]
        m = msys.metrics()
        assert len(m["per_stream"]) == 2
        for p in m["per_stream"]:
            assert p["cam_t_rpe"] < 0.03, p
            assert p["n_obj_estimates"] >= 3, p
        assert m["aggregate"]["n_obj_estimates"] == sum(
            p["n_obj_estimates"] for p in m["per_stream"])
        assert m["aggregate"]["cam_t_rpe"] == pytest.approx(np.mean(
            [p["cam_t_rpe"] for p in m["per_stream"]]))
        # the CPU path runs the plain version: the kernel's count is still
        assert small_runs["launches"] == 0

    @pytest.mark.parametrize("s", [0, 1])
    def test_stream_equals_solo_system(self, small_runs, s):
        msys, solo = small_runs["msys"], small_runs["solos"][s]
        np.testing.assert_allclose(np.stack(msys.maps[s].cam_pose),
                                   np.stack(solo.map.cam_pose), atol=2e-4)
        np.testing.assert_allclose(np.stack(msys.maps[s].cam_pose_rf),
                                   np.stack(solo.map.cam_pose_rf), atol=2e-4)
        np.testing.assert_array_equal(np.stack(msys.maps[s].cam_pose_gt),
                                      np.stack(solo.map.cam_pose_gt))
        assert msys.maps[s].rm_label == solo.map.rm_label
        assert msys.maps[s].sem_label == solo.map.sem_label
        pm, sm = msys.metrics()["per_stream"][s], solo.metrics()
        assert abs(pm["cam_t_rpe"] - sm["cam_t_rpe"]) < 1e-4
        assert pm["n_obj_estimates"] == sm["n_obj_estimates"]

    def test_window_ba_ran_per_stream(self, small_runs):
        msys = small_runs["msys"]
        for t, solo in zip(msys.trackers, small_runs["solos"]):
            assert len(t.ba_health) == len(solo.tracker.ba_health) == 2
            assert len(t.map.lba_times) == 2
            for h in t.ba_health:
                assert h["cost"] <= h["cost0"]

    def test_sync_step_frames_equal_the_pipelined_run(self, small_runs):
        cfg, dss = small_runs["cfg"], small_runs["dss"]
        systems = [MultiStreamSystem(cfg, n_streams=2, enable_local_ba=False,
                                     device="cpu") for _ in range(2)]
        for i in range(3):
            reps = systems[0].step_frame([d[i] for d in dss])
            assert [r["frame_id"] for r in reps] == [i, i]
        assert systems[0].flush() == []
        systems[1].run(dss, max_frames=3)
        for s in range(2):
            np.testing.assert_array_equal(
                np.stack(systems[0].maps[s].cam_pose),
                np.stack(systems[1].maps[s].cam_pose))
            # the window solves of the fixture's run moved its poses a
            # little; the tracked poses are the same
            np.testing.assert_allclose(
                np.stack(systems[0].maps[s].cam_pose),
                np.stack(small_runs["msys"].maps[s].cam_pose)[:3], atol=2e-4)

    def test_save_results_per_stream(self, small_runs, tmp_path):
        small_runs["msys"].save_results(tmp_path)
        for s in range(2):
            assert (tmp_path / f"stream_{s}"
                    / "initial_stereo_new.txt").exists()

    def test_devices_make_one_group_per_divisor(self, small_runs):
        """n_dev, the largest divisor of S that is at most len(devices)
        (the JAX package's rule): that many groups, each a contiguous block
        of streams on its device, with a step and a state of its own."""
        cfg = small_runs["cfg"]
        two = MultiStreamSystem(cfg, n_streams=2, devices=["cpu", "cpu"],
                                enable_local_ba=False)
        assert [list(g.streams) for g in two.groups] == [[0], [1]]
        assert [g.trackers for g in two.groups] == [two.trackers[:1],
                                                    two.trackers[1:]]
        assert two.groups[0].step is not two.groups[1].step
        assert all(g.states.slot_H.shape[0] == 1 for g in two.groups)
        one = MultiStreamSystem(cfg, n_streams=2, devices=["cpu"],
                                enable_local_ba=False)
        assert one.device.type == "cpu" and len(one.groups) == 1
        assert not hasattr(one.trackers[0], "state")
        odd = MultiStreamSystem(cfg, n_streams=3, devices=["cpu"] * 2,
                                enable_local_ba=False)
        assert [list(g.streams) for g in odd.groups] == [[0, 1, 2]]
        cpu = torch.device("cpu")
        assert [list(r) for _, r in stream_groups(6, [cpu] * 4)] == [
            [0, 1], [2, 3], [4, 5]]
        with pytest.raises(ValueError, match="empty"):
            MultiStreamSystem(cfg, n_streams=2, devices=[])


@pytest.fixture(scope="module")
def two_device_runs():
    """S = 2 on two 96x64 scenes under tpu_fast's wire, window BA every 2
    frames from frame 3, drains of 3 frames: on one device, and over
    ["cpu", "cpu"], one stream per device."""
    _, cfg = tiny_pair(window_size=4, overlap_size=2, fused_drain_chunks=3,
                       **WIRE)
    dss = [SyntheticDataset(make_scene(num_frames=7, width=96, height=64,
                                       num_objects=1, seed=s),
                            depth_map_factor=1.0, bf=40.0) for s in (1, 2)]
    runs = {}
    for name, devices in (("one", ["cpu"]), ("two", ["cpu", "cpu"])):
        msys = MultiStreamSystem(cfg, n_streams=2, enable_local_ba=True,
                                 devices=devices)
        launches = KERNEL.launches
        runs[name] = (msys, msys.run(dss), KERNEL.launches - launches)
    return runs


def test_two_devices_equal_one_device(two_device_runs):
    """Each stream over two devices against the same stream in the
    one-device batch of two: every archived pose entry within 5e-6, the
    same labels, reports, estimates and window solves.  The batched body
    under vmap rounds differently for a batch of one than of two, and the
    gap grows by ~5e-7 a frame: 2.86e-6 at frame 5 here, with or without
    the window solves (a stream against its solo run: 2.5e-6)."""
    (one, reps1, l1), (two, reps2, l2) = (two_device_runs["one"],
                                          two_device_runs["two"])
    assert len(one.groups) == 1 and len(two.groups) == 2
    assert l1 == l2 == 0      # the CPU runs the kernel's plain version
    m1, m2 = one.metrics()["per_stream"], two.metrics()["per_stream"]
    n = len(reps1[0])
    for s in range(2):
        a, b = two.maps[s], one.maps[s]
        assert a.num_frames == b.num_frames == n == 6
        assert [r["frame_id"] for r in reps2[s]] == list(range(n))
        np.testing.assert_allclose(np.stack(a.cam_pose), np.stack(b.cam_pose),
                                   atol=5e-6)
        np.testing.assert_allclose(np.stack(a.cam_pose_rf),
                                   np.stack(b.cam_pose_rf), atol=5e-6)
        assert a.sem_label == b.sem_label and a.rm_label == b.rm_label
        assert m2[s]["n_obj_estimates"] == m1[s]["n_obj_estimates"]
        assert len(two.trackers[s].ba_health) == len(
            one.trackers[s].ba_health) == 2


def test_multistream_step_over_two_devices():
    """make_multistream_step over ["cpu", "cpu"]: the stacked state and
    inputs split by shard_streams, one batched step per device, the fleet
    gathered on the first; each stream within 2.5e-6 of the one-device
    step, equal inlier counts, the same fleet."""
    _, cfg = tiny_pair()
    dss = [SyntheticDataset(make_scene(num_frames=3, width=96, height=64,
                                       num_objects=1, seed=s),
                            depth_map_factor=1.0, bf=40.0) for s in (1, 2)]
    devices = ["cpu", "cpu"]
    one = make_multistream_step(cfg, "cpu")
    two = make_multistream_step(cfg, devices=devices)
    stagers = [FusedTracker(cfg, device="cpu", build_step=False)
               for _ in dss]
    s1 = stack_states([make_stream_state(cfg, "cpu") for _ in dss])
    s2 = shard_streams(s1, devices)
    assert [x.slot_H.shape[0] for x in s2] == [1, 1]
    for f in range(3):
        per = []
        for t, ds in zip(stagers, dss):
            fd = ds[f]
            per.append({"rgb": torch.from_numpy(fd.rgb),
                        "depth_raw": torch.from_numpy(fd.depth_raw),
                        "flow": torch.from_numpy(fd.flow),
                        "seg": torch.from_numpy(fd.mask.astype(np.int32)),
                        "T_cw_gt": torch.from_numpy(t._gt_pose(
                            fd.pose_gt_raw))})
        inputs = {k: torch.stack([p[k] for p in per]) for k in per[0]}
        u = {k: v.expand((2,) + v.shape)
             for k, v in stagers[0].frame_draws(f).items()}
        s1, m1, f1 = one(s1, inputs, u, f > 0)
        s2, m2, f2 = two(s2, shard_streams(inputs, devices),
                         shard_streams(u, devices), f > 0)
        for k in range(2):
            np.testing.assert_allclose(s2[k].frame.T_cw[0].numpy(),
                                       s1.frame.T_cw[k].numpy(), atol=2.5e-6)
            assert int(m2[k]["n_inlier"][0]) == int(m1["n_inlier"][k])
        assert int(f2["total_objects"]) == int(f1["total_objects"])
        for key in ("mean_t_rpe", "mean_r_rpe"):
            assert float(f2[key]) == pytest.approx(float(f1[key]), abs=1e-6)
    with pytest.raises(ValueError, match="split evenly"):
        shard_streams(inputs, ["cpu"] * 3)


def test_pipelined_drain_returns_frames_in_batches():
    _, cfg = tiny_pair(fused_drain_chunks=3, **WIRE)
    ds = SyntheticDataset(make_scene(num_frames=6, width=96, height=64,
                                     num_objects=1, seed=1),
                          depth_map_factor=1.0, bf=40.0)
    msys = MultiStreamSystem(cfg, n_streams=2, enable_local_ba=False,
                             device="cpu")
    got = [msys.step_frame([ds[i], ds[i]], sync=False) for i in range(5)]
    ids = [[frame[0]["frame_id"] for frame in done] for done in got]
    assert ids == [[], [], [0, 1, 2], [], []]
    assert [f[0]["frame_id"] for f in msys.flush()] == [3, 4]
    # identical inputs and identical draws: identical streams
    np.testing.assert_array_equal(np.stack(msys.maps[0].cam_pose),
                                  np.stack(msys.maps[1].cam_pose))


def test_batched_scores_equal_per_stream_scores():
    """The plain fast_score and the pyramid on (S, H, W): bit-equal to the
    streams scored alone, every level contiguous."""
    rng = np.random.default_rng(0)
    gray = torch.from_numpy(rng.random((3, 63, 97), dtype=np.float32))
    levels = fast.pyramid(gray, 3, 1.2)
    assert all(lv.is_contiguous() and lv.shape[0] == 3 for lv in levels)
    batched = fast.score_pyramid(gray, 3, 1.2, 20.0, 7.0)
    for s in range(3):
        alone = fast.score_pyramid(gray[s], 3, 1.2, 20.0, 7.0)
        for (bi, bm), (ai, am), lv in zip(batched, alone, levels):
            assert bi.shape == lv.shape
            assert torch.equal(bi[s], ai) and torch.equal(bm[s], am)
        det = fast.select_pyramid([(i[s], m[s]) for i, m in batched], 200,
                                  1.2, 30)
        ref = fast.detect_pyramid(gray[s], 200, 3, 1.2, 20.0, 7.0, 30)
        for k in ref:
            assert torch.equal(det[k], ref[k])


def test_multistream_step_equals_solo_steps_and_reduces():
    """make_multistream_step on dense inputs: stream s against the solo
    step on the same inputs and draws; the fleet reductions."""
    _, cfg = tiny_pair()
    scenes = [make_scene(num_frames=4, width=96, height=64, num_objects=1,
                         seed=s) for s in (1, 2, 3)]
    dss = [SyntheticDataset(s, depth_map_factor=1.0, bf=40.0) for s in scenes]
    S = len(dss)
    pstep = make_multistream_step(cfg, "cpu")
    step = make_frame_step(cfg, "cpu")
    stagers = [FusedTracker(cfg, device="cpu", build_step=False)
               for _ in range(S)]
    states = stack_states([make_stream_state(cfg, "cpu") for _ in range(S)])
    solo = [make_stream_state(cfg, "cpu") for _ in range(S)]
    for f in range(3):
        per = []
        for t, ds in zip(stagers, dss):
            fd = ds[f]
            per.append({"rgb": torch.from_numpy(fd.rgb),
                        "depth_raw": torch.from_numpy(fd.depth_raw),
                        "flow": torch.from_numpy(fd.flow),
                        "seg": torch.from_numpy(fd.mask.astype(np.int32)),
                        "T_cw_gt": torch.from_numpy(t._gt_pose(
                            fd.pose_gt_raw))})
        u = stagers[0].frame_draws(f)
        inputs = {k: torch.stack([p[k] for p in per]) for k in per[0]}
        states, metrics, fleet = pstep(
            states, inputs, {k: v.expand((S,) + v.shape) for k, v in
                             u.items()}, f > 0)
        assert metrics["t_rpe"].shape == (S,)
        assert float(fleet["mean_t_rpe"]) == pytest.approx(
            float(metrics["t_rpe"].mean()))
        assert int(fleet["total_objects"]) == int(metrics["n_objects"].sum())
        for s in range(S):
            solo[s], m = step(solo[s], per[s], draws_mod.UniformDraws(u),
                              f > 0)
            assert int(metrics["n_inlier"][s]) == int(m["n_inlier"])
            np.testing.assert_allclose(states.frame.T_cw[s].numpy(),
                                       solo[s].frame.T_cw.numpy(), atol=1e-5)
            assert torch.equal(states.frame.static.valid[s],
                               solo[s].frame.static.valid)
    assert float(fleet["mean_t_rpe"]) < 0.2


def _random_jax_state(jcfg, seed):
    """A JAX stream state with seeded contents in every leaf."""
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == bool:
            return rng.random(x.shape) > 0.5
        if np.issubdtype(x.dtype, np.integer):
            return rng.integers(0, 9, x.shape).astype(x.dtype)
        return rng.random(x.shape).astype(x.dtype)

    return jax.tree.map(fill, jax.device_get(jax_state(jcfg)))


def test_state_from_numpy_on_a_stacked_jax_state():
    jcfg, cfg = tiny_pair()
    singles = [_random_jax_state(jcfg, s) for s in range(3)]
    stacked = jax.device_get(jax.tree.map(lambda *xs: jnp.stack(xs),
                                          *singles))
    state, init = state_from_numpy(stacked, "cpu")
    assert isinstance(state, StreamState)
    assert init == [bool(s["initialized"]) for s in singles]
    own = stack_states([state_from_numpy(s, "cpu")[0] for s in singles])
    empty = _flatten(make_stream_state(cfg, "cpu"))
    for a, b, e in zip(_flatten(state), _flatten(own), empty):
        assert a.shape == (3,) + e.shape and a.dtype == e.dtype
        assert torch.equal(a, b)
    np.testing.assert_array_equal(state.frame.dynamic.sem_label[1].numpy(),
                                  singles[1]["frame"].dynamic.sem_label)
    one, flag = state_from_numpy(singles[2], "cpu")
    assert isinstance(flag, bool) and one.slot_H.shape == empty[-2].shape


@pytest.fixture(scope="module")
def jax_pair():
    """The JAX and the port's MultiStreamSystem, S = 2, on two 96x64
    scenes under tpu_fast's wire, window BA off; and the JAX system's
    stacked state before its last frame."""
    from vdo_slam_tpu.io.dataset import SyntheticDataset as JDataset
    from vdo_slam_tpu.io.synthetic import make_scene as jmake_scene
    from vdo_slam_tpu.parallel import MultiStreamSystem as JMultiStreamSystem

    jcfg, cfg = tiny_pair(**WIRE)
    kw = dict(num_frames=6, width=96, height=64, num_objects=1)
    jdss = [JDataset(jmake_scene(seed=s, **kw), depth_map_factor=1.0, bf=40.0)
            for s in (1, 2)]
    pdss = [SyntheticDataset(make_scene(seed=s, **kw), depth_map_factor=1.0,
                             bf=40.0) for s in (1, 2)]
    n = len(pdss[0])
    jsys = JMultiStreamSystem(jcfg, n_streams=2, enable_local_ba=False,
                              devices=jax.devices()[:1])
    for i in range(n - 1):
        jsys.step_frame([d[i] for d in jdss])
    carried = jax.device_get(jsys.states)
    jsys.step_frame([d[n - 1] for d in jdss])
    psys = MultiStreamSystem(cfg, n_streams=2, enable_local_ba=False,
                             device="cpu")
    psys.run(pdss)
    return {"jsys": jsys, "psys": psys, "carried": carried, "pdss": pdss,
            "cfg": cfg, "n": n}


def test_port_system_against_jax_system(jax_pair):
    jm = jax_pair["jsys"].metrics()["per_stream"]
    pm = jax_pair["psys"].metrics()["per_stream"]
    for s in range(2):
        assert jax_pair["psys"].maps[s].num_frames == jax_pair["n"]
        assert pm[s]["cam_t_rpe"] < max(3.0 * jm[s]["cam_t_rpe"], 0.005)
        assert pm[s]["cam_r_rpe_deg"] < max(3.0 * jm[s]["cam_r_rpe_deg"],
                                            0.01)
        dt, dr = pose_gap(jax_pair["psys"].maps[s].cam_pose[-1],
                          jax_pair["jsys"].maps[s].cam_pose[-1])
        assert dt < 5 * T_TOL_M and dr < 5 * R_TOL_DEG, (dt, dr)


def test_batched_step_from_the_jax_stacked_state(jax_pair):
    """One port batched step from the JAX system's stacked state of the
    frame before against the JAX system's last frame."""
    psys, cfg, n = jax_pair["psys"], jax_pair["cfg"], jax_pair["n"]
    states, init = state_from_numpy(jax_pair["carried"], "cpu")
    assert init == [True, True]
    stagers = MultiStreamSystem(cfg, n_streams=2, enable_local_ba=False,
                                device="cpu")
    for i in range(n):       # the staging state (GT origin, gt_sems)
        staged = stagers._stage([d[i] for d in jax_pair["pdss"]])[0]
    staged.pop("_gts_host")
    states, vecs = psys.groups[0].step(states, staged,
                                       psys._frame_draws(n - 1)[0], True)
    for s in range(2):
        T_wc_jax = jax_pair["jsys"].maps[s].cam_pose[-1]
        dt, dr = pose_gap(np.linalg.inv(states.frame.T_cw[s].numpy()),
                          T_wc_jax)
        assert dt < T_TOL_M and dr < R_TOL_DEG, (dt, dr)
    assert vecs.shape[0] == 2 and torch.isfinite(vecs).all()
