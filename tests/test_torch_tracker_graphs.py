"""The host Tracker's per-stage programs (pipeline/tracking.py, each stage a
utils/cuda_graph.py:GraphedStage) on their CPU path: the stages run eagerly
on the same static input and output buffers the card's graphs run on, so
the overwriting of a stage's outputs by its next call happens here too.
Over 7 frames of a 96x64, 2-object scene:

  * the graphed stages bit-equal to the stage functions called directly
    (reports, archive, final state);
  * the graphed Tracker, replaying the JAX key chain, against the JAX
    package's Tracker, as tests/test_torch_tracking.py holds it: one port
    frame from each JAX Tracker state within all of that file's bounds;
    free-running, within its pose and object bounds and its frame-1
    inlier bound.  On this noise-free scene the two packages' pyramid
    resizes order frame 0's tied FAST scores differently (ROADMAP Queue
    3), so the free runs keep other points: 121 against 119 camera
    inliers at frame 2 and 123 against 121 at frame 3 (1.7 %), where
    test_torch_tracking's 320x240 run is back within 1 % after frame 1;
  * the last frame's pose that scene_flow and objects read is the last
    frame's, not the camera stage's output of this frame, which its call
    has overwritten: the frame state is copied out of the stage graphs;
  * a checkpoint saved mid-run and resumed, against the uninterrupted run;
  * the check that refuses draws made on demand on a card, and a stage
    called with other shapes than its first call's.
"""

import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_slice import JaxDraws, port_config
from tests.test_torch_tracking import STAGES as JAX_STAGES
from tests.test_torch_tracking import (FIRST_FRAME_FRAC, KeyChainTracker,
                                       check_frame, jax_payload,
                                       key_chain_draws)
from vdo_slam_tpu.config import KITTI as JKITTI
from vdo_slam_tpu.config import ShapeConfig as JShapeConfig
from vdo_slam_tpu.config import TrackingConfig as JTrackingConfig
from vdo_slam_tpu.config import VDOConfig as JVDOConfig
from vdo_slam_tpu.io.dataset import SyntheticDataset as JSyntheticDataset
from vdo_slam_tpu.io.synthetic import make_scene
from vdo_slam_tpu.pipeline.system import System as JaxSystem
from vdo_slam_tpu.pipeline.tracking import Tracker as JaxTracker
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.parallel.multistream import _flatten
from vdo_slam_tpu_torch.pipeline import System
from vdo_slam_tpu_torch.pipeline.draws import UniformDraws, frame_uniforms
from vdo_slam_tpu_torch.pipeline.tracking import check_stage_draws
from vdo_slam_tpu_torch.utils import checkpoint
from vdo_slam_tpu_torch.utils.cuda_graph import GraphedStage

N_FRAMES = 7
STAGES = ("_prepare", "_mask_prop", "_inherit", "_camera", "_scene_flow",
          "_objects", "_renew_static", "_renew_dynamic")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs this file in one of several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_config(w=96, h=64):
    """A 96x64 configuration whose host classifier keeps both objects of
    the scene (small object thresholds, a thin boundary band)."""
    cfg = JVDOConfig()
    return cfg.replace(
        camera=dataclasses.replace(cfg.camera, fx=float(w), fy=float(w),
                                   cx=w / 2.0, cy=h / 2.0, width=w, height=h,
                                   bf=40.0),
        tracking=dataclasses.replace(
            JTrackingConfig(), dataset=JKITTI, depth_map_factor=1.0,
            boundary_shrink_row=2, boundary_shrink_col=3,
            min_obj_points=12, min_init_inliers=6),
        shapes=JShapeConfig(max_static=128, max_dynamic=256, max_objects=4,
                            ransac_samples=32),
        frontend=dataclasses.replace(cfg.frontend, n_features=200,
                                     n_levels=2))


def plain_stages(tracker):
    """The tracker with each stage's function called directly (no static
    buffers) where its GraphedStage stood."""
    for name in STAGES:
        setattr(tracker, name, getattr(tracker, name).fn)
    return tracker


def _drive(sysm, ds, frames):
    return [sysm.track_rgbd(ds[f]) for f in frames]


@pytest.fixture(scope="module")
def runs():
    jcfg = jax_config()
    cfg = port_config(jcfg)
    # the last frame of a scene has no flow: N_FRAMES + 1 make N_FRAMES
    scene = make_scene(num_frames=N_FRAMES + 1, width=96, height=64,
                       num_objects=2, seed=2)
    ds = SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)
    assert len(ds) == N_FRAMES
    out = {"cfg": cfg, "ds": ds}
    for name in ("graphed", "direct"):
        sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                      device="cpu")
        if name == "direct":
            plain_stages(sysm.tracker)
        out[name] = (sysm, _drive(sysm, ds, range(N_FRAMES)))
    jsys = JaxSystem(jcfg, enable_local_ba=False, enable_global_ba=False)
    jds = JSyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)
    out["jax"] = jsys.run_sequence(jds)
    psys = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  device="cpu")
    psys.tracker = KeyChainTracker(cfg, jax.random.PRNGKey(jcfg.seed),
                                   game_map=psys.map, device="cpu")
    out["keychain"] = psys.run_sequence(ds)
    # the JAX run again, stepped through its compiled stages, each state
    # kept; one graphed port frame from each
    step = JaxTracker(jcfg)
    for name in JAX_STAGES:
        setattr(step, name, getattr(jsys.tracker, name))
    out["carried"] = []
    for f in range(N_FRAMES):
        payload = jax_payload(step)
        np.testing.assert_array_equal(step.grab_frame(jds[f])["T_cw"],
                                      out["jax"][f]["T_cw"])
        if f:
            tr = checkpoint.tracker_from_numpy(payload, cfg, device="cpu")
            _, draws = key_chain_draws(payload["key"], 4,
                                       cfg.shapes.max_objects)
            tr._frame_draws = lambda d=draws: d
            out["carried"].append(tr.grab_frame(ds[f]))
    return out


def _same_report(a, b):
    assert a["frame_id"] == b["frame_id"]
    for k in ("T_cw", "t_rpe", "r_rpe", "n_inlier_cam", "used_motion_model"):
        if k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(a["objects"]) == len(b["objects"])
    for oa, ob in zip(a["objects"], b["objects"]):
        assert oa.keys() == ob.keys()
        for k, v in ob.items():
            np.testing.assert_array_equal(oa[k], v, err_msg=k)


def _same_archive(ma, mb):
    for name in ("stat_xy", "stat_3d", "stat_valid", "dyn_xy", "dyn_3d",
                 "dyn_valid", "dyn_obj_label", "dyn_sem_label", "cam_pose",
                 "stat_assoc", "dyn_assoc"):
        for x, y in zip(getattr(ma, name), getattr(mb, name), strict=True):
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert ma.rm_label == mb.rm_label and ma.sem_label == mb.sem_label


def _same_state(a, b):
    for x, y in zip(_flatten(a), _flatten(b), strict=True):
        assert torch.equal(x, y)


def test_graphed_stages_equal_direct_calls(runs):
    (gs, greps), (ds_, dreps) = runs["graphed"], runs["direct"]
    assert all(isinstance(getattr(gs.tracker, n), GraphedStage)
               and getattr(gs.tracker, n).inputs is not None for n in STAGES)
    for a, b in zip(greps, dreps, strict=True):
        _same_report(a, b)
    _same_archive(gs.map, ds_.map)
    _same_state(gs.tracker.state, ds_.tracker.state)
    assert torch.equal(gs.tracker._last_seg, ds_.tracker._last_seg)
    assert torch.equal(gs.tracker._last_flow, ds_.tracker._last_flow)
    # both objects are tracked from frame 1 on
    assert all(sum(o["status"] for o in r["objects"]) == 2
               for r in greps[1:])
    assert gs.metrics() == ds_.metrics()


def test_graphed_tracker_frame_from_each_jax_state(runs):
    for port, ref in zip(runs["carried"], runs["jax"][1:], strict=True):
        check_frame(port, ref)
    assert sum(o["status"] for r in runs["jax"] for o in r["objects"]) >= 8


def test_graphed_tracker_free_run_against_jax(runs):
    for port, ref in zip(runs["keychain"], runs["jax"], strict=True):
        check_frame(port, ref, FIRST_FRAME_FRAC)


def test_last_pose_is_the_last_frames(runs):
    """scene_flow and objects read last.T_cw from the frame state: the
    last frame's pose, which this frame's camera call, having overwritten
    its output buffer, no longer holds.  Were the state the camera
    graph's output itself, both would read this frame's pose twice."""
    cfg, ds = runs["cfg"], runs["ds"]
    sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  device="cpu")
    tr = sysm.tracker
    seen = []
    for name, last_at, cur_at in (("_scene_flow", 4, 5), ("_objects", 9, 10)):
        stage = getattr(tr, name)

        def spy(*args, _stage=stage, _name=name, _l=last_at, _c=cur_at,
                **kw):
            seen.append((_name, tr.frame_id, args[_l].clone(),
                         args[_c].clone()))
            return _stage(*args, **kw)

        setattr(tr, name, spy)
    reps = _drive(sysm, ds, range(N_FRAMES))
    assert len(seen) == 2 * (N_FRAMES - 1)
    for name, f, last, cur in seen:
        np.testing.assert_array_equal(last.numpy(), reps[f - 1]["T_cw"],
                                      err_msg=f"{name}, frame {f}")
        np.testing.assert_array_equal(cur.numpy(), reps[f]["T_cw"])
        assert not torch.equal(last, cur), (name, f)
    # the camera stage's static output is this frame's pose, the kept
    # state's the same values in a buffer of the tracker's own
    cam_out = tr._camera.call._static_out.tree["T_cw"]
    kept = tr._frame.tree["state"].T_cw
    assert torch.equal(cam_out, kept)
    assert cam_out.untyped_storage().data_ptr() != \
        kept.untyped_storage().data_ptr()


def test_checkpoint_resumed_mid_run(runs, tmp_path):
    cfg, ds = runs["cfg"], runs["ds"]
    gs, greps = runs["graphed"]
    first = System(cfg, enable_local_ba=False, enable_global_ba=False,
                   device="cpu")
    _drive(first, ds, range(3))
    checkpoint.save_checkpoint(first.tracker, tmp_path / "ck.pkl")
    with open(tmp_path / "ck.pkl", "rb") as fh:
        assert pickle.load(fh)["frame_id"] == 3
    resumed = System(cfg, enable_local_ba=False, enable_global_ba=False,
                     device="cpu")
    checkpoint.load_checkpoint(resumed.tracker, tmp_path / "ck.pkl")
    for a, b in zip(_drive(resumed, ds, range(3, N_FRAMES)), greps[3:],
                    strict=True):
        _same_report(a, b)
    _same_state(resumed.tracker.state, gs.tracker.state)
    _same_archive(resumed.map, gs.map)


def test_stage_draws_check():
    """On a card the stage graphs take a UniformDraws only (draws made on
    demand, as JaxDraws makes them, would be baked into the capture); on
    the CPU any FrameDraws runs."""
    cfg = port_config(jax_config())
    uniform = UniformDraws(frame_uniforms(cfg, 1, torch.Generator()))
    on_demand = JaxDraws(jax.random.PRNGKey(0), True, 4)
    for dev in ("cpu", "cuda"):
        check_stage_draws(uniform, dev)
    check_stage_draws(on_demand, "cpu")
    with pytest.raises(ValueError, match="UniformDraws"):
        check_stage_draws(on_demand, "cuda")


def test_graphed_stage_refuses_other_shapes():
    stage = GraphedStage(lambda x, y: {"s": x + y}, "cpu", "add")
    a = stage(torch.ones(3), torch.ones(3))
    b = stage(torch.zeros(3), torch.full((3,), 2.0))
    assert a is b and torch.equal(b["s"], torch.full((3,), 2.0))
    with pytest.raises(ValueError, match="add"):
        stage(torch.ones(4), torch.ones(4))
    with pytest.raises(ValueError, match="add"):
        stage(torch.ones(3, dtype=torch.float64), torch.ones(3))
