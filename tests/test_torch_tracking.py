"""The port's host Tracker (System mode "reference", the default) against
the JAX package's, on the run of tests/conftest.py:tracked_session: the
8-frame, 320x240, 2-object scene under `small_config`, reference mode,
BA off.  That run is repeated here frame by frame, through the session's
compiled stages, so that each JAX Tracker state is kept (as numpy, by
name); it equals the session's run.

The port replays the JAX key chain (PRNGKey(seed), one split per
`_next_key`: prepare, camera, objects and renewal keys of each frame)
through an overridden `_frame_draws`.  Two comparisons:
  * free-running: the port's System over the same frames;
  * carried: one port frame from each JAX Tracker state, built with
    `utils.checkpoint.tracker_from_numpy`.
Per frame: T_cw within 1e-3 m and 0.01 deg; the same (model_label,
sem_label, status) per object; each tracked object's H translation within
5e-3 m; camera inliers within 1 %, except at frame 1 of the free run.
There the frame-0 detections of the two packages differ by the FAST score
ties their pyramid resizes reorder (ROADMAP Queue 3), so the same RANSAC
draws pick other points of the static bank: 586 against 542 inliers on
this scene, held within FIRST_FRAME_FRAC; the carried frame 1, from the
JAX state, gives 542 as the JAX frame does.  The free-running metrics stay
under the bounds tests/test_torch_slice.py holds the fused path to.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_slice import JaxDraws, pose_gap, port_config
from vdo_slam_tpu.pipeline.tracking import Tracker as JaxTracker
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.pipeline import System, Tracker
from vdo_slam_tpu_torch.utils.checkpoint import tracker_from_numpy

T_TOL_M, R_TOL_DEG, H_TOL_M, INLIER_FRAC = 1e-3, 0.01, 5e-3, 0.01
FIRST_FRAME_FRAC = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def key_chain_draws(key, n_keys: int, n_slots: int):
    """(next key, FrameDraws) of a frame that takes n_keys keys from the
    chain, as the JAX Tracker's _next_key takes them."""
    ks = []
    for _ in range(n_keys):
        key, k = jax.random.split(key)
        ks.append(k)
    return key, JaxDraws.from_keys(n_slots, *ks)


class KeyChainTracker(Tracker):
    """The port's Tracker drawing what the JAX Tracker draws."""

    def __init__(self, cfg, key, **kwargs):
        super().__init__(cfg, **kwargs)
        self.key = key

    def _frame_draws(self):
        self.key, draws = key_chain_draws(
            self.key, 1 if self.frame_id == 0 else 4,
            self.cfg.shapes.max_objects)
        return draws


def jax_payload(tr):
    """The JAX Tracker's state as numpy, by name (what
    vdo_slam_tpu/utils/checkpoint.py saves, without the map)."""
    return {
        "frame_id": tr.frame_id, "max_id": tr.max_id,
        "origin_inv": tr.origin_inv,
        "state": jax.device_get(tr.state) if tr.state is not None else None,
        "last_sem": tr._last_sem, "last_obj_rows": tr._last_obj_rows,
        "last_seg": (np.asarray(tr._last_seg) if tr._last_seg is not None
                     else None),
        "last_flow": (np.asarray(tr._last_flow) if tr._last_flow is not None
                      else None),
        "tracks": [(t.model_label, t.sem_label, np.asarray(t.H), t.active)
                   for t in tr._last_tracks],
        "key": np.asarray(tr.key),
    }


STAGES = ("_prepare", "_mask_prop", "_inherit", "_camera", "_scene_flow",
          "_objects", "_renew_static", "_renew_dynamic", "_init_banks")


@pytest.fixture(scope="module")
def runs(tracked_session):
    jsys = tracked_session["sysm"]
    jcfg = tracked_session["cfg"]
    cfg = port_config(jcfg)
    ds = SyntheticDataset(tracked_session["scene"], depth_map_factor=1.0,
                          bf=40.0)
    jreps = tracked_session["reports"]
    # the session's run again, stepped, its state kept before each frame
    step = JaxTracker(jcfg)
    for name in STAGES:
        setattr(step, name, getattr(jsys.tracker, name))
    payloads = []
    for f in range(len(ds)):
        payloads.append(jax_payload(step))
        rep = step.grab_frame(ds[f])
        np.testing.assert_array_equal(rep["T_cw"], jreps[f]["T_cw"])
    psys = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  device="cpu")
    psys.tracker = KeyChainTracker(cfg, jax.random.PRNGKey(jcfg.seed),
                                   game_map=psys.map, device="cpu")
    preps = psys.run_sequence(ds)
    carried = []
    for f in range(1, len(ds)):
        tr = tracker_from_numpy(payloads[f], cfg, device="cpu")
        _, draws = key_chain_draws(payloads[f]["key"], 4,
                                   cfg.shapes.max_objects)
        tr._frame_draws = lambda d=draws: d
        carried.append(tr.grab_frame(ds[f]))
    return {"jax": jreps, "port": preps, "carried": carried,
            "jax_metrics": jsys.metrics(), "port_metrics": psys.metrics(),
            "port_system": psys, "n": len(ds)}


def check_frame(port, ref, inlier_frac=INLIER_FRAC):
    assert port["frame_id"] == ref["frame_id"]
    dt, dr = pose_gap(port["T_cw"], ref["T_cw"])
    assert dt < T_TOL_M and dr < R_TOL_DEG, (ref["frame_id"], dt, dr)

    def ids(rep):
        return [(o["model_label"], o["sem_label"], o["status"])
                for o in rep["objects"]]

    assert ids(port) == ids(ref), (ids(port), ids(ref))
    for po, ro in zip(port["objects"], ref["objects"]):
        if ro["status"]:
            gap = np.linalg.norm(np.asarray(po["H"])[:3, 3]
                                 - np.asarray(ro["H"])[:3, 3])
            assert gap < H_TOL_M, (ref["frame_id"], ro["sem_label"], gap)
    if "n_inlier_cam" in ref:
        n_p, n_j = port["n_inlier_cam"], ref["n_inlier_cam"]
        assert abs(n_p - n_j) <= inlier_frac * n_j, (n_p, n_j)


def test_free_running_frames_agree(runs):
    assert len(runs["port"]) == len(runs["jax"]) == runs["n"]
    for port, ref in zip(runs["port"], runs["jax"]):
        check_frame(port, ref, FIRST_FRAME_FRAC if ref["frame_id"] == 1
                    else INLIER_FRAC)
    # objects really are tracked on both sides
    assert sum(o["status"] for r in runs["jax"] for o in r["objects"]) >= 8


def test_frame_from_each_jax_state(runs):
    assert len(runs["carried"]) == runs["n"] - 1
    for port, ref in zip(runs["carried"], runs["jax"][1:]):
        check_frame(port, ref)


def test_reports_have_the_jax_fields(runs):
    ref = runs["jax"][3]
    port = runs["port"][3]
    assert set(port) == set(ref)
    assert set(port["objects"][0]) == set(ref["objects"][0])
    assert port["timings_ms"].shape == (5,)


def test_system_metrics_within_bounds(runs):
    rep, ref = runs["port_metrics"], runs["jax_metrics"]
    assert rep["cam_t_rpe"] < max(3.0 * ref["cam_t_rpe"], 0.005), (rep, ref)
    assert rep["cam_r_rpe_deg"] < max(3.0 * ref["cam_r_rpe_deg"], 0.01)
    assert rep["obj_t_rpe"] < 0.02, rep
    assert rep["n_obj_estimates"] == ref["n_obj_estimates"] > 0
    t = runs["port_system"].timing()
    assert t["camera_est_ms"] > 0 and t["obj_est_ms"] > 0
