"""The stages under the options of this slice, held stage by stage to the
JAX package's: every stage call the JAX host Tracker makes over four
frames of the 320x240 `small_config` scene is recorded (its inputs, its
key and its outputs), and the port's stage is called on the same inputs
with draws replayed from the same key.

Options:
  * nonjoint: joint_flow=False with depth_noise (the reprojection-only
    camera solve with its depth-noise draw, and the uncompacted object
    route without a robust kernel);
  * distorted_sampled: the scene rendered through a barrel lens with
    k1/k2 configured (the stages' warps: prepare's pinhole banks, mask
    propagation, inheritance and both renewal criteria) and grid-sampled
    keypoints (use_sample_feature; no FAST score, so prepare is
    deterministic and compared whole).
Full sequences under these options are `slow` in the JAX package's own
tests (tests/test_pipeline_e2e.py:172,238,287); these runs stay at stage
level and four frames.

Tolerances: labels, masks and integer outputs equal; pixel coordinates
through the warps within 2e-4 px (tests/test_torch_undistort.py); depths
and other floats within 1e-5 relative; camera poses within 1e-4 m and
1e-3 deg; object motions within 1e-3 m and 0.01 deg (the planar objects'
6x6 systems are ill-conditioned, ROADMAP Queue 3: the two packages' fp32
sums land 3e-4 m and 1.1e-3 deg apart).  Under distortion, an object
candidate sampled at an integer pixel comes back from the pinhole round
trip within an ulp of that pixel's edge, and the int-truncating gather may
take the neighbouring pixel in one package and not the other: up to
EDGE_FRAC of a bank's rows may hold such a neighbour's depth, world point
or flow, within EDGE_REL (EDGE_PX for pixel values) of each other.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_e2e import small_config
from tests.test_torch_slice import JaxDraws, pose_gap, port_config
from vdo_slam_tpu.io.dataset import SyntheticDataset
from vdo_slam_tpu.io.synthetic import make_scene
from vdo_slam_tpu.ops import fast as jfast
from vdo_slam_tpu.pipeline import System as JaxSystem
from vdo_slam_tpu_torch.ops import fast as pfast
from vdo_slam_tpu_torch.pipeline import stages
from vdo_slam_tpu_torch.pipeline import state as pstate

DIST = (-0.28, 0.07, 0.0, 0.0, 0.0)
N_FRAMES = 4
PX_TOL, REL_TOL, T_TOL_M, R_TOL_DEG = 2e-4, 1e-5, 1e-4, 1e-3
H_TOL_M, H_TOL_DEG = 1e-3, 0.01
EDGE_FRAC, EDGE_REL, EDGE_PX = 0.01, 1e-3, 0.05
STAGES = ("_prepare", "_mask_prop", "_inherit", "_camera", "_scene_flow",
          "_objects", "_renew_static", "_renew_dynamic")
# which key of the host Tracker's chain a stage is handed
KEY_ROLE = {"_prepare": "k1", "_camera": "k2", "_objects": "k3",
            "_renew_dynamic": "k4"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def option_config(name):
    """(JAX config, dataset) of an option."""
    if name == "nonjoint":
        scene = make_scene(num_frames=N_FRAMES + 1, width=320, height=240,
                           num_objects=2, seed=3)
        cfg = small_config(scene, joint_flow=False, depth_noise=True)
    else:
        scene = make_scene(num_frames=N_FRAMES + 1, width=320, height=240,
                           num_objects=2, seed=3, dist=DIST)
        cfg = small_config(scene)
        cfg = cfg.replace(
            camera=dataclasses.replace(cfg.camera, k1=DIST[0], k2=DIST[1]),
            frontend=dataclasses.replace(cfg.frontend,
                                         use_sample_feature=True,
                                         n_sample_points=1500))
    return cfg, SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)


@pytest.fixture(scope="module", params=["nonjoint", "distorted_sampled"])
def recorded(request):
    """The JAX Tracker's stage calls over N_FRAMES frames, and the port's
    stages for the same configuration."""
    jcfg, ds = option_config(request.param)
    sysm = JaxSystem(jcfg, enable_local_ba=False, enable_global_ba=False)
    calls = []
    for name in STAGES:
        fn = getattr(sysm.tracker, name)

        def wrapped(*args, _fn=fn, _name=name):
            out = _fn(*args)
            calls.append((_name, jax.device_get(args), jax.device_get(out)))
            return out

        setattr(sysm.tracker, name, wrapped)
    sysm.run_sequence(ds, max_frames=N_FRAMES)
    cfg = port_config(jcfg)
    dev = "cpu"
    renew_s, renew_d = stages.make_renew_stage(cfg, dev)
    port = {"_prepare": stages.make_prepare(cfg, dev),
            "_mask_prop": stages.make_mask_prop(cfg, dev),
            "_inherit": stages.make_inherit(cfg, dev),
            "_camera": stages.make_camera_stage(cfg, dev),
            "_scene_flow": stages.make_scene_flow(cfg, dev),
            "_objects": stages.make_objects_stage(cfg, dev),
            "_renew_static": renew_s, "_renew_dynamic": renew_d}
    return request.param, cfg, calls, port


def to_torch(x):
    """A JAX stage input pulled to numpy -> the port's (banks by name)."""
    if isinstance(x, dict):
        return {k: to_torch(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_torch(v) for v in x]
    if dataclasses.is_dataclass(x):
        cls = getattr(pstate, type(x).__name__)
        return cls(**{f.name: to_torch(getattr(x, f.name))
                      for f in dataclasses.fields(cls)})
    return torch.from_numpy(np.array(x))


def leaves(x, prefix=""):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from leaves(v, f"{prefix}{k}.")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from leaves(v, f"{prefix}{i}.")
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from leaves(getattr(x, f.name), f"{prefix}{f.name}.")
    else:
        yield prefix[:-1], np.asarray(x)


PIXEL_LEAVES = ("xy", "corres", "flow", "uv_cur", "det_xy")


def check_leaves(port_out, ref_out, skip=(), edge=False):
    port = dict(leaves(port_out))
    ref = dict(leaves(ref_out))
    assert set(ref) <= set(port), set(ref) - set(port)
    for k, r in ref.items():
        if any(k == s or k.startswith(s + ".") for s in skip):
            continue
        p = port[k]
        assert p.shape == r.shape, k
        if r.dtype.kind in "biu":
            np.testing.assert_array_equal(p, r, err_msg=k)
            continue
        pixel = k.split(".")[-1] in PIXEL_LEAVES
        atol, rtol = (PX_TOL, 0.0) if pixel else (1e-6, REL_TOL)
        close = np.isclose(p, r, atol=atol, rtol=rtol)
        if edge and r.ndim:
            rows = close.reshape(r.shape[0], -1).all(axis=1)
            assert (~rows).mean() <= EDGE_FRAC, (k, int((~rows).sum()))
            np.testing.assert_allclose(
                p[~rows], r[~rows], err_msg=k,
                **(dict(atol=EDGE_PX, rtol=0) if pixel
                   else dict(atol=1e-6, rtol=EDGE_REL)))
        else:
            np.testing.assert_allclose(p, r, atol=atol, rtol=rtol, err_msg=k)


def run_port(port, n_slots, name, args):
    args = list(args)
    if name in KEY_ROLE:
        key = jnp.asarray(args.pop())
        draws = JaxDraws.from_keys(n_slots, **{KEY_ROLE[name]: key})
        return port[name](*to_torch(args), draws)
    return port[name](*to_torch(args))


def test_every_stage_called(recorded):
    _, _, calls, _ = recorded
    names = [c[0] for c in calls]
    assert names.count("_prepare") == N_FRAMES
    for name in STAGES[1:]:
        assert names.count(name) == N_FRAMES - 1, name


@pytest.mark.parametrize("stage", ["_prepare", "_mask_prop", "_inherit",
                                   "_scene_flow", "_renew_static",
                                   "_renew_dynamic"])
def test_stage_matches_jax(recorded, stage):
    option, cfg, calls, port = recorded
    n = 0
    for name, args, ref in calls:
        if name != stage:
            continue
        out = run_port(port, cfg.shapes.max_objects, name, args)
        skip = ()
        if name == "_prepare" and option == "nonjoint":
            # FAST detections reorder tied scores between the packages'
            # pyramid resizes (ROADMAP Queue 3): only the rest is held
            skip = ("stat_cand", "det_xy", "det_valid", "det_score")
        check_leaves(out, ref, skip, edge=option == "distorted_sampled")
        n += 1
    assert n


def test_camera_matches_jax(recorded):
    _, cfg, calls, port = recorded
    for name, args, ref in calls:
        if name != "_camera":
            continue
        out = run_port(port, cfg.shapes.max_objects, name, args)
        dt, dr = pose_gap(out["T_cw"].numpy(), ref["T_cw"])
        assert dt < T_TOL_M and dr < R_TOL_DEG, (dt, dr)
        np.testing.assert_array_equal(out["inlier"].numpy(), ref["inlier"])
        np.testing.assert_array_equal(out["init_inlier"].numpy(),
                                      ref["init_inlier"])
        np.testing.assert_allclose(out["uv_cur"].numpy(), ref["uv_cur"],
                                   atol=PX_TOL, rtol=0)
        assert int(out["n_inlier"]) == int(ref["n_inlier"]) > 100


def test_objects_match_jax(recorded):
    _, cfg, calls, port = recorded
    n_active = 0
    for name, args, ref in calls:
        if name != "_objects":
            continue
        out = run_port(port, cfg.shapes.max_objects, name, args)
        active = np.asarray(args[5])               # slot_active
        np.testing.assert_array_equal(out["n_init"].numpy(), ref["n_init"])
        np.testing.assert_array_equal(out["members"].numpy(), ref["members"])
        np.testing.assert_array_equal(out["inlier"].numpy(), ref["inlier"])
        for k in np.flatnonzero(active):
            dt, dr = pose_gap(out["H"][k].numpy(), ref["H"][k])
            assert dt < H_TOL_M and dr < H_TOL_DEG, (k, dt, dr)
            n_active += 1
        np.testing.assert_allclose(out["uv_cur"].numpy(), ref["uv_cur"],
                                   atol=PX_TOL, rtol=0)
    assert n_active >= 2 * (N_FRAMES - 1) - 2


def test_grid_sample_keypoints_matches_jax():
    key = jax.random.PRNGKey(5)
    n, n_div = 1500, 20
    ref_xy, ref_v = jfast.grid_sample_keypoints(key, 240, 320, n=n,
                                                n_div=n_div)
    draws = JaxDraws.from_keys(1, k1=key)
    draws.k_det = key   # the key grid_sample_keypoints splits (fast.py:211)
    offs = draws.sample_offsets(n_div, pfast.sample_cells(n, n_div))
    xy, v = pfast.grid_sample_keypoints(offs, 240, 320, n=n, n_div=n_div)
    np.testing.assert_array_equal(xy.numpy(), np.asarray(ref_xy))
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    assert xy.shape == (n, 2) and 0.9 * n < int(v.sum()) <= n
