"""The port's jax-free host layer against the JAX package's originals, the
System's refusals, and a run of the port with jax and flax unimportable.

Tolerance: exact (these are copies of numpy code; the same inputs must give
the same arrays and numbers).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from vdo_slam_tpu import config as jconfig
from vdo_slam_tpu.eval import results as jresults
from vdo_slam_tpu.io import dataset as jdataset
from vdo_slam_tpu.io import synthetic as jsynthetic
from vdo_slam_tpu.pipeline import map_state as jmap_state
from vdo_slam_tpu.pipeline import tracking as jtracking
from vdo_slam_tpu_torch import config as pconfig
from vdo_slam_tpu_torch.eval import results as presults
from vdo_slam_tpu_torch.io import dataset as pdataset
from vdo_slam_tpu_torch.io import flo as pflo
from vdo_slam_tpu_torch.io import synthetic as psynthetic
from vdo_slam_tpu_torch.pipeline import map_state as pmap_state
from vdo_slam_tpu_torch.pipeline import tracking as ptracking

REPO = Path(__file__).resolve().parent.parent


def test_make_scene_identical():
    a = psynthetic.make_scene(num_frames=3, width=320, height=240, seed=3)
    b = jsynthetic.make_scene(num_frames=3, width=320, height=240, seed=3)
    for f in dataclasses.fields(b):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))


@pytest.mark.parametrize("cls", [pdataset.SyntheticDataset,
                                 pdataset.SyntheticOMDDataset])
def test_datasets_identical(cls):
    scene = psynthetic.make_scene(num_frames=3, width=64, height=48, seed=1)
    ref_cls = getattr(jdataset, cls.__name__)
    a, b = cls(scene, 256.0, 387.5744), ref_cls(scene, 256.0, 387.5744)
    assert len(a) == len(b) == 2
    for i in range(2):
        fa, fb = a[i], b[i]
        for f in dataclasses.fields(fb):
            np.testing.assert_array_equal(getattr(fa, f.name),
                                          getattr(fb, f.name))


def test_config_dataclasses_agree():
    """Field by field, the port's own fields (config.PORT_ONLY) aside,
    which must hold the value that does what the JAX package does."""
    pc, jc = pconfig.VDOConfig(), jconfig.VDOConfig()
    assert pconfig.jax_fields(pc) == dataclasses.asdict(jc)
    assert (pconfig.jax_fields(pconfig.tpu_fast(pc))
            == dataclasses.asdict(jconfig.tpu_fast(jc)))
    odd = pc.replace(tracking=dataclasses.replace(pc.tracking,
                                                  wire_depth_steps=64))
    with pytest.raises(ValueError, match="wire_depth_steps"):
        pconfig.jax_fields(odd)
    assert (pconfig.KITTI, pconfig.OMD, pconfig.VIRTUAL_KITTI) == (
        jconfig.KITTI, jconfig.OMD, jconfig.VIRTUAL_KITTI)


def test_load_settings_agrees(tmp_path):
    y = tmp_path / "settings.yaml"
    y.write_text(
        "%YAML:1.0\n\nCamera.fx: 500.0\nCamera.fy: 501.0\nCamera.cx: 320.0\n"
        "Camera.cy: 240.0\nCamera.bf: 40.0\nChooseData: 2\nWINDOW_SIZE: 10\n"
        "OVERLAP_SIZE: 2\nMaxTrackPointBG: 600\nORBextractor.nFeatures: 1000\n")
    assert (pconfig.jax_fields(pconfig.load_settings(y))
            == dataclasses.asdict(jconfig.load_settings(y)))


def test_pose_helpers_identical():
    rng = np.random.default_rng(0)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    T[:3, 3] = rng.normal(size=3)
    row = rng.normal(size=10).astype(np.float32)
    np.testing.assert_array_equal(ptracking._np_inv(T), jtracking._np_inv(T))
    np.testing.assert_array_equal(ptracking.obj_pose_parsing_kt(row),
                                  jtracking.obj_pose_parsing_kt(row))
    np.testing.assert_array_equal(ptracking.obj_pose_parsing_ox(row, T),
                                  jtracking.obj_pose_parsing_ox(row, T))


def _hand_built_map(mod):
    """A 4-frame MapState with two object tracks, built by hand."""
    rng = np.random.default_rng(5)

    def pose(scale):
        T = np.eye(4, dtype=np.float32)
        w = rng.normal(size=3) * scale
        th = np.linalg.norm(w)
        k = w / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        T[:3, :3] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        T[:3, 3] = rng.normal(size=3)
        return T

    m = mod.MapState()
    for f in range(4):
        m.cam_pose.append(pose(0.05))
        m.cam_pose_rf.append(m.cam_pose[-1].copy())
        m.cam_pose_gt.append(pose(0.05))
        m.stat_valid.append(rng.random(20) > 0.2)
        m.dyn_valid.append(rng.random(20) > 0.2)
        m.dyn_obj_label.append(rng.integers(-2, 3, 20).astype(np.int32))
        m.timings.append(rng.random(5).astype(np.float32))
        if f == 0:
            continue
        m.stat_assoc.append(rng.integers(-1, 20, 20).astype(np.int32))
        m.dyn_assoc.append(rng.integers(-1, 20, 20).astype(np.int32))
        mots = [pose(0.01), pose(0.01), pose(0.01)]
        m.rigid_motion.append(mots)
        m.rigid_motion_rf.append([x.copy() for x in mots])
        m.rigid_motion_gt.append([pose(0.01) for _ in range(3)])
        m.obj_pose_pre.append([pose(0.3) for _ in range(3)])
        m.rm_label.append([0, 1, 2])
        m.sem_label.append([0, 1, 2])
        m.obj_stat.append([True, True, f != 2])
        m.centres.append([np.zeros(3), rng.normal(size=3), rng.normal(size=3)])
        m.sm_label_gt.append([1, 2])
    # feature banks for the full-BA graph, from a generator of their own so
    # the draws above stay as they were
    rng = np.random.default_rng(6)
    for f in range(4):
        for kind in ("stat", "dyn"):
            xy = rng.uniform((0, 0), (1242, 375), (20, 2)).astype(np.float32)
            getattr(m, kind + "_xy").append(xy)
            getattr(m, kind + "_depth").append(
                rng.uniform(5, 30, 20).astype(np.float32))
            getattr(m, kind + "_3d").append(
                rng.normal(0, 5, (20, 3)).astype(np.float32))
    return m


@pytest.mark.parametrize("refined,rms", [(False, False), (True, True)])
def test_metric_report_agrees(refined, rms):
    a = presults.metric_report(_hand_built_map(pmap_state), refined, rms)
    b = jresults.metric_report(_hand_built_map(jmap_state), refined, rms)
    assert a == b and a["n_obj_estimates"] == 5


def test_timing_tracklets_and_files_agree(tmp_path):
    pm, jm = _hand_built_map(pmap_state), _hand_built_map(jmap_state)
    assert presults.timing_summary(pm) == jresults.timing_summary(jm)
    a = pmap_state.build_tracklets(pm.dyn_assoc, pm.dyn_valid, pm.dyn_obj_label)
    b = jmap_state.build_tracklets(jm.dyn_assoc, jm.dyn_valid, jm.dyn_obj_label)
    assert a == b
    presults.save_results(pm, tmp_path / "port")
    jresults.save_results(jm, tmp_path / "jax")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for n in names:
        assert ((tmp_path / "port" / n).read_text()
                == (tmp_path / "jax" / n).read_text()), n
    # after one full-BA iteration in each package, the g2o dump of the
    # optimized graph: the same edge lines, and vertex values within 2e-3
    # (fp32 solves of this random, ill-posed graph drift up to ~3e-4 apart)
    from vdo_slam_tpu.backend.full_ba import full_ba_inplace as jfull_ba
    from vdo_slam_tpu_torch.backend.full_ba import full_ba_inplace as pfull_ba

    pfull_ba(pm, pconfig.VDOConfig(), iters=1, device="cpu")
    jfull_ba(jm, jconfig.VDOConfig(), iters=1)
    presults.save_results(pm, tmp_path / "port_ba")
    jresults.save_results(jm, tmp_path / "jax_ba")
    name = "dynamic_slam_graph_after_opt.g2o"
    a = (tmp_path / "port_ba" / name).read_text().splitlines()
    b = (tmp_path / "jax_ba" / name).read_text().splitlines()
    assert len(a) == len(b) and len(b) > 40
    tags = set()
    for la, lb in zip(a, b):
        ta, tb = la.split(), lb.split()
        assert ta[0] == tb[0] and len(ta) == len(tb), (la, lb)
        if ta[0].startswith("EDGE"):  # from the graph: built identically
            assert la == lb
        else:
            assert ta[1] == tb[1], (la, lb)
            np.testing.assert_allclose(np.float64(ta[2:]), np.float64(tb[2:]),
                                       atol=2e-3, err_msg=la)
        tags.add(ta[0])
    assert tags == {"VERTEX_SE3:QUAT", "VERTEX_TRACKXYZ", "EDGE_SE3:QUAT",
                    "EDGE_SE3_TRACKXYZ"}


def test_flo_roundtrip(tmp_path):
    from vdo_slam_tpu.io import flo as jflo

    flow = np.random.default_rng(2).normal(size=(5, 7, 2)).astype(np.float32)
    pflo.write_flo(tmp_path / "a.flo", flow)
    np.testing.assert_array_equal(jflo.read_flo(tmp_path / "a.flo"), flow)
    np.testing.assert_array_equal(pflo.read_flo(tmp_path / "a.flo"), flow)


class TestRefusals:
    """Options that were outside the port once and are ported now are
    taken: the default mode "reference" and every configuration option of
    the JAX stages.  Nothing of System raises NotImplementedError now."""

    @staticmethod
    def _cfg(**tracking):
        cfg = pconfig.VDOConfig()
        return cfg.replace(tracking=dataclasses.replace(cfg.tracking,
                                                        **tracking))

    @pytest.mark.parametrize("kwargs,word", [
        (dict(enable_local_ba=False, enable_global_ba=False), "mode"),
    ])
    def test_system_options(self, kwargs, word):
        from vdo_slam_tpu_torch.pipeline import System, Tracker

        # the default `mode` is "reference": the host Tracker
        sysm = System(pconfig.VDOConfig(), device="cpu", **kwargs)
        assert isinstance(sysm.tracker, Tracker)
        assert sysm.tracker.device.type == "cpu"

    @pytest.mark.parametrize("change,word", [
        (dict(camera=dict(k1=-0.28)), "distortion"),
        (dict(frontend=dict(use_sample_feature=True)), "use_sample_feature"),
        (dict(tracking=dict(joint_flow=False)), "joint_flow"),
        (dict(tracking=dict(wire_flow_half=True)), "wire_flow_half"),
        (dict(tracking=dict(wire_flow_down=4)), "wire_flow_down"),
        (dict(tracking=dict(wire_flow_half=True, wire_entropy=True)),
         "wire_entropy"),
        (dict(tracking=dict(fused_chunk=4)), "fused_chunk"),
    ])
    def test_configs(self, change, word):
        from vdo_slam_tpu_torch.pipeline import System

        cfg = pconfig.VDOConfig()
        cfg = cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                             for k, v in change.items()})
        # every option is taken, and the trackers of both modes are built
        # for it
        sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                      mode="fused", device="cpu")
        assert sysm.tracker.chunk == cfg.tracking.fused_chunk
        assert sysm.cfg.tracking.flow_down == cfg.tracking.flow_down
        ref = System(cfg, enable_local_ba=False, enable_global_ba=False,
                     device="cpu")
        assert ref.cfg == cfg and ref.tracker.frame_id == 0


def test_entry_points_default_to_the_card():
    """With no device given, System (and the FusedTracker, frame step and
    stream state under it) runs on "cuda"; without a card it raises rather
    than run on the CPU."""
    import torch

    from vdo_slam_tpu_torch.pipeline import System

    args = (pconfig.VDOConfig(),)
    kwargs = dict(enable_local_ba=False, enable_global_ba=False, mode="fused")
    if torch.cuda.is_available():
        sysm = System(*args, **kwargs)
        assert sysm.tracker.device.type == "cuda"
        assert sysm.tracker.state.frame.T_cw.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            System(*args, **kwargs)


NO_JAX = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import dataclasses
import vdo_slam_tpu_torch
import vdo_slam_tpu_torch.backend
from vdo_slam_tpu_torch.config import VDOConfig, ShapeConfig
from vdo_slam_tpu_torch.io import SyntheticDataset, make_scene
from vdo_slam_tpu_torch.pipeline import System

scene = make_scene(num_frames=3, width=96, height=64, num_objects=1, seed=0)
cfg = VDOConfig()
cfg = cfg.replace(
    camera=dataclasses.replace(cfg.camera, fx=96.0, fy=96.0, cx=48.0, cy=32.0,
                               width=96, height=64, bf=40.0),
    tracking=dataclasses.replace(cfg.tracking, depth_map_factor=1.0),
    shapes=ShapeConfig(max_static=64, max_dynamic=128, max_objects=2,
                       ransac_samples=16),
    frontend=dataclasses.replace(cfg.frontend, n_features=100, n_levels=2))
sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
              mode="fused", device="cpu")
reports = sysm.run_sequence(SyntheticDataset(scene, 1.0, 40.0), max_frames=1)
assert len(reports) == 1 and reports[0]["frame_id"] == 0
assert not any(m == "jax" or m.startswith(("jax.", "flax"))
               for m in sys.modules if sys.modules[m] is not None)
print("NO_JAX_OK")
"""


IMPORT_ALL = r"""
import importlib
import pkgutil
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import vdo_slam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vdo_slam_tpu_torch.__path__,
                                               "vdo_slam_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"vdo_slam_tpu_torch.run", "vdo_slam_tpu_torch.utils.checkpoint",
        "vdo_slam_tpu_torch.utils.profiling",
        "vdo_slam_tpu_torch.pipeline.tracking",
        "vdo_slam_tpu_torch.solvers.reproj_lm",
        "vdo_slam_tpu_torch.ops.undistort"} <= set(names)
assert not any(m == "jax" or m.startswith(("jax.", "flax", "vdo_slam_tpu."))
               or m == "vdo_slam_tpu"
               for m in sys.modules if sys.modules[m] is not None)
print("IMPORTED", len(names))
"""


def test_every_port_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "IMPORTED" in out.stdout


def test_port_runs_without_jax():
    out = subprocess.run([sys.executable, "-c", NO_JAX], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout


def test_no_jax_imports_in_the_port():
    """Neither the port's package nor chip_smoke.py imports jax, flax or
    anything of the JAX package."""
    import re

    pat = re.compile(r"^\s*(import|from) (jax|flax|vdo_slam_tpu)\b(?!_)",
                     re.M)
    files = list((REPO / "vdo_slam_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 30
    hits = [str(p) for p in files if pat.search(p.read_text())]
    assert not hits, hits
    assert pat.search("from vdo_slam_tpu.io import packing")
    assert not pat.search("from vdo_slam_tpu_torch.io import packing")
