"""The port's bench (vdo_slam_tpu_torch/bench.py) against the repository's
bench.py and the JAX package.

- Config: the port's bench_config / multistream_config equal the configs
  bench.py builds (bench.py:76-85, 262-285), through JAX's own
  _env_overrides, field by field, with no knob set and with each of the
  14 VDO_BENCH_* config knobs set; VDO_BENCH_CHUNK as bench.py reads it.
- argv: the port's parse_argv against bench.py's own dispatch block
  (bench.py:440-457, executed with its two entry points recorded), and the
  metric names of bench.py:158, 432-433.
- The default mode at 320x96 over 12 frames against the JAX
  System(mode="fused") on the same scene and config, both BA passes; the
  S-stream mode (S = 2, 8 frames) against the JAX MultiStreamSystem driven
  as bench_multistream drives it.  Tolerances of
  tests/test_torch_multistream.py: each RPE under max(3x the JAX run's,
  5e-3 m / 0.01 deg for the camera, 5e-3 m / 0.05 deg for objects), the
  last camera pose within 5x the slice test's per-frame bounds.  96x64,
  the slice tests' size, leaves bench.py's camera (fx 721.5 px, a 7.6 deg
  field) no trackable point: both packages then return a zero rotation
  and metric_report raises, so these runs take 320x96.
- --hard: the port's degraded scene equals JAX degrade_scene with
  bench.py's arguments at atol = 0.
- No jax: a subprocess with jax unimportable runs the default mode at its
  smallest and both tools, imports nothing of vdo_slam_tpu, and never
  opens bench.py's scene cache, where a JAX-format pickle is planted.
"""

import ast
import contextlib
import dataclasses
import io
import json
import pickle
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jbench
from tests.test_torch_slice import R_TOL_DEG, T_TOL_M, pose_gap
from vdo_slam_tpu_torch import bench
from vdo_slam_tpu_torch import config as pconfig

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(width=320, height=96)
N_SMALL = 12
# a valid value for each of bench.py's config knobs (bench.py:171-213)
KNOBS = {
    "VDO_BENCH_FLOW_DOWN": "4",
    "VDO_BENCH_DEPTH_DOWN": "1",
    "VDO_BENCH_DEPTH_RESID": "0",
    "VDO_BENCH_ENTROPY": "0",
    "VDO_BENCH_DRAIN": "3",
    "VDO_BENCH_MASK_PROP": "0",
    "VDO_BENCH_CAM_ITERS": "7",
    "VDO_BENCH_OBJ_ITERS": "5",
    "VDO_BENCH_REFIT": "0",
    "VDO_BENCH_FULL_ITERS": "9",
    "VDO_BENCH_FULL_CHUNK": "2",
    "VDO_BENCH_CG_UNROLL": "3",
    "VDO_BENCH_LOCAL_UNROLL": "2",
    "VDO_BENCH_LOCAL_ITERS": "6",
}
ENV = tuple(KNOBS) + ("VDO_BENCH_CHUNK", "VDO_BENCH_NO_PROBE")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs in several worker processes at once, and each worker's idle
    OpenMP threads spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@contextlib.contextmanager
def _no_knobs():
    """No VDO_BENCH_* variable set (for the module-scoped runs)."""
    mp = pytest.MonkeyPatch()
    for k in ENV:
        mp.delenv(k, raising=False)
    try:
        yield
    finally:
        mp.undo()


def jax_config(width, height, multistream=False):
    """The config bench.py builds: bench_multistream's (bench.py:76-85) or
    main's (bench.py:262-285), through JAX's tpu_fast and bench.py's own
    _env_overrides."""
    import os

    from vdo_slam_tpu.config import (KITTI, ShapeConfig, TrackingConfig,
                                     VDOConfig, tpu_fast)

    cfg = VDOConfig()
    camera = dataclasses.replace(
        cfg.camera, fx=721.5377, fy=721.5377, cx=width / 2.0,
        cy=height / 2.0, width=width, height=height, bf=387.5744)
    if multistream:
        cfg = cfg.replace(
            camera=camera,
            tracking=dataclasses.replace(TrackingConfig(), dataset=KITTI,
                                         depth_map_factor=256.0),
            shapes=ShapeConfig())
    else:
        cfg = cfg.replace(
            camera=camera,
            tracking=dataclasses.replace(
                TrackingConfig(), dataset=KITTI, depth_map_factor=256.0,
                fused_chunk=int(os.environ.get("VDO_BENCH_CHUNK", "4"))),
            shapes=ShapeConfig(),
            backend=dataclasses.replace(
                cfg.backend, full_obs_cap=245760, full_ter_cap=131072,
                full_point_cap=122880, full_motion_cap=192,
                full_smo_cap=192))
    return jbench._env_overrides(tpu_fast(cfg))


def jax_packed(scene, cfg):
    """bench.py's InMemoryPackedDataset of the scene (bench.py:286-301)."""
    from vdo_slam_tpu.io.dataset import SyntheticDataset
    from vdo_slam_tpu.io.packed_dataset import InMemoryPackedDataset

    tr = cfg.tracking
    return InMemoryPackedDataset(
        SyntheticDataset(scene, depth_map_factor=256.0, bf=387.5744),
        depth_map_factor=256.0, flow_down=tr.flow_down,
        flow_delta=tr.flow_delta, depth_down=tr.depth_down,
        depth_resid=tr.depth_resid, entropy=tr.entropy,
        seg_cap=tr.wire_seg_cap, depth_exc_cap=tr.wire_depth_exc_cap)


def jax_scene(n_frames, width, height, hard=False):
    from vdo_slam_tpu.io.synthetic import degrade_scene, make_scene

    scene = make_scene(num_frames=n_frames + 1, width=width, height=height,
                       num_objects=3, fx=721.5377, seed=7)
    if hard:    # bench.py:254-256
        scene = degrade_scene(scene, flow_noise_px=0.75,
                              flow_outlier_frac=0.01, mask_erode_px=1,
                              mask_jitter_px=1, seed=13)
    return scene


# ---- (a) config parity


@pytest.mark.parametrize("knob", [None] + list(KNOBS))
def test_config_equals_bench_py(knob, clean_env):
    if knob is not None:
        clean_env.setenv(knob, KNOBS[knob])
    for port, multistream in ((bench.bench_config, False),
                              (bench.multistream_config, True)):
        want = dataclasses.asdict(jax_config(1242, 375, multistream))
        got = pconfig.jax_fields(port(1242, 375))
        assert got.keys() == want.keys()
        for section in want:
            assert got[section] == want[section], (knob, section)


def test_chunk_knob_and_warmup_frames(clean_env):
    """VDO_BENCH_CHUNK sets fused_chunk and WARMUP_FRAMES as bench.py
    reads them (bench.py:33, 273), read when the bench runs."""
    import importlib

    assert bench.warmup_frames() == 4
    assert bench.bench_config().tracking.fused_chunk == 4
    clean_env.setenv("VDO_BENCH_CHUNK", "6")
    try:
        importlib.reload(jbench)
        assert bench.warmup_frames() == jbench.WARMUP_FRAMES == 6
        assert (pconfig.jax_fields(bench.bench_config())
                == dataclasses.asdict(jax_config(1242, 375)))
        assert bench.bench_config().tracking.fused_chunk == 6
    finally:
        clean_env.delenv("VDO_BENCH_CHUNK")
        importlib.reload(jbench)
    assert jbench.WARMUP_FRAMES == 4


# ---- (b) argv


def _bench_py_dispatch(argv):
    """What bench.py's `if __name__ == "__main__":` block calls for argv:
    the block executed with its two entry points recorded."""
    tree = ast.parse((REPO / "bench.py").read_text())
    block = next(n for n in tree.body if isinstance(n, ast.If)
                 and "__main__" in ast.unparse(n.test))
    calls = []
    ns = {"sys": types.SimpleNamespace(argv=["bench.py", *argv]),
          "main": lambda **kw: calls.append(("main", kw)),
          "bench_multistream": lambda s, **kw: calls.append(
              ("multistream", {"n_streams": s, **kw}))}
    exec(compile(ast.Module(body=block.body, type_ignores=[]), "bench.py",
                 "exec"), ns)
    assert len(calls) == 1
    return calls[0]


@pytest.mark.parametrize("argv", [[], ["--hard"], ["--streams", "2"],
                                  ["--throughput"],
                                  ["--throughput", "--streams", "3"]])
def test_argv_matches_bench_py(argv):
    mode, kwargs = bench.parse_argv(argv)
    assert (mode, kwargs) == _bench_py_dispatch(argv)
    # bench.py:158 and 432-433
    if mode == "multistream":
        want = (f"kitti_synth_multistream{kwargs['n_streams']}"
                f"{kwargs.get('tag', '')}_aggregate_fps")
    else:
        want = ("kitti_synth_hard_fps" if kwargs["hard"]
                else "kitti_synth_full_pipeline_fps")
    assert bench.metric_name(**kwargs) == want
    with_device = bench.parse_argv(argv + ["--device", "cpu"])
    assert with_device == (mode, kwargs)


def test_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.cli(["--hard"])


# ---- (c) the default mode against the JAX System


def _run_captured(fn, **kwargs):
    out = io.StringIO()
    with _no_knobs(), contextlib.redirect_stdout(out):
        res = fn(device="cpu", **kwargs)
    return res, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def default_runs():
    """The port's bench main at 320x96 (12 frames, chunk 4, both BA
    passes, the probe) and the JAX System(mode="fused") on the same scene
    and config, window BA on, full BA at the end."""
    from vdo_slam_tpu.pipeline import System as JSystem

    res, lines = _run_captured(bench.main, n_frames=N_SMALL, **SMALL)
    with _no_knobs():
        jcfg = jax_config(**SMALL)
    jsys = JSystem(jcfg, enable_local_ba=True, enable_global_ba=True,
                   mode="fused")
    jsys.run_sequence(jax_packed(jax_scene(N_SMALL, **SMALL), jcfg))
    return {"res": res, "lines": lines, "jsys": jsys}


def _check_record(lines, metric):
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == metric and rec["unit"] == "frames/sec"
    assert rec["value"] > 0
    # vs_baseline rounds fps / 0.249; value is fps rounded to 3 places
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 0.249,
                                               abs=3e-3)
    return rec


def _held_to_jax(port: dict, ref: dict):
    floors = {"cam_t_rpe": 5e-3, "cam_r_rpe_deg": 0.01, "obj_t_rpe": 5e-3,
              "obj_r_rpe_deg": 0.05}
    for k, floor in floors.items():
        assert port[k] < max(3.0 * ref[k], floor), (k, port[k], ref[k])
    assert port["n_obj_estimates"] == ref["n_obj_estimates"]


def test_default_mode_prints_bench_py_line(default_runs):
    rec = _check_record(default_runs["lines"],
                        "kitti_synth_full_pipeline_fps")
    assert default_runs["res"]["record"] == rec
    assert default_runs["res"]["frames"] == N_SMALL
    sysm = default_runs["res"]["system"]
    assert sysm.map.num_frames == N_SMALL
    # the probe ran and its split is archived with every frame
    assert sysm.timing()["camera_est_ms"] > 0


def test_default_mode_matches_jax_system(default_runs):
    sysm, jsys = default_runs["res"]["system"], default_runs["jsys"]
    for refined in (False, True):
        _held_to_jax(sysm.metrics(refined=refined),
                     jsys.metrics(refined=refined))
    for poses in ("cam_pose", "cam_pose_rf"):
        dt, dr = pose_gap(getattr(sysm.map, poses)[-1],
                          getattr(jsys.map, poses)[-1])
        assert dt < 5 * T_TOL_M and dr < 5 * R_TOL_DEG, (poses, dt, dr)
    full = default_runs["res"]["full_ba"]
    assert full["cost"] < full["cost0"]


# ---- (d) --hard


def test_hard_scene_equals_jax_degrade_scene():
    got = bench.bench_scene(N_SMALL, hard=True, **SMALL)
    want = jax_scene(N_SMALL, hard=True, **SMALL)
    clean = bench.bench_scene(N_SMALL, **SMALL)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert a.dtype == b.dtype, f.name
        else:
            assert a == b, f.name
    assert not np.array_equal(got.flow, clean.flow)
    # made once per process, however the arguments are passed
    assert bench.bench_scene(N_SMALL, hard=True, **SMALL) is got
    assert bench.bench_scene(N_SMALL, SMALL["width"], SMALL["height"]) is clean


# ---- (e) S streams against the JAX MultiStreamSystem


@pytest.fixture(scope="module")
def stream_runs():
    import jax

    from vdo_slam_tpu.parallel import MultiStreamSystem as JMulti

    n = 8
    res, lines = _run_captured(bench.bench_multistream, n_streams=2,
                               n_frames=n, scene_frames=N_SMALL, **SMALL)
    with _no_knobs():
        jcfg = jax_config(multistream=True, **SMALL)
    pds = jax_packed(jax_scene(N_SMALL, **SMALL), jcfg)
    offsets = [(7 * s) % (len(pds) - n) for s in range(2)]    # bench.py:110
    views = [bench._View(pds, off, n) for off in offsets]
    # bench.py's drive (bench.py:123-144), on one device as on one chip
    jsys = JMulti(jcfg, n_streams=2, enable_local_ba=True,
                  devices=jax.devices()[:1])
    staged = jsys._stage([d[0] for d in views])
    for i in range(bench.WARM):
        jsys.step_frame([d[i] for d in views], staged)
        staged = jsys._stage([d[i + 1] for d in views])
    for i in range(bench.WARM, n):
        nxt = jsys._stage([d[i + 1] for d in views]) if i + 1 < n else None
        jsys.step_frame([d[i] for d in views], staged, sync=False)
        staged = nxt
    jsys.flush()
    return {"res": res, "lines": lines, "jsys": jsys, "offsets": offsets,
            "n": n}


def test_multistream_matches_jax_system(stream_runs):
    res, jsys = stream_runs["res"], stream_runs["jsys"]
    _check_record(stream_runs["lines"],
                  "kitti_synth_multistream2_aggregate_fps")
    assert res["offsets"] == stream_runs["offsets"] == [0, 3]
    msys = res["system"]
    pm = msys.metrics()["per_stream"]
    jm = jsys.metrics()["per_stream"]
    for s in range(2):
        assert msys.maps[s].num_frames == stream_runs["n"]
        _held_to_jax(pm[s], jm[s])
        dt, dr = pose_gap(msys.maps[s].cam_pose[-1], jsys.maps[s].cam_pose[-1])
        assert dt < 5 * T_TOL_M and dr < 5 * R_TOL_DEG, (s, dt, dr)


def test_stream_offsets_as_bench_py():
    """bench.py:110 at the sizes the card runs: --streams 4 and
    --throughput over the 100-frame sequence, 40 frames each."""
    for S in (4, 6):
        assert bench.stream_offsets(100, S) == [(7 * s) % (100 - 40)
                                                for s in range(S)]
    assert bench.stream_offsets(100, 6) == [0, 7, 14, 21, 28, 35]


# ---- (f) no jax


NO_JAX = r"""
import json, os, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
plant, work = sys.argv[1], sys.argv[2]
opened = []
sys.addaudithook(lambda event, args: opened.append(str(args[0]))
                 if event == "open" and "vdo_bench_scene" in str(args[0])
                 else None)
import contextlib, io
from pathlib import Path

import numpy as np
import torch
torch.set_num_threads(1)

from vdo_slam_tpu_torch import bench
from vdo_slam_tpu_torch.io import write_reference_sequence
from vdo_slam_tpu_torch.io.packed_dataset import PackedDataset
from vdo_slam_tpu_torch.tools import cube_segmentation, pack_sequence

os.environ["VDO_BENCH_NO_PROBE"] = "1"
out = io.StringIO()
with contextlib.redirect_stdout(out):
    res = bench.main(device="cpu", n_frames=5, width=320, height=96)
rec = json.loads(out.getvalue())
assert rec["metric"] == "kitti_synth_full_pipeline_fps", rec
assert res["system"].map.num_frames == 5

scene = bench.bench_scene(5, 320, 96)
seq = write_reference_sequence(scene, Path(work) / "seq",
                               depth_map_factor=256.0, bf=387.5744)
with contextlib.redirect_stdout(io.StringIO()):
    rc = pack_sequence.main([str(seq), str(Path(work) / "packed"),
                             "--flow-delta", "--entropy"])
assert rc == 0 and len(PackedDataset(Path(work) / "packed")) == 5

from PIL import Image
rgb = np.full((300, 400, 3), 20, np.uint8)
rgb[30:180, 40:190] = (200, 30, 30)
(Path(work) / "img").mkdir()
Image.fromarray(rgb).save(Path(work) / "img" / "000000.png")
from vdo_slam_tpu_torch.io import native_loader
if native_loader.build_native_loader() is None:
    labels = cube_segmentation.segment_cubes(rgb)
    print("NATIVE_SKIPPED")
else:
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cube_segmentation.main([str(Path(work) / "img"),
                                     str(Path(work) / "lab")])
    assert rc == 0
    labels = np.loadtxt(Path(work) / "lab" / "000000.txt")
assert labels.max() == 1

assert not opened, opened
bad = [m for m in sys.modules if sys.modules[m] is not None and (
    m in ("jax", "vdo_slam_tpu", "bench") or m.startswith(
        ("jax.", "flax", "vdo_slam_tpu.")))]
assert not bad, bad
print("NO_JAX_OK")
"""


def test_bench_and_tools_run_without_jax(tmp_path):
    """jax unimportable: the default mode at its smallest (5 frames, the
    probe skipped by its knob) and both tools.  bench.py's scene cache
    (bench.py:69, 237) holds a pickle of the JAX package's scene: one is
    planted under the subprocess's temp directory, and an audit hook fails
    the run if any path of that name is opened (/tmp's included)."""
    import os

    scene = jax_scene(2, 96, 64)
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    plant = tmp / f"vdo_bench_scene_{bench.N_FRAMES}.pkl"
    plant.write_bytes(pickle.dumps(scene))
    assert b"vdo_slam_tpu.io.synthetic" in plant.read_bytes()
    env = {k: v for k, v in os.environ.items() if not k.startswith(
        "VDO_BENCH_")}
    env["TMPDIR"] = str(tmp)
    work = tmp_path / "work"
    work.mkdir()
    out = subprocess.run([sys.executable, "-c", NO_JAX, str(plant),
                          str(work)], cwd=REPO, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
    assert "stage probe skipped (VDO_BENCH_NO_PROBE=1)" in out.stderr
