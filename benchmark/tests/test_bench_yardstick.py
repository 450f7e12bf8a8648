"""The yardstick's arithmetic, the metric readers on a canned trace, the
configuration files against the program's own configurations, and the
rule that nothing the benchmark runs loads jax or the JAX package."""

import ast
import functools
import importlib.util
import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import counting
from benchmark.run import HERE, ROOT, load_cell
from benchmark.trace import Trace, WindowTrace, breakdown


def _reader(name):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("m_" + name.replace(
        ".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_fast_pyramid_px_at_kitti():
    # PERF.md: 1,441,692 px over 8 levels of 1242x375 at scale 1.2
    assert counting.pyramid_px(375, 1242, 8, 1.2) == 1441692
    assert counting.fast_pyramid_bytes(1441692) == 12 * 1441692


def test_pyramid_px_is_the_ports_levels():
    from vdo_slam_tpu_torch.ops.fast import level_shapes

    for h, w in ((375, 1242), (480, 640), (97, 161)):
        want = sum(a * b for a, b in level_shapes(h, w, 8, 1.2))
        assert counting.pyramid_px(h, w, 8, 1.2) == want


def _canned():
    """Two streams over a 1 ms stretch (ns) of a longer recording: the
    step's stream 7 runs three kernels (one FAST) inside it, the solve's
    stream 9 one kernel and a copy; a FAST launch and a step kernel
    straddle the stretch's start, and kernels before and after it are
    recorded too."""
    tr = Trace(t0_ns=0, t1_ns=1_000_000)
    tr.ops = sorted([
        ("fast_pyramid_kernel(FastPyramid, float*)", -300_000, -290_000, 7),
        ("fast_pyramid_kernel(FastPyramid, float*)", -5_000, 5_000, 7),
        ("step_0", -50_000, 20_000, 7),
        ("fast_pyramid_kernel(FastPyramid, float*)", 100_000, 110_000, 7),
        ("step_a", 110_000, 300_000, 7),
        ("step_b", 400_000, 500_000, 7),
        ("solve", 450_000, 700_000, 9),
        ("Memcpy DtoH (Device -> Pinned)", 800_000, 850_000, 9),
        ("step_c", 1_200_000, 1_900_000, 7),
    ], key=lambda o: o[1])
    tr.calls = [("cudaGraphLaunch", 50_000, 60_000),
                ("cudaStreamSynchronize", 700_000, 790_000)]
    return tr


def test_trace_reductions():
    tr = _canned()
    assert tr.busy_intervals() == [(0, 20_000), (100_000, 300_000),
                                   (400_000, 700_000), (800_000, 850_000)]
    assert tr.busy_s() == pytest.approx(570e-6)
    assert tr.main_stream() == 7
    assert len(tr.kernels(whole=True)) == 4
    bd = breakdown(tr)
    assert bd["device_ops"][0] == ["solve", 250e-6]
    assert ["step_0", 20e-6] in bd["device_ops"]
    assert "step_c" not in [k for k, _ in bd["device_ops"]]
    assert bd["idle_gaps"][0] == ["after cudaStreamSynchronize", 150e-6]
    names = [g[0] for g in bd["idle_gaps"]]
    assert "in cudaStreamSynchronize" in names


def test_readers_on_a_canned_trace():
    tr = _canned()
    run = SimpleNamespace(trace=tr, trace_frames=2, fast_px=1441692,
                          probe={"camera_est": 4.5, "obj_est": 4.1},
                          window_solve_ms=[30.0, 50.0])
    # 5 + 20 + 10 + 190 + 100 us of the step's stream inside the stretch
    assert _reader("step_device_ms")(run) == pytest.approx(0.325 / 2)
    assert _reader("camera_est_ms")(run) == 4.5
    assert _reader("obj_est_ms")(run) == 4.1
    bound_s = 12 * 1441692 / 3.35e12
    assert _reader("fast_roofline_pct")(run) == pytest.approx(
        100 * bound_s / 10e-6)
    assert _reader("window_solve_ms.fps")(run) == 40.0
    assert _reader("device_idle_pct.fps")(run) == pytest.approx(43.0)


def test_readers_find_nothing_without_a_trace():
    run = SimpleNamespace(trace=None, trace_frames=0, fast_px=0, probe=None,
                          window_solve_ms=[])
    for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]:
        assert _reader(m["name"])(run) is None, m["name"]


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_the_benchmark_runs_loads_jax():
    run_modules = [p for p in HERE.rglob("*.py") if "tests" not in p.parts]
    assert len(run_modules) > 10
    for p in run_modules:
        bad = _imports(p) & {"jax", "jaxlib", "flax", "vdo_slam_tpu"}
        assert not bad, (p, bad)


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "scene.py", "wire.py", "counting.py",
                 "trace.py"):
        assert "vdo_slam_tpu_torch" not in _imports(HERE / name), name


# the configuration as it was benchmarked: the values the cell's `why`
# and PERF.md name, and a digest of every value of its "config" sections
KITTI_FROZEN = {
    "camera": {"width": 1242, "height": 375, "fx": 721.5377, "fy": 721.5377,
               "cx": 621.0, "cy": 187.5, "bf": 387.5744, "fps": 10.0},
    "frontend": {"n_levels": 8, "scale_factor": 1.2,
                 "use_sample_feature": False},
    "tracking": {"depth_map_factor": 256.0, "fused_chunk": 4,
                 "fused_drain_chunks": 8, "wire_entropy": True,
                 "wire_flow_delta": True, "window_size": 20,
                 "overlap_size": 4},
    "backend": {"full_obs_cap": 245760, "full_ter_cap": 131072,
                "full_point_cap": 122880, "full_motion_cap": 192},
}
KITTI_SHA256 = \
    "b0cded0c6e8e0458ce545d7b6a15932491123457a08065e5f13edcecb1a0a17e"


def test_configuration_file_is_as_benchmarked():
    import hashlib

    from benchmark.program import build_config

    conf = load_cell("kitti-drive")["config"]
    for sec, vals in KITTI_FROZEN.items():
        for k, v in vals.items():
            assert conf["config"][sec][k] == v, (sec, k)
    digest = hashlib.sha256(json.dumps(conf["config"], sort_keys=True)
                            .encode()).hexdigest()
    assert digest == KITTI_SHA256
    logged = []
    cfg = build_config(conf, logged.append)
    assert logged == []                  # the file gives every field
    assert cfg.camera.width == 1242 and cfg.tracking.fused_chunk == 4


def test_build_config_defaults_omitted_fields_and_refuses_unknown():
    import copy

    from benchmark.program import build_config
    from vdo_slam_tpu_torch.config import TrackingConfig

    conf = copy.deepcopy(load_cell("kitti-drive")["config"])
    del conf["config"]["tracking"]["sf_mg_thres"]
    logged = []
    cfg = build_config(conf, logged.append)
    assert cfg.tracking.sf_mg_thres == TrackingConfig().sf_mg_thres
    assert len(logged) == 1 and "sf_mg_thres" in logged[0]
    conf["config"]["tracking"]["no_such_field"] = 1
    with pytest.raises(ValueError, match="no_such_field"):
        build_config(conf)


def test_every_cell_finds_its_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name in [w["name"] for w in spec["workloads"]]:
        c = load_cell(name)
        assert (HERE / "kinds" / f"{c['traffic']['kind']}.py").is_file()
        assert set(c["limits"]) >= {"cam_t_max", "frames_missing"}
        assert c["config"]["name"] == c["cell"]["config"]
    for m in spec["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    with pytest.raises(SystemExit):
        load_cell("no-such-cell")


class _FakeProfile:
    """A profiler that records one 100 us kernel on stream 7 every 200 us
    of host time between its start and stop, and one FAST launch per ms."""

    made: list = []

    def __init__(self):
        self.t = []
        _FakeProfile.made.append(self)

    def start(self):
        self.t.append(time.time_ns())

    def stop(self):
        self.t.append(time.time_ns())

    @property
    def profiler(self):
        from torch.autograd import DeviceType

        evs = []
        for s in range(self.t[0], self.t[1] - 100_000, 200_000):
            name = ("fast_pyramid_kernel" if (s - self.t[0]) % 1_000_000
                    == 0 else "step")
            evs.append(SimpleNamespace(
                start_ns=lambda s=s: s, duration_ns=lambda: 100_000,
                device_type=lambda: DeviceType.CUDA, name=lambda n=name: n,
                device_resource_id=lambda: 7))
        return SimpleNamespace(kineto_results=SimpleNamespace(
            events=lambda: evs))


def test_window_trace_starts_and_stops_around_its_stretch(monkeypatch):
    monkeypatch.setattr(WindowTrace, "profile_factory", _FakeProfile)
    _FakeProfile.made.clear()
    started = []
    wt = WindowTrace(first=32, n=16, lead=16,
                     on_start=lambda: started.append(len(_FakeProfile.made)))
    for i in range(70):
        wt.fetched(i)
        if i < 16:
            assert not started and not _FakeProfile.made
        if i == 16:
            assert started == [0]
        if i < 32:
            assert wt.t0_ns is None
        if 32 <= i < 48:
            assert wt.t0_ns is not None and wt.t1_ns is None
            # running by the stretch's first frame, on its own thread
            assert len(_FakeProfile.made) == 1
            assert len(_FakeProfile.made[0].t) == 1
        time.sleep(0.0005)
    assert len(_FakeProfile.made[0].t) == 1   # runs on to the call's end
    tr = wt.result()
    assert len(_FakeProfile.made) == 1
    prof = _FakeProfile.made[0]
    assert prof.t[0] < tr.t0_ns < tr.t1_ns < prof.t[1]
    assert tr.ops and 0.3 < tr.busy_s() / tr.window_s < 0.7
    assert not wt._thread.is_alive()


def test_a_traced_run_traces_inside_its_window(monkeypatch):
    """A traced run on the CPU, its profiler faked: the stretch lies
    inside the window's one run_sequence call, and every per-layer metric
    of the cell is read from it."""
    import copy

    import torch

    from benchmark import loads
    from benchmark import run as harness

    def tiny(name):
        c = copy.deepcopy(load_cell(name))
        c["config"]["config"]["camera"].update(width=320, height=96,
                                               cx=160.0, cy=48.0)
        # the archive drained every chunk, so that solves queue early
        c["config"]["config"]["tracking"].update(window_size=6,
                                                 overlap_size=2,
                                                 fused_drain_chunks=1)
        c["traffic"].update(warm_frames=4, trace_frames=8,
                            planning_fps=10.0, frames_multiple=4)
        return c

    from vdo_slam_tpu_torch.pipeline import system as sysmod

    calls = []
    orig = sysmod.System.run_sequence

    def run_sequence(self, dataset, *a, **k):
        calls.append((len(dataset), _FakeProfile.made[:]))
        return orig(self, dataset, *a, **k)

    monkeypatch.setattr(sysmod.System, "run_sequence", run_sequence)
    monkeypatch.setattr(harness, "load_cell", tiny)
    monkeypatch.setattr(WindowTrace, "profile_factory", _FakeProfile)
    # a short lead, so that window solves end before the profiler starts
    monkeypatch.setattr(loads, "WindowTrace",
                        functools.partial(WindowTrace, lead=2))
    _FakeProfile.made.clear()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        result, lines = harness.run_cell("kitti-drive", 2**32 + 9, 4, True,
                                         "cpu")
    finally:
        torch.set_num_threads(n)
    # warm frames, then the window: one call, the profiler started in it
    assert [c[0] for c in calls] == [4, 40]
    assert calls[1][1] == [] and len(_FakeProfile.made) == 1
    assert 0 < result["device"]["busy_s"] < result["device"]["window_s"]
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["per_layer"]
            if "kitti-drive" in m.get("workloads", ["kitti-drive"])}
    assert set(result["metrics"]) == want
    assert result["breakdown"]["device_ops"]


def test_control_reads_zero_without_rounding():
    """The judge reads the truth as exact, so a control's readings are
    its rounding alone."""
    from benchmark import reference as R
    from benchmark import scene as S

    lay = S.make_layout(30, 160, 96, 2, 160.0, 160.0, 4)
    gt = R.truth(lay.T_wc, lay.L)
    F, K = lay.L.shape[:2]
    Lw = gt["L"]
    ests = [(f, k, Lw[f, k] @ R._inv(Lw[f - 1, k]))
            for f in range(1, F) for k in range(K)]
    C = R.corners(lay.obj_patches)
    exact = R.judge({"cam": gt["T_wc"], "cam_ba": gt["T_wc"], "obj": ests},
                    lay.T_wc, lay.L, C, range(F))
    assert exact["cam_t_max"] < 1e-12 and exact["obj_t_p99"] < 1e-9
    assert exact["obj_corner_p99"] < 1e-9
    ctl = R.control(lay.T_wc, lay.L, C, range(F))
    assert ctl["cam_t_max"] > 1e-3
    assert np.isfinite(list(ctl.values())).all()
