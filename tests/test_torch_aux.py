"""The port's auxiliary modules: the velocity report and result files
against the JAX package's on the same map (atol = 0: both are numpy over
the same arrays), the error-curve plots, checkpoint and resume of both
trackers (a resumed run equals the uninterrupted one at atol = 0 on the
CPU), and the run CLI on the CPU against the JAX CLI's report.
"""

import copy
import json

import numpy as np
import pytest
import torch

from tests.test_multistream import tiny_config
from tests.test_torch_slice import port_config
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.io.synthetic import make_scene
from vdo_slam_tpu_torch.pipeline import MapState, System
from vdo_slam_tpu_torch.utils import checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_map(tracked_session):
    """The JAX package's map of the shared session run, and the same
    arrays in the port's MapState."""
    jm = tracked_session["sysm"].map
    pm = MapState()
    pm.__dict__.update(copy.deepcopy(vars(jm)))
    return tracked_session["sysm"], jm, pm


def test_velocity_report_equals_jax(jax_map, tmp_path):
    from vdo_slam_tpu.eval.velocity import velocity_report as jvel
    from vdo_slam_tpu_torch.eval.velocity import velocity_report as pvel

    _, jm, pm = jax_map
    for rms in (True, False):
        a = pvel(pm, tmp_path / "port", rms=rms)
        b = jvel(jm, tmp_path / "jax", rms=rms)
        assert a == b and a["n_estimates"] > 3
    names = ("speed_error.txt", "speed_estimated.txt",
             "speed_groundtruth.txt", "tracking_id.txt")
    for n in names:
        assert ((tmp_path / "port" / n).read_text()
                == (tmp_path / "jax" / n).read_text()), n


def test_save_results_equals_jax(jax_map, tmp_path):
    from vdo_slam_tpu.eval.results import save_results as jsave
    from vdo_slam_tpu_torch.eval.results import save_results as psave

    _, jm, pm = jax_map
    psave(pm, tmp_path / "port")
    jsave(jm, tmp_path / "jax")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "obj_mot_stereo_new.txt" in names
    for n in names:
        assert ((tmp_path / "port" / n).read_text()
                == (tmp_path / "jax" / n).read_text()), n


def test_plot_metric_error_writes_files(jax_map, tmp_path):
    pytest.importorskip("matplotlib")
    from vdo_slam_tpu_torch.eval.plots import plot_metric_error

    _, _, pm = jax_map
    for refined in (False, True):
        paths = plot_metric_error(pm, tmp_path, refined=refined)
        assert len(paths) == 2
        for p in paths:
            assert (tmp_path / p.split("/")[-1]).stat().st_size > 1000


# --------------------------------------------------------------------------
# checkpoint and resume
# --------------------------------------------------------------------------

N_CK, CUT = 7, 3


@pytest.fixture(scope="module")
def small():
    """(config, dataset) of a 128x96 scene whose object both trackers
    track."""
    scene = make_scene(num_frames=N_CK + 1, width=128, height=96,
                       num_objects=1, seed=1)
    return (port_config(tiny_config(128, 96)),
            SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0))


def _archive(m):
    return {k: np.stack(getattr(m, k)) for k in
            ("cam_pose", "stat_xy", "stat_3d", "dyn_xy", "dyn_3d",
             "dyn_obj_label", "stat_assoc", "dyn_assoc")}


def _equal_archives(a, b):
    a, b = _archive(a), _archive(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("mode", ["reference", "fused"])
def test_resume_equals_uninterrupted(small, tmp_path, mode):
    cfg, tiny_ds = small
    save, load = ((checkpoint.save_checkpoint, checkpoint.load_checkpoint)
                  if mode == "reference" else
                  (checkpoint.save_fused_checkpoint,
                   checkpoint.load_fused_checkpoint))

    def system():
        return System(cfg, enable_local_ba=False, enable_global_ba=False,
                      mode=mode, device="cpu")

    whole = system()
    whole.run_sequence(tiny_ds)
    first = system()
    for i in range(CUT):
        first.track_rgbd(tiny_ds[i])
    ck = tmp_path / "ck.pkl"
    save(first.tracker, ck)
    resumed = system()
    load(resumed.tracker, ck)
    assert resumed.tracker.frame_id == CUT
    assert resumed.map.num_frames == CUT
    for i in range(CUT, N_CK):
        resumed.track_rgbd(tiny_ds[i])
    assert resumed.metrics() == whole.metrics()   # flushes the fused one
    assert whole.metrics()["n_obj_estimates"] > 0
    _equal_archives(whole.map, resumed.map)


def test_tracker_from_numpy_round_trip(small, tmp_path):
    """A payload of the port's own state rebuilds the same tracker."""
    import pickle

    cfg, tiny_ds = small
    sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  device="cpu")
    for i in range(2):
        sysm.track_rgbd(tiny_ds[i])
    ck = tmp_path / "ck.pkl"
    checkpoint.save_checkpoint(sysm.tracker, ck)
    with open(ck, "rb") as f:
        payload = pickle.load(f)
    tr = checkpoint.tracker_from_numpy(payload, cfg, device="cpu")
    assert tr.frame_id == 2 and tr.max_id == sysm.tracker.max_id
    assert torch.equal(tr.state.static.xy, sysm.tracker.state.static.xy)
    assert torch.equal(tr.state.dynamic.sem_label,
                       sysm.tracker.state.dynamic.sem_label)
    np.testing.assert_array_equal(tr._last_sem, sysm.tracker._last_sem)
    assert [(t.model_label, t.sem_label, t.active) for t in tr._last_tracks] \
        == [(t.model_label, t.sem_label, t.active)
            for t in sysm.tracker._last_tracks]
    assert tr.map.num_frames == 2
    a, b = tr.grab_frame(tiny_ds[2]), sysm.track_rgbd(tiny_ds[2])
    np.testing.assert_array_equal(a["T_cw"], b["T_cw"])


# --------------------------------------------------------------------------
# profiling
# --------------------------------------------------------------------------

def test_profiling_utilities():
    """The recorder's per-name summary and its lookup by name; the package
    exports the recorder and the call that turns it on."""
    from vdo_slam_tpu_torch.utils import StageTimer, recording

    with recording() as timer:
        assert isinstance(timer, StageTimer)
        for _ in range(3):
            with timer.span("double", cpu=True):
                torch.arange(6.0) * 2
        timer.add("other", 10, 2_000_010)
    summ = timer.summary()
    assert list(summ) == ["double", "other"]
    assert summ["double"]["count"] == 3 and summ["double"]["total_s"] >= 0
    assert summ["other"] == {"total_s": 0.002, "count": 1, "mean_ms": 2.0}
    assert [s.unit for s in timer.named("other")] == [None]
    assert len(timer.named("double")) == 3 and timer.named("none") == []


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def _key_tree(x):
    """The nested keys of a report; per-object tables (keyed by label,
    ints in Python, strings once in JSON) count as leaves."""
    if isinstance(x, dict) and not any(str(k).isdigit() for k in x):
        return {k: _key_tree(v) for k, v in x.items()}
    return None


def test_cli_on_cpu(jax_map, tmp_path, capsys):
    """--device cpu: the report has the JAX CLI's keys (run.py:82-90, here
    assembled from the JAX session's System as that CLI assembles it) and
    the result files are written."""
    from vdo_slam_tpu.eval.velocity import velocity_report as jvel
    from vdo_slam_tpu_torch import run

    jsys, _, _ = jax_map
    ref = {"metrics_initial": jsys.metrics(refined=False),
           "metrics_refined": jsys.metrics(refined=True),
           "timing": jsys.timing(), "frames": jsys.map.num_frames,
           "velocity": jvel(jsys.map)}
    out = tmp_path / "out"
    assert run.main(["--synthetic", "--frames", "3", "--out", str(out),
                     "--quiet", "--device", "cpu", "--checkpoint",
                     str(tmp_path / "ck.pkl")]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert _key_tree(rep) == _key_tree(ref)
    assert rep["frames"] == 3
    for f in ("initial_stereo_new.txt", "refined_stereo_new.txt",
              "obj_mot_stereo_new.txt", "speed_estimated.txt",
              "tracking_id.txt", "dynamic_slam_graph_after_opt.g2o"):
        assert (out / f).exists(), f
    assert (tmp_path / "ck.pkl").stat().st_size > 0


def test_cli_defaults(monkeypatch):
    """Without --device the CLI runs on the card; mode defaults to
    reference, as the JAX CLI's does."""
    from vdo_slam_tpu_torch import run

    seen = {}

    class Probe:
        def __init__(self, cfg, enable_local_ba, enable_global_ba, mode,
                     device):
            seen.update(mode=mode, device=device)
            raise SystemExit(0)

    monkeypatch.setattr("vdo_slam_tpu_torch.pipeline.System", Probe)
    with pytest.raises(SystemExit):
        run.main(["--synthetic", "--frames", "2"])
    assert seen == {"mode": "reference", "device": "cuda"}
