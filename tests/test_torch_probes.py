"""The port's FusedTracker.step_chunk, its probe tools (probe_loop,
probe_chunk, capture_extras in vdo_slam_tpu_torch/tools/) and the bench's
scene cache on disk.

On the CPU at 320x96 (bench.py's camera sees trackable points there, not
at 96x64): step_chunk against the tracker's step called frame by frame,
bit-equal; the chunked drive's archive against the frame-by-frame drive's;
both probes' phases finite and non-negative and every drive archiving the
frames it was given; capture_extras with its bench processes stubbed; the
scene cache loaded, not made, on the second call; and the three tools and
the cache load without jax.
"""

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_slice import WIRE, tiny_pair
from vdo_slam_tpu_torch import bench
from vdo_slam_tpu_torch.io import synthetic
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.pipeline import draws as draws_mod
from vdo_slam_tpu_torch.pipeline.fused import FusedTracker, pack_outputs
from vdo_slam_tpu_torch.tools import capture_extras, probe_chunk, probe_loop

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(width=320, height=96)
N_SCENE = 16      # 8 warm frames, 4 probed, 4 for probe_chunk's last drive


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
def tmp_tempdir(tmp_path, monkeypatch):
    """tempfile's directory (the scene cache's) moved under tmp_path."""
    d = tmp_path / "tmp"
    d.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(d))
    return d


@pytest.fixture(scope="module")
def tiny_ds():
    scene = synthetic.make_scene(num_frames=9, width=96, height=64,
                                 num_objects=1, seed=1)
    return SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)


# ---- step_chunk


def test_step_chunk_equals_frame_steps(tiny_ds):
    """Two chunks of 4 through step_chunk against the tracker's step called
    frame by frame with each frame's draws: equal output vectors and
    states, bit for bit."""
    _, cfg = tiny_pair(fused_chunk=4, **WIRE)
    tr = FusedTracker(cfg, device="cpu")
    ref = FusedTracker(cfg, device="cpu")
    state, st = tr.state, ref.state
    for f0 in (0, 4):
        staged = tr.device_inputs_chunk([tiny_ds[f0 + c] for c in range(4)])
        staged.pop("_T_cw_gt_host")
        state, vecs = tr.step_chunk(state, staged, f0)
        want = []
        for c in range(4):
            draws = draws_mod.UniformDraws(ref.frame_draws(f0 + c))
            st, m = ref.step(st, {k: v[c] for k, v in staged.items()}, draws,
                             f0 + c > 0)
            want.append(pack_outputs(st, m))
        assert vecs.shape == (4, want[0].numel())
        assert torch.equal(vecs, torch.stack(want))
    assert tr.initialized
    from vdo_slam_tpu_torch.parallel.multistream import _flatten

    for a, b in zip(_flatten(state), _flatten(st)):
        assert torch.equal(a, b)


def test_grab_chunk_archive_equals_frame_drive(tiny_ds):
    """grab_chunk (which now steps through step_chunk) over 8 frames in
    chunks of 4 archives what grab_frame archives frame by frame."""
    _, cfg4 = tiny_pair(fused_chunk=4, fused_drain_chunks=1, **WIRE)
    _, cfg1 = tiny_pair(**WIRE)
    fds = [tiny_ds[i] for i in range(8)]
    chunked = FusedTracker(cfg4, device="cpu")
    reps = chunked.grab_chunk(fds[:4]) + chunked.grab_chunk(fds[4:])
    reps += chunked.flush()
    frames = FusedTracker(cfg1, device="cpu")
    for fd in fds:
        frames.grab_frame(fd)
    frames.flush()
    assert [r["frame_id"] for r in reps] == list(range(8))
    assert chunked.map.num_frames == frames.map.num_frames == 8
    for key in ("cam_pose", "stat_xy", "dyn_xy", "dyn_obj_label"):
        np.testing.assert_array_equal(np.stack(getattr(chunked.map, key)),
                                      np.stack(getattr(frames.map, key)),
                                      err_msg=key)


# ---- the probes


def _check_probe(out, tmp_tempdir, work):
    for k, v in out.items():
        if isinstance(v, float):
            assert np.isfinite(v), k
            assert v >= 0.0 or k.startswith("gap"), (k, v)
    for d in out["drives"]:
        assert d["archived"] == d["given"] == d["steps"], d
    assert out["device"] == "cpu" and out["chunk"] == 4
    # nothing written but the scene cache
    assert not list(work.iterdir())
    assert {p.name for p in tmp_tempdir.iterdir()} <= {
        Path(bench.scene_cache_path(N_SCENE, hard=False, **SMALL)).name}


def test_probe_loop_on_cpu(tmp_tempdir, tmp_path, monkeypatch):
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    before = sorted(p.name for p in REPO.iterdir())
    out = probe_loop.main(n_frames=4, device="cpu", scene_frames=N_SCENE,
                          **SMALL)
    for k in ("upload_ms_frame", "dispatch_ms_frame", "device_ms_frame",
              "launches_per_frame", "loop_ms_frame_ba_off",
              "loop_ms_frame_ba_on", "gap_ms_frame_ba_off",
              "gap_ms_frame_ba_on"):
        assert isinstance(out[k], float), k
    assert out["launches_per_frame"] == 0.0   # the CPU launches no kernel
    assert out["device_ms_frame"] == out["dispatch_ms_frame"]
    assert [d["given"] for d in out["drives"]] == [4, 4]
    # 8 warm, 3 chunks of 4 stepped off the sequence, 2 x (8 warm + 4)
    assert out["steps"] == 8 + 12 + 24
    _check_probe(out, tmp_tempdir, work)
    assert sorted(p.name for p in REPO.iterdir()) == before


def test_probe_chunk_on_cpu(tmp_tempdir, tmp_path, monkeypatch):
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    before = sorted(p.name for p in REPO.iterdir())
    out = probe_chunk.main(n_frames=4, device="cpu", scene_frames=N_SCENE,
                           **SMALL)
    for k in ("submit_ms", "grab_chunk_ms", "stage_wait_ms",
              "drain_flush_ms", "total_s", "ms_frame", "fps",
              "run_sequence_ms_frame", "run_sequence_fps"):
        assert isinstance(out[k], float), k
    assert out["chunks"] == 1 and len(out["chunk_ms"]) == 1
    assert [d["what"] for d in out["drives"]] == [
        "warm frames", "inline chunks", "run_sequence"]
    assert out["steps"] == 16
    _check_probe(out, tmp_tempdir, work)
    assert sorted(p.name for p in REPO.iterdir()) == before


# ---- capture_extras


class _Proc:
    def __init__(self, stdout, rc=0):
        self.returncode, self.stdout = rc, stdout
        self.stderr = "\n".join(f"log {i}" for i in range(20))


def test_capture_extras_with_stubbed_bench(tmp_path, monkeypatch):
    calls = []
    outs = iter([
        _Proc('warming\n{"metric": "kitti_synth_hard_fps", "value": 4.5}\n'),
        _Proc('{not json\nnoise\n{"metric": "m4", "value": 7.0}\ntail\n'),
        _Proc('{"metric": "m8", "value": 9.0}\n', rc=3),
        _Proc("no json line at all\n"),
    ])

    def run(argv, **kw):
        calls.append((argv, kw))
        return next(outs)

    monkeypatch.setattr(capture_extras.subprocess, "run", run)
    monkeypatch.setenv("VDO_BENCH_NO_PROBE", "0")
    old = tmp_path / "BENCH_extra_r05.json"
    old.write_bytes(b'{"pre-port": true}\n')
    path = capture_extras.main(["--round", "9", "--streams", "4", "8",
                                "--device", "cpu"], root=tmp_path)
    assert path == tmp_path / "BENCH_torch_extra_r09.json"
    assert old.read_bytes() == b'{"pre-port": true}\n'
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "BENCH_extra_r05.json", "BENCH_torch_extra_r09.json"]
    modes = [["--hard"], ["--streams", "4"], ["--streams", "8"],
             ["--throughput"]]
    assert [c[0] for c in calls] == [
        [sys.executable, "-m", "vdo_slam_tpu_torch.bench", *m, "--device",
         "cpu"] for m in modes]
    assert all(kw["env"]["VDO_BENCH_NO_PROBE"] == "0" for _, kw in calls)
    art = json.loads(path.read_text())
    assert set(art) == {"captured_utc", "card", "runs"}
    assert art["card"] == "cpu"
    assert [r["args"] for r in art["runs"]] == modes
    assert [r["rc"] for r in art["runs"]] == [0, 0, 3, 0]
    assert [r["result"] for r in art["runs"]] == [
        {"metric": "kitti_synth_hard_fps", "value": 4.5},
        {"metric": "m4", "value": 7.0}, {"metric": "m8", "value": 9.0},
        None]
    for r in art["runs"]:
        assert set(r) == {"args", "rc", "wall_s", "result", "stderr_tail"}
        assert r["stderr_tail"] == [f"log {i}" for i in range(8, 20)]


def test_capture_extras_defaults_and_probe_knob(tmp_path, monkeypatch):
    """No --streams: S = 4 only; --skip-hard drops --hard; the stage probe
    is skipped unless the environment sets its knob."""
    assert capture_extras.modes([4], False) == [
        ["--hard"], ["--streams", "4"], ["--throughput"]]
    assert capture_extras.modes([], True) == [["--throughput"]]
    seen = []
    monkeypatch.delenv("VDO_BENCH_NO_PROBE", raising=False)
    monkeypatch.setattr(capture_extras.subprocess, "run", lambda argv, **kw: (
        seen.append(kw["env"]["VDO_BENCH_NO_PROBE"]) or _Proc("{}")))
    capture_extras.main(["--round", "9", "--skip-hard", "--device", "cpu"],
                        root=tmp_path)
    assert seen == ["1", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            capture_extras.main(["--round", "9"], root=tmp_path)


# ---- the scene cache


def test_scene_cache_loads_on_second_call(tmp_tempdir, monkeypatch):
    """bench_scene's disk cache: made and written on the first call, loaded
    on the second (making it again would raise), equal to a fresh
    make_scene; the path keyed on the values; the hard variant a file of
    its own; a damaged file made anew; no temporary file left."""
    make = bench._scene.__wrapped__          # past the in-process memo
    real_make = synthetic.make_scene
    first = make(3, 320, 96, False)
    path = Path(bench.scene_cache_path(3, 320, 96, False))
    assert path.parent == tmp_tempdir and path.exists()

    def no_make(*a, **k):
        raise AssertionError("made again, not loaded")

    monkeypatch.setattr(synthetic, "make_scene", no_make)
    again = make(3, 320, 96, False)
    fresh = real_make(num_frames=4, width=320, height=96, num_objects=3,
                      fx=bench.FX, seed=7)
    for k in bench.dataclasses.fields(fresh):
        np.testing.assert_array_equal(getattr(again, k.name),
                                      getattr(fresh, k.name))
        np.testing.assert_array_equal(getattr(first, k.name),
                                      getattr(fresh, k.name))
        assert getattr(again, k.name).dtype == getattr(fresh, k.name).dtype
    assert bench.scene_cache_path(n_frames=3, width=320, height=96,
                                  hard=False) == str(path)
    others = {bench.scene_cache_path(4, 320, 96, False),
              bench.scene_cache_path(3, 321, 96, False),
              bench.scene_cache_path(3, 320, 97, False),
              bench.scene_cache_path(3, 320, 96, True)}
    assert len(others) == 4 and str(path) not in others
    # the hard variant: its own file, the degraded scene
    monkeypatch.setattr(synthetic, "make_scene", real_make)
    hard = make(3, 320, 96, True)
    hard_path = Path(bench.scene_cache_path(3, 320, 96, True))
    assert hard_path.exists()
    monkeypatch.setattr(synthetic, "degrade_scene", no_make)
    hard_again = make(3, 320, 96, True)
    np.testing.assert_array_equal(hard_again.flow, hard.flow)
    assert not np.array_equal(hard.flow, fresh.flow)
    # a damaged file is made anew and rewritten
    monkeypatch.setattr(synthetic, "make_scene", real_make)
    path.write_bytes(b"not a zip")
    remade = make(3, 320, 96, False)
    np.testing.assert_array_equal(remade.rgb, fresh.rgb)
    assert path.stat().st_size > 1000
    assert sorted(p.name for p in tmp_tempdir.iterdir()) == sorted(
        [path.name, hard_path.name])


NO_JAX = r"""
import sys
if sys.argv[1] == "block":
    sys.modules["jax"] = None
    sys.modules["flax"] = None
from vdo_slam_tpu_torch import bench
from vdo_slam_tpu_torch.tools import capture_extras, probe_chunk, probe_loop
scene = bench.bench_scene(3, 320, 96)
assert scene.rgb.shape == (4, 96, 320), scene.rgb.shape
bad = [m for m in sys.modules if sys.modules[m] is not None and (
    m in ("jax", "vdo_slam_tpu", "bench") or m.startswith(
        ("jax.", "flax", "vdo_slam_tpu.")))]
assert not bad, bad
print("NO_JAX_OK")
"""


@pytest.mark.parametrize("block", ["block", "free"])
def test_tools_and_cache_load_without_jax(tmp_tempdir, block):
    """In a fresh process, the three tools import and the cached scene
    loads (not made: the log says so) with jax unimportable ("block"), and
    with jax importable but never imported ("free")."""
    import os

    bench._scene.__wrapped__(3, 320, 96, False)      # plant the cache
    env = {k: v for k, v in os.environ.items() if not k.startswith(
        "VDO_BENCH_")}
    env["TMPDIR"] = str(tmp_tempdir)
    out = subprocess.run([sys.executable, "-c", NO_JAX, block], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
    assert "scene loaded from " + str(tmp_tempdir) in out.stderr
