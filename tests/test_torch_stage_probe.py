"""The fused tracker's stage-time probe (`FusedTracker.calibrate_stage_times`,
parallel/multistream.py:make_scan_probe) on the CPU: the JAX test of
tests/test_multistream.py:TestStageProbe on the same 320x240 scene and
`small_config`, plus what the JAX test does not check: the probe leaves the
tracker's state, frame counter, staged GT labels and next draws as they
were, so the run continued after it equals the same run without it
(atol = 0).  The span names and the keys of the times are the JAX
package's.  The probe's programs (ProbePrograms: on a card one CUDA graph
per span, each captured over the previous span's outputs, and the frame
program) run eagerly here on the same static buffers: the chain of spans
ends in the packed step's output vector, and the frame program carries
its own state as the tracker's step would, leaving the tracker's alone
(atol = 0).
"""

import numpy as np
import pytest
import torch

from tests.test_pipeline_e2e import small_config
from tests.test_torch_slice import port_config
from vdo_slam_tpu.parallel import multistream as jax_multistream
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.io.synthetic import make_scene
from vdo_slam_tpu_torch.parallel.multistream import (PROBE_SPANS,
                                                     STAGE_SPANS, _flatten,
                                                     make_scan_probe)
from vdo_slam_tpu_torch.pipeline import System


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(cfg):
    return System(cfg, enable_local_ba=False, enable_global_ba=False,
                  mode="fused", device="cpu")


@pytest.fixture(scope="module")
def probed():
    scene = make_scene(num_frames=5, width=320, height=240, num_objects=2,
                       seed=3)
    cfg = port_config(small_config(scene))
    ds = SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)
    sysm = _system(cfg)
    sysm.run_sequence(ds, max_frames=3)
    tr = sysm.tracker
    before = {"state": [t.clone() for t in _flatten(tr.state)],
              "frame_id": tr.frame_id, "sems": set(tr._stage_last_sems),
              "draws": tr.frame_draws(tr.frame_id),
              "n_archived": sysm.map.num_frames}
    times = tr.calibrate_stage_times(ds[3], rounds=1, n_iters=2)
    after_state = _flatten(tr.state)
    after = {"state": after_state, "frame_id": tr.frame_id,
             "sems": set(tr._stage_last_sems),
             "draws": tr.frame_draws(tr.frame_id)}
    sysm.track_rgbd(ds[3])
    tr.flush()
    plain = _system(cfg)
    plain.run_sequence(ds, max_frames=3)
    plain.track_rgbd(ds[3])
    plain.tracker.flush()
    return {"sysm": sysm, "plain": plain, "times": times, "before": before,
            "after": after, "ds": ds}


def _programs(probed, n_iters=1):
    """The probe's programs over the tracker's state with the last frame
    as its next one, and the (staged inputs, draws) they copied."""
    tr = probed["sysm"].tracker
    staged, draws = tr.probe_inputs(probed["ds"][3])
    probe = make_scan_probe(tr.cfg, "cpu", n_iters=n_iters)
    return probe.programs(tr.state, staged, draws), staged, draws


def test_span_names_are_the_jax_packages():
    assert STAGE_SPANS == jax_multistream.STAGE_SPANS
    assert PROBE_SPANS == jax_multistream.PROBE_SPANS


def test_probe_returns_every_span(probed):
    times = dict(probed["times"])
    assert times.pop("_rtt_ms") >= 0.0
    frame_ms = times.pop("_frame_ms")
    assert frame_ms > 0.0
    assert set(times) == set(PROBE_SPANS)
    assert all(np.isfinite(v) and v >= 0.0 for v in times.values()), times
    total = sum(times.values())
    assert total > 0.0, times
    # what the spans add up to against one whole step (CPU, one thread)
    print(f"spans sum to {total:.3f} ms against a whole packed step of "
          f"{frame_ms:.3f} ms ({total / frame_ms:.3f}x) on the CPU: "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))


def test_timings_archived_past_and_future(probed):
    sysm = probed["sysm"]
    tr = sysm.tracker
    want = np.asarray([max(probed["times"][k], 0.0) for k in STAGE_SPANS],
                      np.float32)
    np.testing.assert_array_equal(tr._stage_ms, want)
    assert tr._probe_rtt_ms == probed["times"]["_rtt_ms"]
    rows = np.stack(sysm.map.timings)
    assert rows.shape == (sysm.map.num_frames, 5)
    assert sysm.map.num_frames > probed["before"]["n_archived"]
    np.testing.assert_array_equal(rows, np.broadcast_to(want, rows.shape))
    assert (rows.sum(axis=1) > 0).all()
    t = sysm.timing()
    assert t["mask_update_ms"] > 0 and t["camera_est_ms"] > 0


def test_probe_leaves_the_run_as_it_was(probed):
    b, a = probed["before"], probed["after"]
    assert a["frame_id"] == b["frame_id"]
    assert a["sems"] == b["sems"]
    assert len(a["state"]) == len(b["state"])
    for x, y in zip(a["state"], b["state"]):
        assert torch.equal(x, y)
    assert set(a["draws"]) == set(b["draws"])
    for k in b["draws"]:
        assert torch.equal(a["draws"][k], b["draws"][k]), k
    pm, qm = probed["sysm"].map, probed["plain"].map
    assert pm.num_frames == qm.num_frames
    for x, y in zip(pm.cam_pose, qm.cam_pose):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(pm.dyn_3d, qm.dyn_3d):
        np.testing.assert_array_equal(x, y)
    assert probed["sysm"].metrics() == probed["plain"].metrics()


def test_probe_defaults_to_the_card(probed):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        make_scan_probe(probed["sysm"].cfg)


def test_times_keep_the_jax_packages_keys(probed):
    assert set(probed["times"]) == (set(jax_multistream.PROBE_SPANS)
                                    | {"_frame_ms", "_rtt_ms"})
    report = probed["sysm"].tracker.probe_report
    assert report["seconds"] > 0
    # no capture on the CPU: the programs ran eagerly
    assert report["graphs"] == [] and report["pool_reserved_bytes"] == 0


def test_span_chain_ends_in_the_packed_steps_vector(probed):
    """The spans, each over the previous span's static outputs, end in
    the output vector of the packed step on the same state, inputs and
    draws; a second pass over the same buffers (a card's replays) too."""
    progs, staged, draws = _programs(probed)
    tr = probed["sysm"].tracker
    _, want = tr._packed_step(tr.state, staged, draws.u, True)
    got = progs.chain().clone()
    assert torch.equal(got, want)
    assert torch.equal(progs.chain(), want)
    assert [c.name for c in progs.spans] == [f"probe span {k}"
                                             for k in PROBE_SPANS]


def test_frame_program_carries_its_state_not_the_trackers(probed):
    """Three calls of the frame program from the tracker's state equal
    three packed steps by hand, its state carried, output vectors and
    final state bit-equal; the tracker's state stays as it was, and
    reset_frame starts the program again from it."""
    tr = probed["sysm"].tracker
    before = [t.clone() for t in _flatten(tr.state)]
    progs, staged, draws = _programs(probed)
    progs.reset_frame()
    vecs = [progs.frame().clone() for _ in range(3)]
    st = tr.state
    for vec in vecs:
        st, want = tr._packed_step(st, staged, draws.u, True)
        assert torch.equal(vec, want)
    for a, b in zip(_flatten(progs.frame_state.tree), _flatten(st),
                    strict=True):
        assert torch.equal(a, b)
    for a, b in zip(_flatten(tr.state), before, strict=True):
        assert torch.equal(a, b)
    progs.reset_frame()
    assert torch.equal(progs.frame(), vecs[0])
