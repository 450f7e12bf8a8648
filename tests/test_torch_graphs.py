"""The port's compiled-program layer (vdo_slam_tpu_torch/utils/
cuda_graph.py) on its CPU path: the fused tracker, the S-stream system and
the window solve run on the same static buffers the card's graphs run on,
eagerly, and are held here to the eager functions called by hand.

  * the graphed FusedTracker against a hand-driven loop of make_frame_step
    (fused_chunk 1 and 4, and a padded tail chunk): archive and final state
    bit-equal;
  * a 2-stream MultiStreamSystem against its batched step driven by hand;
  * each window-solve tier against lm_solve_schur called directly, and
    with the solver "lm" against lm_solve;
  * what a caller holds (a report, a state, a chunk's output vectors, the
    archive) unchanged by the next step: the static outputs are copied out;
  * a checkpoint resumed mid-run against the uninterrupted run;
  * step_chunk with a caller's own state, threaded chunk after chunk,
    against the tracker's own drive;
  * StaticTree's one-copy load of a snapshot and its writes that read
    the buffers they write.

Everything is CPU arithmetic on the same ops in the same order, so the
comparisons are exact.  The card's side (graphed against eager, launch
counts) is in tests/test_torch_kernel_cuda.py and chip_smoke.py phase 16.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from vdo_slam_tpu_torch.backend import builders
from vdo_slam_tpu_torch.backend.factor_graph import (fetch, lm_solve,
                                                     lm_solve_schur, upload)
from vdo_slam_tpu_torch.backend.window_ba import (WindowGraphs, _lm_params,
                                                  local_ba_inplace,
                                                  warmup_window_ba)
from vdo_slam_tpu_torch.config import (KITTI, ShapeConfig, TrackingConfig,
                                       VDOConfig)
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.io.synthetic import make_scene
from vdo_slam_tpu_torch.parallel import MultiStreamSystem
from vdo_slam_tpu_torch.parallel.multistream import (_flatten,
                                                     make_frame_step,
                                                     make_stream_state,
                                                     stack_states)
from vdo_slam_tpu_torch.pipeline import System
from vdo_slam_tpu_torch.pipeline import draws as draws_mod
from vdo_slam_tpu_torch.pipeline.fused import (FusedTracker, pack_outputs,
                                               unpack_host)
from vdo_slam_tpu_torch.pipeline.tracking import _np_inv
from vdo_slam_tpu_torch.utils import checkpoint
from vdo_slam_tpu_torch.utils.cuda_graph import (GraphedCall, StaticTree,
                                                 tree_flatten)

# tpu_fast's wire (the bench's), as the slice tests run it
WIRE = dict(wire_flow_half=True, wire_flow_delta=True, wire_entropy=True,
            fused_drain_chunks=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs this file in one of several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_cfg(w=96, h=64, **tracking):
    """tests/test_multistream.py's tiny_config in the port's classes."""
    cfg = VDOConfig()
    return cfg.replace(
        camera=dataclasses.replace(cfg.camera, fx=float(w), fy=float(w),
                                   cx=w / 2.0, cy=h / 2.0, width=w, height=h,
                                   bf=40.0),
        tracking=dataclasses.replace(
            TrackingConfig(), dataset=KITTI, depth_map_factor=1.0,
            boundary_shrink_row=4, boundary_shrink_col=6,
            min_obj_points=20, min_init_inliers=10, **tracking),
        shapes=ShapeConfig(max_static=128, max_dynamic=256, max_objects=4,
                           ransac_samples=32),
        frontend=dataclasses.replace(cfg.frontend, n_features=200,
                                     n_levels=2))


def _ds(seed=1, n=9, w=96, h=64):
    return SyntheticDataset(make_scene(num_frames=n, width=w, height=h,
                                       num_objects=1, seed=seed),
                            depth_map_factor=1.0, bf=40.0)


@pytest.fixture(scope="module")
def tiny_ds():
    return _ds()


def _hand_loop(cfg, fds):
    """make_frame_step called by hand on `fds` (frame f with frame f's
    draws), staged as the tracker stages: (output vectors, final state)."""
    step = make_frame_step(cfg, "cpu", packed=True)
    stager = FusedTracker(cfg, device="cpu", build_step=False)
    st = make_stream_state(cfg, "cpu")
    vecs = []
    for f, fd in enumerate(fds):
        inputs = stager.device_inputs(fd)
        inputs.pop("_T_cw_gt_host")
        draws = draws_mod.UniformDraws(draws_mod.frame_uniforms(
            cfg, f, torch.Generator()))
        st, m = step(st, inputs, draws, f > 0)
        vecs.append(pack_outputs(st, m))
    return vecs, st


def _host(cfg, vec):
    sh = cfg.shapes
    return unpack_host(vec.numpy(), sh.max_static, sh.max_dynamic,
                       sh.max_objects)


def _assert_states_equal(a, b):
    for x, y in zip(_flatten(a), _flatten(b), strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("chunk,n", [(1, 6), (4, 8), (4, 7)],
                         ids=["frames", "chunks", "padded_tail"])
def test_fused_tracker_equals_hand_loop(tiny_ds, chunk, n):
    """System(mode="fused") over n frames in chunks of `chunk` (7 = one
    chunk of 4 and a tail of 3 padded with its last frame) against the
    step called by hand on the same frames (the padding included): every
    archived pose and bank, and the final state, bit-equal."""
    cfg = _tiny_cfg(fused_chunk=chunk, **WIRE)
    sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  mode="fused", device="cpu")
    reps = sysm.run_sequence(tiny_ds, max_frames=n)
    assert [r["frame_id"] for r in reps] == list(range(n))
    fds = [tiny_ds[i] for i in range(n)]
    fds += [fds[-1]] * (-n % chunk)
    vecs, st = _hand_loop(cfg, fds)
    assert sysm.tracker.frame_id == len(fds)
    m = sysm.map
    for f in range(n):
        h = _host(cfg, vecs[f])
        np.testing.assert_array_equal(m.cam_pose[f], _np_inv(h["T_cw"]))
        np.testing.assert_array_equal(m.stat_xy[f], h["stat"][0])
        np.testing.assert_array_equal(m.dyn_xy[f], h["dyn"][0])
        np.testing.assert_array_equal(m.dyn_obj_label[f], h["dyn"][5])
    _assert_states_equal(sysm.tracker.state, st)


def test_multistream_equals_hand_batched_step():
    """MultiStreamSystem(S = 2) against its eager batched step driven by
    hand from stacked fresh states with the same staging and draws: every
    stream's archive and the final stacked state bit-equal."""
    cfg = _tiny_cfg(**WIRE)
    dss = [_ds(seed=s, n=6) for s in (1, 2)]
    msys = MultiStreamSystem(cfg, n_streams=2, enable_local_ba=False,
                             device="cpu")
    msys.run(dss)
    hand = MultiStreamSystem(cfg, n_streams=2, enable_local_ba=False,
                             device="cpu")
    g = hand.groups[0]
    states = stack_states([make_stream_state(cfg, "cpu")] * 2)
    for f in range(len(dss[0])):
        staged = hand._stage([d[f] for d in dss])[0]
        staged.pop("_gts_host")
        states, vecs = g.step(states, staged, hand._frame_draws(f)[0],
                              f > 0)
        for s in range(2):
            h = _host(cfg, vecs[s])
            np.testing.assert_array_equal(msys.maps[s].cam_pose[f],
                                          _np_inv(h["T_cw"]))
            np.testing.assert_array_equal(msys.maps[s].stat_xy[f],
                                          h["stat"][0])
    _assert_states_equal(msys.groups[0].states, states)


@pytest.fixture(scope="module")
def tracked_map(tiny_ds):
    """The port's map of the 9-frame tiny scene, BA off."""
    cfg = _tiny_cfg(**WIRE)
    sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  mode="fused", device="cpu")
    sysm.run_sequence(tiny_ds)
    return sysm.map, cfg


@pytest.mark.parametrize("tier", range(len(builders.WINDOW_TIERS)))
def test_window_tier_equals_direct_solve(tracked_map, monkeypatch, tier):
    """A window graph padded to each WINDOW_TIERS entry, solved three
    times through WindowGraphs (the warm-up, the capture's call and a
    replay's on a card) against lm_solve_schur called directly on the
    uploaded graph: every output equal."""
    m, cfg = tracked_map
    monkeypatch.setattr(builders, "WINDOW_TIERS",
                        (builders.WINDOW_TIERS[tier],))
    g, v, meta = builders.build_window_graph(m, cfg, window=6)
    assert v.points.shape[0] == builders.WINDOW_TIERS[0][0]
    assert meta.n_static_points > 10
    p = _lm_params(cfg)
    vd, infod = lm_solve_schur(*upload(g, v, "cpu"), p)
    want = fetch((vd, infod))
    graphs = WindowGraphs("cpu")
    for _ in range(3):
        with graphs.solve(g, v, p) as out:
            got = fetch(out)
        for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0],
                        strict=True):
            np.testing.assert_array_equal(a, b)
    assert len(graphs._solves) == 1
    assert float(want[1]["cost"]) < float(want[1]["cost0"])


@pytest.mark.parametrize("tier", range(len(builders.WINDOW_TIERS)))
def test_window_tier_lm_equals_direct_solve(tracked_map, monkeypatch, tier):
    """The window solver "lm" (matrix-free PCG) through WindowGraphs, three
    solves as above, against lm_solve called directly on the uploaded
    graph: every output equal; the same window solved with "schur" is a
    graph of its own (the graphs are keyed on the solver), and
    local_ba_inplace(solver="lm") through the caller's graphs writes the
    same map as through its own."""
    m, cfg = tracked_map
    monkeypatch.setattr(builders, "WINDOW_TIERS",
                        (builders.WINDOW_TIERS[tier],))
    g, v, _ = builders.build_window_graph(m, cfg, window=6)
    p = _lm_params(cfg)
    vd, infod = lm_solve(*upload(g, v, "cpu"), p)
    want = fetch((vd, infod))
    graphs = WindowGraphs("cpu")
    for _ in range(3):
        with graphs.solve(g, v, p, solver="lm") as out:
            got = fetch(out)
        for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0],
                        strict=True):
            np.testing.assert_array_equal(a, b)
    assert float(want[1]["cost"]) < float(want[1]["cost0"])
    with graphs.solve(g, v, p):
        pass
    assert sorted(k[1] for k in graphs._solves) == ["lm", "schur"]
    ma, mb = copy.deepcopy(m), copy.deepcopy(m)
    ra = local_ba_inplace(ma, cfg, window=6, solver="lm", device="cpu",
                          graphs=graphs)
    rb = local_ba_inplace(mb, cfg, window=6, solver="lm", device="cpu")
    assert (ra["cost0"], ra["cost"]) == (float(want[1]["cost0"]),
                                         float(want[1]["cost"]))
    assert (ra["cost0"], ra["cost"]) == (rb["cost0"], rb["cost"])
    np.testing.assert_array_equal(np.stack(ma.cam_pose),
                                  np.stack(mb.cam_pose))


def test_local_ba_through_graphs_equals_its_own(tracked_map):
    """local_ba_inplace with a WindowGraphs of the caller (warmed on every
    tier first, as System warms it on a card) against the same solve with
    one of its own: the same report costs and the same written-back map."""
    m, cfg = tracked_map
    graphs = WindowGraphs("cpu")
    warmup_window_ba(cfg, graphs, window=6)
    assert len(graphs._solves) == len(builders.WINDOW_TIERS)
    ma, mb = copy.deepcopy(m), copy.deepcopy(m)
    ra = local_ba_inplace(ma, cfg, window=6, device="cpu", graphs=graphs)
    rb = local_ba_inplace(mb, cfg, window=6, device="cpu")
    assert (ra["cost0"], ra["cost"]) == (rb["cost0"], rb["cost"])
    np.testing.assert_array_equal(np.stack(ma.cam_pose),
                                  np.stack(mb.cam_pose))
    for a, b in zip(ma.stat_3d, mb.stat_3d, strict=True):
        np.testing.assert_array_equal(a, b)


def test_held_values_survive_the_next_step(tiny_ds):
    """A report, a state read at frame f, a chunk's output vectors and the
    archive stay as they were after frame f + 1 overwrites the graph's
    buffers."""
    cfg = _tiny_cfg(**WIRE)
    tr = FusedTracker(cfg, device="cpu")
    for i in range(3):
        tr.grab_frame(tiny_ds[i])
    held_state = tr.state
    before = [x.clone() for x in _flatten(held_state)]
    rep = tr.grab_frame(tiny_ds[3])          # the report of frame 2
    T_rep = rep["T_cw"].copy()
    archived = [a.copy() for a in (tr.map.cam_pose[-1], tr.map.stat_xy[-1])]
    tr.grab_frame(tiny_ds[4])
    tr.grab_frame(tiny_ds[5])
    for x, y in zip(_flatten(held_state), before, strict=True):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(rep["T_cw"], T_rep)
    np.testing.assert_array_equal(tr.map.cam_pose[2], archived[0])
    np.testing.assert_array_equal(tr.map.stat_xy[2], archived[1])
    assert not np.array_equal(tr.map.cam_pose[2], tr.map.cam_pose[4])

    c4 = FusedTracker(_tiny_cfg(fused_chunk=4, **WIRE), device="cpu")
    staged = [c4.device_inputs_chunk([tiny_ds[i + k] for k in range(4)])
              for i in (0, 4)]
    for s in staged:
        s.pop("_T_cw_gt_host")
    st0, vecs0 = c4.step_chunk(c4.state, staged[0], 0)
    held = vecs0.clone(), [x.clone() for x in _flatten(st0)]
    c4.step_chunk(st0, staged[1], 4)
    assert torch.equal(vecs0, held[0])
    for x, y in zip(_flatten(st0), held[1], strict=True):
        assert torch.equal(x, y)


def test_resume_mid_run_equals_uninterrupted(tiny_ds, tmp_path):
    """A chunked fused run cut after two chunks, checkpointed and resumed
    in a fresh System (its state copied into the fresh tracker's buffers)
    against the uninterrupted run: equal archives and final state."""
    cfg = _tiny_cfg(fused_chunk=2, **WIRE)

    def system():
        return System(cfg, enable_local_ba=False, enable_global_ba=False,
                      mode="fused", device="cpu")

    whole = system()
    whole.run_sequence(tiny_ds, max_frames=8)
    first = system()
    first.run_sequence(tiny_ds, max_frames=4)
    ck = tmp_path / "ck.pkl"
    checkpoint.save_fused_checkpoint(first.tracker, ck)
    resumed = system()
    checkpoint.load_fused_checkpoint(resumed.tracker, ck)
    assert resumed.tracker.initialized and resumed.tracker.frame_id == 4

    class _Tail:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return tiny_ds[4 + i]

    resumed.run_sequence(_Tail())
    assert resumed.map.num_frames == whole.map.num_frames == 8
    np.testing.assert_array_equal(np.stack(resumed.map.cam_pose),
                                  np.stack(whole.map.cam_pose))
    _assert_states_equal(resumed.tracker.state, whole.tracker.state)


def test_step_chunk_with_callers_state_equals_tracker_drive(tiny_ds):
    """A caller's drive (`state = tr.state`, then `state, vecs =
    tr.step_chunk(state, ...)` chunk after chunk) against the tracker's own
    chunk steps (grab_chunk's), and a foreign state handed to step_chunk
    against the same state stepped by hand."""
    cfg = _tiny_cfg(fused_chunk=4, **WIRE)
    own, probe = (FusedTracker(cfg, device="cpu") for _ in range(2))
    staged = [own.device_inputs_chunk([tiny_ds[i + k] for k in range(4)])
              for i in (0, 4)]
    probe_staged = [probe.device_inputs_chunk([tiny_ds[i + k]
                                               for k in range(4)])
                    for i in (0, 4)]
    for s in staged + probe_staged:
        s.pop("_T_cw_gt_host")
    state = probe.state
    for i in range(2):
        want = own._step_chunk(staged[i], 4 * i)
        state, vecs = probe.step_chunk(state, probe_staged[i], 4 * i)
        assert torch.equal(vecs, want)
    _assert_states_equal(state, own.state)

    # a state of the caller's own, not the tracker's: frames 4-7 from the
    # state after frame 3, stepped by hand
    vecs_hand, st_hand = _hand_loop(cfg, [tiny_ds[i] for i in range(8)])
    fresh = FusedTracker(cfg, device="cpu")
    fresh.initialized = True
    _, st3 = _hand_loop(cfg, [tiny_ds[i] for i in range(4)])
    st, vecs = fresh.step_chunk(st3, staged[1], 4)
    assert torch.equal(vecs, torch.stack(vecs_hand[4:]))
    _assert_states_equal(st, st_hand)


def test_static_tree_loads_a_snapshot_in_one_copy_and_writes_safely():
    """A snapshot (one buffer at the tree's layout) is recognized for a
    one-copy load, a tree of separate tensors is not; and a write whose new
    values are the buffers it writes (a swap of two leaves, one through a
    transposed view, and a leaf passed through) writes the values they had
    before it."""
    like = {"x": torch.arange(4, dtype=torch.float32).reshape(2, 2),
            "y": torch.arange(4, dtype=torch.float32).reshape(2, 2) + 10,
            "n": torch.tensor([7, 8, 9], dtype=torch.int64),
            "c": torch.tensor([True, False])}
    tree = StaticTree(like, "cpu")
    tree.load(like)
    snap = tree.snapshot()
    assert tree._same_layout(tree_flatten(snap)[0]) is not None
    assert tree._same_layout(tree_flatten(like)[0]) is None
    tree.tree["x"].zero_()
    tree.load(snap)
    assert torch.equal(tree.tree["x"], like["x"])
    t = tree.tree
    tree.write({"x": t["y"].t(), "y": t["x"], "n": t["n"], "c": t["c"]})
    assert torch.equal(t["x"], like["y"].t())
    assert torch.equal(t["y"], like["x"])
    assert torch.equal(t["n"], like["n"]) and torch.equal(t["c"], like["c"])


def test_graphed_call_outputs_are_static_on_the_cpu():
    """On the CPU a GraphedCall runs fn every call and returns the same
    output tensors, overwritten: what the card's replays return."""
    box = {"x": torch.zeros(3)}
    call = GraphedCall(lambda: {"y": box["x"] + 1}, "cpu", "test")
    first = call()
    y0 = first["y"].clone()
    box["x"] = torch.ones(3)
    second = call()
    assert second["y"] is first["y"]
    assert torch.equal(y0, torch.ones(3))
    assert torch.equal(first["y"], torch.full((3,), 2.0))
