"""GPU-only tests of the port: the CUDA FAST kernel bit for bit against its
plain version (one level and a whole pyramid per launch, and the pyramids
of S = 4 and S = 6 streams' decoded frames in one launch, held stream by
stream), the
wire decode on the card against the CPU's, the packed fused step and the
S-stream system on the card against the same on the CPU, the host Tracker
(System mode "reference") on the card against the same on the CPU with
one FAST launch per frame (none with grid-sampled keypoints) and its
one-copy host reads, one frame of a barrel-distorted bench scene stepped
from one state on the card and on the CPU, that scene's frame 0 stage by
stage (bit-equal to the CPU's once fed the CPU's pyramid levels; the same
sets of keypoints with seeded noise), both BA solvers on the card
against the same solve on the CPU, a window solve on a fused tracker's
solve thread and stream against the same solve inline, the edge-sharded
full solve and
full_ba_inplace over ["cuda:0"] * n, S = 2 streams spread over
["cuda:0", "cuda:0"] (two FAST launches per frame) against one group on
the card, and the CUDA graphs (utils/cuda_graph.py): the graphed fused
tracker and S = 4 system against their steps called op by op on the card
(the step's card-vs-CPU bounds), KERNEL.launches up by one per replayed
frame, each window-solve tier's graph against lm_solve_schur op by op
(cost within 1e-5 relative, poses within 1e-4), the full BA's graph
against the eager full BA (cost within 1e-5 relative, poses within
1e-5), the edge-sharded full BA's graphs over ["cuda:0"] * n and the
window solver "lm"'s graph against their eager solves (cost within 1e-6
relative), the stage probe's spans against the profiler's device time of
each span's graph, each host Tracker stage's replay against its eager
call on the same inputs, and the small linear solves of the step and the
window solve captured and replayed bit-equal to the eager call, and the
edge Hessian-vector kernels (csrc/edge_hessian.cu) against their plain
version on the card at the 1,028-frame refine's caps, at a window's shapes
and with F and M above the shared-memory budget, with the launches a
graphed full BA counts.  Every test here skips without a CUDA device.  This file imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py

Tolerances: the kernel is held to atol=0 (it only subtracts, compares and
takes mins and maxes).  The step on the card sums in another order (float
atomics in index_add_, other reduction trees, float64 normal equations in
the LM) and resizes the pyramid with another kernel (~1e-6 apart, which
reorders tied FAST scores), so it is held to the bounds the JAX-vs-port
slice test uses: the same active object slots, T_cw within 1e-3 m and
0.01 deg per frame.  The wire decode is integer work and elementwise float
work: atol = 0 against the CPU for every output of every layout.  The BA solves (window Schur and chunked full LM+PCG,
on graphs the port's builders make from a map the port tracked on the
CPU) sum with float atomics on the card: pose entries within 1e-4, points
within 1e-3 m plus 2e-4 of the coordinate, final costs within 1e-4 of the
starting cost, as the JAX-vs-port CPU tests hold them.  The edge Hessian
product H t (and H t + damp * t, Dinv r) is held to its plain version on
the card within 1e-5 relative to each output's largest entry: both sum in
float32, the kernels with float atomics in another order (and another from
run to run), after warp and shared-memory partial sums.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vdo_slam_tpu_torch.config import KITTI, ShapeConfig, VDOConfig
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.io.synthetic import make_scene
from vdo_slam_tpu_torch.ops import fast
from vdo_slam_tpu_torch.ops.fast_cuda import (KERNEL, MAX_LEVELS,
                                              fast_score_pair,
                                              fast_score_pyramid)
from vdo_slam_tpu_torch.parallel.multistream import (make_frame_step,
                                                     make_stream_state)
from vdo_slam_tpu_torch.pipeline.fused import FusedTracker

pytestmark = pytest.mark.cuda
TH_INI, TH_MIN = 20 / 255.0, 7 / 255.0


@pytest.fixture(autouse=True)
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _binary(shape, seed):
    return (np.random.default_rng(seed).random(shape) > 0.5).astype(np.float32)


@pytest.mark.parametrize("shape,seed", [((120, 200), 0), ((97, 131), 1),
                                        ((3, 64, 150), 2), ((7, 7), 3)])
def test_kernel_equals_plain(shape, seed):
    g = torch.from_numpy(_binary(shape, seed)).cuda()
    before = KERNEL.launches
    k_ini, k_min = fast_score_pair(g, TH_INI, TH_MIN)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert torch.equal(k_ini, fast.fast_score(g, TH_INI))
    assert torch.equal(k_min, fast.fast_score(g, TH_MIN))


def test_kernel_on_pyramid_and_threshold_ties():
    frame = make_scene(num_frames=2, width=320, height=240, seed=3).rgb[0]
    for g in fast.pyramid(torch.from_numpy(frame).cuda()):
        k_ini, k_min = fast_score_pair(g, TH_INI, TH_MIN)
        torch.cuda.synchronize()
        assert torch.equal(k_ini, fast.fast_score(g, TH_INI))
        assert torch.equal(k_min, fast.fast_score(g, TH_MIN))
    # differences landing exactly on fp32(20/255): compared as float
    th = float(np.float32(TH_INI))
    img = np.zeros((16, 16), np.float32)
    img[:, 8:] = th
    g = torch.from_numpy(img).cuda()
    assert torch.equal(fast_score_pair(g, TH_INI, TH_MIN)[0],
                       fast.fast_score(g, TH_INI))


def test_kernel_rejects_cpu_only_layouts():
    with pytest.raises(ValueError):
        fast_score_pair(torch.zeros(20, 40, device="cuda")[:, ::2], TH_INI,
                        TH_MIN)


def _bench_levels(n_frames):
    """The 8 pyramid levels of the bench scene's first frames (1242x375),
    (H_l, W_l) for one frame, (n_frames, H_l, W_l) for more."""
    rgb = make_scene(num_frames=n_frames, width=1242, height=375,
                     num_objects=3, fx=721.5377, seed=7).rgb
    per_frame = [fast.pyramid(torch.from_numpy(f).cuda()) for f in rgb]
    if n_frames == 1:
        return per_frame[0]
    return [torch.stack(lv).contiguous() for lv in zip(*per_frame)]


def _tie_image():
    img = np.zeros((16, 16), np.float32)
    img[:, 8:] = np.float32(TH_INI)
    img[5:9, 8:] = 1.0
    return img


@pytest.mark.parametrize("case", ["bench_8_levels", "bench_S3", "7x7",
                                  "ties"])
def test_pyramid_equals_plain(case):
    if case == "bench_8_levels":
        levels = _bench_levels(1)
    elif case == "bench_S3":
        levels = _bench_levels(3)
    elif case == "7x7":
        levels = [torch.from_numpy(_binary((7, 7), 3)).cuda()]
    else:
        levels = [torch.from_numpy(_tie_image()).cuda(),
                  torch.from_numpy(_binary((40, 70), 4)).cuda()]
    for th_ini, th_min in ((TH_INI, TH_MIN), (TH_MIN, TH_INI)):
        before = KERNEL.launches
        pairs = fast_score_pyramid(levels, th_ini, th_min)
        torch.cuda.synchronize()
        assert KERNEL.launches == before + 1
        for g, (k_ini, k_min) in zip(levels, pairs):
            assert k_ini.shape == g.shape and k_ini.is_contiguous()
            assert torch.equal(k_ini, fast.fast_score(g, th_ini))
            assert torch.equal(k_min, fast.fast_score(g, th_min))


@pytest.mark.parametrize("bad,err", [
    (lambda: [torch.zeros(20, 20, dtype=torch.float64, device="cuda")],
     TypeError),
    (lambda: [torch.zeros(20, 40, device="cuda")[:, ::2]], ValueError),
    (lambda: [torch.zeros(2, 20, 20, device="cuda"),
              torch.zeros(3, 9, 9, device="cuda")], ValueError),
    (lambda: [torch.zeros(16, 16, device="cuda")] * (MAX_LEVELS + 1),
     ValueError),
], ids=["fp64", "strided", "mixed_S", "too_many"])
def test_pyramid_rejects(bad, err):
    before = KERNEL.launches
    with pytest.raises(err):
        fast_score_pyramid(bad(), TH_INI, TH_MIN)
    assert KERNEL.launches == before


class NumpyDraws:
    """The same draws on either device, from a numpy generator."""

    def __init__(self, seed, device):
        self.rng = np.random.default_rng(seed)
        self.device = device

    def _u(self, shape):
        return torch.from_numpy(self.rng.random(shape, dtype=np.float32)).to(
            self.device)

    def object_priority(self, n):
        return self._u((n,))

    def renew_priority(self, n):
        return self._u((n,))

    def camera_picks(self, n_samples, n_valid):
        u = self._u((n_samples, 3))
        return torch.minimum((u * n_valid).long(), n_valid - 1)

    def object_picks(self, n_samples, n_valid):
        u = self._u(tuple(n_valid.shape) + (n_samples, 3))
        n = n_valid[:, None, None]
        return torch.minimum((u * n).long(), n - 1)

    def sample_offsets(self, n_div, per_cell):
        return self._u((2, n_div, n_div, per_cell))

    def depth_noise(self, n):
        return torch.from_numpy(self.rng.standard_normal(
            n, dtype=np.float32)).to(self.device)


def _small_cfg():
    cfg = VDOConfig()
    return cfg.replace(
        camera=dataclasses.replace(cfg.camera, fx=320.0, fy=320.0, cx=160.0,
                                   cy=120.0, width=320, height=240, bf=40.0),
        tracking=dataclasses.replace(cfg.tracking, dataset=KITTI,
                                     depth_map_factor=1.0,
                                     boundary_shrink_row=8,
                                     boundary_shrink_col=12,
                                     min_obj_points=40, min_init_inliers=20),
        shapes=ShapeConfig(max_static=600, max_dynamic=2048, max_objects=8,
                           ransac_samples=128),
        frontend=dataclasses.replace(cfg.frontend, n_features=1200,
                                     n_levels=3))


def test_step_on_card_matches_cpu():
    """The packed step (the wire decode in front of the body) on the card
    against the CPU's, on the same wire buffers and draws."""
    scene = make_scene(num_frames=6, width=320, height=240, num_objects=2,
                       seed=3)
    cfg = _small_cfg()
    ds = SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)
    poses = {}
    for dev in ("cpu", "cuda"):
        step = make_frame_step(cfg, dev, packed=True)
        stager = FusedTracker(cfg, device=dev, build_step=False)
        draws = NumpyDraws(0, dev)
        st = make_stream_state(cfg, dev)
        poses[dev] = []
        for f in range(len(ds)):
            inputs = stager.device_inputs(ds[f])
            inputs.pop("_T_cw_gt_host")
            st, m = step(st, inputs, draws, f > 0)
            act = m["slot_active"].cpu().numpy()
            poses[dev].append((st.frame.T_cw.cpu().numpy().astype(np.float64),
                               set(m["slot_sem"].cpu().numpy()[act].tolist())))
    for (Tc, sc), (Tg, sg) in zip(poses["cpu"], poses["cuda"]):
        assert sc == sg
        E = np.linalg.inv(Tc) @ Tg
        s = np.array([E[2, 1] - E[1, 2], E[0, 2] - E[2, 0], E[1, 0] - E[0, 1]])
        dt = np.linalg.norm(Tg[:3, 3] - Tc[:3, 3])
        dr = np.degrees(np.arcsin(min(0.5 * np.linalg.norm(s), 1.0)))
        assert dt < 1e-3 and dr < 0.01, (dt, dr)


WIRES = {
    "dense_delta": dict(wire_flow_delta=True),
    "down4_resid": dict(wire_flow_down=4, wire_depth_down=2,
                        wire_depth_resid=64),
    "tpu_fast": dict(wire_flow_half=True, wire_flow_delta=True,
                     wire_entropy=True),
}


@pytest.mark.parametrize("wire", list(WIRES))
def test_unpack_on_card_equals_cpu(wire):
    from vdo_slam_tpu_torch.pipeline.stages import make_unpack

    scene = make_scene(num_frames=4, width=321, height=239, num_objects=2,
                       seed=3)
    cfg = _small_cfg()
    cfg = cfg.replace(
        camera=dataclasses.replace(cfg.camera, width=321, height=239),
        tracking=dataclasses.replace(cfg.tracking, **WIRES[wire]))
    ds = SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)
    stager = FusedTracker(cfg, device="cpu", build_step=False)
    staged = stager.device_inputs_chunk([ds[i] for i in range(3)])
    unpack = make_unpack(cfg)
    on_cpu = unpack(staged)
    on_card = unpack({k: v.cuda() for k, v in staged.items()
                      if torch.is_tensor(v)})
    for k in ("rgb", "depth_raw", "flow", "seg"):
        assert on_card[k].shape[0] == 3
        assert torch.equal(on_card[k].cpu(), on_cpu[k]), k


def _batched_kernel_held_per_stream(S):
    """The launch the S-stream step makes: the pyramids of S decoded
    bench frames, S in the kernel's grid, against the plain version per
    stream."""
    from vdo_slam_tpu_torch.io.packing import pack_frame, unpack_frame

    scene = make_scene(num_frames=S + 1, width=1242, height=375,
                       num_objects=3, fx=721.5377, seed=7)
    ds = SyntheticDataset(scene, depth_map_factor=256.0, bf=387.5744)
    bufs = np.stack([pack_frame(fd.rgb, fd.depth_raw, fd.flow, fd.mask)
                     for fd in (ds[i] for i in range(S))])
    gray = unpack_frame(torch.from_numpy(bufs).cuda())[0]
    levels = fast.pyramid(gray, 8, 1.2)
    assert all(lv.is_contiguous() and lv.shape[0] == S for lv in levels)
    before = KERNEL.launches
    pairs = fast_score_pyramid(levels, TH_INI, TH_MIN)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    for g, (k_ini, k_min) in zip(levels, pairs):
        for s in range(S):
            assert torch.equal(k_ini[s], fast.fast_score(g[s], TH_INI))
            assert torch.equal(k_min[s], fast.fast_score(g[s], TH_MIN))


def test_batched_kernel_equals_plain_per_stream():
    _batched_kernel_held_per_stream(4)


def test_batched_kernel_equals_plain_per_stream_at_s6():
    """bench --throughput's S = 6: 8.65 M pixels in one launch."""
    _batched_kernel_held_per_stream(6)


def test_multistream_system_on_card_matches_cpu_and_launches_once():
    """S = 2 on the card: one FAST launch per frame for both streams, and
    every stream within the step's card-vs-CPU bounds of the CPU system."""
    from vdo_slam_tpu_torch.parallel import MultiStreamSystem

    scenes = [make_scene(num_frames=6, width=320, height=240, num_objects=2,
                         seed=s) for s in (3, 9)]
    cfg = _small_cfg()
    cfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, **WIRES["tpu_fast"]))
    dss = [SyntheticDataset(s, depth_map_factor=1.0, bf=40.0) for s in scenes]
    maps = {}
    for dev in ("cpu", "cuda"):
        msys = MultiStreamSystem(cfg, n_streams=2, enable_local_ba=False,
                                 device=dev)
        before = KERNEL.launches
        msys.run(dss)
        assert KERNEL.launches - before == (len(dss[0]) if dev == "cuda"
                                            else 0)
        maps[dev] = msys.maps
    for mc, mg in zip(maps["cpu"], maps["cuda"]):
        assert mc.sem_label == mg.sem_label
        for Tc, Tg in zip(mc.cam_pose, mg.cam_pose):
            assert _pose_gap_ok(Tc, Tg)


def _pose_gap_ok(Tc, Tg):
    """Tg within 1e-3 m and 0.01 deg of Tc (the step's card-vs-CPU
    bounds)."""
    E = np.linalg.inv(Tc.astype(np.float64)) @ Tg.astype(np.float64)
    s = np.array([E[2, 1] - E[1, 2], E[0, 2] - E[2, 0], E[1, 0] - E[0, 1]])
    dr = np.degrees(np.arcsin(min(0.5 * np.linalg.norm(s), 1.0)))
    return np.linalg.norm(E[:3, 3]) < 1e-3 and dr < 0.01


def test_grouped_streams_on_card():
    """S = 2 over ["cuda:0", "cuda:0"]: two groups of one stream, one FAST
    launch per group per frame, each stream within the card-vs-CPU bounds
    of the one-group run on the card."""
    from vdo_slam_tpu_torch.parallel import MultiStreamSystem

    scenes = [make_scene(num_frames=6, width=320, height=240, num_objects=2,
                         seed=s) for s in (3, 9)]
    cfg = _small_cfg()
    cfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, **WIRES["tpu_fast"]))
    dss = [SyntheticDataset(s, depth_map_factor=1.0, bf=40.0) for s in scenes]
    maps = {}
    for groups, devices in ((1, ["cuda:0"]), (2, ["cuda:0", "cuda:0"])):
        msys = MultiStreamSystem(cfg, n_streams=2, enable_local_ba=False,
                                 devices=devices)
        assert len(msys.groups) == groups
        before = KERNEL.launches
        msys.run(dss)
        assert KERNEL.launches - before == groups * len(dss[0])
        maps[groups] = msys.maps
    for m1, m2 in zip(maps[1], maps[2]):
        assert m1.sem_label == m2.sem_label
        for T1, T2 in zip(m1.cam_pose, m2.cam_pose):
            assert _pose_gap_ok(T1, T2)


def _reference_run(cfg, ds, dev):
    """System mode "reference" on `dev` with the tracker's own draws
    (pipeline/draws.py: the same on either device); returns (reports, FAST
    launches)."""
    from vdo_slam_tpu_torch.pipeline import System

    sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  device=dev)
    before = KERNEL.launches
    reps = sysm.run_sequence(ds)
    return reps, KERNEL.launches - before


@pytest.mark.parametrize("option", ["fast", "sample_feature"])
def test_reference_tracker_on_card_matches_cpu(option):
    """The host Tracker on the card against the CPU's, the same frames and
    draws: one FAST launch per frame, none with grid-sampled keypoints."""
    scene = make_scene(num_frames=6, width=320, height=240, num_objects=2,
                       seed=3)
    cfg = _small_cfg()
    if option == "sample_feature":
        cfg = cfg.replace(frontend=dataclasses.replace(
            cfg.frontend, use_sample_feature=True, n_sample_points=1500))
    ds = SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)
    (cpu, n_cpu), (card, n_card) = (_reference_run(cfg, ds, d)
                                    for d in ("cpu", "cuda"))
    assert n_cpu == 0
    assert n_card == (0 if option == "sample_feature" else len(ds))
    for rc, rg in zip(cpu, card):
        assert ([(o["model_label"], o["sem_label"], o["status"])
                 for o in rc["objects"]]
                == [(o["model_label"], o["sem_label"], o["status"])
                    for o in rg["objects"]])
        Tc = np.asarray(rc["T_cw"], np.float64)
        Tg = np.asarray(rg["T_cw"], np.float64)
        E = np.linalg.inv(Tc) @ Tg
        s = np.array([E[2, 1] - E[1, 2], E[0, 2] - E[2, 0], E[1, 0] - E[0, 1]])
        dr = np.degrees(np.arcsin(min(0.5 * np.linalg.norm(s), 1.0)))
        assert np.linalg.norm(Tg[:3, 3] - Tc[:3, 3]) < 1e-3 and dr < 0.01
    assert sum(o["status"] for r in card for o in r["objects"]) >= 6


DIST = (-0.28, 0.07, 0.0, 0.0, 0.0)    # tests/test_pipeline_e2e.py:258


def _bench_cfg(k1: float = 0.0, k2: float = 0.0):
    """chip_smoke.py's bench_config (bench.py's, tpu_fast's LM budgets) at
    1242x375, with the lens's k1/k2 configured."""
    cfg = VDOConfig()
    return cfg.replace(
        camera=dataclasses.replace(
            cfg.camera, fx=721.5377, fy=721.5377, cx=621.0, cy=187.5,
            width=1242, height=375, bf=387.5744, k1=k1, k2=k2),
        tracking=dataclasses.replace(cfg.tracking, dataset=KITTI,
                                     depth_map_factor=256.0),
        shapes=ShapeConfig(),
        solver=dataclasses.replace(cfg.solver, lm_iters=10, lm_iters_obj=6))


def _one_frame_on_both(cfg, ds, fid: int, tmp_path):
    """Frame fid by the host Tracker on the CPU and on the card, both from
    the card's state after frame fid - 1 (a checkpoint payload) with the
    same draws (each tracker's own for frame fid): {"cpu": report, "cuda":
    report}."""
    import pickle

    from vdo_slam_tpu_torch.pipeline import System
    from vdo_slam_tpu_torch.utils.checkpoint import (save_checkpoint,
                                                     tracker_from_numpy)

    sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  device="cuda")
    for f in range(fid):
        sysm.track_rgbd(ds[f])
    save_checkpoint(sysm.tracker, tmp_path / "ck.pkl")
    with open(tmp_path / "ck.pkl", "rb") as fh:
        payload = pickle.load(fh)
    reps = {}
    for dev in ("cpu", "cuda"):
        tr = tracker_from_numpy(payload, cfg, device=dev)
        reps[dev] = tr.grab_frame(ds[fid])
    return reps


def test_distorted_frame_on_card_matches_cpu(tmp_path):
    """One frame of the bench scene rendered through a barrel lens (k1/k2
    configured, so every stage warps through undistortion), stepped by the
    host Tracker from one state on the card and on the CPU with the same
    draws: held to the undistorted step's bound, the same objects, and
    each object's motion within 5e-3 m."""
    scene = make_scene(num_frames=6, width=1242, height=375, num_objects=3,
                       fx=721.5377, seed=7, dist=DIST)
    cfg = _bench_cfg(k1=DIST[0], k2=DIST[1])
    ds = SyntheticDataset(scene, depth_map_factor=256.0, bf=387.5744)
    reps = _one_frame_on_both(cfg, ds, 4, tmp_path)
    cpu, card = reps["cpu"], reps["cuda"]

    def ids(rep):
        return [(o["model_label"], o["sem_label"], o["status"])
                for o in rep["objects"]]

    assert ids(card) == ids(cpu)
    assert sum(o["status"] for o in cpu["objects"]) >= 2
    for oc, og in zip(cpu["objects"], card["objects"]):
        if oc["status"]:
            assert np.linalg.norm(np.asarray(og["H"])[:3, 3]
                                  - np.asarray(oc["H"])[:3, 3]) < 5e-3
    Tc = np.asarray(cpu["T_cw"], np.float64)
    Tg = np.asarray(card["T_cw"], np.float64)
    E = np.linalg.inv(Tc) @ Tg
    s = np.array([E[2, 1] - E[1, 2], E[0, 2] - E[2, 0], E[1, 0] - E[0, 1]])
    dr = np.degrees(np.arcsin(min(0.5 * np.linalg.norm(s), 1.0)))
    dt = np.linalg.norm(Tg[:3, 3] - Tc[:3, 3])
    print(f"distorted frame 4, card vs CPU: {dt:.3e} m, {dr:.3e} deg, "
          f"camera inliers {card['n_inlier_cam']} / {cpu['n_inlier_cam']}")
    assert dt < 1e-3 and dr < 0.01, (dt, dr)


# the card's pyramid levels against the CPU's on the distorted frame 0
# (2.724e-5 measured on an H100 by chip_distortion_scatter.py)
LEVEL_GAP_TOL = 3e-5


def _distorted_frame0_stages(fd, cfg, dev, rgb, levels=None,
                             monkeypatch=None):
    """Frame 0 of the distorted scene on `dev`, stage by stage: pyramid
    levels, FAST score maps, detections, their undistorted keypoints, and
    the static and object candidates.  `levels` (another device's) replace
    this device's own pyramid."""
    from vdo_slam_tpu_torch.pipeline import stages
    from vdo_slam_tpu_torch.pipeline.draws import UniformDraws, frame_uniforms

    fe = cfg.frontend
    gray = torch.from_numpy(rgb).to(dev)
    if levels is not None:
        monkeypatch.setattr(fast, "pyramid",
                            lambda *a, **k: [x.to(dev) for x in levels])
    lv = fast.pyramid(gray, fe.n_levels, fe.scale_factor)
    scores = stages.make_score_pyramid(cfg)(gray)
    det = fast.select_pyramid(scores, fe.n_features, fe.scale_factor,
                              fe.fast_cell)
    draws = UniformDraws(frame_uniforms(cfg, 0, torch.Generator(), dev))
    prep = stages.make_prepare(cfg, dev)(
        gray, torch.from_numpy(fd.depth_raw).to(dev),
        torch.from_numpy(fd.flow).to(dev),
        torch.from_numpy(fd.mask.astype(np.int32)).to(dev), draws,
        scores=scores)
    out = {"levels": lv, "scores": [t for pair in scores for t in pair],
           "und": stages._warps(cfg, dev)[0](det["xy"])}
    out.update({f"det_{k}": v for k, v in det.items()})
    for bank in ("stat_cand", "obj_cand"):
        out.update({f"{bank}_{k}": v for k, v in prep[bank].items()})
    return {k: ([t.cpu() for t in v] if isinstance(v, list) else v.cpu())
            for k, v in out.items()}


@pytest.fixture(scope="module")
def distorted_frame0():
    scene = make_scene(num_frames=2, width=1242, height=375, num_objects=3,
                       fx=721.5377, seed=7, dist=DIST)
    return SyntheticDataset(scene, depth_map_factor=256.0, bf=387.5744)[0]


def test_distorted_frame0_departs_only_at_the_resize(distorted_frame0,
                                                     monkeypatch):
    """Frame 0 of the distorted scene: the gray image is equal on the two
    devices and the pyramid levels are not (F.interpolate rounds
    differently on the card: 2.724e-5 at most on an H100); fed the CPU's
    levels, the card's FAST score maps, detections, undistorted keypoints
    and candidate banks are bit-equal to the CPU's."""
    from vdo_slam_tpu_torch.ops.image import rgb_to_gray

    cfg = _bench_cfg(k1=DIST[0], k2=DIST[1])
    fe = cfg.frontend
    rgb = np.asarray(distorted_frame0.rgb, np.float32)
    gray = {dev: rgb_to_gray(torch.from_numpy(rgb).to(dev))
            for dev in ("cpu", "cuda")}
    assert torch.equal(gray["cuda"].cpu(), gray["cpu"])
    own = {dev: fast.pyramid(g, fe.n_levels, fe.scale_factor)
           for dev, g in gray.items()}
    gap = max(float((a.cpu() - b).abs().max())
              for a, b in zip(own["cuda"], own["cpu"]))
    assert 0.0 < gap <= LEVEL_GAP_TOL, gap
    cpu = _distorted_frame0_stages(distorted_frame0, cfg, "cpu", rgb)
    card = _distorted_frame0_stages(distorted_frame0, cfg, "cuda", rgb,
                                    cpu["levels"], monkeypatch)
    for k, v in cpu.items():
        for a, b in zip(v, card[k]) if isinstance(v, list) else [(v,
                                                                  card[k])]:
            assert torch.equal(a, b), k


def test_distorted_frame0_banks_with_noise_agree_as_sets(distorted_frame0):
    """The explanation's prediction: with seeded gray noise (sigma 0.02,
    seed 0) the resize no longer reorders score ties, and frame 0's
    detections and candidate banks are the same sets of keypoints on the
    card and on the CPU (rows may come in another order)."""
    cfg = _bench_cfg(k1=DIST[0], k2=DIST[1])
    rgb = np.clip(np.asarray(distorted_frame0.rgb, np.float32)
                  + 0.02 * np.random.default_rng(0).standard_normal(
                      distorted_frame0.rgb.shape), 0.0, 1.0).astype(
                          np.float32)
    got = {dev: _distorted_frame0_stages(distorted_frame0, cfg, dev, rgb)
           for dev in ("cpu", "cuda")}

    def rows(out, name):
        xy, ok = out[f"{name}_xy"].numpy(), out[f"{name}_valid"].numpy()
        return sorted(map(tuple, xy[ok].tolist()))

    for name in ("det", "stat_cand", "obj_cand"):
        assert rows(got["cuda"], name) == rows(got["cpu"], name), name
    assert len(rows(got["cpu"], "stat_cand")) == cfg.shapes.max_static


def test_tracker_fetch_is_one_exact_copy():
    from vdo_slam_tpu_torch.pipeline import Tracker

    tr = Tracker(_small_cfg(), device="cuda")
    xs = [torch.arange(7, dtype=torch.int32, device="cuda") - 3,
          torch.rand(5, 3, device="cuda"),
          torch.rand(4, device="cuda") > 0.5,
          torch.tensor(2**40 + 3, device="cuda"),
          torch.eye(4, device="cuda")[1:]]
    got = tr._fetch(*xs)
    for x, g in zip(xs, got):
        ref = x.cpu().numpy()
        assert g.dtype == ref.dtype and g.shape == ref.shape
        np.testing.assert_array_equal(g, ref)


@pytest.fixture(scope="module")
def tracked_map():
    """The port's map of the 8-frame scene, tracked on the CPU, BA off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vdo_slam_tpu_torch.pipeline import System

    scene = make_scene(num_frames=8, width=320, height=240, num_objects=2,
                       seed=3)
    cfg = _small_cfg()
    sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  mode="fused", device="cpu")
    sysm.run_sequence(SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0))
    return sysm.map, cfg


def _solve_both(solve, g, v, solve_card=None):
    """`solve` on the CPU against `solve_card` (default: `solve`) on the
    card, from the same numpy graph."""
    from vdo_slam_tpu_torch.backend.factor_graph import fetch, upload

    out = {}
    for dev, fn in (("cpu", solve), ("cuda", solve_card or solve)):
        vv, info = fn(*upload(g, v, dev))
        out[dev] = fetch((vv.poses, vv.points, info["cost0"], info["cost"]))
    (pc, xc, c0c, cc), (pg, xg, c0g, cg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(pg, pc, atol=1e-4)
    np.testing.assert_allclose(xg, xc, atol=1e-3, rtol=2e-4)
    assert float(c0g) == pytest.approx(float(c0c), rel=1e-5)
    assert abs(float(cg) - float(cc)) <= 1e-4 * float(c0c)
    assert float(cg) < float(c0g)


def test_window_solve_on_card_matches_cpu(tracked_map):
    from vdo_slam_tpu_torch.backend.builders import build_window_graph
    from vdo_slam_tpu_torch.backend.factor_graph import lm_solve_schur
    from vdo_slam_tpu_torch.backend.window_ba import _lm_params

    m, cfg = tracked_map
    g, v, meta = build_window_graph(m, cfg, window=6)
    assert meta.n_static_points > 20
    _solve_both(lambda gg, vv: lm_solve_schur(gg, vv, _lm_params(cfg)), g, v)


def test_full_solve_on_card_matches_cpu(tracked_map):
    from vdo_slam_tpu_torch.backend.builders import build_full_graph
    from vdo_slam_tpu_torch.backend.factor_graph import lm_solve_chunked
    from vdo_slam_tpu_torch.backend.full_ba import scaled_lm_params

    m, cfg = tracked_map
    g, v, meta = build_full_graph(m, cfg)
    assert meta.n_motions >= 2
    p = scaled_lm_params(cfg, g.obs_w.shape[0])
    _solve_both(lambda gg, vv: lm_solve_chunked(gg, vv, p, chunk=3), g, v)


def test_full_build_on_card_equals_cpu(tracked_map):
    """build_full_graph_on the card against the same build on the CPU, bit
    for bit: every Graph and Variables field, dtypes and shapes included,
    the write-back's indices and the rest of the GraphMeta (caps,
    motion slots, counts)."""
    from vdo_slam_tpu_torch.backend.builders import build_full_graph_on
    from vdo_slam_tpu_torch.backend.factor_graph import fetch

    m, cfg = tracked_map
    out = {dev: build_full_graph_on(m, cfg, dev) for dev in ("cpu", "cuda")}
    (gc, vc, mc), (gg, vg, mg) = out["cpu"], out["cuda"]
    assert gg.obs_w.device.type == "cuda" and vg.points.device.type == "cuda"
    names = [f.name for f in dataclasses.fields(gc)]
    for a, b in ((gc, gg), (vc, vg)):
        fields = names if a is gc else ["poses", "motions", "points"]
        host = fetch({n: getattr(b, n) for n in fields})
        for n in fields:
            x = getattr(a, n)
            assert x.dtype == getattr(b, n).dtype and x.shape == host[n].shape
            np.testing.assert_array_equal(host[n], x.numpy(), err_msg=n)
    for f in dataclasses.fields(mc):
        x, y = getattr(mc, f.name), getattr(mg, f.name)
        if isinstance(x, tuple):
            for u, w in zip(x, y, strict=True):
                assert u.dtype == w.dtype == np.int64
                np.testing.assert_array_equal(u, w, err_msg=f.name)
        else:
            assert x == y, f.name
    assert int((gc.ter_w > 0).sum()) > 20 and mc.n_motions >= 2


def test_window_solve_on_its_thread_and_stream(tracked_map):
    """A window end queued on a fused tracker is solved on the tracker's
    solve thread, on its own CUDA stream (not the default one), and the
    result matches the same solve inline on the card within the bounds
    above."""
    import copy
    import threading

    from vdo_slam_tpu_torch.backend.window_ba import local_ba_inplace

    m, cfg = tracked_map
    n = m.num_frames
    m_thread, m_inline = copy.deepcopy(m), copy.deepcopy(m)
    tr = FusedTracker(cfg, m_thread, device="cuda", build_step=False)
    seen = {}

    def hook(mm, n_frames):
        seen["stream"] = torch.cuda.current_stream().cuda_stream
        seen["thread"] = threading.current_thread()
        return local_ba_inplace(mm, cfg, window=6, n_frames=n_frames,
                                device="cuda")

    tr.local_ba_hook = hook
    tr._queue_ba(n)
    with tr._ba_lock:
        th = tr._ba_thread
    if th is not None:
        th.join(120)
        assert not th.is_alive()
    tr.flush()
    assert tr.ba_failures == 0 and len(tr.ba_health) == 1
    assert seen["thread"] is not threading.current_thread()
    assert seen["stream"] == tr.ba_stream.cuda_stream
    assert seen["stream"] != torch.cuda.default_stream().cuda_stream
    inline = local_ba_inplace(m_inline, cfg, window=6, n_frames=n,
                              device="cuda")
    h = tr.ba_health[0]
    assert h["cost0"] == pytest.approx(inline["cost0"], rel=1e-5)
    assert abs(h["cost"] - inline["cost"]) <= 1e-4 * inline["cost0"]
    assert h["cost"] < h["cost0"]
    np.testing.assert_allclose(np.stack(m_thread.cam_pose),
                               np.stack(m_inline.cam_pose), atol=1e-4)
    for a, b in zip(m_thread.stat_3d, m_inline.stat_3d):
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=2e-4)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_full_solve_on_card(tracked_map, n_dev):
    """The edge-sharded chunked solve over ["cuda:0"] * n_dev on the card
    against the one-device chunked solve on the CPU (the bounds above); then
    full_ba_inplace over the same list against the one-device call on the
    card, within the JAX package's sharded bounds (cost within 10 %, poses
    within 1e-3)."""
    import copy

    from vdo_slam_tpu_torch.backend.builders import build_full_graph
    from vdo_slam_tpu_torch.backend.factor_graph import (
        lm_solve_chunked, lm_solve_sharded_chunked)
    from vdo_slam_tpu_torch.backend.full_ba import (full_ba_inplace,
                                                    scaled_lm_params)

    m, cfg = tracked_map
    g, v, _ = build_full_graph(m, cfg)
    p = scaled_lm_params(cfg, g.obs_w.shape[0])
    devices = ["cuda:0"] * n_dev
    _solve_both(lambda gg, vv: lm_solve_chunked(gg, vv, p, chunk=3), g, v,
                lambda gg, vv: lm_solve_sharded_chunked(gg, vv, p, devices,
                                                        chunk=3))
    m1, m2 = copy.deepcopy(m), copy.deepcopy(m)
    r1 = full_ba_inplace(m1, cfg, device="cuda")
    r2 = full_ba_inplace(m2, cfg, device="cuda", devices=devices)
    assert r2["iters_run"] == r1["iters_run"]
    assert abs(r2["cost"] - r1["cost"]) <= 0.1 * max(r1["cost"], 1e-6)
    gap = max(float(np.abs(a.astype(np.float64) - b).max())
              for a, b in zip(m2.cam_pose_rf, m1.cam_pose_rf))
    assert gap < 1e-3


# ---- the compiled programs (utils/cuda_graph.py) on the card

def _eager_frames(cfg, ds, dev, n):
    """make_frame_step called by hand, op by op, over n frames: each
    frame's (T_cw, active slot labels)."""
    from vdo_slam_tpu_torch.pipeline import draws as draws_mod

    step = make_frame_step(cfg, dev, packed=True)
    stager = FusedTracker(cfg, device=dev, build_step=False)
    st = make_stream_state(cfg, dev)
    out = []
    for f in range(n):
        inputs = stager.device_inputs(ds[f])
        inputs.pop("_T_cw_gt_host")
        st, m = step(st, inputs, draws_mod.UniformDraws(
            stager.frame_draws(f)), f > 0)
        act = m["slot_active"].cpu().numpy()
        out.append((np.linalg.inv(st.frame.T_cw.cpu().numpy()),
                    set(m["slot_sem"].cpu().numpy()[act].tolist())))
    return out


def test_graphed_tracker_matches_eager_and_counts_replays():
    """System(mode="fused") on the card, which steps from its graph from
    frame 2 on, against the step called by hand on the card over 10
    frames: each pose within the card-vs-CPU bounds; KERNEL.launches up by
    one per frame, a replayed frame's launch included, and the capture's
    recorded launch not counted as one."""
    from vdo_slam_tpu_torch.pipeline import System

    scene = make_scene(num_frames=11, width=320, height=240, num_objects=2,
                       seed=3)
    cfg = _small_cfg()
    ds = SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)
    sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  mode="fused", device="cuda")
    tr = sysm.tracker
    per_frame = []
    for f in range(10):
        before, captured = KERNEL.launches, KERNEL.captured
        tr.grab_frame(ds[f])
        per_frame.append((KERNEL.launches - before,
                          KERNEL.captured - captured))
    tr.flush()
    assert per_frame[2] == (1, 1)            # the capture, then its replay
    assert all(p == (1, 0) for i, p in enumerate(per_frame) if i != 2)
    rec = tr._graph.track.record
    assert rec["kernel_launches_per_replay"] == {"FastScoreKernel": 1}
    for Tg, (Te, _) in zip(sysm.map.cam_pose, _eager_frames(cfg, ds, "cuda",
                                                            10)):
        assert _pose_gap_ok(Te, Tg)


def test_graphed_streams_match_eager_batched_step():
    """MultiStreamSystem(S = 4) on the card (one graph for the group)
    against its batched step called by hand on the card over 10 frames:
    every stream's pose within the bounds each frame, one FAST launch per
    frame for all four streams."""
    from vdo_slam_tpu_torch.parallel import MultiStreamSystem
    from vdo_slam_tpu_torch.parallel.multistream import stack_states

    scenes = [make_scene(num_frames=10, width=320, height=240, num_objects=2,
                         seed=s) for s in (3, 9, 5, 7)]
    cfg = _small_cfg()
    cfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, **WIRES["tpu_fast"]))
    dss = [SyntheticDataset(s, depth_map_factor=1.0, bf=40.0) for s in scenes]
    msys = MultiStreamSystem(cfg, n_streams=4, enable_local_ba=False,
                             device="cuda")
    before = KERNEL.launches
    msys.run(dss)
    assert KERNEL.launches - before == len(dss[0])
    hand = MultiStreamSystem(cfg, n_streams=4, enable_local_ba=False,
                             device="cuda")
    g = hand.groups[0]
    states = stack_states([make_stream_state(cfg, "cuda")] * 4)
    for f in range(len(dss[0])):
        staged = hand._stage([d[f] for d in dss])[0]
        staged.pop("_gts_host")
        states, _ = g.step(states, staged, hand._frame_draws(f)[0], f > 0)
        T_wc = np.linalg.inv(states.frame.T_cw.cpu().numpy())
        for s in range(4):
            assert _pose_gap_ok(T_wc[s], msys.maps[s].cam_pose[f])


@pytest.mark.parametrize("tier", [0, 1])
def test_window_tier_graph_matches_eager(tracked_map, monkeypatch, tier):
    """A window graph padded to each WINDOW_TIERS entry, solved from its
    graph (the third solve replays it) against lm_solve_schur op by op on
    the card: the cost within 1e-5 relative, poses within 1e-4."""
    from vdo_slam_tpu_torch.backend import builders
    from vdo_slam_tpu_torch.backend.factor_graph import (fetch,
                                                         lm_solve_schur,
                                                         upload)
    from vdo_slam_tpu_torch.backend.window_ba import WindowGraphs, _lm_params

    m, cfg = tracked_map
    monkeypatch.setattr(builders, "WINDOW_TIERS",
                        (builders.WINDOW_TIERS[tier],))
    g, v, _ = builders.build_window_graph(m, cfg, window=6)
    p = _lm_params(cfg)
    ve, ie = lm_solve_schur(*upload(g, v, "cuda"), p)
    pe, ce = fetch((ve.poses, ie["cost"]))
    graphs = WindowGraphs("cuda")
    for _ in range(3):
        with graphs.solve(g, v, p) as (vg, ig):
            pg, cg = fetch((vg.poses, ig["cost"]))
    assert graphs.records() and graphs.records()[0]["capture_s"] > 0
    assert abs(float(cg) - float(ce)) <= 1e-5 * float(ce)
    np.testing.assert_allclose(pg, pe, atol=1e-4)


def test_full_ba_graph_matches_eager(tracked_map):
    """full_ba_inplace from its graphs (warmup_full_ba on the zero-weight
    graph of small full_* caps, then the solve, which replays) against the
    eager full_ba_inplace on the card: the cost within 1e-5 relative
    (chip_smoke's GRAPH_COST_RTOL), every refined pose entry within 1e-5,
    and the captures the warm-up made, which the solve replays, making no
    other."""
    import copy

    from vdo_slam_tpu_torch.backend.full_ba import (FullBAGraphs,
                                                   full_ba_inplace,
                                                   warmup_full_ba)

    m, cfg = tracked_map
    cfg = cfg.replace(backend=dataclasses.replace(
        cfg.backend, full_obs_cap=16384, full_ter_cap=8192,
        full_point_cap=16384, full_motion_cap=64, full_smo_cap=64))
    graphs = FullBAGraphs("cuda")
    warmup_full_ba(cfg, m.num_frames, graphs)
    keys = set(graphs._calls)
    me, mg = copy.deepcopy(m), copy.deepcopy(m)
    eager = full_ba_inplace(me, cfg, device="cuda")
    graphed = full_ba_inplace(mg, cfg, device="cuda", graphs=graphs)
    assert set(graphs._calls) == keys and len(graphs.records()) == len(keys)
    assert all(r["capture_s"] > 0 for r in graphs.records())
    assert graphed["cost0"] == pytest.approx(eager["cost0"], rel=1e-5)
    assert abs(graphed["cost"] - eager["cost"]) <= 1e-5 * eager["cost"]
    assert graphed["cost"] < graphed["cost0"]
    for a, b in zip(mg.cam_pose_rf, me.cam_pose_rf, strict=True):
        np.testing.assert_allclose(a, b, atol=1e-5)
    for ra, rb in zip(mg.rigid_motion_rf, me.rigid_motion_rf, strict=True):
        for a, b in zip(ra, rb, strict=True):
            np.testing.assert_allclose(a, b, atol=1e-5)


def test_system_refine_replays_after_its_warmup(tracked_map):
    """System.warmup_refine for the archive's length, then System.refine:
    every chunk replays a graph, the caps hold, and the objective is the
    plain reference's float64 one (benchmark/full_batch_reference.py)
    within 1e-4 relative."""
    import copy

    from benchmark import full_batch_reference as ref
    from vdo_slam_tpu_torch.pipeline import System

    m, cfg = tracked_map
    cfg = cfg.replace(backend=dataclasses.replace(
        cfg.backend, full_obs_cap=16384, full_ter_cap=8192,
        full_point_cap=16384, full_motion_cap=64, full_smo_cap=64))
    sysm = System(cfg, enable_local_ba=False, enable_global_ba=True,
                  mode="fused", device="cuda")
    sysm.map = copy.deepcopy(m)
    sysm.warmup_refine(m.num_frames)
    p = ref.build(sysm.map, ref.settings(dataclasses.asdict(cfg.backend),
                                         dataclasses.asdict(cfg.camera)))
    rep = sysm.refine()
    assert rep["caps_held"] and rep["chunk_modes"] == ["replay"]
    assert ref.check(p, rep, sysm.map, 1e-4, "cuda")["ok"]


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_full_ba_graph_matches_eager(tracked_map, n_dev):
    """full_ba_inplace over ["cuda:0"] * n_dev from FullBAGraphs over the
    same list (warmup_full_ba at small full_* caps, then the solve, which
    replays one graph per chunk length) against the eager sharded
    full_ba_inplace: the cost within 1e-6 relative, every refined pose
    entry within 1e-5; each capture names its shard count."""
    import copy

    from vdo_slam_tpu_torch.backend.full_ba import (FullBAGraphs,
                                                   full_ba_inplace,
                                                   warmup_full_ba)

    m, cfg = tracked_map
    cfg = cfg.replace(backend=dataclasses.replace(
        cfg.backend, full_obs_cap=16384, full_ter_cap=8192,
        full_point_cap=16384, full_motion_cap=64, full_smo_cap=64))
    devices = ["cuda:0"] * n_dev
    graphs = FullBAGraphs(devices)
    warmup_full_ba(cfg, m.num_frames, graphs)
    keys = set(graphs._calls)
    me, mg = copy.deepcopy(m), copy.deepcopy(m)
    eager = full_ba_inplace(me, cfg, device="cuda", devices=devices)
    graphed = full_ba_inplace(mg, cfg, device="cuda", devices=devices,
                              graphs=graphs)
    assert set(graphs._calls) == keys and len(graphs.records()) == len(keys)
    assert all(r["name"].endswith(f"shards={n_dev}")
               for r in graphs.records())
    assert graphed["iters_run"] == eager["iters_run"]
    assert graphed["cost0"] == pytest.approx(eager["cost0"], rel=1e-6)
    assert abs(graphed["cost"] - eager["cost"]) <= 1e-6 * eager["cost"]
    assert graphed["cost"] < graphed["cost0"]
    for a, b in zip(mg.cam_pose_rf, me.cam_pose_rf, strict=True):
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("tier", [0, 1])
def test_window_lm_graph_matches_eager(tracked_map, monkeypatch, tier):
    """The window solver "lm" from WindowGraphs (the third solve replays
    its graph) against lm_solve op by op on the card, at each
    WINDOW_TIERS entry: the cost within 1e-6 relative, poses within 1e-4;
    local_ba_inplace(solver="lm") through the same graphs lowers the
    cost."""
    import copy

    from vdo_slam_tpu_torch.backend import builders
    from vdo_slam_tpu_torch.backend.factor_graph import (fetch, lm_solve,
                                                         upload)
    from vdo_slam_tpu_torch.backend.window_ba import (WindowGraphs,
                                                      _lm_params,
                                                      local_ba_inplace)

    m, cfg = tracked_map
    monkeypatch.setattr(builders, "WINDOW_TIERS",
                        (builders.WINDOW_TIERS[tier],))
    g, v, _ = builders.build_window_graph(m, cfg, window=6)
    p = _lm_params(cfg)
    ve, ie = lm_solve(*upload(g, v, "cuda"), p)
    pe, ce = fetch((ve.poses, ie["cost"]))
    graphs = WindowGraphs("cuda")
    for _ in range(3):
        with graphs.solve(g, v, p, solver="lm") as (vg, ig):
            pg, cg = fetch((vg.poses, ig["cost"]))
    assert [r["name"].endswith("solver=lm") for r in graphs.records()] == [
        True]
    assert abs(float(cg) - float(ce)) <= 1e-6 * float(ce)
    np.testing.assert_allclose(pg, pe, atol=1e-4)
    rep = local_ba_inplace(copy.deepcopy(m), cfg, window=6, solver="lm",
                           device="cuda", graphs=graphs)
    assert len(graphs.records()) == 1 and rep["cost"] < rep["cost0"]


def _replay_device_ms(call, n: int) -> float:
    """The device activity's summed ms per call of n calls of `call` (a
    captured GraphedCall) under torch.profiler; a session that recorded
    none (the profiler now and then records no device event) is retried,
    twice at most, as chip_smoke's replay_device_ms does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA]
        if dev:
            return sum(e.time_range.elapsed_us() for e in dev) / n / 1e3
    raise AssertionError("the profiler recorded no device activity in 3 "
                         "sessions")


def test_stage_probe_spans_are_device_times():
    """calibrate_stage_times on the card (a fused System at 320x240 after
    8 frames): the FAST launches are what its graphs' records and replays
    say, the tracker's state and frame counter unchanged, all graphs in
    one pool; each span within max(25 %, 0.2 ms) of the profiler's summed
    device time of the same span's graph replayed alone, _frame_ms
    0.95-1.25x the frame program's (chip_smoke's PROBE_FRAME_RATIO: the
    events also see the gaps between the graph's kernel nodes), and the
    spans sum to 0.85-1.15 of _frame_ms."""
    from vdo_slam_tpu_torch.parallel.multistream import (PROBE_SPANS,
                                                         _flatten,
                                                         make_scan_probe)
    from vdo_slam_tpu_torch.pipeline import System

    scene = make_scene(num_frames=11, width=320, height=240, num_objects=2,
                       seed=3)
    cfg = _small_cfg()
    ds = SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)
    sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  mode="fused", device="cuda")
    sysm.run_sequence(ds, max_frames=8)
    tr = sysm.tracker
    before, fid = [t.clone() for t in _flatten(tr.state)], tr.frame_id
    n0 = KERNEL.launches
    times = tr.calibrate_stage_times(ds[8], rounds=2, n_iters=4)
    launches = KERNEL.launches - n0
    rep = tr.probe_report
    assert len(rep["graphs"]) == len(PROBE_SPANS) + 1
    want = sum(g["kernel_launches_warm"].get("FastScoreKernel", 0)
               + g["kernel_launches_per_replay"].get("FastScoreKernel", 0)
               * g["replays"] for g in rep["graphs"])
    assert launches == want > 0
    assert rep["pool_reserved_bytes"] > 0
    assert tr.frame_id == fid
    for a, b in zip(_flatten(tr.state), before, strict=True):
        assert torch.equal(a, b)
    spans = sum(times[k] for k in PROBE_SPANS)
    assert 0.85 <= spans / times["_frame_ms"] <= 1.15, times
    staged, draws = tr.probe_inputs(ds[8])
    progs = make_scan_probe(cfg, "cuda").programs(tr.state, staged, draws)
    progs.build()
    for name, call in zip(PROBE_SPANS, progs.spans):
        dev_ms = _replay_device_ms(call, 4)
        assert abs(times[name] - dev_ms) <= max(0.25 * dev_ms, 0.2), (
            name, times[name], dev_ms)
    progs.reset_frame()
    dev_ms = _replay_device_ms(progs.frame, 4)
    progs.close()
    assert 0.95 <= times["_frame_ms"] / dev_ms <= 1.25, (
        times["_frame_ms"], dev_ms)


HOST_STAGES = ("_prepare", "_mask_prop", "_inherit", "_camera",
               "_scene_flow", "_objects", "_renew_static", "_renew_dynamic")


def test_tracker_stage_graphs_replay_equal_eager_calls():
    """The host Tracker (System mode "reference") on the card over 6
    frames, each stage captured at its second call and replayed after;
    then each stage's function called eagerly on the inputs its last
    replay read: integer and boolean outputs equal, float outputs within
    1e-5.  Against the same run with the stage functions called directly,
    every frame's pose within the card-vs-CPU bounds and the same
    objects; KERNEL.launches up by one per frame either way."""
    from vdo_slam_tpu_torch.pipeline import System
    from vdo_slam_tpu_torch.utils.cuda_graph import tree_flatten

    scene = make_scene(num_frames=7, width=320, height=240, num_objects=2,
                       seed=3)
    cfg = _small_cfg()
    ds = SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)
    runs = {}
    for name in ("graphed", "direct"):
        sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                      device="cuda")
        if name == "direct":
            for st in HOST_STAGES:
                setattr(sysm.tracker, st, getattr(sysm.tracker, st).fn)
        before = KERNEL.launches
        reps = sysm.run_sequence(ds)
        runs[name] = (sysm, reps, KERNEL.launches - before)
    tr = runs["graphed"][0].tracker
    assert runs["graphed"][2] == runs["direct"][2] == len(ds)
    assert len(tr.graph_records()) == len(HOST_STAGES)
    assert tr._prepare.call.record["kernel_launches_per_replay"] == {
        "FastScoreKernel": 1}
    for name in HOST_STAGES:
        stage = getattr(tr, name)
        eager = tree_flatten(stage.fn(*stage.inputs.tree, **stage._consts))[0]
        replayed = tree_flatten(stage.call.out)[0]
        assert len(eager) == len(replayed), name
        for e, r in zip(eager, replayed):
            if e.is_floating_point():
                torch.testing.assert_close(r, e, rtol=1e-5, atol=1e-5)
            else:
                assert torch.equal(r, e), name
    for rg, rd in zip(runs["graphed"][1], runs["direct"][1], strict=True):
        assert _pose_gap_ok(rd["T_cw"], rg["T_cw"])
        assert ([(o["model_label"], o["sem_label"], o["status"])
                 for o in rg["objects"]]
                == [(o["model_label"], o["sem_label"], o["status"])
                    for o in rd["objects"]])


@pytest.mark.parametrize("name,make", [
    ("solve 6x6", lambda: (torch.eye(6, device="cuda") * 6
                           + torch.rand(6, 6, device="cuda"),
                           torch.rand(6, 1, device="cuda"))),
    ("solve 16x6x6", lambda: (torch.eye(6, device="cuda") * 6
                              + torch.rand(16, 6, 6, device="cuda"),
                              torch.rand(16, 6, 1, device="cuda"))),
    ("solve 4x16x6x6", lambda: (torch.eye(6, device="cuda") * 6
                                + torch.rand(4, 16, 6, 6, device="cuda"),
                                torch.rand(4, 16, 6, 1, device="cuda"))),
    ("solve 96x96", lambda: (torch.eye(96, device="cuda") * 96
                             + torch.rand(96, 96, device="cuda"),
                             torch.rand(96, device="cuda"))),
    ("inv 4096x3x3", lambda: (torch.eye(3, device="cuda") * 3
                              + torch.rand(4096, 3, 3, device="cuda"),)),
])
def test_small_solves_capture(name, make):
    """The step's and the window solve's small linear solves
    (solvers/flow_lm.py, solvers/reproj_lm.py, backend/factor_graph.py:
    solve_ex 6x6 single and batched, solve_ex n x n, inv_ex 3x3 batched)
    capture into a graph on this card's default linalg backend, and a
    replay on new inputs equals the eager call."""
    from vdo_slam_tpu_torch.utils.cuda_graph import GraphedCall

    args = make()

    def fn():
        if len(args) == 1:
            return torch.linalg.inv_ex(args[0])[0]
        return torch.linalg.solve_ex(*args)[0]

    call = GraphedCall(fn, "cuda", name)
    call()
    call()                                    # captured
    for a, b in zip(args, make()):
        a.copy_(b)
    got = call().clone()
    assert call.graph is not None
    torch.testing.assert_close(got, fn(), rtol=0, atol=0)


def test_capture_survives_a_collectable_graph():
    """A captured graph whose last reference, a reference cycle (as a
    dropped tracker or probe leaves its graphs), is dropped while another
    graph captures, and the collector then runs there as it may at any
    allocation (here on demand, where it is enabled): the capture holds,
    because captures run with the collector off.  A graph destroyed inside
    a capture breaks it ("operation not permitted when stream is
    capturing"), which is how one full chip_smoke run failed."""
    import gc

    from vdo_slam_tpu_torch.utils.cuda_graph import GraphedCall

    x = torch.rand(1024, device="cuda")
    bag = []

    def fn():
        if bag:
            bag.pop()          # the old graph's cycle is garbage from here
            if gc.isenabled():
                gc.collect()   # the collector's automatic run
        return (x + 1.0).sum()

    class Holder:
        pass

    call = GraphedCall(fn, "cuda", "new")
    call()                                           # the warm-up
    old = Holder()
    old.call = GraphedCall(lambda: (x * 2).sum(), "cuda", "old")
    old.self = old                                   # a cycle
    old.call()
    old.call()                                       # captured
    assert old.call.graph is not None
    bag.append(old)
    del old
    got = call().clone()                             # captured, replayed
    assert call.graph is not None and not bag and gc.isenabled()
    torch.testing.assert_close(got, fn(), rtol=0, atol=0)


def test_graph_setup_spans_are_its_record():
    """With the span recorder on, a GraphedCall's warm-up and capture are
    `setup.warm` and `setup.capture` spans named by the graph, of the same
    clock reads as its record's seconds, and its replays record none."""
    from vdo_slam_tpu_torch.utils import profiling
    from vdo_slam_tpu_torch.utils.cuda_graph import GraphedCall

    x = torch.rand(1024, device="cuda")
    call = GraphedCall(lambda: (x * 3).sum(), "cuda", "triple")
    with profiling.recording() as rec:
        for _ in range(4):
            call()
    torch.cuda.synchronize()
    assert [s.name for s in rec.spans] == ["setup.warm", "setup.capture"]
    warm, cap = rec.spans
    assert warm.unit == cap.unit == "triple"
    assert call.record["warm_s"] == warm.wall_ns / 1e9
    assert call.record["capture_s"] == cap.wall_ns / 1e9
    assert warm.end_ns <= cap.start_ns


# --------------------------------------------------------------------------
# the edge Hessian-vector kernels (csrc/edge_hessian.cu)
# --------------------------------------------------------------------------

HV_RTOL = 1e-5
# bytes of shared rows a block of the edge kernel may hold (HV_SMEM_BUDGET
# of csrc/edge_hessian.cu): 24 B a pose or motion row
HV_SMEM_BUDGET = 114688


def _hv_case(case: str):
    """(graph, variables) on the card: about a 1,028-frame drive's graph at
    the refine's caps, a window's, or one with F and M above the
    shared-memory budget."""
    import hv_graphs

    shapes = {
        "refine_caps": dict(hv_graphs.REFINE_SHAPE,
                            caps=hv_graphs.REFINE_CAPS),
        "window": dict(F=20, objects=3, per=40, n_static=400, max_len=20),
        "above_smem": dict(F=5000, objects=3, per=4, n_static=3000,
                           max_len=30),
    }[case]
    return hv_graphs.upload(*hv_graphs.make_graph(seed=11, **shapes), "cuda")


def _rel_gap(got, want) -> float:
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, want, strict=True))


@pytest.mark.parametrize("case", ["refine_caps", "window", "above_smem"])
def test_edge_hessian_kernels_equal_plain(case):
    """hessian_vector and block_jacobi on the card against
    their plain versions on the card, on the blocks and weights that
    factor_graph._linearize gives (their own strides: a transposed view, an
    expanded identity) and the damped block-Jacobi inverses; one vertex
    pass and one edge launch per edge type with edges per product."""
    import hv_graphs

    from vdo_slam_tpu_torch.backend import factor_graph as fg
    from vdo_slam_tpu_torch.ops import edge_hessian_cuda as EH

    g, v = _hv_case(case)
    F, M, P = v.poses.shape[0], v.motions.shape[0], v.points.shape[0]
    fits = {e: 24 * n <= HV_SMEM_BUDGET for e, n in (("obs", F), ("ter", M))}
    assert fits == ({"obs": False, "ter": False} if case == "above_smem"
                    else {"obs": True, "ter": True})
    _, weights, blocks = fg._linearize(g, v, fg.LMParams())
    assert blocks["Jt_prev"].stride(0) == 0
    assert not blocks["Jo_pt"].is_contiguous()
    D = fg._block_diag(g, blocks, weights, F, M, P)
    damp = fg._damped_diag(D, torch.full((), 1e-4, device="cuda"))
    Dinv = fg._invert_precond(tuple(
        x + torch.diag_embed(d)
        for x, d in zip(D, (damp.poses, damp.motions, damp.points))))
    t = hv_graphs.random_tangent(v, seed=2)
    n_types = sum(1 for e in EH.INCIDENCE if weights[e].shape[0])
    launches, vertex = EH.KERNEL.launches, EH.VERTEX.launches
    plain = EH.matvec_plain(g, blocks, weights, t)
    got = EH.hessian_vector(g, blocks, weights, t)
    torch.cuda.synchronize()
    assert _rel_gap(got, plain) <= HV_RTOL
    got = EH.hessian_vector(g, blocks, weights, t, damp)
    assert _rel_gap(got, EH.damped_plain(plain, damp, t)) <= HV_RTOL
    got = EH.block_jacobi(Dinv, t)
    assert _rel_gap(got, EH.precond_plain(Dinv, t)) <= HV_RTOL
    torch.cuda.synchronize()
    assert EH.KERNEL.launches - launches == 2 * n_types == 12
    assert EH.VERTEX.launches - vertex == 3


def test_graphed_refine_counts_its_hv_launches(tracked_map):
    """full_ba_inplace from its graphs (warmed at small full_* caps) goes
    through the edge kernel: its counter full.hv_launches and the kernel's
    `launches` both read edge types x cg_iters x iters_run, each capture
    records edge types x cg_iters x its chunk's iterations, and the eager
    solve counts the same."""
    import copy

    from vdo_slam_tpu_torch.backend.full_ba import (FullBAGraphs,
                                                   full_ba_inplace,
                                                   warmup_full_ba)
    from vdo_slam_tpu_torch.ops import edge_hessian_cuda as EH
    from vdo_slam_tpu_torch.utils import profiling

    m, cfg = tracked_map
    cfg = cfg.replace(backend=dataclasses.replace(
        cfg.backend, full_obs_cap=16384, full_ter_cap=8192,
        full_point_cap=16384, full_motion_cap=64, full_smo_cap=64))
    graphs = FullBAGraphs("cuda")
    warmup_full_ba(cfg, m.num_frames, graphs)
    reps = []
    for gr in (graphs, None):
        before = EH.KERNEL.launches
        with profiling.recording() as rec:
            rep = full_ba_inplace(copy.deepcopy(m), cfg, device="cuda",
                                  graphs=gr)
        n_types = sum(1 for n in rep["edges"].values() if n)
        want = n_types * rep["cg_iters"] * rep["iters_run"]
        assert want > 0 and EH.KERNEL.launches - before == want
        assert [c.value for c in rec.counted("full.hv_launches")] == [want]
        reps.append(rep)
    assert set(reps[0]["chunk_modes"]) == {"replay"}
    assert set(reps[1]["chunk_modes"]) == {"eager"}
    for r in graphs.records():
        iters = int(r["name"].split("iters=")[1].split()[0])
        assert r["kernel_launches_per_replay"]["EdgeHessianKernel"] == (
            n_types * reps[0]["cg_iters"] * iters)
        assert r["kernel_launches_per_replay"]["VertexPassKernel"] == (
            (2 * reps[0]["cg_iters"] + 1) * iters)
