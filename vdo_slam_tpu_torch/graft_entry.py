"""Driver entry points of the port — counterpart of the repository root's
__graft_entry__.py, without jax.

    python -m vdo_slam_tpu_torch.graft_entry      # on a GPU host

entry()            — one fused per-frame tracking step (the flagship path)
                     and its example arguments
dryrun_multichip() — the multi-stream step over n devices, stream 0 held to
                     the solo step, and the edge-sharded full BA on a
                     production-builder graph

Two deliberate differences from the original:

* the JAX step takes a PRNG key and picks the init branch with lax.cond on
  the state's `initialized` flag; the port's step takes a FrameDraws
  (pipeline/draws.py) and `initialized` as a host bool, False for
  entry()'s fresh state;
* the original forces a virtual CPU mesh of n devices in this or a child
  process (`_ensure_n_devices`, `_dryrun_in_subprocess`); here the n
  devices are a list (devices.py), the first n visible cards, or cuda:0
  n times where fewer are visible.  The CPU runs them only when the caller
  passes it.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .config import KITTI, ShapeConfig, TrackingConfig, VDOConfig
from .devices import device_list

# stream 0 of the S-stream step against the solo step: the bounds of the
# original (__graft_entry__.py:221)
SOLO_POSE_TOL, SOLO_RPE_TOL = 1e-5, 1e-6
# the sharded full BA against the single-device solve (:250-256)
MIN_POINTS, MIN_EDGES, MIN_MOTIONS = 10_000, 30_000, 10
COST_REL_TOL, POSE_TOL = 0.1, 1e-3
FULL_BA_ITERS = 6


def _check(ok: bool, message: str) -> None:
    """The original's asserts, kept under python -O."""
    if not ok:
        raise AssertionError(message)


def _on(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the "
                           "CPU")
    return device


def _tiny_config(w=96, h=64) -> VDOConfig:
    cfg = VDOConfig()
    return cfg.replace(
        camera=dataclasses.replace(cfg.camera, fx=float(w), fy=float(w),
                                   cx=w / 2.0, cy=h / 2.0, width=w, height=h,
                                   bf=40.0),
        tracking=dataclasses.replace(
            TrackingConfig(), dataset=KITTI, depth_map_factor=1.0,
            boundary_shrink_row=4, boundary_shrink_col=6,
            min_obj_points=20, min_init_inliers=10,
        ),
        shapes=ShapeConfig(max_static=128, max_dynamic=256, max_objects=4,
                           ransac_samples=32),
        frontend=dataclasses.replace(cfg.frontend, n_features=200, n_levels=2),
    )


def _medium_config(w=256, h=192) -> VDOConfig:
    """Production-like shapes for the sharded full-BA leg: a 25-frame
    256x192 3-object sequence builds a ~20k-point / ~53k-edge graph."""
    cfg = VDOConfig()
    return cfg.replace(
        camera=dataclasses.replace(cfg.camera, fx=float(w), fy=float(w),
                                   cx=w / 2.0, cy=h / 2.0, width=w, height=h,
                                   bf=60.0),
        tracking=dataclasses.replace(
            TrackingConfig(), dataset=KITTI, depth_map_factor=1.0,
            boundary_shrink_row=8, boundary_shrink_col=10,
            min_obj_points=20, min_init_inliers=10,
        ),
        shapes=ShapeConfig(max_static=768, max_dynamic=3072, max_objects=8,
                           ransac_samples=64),
        frontend=dataclasses.replace(cfg.frontend, n_features=800,
                                     n_levels=3),
    )


def _example_inputs(cfg: VDOConfig, seed=0, device="cuda") -> dict:
    """Frame 1 of a 3-frame synthetic scene as the step's dense inputs,
    with T_cw_gt the inverse of the raw ground-truth pose."""
    from .io.dataset import SyntheticDataset
    from .io.synthetic import make_scene

    device = _on(device)
    scene = make_scene(num_frames=3, width=cfg.camera.width,
                       height=cfg.camera.height, num_objects=1, seed=seed)
    ds = SyntheticDataset(scene, depth_map_factor=1.0, bf=cfg.camera.bf)
    fd = ds[1]
    R = fd.pose_gt_raw[:3, :3]
    T_cw = np.eye(4, dtype=np.float32)
    T_cw[:3, :3] = R.T
    T_cw[:3, 3] = -R.T @ fd.pose_gt_raw[:3, 3]
    arrays = {"rgb": fd.rgb, "depth_raw": fd.depth_raw, "flow": fd.flow,
              "seg": np.asarray(fd.mask, np.int32), "T_cw_gt": T_cw}
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for k, a in arrays.items()}


def _uniforms(cfg: VDOConfig, frame: int, device, stream: int = 0) -> dict:
    """Frame `frame`'s draws for stream `stream` (a tracker seeded with
    cfg.seed + stream), on `device`: distinct streams draw distinct
    numbers, as the original's split keys do."""
    from .pipeline.draws import frame_uniforms

    return frame_uniforms(cfg.replace(seed=cfg.seed + stream), frame,
                          torch.Generator(), device)


def entry(device="cuda"):
    """(step, (state, inputs, draws, initialized)): one fused tracking
    frame step on `device` and its arguments, `step(*args)` running it."""
    from .parallel import make_frame_step, make_stream_state
    from .pipeline.draws import UniformDraws

    device = _on(device)
    cfg = _tiny_config()
    step = make_frame_step(cfg, device)
    state = make_stream_state(cfg, device)
    inputs = _example_inputs(cfg, device=device)
    draws = UniformDraws(_uniforms(cfg, 0, device))
    return step, (state, inputs, draws, False)


def _mesh_devices(n_devices: int, devices=None) -> list[torch.device]:
    """The n devices of the dry run: the first n of `devices`, else of the
    visible cards; cuda:0 n times where fewer cards are visible."""
    if devices is not None:
        devices = device_list(devices)
        if len(devices) < n_devices:
            raise ValueError(f"{len(devices)} devices given, {n_devices} "
                             f"asked for")
        return devices[:n_devices]
    _on("cuda")
    visible = torch.cuda.device_count()
    if visible >= n_devices:
        return [torch.device("cuda", i) for i in range(n_devices)]
    print(f"dryrun_multichip: {visible} card(s) visible; the {n_devices} "
          f"entries of the device list share cuda:0")
    return [torch.device("cuda", 0)] * n_devices


def _stacked(trees: list[dict]) -> dict:
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _multistream_leg(cfg: VDOConfig, devices, uniforms=None) -> dict:
    """Leg (a): S = len(devices) streams, stream s on frame 1 of scene s,
    through make_multistream_step over `devices` for two frames (the first
    initializes, the second tracks).  `uniforms(frame)` gives the S
    streams' draws stacked (default `_uniforms` per stream).  Returns the
    per-device states and metrics, the fleet and stream 0's draws."""
    from .parallel import (make_multistream_step, make_stream_state,
                           shard_streams, stack_states)

    devices = device_list(devices)
    S, home = len(devices), devices[0]
    if uniforms is None:
        def uniforms(frame):
            return _stacked([_uniforms(cfg, frame, home, s)
                             for s in range(S)])
    pstep = make_multistream_step(cfg, devices=devices)
    states = shard_streams(stack_states(
        [make_stream_state(cfg, home) for _ in range(S)]), devices)
    inputs = shard_streams(_stacked(
        [_example_inputs(cfg, seed=s, device=home) for s in range(S)]),
        devices)
    stream0 = []
    for i in range(2):
        u = uniforms(i)
        stream0.append({k: v[0] for k, v in u.items()})
        states, metrics, fleet = pstep(states, inputs,
                                       shard_streams(u, devices), i > 0)
    return {"states": states, "metrics": metrics,
            "fleet": {k: float(v) for k, v in fleet.items()},
            "stream0_uniforms": stream0}


def _solo_leg(cfg: VDOConfig, device, ms: dict) -> dict:
    """Leg (b): stream 0's inputs and draws through the solo
    make_frame_step: the largest pose-entry gap and the t_rpe gap to
    stream 0 of leg (a)'s run."""
    from .parallel import make_frame_step, make_stream_state
    from .pipeline.draws import UniformDraws

    step = make_frame_step(cfg, device)
    solo = make_stream_state(cfg, device)
    inputs = _example_inputs(cfg, seed=0, device=device)
    for i, u in enumerate(ms["stream0_uniforms"]):
        draws = UniformDraws({k: v.to(device) for k, v in u.items()})
        solo, metrics = step(solo, inputs, draws, i > 0)
    T_ms = ms["states"][0].frame.T_cw[0].double().cpu()
    rpe_ms = float(ms["metrics"][0]["t_rpe"][0])
    return {"pose_gap": float((T_ms - solo.frame.T_cw.double().cpu())
                              .abs().max()),
            "rpe_gap": abs(rpe_ms - float(metrics["t_rpe"]))}


def _full_ba_leg(devices) -> dict:
    """Leg (c): a 25-frame 256x192 3-object sequence tracked on the first
    device, its full dynamic graph built as full_ba_inplace builds it,
    solved on one device (lm_solve_chunked) and by full_ba_inplace with the
    edges sharded over `devices`, from its CUDA graphs where `devices`
    names one card (full_ba.graphs_for: a chunk length's first chunk runs
    eagerly, its second captures), eagerly over distinct cards.  Returns
    the numbers the asserts read, the tracked map (before either solve)
    and the graphs (None over distinct cards)."""
    from .backend.builders import build_full_graph
    from .backend.factor_graph import lm_solve_chunked, upload
    from .backend.full_ba import (FULL_BA_CHUNK, full_ba_inplace,
                                  graphs_for, scaled_lm_params)
    from .io.dataset import SyntheticDataset
    from .io.synthetic import make_scene
    from .pipeline import System

    devices = device_list(devices)
    home = devices[0]
    mcfg = _medium_config()
    scene = make_scene(num_frames=25, width=mcfg.camera.width,
                       height=mcfg.camera.height, num_objects=3, seed=11)
    ds = SyntheticDataset(scene, depth_map_factor=1.0, bf=mcfg.camera.bf)
    sysm = System(mcfg, enable_local_ba=False, enable_global_ba=False,
                  device=home)
    sysm.run_sequence(ds)

    g, v0, meta = build_full_graph(sysm.map, mcfg)
    n_points = int(v0.points.shape[0])
    n_edges = int(np.sum(np.asarray(g.obs_w) > 0)
                  + np.sum(np.asarray(g.ter_w) > 0))
    p = scaled_lm_params(mcfg, g.obs_w.shape[0], iters=FULL_BA_ITERS)
    v_ref, info_ref = lm_solve_chunked(*upload(g, v0, home), p,
                                       chunk=FULL_BA_CHUNK)
    ref_poses = v_ref.poses.double().cpu().numpy()

    m = copy.deepcopy(sysm.map)
    graphs = graphs_for(home, devices)
    info = full_ba_inplace(m, mcfg, iters=FULL_BA_ITERS, device=home,
                           devices=devices, graphs=graphs)
    # full_ba_inplace writes the solve's pose variables straight into
    # cam_pose_rf, the convention of v_ref.poses
    sh_poses = np.stack([np.asarray(m.cam_pose_rf[f], np.float64)
                         for f in range(m.num_frames)])
    return {"cost0": float(info["cost0"]), "cost": float(info["cost"]),
            "cost_ref": float(info_ref["cost"]),
            "pose_err": float(np.abs(sh_poses - ref_poses).max()),
            "n_points": n_points, "n_edges": n_edges,
            "n_motions": int(info["n_motions"]), "n_dyn": int(info["n_dyn"]),
            "n_static_points": int(meta.n_static_points),
            "iters_run": info["iters_run"], "t_solve_s": info["t_solve_s"],
            "config": mcfg, "map": sysm.map, "graphs": graphs}


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The full multi-stream tracking step over n devices, stream 0 against
    the solo step, and the sharded full BA against one device's, with the
    original's asserts and lines.  `devices`: a list of at least n (the
    first n are used); default the visible cards, or cuda:0 n times.
    Returns the legs' numbers."""
    devices = _mesh_devices(n_devices, devices)
    cfg = _tiny_config()

    ms = _multistream_leg(cfg, devices)
    print("dryrun_multichip tracking OK:", ms["fleet"])

    # per-stream-equals-solo: the same frames and draws through the
    # single-stream step reproduce stream 0 (placement must not change
    # results)
    solo = _solo_leg(cfg, devices[0], ms)
    pose_gap, rpe_gap = solo["pose_gap"], solo["rpe_gap"]
    _check(pose_gap < SOLO_POSE_TOL and rpe_gap < SOLO_RPE_TOL,
           f"S-stream stream 0 diverged from the solo step: pose "
           f"{pose_gap}, t_rpe {rpe_gap}")
    print(f"dryrun_multichip per-stream-equals-solo OK: pose gap "
          f"{pose_gap:.2e}, t_rpe gap {rpe_gap:.2e}")

    ba = _full_ba_leg(devices)
    _check(ba["n_points"] >= MIN_POINTS and ba["n_edges"] >= MIN_EDGES,
           f"full-BA leg below production-like scale: {ba['n_points']} "
           f"points, {ba['n_edges']} edges")
    _check(ba["n_motions"] >= MIN_MOTIONS and ba["n_dyn"] > 0,
           "production graph missing dynamic structure")
    cost_sh, cost_ref = ba["cost"], ba["cost_ref"]
    _check(cost_sh <= ba["cost0"], "sharded solve did not descend")
    _check(abs(cost_sh - cost_ref)
           <= COST_REL_TOL * max(cost_ref, 1e-6) + 1e-6,
           f"sharded vs single-device cost mismatch: {cost_sh} vs "
           f"{cost_ref}")
    _check(ba["pose_err"] < POSE_TOL,
           f"sharded vs single-device poses differ: {ba['pose_err']}")
    print("dryrun_multichip sharded full-BA (production builder) OK:",
          f"{ba['cost0']:.4g} -> {cost_sh:.4g}",
          f"(single-device {cost_ref:.4g}, pose diff {ba['pose_err']:.2e},",
          f"{ba['n_points']} points, {ba['n_edges']} edges,",
          f"{ba['n_motions']} motion vertices, {ba['n_dyn']} dyn obs,",
          f"{ba['n_static_points']} static points)")
    return {"devices": devices, "fleet": ms["fleet"], "solo": solo,
            "full_ba": ba}


if __name__ == "__main__":
    fn, args = entry()
    fn(*args)
    torch.cuda.synchronize()
    print("entry OK")
    dryrun_multichip(8)
