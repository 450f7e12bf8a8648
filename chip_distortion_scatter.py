#!/usr/bin/env python3
"""Where the card and the CPU part on the distorted bench scene: frame 0
stage by stage, then frame by frame over chip_smoke.py phase 9's runs.

    python3 chip_distortion_scatter.py                  # one GPU
    python3 chip_distortion_scatter.py --deterministic  # diagnostic only
    python3 chip_distortion_scatter.py --f64-resize     # experiment only

First, frame 0 of three inputs (the bench scene rendered through the barrel
lens chip_smoke uses with k1/k2 configured; the same with seeded gray noise
added to the image; the undistorted bench scene under the unconfigured
camera), in pipeline order on each device from the same inputs and draws:
the gray image, each pyramid level, each level's two FAST score maps, each
level's select_corners output, the detections of the whole pyramid, their
undistorted keypoints, and the static and object candidate banks of
`stages.make_prepare`.  Each stage is also fed the CPU's output of the
stage before it ("fed"), so a stage that departs by itself shows apart
from one that inherits a departure.  Keypoint arrays are compared row by
row and as sets sorted by (level, y, x); the first array that differs is
named on the scene's JSON line.

Then the 25 distorted frames through System(mode="reference") and
System(mode="fused"), BA off, once on each device: per mode and frame, the
camera pose gap between the devices (m, deg), the camera inliers on each,
and what the two archives show about the banks (rows valid on one device
only; rows valid on both whose keypoints lie 1e-2 px or more apart; of the
rows within 1e-2 px, how many sit in different pixels and how many carry a
different depth or label).  Then the first frame past 1e-3 m / 0.01 deg,
one JSON line per mode.  --deterministic runs these frames alone under
torch.use_deterministic_algorithms(True) (with CUBLAS_WORKSPACE_CONFIG
set): a departure that stays is not a nondeterministic CUDA op's.
--f64-resize runs everything with the detector's pyramid replaced, on both
devices, by `f64_pyramid` (the resize as float64 products, rounded once:
the same bits on every device), to show what the card and the CPU part on
once the resize no longer differs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

T_TOL_M, R_TOL_DEG = 1e-3, 0.01       # the undistorted step's bound
XY_CLOSE_PX = 1e-2
NOISE_SIGMA = 0.02                    # gray noise of the noisy variant


def _bank_flips(xy_a, xy_b, valid_a, valid_b, vals_a, vals_b):
    """(rows valid on one device only, rows valid on both at least
    XY_CLOSE_PX apart, rows within XY_CLOSE_PX in different pixels, rows
    within XY_CLOSE_PX with any gathered value differing)."""
    both = valid_a & valid_b
    close = both & (np.abs(xy_a - xy_b).max(-1) < XY_CLOSE_PX)
    edge = close & (np.floor(xy_a) != np.floor(xy_b)).any(-1)
    diff = np.zeros_like(close)
    for a, b in zip(vals_a, vals_b):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        diff |= d.reshape(len(close), -1).max(-1) > 1e-3 * np.maximum(
            np.abs(np.asarray(b, np.float64)).reshape(len(close), -1).max(-1),
            1.0)
    return (int((valid_a != valid_b).sum()), int((both & ~close).sum()),
            int(edge.sum()), int((close & diff).sum()))


def frame_table(card_map, cpu_map, card_reps, cpu_reps) -> list[dict]:
    from chip_smoke import _pose_gap

    rows = []
    for f in range(cpu_map.num_frames):
        t, r = _pose_gap(card_map.cam_pose[f], cpu_map.cam_pose[f])
        stat = _bank_flips(card_map.stat_xy[f], cpu_map.stat_xy[f],
                           card_map.stat_valid[f], cpu_map.stat_valid[f],
                           [card_map.stat_depth[f]], [cpu_map.stat_depth[f]])
        dyn = _bank_flips(card_map.dyn_xy[f], cpu_map.dyn_xy[f],
                          card_map.dyn_valid[f], cpu_map.dyn_valid[f],
                          [card_map.dyn_depth[f], card_map.dyn_obj_label[f],
                           card_map.dyn_sem_label[f]],
                          [cpu_map.dyn_depth[f], cpu_map.dyn_obj_label[f],
                           cpu_map.dyn_sem_label[f]])
        rows.append({"frame": f, "cam_t_m": t, "cam_r_deg": r,
                     "inliers": [card_reps[f].get("n_inlier_cam"),
                                 cpu_reps[f].get("n_inlier_cam")],
                     "static": stat, "dynamic": dyn})
    return rows


# --------------------------------------------------------------------------
# frame 0, stage by stage
# --------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _to(v, dev):
    """Tensors, and lists, tuples and dicts of them, on `dev`."""
    if isinstance(v, dict):
        return {k: _to(x, dev) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_to(x, dev) for x in v)
    return v.to(dev)


def array_gap(a, b) -> dict:
    """Largest entry gap and the count of entries that differ."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b)
    return {"n": int(d.size), "n_diff": int((d > 0).sum()),
            "max_gap": float(d.max()) if d.size else 0.0}


def _key_rows(xy, valid, level):
    lev = np.zeros(len(xy)) if level is None else np.asarray(level)
    k = np.stack([lev, xy[:, 1], xy[:, 0]], -1)[valid]
    return k[np.lexsort((k[:, 2], k[:, 1], k[:, 0]))]


def _unmatched(A, B) -> tuple[int, float]:
    """Rows of A with no row of B at the same level within XY_CLOSE_PX,
    and the largest gap of the rows that have one."""
    if not len(A):
        return 0, 0.0
    if not len(B):
        return len(A), 0.0
    same = A[:, None, 0] == B[None, :, 0]
    d = np.abs(A[:, None, 1:] - B[None, :, 1:]).max(-1)
    d = np.where(same, d, np.inf).min(1)
    ok = d < XY_CLOSE_PX
    return int((~ok).sum()), float(d[ok].max()) if ok.any() else 0.0


def keypoint_gap(xy_a, xy_b, va, vb, level=None) -> dict:
    """Row by row (rows valid on one only or XY_CLOSE_PX apart) and as
    sets sorted by (level, y, x): rows of each with no partner in the
    other, the largest gap of matched rows, and whether the sorted sets are
    equal while the rows are not (a reordering)."""
    xy_a, xy_b = np.asarray(xy_a, np.float64), np.asarray(xy_b, np.float64)
    va, vb = np.asarray(va, bool), np.asarray(vb, bool)
    both = va & vb
    apart = both & (np.abs(xy_a - xy_b).max(-1) >= XY_CLOSE_PX)
    rows = int((va != vb).sum() + apart.sum())
    A, B = _key_rows(xy_a, va, level), _key_rows(xy_b, vb, level)
    only_a, gap_a = _unmatched(A, B)
    only_b, gap_b = _unmatched(B, A)
    return {"n_valid": [int(va.sum()), int(vb.sum())], "rows_apart": rows,
            "only_a": only_a, "only_b": only_b,
            "matched_max_gap": max(gap_a, gap_b),
            "reordered": bool(rows and not only_a and not only_b)}


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of one axis of the antialiased bilinear resize
    (half-pixel centres, the triangle filter widened by the scale when
    shrinking, rows normalized), in float32 as jax.image.resize computes
    them outside jit."""
    f32 = np.float32
    inv = 1.0 / (n_out / n_in)
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv) - f32(0.5)
    x = np.abs(sample[:, None] - np.arange(n_in, dtype=f32)[None, :]) / f32(
        max(inv, 1.0))
    w = np.maximum(f32(1.0) - x, f32(0.0))
    return w / w.sum(1, keepdims=True, dtype=f32)


def f64_pyramid(gray, n_levels: int = 8, scale_factor: float = 1.2):
    """ops/fast.py:pyramid with each level the float64 product of the
    resize weights, rounded to float32 once: float64 sums in another order
    round to the same float32 but within 1e-16 of a rounding midpoint, so
    the card and the CPU give the same levels."""
    from vdo_slam_tpu_torch.ops.fast import level_shapes

    H, W = gray.shape[-2:]
    g64 = gray.to(torch.float64)
    out = [gray.contiguous()]
    for Hl, Wl in level_shapes(H, W, n_levels, scale_factor)[1:]:
        wy, wx = (torch.from_numpy(_resize_weights(n, m)).to(gray.device,
                                                             torch.float64)
                  for n, m in ((H, Hl), (W, Wl)))
        out.append((wy @ g64 @ wx.mT).to(torch.float32).contiguous())
    return out


def frame0_outputs(fd, cfg, device, noise=None, fed=None) -> dict:
    """Frame 0's arrays on `device`, in pipeline order.  `fed`: the CPU's
    outputs, each stage of which replaces this device's input to the next
    stage (on `device`)."""
    from vdo_slam_tpu_torch.ops import fast
    from vdo_slam_tpu_torch.ops.fast_cuda import fast_score_pyramid
    from vdo_slam_tpu_torch.ops.image import rgb_to_gray
    from vdo_slam_tpu_torch.pipeline import stages
    from vdo_slam_tpu_torch.pipeline.draws import (UniformDraws,
                                                   frame_uniforms)

    fe = cfg.frontend
    dev = torch.device(device)

    def put(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x)).to(dtype).to(dev)

    def src(name, own):
        """This device's input to the next stage: its own, or the CPU's."""
        return own if fed is None else _to(fed[name], dev)

    rgb = np.asarray(fd.rgb, np.float32)
    if noise is not None:
        rgb = np.clip(rgb + noise, 0.0, 1.0).astype(np.float32)
    rgb_t = put(rgb)
    out = {"gray": rgb_to_gray(rgb_t)}
    out["levels"] = fast.pyramid(src("gray", out["gray"]), fe.n_levels,
                                 fe.scale_factor)
    t_scale = 1.0 / 255.0
    out["scores"] = fast_score_pyramid(
        list(src("levels", out["levels"])),
        float(fe.ini_th_fast) * t_scale, float(fe.min_th_fast) * t_scale)
    scores = src("scores", out["scores"])
    budgets = fast.level_budgets(fe.n_features, fe.n_levels, fe.scale_factor)
    out["select"] = [
        fast.select_corners(s_ini, s_min,
                            max(int(fe.fast_cell / fe.scale_factor ** l), 8),
                            budgets[l])
        for l, (s_ini, s_min) in enumerate(scores)]
    out["det"] = fast.select_pyramid(scores, n_features=fe.n_features,
                                     scale_factor=fe.scale_factor,
                                     cell=fe.fast_cell)
    warps = stages._warps(cfg, dev)
    if warps is not None:
        out["undistorted"] = warps[0](src("det", out["det"])["xy"])
    draws = UniformDraws(frame_uniforms(cfg, 0, torch.Generator(), dev))
    prep = stages.make_prepare(cfg, dev)(
        rgb_t, put(fd.depth_raw), put(fd.flow), put(fd.mask, torch.int32),
        draws, scores=scores)
    out["stat_cand"], out["obj_cand"] = prep["stat_cand"], prep["obj_cand"]
    return out


def compare_frame0(a: dict, b: dict) -> list[dict]:
    """One row per array, in pipeline order: a (card) against b (CPU)."""
    rows = [dict(stage="gray", **array_gap(_np(a["gray"]), _np(b["gray"])))]
    for l, (la, lb) in enumerate(zip(a["levels"], b["levels"])):
        rows.append(dict(stage=f"level {l}", **array_gap(_np(la), _np(lb))))
    for l, ((ia, ma), (ib, mb)) in enumerate(zip(a["scores"], b["scores"])):
        rows.append(dict(stage=f"score_ini {l}",
                         **array_gap(_np(ia), _np(ib))))
        rows.append(dict(stage=f"score_min {l}",
                         **array_gap(_np(ma), _np(mb))))
    for l, ((xa, sa, va), (xb, sb, vb)) in enumerate(zip(a["select"],
                                                         b["select"])):
        rows.append(dict(stage=f"select {l}",
                         **keypoint_gap(_np(xa), _np(xb), _np(va), _np(vb)),
                         score=array_gap(_np(sa), _np(sb))))
    da, db = a["det"], b["det"]
    rows.append(dict(stage="detections",
                     **keypoint_gap(_np(da["xy"]), _np(db["xy"]),
                                    _np(da["valid"]), _np(db["valid"]),
                                    _np(da["octave"]))))
    if "undistorted" in a:
        rows.append(dict(stage="undistorted",
                         **keypoint_gap(_np(a["undistorted"]),
                                        _np(b["undistorted"]),
                                        _np(da["valid"]), _np(db["valid"]),
                                        _np(da["octave"])),
                         xy=array_gap(_np(a["undistorted"]),
                                      _np(b["undistorted"]))))
    for bank in ("stat_cand", "obj_cand"):
        ba, bb = a[bank], b[bank]
        rows.append(dict(stage=bank,
                         **keypoint_gap(_np(ba["xy"]), _np(bb["xy"]),
                                        _np(ba["valid"]), _np(bb["valid"])),
                         depth=array_gap(_np(ba["depth"]),
                                         _np(bb["depth"]))))
    return rows


def _differs(row: dict) -> bool:
    if "rows_apart" in row:
        return bool(row["rows_apart"] or row["only_a"] or row["only_b"]
                    or row.get("xy", {}).get("n_diff", 0))
    return bool(row["n_diff"])


def _fmt(row: dict) -> str:
    if "rows_apart" in row:
        extra = ""
        if "xy" in row:
            extra = (f", xy entries differing {row['xy']['n_diff']} "
                     f"(largest {row['xy']['max_gap']:.3e} px)")
        if "score" in row:
            extra = (f", scores differing {row['score']['n_diff']} "
                     f"(largest {row['score']['max_gap']:.3e})")
        return (f"valid {row['n_valid'][0]} / {row['n_valid'][1]}; row by "
                f"row {row['rows_apart']} apart; as sorted sets "
                f"{row['only_a']} card-only, {row['only_b']} CPU-only, "
                f"matched within {row['matched_max_gap']:.3e} px"
                f"{' (reordered)' if row['reordered'] else ''}{extra}")
    return (f"{row['n_diff']} of {row['n']} entries differ, largest "
            f"{row['max_gap']:.3e}")


def frame0_report(name, ds, cfg, card: str, device="cuda", host="cpu",
                  noise_sigma=0.0) -> dict:
    """Frame 0 on `device` against `host`: each device from the inputs,
    then `device` fed the host's outputs stage by stage."""
    fd = ds[0]
    noise = None
    if noise_sigma:
        noise = (np.random.default_rng(0).standard_normal(
            np.shape(fd.rgb)) * noise_sigma).astype(np.float32)
    cpu = frame0_outputs(fd, cfg, host, noise)
    own = frame0_outputs(fd, cfg, device, noise)
    fed = frame0_outputs(fd, cfg, device, noise, fed=cpu)
    rows = compare_frame0(own, cpu)
    fed_rows = compare_frame0(fed, cpu)
    print(f"frame 0 of {name}, card against CPU, in pipeline order [{card}]:")
    for r, rf in zip(rows, fed_rows):
        print(f"  {r['stage']:<12} own: {_fmt(r)}")
        if rf["stage"] != "gray":
            print(f"  {'':<12} fed: {_fmt(rf)}")
    first = next((r["stage"] for r in rows if _differs(r)), None)
    first_fed = next((r["stage"] for r in fed_rows
                      if r["stage"] != "gray" and _differs(r)), None)
    rec = {"scene": name, "card": card, "first_differs": first,
           "first_differs_fed": first_fed, "stages": rows,
           "stages_fed": fed_rows}
    print(json.dumps(rec))
    return rec


# --------------------------------------------------------------------------
# the 25 frames
# --------------------------------------------------------------------------

def frames_report(dds, dcfg, card: str, n_frames: int, tag: str = "",
                  device="cuda", host="cpu") -> list[dict]:
    from vdo_slam_tpu_torch.bench import _View
    from vdo_slam_tpu_torch.pipeline import System

    out = []
    for mode in ("reference", "fused"):
        maps, reps = {}, {}
        for dev in (device, host):
            sysm = System(dcfg, enable_local_ba=False,
                          enable_global_ba=False, mode=mode, device=dev)
            t0 = time.perf_counter()
            reps[dev] = sysm.run_sequence(_View(dds, 0, n_frames))
            m = sysm.metrics()
            print(f"mode {mode} on {dev}{tag}: {n_frames} frames in "
                  f"{time.perf_counter() - t0:.1f} s, cam_t "
                  f"{m['cam_t_rpe']:.4e} m, cam_r {m['cam_r_rpe_deg']:.4e} "
                  f"deg [{card}]")
            maps[dev] = sysm.map
        rows = frame_table(maps[device], maps[host], reps[device],
                           reps[host])
        print(f"mode {mode}{tag}, card against CPU per frame: t (m), r "
              f"(deg), camera inliers card / CPU, static / dynamic rows "
              f"(valid on one only, apart, edge, value)")
        for row in rows:
            print(f"  {row['frame']:2d} {row['cam_t_m']:.3e} "
                  f"{row['cam_r_deg']:.3e}  {row['inliers']}  "
                  f"{row['static']}  {row['dynamic']}")
        past = [r["frame"] for r in rows if r["cam_t_m"] > T_TOL_M
                or r["cam_r_deg"] > R_TOL_DEG]
        flips = [r["frame"] for r in rows
                 if sum(r["static"][2:]) + sum(r["dynamic"][2:])]
        rec = {"mode": mode, "card": card, "deterministic": bool(tag),
               "first_past_bound": past[0] if past else None,
               "first_gather_flip": flips[0] if flips else None,
               "max_cam_t_m": max(r["cam_t_m"] for r in rows),
               "max_cam_r_deg": max(r["cam_r_deg"] for r in rows),
               "frames": rows}
        print(json.dumps(rec))
        out.append(rec)
    return out


def scenes(n_frames: int):
    """(distorted dataset, its config, undistorted dataset, bench config)."""
    from chip_smoke import DIST, W, H, bench_config
    from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
    from vdo_slam_tpu_torch.io.synthetic import make_scene

    kw = dict(num_frames=n_frames + 1, width=W, height=H, num_objects=3,
              fx=721.5377, seed=7)
    dds = SyntheticDataset(make_scene(dist=DIST, **kw),
                           depth_map_factor=256.0, bf=387.5744)
    uds = SyntheticDataset(make_scene(**kw), depth_map_factor=256.0,
                           bf=387.5744)
    cfg = bench_config()
    dcfg = cfg.replace(camera=dataclasses.replace(cfg.camera, k1=DIST[0],
                                                  k2=DIST[1]))
    return dds, dcfg, uds, cfg


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    deterministic = "--deterministic" in argv
    if "--f64-resize" in argv:
        from vdo_slam_tpu_torch.ops import fast

        fast.pyramid = f64_pyramid
        print("the detector's pyramid: f64_pyramid on both devices")
    if deterministic:    # before cuBLAS makes its first handle
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_distortion_scatter: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import N_OPT_FRAMES, card_line

    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    dds, dcfg, uds, cfg = scenes(N_OPT_FRAMES)
    print(f"scenes made in {time.perf_counter() - t0:.1f} s")
    if deterministic:
        torch.use_deterministic_algorithms(True)
        try:
            frames_report(dds, dcfg, card, N_OPT_FRAMES,
                          tag=" (deterministic algorithms)")
        finally:
            torch.use_deterministic_algorithms(False)
        return 0
    frame0_report("the distorted scene (k1/k2 configured)", dds, dcfg, card)
    frame0_report(f"the distorted scene with gray noise (sigma "
                  f"{NOISE_SIGMA}, seed 0)", dds, dcfg, card,
                  noise_sigma=NOISE_SIGMA)
    frame0_report("the undistorted scene", uds, cfg, card)
    frames_report(dds, dcfg, card, N_OPT_FRAMES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
