"""The Oxford Multimotion deployment (benchmark/configs/omd.json) on the
port's fused path, and the indoor world that the benchmark's cell
omd-swinging4 renders for it (benchmark/scene_room.py, kind "room").

(a) the room's render against its float64 geometry; (b) the object rows
the kind writes, parsed by the port's ObjPoseParsingOX; (c) the wire's
depth plane at the configuration's scale against the world's nearest
surface; (d) System(mode="fused") over 12 frames of a small room, judged by
the benchmark's reference.  Each test's tolerance is stated with its
reason.  One torch thread; nothing here imports jax.
"""

import copy
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import loads
from benchmark import reference as ref
from benchmark import scene as S
from benchmark import scene_room as R
from benchmark.program import build_config
from benchmark.wire import pack_entropy
from vdo_slam_tpu_torch.io.packing import (depth_exceptions, unpack_frame,
                                           wire_kwargs)
from vdo_slam_tpu_torch.ops.image import preprocess_depth
from vdo_slam_tpu_torch.pipeline.tracking import obj_pose_parsing_ox

ROOT = Path(__file__).resolve().parent.parent
CONF = json.loads((ROOT / "benchmark/configs/omd.json").read_text())
ROOM = loads.kind_module("room")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_conf(width=160, height=120):
    """omd.json at width x height: the intrinsics (bf = fx x the
    baseline among them) scaled with the image, and the two pixel-sized
    settings with it, the classifier's border
    band (Tracking.cc:1404-1408, 25 rows and 50 columns at 640x480) and
    the object sampling step (4 px), so that a box keeps its share of the
    image border and its number of object samples; every other value is
    the file's."""
    conf = copy.deepcopy(CONF)
    c = conf["config"]
    s = width / c["camera"]["width"]
    cam = c["camera"]
    cam.update(width=width, height=height, fx=cam["fx"] * s,
               fy=cam["fy"] * s, cx=cam["cx"] * s, cy=cam["cy"] * s,
               bf=cam["bf"] * s)
    c["tracking"].update(boundary_shrink_row=round(25 * s),
                         boundary_shrink_col=round(50 * s))
    c["frontend"].update(obj_sample_step=max(1, round(4 * s)))
    return conf


def _faces_world(lay, f):
    """(origin, eu, ev, label) of every room plane and box face at frame
    f, in the world, by plain numpy."""
    out = [(o, u, v, 0) for o, u, v in lay.patches]
    for k, h in enumerate(lay.half):
        T = lay.L[f, k]
        for o, u, v in R.box_faces(h):
            out.append((T[:3, :3] @ o + T[:3, 3], T[:3, :3] @ u,
                        T[:3, :3] @ v, k + 1))
    return out


def _first_hit(lay, f, px):
    """(depth, label, world point) of the first plane the ray through
    pixel px meets at frame f, every plane tested, in float64."""
    Twc = lay.T_wc[f]
    K = lay.K
    ray = Twc[:3, :3] @ np.array([(px[0] - K[0, 2]) / K[0, 0],
                                  (px[1] - K[1, 2]) / K[1, 1], 1.0])
    c = Twc[:3, 3]
    best = (math.inf, -1, None)
    for o, u, v, lab in _faces_world(lay, f):
        n = np.cross(u, v)
        den = ray @ n
        if abs(den) < 1e-12:
            continue
        s = (o - c) @ n / den
        X = c + s * ray
        G = np.array([[u @ u, u @ v], [u @ v, v @ v]])
        a, b = np.linalg.solve(G, np.array([(X - o) @ u, (X - o) @ v]))
        if s > 0.1 and 0 <= a <= 1 and 0 <= b <= 1 and s < best[0]:
            best = (s, lab, X)
    return best


def test_a_render_matches_the_geometry():
    """At the pixel nearest each front-facing box face's centre, frames 0
    to 3 of a 160x120 room: the mask is the label and the depth the
    distance of the first plane that an independent float64 ray test
    meets (depth within float32's rounding, 1e-6 relative); the forward
    flow carries that point with its box's motion into the next camera
    (within 1e-4 px: the render's float32 flow of a float64 projection).
    Every box is seen, and faces turn: the largest rotation of a box from
    one frame to the next exceeds 1 degree."""
    conf = small_conf()
    cfg = build_config(conf)
    lay = ROOM.layout_for(conf, cfg, 4, seed=2**31 + 5)
    assert lay.num_objects == 4 and lay.max_rotation_deg() > 1.0
    rend = R.Renderer(lay, "cpu")
    K = lay.K
    seen = set()
    for f in range(4):
        out = rend.frame(f)
        Tcw = S.inv(lay.T_wc[f])
        Tcn = S.inv(lay.T_wc[f + 1])
        for k, h in enumerate(lay.half):
            for o, u, v in R.box_faces(h):
                T = lay.L[f, k]
                Xc = Tcw @ T @ np.append(o + (u + v) / 2, 1.0)
                n_cam = Tcw[:3, :3] @ T[:3, :3] @ np.cross(u, v)
                if Xc[2] <= 0.1 or n_cam @ Xc[:3] >= 0:
                    continue                 # behind the camera, or back
                px = np.rint(K[:2, :2] @ (Xc[:2] / Xc[2]) + K[:2, 2])
                if not (0 <= px[0] < lay.width and 0 <= px[1] < lay.height):
                    continue
                z, lab, X = _first_hit(lay, f, px)
                i, j = int(px[1]), int(px[0])
                assert int(out["mask"][i, j]) == lab
                assert abs(float(out["depth"][i, j]) - z) <= 1e-6 * z
                if lab != k + 1:
                    continue                 # another box covers it
                seen.add(k)
                Xn = Tcn @ lay.H[f + 1, k] @ np.append(X, 1.0)
                want = K[:2, :2] @ (Xn[:2] / Xn[2]) + K[:2, 2] - px
                got = out["flow"][i, j].double().numpy()
                np.testing.assert_allclose(got, want, atol=1e-4)
    assert seen == set(range(4))


def test_b_ox_rows_parse_to_the_layouts_poses():
    """The kind's rows, parsed by the port's obj_pose_parsing_ox with the
    first camera's float32 pose as the origin, give each box's pose in
    the world of the first camera (reference.truth) within float32's
    rounding of poses a few metres from the origin (2e-6 on the rotation,
    1e-5 m on the translation)."""
    conf = CONF
    cfg = build_config(conf)
    lay = ROOM.layout_for(conf, cfg, 200, seed=11)
    gt = ref.truth(lay.T_wc, lay.L)["L"]
    origin = lay.T_wc[0].astype(np.float32)
    for f in (0, 1, 57, 199):
        rows = R.obj_rows_ox(lay, f)
        assert rows.shape == (4, 10) and rows.dtype == np.float32
        for k, row in enumerate(rows):
            assert row[0] == f and row[1] == k + 1
            P = obj_pose_parsing_ox(row, origin)
            np.testing.assert_allclose(P[:3, :3], gt[f, k, :3, :3],
                                       atol=2e-6)
            np.testing.assert_allclose(P[:3, 3], gt[f, k, :3, 3], atol=1e-5)


def _wire_frame(depth_m: np.ndarray, tr, bf: float):
    """One frame whose depth map is depth_m (1, H, W), packed by the
    benchmark's packer at the configuration's scale and decoded by the
    port: (raw sent, raw decoded, metric depth decoded, scale)."""
    dev = torch.device("cpu")
    d = torch.as_tensor(depth_m, dtype=torch.float32, device=dev)
    raw = S.depth_raw(d, tr.depth_map_factor, bf)
    B, H, W = d.shape
    kw = wire_kwargs(tr)
    buf = pack_entropy(torch.full((B, H, W), 0.5), raw,
                       torch.full((B, H, W, 2), 0.25),
                       torch.zeros((B, H, W), dtype=torch.int32),
                       kw["depth_scale"], tr.wire_seg_cap,
                       tr.wire_depth_exc_cap)
    _, back, _, _ = unpack_frame(buf, hw=(H, W), **kw)
    metric = preprocess_depth(back[0], tr.dataset, bf, tr.depth_map_factor)
    return raw, back, metric, kw["depth_scale"], buf


def test_c_the_wire_carries_the_nearest_box():
    """The nearest any box comes to the camera in a cell-sized run (1,300
    frames at 640x480), and a surface at 300 px of disparity, packed by
    benchmark/wire.py:pack_entropy at the configuration's scale
    (wire_depth_steps 64: 1/64 px of disparity), come back from the
    port's unpack_frame as the quantized samples sent, exactly, and as
    metric depth within half a step of disparity.  At the JAX package's
    256 steps per pixel both lie beyond the u16 plane (255.996 px,
    1.514 m at bf 387.5744) and come back clamped, metres off: the
    configuration's scale is the repair.  The packed buffer's depth
    exceptions are what the port counts (io/packing.py:
    depth_exceptions)."""
    cfg = build_config(CONF)
    tr, bf = cfg.tracking, cfg.camera.bf
    lay = ROOM.layout_for(CONF, cfg, 1300, seed=2**33 + 1)
    z_near = lay.min_depth()
    assert bf / 1024.0 < z_near < bf / 256.0     # the repair is needed
    rng = np.random.default_rng(3)
    depth = rng.uniform(z_near, 6.0, size=(1, 24, 40))
    depth[0, 0, :5] = z_near
    depth[0, 5, 7:12] = bf / 300.0               # 300 px of disparity
    raw, back, metric, scale, buf = _wire_frame(depth, tr, bf)
    sent = torch.clamp(torch.round(raw * scale), 0, 65535)
    assert float(sent.max()) < 65535             # nothing clamped
    assert torch.equal(back, (sent * (1.0 / scale)).to(torch.float32))
    for z in (z_near, bf / 300.0):
        at = np.isclose(depth[0], z)
        step = z * z / bf / tr.wire_depth_steps  # one step of disparity
        assert np.abs(metric.numpy()[at] - z).max() <= 0.5 * step + 1e-6 * z
    d16 = sent.to(torch.int64).reshape(-1)
    big = (torch.diff(d16, prepend=torch.zeros(1, dtype=torch.int64)).abs()
           > 127)
    assert depth_exceptions(buf[0].numpy(), (24, 40), tr.flow_down,
                            tr.wire_depth_exc_cap) == int(big.sum()) > 0

    jax_wire = dataclasses.replace(tr, wire_depth_steps=256)
    _, back256, metric256, _, _ = _wire_frame(depth, jax_wire, bf)
    for z in (z_near, bf / 300.0):
        at = np.isclose(depth[0], z)
        assert float(back256.max()) == 65535 / (256.0 / tr.depth_map_factor)
        assert np.abs(metric256.numpy()[at] - z).min() > 0.1


def test_d_fused_system_tracks_a_small_room():
    """System(cfg, mode="fused") with the omd configuration (small_conf:
    160x120) over 12 frames, on the CPU, under a recorder, judged by the
    benchmark's reference over frames 1-11: no frame missing; the camera
    within 1e-3 m and 0.01 deg a frame (the wire's flow is fp16 at half
    resolution; sound runs here read ~3e-5 m, ~6e-4 deg); every box has
    an estimate on at least 8 of the 11 frames, and every estimate's
    widest corner gap is within 0.05 m, 2.6 px at the farthest box's
    2.9 m at this resolution, their median within 0.005 m (sound runs
    read at most 0.012 m, median 0.0008 m).  The program's counters: one
    depth exception count a packed frame, each at most the cap; objects
    with an estimate as each report counts them; grid samples taken into
    the static bank on every frame."""
    from vdo_slam_tpu_torch.pipeline import System
    from vdo_slam_tpu_torch.utils import profiling

    conf = small_conf()
    cfg = build_config(conf)
    F = 12
    lay = ROOM.layout_for(conf, cfg, F, seed=7)
    frames = ROOM.packed_frames(lay, cfg, torch.device("cpu"), F)
    sysm = System(cfg, enable_local_ba=True, enable_global_ba=False,
                  mode="fused", device="cpu")
    with profiling.recording() as rec:
        reps = sysm.run_sequence(loads._Seq(frames, 0, F))
    assert len(reps) == F
    out = loads.outputs(sysm, lay.num_frames)
    C = ref.corners(lay.obj_patches)
    judged = list(range(1, F))
    got = ref.judge(out, lay.T_wc, lay.L, C, judged)
    assert got["frames_missing"] == 0
    assert got["cam_t_max"] <= 1e-3 and got["cam_r_max"] <= 0.01, got
    gt = ref.truth(lay.T_wc, lay.L)
    ests = [e for e in out["obj"] if e[0] in judged]
    per_box = [sum(1 for e in ests if e[1] == k) for k in range(4)]
    assert min(per_box) >= 8, per_box
    _, _, corner = ref.obj_errors(ests, gt["L"], C)
    assert corner.max() <= 0.05, corner.max()
    assert np.median(corner) <= 0.005, np.median(corner)

    exc = [c.value for c in rec.counted("wire.depth_exc")]
    assert len(exc) == F and max(exc) <= cfg.tracking.wire_depth_exc_cap
    assert [c.value for c in rec.counted("fused.obj_active")] == [
        r["n_objects"] for r in reps]
    kp = [c.value for c in rec.counted("fused.sample_kp")]
    assert len(kp) == F and min(kp) > 0
