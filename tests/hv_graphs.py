"""Random factor graphs for the edge Hessian-vector product
(vdo_slam_tpu_torch/ops/edge_hessian_cuda.py), shaped as the full BA's
builder makes them (backend/builders.py:build_full_graph): static points
observed over runs of consecutive frames, every dynamic observation a point
of its own, ternary edges between a track's points in consecutive frames
through the motion of (frame, object), smoothness between an object's
consecutive motions, an odometry chain, one prior, and zero-weight padding
edges (obs_point, ter_prev and ter_cur padded with their last index, so
that they stay sorted; every other index padded with 0).  Imports no JAX:
the card's tests and chip_smoke.py use it too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vdo_slam_tpu_torch.backend import factor_graph as fg
from vdo_slam_tpu_torch.ops.edge_hessian_cuda import INCIDENCE, ROWS, WIDTH

# the 1,028-frame refine's full_* caps (benchmark/configs/kitti-refine.json)
# and a graph of about the counts its drives give under them
REFINE_CAPS = dict(obs=4407296, ter=2953216, points=3014656, motions=3712,
                   smo=3712)
REFINE_SHAPE = dict(F=1028, objects=3, per=800, n_static=44000, max_len=51)


def _se3(rng, n, rot, trans):
    """n random poses: rotations within `rot` rad, translations within
    `trans`."""
    w = rng.uniform(-rot, rot, (n, 3))
    th = np.linalg.norm(w, axis=1, keepdims=True)
    k = w / np.maximum(th, 1e-12)
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(0, 2, 1)
    s, c = np.sin(th)[:, :, None], np.cos(th)[:, :, None]
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = np.eye(3) + s * K + (1 - c) * K @ K
    T[:, :3, 3] = rng.uniform(-trans, trans, (n, 3))
    return T


def _pad(a, n, fill):
    out = np.full((n,) + a.shape[1:], fill, a.dtype)
    out[:a.shape[0]] = a
    return out


def make_graph(F=6, objects=2, per=3, n_static=10, max_len=4, caps=None,
               pad=2, seed=0):
    """(graph, variables) of numpy arrays: F frames, `objects` objects of
    `per` tracked points each in every frame (their order in a frame
    shuffled once, so that a frame's motions interleave), n_static static
    points seen over 3..max_len consecutive frames.  `caps` (keys obs, ter,
    points, motions, smo) pads each count to its cap; without, every edge
    type gets `pad` padding edges and points and motions `pad` rows."""
    rng = np.random.default_rng(seed)
    # static tracks
    L = rng.integers(3, max_len + 1, n_static)
    f0 = rng.integers(0, np.maximum(F - L, 0) + 1)
    s_pt = np.repeat(np.arange(n_static), L)
    s_pose = np.repeat(f0, L) + (np.arange(L.sum())
                                 - np.repeat(np.cumsum(L) - L, L))
    s_pose = np.minimum(s_pose, F - 1)
    # dynamic points: frame-major, `objects * per` slots a frame
    T = objects * per
    label = rng.permutation(T) % objects
    d_pt = n_static + np.arange(F * T)
    d_pose = np.repeat(np.arange(F), T)
    f = np.repeat(np.arange(1, F), T)
    slot = np.tile(np.arange(T), F - 1)
    ter_prev = n_static + (f - 1) * T + slot
    ter_cur = n_static + f * T + slot
    ter_mot = (f - 1) * objects + label[slot]
    n_mot = (F - 1) * objects
    o = np.tile(np.arange(objects), max(F - 2, 0))
    fs = np.repeat(np.arange(1, F - 1), objects)
    smo_a, smo_b = (fs - 1) * objects + o, fs * objects + o
    obs_pose = np.concatenate([s_pose, d_pose])
    obs_point = np.concatenate([s_pt, d_pt])
    n_pts = n_static + F * T
    capped = caps is not None
    caps = caps or dict(obs=obs_pose.size + pad, ter=ter_prev.size + pad,
                        points=n_pts + pad, motions=n_mot + pad,
                        smo=smo_a.size + pad)
    E, Et, Es = caps["obs"], caps["ter"], caps["smo"]
    Eo = -(-(F - 1) // 64) * 64 if capped else F - 1 + pad

    def w(n, cap, scale):
        return _pad(rng.uniform(0.5, 1.5, n).astype(np.float32) * scale,
                    cap, 0.0)

    g = dict(
        obs_pose=_pad(obs_pose, E, 0),
        obs_point=_pad(obs_point, E, obs_point[-1]),
        obs_meas=_pad(rng.normal(0, 5, (obs_pose.size, 3)), E, 0.0),
        obs_w=w(obs_pose.size, E, 1 / 16.0),
        odo_a=_pad(np.arange(F - 1), Eo, 0),
        odo_b=_pad(np.arange(1, F), Eo, 0),
        odo_meas_inv=_pad(_se3(rng, F - 1, 0.02, 0.3), Eo, 0.0),
        odo_w=w(F - 1, Eo, 1e4),
        pri_idx=np.zeros(1, np.int64),
        pri_meas_inv=np.eye(4)[None],
        pri_w=np.full(1, 1e5, np.float32),
        smo_a=_pad(smo_a, Es, 0),
        smo_b=_pad(smo_b, Es, 0),
        smo_w=w(smo_a.size, Es, 1e3),
        ter_prev=_pad(ter_prev, Et, ter_prev[-1] if ter_prev.size else 0),
        ter_cur=_pad(ter_cur, Et, ter_cur[-1] if ter_cur.size else 0),
        ter_mot=_pad(ter_mot, Et, 0),
        ter_w=w(ter_prev.size, Et, 1 / 100.0),
        alt_mot=np.zeros(1, np.int64),
        alt_w=np.zeros(1, np.float32),
    )
    # the SE(3) padding measurements are the identity, as the builders'
    g["odo_meas_inv"][F - 1:] = np.eye(4)
    poses = _se3(rng, F, 0.05, 0.2)
    poses[:, 2, 3] += 0.25 * np.arange(F)
    points = rng.uniform(-10, 10, (caps["points"], 3))
    points[:, 2] = np.abs(points[:, 2]) + 5.0
    points[n_pts:] = 0.0
    motions = np.tile(np.eye(4), (caps["motions"], 1, 1))
    motions[:n_mot] = _se3(rng, n_mot, 0.03, 0.5)
    v = dict(poses=poses, motions=motions, points=points)
    return g, v


def upload(graph: dict, v: dict, device):
    """The numpy graph as the solver's (Graph, Variables) on `device`."""
    G = fg.Graph(**{k: np.asarray(a) for k, a in graph.items()})
    V = fg.Variables(**{k: np.asarray(a) for k, a in v.items()})
    return fg.upload(G, V, device)


def keep_only(g: fg.Graph, edges) -> fg.Graph:
    """g with every edge type not in `edges` emptied (no edges)."""
    out = {}
    for name in (f.name for f in dataclasses.fields(fg.Graph)):
        x = getattr(g, name)
        kind = name.split("_")[0]
        out[name] = x if kind in edges else x[:0]
    return fg.Graph(**out)


def random_blocks(g: fg.Graph, seed: int = 0):
    """(blocks, weights) of random values shaped and laid out as
    factor_graph._linearize leaves them: Jo_pt a transposed 3x3 view of a
    (E, 4, 4) gather, Jt_prev an expanded identity (edge stride 0), the
    jacfwd blocks views of a larger tensor, the rest contiguous; weights
    random and positive where the graph's are, 0 on its padding edges."""
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float32).to(
            g.obs_w.device)

    blocks = {}
    for edge, inc in INCIDENCE.items():
        E = getattr(g, edge + "_w").shape[0]
        for J, _, kind in inc:
            shape = (E, ROWS[edge], WIDTH[kind])
            if J == "Jo_pt":
                b = rand(E, 4, 4)[..., :3, :3].transpose(-1, -2)
            elif J == "Jt_prev":
                b = torch.eye(3, device=g.obs_w.device).expand(E, 3, 3)
            elif J in ("Jd_a", "Jd_b", "Js_a", "Js_b", "Jp", "Ja"):
                b = rand(E, 1, shape[1], 1, shape[2])[:, 0, :, 0, :]
            else:
                b = rand(*shape)
            blocks[J] = b
    weights = {edge: getattr(g, edge + "_w")
               * (0.5 + rand(getattr(g, edge + "_w").shape[0]).abs())
               for edge in INCIDENCE}
    return blocks, weights


def dense_product(g: fg.Graph, blocks, weights, t, damp=None) -> tuple:
    """(poses, motions, points) of J^T W J t (+ damp * t), with J and W
    assembled as dense float64 matrices from the same blocks."""
    n = {k: getattr(t, k).shape[0] for k in ("poses", "motions", "points")}
    off = {"poses": 0, "motions": 6 * n["poses"],
           "points": 6 * n["poses"] + 6 * n["motions"]}
    cols = off["points"] + 3 * n["points"]
    Js, ws = [], []
    for edge, inc in INCIDENCE.items():
        E, R = getattr(g, edge + "_w").shape[0], ROWS[edge]
        J = torch.zeros(E, R, cols, dtype=torch.float64)
        for name, idx, kind in inc:
            W = WIDTH[kind]
            col = off[kind] + W * getattr(g, idx).cpu()[:, None] + torch.arange(W)
            J.scatter_add_(2, col[:, None, :].expand(E, R, W),
                           blocks[name].cpu().double())
        Js.append(J.reshape(E * R, cols))
        ws.append(weights[edge].cpu().double().repeat_interleave(R))
    J, w = torch.cat(Js), torch.cat(ws)
    x = torch.cat([getattr(t, k).cpu().double().reshape(-1)
                   for k in ("poses", "motions", "points")])
    y = J.T @ (w * (J @ x))
    if damp is not None:
        y = y + torch.cat([getattr(damp, k).cpu().double().reshape(-1)
                           for k in ("poses", "motions", "points")]) * x
    return (y[:off["motions"]].reshape(-1, 6),
            y[off["motions"]:off["points"]].reshape(-1, 6),
            y[off["points"]:].reshape(-1, 3))


def random_tangent(v: fg.Variables, seed: int = 0, device=None) -> fg.Tangent:
    gen = torch.Generator().manual_seed(seed)
    dev = device or v.poses.device
    return fg.Tangent(*[torch.randn(x.shape[0], k, generator=gen).to(dev)
                        for x, k in ((v.poses, 6), (v.motions, 6),
                                     (v.points, 3))])
