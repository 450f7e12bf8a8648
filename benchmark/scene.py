"""The benchmark's scene: a driving world of textured planes, rendered on the
device from a seed, with its exact ground truth.

It is a PyTorch copy of the port's `io/synthetic.py:make_scene`, widened
so that a drive of any length stays inside the world:

- the layout (planes, object sizes and starts, textures, the camera path)
  is drawn on the host from `numpy.random.default_rng(seed)` in
  make_scene's order, so with `road_extra=0` and the "constant" motion
  model it is make_scene's layout (held to it by
  benchmark/tests/test_bench_scene.py);
- `road_extra` metres lengthen the ground, the side walls and the row of
  facades (at make_scene's density) and move the far wall back;
- the "follow" motion model keeps each object on the road beside the
  camera: its body-frame step runs at the camera's mean speed with a
  bounded speed and heading weave, where make_scene's constant step would
  drive it out of view within a few hundred frames;
- the render ray-casts every pixel against the planes in float64 on the
  device, as make_scene does on the host, skipping planes wholly behind the
  camera (they cannot be hit) and planes whose nearest corner lies beyond
  `view_range` metres (the world's view distance; make_scene's world lies
  inside it).

Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _rodrigues(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def pose(w, t) -> np.ndarray:
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = _rodrigues(np.asarray(w, dtype=np.float64))
    T[:3, 3] = t
    return T


def inv(T: np.ndarray) -> np.ndarray:
    """Inverse of a rigid 4x4 (or a stack of them)."""
    R = np.swapaxes(T[..., :3, :3], -1, -2)
    out = np.zeros_like(T)
    out[..., :3, :3] = R
    out[..., :3, 3] = -(R @ T[..., :3, 3, None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


@dataclasses.dataclass
class Layout:
    """Everything a frame's render and its ground truth need."""

    width: int
    height: int
    K: np.ndarray            # (3, 3) float64 intrinsics
    patches: list            # static (origin, eu, ev) in the world, label 0
    obj_patches: list        # (origin, eu, ev) in each object's frame
    T_wc: np.ndarray         # (F, 4, 4) float64 camera -> world
    L: np.ndarray            # (F, K, 4, 4) float64 object poses in the world
    H: np.ndarray            # (F, K, 4, 4) float64 world motion f-1 -> f
    tex_phase: np.ndarray    # (n_patches,) static patches, then objects
    tex_fu: np.ndarray
    tex_fv: np.ndarray
    view_range: float

    @property
    def num_frames(self) -> int:
        return self.T_wc.shape[0]

    @property
    def num_objects(self) -> int:
        return self.L.shape[1]


def make_layout(num_frames: int, width: int, height: int, num_objects: int,
                fx: float, fy: float, seed: int, cam_speed: float = 0.25,
                obj_speed: float = 0.5, cam_yaw_rate: float = 0.004,
                obj_spacing: float = 6.0, road_extra: float = 0.0,
                motion: str = "constant", follow: dict | None = None,
                view_range: float = 150.0) -> Layout:
    """The world and its trajectories, drawn as make_scene draws them.

    motion "constant": make_scene's constant body-frame step per object.
    motion "follow": object k's step at frame f is a yaw of
    A_k (sin(2 pi f / P_k) - sin(2 pi (f - 1) / P_k)) and a forward move of
    cam_speed (1 + B_k sin(2 pi f / Q_k + phi_k)), so its heading is
    A_k sin(2 pi f / P_k) about the road's axis and its distance ahead of
    the camera weaves by at most cam_speed B_k Q_k / pi; A, P, B, Q and phi
    are drawn from their ranges in `follow` by a second generator,
    default_rng([seed, 1]), so the first draws make_scene's stream."""
    rng = np.random.default_rng(seed)
    cx, cy = width / 2.0, height / 2.0
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64)
    z_len = 120.0 + road_extra
    patches = [
        (np.array([-40.0, 2.0, -5.0]), np.array([80.0, 0.0, 0.0]),
         np.array([0.0, 0.0, z_len])),
        (np.array([-12.0, 2.0, -5.0]), np.array([0.0, -10.0, 0.0]),
         np.array([0.0, 0.0, z_len])),
        (np.array([12.0, 2.0, -5.0]), np.array([0.0, -10.0, 0.0]),
         np.array([0.0, 0.0, z_len])),
        (np.array([-40.0, 2.0, 110.0 + road_extra]),
         np.array([80.0, 0.0, 0.0]), np.array([0.0, -30.0, 0.0])),
    ]
    n_facades = 14 + int(round(road_extra * 13.0 / 89.0))
    for j, z in enumerate(np.linspace(6.0, 95.0 + road_extra, n_facades)):
        side = -1.0 if j % 2 == 0 else 1.0
        x0 = side * rng.uniform(5.0, 9.0)
        w_, h_ = rng.uniform(3.0, 5.0), rng.uniform(3.0, 6.0)
        patches.append((np.array([x0 - w_ / 2, 1.8, z]),
                        np.array([w_, 0.0, 0.0]), np.array([0.0, -h_, 0.0])))

    obj_patches, obj_T0, obj_vel = [], [], []
    for k in range(num_objects):
        side = -1.0 if k % 2 == 0 else 1.0
        x0 = side * rng.uniform(1.8, 3.2)
        z0 = rng.uniform(10.0, 14.0) + obj_spacing * k
        w_, h_ = rng.uniform(2.2, 3.0), rng.uniform(1.5, 2.0)
        obj_patches.append((np.array([-w_ / 2, h_ / 2, 0.0]),
                            np.array([w_, 0.0, 0.0]),
                            np.array([0.0, -h_, 0.0])))
        obj_T0.append(pose([0.0, 0.0, 0.0], [x0, 0.9, z0]))
        fwd = obj_speed * rng.uniform(0.7, 1.3)
        yaw = rng.uniform(-0.01, 0.01)
        vx = rng.uniform(-0.02, 0.02)
        obj_vel.append((np.array([0.0, yaw, 0.0]), np.array([vx, 0.0, fwd])))

    F = num_frames
    T_wc = np.zeros((F, 4, 4))
    for f in range(F):
        yaw = cam_yaw_rate * f + 0.05 * np.sin(0.05 * f)
        T_wc[f] = pose([0.0, yaw, 0.0],
                       [0.3 * np.sin(0.08 * f), 0.0, cam_speed * f])

    L = np.zeros((F, num_objects, 4, 4))
    H = np.tile(np.eye(4), (F, num_objects, 1, 1))
    if motion == "follow":
        fo = follow or {}
        rng2 = np.random.default_rng([seed, 1])
    elif motion != "constant":
        raise ValueError(f"unknown motion model {motion!r}")
    for k in range(num_objects):
        L[0, k] = obj_T0[k]
        if motion == "constant":
            steps = [pose(*obj_vel[k])] * F
        else:
            A = rng2.uniform(*fo["heading_amp_rad"])
            P = rng2.uniform(*fo["heading_period_frames"])
            B = rng2.uniform(*fo["speed_amp"])
            Q = rng2.uniform(*fo["speed_period_frames"])
            phi = rng2.uniform(0.0, 2 * math.pi)
            steps = [None] + [
                pose([0.0, A * (np.sin(2 * np.pi * f / P)
                                - np.sin(2 * np.pi * (f - 1) / P)), 0.0],
                     [0.0, 0.0, cam_speed
                      * (1.0 + B * np.sin(2 * np.pi * f / Q + phi))])
                for f in range(1, F)]
        for f in range(1, F):
            L[f, k] = L[f - 1, k] @ steps[f]
            H[f, k] = L[f, k] @ inv(L[f - 1, k])

    n_patches = len(patches) + num_objects
    tex_phase = rng.uniform(0, 6.0, size=n_patches)
    cells_per_m = rng.uniform(0.9, 1.4, size=n_patches)
    sizes = [(np.linalg.norm(p[1]), np.linalg.norm(p[2]))
             for p in patches + obj_patches]
    tex_fu = np.array([max(s[0] * c, 2.0) for s, c in zip(sizes, cells_per_m)])
    tex_fv = np.array([max(s[1] * c, 2.0) for s, c in zip(sizes, cells_per_m)])
    return Layout(width, height, K, patches, obj_patches, T_wc, L, H,
                  tex_phase, tex_fu, tex_fv, float(view_range))


def _frame_patches(lay: Layout, f: int):
    """(index, origin, eu, ev, label) of the planes frame f's render
    tests, in make_scene's order (static, then objects)."""
    Twc = lay.T_wc[f]
    Tcw = inv(Twc)
    out = []
    n_static = len(lay.patches)
    every = [(o, u, v, 0) for o, u, v in lay.patches]
    for k, (o, u, v) in enumerate(lay.obj_patches):
        T = lay.L[f, k]
        every.append((T[:3, :3] @ o + T[:3, 3], T[:3, :3] @ u,
                      T[:3, :3] @ v, k + 1))
    for i, (o, u, v, lab) in enumerate(every):
        corners = np.stack([o, o + u, o + v, o + u + v])
        zc = corners @ Tcw[2, :3] + Tcw[2, 3]
        if zc.max() <= 0.1:
            continue            # wholly behind the camera: never hit
        if i < n_static and zc.min() > lay.view_range:
            continue            # beyond the view distance
        out.append((i, o, u, v, lab))
    return out


class Renderer:
    """Frames of a layout on one device, as float32 / int32 tensors."""

    def __init__(self, lay: Layout, device):
        self.lay = lay
        self.device = torch.device(device)
        H, W = lay.height, lay.width
        K = lay.K
        d64 = dict(dtype=torch.float64, device=self.device)
        ys, xs = torch.meshgrid(torch.arange(H, **d64),
                                torch.arange(W, **d64), indexing="ij")
        self.xs, self.ys = xs, ys
        self.rays = torch.stack([(xs - K[0, 2]) / K[0, 0],
                                 (ys - K[1, 2]) / K[1, 1],
                                 torch.ones_like(xs)], dim=-1)
        self.phase = torch.tensor(lay.tex_phase, **d64)
        self.fu = torch.tensor(lay.tex_fu, **d64)
        self.fv = torch.tensor(lay.tex_fv, **d64)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64),
                               device=self.device)

    def _raycast(self, f: int):
        lay = self.lay
        Twc = lay.T_wc[f]
        Tcw = inv(Twc)
        sel = _frame_patches(lay, f)
        idx = torch.tensor([s[0] for s in sel], device=self.device)
        o = self._t([s[1] for s in sel])               # (P, 3)
        u = self._t([s[2] for s in sel])
        v = self._t([s[3] for s in sel])
        lab = torch.tensor([s[4] for s in sel], dtype=torch.int32,
                           device=self.device)
        n = torch.linalg.cross(u, v)
        c = self._t(Twc[:3, 3])
        rays_w = self.rays @ self._t(Twc[:3, :3]).T     # (H, W, 3)
        denom = torch.einsum("hwc,pc->phw", rays_w, n)
        num = ((o - c) * n).sum(-1)[:, None, None]
        par = denom.abs() < 1e-12
        s = torch.where(par, -1.0, num / torch.where(par, 1.0, denom))
        X = c + s[..., None] * rays_w                   # (P, H, W, 3)
        rel = X - o[:, None, None, :]
        pa = (rel * u[:, None, None, :]).sum(-1)
        pb = (rel * v[:, None, None, :]).sum(-1)
        uu, uv, vv = (u * u).sum(-1), (u * v).sum(-1), (v * v).sum(-1)
        det = uu * vv - uv * uv
        g00, g01, g11 = vv / det, -uv / det, uu / det
        a = g00[:, None, None] * pa + g01[:, None, None] * pb
        b = g01[:, None, None] * pa + g11[:, None, None] * pb
        zc = X @ self._t(Tcw[2, :3]) + float(Tcw[2, 3])
        hit = (s > 0.1) & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1) \
            & (zc > 0.1)
        zm = torch.where(hit, zc, math.inf)
        zbuf, win = zm.min(dim=0)                        # first of ties
        g = win[None]
        aa = a.gather(0, g)[0]
        bb = b.gather(0, g)[0]
        valid = torch.isfinite(zbuf)
        return zbuf, lab[win], idx[win], aa, bb, valid

    def frame(self, f: int) -> dict:
        """Frame f: gray (H, W) in [0, 1], metric depth (0 = none), the
        instance mask and the forward flow to frame f + 1 (zeros on the
        last frame), as make_scene computes them."""
        lay = self.lay
        zbuf, lab, pidx, aa, bb, valid = self._raycast(f)
        depth = torch.where(valid, zbuf, 0.0).to(torch.float32)
        mask = torch.where(valid, lab, 0)
        ca = torch.floor(aa * self.fu[pidx] + self.phase[pidx])
        cb = torch.floor(bb * self.fv[pidx] + 0.7 * self.phase[pidx])
        base = torch.remainder(ca + cb, 2.0)
        gray = torch.where(valid, 0.2 + 0.6 * base, 0.0).to(torch.float32)
        flow = torch.zeros(lay.height, lay.width, 2, dtype=torch.float32,
                           device=self.device)
        if f + 1 < lay.num_frames:
            Twc = lay.T_wc[f]
            z = torch.where(valid, zbuf, 0.0)
            Xc = self.rays * z[..., None]
            Xw = Xc @ self._t(Twc[:3, :3]).T + self._t(Twc[:3, 3])
            Xn = Xw
            for k in range(lay.num_objects):
                Hk = lay.H[f + 1, k]
                moved = Xw @ self._t(Hk[:3, :3]).T + self._t(Hk[:3, 3])
                Xn = torch.where((mask == k + 1)[..., None], moved, Xn)
            Tn = inv(lay.T_wc[f + 1])
            X2 = Xn @ self._t(Tn[:3, :3]).T + self._t(Tn[:3, 3])
            z2ok = X2[..., 2] > 0.1
            z2 = torch.where(z2ok, X2[..., 2], 1.0)
            u2 = lay.K[0, 0] * (X2[..., 0] / z2) + lay.K[0, 2]
            v2 = lay.K[1, 1] * (X2[..., 1] / z2) + lay.K[1, 2]
            ok = valid & z2ok
            fu = torch.where(ok, u2 - self.xs, 0.0)
            fv = torch.where(ok, v2 - self.ys, 0.0)
            zero = (fu == 0.0) & (fv == 0.0)
            fu = torch.where(zero, 1e-4, fu)
            flow = torch.stack([fu, fv], dim=-1).to(torch.float32)
        return {"gray": gray, "depth": depth, "mask": mask, "flow": flow}


def depth_raw(depth: torch.Tensor, depth_map_factor: float,
              bf: float) -> torch.Tensor:
    """The raw depth samples a dataset reader hands the tracker, which
    inverts them as bf / (raw / factor): factor * bf / depth where depth
    > 0, in float32 (the port's SyntheticDataset)."""
    num = torch.full_like(depth, depth_map_factor * bf)
    return torch.where(depth > 0,
                       num.div(torch.clamp(depth, min=1e-6)),
                       0.0).to(torch.float32)


def obj_rows_kitti(lay: Layout, f: int) -> np.ndarray:
    """Frame f's object rows in KITTI's object_pose.txt encoding, the pose
    in frame f's camera (the port's SyntheticDataset)."""
    T_wc = lay.T_wc[f].astype(np.float32).astype(np.float64)
    T_cw = np.eye(4)
    T_cw[:3, :3] = T_wc[:3, :3].T
    T_cw[:3, 3] = -T_wc[:3, :3].T @ T_wc[:3, 3]
    rows = []
    for k in range(lay.num_objects):
        L_c = T_cw @ lay.L[f, k].astype(np.float32).astype(np.float64)
        yaw = np.arctan2(L_c[0, 2], L_c[2, 2]) - np.pi / 2.0
        rows.append([f, float(k + 1), 0, 0, 10, 10,
                     L_c[0, 3], L_c[1, 3], L_c[2, 3], yaw])
    return np.asarray(rows, dtype=np.float32).reshape(-1, 10)


def timestamp(f: int) -> float:
    return 0.1 * f if f > 0 else 1e-3
