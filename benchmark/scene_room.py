"""The benchmark's indoor world: a room and four boxes that swing on strings
and twist about them, seen by a hand-held camera, as in the Oxford
Multimotion Dataset's swinging_4_unconstrained; rendered on the device from
a seed, with its exact ground truth.

- the room: floor, ceiling and four walls, textured planes (label 0);
- box k (label k + 1): a cuboid of six textured faces whose centre hangs
  l_k below a pivot.  Its pose is

      L_k(f) = T(pivot_k) R(a_k, theta_k(f)) R(y, psi_k(f) + yaw_k) T(0, l_k)

  (T(0, l_k) the drop of l_k along y), with the swing theta_k(f) = A_k
  sin(2 pi f / P_k + phi_k) about the horizontal axis a_k through the
  pivot, and the twist psi_k(f) = B_k sin(2 pi f / Q_k + chi_k) about the
  string;
- the camera sways about its rest pose in all six degrees of freedom, each
  a sine of its own amplitude, period and phase.

The world frame is the camera's at rest: x right, y down, z forward.  Every
amplitude, period, size and place is drawn from the configuration file's
"scene" ranges by numpy.random.default_rng(seed).  The render is
benchmark/scene.py's: every box face is one of its planes, moved with its
box, and the renderer ray-casts every pixel in float64 on the device; the
face labels are folded to their box's afterwards.  Ground truth is exact:
the camera poses, each box's pose in the world and its motion from frame
to frame, and each frame's object rows in the Oxford Multimotion encoding
that the port's ObjPoseParsingOX reads ([frame, label, t(3), axis-angle(3),
0, 0], the pose in the raw world frame).

Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import scene as S

FACES_PER_BOX = 6


def box_faces(half: np.ndarray) -> list:
    """The six faces (origin, eu, ev) of a box of half sizes `half` about
    its centre, in its body frame, eu x ev pointing out of the box."""
    hx, hy, hz = (float(h) for h in half)
    X, Y, Z = (np.array([2 * hx, 0.0, 0.0]), np.array([0.0, 2 * hy, 0.0]),
               np.array([0.0, 0.0, 2 * hz]))
    lo = np.array([-hx, -hy, -hz])
    return [(np.array([hx, -hy, -hz]), Y, Z), (lo, Z, Y),
            (np.array([-hx, hy, -hz]), Z, X), (lo, X, Z),
            (np.array([-hx, -hy, hz]), X, Y), (lo, Y, X)]


def judged_plane(half: np.ndarray) -> tuple:
    """The plane whose four corners the reference reads (reference.py:
    corners): the box's diagonal section through its centre, whose
    corners are four of its vertices, (-x, -y, -z), (x, -y, -z),
    (-x, y, z), (x, y, z).  No axis through the centre holds all four, so
    a wrong rotation about any axis moves a corner."""
    hx, hy, hz = (float(h) for h in half)
    return (np.array([-hx, -hy, -hz]), np.array([2 * hx, 0.0, 0.0]),
            np.array([0.0, 2 * hy, 2 * hz]))


def _axis_angle(R: np.ndarray) -> np.ndarray:
    """The rotation vector of a rotation matrix, through its unit
    quaternion (stable at every angle)."""
    t = np.trace(R)
    q = np.empty(4)                    # (w, x, y, z)
    if t > 0:
        s = 2.0 * math.sqrt(1.0 + t)
        q[:] = (0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                (R[1, 0] - R[0, 1]) / s)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * math.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    if q[0] < 0:
        q = -q
    v = q[1:]
    n = np.linalg.norm(v)
    if n < 1e-15:
        return np.zeros(3)
    return v / n * 2.0 * math.atan2(n, q[0])


@dataclasses.dataclass
class RoomLayout:
    """Everything a frame's render and its ground truth need.  T_wc, L and
    obj_patches are what the reference judges (reference.py)."""

    width: int
    height: int
    K: np.ndarray            # (3, 3) float64 intrinsics
    patches: list            # the room's planes (origin, eu, ev), label 0
    half: np.ndarray         # (n_boxes, 3) each box's half sizes
    obj_patches: list        # each box's judged plane, in its body frame
    T_wc: np.ndarray         # (F, 4, 4) float64 camera -> world
    L: np.ndarray            # (F, n_boxes, 4, 4) box poses in the world
    H: np.ndarray            # (F, n_boxes, 4, 4) world motion f-1 -> f
    tex_phase: np.ndarray    # (n_patches,) room planes, then box faces
    tex_fu: np.ndarray
    tex_fv: np.ndarray
    fps: float
    params: dict             # the drawn swing, twist and sway, per box

    @property
    def num_frames(self) -> int:
        return self.T_wc.shape[0]

    @property
    def num_objects(self) -> int:
        return self.L.shape[1]

    def faces_layout(self) -> S.Layout:
        """The world as benchmark/scene.py's Layout, each box face one of
        its object planes: face 6 k + j carries box k's poses and motions,
        and its label 6 k + j + 1 folds to k + 1 (`fold_labels`)."""
        faces = [f for h in self.half for f in box_faces(h)]
        rep = np.repeat(np.arange(self.num_objects), FACES_PER_BOX)
        return S.Layout(self.width, self.height, self.K, self.patches, faces,
                        self.T_wc, self.L[:, rep], self.H[:, rep],
                        self.tex_phase, self.tex_fu, self.tex_fv,
                        view_range=1e3)

    def max_rotation_deg(self) -> float:
        """The largest rotation of any box from one frame to the next."""
        R = self.H[1:, :, :3, :3]
        c = np.clip(0.5 * (np.trace(R, axis1=-2, axis2=-1) - 1.0), -1, 1)
        return float(np.degrees(np.arccos(c)).max()) if R.size else 0.0

    def min_depth(self) -> float:
        """The nearest any box corner comes to the camera's image plane
        over the sequence (the room lies farther)."""
        out = math.inf
        for k in range(self.num_objects):
            h = self.half[k]
            corners = np.array([[sx * h[0], sy * h[1], sz * h[2], 1.0]
                                for sx in (-1, 1) for sy in (-1, 1)
                                for sz in (-1, 1)]).T      # (4, 8)
            cam = S.inv(self.T_wc) @ self.L[:, k] @ corners
            out = min(out, float(cam[:, 2].min()))
        return out


def make_layout(num_frames: int, width: int, height: int, fx: float,
                fy: float, cx: float, cy: float, fps: float, seed: int,
                room: dict, boxes: list, centre_jitter_m: float,
                box_edge_m: list, string_m: list, base_yaw_deg: list,
                swing_amp_deg: list, swing_period_frames: list,
                twist_amp_deg: list, twist_period_frames: list,
                cam_sway_m: list, cam_sway_deg: list,
                cam_sway_period_frames: list, **_) -> RoomLayout:
    """The room, its boxes and the camera path, drawn from the seed; the
    keyword arguments are the configuration file's "scene" section (a
    range is [low, high], drawn uniformly)."""
    rng = np.random.default_rng(seed)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64)
    (x0, x1), (y0, y1), (z0, z1) = room["x"], room["y"], room["z"]
    dx, dy, dz = (np.array([x1 - x0, 0.0, 0.0]), np.array([0.0, y1 - y0, 0.0]),
                  np.array([0.0, 0.0, z1 - z0]))
    patches = [(np.array([x0, y1, z0]), dx, dz),      # floor
               (np.array([x0, y0, z0]), dx, dz),      # ceiling
               (np.array([x0, y0, z0]), dy, dz),      # left wall
               (np.array([x1, y0, z0]), dy, dz),      # right wall
               (np.array([x0, y0, z1]), dx, dy),      # far wall
               (np.array([x0, y0, z0]), dx, dy)]      # wall behind

    def draw(r, size=None):
        return rng.uniform(float(r[0]), float(r[1]), size)

    n = len(boxes)
    F = num_frames
    f = np.arange(F, dtype=np.float64)
    half, judged, L, params = [], [], np.zeros((F, n, 4, 4)), []
    for k, rest in enumerate(boxes):
        h = 0.5 * draw(box_edge_m, 3)
        centre = np.asarray(rest, np.float64) + draw(
            [-centre_jitter_m, centre_jitter_m], 3)
        ell = draw(string_m)
        pivot = centre - np.array([0.0, ell, 0.0])
        alpha = draw([0.0, math.pi])
        axis = np.array([math.cos(alpha), 0.0, math.sin(alpha)])
        yaw = math.radians(draw(base_yaw_deg))
        A, P = math.radians(draw(swing_amp_deg)), draw(swing_period_frames)
        B, Q = math.radians(draw(twist_amp_deg)), draw(twist_period_frames)
        phi, chi = draw([0.0, 2 * math.pi]), draw([0.0, 2 * math.pi])
        theta = A * np.sin(2 * math.pi * f / P + phi)
        psi = B * np.sin(2 * math.pi * f / Q + chi) + yaw
        hang = S.pose([0.0, 0.0, 0.0], [0.0, ell, 0.0])
        for i in range(F):
            L[i, k] = (S.pose(axis * theta[i], pivot)
                       @ S.pose([0.0, psi[i], 0.0], [0.0, 0.0, 0.0]) @ hang)
        half.append(h)
        judged.append(judged_plane(h))
        params.append({"half_m": h.tolist(), "string_m": float(ell),
                       "swing_axis": axis.tolist(),
                       "swing_amp_deg": math.degrees(A),
                       "swing_period_frames": float(P),
                       "twist_amp_deg": math.degrees(B),
                       "twist_period_frames": float(Q)})
    H = np.tile(np.eye(4), (F, n, 1, 1))
    H[1:] = L[1:] @ S.inv(L[:-1])

    sway_t, sway_r = draw(cam_sway_m, 3), np.radians(draw(cam_sway_deg, 3))
    per = draw(cam_sway_period_frames, 6)
    ph = draw([0.0, 2 * math.pi], 6)
    wave = np.sin(2 * math.pi * f[:, None] / per[None, :] + ph[None, :])
    T_wc = np.stack([S.pose(sway_r * wave[i, 3:], sway_t * wave[i, :3])
                     for i in range(F)])

    n_planes = len(patches) + FACES_PER_BOX * n
    sizes = [(np.linalg.norm(p[1]), np.linalg.norm(p[2])) for p in patches]
    sizes += [(np.linalg.norm(u), np.linalg.norm(v))
              for h in half for _, u, v in box_faces(h)]
    tex_phase = rng.uniform(0, 6.0, size=n_planes)
    cells_per_m = rng.uniform(3.0, 5.0, size=n_planes)
    tex_fu = np.array([max(s[0] * c, 2.0) for s, c in zip(sizes, cells_per_m)])
    tex_fv = np.array([max(s[1] * c, 2.0) for s, c in zip(sizes, cells_per_m)])
    return RoomLayout(width, height, K, patches, np.asarray(half), judged,
                      T_wc, L, H, tex_phase, tex_fu, tex_fv, float(fps),
                      {"boxes": params, "cam_sway_m": sway_t.tolist(),
                       "cam_sway_deg": np.degrees(sway_r).tolist()})


def fold_labels(mask: torch.Tensor) -> torch.Tensor:
    """Face labels (6 k + j + 1) -> box labels (k + 1); 0 stays 0."""
    return torch.where(mask > 0, (mask - 1) // FACES_PER_BOX + 1, 0)


class Renderer:
    """Frames of a room on one device: scene.Renderer over the faces
    layout, the mask folded to boxes."""

    def __init__(self, lay: RoomLayout, device):
        self.lay = lay
        self._faces = S.Renderer(lay.faces_layout(), device)

    def frame(self, f: int) -> dict:
        """Frame f: gray (H, W) in [0, 1], metric depth (0 = none), the
        box mask and the forward flow to frame f + 1 (zeros on the last
        frame)."""
        out = self._faces.frame(f)
        out["mask"] = fold_labels(out["mask"])
        return out


def obj_rows_ox(lay: RoomLayout, f: int) -> np.ndarray:
    """Frame f's object rows in the Oxford Multimotion encoding
    (ObjPoseParsingOX): [frame, label, t(3), axis-angle(3), 0, 0], each
    box's pose in the raw world frame, float32."""
    rows = []
    for k in range(lay.num_objects):
        P = lay.L[f, k]
        rows.append([f, float(k + 1), *P[:3, 3], *_axis_angle(P[:3, :3]),
                     0.0, 0.0])
    return np.asarray(rows, dtype=np.float32).reshape(-1, 10)


def timestamp(lay: RoomLayout, f: int) -> float:
    return f / lay.fps if f > 0 else 1e-3
