"""A plain reference for the end-of-sequence full-batch refine: the factor
set of FullBatchOptimization (Optimizer.cc:1232-2175) built from a map
archive's arrays, its objective evaluated in float64, and a small dense
Levenberg-Marquardt with an exact solve.

It imports torch and numpy only, nothing of the program: the archive is
read through the attributes of the port's MapState (stat_*, dyn_*,
cam_pose, rigid_motion, rm_label, ...), and the settings are plain
numbers (`settings`).  A copy of this file, byte for byte, is the
benchmark's (benchmark/full_batch_reference.py).

The factor set, in the reference's terms:
  * the camera chain: one pose vertex per frame, an odometry edge between
    frames f - 1 and f whose measurement is the tracked camera motion,
    information 1/sigma2_cam (Optimizer.cc:1355-1418), and a prior on the
    first pose at its estimate, information prior_information
    (Optimizer.cc:1339-1348);
  * static points: a tracklet of static features (Tracking.cc:2201-2304,
    GetStaticTrack) with at least track_len observations
    (FeaLengthThresSta, Optimizer.cc:74) is one point vertex, started at
    its first observation's 3D point, with a camera-observation edge per
    observation (the feature's back-projection in its camera),
    information 1/sigma2_3d_sta (Optimizer.cc:1420-1535);
  * motions: one vertex per object and frame pair (Optimizer.cc:
    1575-1582), and a smoothness edge between the vertices of one object
    label on consecutive frame pairs, measurement identity, information
    1/sigma2_obj_smo (Optimizer.cc:1593-1623); an altitude edge on each
    motion's y translation where altitude is on (Optimizer.cc:1584-1591);
  * dynamic points: each observation of a dynamic tracklet
    (Tracking.cc:2306-2421, GetDynamicTrackNew) of at least track_len
    observations and a label above 0 (FeaLengthThresDyn, Optimizer.cc:85)
    is a NEW point vertex (never merged, Optimizer.cc:1672-1746) with a
    camera-observation edge, information 1/sigma2_3d_dyn; an observation
    after the tracklet's first whose frame pair has no motion vertex for
    the tracklet's label is left out (Optimizer.cc:1786-1789); a ternary
    edge X_prev - H^-1 X_cur ties each kept observation to the kept one
    of the previous frame through that motion vertex, information
    1/sigma2_obj (types_dyn_slam3d.cpp:53-61, Optimizer.cc:1748-1830);
  * a Huber kernel on every edge (deltaHuber*, Optimizer.cc:1352).

Where the program departs from the reference, so does this objective,
since it checks the program's numbers:
  * motions start from the tracked estimates (the archive's
    rigid_motion), not from identity (Optimizer.cc:1575-1582);
  * the odometry, prior and smoothness residuals are the SE(3) log of the
    relative error, not g2o's EdgeSE3 quaternion-and-translation error;
  * the Huber delta of the odometry and smoothness edges is
    max(huber_delta, pose_huber_delta) (float32 rounding of an exact
    chain edge sits above huber_delta), and the kernel is applied to the
    prior too;
  * the solve is the repo's fixed budget (full_iters LM iterations of
    cg_iters PCG steps), not g2o's up to 300 exact-Cholesky iterations.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# float64 throughout; no TF32 in any product this file runs on a card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EDGES = ("obs", "odo", "pri", "smo", "ter", "alt")


@dataclasses.dataclass(frozen=True)
class Settings:
    fx: float
    fy: float
    cx: float
    cy: float
    sigma2_cam: float
    sigma2_3d_sta: float
    sigma2_3d_dyn: float
    sigma2_obj: float
    sigma2_obj_smo: float
    sigma2_alti: float
    prior_information: float
    huber_delta: float
    pose_huber_delta: float
    robust: bool
    track_len: int
    smooth: bool
    altitude: bool


def settings(backend: dict, camera: dict) -> Settings:
    """The numbers the objective needs, from a configuration's "backend"
    and "camera" sections as plain dicts."""
    b = backend
    return Settings(
        fx=float(camera["fx"]), fy=float(camera["fy"]),
        cx=float(camera["cx"]), cy=float(camera["cy"]),
        sigma2_cam=float(b["full_sigma2_cam"]),
        sigma2_3d_sta=float(b["full_sigma2_3d_sta"]),
        sigma2_3d_dyn=float(b["full_sigma2_3d_dyn"]),
        sigma2_obj=float(b["full_sigma2_obj"]),
        sigma2_obj_smo=float(b["full_sigma2_obj_smo"]),
        sigma2_alti=float(b["full_sigma2_alti"]),
        prior_information=float(b["prior_information"]),
        huber_delta=float(b["huber_delta"]),
        pose_huber_delta=float(b["pose_huber_delta"]),
        robust=bool(b["robust_kernel"]),
        track_len=int(b["track_len_thres"]),
        smooth=bool(b["smooth_constraint"]),
        altitude=bool(b["altitude_constraint"]))


@dataclasses.dataclass
class Problem:
    """The factor set of one archive.  Edge indices are int64 arrays into
    the variables; the initial variables are float64; `*_at` say where in
    the archive each vertex's value is read back after a refine."""

    s: Settings
    obs_pose: np.ndarray
    obs_point: np.ndarray
    obs_meas: np.ndarray      # (E, 3) the observation in its camera
    obs_w: np.ndarray         # (E,) information
    odo_a: np.ndarray
    odo_b: np.ndarray
    odo_meas: np.ndarray      # (Eo, 4, 4) camera motion a -> b
    pri_meas: np.ndarray      # (4, 4) the first pose's estimate
    smo_a: np.ndarray
    smo_b: np.ndarray
    ter_prev: np.ndarray
    ter_cur: np.ndarray
    ter_mot: np.ndarray
    alt_mot: np.ndarray
    poses0: np.ndarray        # (F, 4, 4)
    motions0: np.ndarray      # (M, 4, 4)
    points0: np.ndarray       # (P, 3): static points, then dynamic
    n_static: int
    stat_at: np.ndarray       # (n_static, 2) (frame, feature) of each
    dyn_at: np.ndarray        # (P - n_static, 2)
    motion_at: np.ndarray     # (M, 2) (frame pair, slot)

    def counts(self) -> dict:
        """Edges of each type and vertices, as the program's graph meta
        counts them (obs, ternary, smooth, points, motions)."""
        return {"obs": int(self.obs_pose.size),
                "ternary": int(self.ter_prev.size),
                "smooth": int(self.smo_a.size),
                "points": int(self.points0.shape[0]),
                "motions": int(self.motions0.shape[0]),
                "odo": int(self.odo_a.size), "pri": 1,
                "alt": int(self.alt_mot.size)}


# --------------------------------------------------------------------------
# tracklets
# --------------------------------------------------------------------------

def tracklets(assoc: list, valid: list) -> tuple:
    """The tracklets of one feature kind (GetStaticTrack,
    Tracking.cc:2201-2304; GetDynamicTrackNew, 2306-2421): a feature j of
    frame f >= 1 with a match a = assoc[f - 1][j] >= 0 (and valid) either
    continues the tracklet that feature a of frame f - 1 belongs to, if a
    had a match itself, or starts a new tracklet [(f - 1, a), (f, j)].

    Returns (track, frame, feat, root): one row per observation, sorted by
    (track, frame, feature), and per track the (frame, feature) of its
    second observation, which belongs to that track alone (its first, the
    unmatched anchor, may anchor several)."""
    F = len(assoc) + 1
    tracks, frames, feats = [], [], []
    roots = []
    prev_id = None            # track id of each feature of frame f - 1
    n = 0
    for f in range(1, F):
        a = np.asarray(assoc[f - 1]).astype(np.int64)
        ok = (a >= 0) & np.asarray(valid[f]).astype(bool)
        cur = np.full(a.shape, -1, np.int64)
        j = np.nonzero(ok)[0]
        up = (prev_id[a[j]] if prev_id is not None
              else np.full(j.size, -1, np.int64))
        cont = up >= 0
        cur[j[cont]] = up[cont]
        fresh = j[~cont]
        ids = n + np.arange(fresh.size)
        cur[fresh] = ids
        n += fresh.size
        roots.append(np.stack([np.full(fresh.size, f), fresh], 1))
        # the new tracks' anchors, then every matched feature of frame f
        tracks += [ids, cur[j]]
        frames += [np.full(fresh.size, f - 1), np.full(j.size, f)]
        feats += [a[fresh], j]
        prev_id = cur
    if not tracks:
        z = np.zeros(0, np.int64)
        return z, z, z, np.zeros((0, 2), np.int64)
    t, fr, fe = (np.concatenate(x).astype(np.int64)
                 for x in (tracks, frames, feats))
    order = np.lexsort((fe, fr, t))
    return t[order], fr[order], fe[order], np.concatenate(roots)


def _back_project(xy, depth, s: Settings) -> np.ndarray:
    xy = np.asarray(xy, np.float64)
    z = np.asarray(depth, np.float64)
    return np.stack([(xy[:, 0] - s.cx) * z / s.fx,
                     (xy[:, 1] - s.cy) * z / s.fy, z], 1)


def build(m, s: Settings) -> Problem:
    """The factor set of the archive `m` (FullBatchOptimization,
    Optimizer.cc:1232-1935), with its initial values."""
    N = len(m.cam_pose)
    f64 = np.float64
    poses0 = np.stack([np.asarray(p, f64) for p in m.cam_pose])
    # camera chain: EdgeSE3 between consecutive poses, measured by the
    # tracked camera motion (Optimizer.cc:1355-1418)
    odo_a = np.arange(N - 1, dtype=np.int64)
    odo_meas = (np.stack([np.asarray(m.rigid_motion[f][0], f64)
                          for f in range(N - 1)])
                if N > 1 else np.zeros((0, 4, 4)))

    # static tracklets of length >= track_len (Optimizer.cc:74, 1420-1535)
    t, fr, fe, s_root = tracklets(m.stat_assoc, m.stat_valid)
    length = np.bincount(t, minlength=s_root.shape[0])
    long_ = length >= s.track_len
    keep = long_[t]
    point_of = np.cumsum(long_) - 1
    t, fr, fe = t[keep], fr[keep], fe[keep]
    stat_xy = np.stack(m.stat_xy)
    stat_depth = np.stack(m.stat_depth)
    stat_3d = np.stack(m.stat_3d)
    first = np.r_[True, t[1:] != t[:-1]] if t.size else np.zeros(0, bool)
    n_static = int(long_.sum())
    stat_points = stat_3d[fr[first], fe[first]].astype(f64)
    obs = [(fr, point_of[t], _back_project(stat_xy[fr, fe],
                                           stat_depth[fr, fe], s),
            np.full(t.size, 1.0 / s.sigma2_3d_sta))]

    # motion vertices per (frame pair, object slot), the tracked estimate
    # as start (the port's departure), smoothness to the same label's
    # vertex on the frame pair before (Optimizer.cc:1575-1623)
    motion_at, motions0, smo_a, smo_b = [], [], [], []
    vertex = {}                 # (frame pair, label) -> vertex
    for fp in range(len(m.rigid_motion)):
        labels = m.rm_label[fp]
        for j in range(1, len(labels)):
            k = len(motion_at)
            if s.smooth and fp > 0 and (fp - 1, labels[j]) in vertex:
                smo_a.append(vertex[fp - 1, labels[j]])
                smo_b.append(k)
            vertex[fp, labels[j]] = k
            motion_at.append((fp, j))
            motions0.append(np.asarray(m.rigid_motion[fp][j], f64))
    M = len(motion_at)

    # dynamic tracklets of length >= track_len whose first matched
    # feature has a label above 0 (Optimizer.cc:85, 1672-1830)
    t, fr, fe, root = tracklets(m.dyn_assoc, m.dyn_valid)
    labels = np.stack(m.dyn_obj_label)
    track_label = (labels[root[:, 0], root[:, 1]].astype(np.int64)
                   if root.size else np.zeros(0, np.int64))
    length = np.bincount(t, minlength=root.shape[0])
    keep = ((length >= s.track_len) & (track_label > 0))[t]
    t, fr, fe = t[keep], fr[keep], fe[keep]
    lab = track_label[t]
    first = np.r_[True, t[1:] != t[:-1]] if t.size else np.zeros(0, bool)
    # the motion vertex of (frame pair f - 1, label) of every observation
    # after its tracklet's first, -1 where there is none
    top = max([l for _, l in vertex] + [int(lab.max()) if lab.size else 0])
    table = np.full((max(N - 1, 1), top + 1), -1, np.int64)
    for (fp, l), k in vertex.items():
        if l >= 0:
            table[fp, l] = k
    mot = np.where(first, -1, table[np.maximum(fr - 1, 0), lab])
    kept = first | (mot >= 0)
    t, fr, fe, mot, first = t[kept], fr[kept], fe[kept], mot[kept], \
        first[kept]
    dyn_id = n_static + np.arange(t.size)
    # a ternary edge where the previous kept observation of the same
    # tracklet lies on the frame before
    linked = np.zeros(t.size, bool)
    linked[1:] = (~first[1:]) & (t[1:] == t[:-1]) & (fr[1:] == fr[:-1] + 1)
    dyn_xy = np.stack(m.dyn_xy)
    dyn_depth = np.stack(m.dyn_depth)
    dyn_3d = np.stack(m.dyn_3d)
    obs.append((fr, dyn_id, _back_project(dyn_xy[fr, fe],
                                          dyn_depth[fr, fe], s),
                np.full(t.size, 1.0 / s.sigma2_3d_dyn)))
    idx = np.nonzero(linked)[0]

    cat = np.concatenate
    return Problem(
        s=s,
        obs_pose=cat([o[0] for o in obs]).astype(np.int64),
        obs_point=cat([o[1] for o in obs]).astype(np.int64),
        obs_meas=cat([o[2] for o in obs]).reshape(-1, 3),
        obs_w=cat([o[3] for o in obs]),
        odo_a=odo_a, odo_b=odo_a + 1, odo_meas=odo_meas,
        pri_meas=poses0[0].copy(),
        smo_a=np.asarray(smo_a, np.int64), smo_b=np.asarray(smo_b, np.int64),
        ter_prev=dyn_id[idx - 1], ter_cur=dyn_id[idx], ter_mot=mot[idx],
        alt_mot=(np.arange(M, dtype=np.int64) if s.altitude
                 else np.zeros(0, np.int64)),
        poses0=poses0,
        motions0=(np.stack(motions0) if M else np.zeros((0, 4, 4))),
        points0=cat([stat_points.reshape(-1, 3),
                     dyn_3d[fr, fe].astype(f64).reshape(-1, 3)]),
        n_static=n_static,
        stat_at=s_root[long_].reshape(-1, 2),
        dyn_at=np.stack([fr, fe], 1),
        motion_at=np.asarray(motion_at, np.int64).reshape(-1, 2))


def refined(problem: Problem, m) -> tuple:
    """(poses, motions, points) as a refine left them in the archive `m`:
    cam_pose_rf, rigid_motion_rf at each motion's slot, and each point
    read where it was observed (a static point at its tracklet's second
    observation, which no other tracklet shares)."""
    f64 = np.float64
    poses = np.stack([np.asarray(p, f64) for p in m.cam_pose_rf])
    motions = (np.stack([np.asarray(m.rigid_motion_rf[fp][j], f64)
                         for fp, j in problem.motion_at])
               if problem.motion_at.size else np.zeros((0, 4, 4)))
    stat_3d = np.stack(m.stat_3d)
    dyn_3d = np.stack(m.dyn_3d)
    sa, da = problem.stat_at, problem.dyn_at
    points = np.concatenate([stat_3d[sa[:, 0], sa[:, 1]].astype(f64),
                             dyn_3d[da[:, 0], da[:, 1]].astype(f64)])
    return poses, motions, points.reshape(-1, 3)


# --------------------------------------------------------------------------
# the objective in float64
# --------------------------------------------------------------------------

def _rows(R, t):
    """(..., 4, 4) from (..., 3, 3) and (..., 3, 1), with no write in
    place (torch.func differentiates through it)."""
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype,
                         device=R.device)
    bottom = bottom + torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                                   device=R.device)
    return torch.cat([torch.cat([R, t], -1), bottom], -2)


def _inv(T):
    R = T[..., :3, :3].transpose(-1, -2)
    return _rows(R, -(R @ T[..., :3, 3:]))


def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def se3_log(T):
    """(..., 4, 4) -> (..., 6) = (omega, upsilon): the rotation's axis
    times its angle and V(omega)^-1 t, in float64."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    sin2 = torch.linalg.norm(vee, dim=-1)            # 2 sin(theta)
    cos = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
    theta = torch.atan2(0.5 * sin2, cos)
    tiny = theta < 1e-6
    scale = torch.where(tiny, 0.5 + theta ** 2 / 12.0,
                        theta / torch.where(tiny, torch.ones_like(sin2),
                                            sin2))
    w = vee * scale[..., None]
    th2 = theta * theta
    # V^-1 = I - W/2 + (1 - theta sin / (2 (1 - cos))) / theta^2 W^2; its
    # Taylor form below 1e-2 rad, where the closed form cancels
    small = theta < 1e-2
    safe = torch.where(small, torch.ones_like(theta), theta)
    c = torch.where(small, 1.0 / 12.0 + th2 / 720.0,
                    (1.0 - safe * torch.sin(safe)
                     / (2.0 * (1.0 - torch.cos(safe)))) / (safe * safe))
    W = _hat(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    Vinv = eye - 0.5 * W + c[..., None, None] * (W @ W)
    return torch.cat([w, (Vinv @ t[..., None])[..., 0]], -1)


def se3_exp(xi):
    """(..., 6) = (omega, upsilon) -> (..., 4, 4), in float64."""
    w, u = xi[..., :3], xi[..., 3:]
    th2 = torch.sum(w * w, -1)
    # Taylor forms below 1e-3 rad, where the closed forms cancel
    small = th2 < 1e-6
    safe = torch.where(small, torch.ones_like(th2), torch.sqrt(th2))
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(safe) / safe)
    B = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(safe)) / (safe * safe))
    C = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (safe - torch.sin(safe)) / (safe ** 3))
    W = _hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    return _rows(R, V @ u[..., None])


def _apply(T, X):
    return (T[..., :3, :3] @ X[..., None])[..., 0] + T[..., :3, 3]


def _rho(chi2, delta: float, robust: bool):
    """The Huber kernel of information-weighted chi2 (g2o's
    RobustKernelHuber)."""
    if not robust:
        return chi2
    return torch.where(chi2 <= delta * delta, chi2,
                       2.0 * delta * torch.sqrt(chi2) - delta * delta)


def _delta(name: str, s: Settings) -> float:
    if name in ("odo", "smo"):
        return max(s.huber_delta, s.pose_huber_delta)
    return s.huber_delta


def _residuals(name: str, p: Problem, V: tuple, sl: slice, dev):
    """(residuals, information) of edges sl of type `name` at the
    variables V = (poses, motions, points), tensors on dev."""
    poses, motions, points = V

    def ix(a):
        return torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev)

    s = p.s
    if name == "obs":
        T = poses[ix(p.obs_pose)]
        r = _apply(_inv(T), points[ix(p.obs_point)]) - ix(p.obs_meas)
        return r, ix(p.obs_w)
    if name == "odo":
        Minv = _inv(ix(p.odo_meas))
        r = se3_log(Minv @ _inv(poses[ix(p.odo_a)]) @ poses[ix(p.odo_b)])
        return r, torch.full((r.shape[0],), 1.0 / s.sigma2_cam,
                             dtype=r.dtype, device=dev)
    if name == "pri":
        Minv = _inv(torch.from_numpy(p.pri_meas).to(dev))
        r = se3_log(Minv @ poses[0])[None]
        return r, torch.full((1,), s.prior_information, dtype=r.dtype,
                             device=dev)
    if name == "smo":
        r = se3_log(_inv(motions[ix(p.smo_a)]) @ motions[ix(p.smo_b)])
        return r, torch.full((r.shape[0],), 1.0 / s.sigma2_obj_smo,
                             dtype=r.dtype, device=dev)
    if name == "ter":
        H = motions[ix(p.ter_mot)]
        r = points[ix(p.ter_prev)] - _apply(_inv(H), points[ix(p.ter_cur)])
        return r, torch.full((r.shape[0],), 1.0 / s.sigma2_obj,
                             dtype=r.dtype, device=dev)
    H = motions[ix(p.alt_mot)]
    r = H[..., 1, 3:4]
    return r, torch.full((r.shape[0],), 1.0 / s.sigma2_alti, dtype=r.dtype,
                         device=dev)


def _n_edges(name: str, p: Problem) -> int:
    return {"obs": p.obs_pose.size, "odo": p.odo_a.size, "pri": 1,
            "smo": p.smo_a.size, "ter": p.ter_prev.size,
            "alt": p.alt_mot.size}[name]


def objective(p: Problem, poses, motions, points, device="cpu",
              block: int = 1 << 19) -> dict:
    """The robust objective at (poses, motions, points) (numpy arrays of
    any float dtype, taken as float64), evaluated in float64 on `device`
    in blocks of `block` edges: {"cost": the sum of every edge's Huber
    rho, "chi2": {type: sum of information-weighted chi2}, "rho": {type:
    its share of the cost}}."""
    dev = torch.device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    V = (t(poses), t(motions).reshape(-1, 4, 4), t(points).reshape(-1, 3))
    chi2s, rhos = {}, {}
    for name in EDGES:
        n = _n_edges(name, p)
        c = torch.zeros((), dtype=torch.float64, device=dev)
        h = torch.zeros((), dtype=torch.float64, device=dev)
        for b0 in range(0, n, block):
            r, w = _residuals(name, p, V, slice(b0, b0 + block), dev)
            chi2 = w * torch.sum(r * r, -1)
            c = c + chi2.sum()
            h = h + _rho(chi2, _delta(name, p.s), p.s.robust).sum()
        chi2s[name], rhos[name] = float(c), float(h)
    return {"cost": math.fsum(rhos.values()), "chi2": chi2s, "rho": rhos}


def check(p: Problem, report: dict, m, rtol: float, device="cpu",
          cost0_ref: float | None = None) -> dict:
    """The objective check of one refine: the program's reported cost0
    (at the archive as the refine found it, `p`'s initial values; its
    float64 objective may be given as cost0_ref) and cost (at what the
    refine wrote back into `m`) each within rtol of this file's float64
    evaluation, and cost below cost0.  Returns the readings and "ok"."""
    ref0 = (objective(p, p.poses0, p.motions0, p.points0, device)["cost"]
            if cost0_ref is None else cost0_ref)
    ref1 = objective(p, *refined(p, m), device)["cost"]
    gap0 = abs(report["cost0"] - ref0) / max(abs(ref0), 1e-300)
    gap1 = abs(report["cost"] - ref1) / max(abs(ref1), 1e-300)
    ok = bool(gap0 <= rtol and gap1 <= rtol
              and report["cost"] < report["cost0"])
    return {"ok": ok, "cost0_ref": ref0, "cost_ref": ref1,
            "cost0_gap": gap0, "cost_gap": gap1}


# --------------------------------------------------------------------------
# a dense LM with an exact solve (small graphs, the CPU)
# --------------------------------------------------------------------------

def _blocks(name, p: Problem, V):
    """Per edge of type `name`: the Jacobian of its residual with respect
    to each vertex it touches (right-multiplied tangents for poses and
    motions), as [(column offset kind, vertex index, J)]."""
    from torch.func import jacfwd, vmap

    poses, motions, points = V
    if name == "obs":
        def f(d, x, T, m):
            return _apply(_inv(T @ se3_exp(d)), x) - m
        ip, ix = (torch.from_numpy(p.obs_pose), torch.from_numpy(p.obs_point))
        args = (torch.zeros(ip.numel(), 6, dtype=torch.float64),
                points[ix], poses[ip], torch.from_numpy(p.obs_meas))
        Jd = vmap(jacfwd(f, 0))(*args)
        Jx = vmap(jacfwd(f, 1))(*args)
        return [("poses", ip, Jd), ("points", ix, Jx)]
    if name == "ter":
        def f(d, xp, xc, H):
            return xp - _apply(_inv(H @ se3_exp(d)), xc)
        im = torch.from_numpy(p.ter_mot)
        ia, ib = torch.from_numpy(p.ter_prev), torch.from_numpy(p.ter_cur)
        args = (torch.zeros(im.numel(), 6, dtype=torch.float64), points[ia],
                points[ib], motions[im])
        return [("motions", im, vmap(jacfwd(f, 0))(*args)),
                ("points", ia, vmap(jacfwd(f, 1))(*args)),
                ("points", ib, vmap(jacfwd(f, 2))(*args))]
    if name in ("odo", "smo"):
        a, b = ((p.odo_a, p.odo_b) if name == "odo" else (p.smo_a, p.smo_b))
        X = poses if name == "odo" else motions
        kind = "poses" if name == "odo" else "motions"
        ia, ib = torch.from_numpy(a), torch.from_numpy(b)
        Minv = (_inv(torch.from_numpy(p.odo_meas)) if name == "odo" else
                torch.eye(4, dtype=torch.float64).expand(ia.numel(), 4, 4))

        def f(da, db, Mi, A, B):
            return se3_log(Mi @ _inv(A @ se3_exp(da)) @ (B @ se3_exp(db)))
        z = torch.zeros(ia.numel(), 6, dtype=torch.float64)
        args = (z, z, Minv, X[ia], X[ib])
        return [(kind, ia, vmap(jacfwd(f, 0))(*args)),
                (kind, ib, vmap(jacfwd(f, 1))(*args))]
    if name == "pri":
        def f(d, Mi, A):
            return se3_log(Mi @ (A @ se3_exp(d)))
        Minv = _inv(torch.from_numpy(p.pri_meas))[None]
        args = (torch.zeros(1, 6, dtype=torch.float64), Minv, poses[:1])
        return [("poses", torch.zeros(1, dtype=torch.int64),
                 vmap(jacfwd(f, 0))(*args))]
    im = torch.from_numpy(p.alt_mot)

    def f(d, H):
        return (H @ se3_exp(d))[..., 1, 3:4]
    args = (torch.zeros(im.numel(), 6, dtype=torch.float64), motions[im])
    return [("motions", im, vmap(jacfwd(f, 0))(*args))]


def dense_lm(p: Problem, iters: int, lam: float = 1e-4) -> tuple:
    """Levenberg-Marquardt on the CPU with the Huber kernel as IRLS
    weights (g2o's robust kernels weigh an edge by rho'(chi2)) and an
    exact dense solve of (H + lam diag(H)) dx = -g per iteration (H =
    J^T W J over every edge, no Schur step); a step is kept when the cost
    falls.  Returns (poses, motions, points, [cost per iteration]) as
    float64 numpy arrays.  For graphs of a few thousand unknowns: H is
    dense."""
    F, M, P = (p.poses0.shape[0], p.motions0.shape[0], p.points0.shape[0])
    off = {"poses": 0, "motions": 6 * F, "points": 6 * F + 6 * M}
    width = {"poses": 6, "motions": 6, "points": 3}
    n = 6 * F + 6 * M + 3 * P
    V = tuple(torch.from_numpy(np.asarray(x, np.float64)).clone()
              for x in (p.poses0, p.motions0, p.points0))
    V = (V[0], V[1].reshape(-1, 4, 4), V[2].reshape(-1, 3))

    def cost(V):
        return objective(p, *(x.numpy() for x in V))["cost"]

    c = cost(V)
    history = [c]
    for _ in range(iters):
        H = torch.zeros(n, n, dtype=torch.float64)
        g = torch.zeros(n, dtype=torch.float64)
        for name in EDGES:
            if _n_edges(name, p) == 0:
                continue
            r, w = _residuals(name, p, V, slice(None), "cpu")
            chi2 = w * torch.sum(r * r, -1)
            d = _delta(name, p.s)
            if p.s.robust:
                w = w * torch.where(chi2 <= d * d, 1.0,
                                    d / torch.sqrt(torch.clamp(
                                        chi2, min=1e-300)))
            blocks = _blocks(name, p, V)
            cols = [off[k] + width[k] * idx[:, None]
                    + torch.arange(width[k])[None] for k, idx, _ in blocks]
            for (_, _, Ja), ca in zip(blocks, cols):
                g.index_add_(0, ca.reshape(-1),
                             torch.einsum("eri,er,e->ei", Ja, r,
                                          w).reshape(-1))
                for (_, _, Jb), cb in zip(blocks, cols):
                    blk = torch.einsum("eri,erj,e->eij", Ja, Jb, w)
                    H.index_put_((ca[:, :, None].expand_as(blk),
                                  cb[:, None, :].expand_as(blk)), blk,
                                 accumulate=True)
        diag = torch.diagonal(H)
        step = torch.linalg.solve(H + torch.diag(lam * diag + 1e-12), -g)
        dp = step[:6 * F].reshape(F, 6)
        dm = step[6 * F:6 * F + 6 * M].reshape(M, 6)
        dx = step[6 * F + 6 * M:].reshape(P, 3)
        V_new = (V[0] @ se3_exp(dp), V[1] @ se3_exp(dm), V[2] + dx)
        c_new = cost(V_new)
        if c_new < c:
            V, c, lam = V_new, c_new, lam * 0.5
        else:
            lam = lam * 10.0
        history.append(c)
    return tuple(x.numpy() for x in V) + (history,)
