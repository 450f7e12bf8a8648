"""Batched factor-graph core of both BA passes — port of
vdo_slam_tpu/backend/factor_graph.py (single-device solvers).

Same graph, same edge types, same formulas and constants as the original,
whose docstring maps them to the reference g2o stack (EdgeSE3Prior,
EdgeSE3, EdgeSE3PointXYZ, LandmarkMotionTernaryEdge, EdgeSE3Altitude;
Levenberg with a Huber kernel).  One LM iteration is a handful of gathers,
batched small products and `index_add_` segment sums; the full graph's
normal equations are solved matrix-free with block-Jacobi PCG, the window
graph's by a dense Schur complement.  On a card PCG's product H t and its
preconditioner's apply are hand-written kernels, one launch per edge type
and one per-vertex pass (ops/edge_hessian_cuda.py); on the CPU they are
the plain ops.

What changes with eager PyTorch:
  * `Graph` and `Variables` are dataclasses of tensors; the builders fill
    them with numpy arrays, and `upload` moves both to the device in one
    copy (indices as int64).
  * The scans become Python loops.  `LMParams.cg_unroll` and `lm_unroll`
    are XLA scan knobs and are inert here; `cg_tol` is inert, as in the
    original (PCG runs its fixed budget).
  * Accept/reject is `torch.where`, never a host `if`, and the batched
    inverses and solves use the `_ex` forms, which do not check on the
    host: inside a solve nothing waits for the device.  The host syncs are
    the original's: one per chunk of `lm_solve_chunked` for its gain test,
    and the caller's final fetch.
  * The SE(3) chain Jacobians are `torch.func.vmap(torch.func.jacfwd(..))`
    through geometry/se3.py, as the original uses `jax.vmap(jax.jacfwd)`.
  * The edge-sharded solve (`lm_solve_sharded`, `lm_solve_sharded_chunked`)
    takes a list of devices where the original takes a `Mesh`, and runs in
    this one process where the original runs `shard_map`: one controller
    drives every device, as one JAX process drives `jax.devices()`, so the
    API and its semantics stay (no launcher, no ranks).  The edge arrays
    are padded once to a multiple of n and shard i, the i-th contiguous
    block of each, lives on devices[i].  The five reductions the original
    psums (robust_cost, edge_type_stats, _matvec, _gradient, _block_diag)
    are computed per shard and added by one helper, `_psum`, on devices[0]
    in shard order.  What the original repeats on every device (the LM
    state, the damping, the preconditioner, PCG's vectors) runs once on
    devices[0]; the shards get copies of what they read: the variables
    after each step and each CG direction.  A list of one device is the
    single-device solve, op for op, and the list may repeat a device.
"""

from __future__ import annotations

import dataclasses
import math
import threading

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..devices import device_list
from ..geometry import se3
from ..ops.edge_hessian_cuda import INCIDENCE as _INCIDENCE
from ..ops.edge_hessian_cuda import block_jacobi, hessian_vector
from ..ops.edge_hessian_cuda import jtu as _jtu
from ..ops.edge_hessian_cuda import seg as _seg
from ..utils.cuda_graph import copy_out

Tensor = torch.Tensor
# torch's forward-AD levels are numbered process-wide, not per thread: two
# threads inside jacfwd at once (the window solves of two streams, each on
# its tracker's solve thread) enter and leave each other's level and fail.
# Every jacfwd goes through _edge_jac, which takes this lock.
_FORWARD_AD = threading.Lock()


@dataclasses.dataclass
class Graph:
    """Padded edge arrays.  *_w are information weights 1/sigma^2; invalid
    edges carry weight 0 and index 0.  numpy arrays from the builders,
    tensors once uploaded."""

    # pose-point observations
    obs_pose: Tensor       # (E,) int
    obs_point: Tensor      # (E,) int
    obs_meas: Tensor       # (E, 3) point in camera coords
    obs_w: Tensor          # (E,)
    # odometry chain (pose a -> pose b)
    odo_a: Tensor          # (Eo,)
    odo_b: Tensor
    odo_meas_inv: Tensor   # (Eo, 4, 4) M^-1
    odo_w: Tensor
    # prior edges on poses
    pri_idx: Tensor        # (Ep,)
    pri_meas_inv: Tensor   # (Ep, 4, 4)
    pri_w: Tensor
    # smoothness between motion vertices
    smo_a: Tensor          # (Es,)
    smo_b: Tensor
    smo_w: Tensor
    # ternary motion edges
    ter_prev: Tensor       # (Et,)
    ter_cur: Tensor
    ter_mot: Tensor
    ter_w: Tensor
    # altitude priors on motions
    alt_mot: Tensor        # (Ea,)
    alt_w: Tensor

    def to(self, device) -> "Graph":
        return Graph(**{f.name: getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)})


@dataclasses.dataclass
class Variables:
    poses: Tensor     # (F, 4, 4) camera->world
    motions: Tensor   # (M, 4, 4) world-frame object motions
    points: Tensor    # (P, 3)

    def to(self, device) -> "Variables":
        return Variables(self.poses.to(device), self.motions.to(device),
                         self.points.to(device))


def _upload(arrays: dict, device) -> dict:
    """numpy arrays -> tensors on `device` through ONE host-to-device copy:
    integer arrays become int64 (torch's index type), the rest float32,
    all packed into one (pinned, on CUDA) byte buffer and split on the
    device."""
    device = torch.device(device)
    host = {k: np.ascontiguousarray(
        a, np.int64 if np.issubdtype(np.asarray(a).dtype, np.integer)
        else np.float32) for k, a in arrays.items()}
    offsets, total = {}, 0
    for k, a in host.items():
        offsets[k] = total
        total += -(-a.nbytes // 8) * 8
    buf = np.empty(total, np.uint8)
    for k, a in host.items():
        buf[offsets[k]:offsets[k] + a.nbytes] = a.reshape(-1).view(np.uint8)
    t = torch.from_numpy(buf)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    out = {}
    for k, a in host.items():
        dt = torch.int64 if a.dtype == np.int64 else torch.float32
        out[k] = t[offsets[k]:offsets[k] + a.nbytes].view(dt).view(a.shape)
    return out


def graph_from_numpy(g, device="cuda") -> Graph:
    """A graph of numpy arrays (the builders' output, the port's or the JAX
    package's) as a Graph of tensors on `device`."""
    names = [f.name for f in dataclasses.fields(Graph)]
    return Graph(**_upload({n: np.asarray(getattr(g, n)) for n in names},
                           device))


def graph_on_host(g: Graph) -> Graph:
    """A graph of tensors (full_ba_inplace's, on its device) as numpy
    arrays, through ONE device-to-host copy (`fetch`: int64 indices,
    float32 values); a graph of numpy arrays as it is."""
    if not torch.is_tensor(g.obs_w):
        return g
    names = [f.name for f in dataclasses.fields(Graph)]
    return Graph(**fetch({n: getattr(g, n) for n in names}))


def variables_from_numpy(v, device="cuda") -> Variables:
    """Variables of numpy arrays (either package's) as tensors on `device`."""
    t = _upload({n: np.asarray(getattr(v, n))
                 for n in ("poses", "motions", "points")}, device)
    return Variables(**t)


def upload(g, v, device="cuda") -> tuple[Graph, Variables]:
    """A builder's (graph, variables) on `device`, in one copy."""
    gn = [f.name for f in dataclasses.fields(Graph)]
    vn = ("poses", "motions", "points")
    t = _upload({**{n: np.asarray(getattr(g, n)) for n in gn},
                 **{"v_" + n: np.asarray(getattr(v, n)) for n in vn}}, device)
    return (Graph(**{n: t[n] for n in gn}),
            Variables(**{n: t["v_" + n] for n in vn}))


def device_like(g, v) -> tuple[Graph, Variables]:
    """CPU tensors of the dtypes and shapes `upload` gives a builder's
    (graph, variables): integer arrays as int64, the rest float32."""
    def like(a):
        a = np.asarray(a)
        dt = (torch.int64 if np.issubdtype(a.dtype, np.integer)
              else torch.float32)
        return torch.empty(a.shape, dtype=dt)

    return (Graph(**{f.name: like(getattr(g, f.name))
                     for f in dataclasses.fields(Graph)}),
            Variables(*(like(getattr(v, n))
                        for n in ("poses", "motions", "points"))))


@dataclasses.dataclass(frozen=True)
class LMParams:
    """The original's fields and defaults, so one config means the same in
    both packages.  cg_unroll and lm_unroll set XLA scan unrolling there
    and are inert here; cg_tol is inert in both (see _pcg)."""

    iters: int = 30
    cg_iters: int = 100
    cg_tol: float = 1e-6
    cg_unroll: int = 4
    lm_unroll: int = 4
    lambda_init: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.5
    huber_delta: float = 1e-4     # reference deltaHuber* (Optimizer.cc:1352)
    # Huber-delta floor of the SE(3) chain edges (odo, smooth): in fp32 an
    # exact chain edge sits at chi2 ~4e-8 of rounding noise, above
    # huber_delta^2, and would be robustified (the original explains it)
    pose_huber_delta: float = 1e-3
    robust: bool = True
    gain_eps: float = 0.0         # optional early stop on relative decrease
    # the original's shard_map axis, over whose devices each reduction is
    # psummed.  Inert here: the device list given to lm_solve_sharded
    # shards a solve, and its reductions follow that list (_psum)
    axis_name: str | None = None


# --------------------------------------------------------------------------
# residuals
# --------------------------------------------------------------------------

def _eye(n: int, like: Tensor, batch: int) -> Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(
        batch, n, n)


def _se3_rel_residual(Minv, Ta, Tb):
    return se3.log(Minv @ se3.inv(Ta) @ Tb)


def residuals(g: Graph, v: Variables):
    """All edge residuals at the current estimate."""
    Tp = v.poses[g.obs_pose]                    # (E,4,4)
    Xp = v.points[g.obs_point]                  # (E,3)
    r_obs = se3.apply(se3.inv(Tp), Xp) - g.obs_meas

    r_odo = _se3_rel_residual(g.odo_meas_inv, v.poses[g.odo_a],
                              v.poses[g.odo_b])
    r_pri = se3.log(g.pri_meas_inv @ v.poses[g.pri_idx])
    r_smo = _se3_rel_residual(_eye(4, v.motions, g.smo_a.shape[0]),
                              v.motions[g.smo_a], v.motions[g.smo_b])
    H = v.motions[g.ter_mot]
    r_ter = v.points[g.ter_prev] - se3.apply(se3.inv(H), v.points[g.ter_cur])
    r_alt = v.motions[g.alt_mot][..., 1, 3:4]   # (Ea,1) t_y
    return r_obs, r_odo, r_pri, r_smo, r_ter, r_alt


def _chi2(r, w):
    return w * torch.sum(r * r, dim=-1)


def _huber_w(r, w, delta, robust):
    """IRLS weight multiplier per edge from information-weighted chi2."""
    chi2 = _chi2(r, w)
    if not robust:
        return torch.ones_like(chi2)
    # full_like: torch's scalar / tensor is a reciprocal then a product
    return torch.where(chi2 <= delta * delta, 1.0,
                       torch.full_like(chi2, delta)
                       / torch.sqrt(torch.clamp(chi2, min=1e-24)))


EDGE_TYPES = ("obs", "odo", "pri", "smo", "ter", "alt")


def _edge_delta(name: str, p: LMParams) -> float:
    """Huber delta per edge type: SE(3) chain edges get the fp32-adjusted
    pose-delta floor (see LMParams.pose_huber_delta)."""
    if name in ("odo", "smo"):
        return max(p.huber_delta, p.pose_huber_delta)
    return p.huber_delta


def _weights(g: Graph):
    return (g.obs_w, g.odo_w, g.pri_w, g.smo_w, g.ter_w, g.alt_w)


def edge_type_stats(g: Graph, v: Variables, p: LMParams):
    """Per-edge-type chi2 totals and inlier counts (the reference's chi2
    printout around each batch solve, Optimizer.cc:640-970 / 1938-2091):
    {type: {"n": active edges, "chi2": sum of weighted chi2, "n_inlier":
    edges with chi2 <= delta^2}}, as 0-dim tensors (no host sync)."""
    out = {}
    for name, r, w in zip(EDGE_TYPES, residuals(g, v), _weights(g)):
        d = _edge_delta(name, p)
        chi2 = _chi2(r, w)
        active = w > 0
        out[name] = {
            "n": torch.sum(active.to(torch.int32)),
            "chi2": torch.sum(torch.where(active, chi2, 0.0)),
            "n_inlier": torch.sum((active & (chi2 <= d * d)).to(torch.int32)),
        }
    return out


def format_edge_stats(stats0, stats1) -> str:
    """Human-readable before/after chi2 table for solver logs."""
    lines = []
    for name in EDGE_TYPES:
        s0, s1 = stats0[name], stats1[name]
        n = int(s0["n"])
        if n == 0:
            continue
        lines.append(
            f"  {name:>4s}: n={n:<7d} chi2 {float(s0['chi2']):.4e} -> "
            f"{float(s1['chi2']):.4e}  inliers {int(s0['n_inlier'])} -> "
            f"{int(s1['n_inlier'])}"
        )
    return "\n".join(lines)


def robust_cost(g: Graph, v: Variables, p: LMParams):
    """Total Huber-robustified cost (the LM acceptance criterion)."""
    total = 0.0
    for name, r, w in zip(EDGE_TYPES, residuals(g, v), _weights(g)):
        chi2 = _chi2(r, w)
        d = _edge_delta(name, p)
        if p.robust:
            rho = torch.where(
                chi2 <= d * d, chi2,
                2.0 * d * torch.sqrt(torch.clamp(chi2, min=1e-24)) - d * d)
        else:
            rho = chi2
        total = total + torch.sum(rho)
    return total


# --------------------------------------------------------------------------
# edge Jacobian blocks (right-multiplicative retraction)
# --------------------------------------------------------------------------

def _obs_blocks(g: Graph, v: Variables):
    """J wrt pose tangent (3,6) and point (3,3 = R^T) for obs edges."""
    Tp = v.poses[g.obs_pose]
    R = Tp[..., :3, :3]
    Y = se3.apply(se3.inv(Tp), v.points[g.obs_point])  # camera-frame point
    Jw = se3.hat(Y)                                    # dr/domega = [Y]_x
    Jv = -_eye(3, Y, Y.shape[0])                       # dr/dupsilon = -I
    return torch.cat([Jw, Jv], dim=-1), R.transpose(-1, -2)


def _ter_blocks(g: Graph, v: Variables):
    H = v.motions[g.ter_mot]
    RH = H[..., :3, :3]
    Z = se3.apply(se3.inv(H), v.points[g.ter_cur])
    eye = _eye(3, Z, Z.shape[0])
    J_mot = torch.cat([-se3.hat(Z), eye], dim=-1)      # (Et,3,6)
    return eye, -RH.transpose(-1, -2), J_mot


def _edge_jac(r_fn, argnum, z, *args):
    """vmap(jacfwd(r_fn)) over edges: (E, 6) tangents -> (E, out, 6).

    Each edge is vmapped as a batch of ONE (shapes (1, ...)), not as bare
    per-edge tensors: PyTorch's forward-mode rules for a 0-dim float32
    tensor and a Python float (x / 6.0, x * 0.5, x + 1.0) return a float64
    tangent, and se3.py's Taylor branches do that with per-edge angles."""
    with _FORWARD_AD:
        J = vmap(jacfwd(r_fn, argnums=argnum))(z[:, None],
                                               *[a[:, None] for a in args])
    return J[:, 0, :, 0, :]


def _rel_blocks(Minv, Ta, Tb):
    """Exact J of log(M^-1 (Ta e^da)^-1 (Tb e^db)) wrt (da, db) via jacfwd."""
    def r_fn(da, db, Mi, A, B):
        return se3.log(Mi @ se3.inv(A @ se3.exp(da)) @ (B @ se3.exp(db)))

    z = Ta.new_zeros(Ta.shape[0], 6)
    return (_edge_jac(r_fn, 0, z, z, Minv, Ta, Tb),
            _edge_jac(r_fn, 1, z, z, Minv, Ta, Tb))


def _pri_blocks(Minv, T):
    def r_fn(d, Mi, A):
        return se3.log(Mi @ (A @ se3.exp(d)))

    return _edge_jac(r_fn, 0, T.new_zeros(T.shape[0], 6), Minv, T)


def _alt_blocks(g: Graph, v: Variables):
    """d t_y(H e^d)/dd via jacfwd (exact; altitude edges are rare)."""
    def r_fn(d, H):
        return (H @ se3.exp(d))[..., 1, 3:4]

    H = v.motions[g.alt_mot]
    return _edge_jac(r_fn, 0, H.new_zeros(H.shape[0], 6), H)


# --------------------------------------------------------------------------
# matrix-free normal equations
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Tangent:
    poses: Tensor    # (F, 6)
    motions: Tensor  # (M, 6)
    points: Tensor   # (P, 3)

    def dot(self, other):
        return (torch.sum(self.poses * other.poses)
                + torch.sum(self.motions * other.motions)
                + torch.sum(self.points * other.points))

    def __add__(self, o):
        return Tangent(self.poses + o.poses, self.motions + o.motions,
                       self.points + o.points)

    def __sub__(self, o):
        return Tangent(self.poses - o.poses, self.motions - o.motions,
                       self.points - o.points)

    def scale(self, a):
        return Tangent(self.poses * a, self.motions * a, self.points * a)

    def to(self, device) -> "Tangent":
        return Tangent(self.poses.to(device), self.motions.to(device),
                       self.points.to(device))


def _linearize(g: Graph, v: Variables, p: LMParams):
    """Residuals, IRLS-weighted edge weights, and Jacobian blocks."""
    r_obs, r_odo, r_pri, r_smo, r_ter, r_alt = residuals(g, v)
    d = p.huber_delta
    dp = _edge_delta("odo", p)
    weights = dict(
        obs=g.obs_w * _huber_w(r_obs, g.obs_w, d, p.robust),
        odo=g.odo_w * _huber_w(r_odo, g.odo_w, dp, p.robust),
        pri=g.pri_w,  # prior is not robustified (information 1e5/1e7)
        smo=g.smo_w * _huber_w(r_smo, g.smo_w, dp, p.robust),
        ter=g.ter_w * _huber_w(r_ter, g.ter_w, d, p.robust),
        alt=g.alt_w,
    )
    Jo_pose, Jo_pt = _obs_blocks(g, v)
    Jt_prev, Jt_cur, Jt_mot = _ter_blocks(g, v)
    Jd_a, Jd_b = _rel_blocks(g.odo_meas_inv, v.poses[g.odo_a],
                             v.poses[g.odo_b])
    Js_a, Js_b = _rel_blocks(_eye(4, v.motions, g.smo_a.shape[0]),
                             v.motions[g.smo_a], v.motions[g.smo_b])
    blocks = dict(
        Jo_pose=Jo_pose, Jo_pt=Jo_pt, Jt_prev=Jt_prev, Jt_cur=Jt_cur,
        Jt_mot=Jt_mot, Jd_a=Jd_a, Jd_b=Jd_b, Js_a=Js_a, Js_b=Js_b,
        Jp=_pri_blocks(g.pri_meas_inv, v.poses[g.pri_idx]),
        Ja=_alt_blocks(g, v),
    )
    resid = dict(obs=r_obs, odo=r_odo, pri=r_pri, smo=r_smo, ter=r_ter,
                 alt=r_alt)
    return resid, weights, blocks


def _matvec(g: Graph, blocks, weights, t: Tangent,
            damp: Tangent | None = None) -> Tangent:
    """H t = J^T W J t, edge-wise, plus damp * t where given: the edge
    Hessian kernels on a card, their plain version on the CPU
    (ops/edge_hessian_cuda.py)."""
    return Tangent(*hessian_vector(g, blocks, weights, t, damp))


def _gradient(g: Graph, blocks, weights, resid, F, M, P) -> Tangent:
    """g = J^T W r."""
    out = {"poses": resid["obs"].new_zeros(F, 6),
           "motions": resid["obs"].new_zeros(M, 6),
           "points": resid["obs"].new_zeros(P, 3)}
    for edge, inc in _INCIDENCE.items():
        u = resid[edge] * weights[edge][:, None]
        for J, idx, kind in inc:
            out[kind] = out[kind] + _seg(_jtu(blocks[J], u), getattr(g, idx),
                                         out[kind].shape[0])
    return Tangent(**out)


def _outer(J, w):
    return torch.einsum("eij,eik,e->ejk", J, J, w)


def _block_diag(g: Graph, blocks, weights, F, M, P):
    """Undamped block-Jacobi blocks of J^T W J: (poses, motions, points)."""
    w0 = weights["obs"]
    out = {"poses": w0.new_zeros(F, 6, 6), "motions": w0.new_zeros(M, 6, 6),
           "points": w0.new_zeros(P, 3, 3)}
    for edge, inc in _INCIDENCE.items():
        for J, idx, kind in inc:
            out[kind] = out[kind] + _seg(_outer(blocks[J], weights[edge]),
                                         getattr(g, idx), out[kind].shape[0])
    return out["poses"], out["motions"], out["points"]


def _damped_diag(D, lam, floor=1e-8):
    """Marquardt damping terms per variable: lam * diag(H) (+ floor)."""
    return Tangent(*[lam * torch.diagonal(x, dim1=-2, dim2=-1) + floor
                     for x in D])


def _invert_precond(D):
    """Invert the damped block-Jacobi blocks ONCE, outside the CG loop (the
    blocks are SPD + damped; inv_ex leaves the check on the device)."""
    return tuple(torch.linalg.inv_ex(x)[0] for x in D)


def _apply_precond(Dinv, t: Tangent) -> Tangent:
    return Tangent(*block_jacobi(Dinv, t))


def _pcg(matvec, precond, b: Tangent, iters: int) -> Tangent:
    """Preconditioned CG for a fixed budget of `iters` iterations.  The
    original keeps its `tol` inert (a live tolerance measured slower on the
    TPU); here it stays so, for the same iterations in both packages."""
    x = Tangent(torch.zeros_like(b.poses), torch.zeros_like(b.motions),
                torch.zeros_like(b.points))
    r = b
    z = precond(r)
    d = z
    rz = r.dot(z)
    for _ in range(iters):
        Ad = matvec(d)
        dAd = d.dot(Ad)
        ok = dAd > 1e-30
        alpha = torch.where(ok, rz / torch.clamp(dAd, min=1e-30), 0.0)
        x = x + d.scale(alpha)
        r = r - Ad.scale(alpha)
        z = precond(r)
        rz_new = r.dot(z)
        beta = torch.where(ok & (rz > 1e-30),
                           rz_new / torch.clamp(rz, min=1e-30), 0.0)
        d = z + d.scale(beta)
        rz = rz_new
    return x


def _retract_vars(v: Variables, t: Tangent) -> Variables:
    return Variables(poses=v.poses @ se3.exp(t.poses),
                     motions=v.motions @ se3.exp(t.motions),
                     points=v.points + t.points)


def _accept(v_new, v, new_cost, cost, lam, p: LMParams):
    """LM acceptance on the device: keep the step iff the cost fell."""
    accept = new_cost < cost
    v = Variables(*[torch.where(accept, a, b) for a, b in (
        (v_new.poses, v.poses), (v_new.motions, v.motions),
        (v_new.points, v.points))])
    lam = torch.where(accept, lam * p.lambda_down, lam * p.lambda_up)
    return (v, torch.clamp(lam, 1e-10, 1e8),
            torch.where(accept, new_cost, cost))


def _lam(p: LMParams, like: Tensor) -> Tensor:
    # a fill, not a copy from the host (which would wait for the stream)
    return torch.full((), p.lambda_init, dtype=like.dtype, device=like.device)


def _tree_map(fn, *trees):
    """fn over the tensors of trees of one structure (tensors, Tangents,
    tuples, dicts)."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if isinstance(t, Tangent):
        return Tangent(*[_tree_map(fn, *[getattr(x, k) for x in trees])
                         for k in ("poses", "motions", "points")])
    if isinstance(t, dict):
        return {k: _tree_map(fn, *[x[k] for x in trees]) for k in t}
    return tuple(_tree_map(fn, *xs) for xs in zip(*trees))


def _psum(parts: list, device):
    """The reduction over the edge shards (the original's psum): the
    per-shard parts, trees of one structure, added on `device` in shard
    order.  Where a shard lies on another device its part is copied over
    first; one part comes back as it is."""
    total = _tree_map(lambda x: x.to(device), parts[0])
    for part in parts[1:]:
        total = _tree_map(lambda a, b: a + b.to(device), total, part)
    return total


def _lm(shards: list[Graph], v0: Variables, p: LMParams, lam0=None):
    """p.iters LM iterations over a graph whose edges are split into
    `shards`, each on its own device; the variables, the LM state and PCG
    live on v0's device (the first shard's).  Every per-edge sum is taken
    per shard and reduced by _psum; each shard reads a copy of the
    variables (and of each CG direction) on its device, which is the
    variables themselves where the devices agree."""
    dev = v0.poses.device
    devs = [sh.obs_w.device for sh in shards]
    F, M, P = v0.poses.shape[0], v0.motions.shape[0], v0.points.shape[0]

    def cost(v):
        return _psum([robust_cost(sh, vi, p)
                      for sh, vi in zip(shards, [v.to(d) for d in devs])],
                     dev)

    def stats(v):
        return _psum([edge_type_stats(sh, vi, p)
                      for sh, vi in zip(shards, [v.to(d) for d in devs])],
                     dev)

    cost0 = cost(v0)
    v, c = v0, cost0
    lam = _lam(p, cost0) if lam0 is None else lam0
    history = []
    for _ in range(p.iters):
        lins = [_linearize(sh, v.to(d), p) for sh, d in zip(shards, devs)]
        grad = _psum([_gradient(sh, b, w, r, F, M, P)
                      for sh, (r, w, b) in zip(shards, lins)], dev)
        D = _psum([_block_diag(sh, b, w, F, M, P)
                   for sh, (_, w, b) in zip(shards, lins)], dev)
        damp = _damped_diag(D, lam)
        D_prec = _invert_precond(tuple(
            x + torch.diag_embed(dd)
            for x, dd in zip(D, (damp.poses, damp.motions, damp.points))))

        def mv(t):
            # the damping joins the first shard's product, on dev
            return _psum([_matvec(sh, b, w, t.to(d), damp if i == 0 else None)
                          for i, (sh, d, (_, w, b))
                          in enumerate(zip(shards, devs, lins))], dev)

        delta = _pcg(mv, lambda t: _apply_precond(D_prec, t),
                     grad.scale(-1.0), p.cg_iters)
        v_new = _retract_vars(v, delta)
        v, lam, c = _accept(v_new, v, cost(v_new), c, lam, p)
        history.append(c)
    history = torch.stack(history) if history else cost0.new_zeros(0)
    return v, {"cost0": cost0, "cost": c, "history": history, "lam": lam,
               "stats0": stats(v0), "stats": stats(v)}


def lm_solve(g: Graph, v0: Variables, p: LMParams, lam0=None):
    """Damped Gauss-Newton (LM) with PCG inner solves.

    Mirrors g2o OptimizationAlgorithmLevenberg.  Returns (Variables, info
    dict incl. the final damping `lam`, so callers can chunk long
    optimizations)."""
    return _lm([g], v0, p, lam0)


def _chunked(solve, v0: Variables, p: LMParams, chunk: int, callback):
    """p.iters iterations of solve(v, p_chunk, lam) -> (v, info) in chunks
    of `chunk`, damping carried across, with the gain test at each chunk
    boundary (lm_solve_chunked).  solve may return static outputs, which
    its next call overwrites (backend/full_ba.py:FullBAGraphs): v and lam
    only feed that call, and the first chunk's cost0 and stats0 are copied
    out; the last chunk's outputs are the caller's to fetch."""
    v = v0
    lam = _lam(p, v0.points)
    info = {}
    total = 0
    cost0 = stats0 = None
    for i in range(math.ceil(p.iters / chunk)):
        # honor p.iters exactly: the tail chunk runs the remainder
        n_it = min(chunk, p.iters - total)
        v, info = solve(v, dataclasses.replace(p, iters=n_it), lam)
        lam = info["lam"]
        total += n_it
        if cost0 is None:
            # copied out: where solve replays a graph, the next chunk's
            # replay overwrites its outputs
            cost0, stats0 = copy_out((info["cost0"], info["stats0"]))
        stop = False
        if p.gain_eps > 0:
            c0, c1 = torch.stack([info["cost0"], info["cost"]]).tolist()
            stop = (c0 - c1) / max(c0, 1e-20) < p.gain_eps
        if callback is not None:
            callback(i, info)
        if stop:
            break
    info = dict(info)
    info["cost0"] = cost0
    info["stats0"] = stats0
    info["iters_run"] = total
    return v, info


def lm_solve_chunked(g: Graph, v0: Variables, p: LMParams, chunk: int = 3,
                     callback=None):
    """p.iters LM iterations in chunks of `chunk`, damping carried across.

    The chunks are not a device-time workaround here but the g2o gain
    threshold (SparseOptimizerTerminateAction, Optimizer.cc:140-142): the
    relative cost decrease is tested against p.gain_eps at each chunk
    boundary, so the chunk size decides which iterations run.  That test
    is the only host sync per chunk; `callback(i, info)` runs after it.
    info["cost0"] and info["stats0"] stay tensors."""
    return _chunked(lambda v, pc, lam: lm_solve(g, v, pc, lam0=lam), v0, p,
                    chunk, callback)


# --------------------------------------------------------------------------
# edge-sharded solve: edges split over a device list, reductions by _psum
# --------------------------------------------------------------------------

def _pad_edges_for_mesh(g: Graph, n_dev: int) -> Graph:
    """Every edge array padded to a multiple of n_dev (the original's mesh
    size): zero weights, so the pad edges contribute nothing, and index 0;
    the 4x4 measurement pads are identity, so the SE(3) log stays
    finite."""
    def pad_to(x):
        n = -(-x.shape[0] // n_dev) * n_dev - x.shape[0]
        if x.is_floating_point() and x.dim() == 3:  # 4x4 measurement pads
            pad = torch.eye(4, dtype=x.dtype, device=x.device).expand(
                n, 4, 4)
        else:
            pad = x.new_zeros((n,) + tuple(x.shape[1:]))
        return torch.cat([x, pad])

    return Graph(**{f.name: pad_to(getattr(g, f.name))
                    for f in dataclasses.fields(Graph)})


def _shard_edges(g: Graph, devices) -> list[Graph]:
    """g padded for len(devices) shards; shard i, the i-th contiguous block
    of every edge array (the original's P(axis)), on devices[i]."""
    n = len(devices)
    g = _pad_edges_for_mesh(g, n)

    def block(x, i):
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k]

    return [Graph(**{f.name: block(getattr(g, f.name), i).to(d)
                     for f in dataclasses.fields(Graph)})
            for i, d in enumerate(devices)]


def lm_solve_sharded(g: Graph, v0: Variables, p: LMParams, devices,
                     lam0=None):
    """lm_solve with the edge arrays sharded over `devices` (a list, which
    may repeat a device; the original's mesh axis).

    The variables are replicated; every J^T W J product, gradient,
    preconditioner block, cost and edge statistic is computed from each
    shard's edges and summed over the shards on devices[0], where the
    result lies.  Results equal the single-device solve up to summation
    order."""
    devices = device_list(devices)
    v0 = v0.to(devices[0])
    if lam0 is not None:
        lam0 = (lam0.to(devices[0]) if torch.is_tensor(lam0) else
                torch.full((), float(lam0), dtype=torch.float32,
                           device=devices[0]))
    return _lm(_shard_edges(g, devices), v0, p, lam0)


def lm_solve_sharded_chunked(g: Graph, v0: Variables, p: LMParams, devices,
                             chunk: int = 3, callback=None):
    """lm_solve_chunked over the edge-sharded solve: the same chunks, gain
    test and info; the edges are padded and sharded ONCE, not per
    chunk."""
    devices = device_list(devices)
    shards = _shard_edges(g, devices)
    return _chunked(lambda v, pc, lam: _lm(shards, v, pc, lam),
                    v0.to(devices[0]), p, chunk, callback)


# --------------------------------------------------------------------------
# dense-Schur direct LM for point-block-diagonal graphs (windowed BA)
# --------------------------------------------------------------------------

def _reduced_pose_system(g: Graph, resid, weights, blocks, F: int):
    """The pose blocks of the window system before the Schur step: Hcc
    (F, 6, F, 6) from the obs, odometry and prior edges, and its rhs bc
    (F, 6).  The original scatters each (E, 6, 6) block with
    Hcc.at[ii, :, jj, :].add; here the blocks go into an (F, F, 6, 6)
    layout with index_put_ and are permuted once at the end."""
    Jo_pose, w, r = blocks["Jo_pose"], weights["obs"], resid["obs"]
    diag_pose = _seg(torch.einsum("eij,eik,e->ejk", Jo_pose, Jo_pose, w),
                     g.obs_pose, F)
    Hb = torch.einsum("fij,fg->fgij", diag_pose,
                      torch.eye(F, dtype=w.dtype, device=w.device))
    bc = -_seg(torch.einsum("eij,ei->ej", Jo_pose, r * w[:, None]),
               g.obs_pose, F)

    # odometry + prior blocks (small counts; scatter into dense blocks)
    def acc(Ji, Jj, ii, jj, we):
        Hb.index_put_((ii, jj), torch.einsum("eij,eik,e->ejk", Ji, Jj, we),
                      accumulate=True)

    def rhs(Ji, ii, we, re):
        return -_seg(torch.einsum("eij,ei,e->ej", Ji, re, we), ii, F)

    Jd_a, Jd_b = blocks["Jd_a"], blocks["Jd_b"]
    wo, ro = weights["odo"], resid["odo"]
    a_idx, b_idx = g.odo_a, g.odo_b
    acc(Jd_a, Jd_a, a_idx, a_idx, wo)
    bc = bc + rhs(Jd_a, a_idx, wo, ro)
    acc(Jd_b, Jd_b, b_idx, b_idx, wo)
    bc = bc + rhs(Jd_b, b_idx, wo, ro)
    acc(Jd_a, Jd_b, a_idx, b_idx, wo)
    acc(Jd_b, Jd_a, b_idx, a_idx, wo)
    Jp, wp = blocks["Jp"], weights["pri"]
    acc(Jp, Jp, g.pri_idx, g.pri_idx, wp)
    bc = bc + rhs(Jp, g.pri_idx, wp, resid["pri"])
    return Hb.permute(0, 2, 1, 3), bc


def lm_solve_schur(g: Graph, v0: Variables, p: LMParams):
    """LM with an EXACT reduced solve for graphs whose points appear only in
    pose-point obs edges (no ternary coupling) — the windowed static BA.

    Point blocks are eliminated analytically (3x3 inverses), the reduced
    pose system (6F x 6F, F <= window) is assembled densely and solved by
    one equilibrated dense solve per LM iteration (the original's analogue
    of g2o BlockSolver + sparse Cholesky, Optimizer.cc:172-183)."""
    F, P = v0.poses.shape[0], v0.points.shape[0]
    n = 6 * F
    cost0 = robust_cost(g, v0, p)
    v, cost, lam = v0, cost0, _lam(p, cost0)
    eyen = torch.eye(n, dtype=cost0.dtype, device=cost0.device)
    history = []
    for _ in range(p.iters):
        resid, weights, blocks = _linearize(g, v, p)
        Jo_pose, Jo_pt = blocks["Jo_pose"], blocks["Jo_pt"]
        w = weights["obs"]
        r = resid["obs"]

        # point blocks + rhs
        Hpp = _seg(torch.einsum("eij,eik,e->ejk", Jo_pt, Jo_pt, w),
                   g.obs_point, P)
        dpp = lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-8
        Hpp = Hpp + torch.diag_embed(dpp)
        bp = -_seg(torch.einsum("eij,ei,e->ej", Jo_pt, r, w), g.obs_point, P)
        Hpp_inv = torch.linalg.inv_ex(Hpp)[0]

        # dense cross blocks U[(pose, point)] = Jp^T w Jx  (6,3)
        flat_idx = g.obs_pose * P + g.obs_point
        U = _seg(torch.einsum("eij,eik,e->ejk", Jo_pose, Jo_pt, w),
                 flat_idx, F * P).reshape(F, P, 6, 3)

        Hcc, bc = _reduced_pose_system(g, resid, weights, blocks, F)

        # Marquardt damping on poses
        Hd = Hcc.reshape(n, n)
        Hd = Hd + torch.diag(lam * torch.diagonal(Hd) + 1e-8)

        # Schur: S = Hcc - U Hpp^-1 U^T ; rhs = bc - U Hpp^-1 bp
        UHi = torch.einsum("fpij,pjk->fpik", U, Hpp_inv)       # (F,P,6,3)
        # output layout MUST be (F,6,G,6) to match (F,6,F,6)->(n,n); the
        # original records "filg" permuting the columns for any F > 1
        S = Hd - torch.einsum("fpik,gplk->figl", UHi, U).reshape(n, n)
        rhs_c = bc.reshape(n) - torch.einsum("fpik,pk->fi", UHi,
                                             bp).reshape(n)

        # equilibrated solve
        d = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-12))
        Ss = S / d[:, None] / d[None, :]
        dc = torch.linalg.solve_ex(Ss + 1e-7 * eyen, rhs_c / d)[0] / d
        dc_t = dc.reshape(F, 6)
        # back-substitute points
        dp = torch.einsum("pij,pj->pi", Hpp_inv,
                          bp - torch.einsum("fpij,fi->pj", U, dc_t))

        delta = Tangent(dc_t, v.motions.new_zeros(v.motions.shape[0], 6), dp)
        v_new = _retract_vars(v, delta)
        v, lam, cost = _accept(v_new, v, robust_cost(g, v_new, p), cost, lam,
                               p)
        history.append(cost)
    history = torch.stack(history) if history else cost0.new_zeros(0)
    return v, {"cost0": cost0, "cost": cost, "history": history,
               "stats0": edge_type_stats(g, v0, p),
               "stats": edge_type_stats(g, v, p)}


def fetch(tree):
    """Every tensor of a nested dict/list/tuple on the host, through ONE
    device-to-host copy; returns the same structure of numpy arrays (0-dim
    ones for scalars), integer tensors back as int64."""
    leaves = []

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(y) for k, y in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(y) for y in x)
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return _Leaf(len(leaves) - 1)
        return x

    shape = walk(tree)
    # float64 holds every float32 value and every count below 2^53 exactly
    flat = torch.cat([x.reshape(-1).to(torch.float64) for x in leaves]).cpu()
    host, o = [], 0
    for x in leaves:
        a = flat[o:o + x.numel()].numpy().reshape(tuple(x.shape))
        o += x.numel()
        host.append(a.astype(np.int64 if not x.is_floating_point()
                             else np.float32))

    def fill(x):
        if isinstance(x, dict):
            return {k: fill(y) for k, y in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(fill(y) for y in x)
        return host[x.i] if isinstance(x, _Leaf) else x

    return fill(shape)


@dataclasses.dataclass(frozen=True)
class _Leaf:
    i: int
