"""Wrapper of the edge Hessian kernels (csrc/edge_hessian.cu): the
product H t = J^T W J t that the full BA's PCG takes at every step, the
block-Jacobi apply beside it, and the linearisation and evaluation of the
two large edge types (observations, ternary motion edges) around it.

  * `hessian_vector(g, blocks, weights, t, damp=None)`: (poses, motions,
    points) of H t, plus damp * t where `damp` is given;
  * `block_jacobi(Dinv, r)`: each row block of r times its block of Dinv;
  * `linearize(g, v, delta, robust)`: the obs and ter edges' IRLS-weighted
    weights and Jacobian blocks, and their sums J^T W r (the gradient) and
    J^T W J (the undamped block diagonal) per vertex;
  * `evaluate(g, v, delta, robust)`: the obs and ter edges' robust cost
    and chi2 statistics.

`g` is a factor graph (backend/factor_graph.py:Graph), `v` its variables,
`blocks` and `weights` what its linearisation leaves (`_linearize`), `t`,
`damp` and `r` Tangents (anything with poses, motions and points) and
`Dinv` the (poses, motions, points) blocks.  For CUDA tensors
`hessian_vector` is one vertex-pass launch (its output set to damp * t, or
to zeros) and one edge launch per edge type that has edges, all on torch's
current stream; `block_jacobi` is one vertex-pass launch; `linearize` one
launch per large edge type with edges and one vertex pass (the blocks'
lower triangles), `evaluate` one launch per large edge type with edges.
For CPU tensors each runs its plain version (`matvec_plain`,
`damped_plain`, `precond_plain`, `linearize_plain`, `evaluate_plain`), the
solver's own ops.  Anything else raises: wrong dtypes, shapes that
disagree, strides the kernels do not take, tensors on another device.
Indices are trusted to lie inside their vertex kind's rows, as the
builders make them.

The kernels replace no Pallas kernel; the source says why they were
written, what bounds them and what their design does about it.  The shared
library is compiled with nvcc at first use (ops/nvcc_build.py), which is
the first full-BA solve on a card, and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import threading
import time
from pathlib import Path

import torch

from ..geometry import se3
from . import nvcc_build

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "edge_hessian.cu"
KINDS = ("poses", "motions", "points")
WIDTH = {"poses": 6, "motions": 6, "points": 3}

# (Jacobian block, graph index field, variable kind) of every edge-vertex
# incidence, grouped by edge type: the rows that the matvec, the gradient
# and the block diagonal sum over
INCIDENCE = {
    "obs": (("Jo_pose", "obs_pose", "poses"), ("Jo_pt", "obs_point", "points")),
    "ter": (("Jt_prev", "ter_prev", "points"), ("Jt_cur", "ter_cur", "points"),
            ("Jt_mot", "ter_mot", "motions")),
    "odo": (("Jd_a", "odo_a", "poses"), ("Jd_b", "odo_b", "poses")),
    "smo": (("Js_a", "smo_a", "motions"), ("Js_b", "smo_b", "motions")),
    "pri": (("Jp", "pri_idx", "poses"),),
    "alt": (("Ja", "alt_mot", "motions"),),
}
# residual rows of each edge type
ROWS = {"obs": 3, "ter": 3, "odo": 6, "smo": 6, "pri": 6, "alt": 1}
# the source's variant of each edge type (edge_hv_launch)
_VARIANT = {"obs": 0, "ter": 1, "odo": 2, "smo": 2, "pri": 3, "alt": 4}
# the edge types of `linearize` and `evaluate`, their variants there
# (edge_lin_launch) and the rows their Jacobians are taken at
LARGE = ("obs", "ter")
_LIN_VARIANT = {"obs": 0, "ter": 1}
_LIN_ROWS = {"obs": "poses", "ter": "motions"}


# --------------------------------------------------------------------------
# the plain version (the CPU's path)
# --------------------------------------------------------------------------

def seg(x, idx, n):
    """Segment sum of x's rows into n rows (jax.ops.segment_sum)."""
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add_(0, idx, x)


def jx(J, x):
    return torch.einsum("eij,ej->ei", J, x)


def jtu(J, u):
    return torch.einsum("eij,ei->ej", J, u)


def _rows(t) -> tuple:
    return t.poses, t.motions, t.points


def matvec_plain(g, blocks, weights, t) -> tuple:
    """H t = J^T W J t, edge-wise."""
    out = {k: torch.zeros_like(getattr(t, k)) for k in KINDS}
    for edge, inc in INCIDENCE.items():
        u = None
        for J, idx, kind in inc:
            ju = jx(blocks[J], getattr(t, kind)[getattr(g, idx)])
            u = ju if u is None else u + ju
        u = u * weights[edge][:, None]
        for J, idx, kind in inc:
            out[kind] = out[kind] + seg(jtu(blocks[J], u), getattr(g, idx),
                                        out[kind].shape[0])
    return tuple(out[k] for k in KINDS)


def damped_plain(h: tuple, damp, t) -> tuple:
    return tuple(a + d * x for a, d, x in zip(h, _rows(damp), _rows(t)))


def precond_plain(Dinv, t) -> tuple:
    Dp, Dm, Dx = Dinv
    return (torch.einsum("nij,nj->ni", Dp, t.poses),
            torch.einsum("nij,nj->ni", Dm, t.motions),
            torch.einsum("nij,nj->ni", Dx, t.points))


def outer(J, w):
    return torch.einsum("eij,eik,e->ejk", J, J, w)


def add_gradient(out: tuple, g, blocks, weights, resid, edges) -> tuple:
    """out (poses, motions, points) + J^T W r over the incidences of
    `edges`, taken in that order."""
    out = dict(zip(KINDS, out))
    for edge in edges:
        u = resid[edge] * weights[edge][:, None]
        for J, idx, kind in INCIDENCE[edge]:
            out[kind] = out[kind] + seg(jtu(blocks[J], u), getattr(g, idx),
                                        out[kind].shape[0])
    return tuple(out[k] for k in KINDS)


def add_block_diag(out: tuple, g, blocks, weights, edges) -> tuple:
    """out (poses, motions, points) + the block diagonal of J^T W J over
    the incidences of `edges`, taken in that order."""
    out = dict(zip(KINDS, out))
    for edge in edges:
        for J, idx, kind in INCIDENCE[edge]:
            out[kind] = out[kind] + seg(outer(blocks[J], weights[edge]),
                                        getattr(g, idx), out[kind].shape[0])
    return tuple(out[k] for k in KINDS)


def zero_rows(like, n: tuple) -> tuple:
    """Zero gradient rows of like's dtype and device for n = (F, M, P)
    vertices: (F, 6), (M, 6), (P, 3)."""
    return tuple(like.new_zeros(m, WIDTH[k]) for k, m in zip(KINDS, n))


def zero_blocks(like, n: tuple) -> tuple:
    """Zero block-diagonal blocks likewise: (F, 6, 6), (M, 6, 6),
    (P, 3, 3)."""
    return tuple(like.new_zeros(m, WIDTH[k], WIDTH[k])
                 for k, m in zip(KINDS, n))


def _counts(v) -> tuple:
    return tuple(getattr(v, k).shape[0] for k in KINDS)


def chi2(r, w):
    return w * torch.sum(r * r, dim=-1)


def huber_w(r, w, delta, robust):
    """IRLS weight multiplier per edge from information-weighted chi2."""
    c = chi2(r, w)
    if not robust:
        return torch.ones_like(c)
    # full_like: torch's scalar / tensor is a reciprocal then a product
    return torch.where(c <= delta * delta, 1.0,
                       torch.full_like(c, delta)
                       / torch.sqrt(torch.clamp(c, min=1e-24)))


def rho(c, d, robust):
    """The Huber cost of each edge's chi2 c (c itself where not robust)."""
    if not robust:
        return c
    return torch.where(c <= d * d, c,
                       2.0 * d * torch.sqrt(torch.clamp(c, min=1e-24))
                       - d * d)


def edge_stats(c, w, d) -> dict:
    """Active edges (weight above 0), their summed chi2 and their inliers
    (chi2 <= d^2), as 0-dim tensors."""
    active = w > 0
    return {
        "n": torch.sum(active.to(torch.int32)),
        "chi2": torch.sum(torch.where(active, c, 0.0)),
        "n_inlier": torch.sum((active & (c <= d * d)).to(torch.int32)),
    }


def edge_sums(r, w, d, robust) -> dict:
    """One edge type's summed Huber cost ("rho") and edge_stats."""
    c = chi2(r, w)
    return {"rho": torch.sum(rho(c, d, robust)), **edge_stats(c, w, d)}


def obs_residual(g, v):
    """inv(T) X - z of each observation."""
    Tp = v.poses[g.obs_pose]                    # (E,4,4)
    Xp = v.points[g.obs_point]                  # (E,3)
    return se3.apply(se3.inv(Tp), Xp) - g.obs_meas


def ter_residual(g, v):
    """X_prev - inv(H) X_cur of each ternary motion edge."""
    H = v.motions[g.ter_mot]
    return v.points[g.ter_prev] - se3.apply(se3.inv(H), v.points[g.ter_cur])


def _eye(n: int, like, batch: int):
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(
        batch, n, n)


def obs_blocks(g, v):
    """J wrt pose tangent (3,6) and point (3,3 = R^T) for obs edges."""
    Tp = v.poses[g.obs_pose]
    R = Tp[..., :3, :3]
    Y = se3.apply(se3.inv(Tp), v.points[g.obs_point])  # camera-frame point
    Jw = se3.hat(Y)                                    # dr/domega = [Y]_x
    Jv = -_eye(3, Y, Y.shape[0])                       # dr/dupsilon = -I
    return torch.cat([Jw, Jv], dim=-1), R.transpose(-1, -2)


def ter_blocks(g, v):
    H = v.motions[g.ter_mot]
    RH = H[..., :3, :3]
    Z = se3.apply(se3.inv(H), v.points[g.ter_cur])
    eye = _eye(3, Z, Z.shape[0])
    J_mot = torch.cat([-se3.hat(Z), eye], dim=-1)      # (Et,3,6)
    return eye, -RH.transpose(-1, -2), J_mot


def large_terms(g, v, delta, robust):
    """(residuals, IRLS-weighted weights, Jacobian blocks) of the obs and
    ter edges, as dicts keyed like factor_graph._linearize's."""
    r_obs, r_ter = obs_residual(g, v), ter_residual(g, v)
    weights = {"obs": g.obs_w * huber_w(r_obs, g.obs_w, delta, robust),
               "ter": g.ter_w * huber_w(r_ter, g.ter_w, delta, robust)}
    Jo_pose, Jo_pt = obs_blocks(g, v)
    Jt_prev, Jt_cur, Jt_mot = ter_blocks(g, v)
    blocks = dict(Jo_pose=Jo_pose, Jo_pt=Jo_pt, Jt_prev=Jt_prev,
                  Jt_cur=Jt_cur, Jt_mot=Jt_mot)
    return {"obs": r_obs, "ter": r_ter}, weights, blocks


def linearize_plain(g, v, delta, robust) -> tuple:
    """(weights, blocks, gradient, block diagonal) of the obs and ter
    edges: the gradient rows and blocks summed from zeros, obs then ter."""
    resid, weights, blocks = large_terms(g, v, delta, robust)
    n = _counts(v)
    grad = add_gradient(zero_rows(v.points, n), g, blocks, weights, resid,
                        LARGE)
    diag = add_block_diag(zero_blocks(v.points, n), g, blocks, weights,
                          LARGE)
    return weights, blocks, grad, diag


def evaluate_plain(g, v, delta, robust) -> dict:
    """{"obs": edge_sums, "ter": edge_sums}."""
    return {"obs": edge_sums(obs_residual(g, v), g.obs_w, delta, robust),
            "ter": edge_sums(ter_residual(g, v), g.ter_w, delta, robust)}


# --------------------------------------------------------------------------
# host-side checks
# --------------------------------------------------------------------------

def _check_rows(name: str, rows: tuple, device, like=None) -> None:
    """rows: (poses, motions, points), each float32 (n, width) on device,
    contiguous where it goes to a kernel; `like`: rows of the same
    shapes."""
    for i, (k, x) in enumerate(zip(KINDS, rows, strict=True)):
        if not torch.is_tensor(x) or x.dtype != torch.float32:
            raise TypeError(f"{name}.{k} must be a float32 tensor, got "
                            f"{getattr(x, 'dtype', type(x).__name__)}")
        if x.device != device:
            raise ValueError(f"{name}.{k} is on {x.device}, not {device}")
        if x.dim() != 2 or x.shape[1] != WIDTH[k]:
            raise ValueError(f"{name}.{k} must be (n, {WIDTH[k]}), got "
                             f"{tuple(x.shape)}")
        if like is not None and x.shape != like[i].shape:
            raise ValueError(f"{name}.{k} is {tuple(x.shape)}, the tangent "
                             f"{tuple(like[i].shape)}")
        if device.type == "cuda" and not x.is_contiguous():
            raise ValueError(f"{name}.{k} must be contiguous")


def _check_edges(g, blocks, weights, device) -> None:
    for edge, inc in INCIDENCE.items():
        w = weights[edge]
        if not torch.is_tensor(w) or w.dtype != torch.float32:
            raise TypeError(f"weights[{edge!r}] must be a float32 tensor, "
                            f"got {getattr(w, 'dtype', type(w).__name__)}")
        if w.dim() != 1 or w.device != device:
            raise ValueError(f"weights[{edge!r}] must be (E,) on {device}, "
                             f"got {tuple(w.shape)} on {w.device}")
        if device.type == "cuda" and w.stride(0) != 1 and w.shape[0] > 1:
            raise ValueError(f"weights[{edge!r}] must be contiguous")
        E = w.shape[0]
        for J, idx_name, kind in inc:
            b, idx = blocks[J], getattr(g, idx_name)
            want = (E, ROWS[edge], WIDTH[kind])
            if not torch.is_tensor(b) or b.dtype != torch.float32:
                raise TypeError(f"blocks[{J!r}] must be a float32 tensor, "
                                f"got {getattr(b, 'dtype', type(b).__name__)}")
            if tuple(b.shape) != want or b.device != device:
                raise ValueError(f"blocks[{J!r}] must be {want} on {device}, "
                                 f"got {tuple(b.shape)} on {b.device}")
            if not torch.is_tensor(idx) or idx.dtype != torch.int64:
                raise TypeError(f"{idx_name} must be an int64 tensor, got "
                                f"{getattr(idx, 'dtype', type(idx).__name__)}")
            if tuple(idx.shape) != (E,) or idx.device != device:
                raise ValueError(f"{idx_name} must be ({E},) on {device}, "
                                 f"got {tuple(idx.shape)} on {idx.device}")
            if device.type == "cuda" and idx.stride(0) != 1 and E > 1:
                raise ValueError(f"{idx_name} must be contiguous")


def _device(t: tuple):
    device = t[0].device if torch.is_tensor(t[0]) else None
    if device is None or device.type not in ("cpu", "cuda"):
        raise ValueError(f"the edge Hessian product runs on cuda or cpu, "
                         f"got {device}")
    return device


def _check_array(name: str, x, dtype, tail: tuple, device,
                 rows: int | None = None) -> None:
    """x: a `dtype` tensor of shape (rows, *tail) (any rows where None) on
    device, contiguous where it goes to a kernel."""
    if not torch.is_tensor(x) or x.dtype != dtype:
        raise TypeError(f"{name} must be a {dtype} tensor, got "
                        f"{getattr(x, 'dtype', type(x).__name__)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, not {device}")
    if (x.dim() != 1 + len(tail) or tuple(x.shape[1:]) != tail
            or rows is not None and x.shape[0] != rows):
        raise ValueError(f"{name} must be ({rows if rows is not None else 'n'}"
                         f"{''.join(', ' + str(n) for n in tail)}), got "
                         f"{tuple(x.shape)}")
    if device.type == "cuda" and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_large(g, v, device) -> None:
    """The variables and the obs and ter edge fields that `linearize` and
    `evaluate` read."""
    for k, tail in (("poses", (4, 4)), ("motions", (4, 4)), ("points", (3,))):
        _check_array(f"v.{k}", getattr(v, k), torch.float32, tail, device)
    for edge in LARGE:
        w = getattr(g, edge + "_w")
        _check_array(f"{edge}_w", w, torch.float32, (), device)
        for _, idx, _ in INCIDENCE[edge]:
            _check_array(idx, getattr(g, idx), torch.int64, (), device,
                         w.shape[0])
    _check_array("obs_meas", g.obs_meas, torch.float32, (3,), device,
                 g.obs_w.shape[0])


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

class _Inc(ctypes.Structure):
    """struct HvInc of the source."""
    _fields_ = [("J", ctypes.c_void_p), ("sJ", ctypes.c_longlong * 3),
                ("idx", ctypes.c_void_p), ("x", ctypes.c_void_p),
                ("y", ctypes.c_void_p), ("n_rows", ctypes.c_longlong)]


class _Edges(ctypes.Structure):
    """struct HvEdges of the source, passed to the launch by value."""
    _fields_ = [("inc", _Inc * 3), ("w", ctypes.c_void_p),
                ("n_edges", ctypes.c_longlong)]


class _Seg(ctypes.Structure):
    """struct VxSeg of the source."""
    _fields_ = [("A", ctypes.c_void_p), ("sA", ctypes.c_longlong * 3),
                ("d", ctypes.c_void_p), ("x", ctypes.c_void_p),
                ("y", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("w", ctypes.c_int)]


class _Vertex(ctypes.Structure):
    """struct VxArgs of the source, passed to the launch by value."""
    _fields_ = [("seg", _Seg * 3)]


class _LinArgs(ctypes.Structure):
    """struct LinArgs of the source, passed to the launch by value."""
    _fields_ = [("w", ctypes.c_void_p), ("idx", ctypes.c_void_p * 3),
                ("T", ctypes.c_void_p), ("X", ctypes.c_void_p),
                ("meas", ctypes.c_void_p), ("w_out", ctypes.c_void_p),
                ("J", ctypes.c_void_p * 3),
                ("sJ", (ctypes.c_longlong * 3) * 3),
                ("grad", ctypes.c_void_p * 3), ("diag", ctypes.c_void_p * 3),
                ("n_rows", ctypes.c_longlong * 3), ("sums", ctypes.c_void_p),
                ("counts", ctypes.c_void_p), ("n_edges", ctypes.c_longlong),
                ("delta", ctypes.c_float), ("delta2", ctypes.c_float),
                ("two_delta", ctypes.c_float), ("robust", ctypes.c_int)]


class _Counted:
    """A kernel's launch count.

    `launches` goes up by one for each kernel launch and for nothing else
    (the CPU path does not count).  A call made while its stream captures a
    CUDA graph records the launch into the graph without launching it: it
    counts in `captured`, and each replay of that graph adds the launches
    its capture recorded to `launches` (utils/cuda_graph.py)."""

    def __init__(self):
        self.launches = 0
        self.captured = 0

    def _counted(self, n: int, capturing: bool) -> None:
        if capturing:
            self.captured += n
        else:
            self.launches += n


class EdgeHessianKernel(_Counted):
    """The edge kernel (one launch per edge type with edges, per product)
    and the library it lives in.  `build_seconds` and `build_log` (nvcc's
    -Xptxas -v report) are filled when this process built or loaded the
    library."""

    def __init__(self):
        super().__init__()
        self.build_seconds: float | None = None
        self.build_log = ""
        self._lib = None  # the loaded library, kept for its functions' life
        self._lock = threading.Lock()

    def build(self):
        """Compile (if the library for this source is missing) and load;
        returns the library."""
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is not None:
                return self._lib
            t0 = time.time_ns()
            lib_path, log = nvcc_build.build_library(
                _SOURCE, nvcc_build.NVCC_FLAGS, "edge_hessian")
            if log:
                self.build_log = log
            lib = ctypes.CDLL(str(lib_path))
            for fn, size in ((lib.edge_hv_sizeof_edges, _Edges),
                             (lib.edge_hv_sizeof_vertex, _Vertex),
                             (lib.edge_lin_sizeof_args, _LinArgs)):
                fn.restype = ctypes.c_int
                if fn() != ctypes.sizeof(size):
                    raise RuntimeError(
                        f"struct {size.__name__} is {fn()} bytes in the "
                        f"library, {ctypes.sizeof(size)} here")
            lib.edge_hv_launch.argtypes = [ctypes.c_int, _Edges,
                                           ctypes.c_void_p]
            lib.edge_hv_launch.restype = ctypes.c_int
            lib.vertex_pass_launch.argtypes = [_Vertex, ctypes.c_void_p]
            lib.vertex_pass_launch.restype = ctypes.c_int
            lib.edge_lin_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                            _LinArgs, ctypes.c_void_p]
            lib.edge_lin_launch.restype = ctypes.c_int
            lib.mirror_launch.argtypes = [_Vertex, ctypes.c_void_p]
            lib.mirror_launch.restype = ctypes.c_int
            t1 = time.time_ns()
            self.build_seconds = (t1 - t0) / 1e9
            # imported here: utils/ imports this module
            from ..utils import profiling
            rec = profiling.ACTIVE
            if rec is not None:
                rec.add("setup.edge_hessian_build", t0, t1, "edge_hessian")
            self._lib = lib
        return self._lib

    def launch(self, edge: str, g, blocks, weights, t: tuple, out: tuple,
               stream: int) -> bool:
        """One launch for `edge`'s edges, adding into `out`; False where
        the type has no edges (nothing launched)."""
        inc = INCIDENCE[edge]
        w = weights[edge]
        if w.shape[0] == 0:
            return False
        rows = dict(zip(KINDS, out))
        args = _Edges(w=w.data_ptr(), n_edges=w.shape[0])
        xs = dict(zip(KINDS, t))
        for k, (J, idx, kind) in enumerate(inc):
            b = blocks[J]
            args.inc[k] = _Inc(b.data_ptr(), (ctypes.c_longlong * 3)(
                *b.stride()), getattr(g, idx).data_ptr(),
                xs[kind].data_ptr(), rows[kind].data_ptr(),
                rows[kind].shape[0])
        err = self.build().edge_hv_launch(_VARIANT[edge], args, stream)
        if err != 0:
            raise RuntimeError(f"edge_hv_launch ({edge}) failed: "
                               f"cudaError_t {err}")
        return True


class VertexPassKernel(_Counted):
    """The per-vertex passes (one launch each over poses, motions and
    points): the product's start and the block-Jacobi apply (`launch`),
    and the lower triangles of the linearisation's blocks (`mirror`)."""

    def launch(self, out: tuple, x: tuple, d: tuple | None = None,
               A: tuple | None = None, stream: int = 0) -> bool:
        """out = d * x (zeros where d is None), or out = A x; one launch;
        False where there are no rows (nothing launched)."""
        args = _Vertex()
        for k, kind in enumerate(KINDS):
            a = None if A is None else A[k]
            args.seg[k] = _Seg(
                0 if a is None else a.data_ptr(),
                (ctypes.c_longlong * 3)(*(a.stride() if a is not None
                                          else (0, 0, 0))),
                0 if d is None else d[k].data_ptr(),
                x[k].data_ptr(), out[k].data_ptr(), out[k].shape[0],
                WIDTH[kind])
        if not sum(o.numel() for o in out):
            return False
        err = KERNEL.build().vertex_pass_launch(args, stream)
        if err != 0:
            raise RuntimeError(f"vertex_pass_launch failed: cudaError_t "
                               f"{err}")
        return True


    def mirror(self, blocks: tuple, stream: int) -> bool:
        """Each (n, w, w) block of (poses, motions, points) made symmetric
        from its upper triangle, in place; one launch; False where there
        are no rows (nothing launched)."""
        args = _Vertex()
        for k, (kind, b) in enumerate(zip(KINDS, blocks)):
            args.seg[k] = _Seg(0, (ctypes.c_longlong * 3)(0, 0, 0), 0, 0,
                               b.data_ptr(), b.shape[0], WIDTH[kind])
        if not sum(b.numel() for b in blocks):
            return False
        err = KERNEL.build().mirror_launch(args, stream)
        if err != 0:
            raise RuntimeError(f"mirror_launch failed: cudaError_t {err}")
        return True


class EdgeLinearizeKernel(_Counted):
    """The linearise and evaluate kernels of the obs and ter edges (one
    launch per type with edges, per call), in KERNEL's library."""

    def launch(self, edge: str, evaluate: bool, args: _LinArgs,
               stream: int) -> None:
        err = KERNEL.build().edge_lin_launch(_LIN_VARIANT[edge],
                                             int(evaluate), args, stream)
        if err != 0:
            raise RuntimeError(f"edge_lin_launch ({edge}, evaluate="
                               f"{evaluate}) failed: cudaError_t {err}")


KERNEL = EdgeHessianKernel()
VERTEX = VertexPassKernel()
LIN = EdgeLinearizeKernel()


def _vertex(x: tuple, **kw) -> tuple:
    """One vertex pass into fresh outputs shaped like x, counted."""
    out = tuple(torch.empty_like(a, memory_format=torch.contiguous_format)
                for a in x)
    with torch.cuda.device(out[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        n = VERTEX.launch(out, x, stream=stream, **kw)
        VERTEX._counted(int(n), torch.cuda.is_current_stream_capturing())
    return out


# --------------------------------------------------------------------------
# the wrapper's functions
# --------------------------------------------------------------------------

def hessian_vector(g, blocks, weights, t, damp=None) -> tuple:
    """(poses, motions, points) of J^T W J t, plus damp * t where `damp`
    is given (module docstring)."""
    x = _rows(t)
    device = _device(x)
    _check_rows("t", x, device)
    dr = None if damp is None else _rows(damp)
    if dr is not None:
        _check_rows("damp", dr, device, like=x)
    _check_edges(g, blocks, weights, device)
    if device.type == "cpu":
        h = matvec_plain(g, blocks, weights, t)
        return h if damp is None else damped_plain(h, damp, t)
    out = _vertex(x, d=dr)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        n = sum(KERNEL.launch(edge, g, blocks, weights, x, out, stream)
                for edge in INCIDENCE)
        KERNEL._counted(n, torch.cuda.is_current_stream_capturing())
    return out


def block_jacobi(Dinv, r) -> tuple:
    """(poses, motions, points) of Dinv r, row block by row block."""
    x = _rows(r)
    device = _device(x)
    _check_rows("r", x, device)
    for k, (kind, A) in enumerate(zip(KINDS, Dinv, strict=True)):
        W = WIDTH[kind]
        if not torch.is_tensor(A) or A.dtype != torch.float32:
            raise TypeError(f"Dinv.{kind} must be a float32 tensor, got "
                            f"{getattr(A, 'dtype', type(A).__name__)}")
        if tuple(A.shape) != (x[k].shape[0], W, W) or A.device != device:
            raise ValueError(f"Dinv.{kind} must be "
                             f"{(x[k].shape[0], W, W)} on {device}, got "
                             f"{tuple(A.shape)} on {A.device}")
    if device.type == "cpu":
        return precond_plain(Dinv, r)
    return _vertex(x, A=tuple(Dinv))


def _lin_args(edge: str, g, v, delta: float, robust: bool) -> _LinArgs:
    """The fields of one large edge type's launch that both kernels read."""
    w = getattr(g, edge + "_w")
    args = _LinArgs(w=w.data_ptr(), T=getattr(v, _LIN_ROWS[edge]).data_ptr(),
                    X=v.points.data_ptr(),
                    meas=g.obs_meas.data_ptr() if edge == "obs" else None,
                    n_edges=w.shape[0], delta=delta, delta2=delta * delta,
                    two_delta=2.0 * delta, robust=int(robust))
    for k, (_, idx, _) in enumerate(INCIDENCE[edge]):
        args.idx[k] = getattr(g, idx).data_ptr()
    return args


def linearize(g, v, delta: float, robust: bool) -> tuple:
    """(weights, blocks, gradient, block diagonal) of the obs and ter edges
    at the variables v, Huber delta `delta` (module docstring): weights
    {"obs", "ter"}, blocks {"Jo_pose", "Jo_pt", "Jt_prev", "Jt_cur",
    "Jt_mot"}, the gradient J^T W r as rows (poses, motions, points) and
    the undamped block diagonal of J^T W J as blocks (poses, motions,
    points).  On a card each block written is a view of a component-major
    buffer (edge stride 1), Jt_prev the expanded identity (edge stride 0),
    and the blocks of a zero-weight edge are left unwritten: nothing reads
    them."""
    device = _device((v.poses,))
    _check_large(g, v, device)
    if device.type == "cpu":
        return linearize_plain(g, v, delta, robust)
    n = _counts(v)
    grad, diag = zero_rows(v.points, n), zero_blocks(v.points, n)
    weights = {edge: torch.empty_like(getattr(g, edge + "_w"))
               for edge in LARGE}

    def soa(E, W):
        return torch.empty(3, W, E, dtype=torch.float32,
                           device=device).permute(2, 0, 1)

    E, Et = g.obs_w.shape[0], g.ter_w.shape[0]
    blocks = {"Jo_pose": soa(E, 6), "Jo_pt": soa(E, 3),
              "Jt_prev": _eye(3, g.ter_w, Et), "Jt_cur": soa(Et, 3),
              "Jt_mot": soa(Et, 6)}
    rows = dict(zip(KINDS, zip(grad, diag)))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        n = 0
        for edge in LARGE:
            if not weights[edge].shape[0]:
                continue
            args = _lin_args(edge, g, v, delta, robust)
            args.w_out = weights[edge].data_ptr()
            for k, (J, _, kind) in enumerate(INCIDENCE[edge]):
                b = blocks[J]
                if b.stride(0):  # written; the identity is not
                    args.J[k] = b.data_ptr()
                    args.sJ[k] = (ctypes.c_longlong * 3)(*b.stride())
                args.grad[k] = rows[kind][0].data_ptr()
                args.diag[k] = rows[kind][1].data_ptr()
                args.n_rows[k] = rows[kind][0].shape[0]
            LIN.launch(edge, False, args, stream)
            n += 1
        LIN._counted(n, capturing)
        VERTEX._counted(int(VERTEX.mirror(diag, stream)), capturing)
    return weights, blocks, grad, diag


def evaluate(g, v, delta: float, robust: bool) -> dict:
    """{"obs": sums, "ter": sums} at the variables v, Huber delta `delta`:
    each edge type's summed Huber cost "rho", and its active edges "n"
    (weight above 0), their summed "chi2" and their inliers "n_inlier"
    (chi2 <= delta^2), as 0-dim tensors (the counts int64)."""
    device = _device((v.poses,))
    _check_large(g, v, device)
    if device.type == "cpu":
        return evaluate_plain(g, v, delta, robust)
    sums = torch.zeros(len(LARGE), 2, dtype=torch.float32, device=device)
    counts = torch.zeros(len(LARGE), 2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        n = 0
        for i, edge in enumerate(LARGE):
            if not getattr(g, edge + "_w").shape[0]:
                continue
            args = _lin_args(edge, g, v, delta, robust)
            args.sums, args.counts = sums[i].data_ptr(), counts[i].data_ptr()
            LIN.launch(edge, True, args, stream)
            n += 1
        LIN._counted(n, torch.cuda.is_current_stream_capturing())
    return {edge: {"rho": sums[i, 0], "n": counts[i, 0], "chi2": sums[i, 1],
                   "n_inlier": counts[i, 1]} for i, edge in enumerate(LARGE)}
