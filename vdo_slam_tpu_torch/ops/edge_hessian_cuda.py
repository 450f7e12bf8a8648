"""Wrapper of the edge Hessian-vector kernels (csrc/edge_hessian.cu): the
product H t = J^T W J t that the full BA's PCG takes at every step, and the
block-Jacobi apply beside it.

  * `hessian_vector(g, blocks, weights, t, damp=None)`: (poses, motions,
    points) of H t, plus damp * t where `damp` is given;
  * `block_jacobi(Dinv, r)`: each row block of r times its block of Dinv.

`g` is a factor graph (backend/factor_graph.py:Graph), `blocks` and
`weights` what its linearisation leaves (`_linearize`), `t`, `damp` and
`r` Tangents (anything with poses, motions and points) and `Dinv` the
(poses, motions, points) blocks.  For CUDA tensors `hessian_vector` is one
vertex-pass launch (its output set to damp * t, or to zeros) and one edge
launch per edge type that has edges, all on torch's current stream;
`block_jacobi` is one vertex-pass launch.  For CPU
tensors each runs its plain version (`matvec_plain`, `damped_plain`,
`precond_plain`), the solver's own ops.  Anything else raises: wrong
dtypes, shapes that disagree, strides the kernels do not take, tensors on
another device.  Indices are trusted to lie inside their vertex kind's
rows, as the builders make them.

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
                             (lib.edge_hv_sizeof_vertex, _Vertex)):
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
    """The per-vertex pass (one launch over poses, motions and points)."""

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


KERNEL = EdgeHessianKernel()
VERTEX = VertexPassKernel()


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
