"""CUDA graphs of the port's fixed-shape programs: the counterpart of the
JAX package's compiled step and window-solve warmup.

The JAX package never runs its hot path op by op.  The tracker's packed
step (`jax.jit(_step)`, vdo_slam_tpu/pipeline/fused.py:124), its C-frame
chunk (fused.py:133-144), the S-stream step (`jax.jit(vmap(one))`,
vdo_slam_tpu/parallel/multisystem.py:55), the window solve at each shape
tier (`warmup_window_ba`, vdo_slam_tpu/backend/window_ba.py:43-56), the
full BA's chunk (`warmup_full_ba`, vdo_slam_tpu/backend/full_ba.py:73-88)
and each stage of the host Tracker (vdo_slam_tpu/pipeline/stages.py) are
each one executable, compiled once for their fixed shapes and executed
per call.  On a card the port does the same with a `torch.cuda.CUDAGraph`:

  * the first call runs the function eagerly on a side stream: the warm-up,
    which makes the library handles and workspaces, loads the FAST kernel's
    module and fills the allocator before anything is captured;
  * the second call captures it (on a stream of its own, in a memory pool
    of its own, `capture_error_mode="thread_local"` so that the tracking
    thread and the solve threads never make each other's capture illegal)
    and replays it;
  * every later call replays it: one host call launches the whole program.

The function reads static input buffers (`StaticTree`), which the caller
fills by copies queued on the stream the graph replays on, and returns
static outputs, which the next call overwrites: a caller copies out what it
keeps.  `StepGraph` holds a tracking step's state in static buffers, which
the captured step updates in place; `GraphedStage` copies a call's tensor
arguments into static buffers of its own (the host Tracker's stages).

On the CPU (device="cpu", as the tests run) the same objects run the
function eagerly on the same static buffers and copy its outputs into
static output buffers, so the tests reach the buffer handling, the
overwriting of outputs included, that the card runs.

A kernel launched while its stream captures is recorded, not launched:
ops/fast_cuda.py counts it in `captured`, not in `launches`, and each
replay adds the launches its capture recorded to `launches`.

A capture or replay that fails raises.  Nothing falls back to eager
execution.  Python's garbage collector is off during a capture: a graph
it collects there would be destroyed inside the capture, which CUDA
refuses.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time

import numpy as np
import torch

from ..ops.fast_cuda import KERNEL
from . import profiling

Tensor = torch.Tensor

# the kernels written by hand whose wrappers count launches
KERNELS = (KERNEL,)
# one capture at a time in the process: a capture on a solve thread and one
# on the tracking thread never overlap
_CAPTURE_LOCK = threading.Lock()
# byte alignment of each leaf in a StaticTree's buffer
_ALIGN = 16


# --------------------------------------------------------------------------
# trees of tensors
# --------------------------------------------------------------------------

def tree_flatten(tree) -> tuple[list, object]:
    """(leaves, spec) of a nesting of dataclasses, dicts, lists and tuples
    whose leaves are tensors or numpy arrays."""
    leaves = []

    def walk(x):
        if torch.is_tensor(x) or isinstance(x, np.ndarray):
            leaves.append(x)
            return None
        if dataclasses.is_dataclass(x):
            return type(x), tuple((f.name, walk(getattr(x, f.name)))
                                  for f in dataclasses.fields(x))
        if isinstance(x, dict):
            return dict, tuple((k, walk(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x), tuple((None, walk(v)) for v in x)
        raise TypeError(f"not a tree of tensors: {type(x).__name__}")

    return leaves, walk(tree)


def tree_unflatten(spec, leaves):
    """Inverse of tree_flatten."""
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, items = s
        if kind is dict:
            return {k: build(c) for k, c in items}
        if kind in (list, tuple):
            return kind(build(c) for _, c in items)
        return kind(**{k: build(c) for k, c in items})

    return build(spec)


def copy_all(dsts: list, srcs: list, non_blocking: bool = False) -> None:
    """dst.copy_(src) for each pair, in few launches: the pairs whose source
    has its destination's shape and is contiguous are copied by one
    `torch._foreach_copy_` per source and destination dtype (one kernel
    each on a card), the rest one by one; a source that is its destination
    is skipped."""
    groups, rest = {}, []
    for dst, src in zip(dsts, srcs, strict=True):
        if src.data_ptr() == dst.data_ptr() and src.dtype == dst.dtype \
                and src.shape == dst.shape and src.stride() == dst.stride():
            continue
        if (src.shape == dst.shape and src.is_contiguous()
                and src.device == dst.device):
            groups.setdefault((src.dtype, dst.dtype), ([], []))
            groups[src.dtype, dst.dtype][0].append(dst)
            groups[src.dtype, dst.dtype][1].append(src)
        else:
            rest.append((dst, src))
    for d, s in groups.values():
        torch._foreach_copy_(d, s, non_blocking=non_blocking)
    for dst, src in rest:
        dst.copy_(src, non_blocking=non_blocking)


def copy_out(tree):
    """A copy of a tree of tensors on one device, made by ONE copy (their
    bytes concatenated, the widest dtypes first so that every leaf stays
    aligned): later writes to the tree's tensors, a graph's next replay
    among them, leave it alone."""
    leaves, spec = tree_flatten(tree)
    order = sorted(range(len(leaves)),
                   key=lambda i: -leaves[i].element_size())
    flat = torch.cat([leaves[i].reshape(-1).view(torch.uint8)
                      for i in order])
    out, o = [None] * len(leaves), 0
    for i in order:
        x = leaves[i]
        n = x.numel() * x.element_size()
        out[i] = flat[o:o + n].view(x.dtype).reshape(x.shape)
        o += n
    return tree_unflatten(spec, out)


def _nbytes(dtype, shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) * torch.empty(
        0, dtype=dtype).element_size()


class StaticTree:
    """A tree of tensors at fixed addresses: every leaf is a view into ONE
    byte buffer on `device`, at an offset fixed by the leaves' dtypes and
    shapes.  A graph captured over `tree` reads and writes these views.

    `load` copies a tree of the same structure in (one copy where the
    source is laid out the same way in one buffer, as a `snapshot` is);
    `load_host` copies host arrays in through one pinned buffer and one
    transfer; `snapshot` copies the buffer out (one copy) as a tree of its
    own, which later writes leave alone; `write` copies a step's new values
    in, inside the captured function."""

    def __init__(self, like, device):
        leaves, self.spec = tree_flatten(like)
        self.meta = [(x.dtype if torch.is_tensor(x)
                      else torch.from_numpy(np.asarray(x)[:0]).dtype,
                      tuple(x.shape)) for x in leaves]
        self.offsets, off = [], 0
        for dtype, shape in self.meta:
            self.offsets.append(off)
            off += -(-_nbytes(dtype, shape) // _ALIGN) * _ALIGN
        self.nbytes = off
        self.device = torch.device(device)
        self.flat = torch.zeros(max(off, _ALIGN), dtype=torch.uint8,
                                device=self.device)
        self.leaves = self._views(self.flat)
        self.tree = tree_unflatten(self.spec, self.leaves)

    def _views(self, flat: Tensor) -> list[Tensor]:
        return [flat[o:o + _nbytes(dt, sh)].view(dt).view(sh)
                for o, (dt, sh) in zip(self.offsets, self.meta)]

    def _same_layout(self, src: list) -> Tensor | None:
        """The byte buffer under `src` where its leaves lie in one storage
        at this tree's offsets with this tree's dtypes and shapes, else
        None."""
        if len(src) != len(self.meta) or not all(
                torch.is_tensor(x) for x in src):
            return None
        storage = src[0].untyped_storage()
        base = src[0].data_ptr() - self.offsets[0]
        for x, o, (dt, sh) in zip(src, self.offsets, self.meta):
            if (x.untyped_storage().data_ptr() != storage.data_ptr()
                    or x.dtype != dt or tuple(x.shape) != sh
                    or not x.is_contiguous() or x.data_ptr() != base + o):
                return None
        start = base - storage.data_ptr()
        if start < 0 or start + self.nbytes > storage.nbytes():
            return None
        flat = torch.empty(0, dtype=torch.uint8, device=src[0].device)
        return flat.set_(storage, start, (self.nbytes,))

    def load(self, tree) -> None:
        """Copy `tree` (tensors on this device) into the buffers, queued on
        the current stream."""
        src, _ = tree_flatten(tree)
        flat = self._same_layout(src)
        if flat is not None:
            if flat.data_ptr() != self.flat.data_ptr():
                self.flat[:self.nbytes].copy_(flat, non_blocking=True)
            return
        if len(src) != len(self.leaves):
            raise ValueError(f"a tree of {len(src)} leaves loaded into one "
                             f"of {len(self.leaves)}")
        copy_all(self.leaves, [torch.as_tensor(x) for x in src],
                 non_blocking=True)

    def load_host(self, tree) -> None:
        """Copy `tree` (numpy arrays or CPU tensors, each of its leaf's
        shape or broadcast to it, cast to its dtype) into the buffers: on a
        card through one pinned host buffer and ONE transfer, queued on the
        current stream."""
        if self.device.type != "cuda":
            self.load(tree)
            return
        src, _ = tree_flatten(tree)
        if len(src) != len(self.leaves):
            raise ValueError(f"a tree of {len(src)} leaves loaded into one "
                             f"of {len(self.leaves)}")
        host = torch.empty(self.nbytes, dtype=torch.uint8, pin_memory=True)
        for dst, x in zip(self._views(host), src):
            dst.copy_(torch.as_tensor(x))
        self.flat[:self.nbytes].copy_(host, non_blocking=True)

    def snapshot(self):
        """A copy of the buffers as a tree of its own (one device copy)."""
        return tree_unflatten(self.spec, self._views(self.flat.clone()))

    def write(self, tree) -> None:
        """Copy a step's new values in.  A new value that reads these
        buffers (a leaf passed through, or a view of one) is copied out
        first, so that no write changes a value still to be written; a leaf
        passed through unchanged is left where it is."""
        src, _ = tree_flatten(tree)
        mine = self.flat.untyped_storage().data_ptr()
        moves = []
        for dst, x in zip(self.leaves, src):
            if x.untyped_storage().data_ptr() != mine:
                moves.append((dst, x))
            elif x.data_ptr() != dst.data_ptr() or x.stride() != dst.stride():
                moves.append((dst, x.clone()))
        copy_all([d for d, _ in moves], [x for _, x in moves])


# --------------------------------------------------------------------------
# one captured function
# --------------------------------------------------------------------------

class GraphedCall:
    """fn() over static buffers, captured once on a card and replayed.

    Call 1 runs fn eagerly on a side stream (the warm-up) and returns its
    outputs, fresh tensors.  Call 2 captures fn and replays it, and every
    later call replays it: from call 2 on, the outputs are the captured
    ones, which every replay overwrites.  On the CPU every call runs fn and
    copies its outputs into static output buffers, which it returns.

    `record` (after the capture) holds what a capture cost: seconds of the
    warm-up and of the capture, the bytes the graph's pool reserved, and
    the launches of each hand-written kernel per replay and in the
    warm-up; `replays` counts the replays, the capture's own included.
    `lock` is for callers that share one graph between threads: a graph
    must never be replayed while it runs, nor its outputs read after the
    next replay.

    `pool` (torch.cuda.graph_pool_handle()) puts the graph in a memory
    pool that other graphs share; such graphs must be replayed in the
    order they were captured, never at once (a later capture may reuse
    what an earlier graph frees).  None: a pool of the graph's own."""

    def __init__(self, fn, device, name: str, pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.name = name
        self.pool = pool
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out = None
        self.warm_s: float | None = None
        self.record: dict | None = None
        self.replays = 0
        self.lock = threading.Lock()
        self._kernel_launches: list = []
        self._warm_launches: dict = {}
        self._static_out: StaticTree | None = None

    def __call__(self):
        if self.device.type != "cuda":
            out = self.fn()
            if self._static_out is None:
                self._static_out = StaticTree(out, self.device)
            self._static_out.load(out)
            return self._static_out.tree
        with torch.cuda.device(self.device):
            if self.warm_s is None:
                return self._warm()
            if self.graph is None:
                self._capture()
            self.graph.replay()
        self.replays += 1
        for kernel, n in self._kernel_launches:
            kernel.launches += n
        return self.out

    def _warm(self):
        """The first call: fn eagerly on a side stream, its outputs handed
        to the current stream."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        before = [k.launches for k in KERNELS]
        t0 = time.time_ns()
        with torch.cuda.stream(side):
            out = self.fn()
        cur.wait_stream(side)
        self._warm_launches = {type(k).__name__: k.launches - n
                               for k, n in zip(KERNELS, before)
                               if k.launches > n}
        for x in tree_flatten(out)[0]:
            x.record_stream(cur)
        t1 = time.time_ns()
        self.warm_s = (t1 - t0) / 1e9
        rec = profiling.ACTIVE
        if rec is not None:
            rec.add("setup.warm", t0, t1, self.name)
        return out

    def _capture(self) -> None:
        cur = torch.cuda.current_stream(self.device)
        with _CAPTURE_LOCK:
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(cur)
            graph = torch.cuda.CUDAGraph()
            before = [k.captured for k in KERNELS]
            reserved = torch.cuda.memory_reserved(self.device)
            t0 = time.time_ns()
            # no garbage collection during the capture: a collected graph's
            # destructor (cudaGraphExecDestroy) is not permitted while this
            # thread captures, and invalidates the capture
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.stream(stream):
                    graph.capture_begin(pool=self.pool,
                                        capture_error_mode="thread_local")
                    try:
                        out = self.fn()
                    finally:
                        # ends the capture whatever fn did; an error fn
                        # raised propagates, else one capture_end raises
                        graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            t1 = time.time_ns()
        self._kernel_launches = [(k, k.captured - n)
                                 for k, n in zip(KERNELS, before)
                                 if k.captured > n]
        self.graph, self.out = graph, out
        self.record = {
            "name": self.name, "device": str(self.device),
            "warm_s": self.warm_s, "capture_s": (t1 - t0) / 1e9,
            "pool_reserved_bytes":
                torch.cuda.memory_reserved(self.device) - reserved,
            "kernel_launches_per_replay": {
                type(k).__name__: n for k, n in self._kernel_launches},
            "kernel_launches_warm": self._warm_launches}
        rec = profiling.ACTIVE
        if rec is not None:
            rec.add("setup.capture", t0, t1, self.name)


class GraphedStage:
    """fn(*args, **consts) as a GraphedCall over static input buffers: the
    general form of a program whose inputs change from call to call.

    The first call lays out a StaticTree like `args` (tensors on `device`,
    in dataclasses, dicts, lists and tuples); every call copies `args` in
    (few launches, queued on the current stream) and calls its GraphedCall,
    so call 1 runs fn eagerly, call 2 captures it and later calls replay it
    on a card, and the outputs are static, overwritten by the next call.
    `consts` are passed to fn as they are: on a card the capture bakes
    them in, so every call must pass the same objects (a draws object over
    static buffers, say), and another object raises; on the CPU each call
    passes its own.  Arguments of other dtypes or shapes than the first
    call's raise."""

    def __init__(self, fn, device, name: str):
        self.fn = fn
        self.device = torch.device(device)
        self.name = name
        self.inputs: StaticTree | None = None
        self.call = GraphedCall(self._run, self.device, name)
        self._consts: dict | None = None

    def _run(self):
        return self.fn(*self.inputs.tree, **self._consts)

    def __call__(self, *args, **consts):
        leaves, spec = tree_flatten(args)
        if self.inputs is None:
            self.inputs = StaticTree(args, self.device)
        meta = [(x.dtype, tuple(x.shape)) for x in leaves]
        if spec != self.inputs.spec or meta != self.inputs.meta:
            raise ValueError(f"{self.name}: called with other dtypes or "
                             f"shapes than its first call's")
        if self.device.type == "cuda" and self._consts is not None and (
                consts.keys() != self._consts.keys()
                or any(v is not self._consts[k] for k, v in consts.items())):
            raise ValueError(f"{self.name}: its graph holds the objects of "
                             f"its first call ({sorted(self._consts)}); "
                             f"another was passed")
        self._consts = consts
        self.inputs.load(args)
        return self.call()


# --------------------------------------------------------------------------
# a tracking step with its state in static buffers
# --------------------------------------------------------------------------

class StepGraph:
    """A tracking step with its state held in static buffers: the port's
    form of the JAX package's jitted packed step.

    `step(state, inputs, uniforms, initialized) -> (state, out)` is the
    eager step, of one stream or (`streams`) of S at once, the draws then
    broadcast over the streams.  The state lives in
    `state` (a StaticTree), which the step updates in place.  A call
    copies the frame's staged inputs (tensors on the device) and its draws
    (host tensors: one pinned transfer) into static buffers, then runs the
    frame-0 initialization eagerly (the JAX package's lax.cond picks it by
    the state's flag; here the flag is a host bool) or the track body from
    its graph, and returns `out`: a fresh tensor after the initialization,
    the graph's static output after a tracked frame, overwritten by the
    next call either way on the card."""

    def __init__(self, step, state, device, name: str,
                 streams: int | None = None):
        self.step = step
        self.streams = streams
        self.device = torch.device(device)
        self.state = StaticTree(state, self.device)
        self.state.load(state)
        self.inputs: StaticTree | None = None
        self.draws: StaticTree | None = None
        self.track = GraphedCall(lambda: self._run(True), self.device, name)

    def _run(self, initialized: bool):
        state, out = self.step(self.state.tree, self.inputs.tree,
                               self.draws.tree, initialized)
        self.state.write(state)
        return out

    def __call__(self, inputs: dict, uniforms: dict, initialized: bool):
        """inputs: the frame's staged tensors on the device; uniforms: its
        draws (pipeline/draws.py:frame_uniforms on the CPU), broadcast over
        a leading stream dimension where the step has one."""
        if self.inputs is None:
            self.inputs = StaticTree(inputs, self.device)
            lead = () if self.streams is None else (self.streams,)
            self.draws = StaticTree(
                {k: torch.empty(lead + tuple(v.shape), dtype=v.dtype)
                 for k, v in uniforms.items()}, self.device)
        self.inputs.load(inputs)
        self.draws.load_host(uniforms)
        if not initialized:
            return self._run(False)
        return self.track()
