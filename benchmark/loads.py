"""What the traffic kinds share.  A traffic kind is one general generator
per kind of load, driven by a traffic file's parameters: a cell names a
configuration and a traffic file, the file's "kind" names the kind, and
the kind is the file benchmark/kinds/<kind>.py, found by that name as a
per-layer metric's reader is (`KINDS`).  A kind file defines

    run(cfg_file, cfg, traffic, seed, seconds, trace, device, t_start) -> Run
    worlds(cfg_file, cfg, traffic, seed, seconds) -> [Stream]

`worlds` gives each stream's layout and judged frames as `run` makes
them, without the program: benchmark/control.py judges the control on
them.  A kind reaches what it shares here through this module (`loads.X`),
so that a test or a tool that wraps one of them wraps it for every kind.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np

from . import scene as S
# pyramid_px, outputs and WindowTrace are the kinds' (loads.outputs, ...)
from .counting import pyramid_px  # noqa: F401
from .program import PackedFrame, outputs  # noqa: F401
from .trace import WindowTrace  # noqa: F401

KINDS_DIR = Path(__file__).resolve().parent / "kinds"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_file(path: Path, name: str):
    """The module in the file `path`, loaded under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(kind: str, where: Path = KINDS_DIR):
    """The traffic kind `kind`: the module in where/<kind>.py.  An unknown
    kind stops the run, naming the kinds there are."""
    path = where / f"{kind}.py"
    if not path.is_file():
        have = sorted(p.stem for p in where.glob("*.py"))
        raise SystemExit(f"no traffic kind {kind!r}: {where} has the kinds "
                         f"{have}")
    return load_file(path, "benchmark_kind_" + kind.replace("-", "_"))


class Kinds(dict):
    """The kinds' `run` functions by name, each loaded from its file
    (`kind_module`) the first time a run asks for it.  An entry set by
    hand, a kind wrapped for one run (chip_spans.py wraps "drive"), is
    used as it is."""

    def __init__(self, where: Path = KINDS_DIR):
        super().__init__()
        self.where = where

    def __missing__(self, kind: str):
        self[kind] = kind_module(kind, self.where).run
        return self[kind]


KINDS = Kinds()


@dataclasses.dataclass
class Stream:
    """One stream of a run as the reference judges it: its world, the
    frames of its drive that are judged, and the program's answers
    (`program.outputs`), None until the run has read them."""

    layout: object
    judged_frames: list
    outputs: dict | None = None


@dataclasses.dataclass
class Run:
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    e2e: dict = dataclasses.field(default_factory=dict)
    streams: list = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0
    # per-layer inputs
    trace: object = None
    trace_frames: int = 0
    probe: dict | None = None
    window_solve_ms: list = dataclasses.field(default_factory=list)
    fast_px: int = 0

    @property
    def judged_frames(self) -> list:
        """Stream 0's judged frames (chip_spans.py reads them)."""
        return self.streams[0].judged_frames


class _Seq:
    """Frames start .. start + n - 1 as a dataset; `fetched(i)`, where
    given, hears of each fetch (the window's tracer)."""

    def __init__(self, frames, start, n, fetched=None):
        self.frames, self.start, self.n = frames, start, n
        self.fetched = fetched

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.fetched is not None:
            self.fetched(i)
        return self.frames[self.start + i]


def layout_for(cfg_file: dict, cfg, n_frames: int, seed: int):
    """The scene's layout for a drive of n_frames frames (one more is made:
    the last frame has no forward flow); the road runs on past the last
    frame by the world's usual length."""
    sc = cfg_file["scene"]
    F = n_frames + 1
    return S.make_layout(
        num_frames=F, width=cfg.camera.width, height=cfg.camera.height,
        fx=cfg.camera.fx, fy=cfg.camera.fy, seed=seed,
        road_extra=sc["cam_speed"] * F, **sc)


def window_frames(traffic: dict, seconds: float) -> tuple:
    """(warm frames, frames in the measured window) of a run."""
    period = int(traffic["frames_multiple"])
    n = max(period, int(round(seconds * traffic["planning_fps"]
                              / period)) * period)
    return int(traffic["warm_frames"]), n


def total_frames(traffic: dict, n: int) -> int:
    """Frames of a run's drive: warm frames, the window's n and the stage
    probe's one, whether the run traces or not, so that every run of a
    seed sees the same world."""
    return int(traffic["warm_frames"]) + n + 1


def traced_stretch(traffic: dict, n: int) -> tuple:
    """(first frame, frames) of the stretch a traced run traces, counted
    from the window's start: trace_frames frames that end at least
    frames_multiple frames before the window's end (the profiler runs on
    to the end of the call, but the stretch sees no flush), starting on a
    multiple of frames_multiple."""
    m = min(int(traffic["trace_frames"]), n)
    period = int(traffic["frames_multiple"])
    return max(n - m - period, 0) // period * period, m


def _rendered(lay, cfg, device, frames, block):
    """(frame ids, gray, raw depth, flow, mask) blocks on the device."""
    import torch

    R = S.Renderer(lay, device)
    tr = cfg.tracking
    for b0 in range(0, len(frames), block):
        fs = frames[b0:b0 + block]
        out = [R.frame(f) for f in fs]
        depth = torch.stack([o["depth"] for o in out])
        yield (fs, torch.stack([o["gray"] for o in out]),
               S.depth_raw(depth, tr.depth_map_factor, cfg.camera.bf),
               torch.stack([o["flow"] for o in out]),
               torch.stack([o["mask"] for o in out]))


def packed_frames(lay, cfg, device, n: int, block: int = 16) -> list:
    """Frames 0..n-1 on the configuration's entropy wire."""
    from .wire import pack_entropy

    tr = cfg.tracking
    if not (tr.entropy and tr.flow_down == 2 and tr.flow_delta):
        raise ValueError("the drive packs the entropy wire of flow_down 2 "
                         "with flow_delta only")
    out = []
    for fs, gray, draw, flow, mask in _rendered(lay, cfg, device,
                                                list(range(n)), block):
        buf = pack_entropy(gray, draw, flow, mask,
                           256.0 / tr.depth_map_factor, tr.wire_seg_cap,
                           tr.wire_depth_exc_cap).cpu().numpy()
        for j, f in enumerate(fs):
            out.append(PackedFrame(buf[j], lay.T_wc[f].astype(np.float32),
                                   S.obj_rows_kitti(lay, f), S.timestamp(f)))
    return out


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device) -> None:
    import torch

    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    import torch

    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def _failed(reps, expected: int) -> int:
    """Frames with no report or whose camera solve kept no inlier."""
    lost = sum(1 for r in reps if int(r.get("n_inlier_cam", 0)) <= 0)
    return max(expected - len(reps), 0) + lost


def _solve_failures(tracker, since: tuple) -> int:
    """Window solves since `since` = (failures, reports) that raised or
    reported a cost that is not finite."""
    return tracker.ba_failures - since[0] + sum(
        1 for h in tracker.ba_health[since[1]:]
        if not (np.isfinite(h["cost"]) and np.isfinite(h["cost0"])))
