"""Benchmark: the full VDO-SLAM pipeline's throughput on one GPU — a
jax-free port of the repository's bench.py.

    python -m vdo_slam_tpu_torch.bench                   # default mode
    python -m vdo_slam_tpu_torch.bench --hard            # degraded inputs
    python -m vdo_slam_tpu_torch.bench --streams S       # S streams
    python -m vdo_slam_tpu_torch.bench --throughput [--streams S]  # S = 6
    ... [--device cpu]                                   # default cuda

Runs the complete per-frame pipeline (FAST front end, camera RANSAC+LM,
scene-flow classification, per-object motion LM, renewal, a window BA
every 16 frames) and the final full-batch BA on a KITTI-sized (1242x375)
synthetic sequence with exact ground truth, as bench.py does, with
bench.py's scene, config (tpu_fast; fused_chunk from VDO_BENCH_CHUNK; the
fixed full-graph capacities), pre-packed input and timing, and bench.py's
VDO_BENCH_* overrides.

Baseline: the reference C++ binary, run single-threaded on the same
100-frame synthetic sequence end to end (tracking, window BA and the
final full-batch optimization), does 0.249 fps (BASELINE.md).
vs_baseline = measured fps / 0.249.

Prints ONE json line on stdout; everything else goes to stderr.

Against bench.py (deliberate):
- The scene cache on disk is the port's own: numpy arrays in
  `<tempdir>/vdo_torch_bench_scene_<n>_<W>x<H>[_hard].npz`, keyed on the
  values (n_frames, width, height, hard) and loaded without unpickling
  anything (`bench_scene`).  bench.py pickles its scene to /tmp, and that
  pickle holds the JAX package's SyntheticScene; this bench never reads
  it.
- The window solve's warmup is the System's own: on a card it warms and
  captures a CUDA graph of each shape tier when it is made
  (backend/window_ba.py:warmup_window_ba), as bench.py's
  warmup_window_ba compiles them.  The full BA's graphs are warmed and
  captured after the warm frames, on the calling thread, by
  `warmup_full_ba` on the zero-weight graph of the full_* caps, where
  bench.py compiles its program on a background thread during the warm
  frames: the port's threads share the interpreter lock, so a warm-up on
  a thread would slow the warm frames instead of overlapping them.
- A failing stage probe fails the run (bench.py logs it and goes on);
  VDO_BENCH_NO_PROBE=1 still skips it.
- --streams stages the next frame on one uploader thread as bench.py
  does, with the copies bound to the calling thread's CUDA stream on each
  device, so the batched step that reads them is queued after them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import sys
import tempfile
import time
import zipfile

import numpy as np

BASELINE_FPS = 0.249  # the reference C++ end to end on the same input (BASELINE.md)
N_FRAMES = 100
N_STREAM_FRAMES = 40
W, H = 1242, 375
FX, BF, DEPTH_MAP_FACTOR = 721.5377, 387.5744, 256.0
WARM = 3              # bench_multistream's staged warm frames
PROBE_ITERS = 4       # the stage probe's repetitions per span


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def warmup_frames() -> int:
    """Frames run before the timed region: at least one whole fused chunk
    (bench.py:29-33), read from VDO_BENCH_CHUNK when the bench runs."""
    return max(4, int(os.environ.get("VDO_BENCH_CHUNK", "4")))


def bench_scene(n_frames: int = N_FRAMES, width: int = W, height: int = H,
                hard: bool = False):
    """bench.py's scene (bench.py:237-257): n_frames + 1 frames, 3
    objects, seed 7; `hard` degrades its inputs as --hard does (flow sigma
    0.75 px, 1 % outliers, masks eroded and jittered by 1 px, seed 13).
    Made once per process, and cached on disk across processes
    (`scene_cache_path`), as bench.py caches its own (bench.py:69-75)."""
    return _scene(n_frames, width, height, hard)


def scene_cache_path(n_frames: int, width: int, height: int,
                     hard: bool) -> str:
    """Where bench_scene keeps the scene of these values on disk."""
    name = (f"vdo_torch_bench_scene_{n_frames}_{width}x{height}"
            f"{'_hard' if hard else ''}.npz")
    return os.path.join(tempfile.gettempdir(), name)


@functools.lru_cache(maxsize=4)
def _scene(n_frames: int, width: int, height: int, hard: bool):
    from .io.synthetic import SyntheticScene, degrade_scene, make_scene

    path = scene_cache_path(n_frames, width, height, hard)
    fields = [f.name for f in dataclasses.fields(SyntheticScene)]
    t0 = time.perf_counter()
    try:
        with np.load(path, allow_pickle=False) as z:
            scene = SyntheticScene(**{k: z[k] for k in fields})
        log(f"scene loaded from {path} in {time.perf_counter() - t0:.1f}s")
        return scene
    except (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile):
        pass        # absent, or not this layout: make it anew
    if hard:
        scene = degrade_scene(_scene(n_frames, width, height, False),
                              flow_noise_px=0.75, flow_outlier_frac=0.01,
                              mask_erode_px=1, mask_jitter_px=1, seed=13)
    else:
        scene = make_scene(num_frames=n_frames + 1, width=width,
                           height=height, num_objects=3, fx=FX, seed=7)
    log(f"scene made in {time.perf_counter() - t0:.1f}s")
    _write_scene(path, scene, fields)
    return scene


def _write_scene(path: str, scene, fields) -> None:
    """Save the scene's arrays to `path` atomically (a temporary file in the
    same directory, then a rename), so that a process that reads the cache
    never sees half a file.  A cache that cannot be written is skipped."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=".vdo_torch_scene_", suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **{k: getattr(scene, k) for k in fields})
        os.replace(tmp, path)
    except OSError as e:
        log(f"scene cache not written ({e})")
        with contextlib.suppress(OSError):
            os.remove(tmp)


def _base_config(width: int, height: int, **tracking):
    from .config import KITTI, ShapeConfig, TrackingConfig, VDOConfig

    cfg = VDOConfig()
    return cfg.replace(
        camera=dataclasses.replace(
            cfg.camera, fx=FX, fy=FX, cx=width / 2.0, cy=height / 2.0,
            width=width, height=height, bf=BF),
        tracking=dataclasses.replace(
            TrackingConfig(), dataset=KITTI,
            depth_map_factor=DEPTH_MAP_FACTOR, **tracking),
        shapes=ShapeConfig(),
    )


def bench_config(width: int = W, height: int = H):
    """The default and --hard modes' config (bench.py:262-285): the KITTI
    camera, fused_chunk from VDO_BENCH_CHUNK, the fixed full-graph
    capacities, then tpu_fast, then the VDO_BENCH_* overrides."""
    from .config import tpu_fast

    cfg = _base_config(width, height,
                       fused_chunk=int(os.environ.get("VDO_BENCH_CHUNK",
                                                      "4")))
    cfg = cfg.replace(backend=dataclasses.replace(
        cfg.backend, full_obs_cap=245760, full_ter_cap=131072,
        full_point_cap=122880, full_motion_cap=192, full_smo_cap=192))
    return _env_overrides(tpu_fast(cfg))


def multistream_config(width: int = W, height: int = H):
    """bench_multistream's config (bench.py:76-85): the KITTI camera,
    tpu_fast, the VDO_BENCH_* overrides."""
    from .config import tpu_fast

    return _env_overrides(tpu_fast(_base_config(width, height)))


def packed_dataset(scene, cfg):
    """The scene's frames pre-packed under cfg's wire (bench.py:286-301)."""
    from .io.dataset import SyntheticDataset
    from .io.packed_dataset import InMemoryPackedDataset

    tr = cfg.tracking
    return InMemoryPackedDataset(
        SyntheticDataset(scene, depth_map_factor=DEPTH_MAP_FACTOR, bf=BF),
        depth_map_factor=DEPTH_MAP_FACTOR, flow_down=tr.flow_down,
        flow_delta=tr.flow_delta, depth_down=tr.depth_down,
        depth_resid=tr.depth_resid, entropy=tr.entropy,
        seg_cap=tr.wire_seg_cap, depth_exc_cap=tr.wire_depth_exc_cap)


def stream_offsets(n_total: int, n_streams: int,
                   n_frames: int = N_STREAM_FRAMES) -> list[int]:
    """Where each stream's window starts (bench.py:110)."""
    return [(7 * s) % (n_total - n_frames) for s in range(n_streams)]


class _View:
    """n frames of a dataset from `start` (bench.py:100-108)."""

    def __init__(self, base, start: int, n: int):
        self.base, self.start, self.n = base, start, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.base[self.start + i]


def _env_overrides(cfg):
    """VDO_BENCH_* env knobs for A/B experiments (bench.py:171-213): the
    same knobs, onto the same fields."""
    tr, so, be = {}, {}, {}
    env = os.environ
    if "VDO_BENCH_FLOW_DOWN" in env:
        tr["wire_flow_down"] = int(env["VDO_BENCH_FLOW_DOWN"])
    if "VDO_BENCH_DEPTH_DOWN" in env:
        tr["wire_depth_down"] = int(env["VDO_BENCH_DEPTH_DOWN"])
    if "VDO_BENCH_DEPTH_RESID" in env:
        tr["wire_depth_resid"] = int(env["VDO_BENCH_DEPTH_RESID"])
    if "VDO_BENCH_ENTROPY" in env:
        tr["wire_entropy"] = bool(int(env["VDO_BENCH_ENTROPY"]))
    if "VDO_BENCH_DRAIN" in env:
        tr["fused_drain_chunks"] = int(env["VDO_BENCH_DRAIN"])
    if "VDO_BENCH_MASK_PROP" in env:
        tr["fused_mask_prop"] = bool(int(env["VDO_BENCH_MASK_PROP"]))
    if "VDO_BENCH_CAM_ITERS" in env:
        so["lm_iters"] = int(env["VDO_BENCH_CAM_ITERS"])
    if "VDO_BENCH_OBJ_ITERS" in env:
        so["lm_iters_obj"] = int(env["VDO_BENCH_OBJ_ITERS"])
    if "VDO_BENCH_REFIT" in env:
        so["refit_init"] = bool(int(env["VDO_BENCH_REFIT"]))
    if "VDO_BENCH_FULL_ITERS" in env:
        be["full_iters"] = int(env["VDO_BENCH_FULL_ITERS"])
    if "VDO_BENCH_FULL_CHUNK" in env:
        be["full_ba_chunk"] = int(env["VDO_BENCH_FULL_CHUNK"])
    if "VDO_BENCH_CG_UNROLL" in env:
        be["cg_unroll"] = int(env["VDO_BENCH_CG_UNROLL"])
    if "VDO_BENCH_LOCAL_UNROLL" in env:
        be["local_unroll"] = int(env["VDO_BENCH_LOCAL_UNROLL"])
    if "VDO_BENCH_LOCAL_ITERS" in env:
        be["local_iters"] = int(env["VDO_BENCH_LOCAL_ITERS"])
    if tr:
        cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, **tr))
    if so:
        cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, **so))
    if be:
        cfg = cfg.replace(backend=dataclasses.replace(cfg.backend, **be))
    if tr or so or be:
        log(f"env overrides: tracking={tr} solver={so} backend={be}")
    return cfg


def metric_name(hard: bool = False, n_streams: int | None = None,
                tag: str = "") -> str:
    """The metric of bench.py's JSON line (bench.py:158, 432-433)."""
    if n_streams is not None:
        return f"kitti_synth_multistream{n_streams}{tag}_aggregate_fps"
    return "kitti_synth_hard_fps" if hard else "kitti_synth_full_pipeline_fps"


def _record(name: str, fps: float) -> dict:
    rec = {"metric": name, "value": round(fps, 3), "unit": "frames/sec",
           "vs_baseline": round(fps / BASELINE_FPS, 3)}
    print(json.dumps(rec))
    return rec


def _device(device):
    """`device` as a torch device; a CUDA device without a card raises."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu (device="
                               "'cpu') to run the bench on the CPU")
        log(f"device: {torch.cuda.get_device_name(device)}")
    else:
        log(f"device: {device}")
    return device


def card_line(device) -> str:
    """The card as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives it, for a CUDA device; else the device."""
    import subprocess

    if device.type != "cuda":
        return str(device)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[device.index or 0]


def on_callers_streams(devices, fn):
    """fn, for another thread, run on this thread's current CUDA stream of
    each of `devices`: the copies it queues are then ordered before the
    work that this thread queues after it returns."""
    import torch

    streams = [torch.cuda.current_stream(d) for d in devices
               if d.type == "cuda"]

    def run(*a):
        with contextlib.ExitStack() as stack:
            for s in streams:
                stack.enter_context(torch.cuda.stream(s))
            return fn(*a)
    return run


def _capture_seconds(graphs) -> float:
    """Seconds the warm-ups and captures of `graphs` (WindowGraphs or
    FullBAGraphs objects) took."""
    return sum(r["warm_s"] + r["capture_s"] for wg in graphs
               for r in wg.records())


def bench_multistream(n_streams: int, n_frames: int = N_STREAM_FRAMES,
                      tag: str = "", device="cuda",
                      scene_frames: int = N_FRAMES, width: int = W,
                      height: int = H) -> dict:
    """Aggregate-throughput mode (--streams S, bench.py:40-162): S complete
    pipelines (per-stream MapState archive, window BA every 16 frames,
    per-stream metric reports) whose per-frame device work is ONE batched
    step on the device (MultiStreamSystem).  Each stream tracks its own
    window of the sequence.  Returns the JSON record and the system."""
    from concurrent.futures import ThreadPoolExecutor

    from .parallel import MultiStreamSystem

    device = _device(device)
    t0 = time.perf_counter()
    scene = bench_scene(scene_frames, width, height)
    cfg = multistream_config(width, height)
    ds = packed_dataset(scene, cfg)
    log(f"scene ready and packed in {time.perf_counter() - t0:.1f}s")
    offsets = stream_offsets(len(ds), n_streams, n_frames)
    datasets = [_View(ds, off, n_frames) for off in offsets]

    msys = MultiStreamSystem(cfg, n_streams=n_streams, enable_local_ba=True,
                             device=device)
    log(f"multistream: warming S={n_streams} step...")
    t0 = time.perf_counter()
    staged = msys._stage([d[0] for d in datasets])
    for i in range(WARM):
        msys.step_frame([d[i] for d in datasets], staged)
        staged = msys._stage([d[i + 1] for d in datasets])
        log(f"  warm frame {i}: +{time.perf_counter() - t0:.1f}s")
    log(f"multistream warmup (S={n_streams}): {time.perf_counter() - t0:.1f}s")
    log(f"window-BA graphs warmed and captured at construction: "
        f"{_capture_seconds(msys.window_graphs.values()):.1f}s")

    uploader = ThreadPoolExecutor(1)  # see MultiStreamSystem.run
    stage = on_callers_streams([g.device for g in msys.groups], msys._stage)
    t0 = time.perf_counter()
    try:
        for i in range(WARM, n_frames):
            fut = (uploader.submit(stage, [d[i + 1] for d in datasets])
                   if i + 1 < n_frames else None)
            # pipelined: outputs drain every fused_drain_chunks frames
            msys.step_frame([d[i] for d in datasets], staged, sync=False)
            staged = fut.result() if fut is not None else None
        msys.flush()
    finally:
        uploader.shutdown(wait=True)
    elapsed = time.perf_counter() - t0
    n_done = (n_frames - WARM) * n_streams
    fps = n_done / elapsed
    log(f"multistream S={n_streams}: {n_done} frame-steps in {elapsed:.2f}s "
        f"= {fps:.2f} aggregate fps ({fps / n_streams:.2f}/stream), "
        f"windowed BA on")
    m = msys.metrics()
    for s, p in enumerate(m["per_stream"]):
        log(f"  stream {s}: {p}")
    log(f"aggregate accuracy: {m['aggregate']}  window solves: "
        f"{[len(t.ba_health) for t in msys.trackers]}  ba_failures: "
        f"{[t.ba_failures for t in msys.trackers]}")
    rec = _record(metric_name(n_streams=n_streams, tag=tag), fps)
    return {"record": rec, "system": msys, "offsets": offsets,
            "metrics": m}


class _Tail:
    """The frames of a dataset from `start` on (bench.py:342-350)."""

    def __init__(self, base, start: int):
        self.base, self.start = base, start

    def __len__(self):
        return len(self.base) - self.start

    def __getitem__(self, i):
        return self.base[self.start + i]


def main(hard: bool = False, device="cuda", n_frames: int = N_FRAMES,
         width: int = W, height: int = H) -> dict:
    """The default mode (bench.py:216-437), or --hard: warm frames, then
    the rest timed through run_sequence with a window solve at every
    trigger, then the full-batch BA; fps = timed frames / (tracking + full
    BA).  The stage probe runs after the timed region.  Returns the JSON
    record and the system."""
    from .backend.factor_graph import format_edge_stats
    from .backend.full_ba import full_ba_inplace, graphs_for, warmup_full_ba
    from .parallel.multistream import PROBE_SPANS
    from .pipeline import System

    device = _device(device)
    n_warm = warmup_frames()
    t0 = time.perf_counter()
    scene = bench_scene(n_frames, width, height, hard)
    if hard:
        log("HARD mode: flow sigma=0.75px + 1% outliers, mask erode 1px + "
            "jitter 1px")
    log(f"scene ready in {time.perf_counter() - t0:.1f}s")

    cfg = bench_config(width, height)
    t0 = time.perf_counter()
    pds = packed_dataset(scene, cfg)
    log(f"pre-packed {len(pds)} frames in {time.perf_counter() - t0:.1f}s "
        f"({pds[0].packed.nbytes / 1e6:.2f} MB/frame wire)")

    sysm = System(cfg, enable_local_ba=True, enable_global_ba=False,
                  mode="fused", device=device)

    t0 = time.perf_counter()
    sysm.run_sequence(pds, max_frames=n_warm)
    log(f"warmup {n_warm} frames: {time.perf_counter() - t0:.1f}s")
    log(f"window-BA graphs warmed and captured at construction: "
        f"{_capture_seconds([sysm.window_graphs]):.1f}s")
    full_graphs = graphs_for(device)
    if full_graphs is None:
        log("full BA over distinct cards: no graphs, the sharded solve "
            "runs eagerly")
    else:
        t0 = time.perf_counter()
        warmup_full_ba(cfg, len(pds), full_graphs)
        log(f"full-BA graphs warmed and captured: "
            f"{time.perf_counter() - t0:.1f}s "
            f"({_capture_seconds([full_graphs]):.1f}s of warm-up and "
            f"capture)")

    n_timed = len(pds) - n_warm
    n_solves = len(sysm.map.lba_times)
    t0 = time.perf_counter()
    sysm.run_sequence(_Tail(pds, n_warm))
    track_elapsed = time.perf_counter() - t0
    log(f"tracking+windowed-BA: {n_timed} frames in {track_elapsed:.2f}s "
        f"= {n_timed / track_elapsed:.2f} fps")
    solve_ms = sysm.map.lba_times[n_solves:]
    if len(solve_ms) > 1:
        rest = float(np.median(solve_ms[1:]))
        log(f"window solves in the timed region: {len(solve_ms)}; the first "
            f"{solve_ms[0]:.1f} ms, the median of the rest {rest:.1f} ms "
            f"({solve_ms[0] / rest:.2f}x)")

    wb = sysm.tracker.ba_health
    if wb:
        h = wb[-1]
        log(f"window-BA health: {len(wb)} solves, "
            f"{sysm.tracker.ba_failures} failures; last window: cost "
            f"{h['cost0']:.3e} -> {h['cost']:.3e}  points {h['n_points']}  "
            f"tracks_dropped {h['n_tracks_dropped']}")
        log(format_edge_stats(h["edge_stats0"], h["edge_stats"]))

    # end-of-run full-batch refinement (Tracking.cc:1190-1208)
    t1 = time.perf_counter()
    ba_info = full_ba_inplace(sysm.map, cfg, device=device,
                              graphs=full_graphs)
    ba_elapsed = time.perf_counter() - t1
    log(f"full-batch BA: {ba_elapsed:.1f}s  (build "
        f"{ba_info['t_build_s']:.3f}s, solve "
        f"{'from its graphs ' if full_graphs else '(eager) '}"
        f"{ba_info['t_solve_s']:.3f}s, wb "
        f"{ba_info['t_writeback_s']:.3f}s, {ba_info['iters_run']} LM iters)"
        f"  cost {ba_info['cost0']:.4e} -> {ba_info['cost']:.4e}  (static "
        f"{ba_info['n_static']}, dyn {ba_info['n_dyn']}, motions "
        f"{ba_info['n_motions']})")
    log("per-edge-type chi2 before/after:")
    log(format_edge_stats(ba_info["edge_stats0"], ba_info["edge_stats"]))
    rep_rf = sysm.metrics(refined=True)
    log(f"refined accuracy: {rep_rf}")

    # the per-stage split, after the timed region (bench.py:390-420); a
    # failure fails the run
    if os.environ.get("VDO_BENCH_NO_PROBE"):
        log("stage probe skipped (VDO_BENCH_NO_PROBE=1)")
    else:
        t0 = time.perf_counter()
        stage_ms = sysm.tracker.calibrate_stage_times(pds[n_warm],
                                                      n_iters=PROBE_ITERS)
        log(f"stage probe ({time.perf_counter() - t0:.1f}s, rtt "
            f"{stage_ms.pop('_rtt_ms'):.3f}ms): "
            + "  ".join(f"{k}={v:.1f}ms" for k, v in stage_ms.items()))
        span_sum = sum(stage_ms[k] for k in PROBE_SPANS)
        fm = stage_ms.get("_frame_ms", 0.0)
        log(f"span coverage: sum(spans)={span_sum:.1f}ms vs "
            f"frame={fm:.1f}ms ({span_sum / max(fm, 1e-9) * 100:.0f}%)")

    elapsed = track_elapsed + ba_elapsed
    fps = n_timed / elapsed
    rep = sysm.metrics()
    log(f"frames: {n_timed}  elapsed: {elapsed:.2f}s  fps: {fps:.2f}")
    log(f"accuracy: {rep}")
    log(f"stage timing (ms): {sysm.timing()}")
    rec = _record(metric_name(hard=hard), fps)
    return {"record": rec, "system": sysm, "full_ba": ba_info,
            "full_ba_graphs": (full_graphs.records() if full_graphs
                               else []), "frames": len(pds),
            "window_solve_ms": solve_ms}


def parse_argv(argv) -> tuple[str, dict]:
    """bench.py's argv handling (bench.py:440-457): ("multistream",
    {n_streams, tag}) for --throughput (S = 6 unless --streams S) and
    --streams S, else ("main", {hard})."""
    if "--throughput" in argv:
        s = (int(argv[argv.index("--streams") + 1])
             if "--streams" in argv else 6)
        return "multistream", {"n_streams": s, "tag": "_throughput"}
    if "--streams" in argv:
        return "multistream", {
            "n_streams": int(argv[argv.index("--streams") + 1])}
    return "main", {"hard": "--hard" in argv}


def cli(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
    mode, kwargs = parse_argv(argv)
    run = bench_multistream if mode == "multistream" else main
    run(device=device, **kwargs)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
