"""Split the fused tracking loop's time per frame into its phases; a
jax-free port of tools/probe_loop.py.

    python -m vdo_slam_tpu_torch.tools.probe_loop [--frames 48] [--device cpu]

On bench.py's scene, config and pre-packed frames, taken from the port's
bench (`bench_scene`, `bench_config` with its VDO_BENCH_* knobs,
`packed_dataset`), it measures, per frame:

  upload_ms_frame    `device_inputs_chunk` of real packed chunks, each
                     followed by torch.cuda.synchronize(): the pinned
                     (C, wire_len) copy and its staging on the host.
  dispatch_ms_frame  `step_chunk` on two pre-staged chunks in turn, with no
                     sync until the end: the host's time to queue a step.
  device_ms_frame    the same steps' time on the device: the sum of their
                     kernels and copies under torch.profiler (CUDA activity
                     only), with launches_per_frame, the kernels counted.
  loop_ms_frame_ba_off / _ba_on
                     `System.run_sequence` on a fresh System after 2 C
                     warm frames, window BA off and then on.
  gap_ms_frame_ba_off / _ba_on
                     loop - max(upload, dispatch).

In the JAX package the step is one compiled program, so its device phase
is one number: chunk steps never synced.  In eager PyTorch the host queues
each of the step's kernels itself, so that phase is two numbers: the
host's dispatch time, and the device's time for the kernels queued.  The
card is busy for a small share of a step, so the dispatch time is what
bounds the loop; the gap is the loop's host work outside the step
(reading and staging frames, archiving, the drains, and with BA on the
window solves, which run on the tracker's thread).  On the CPU the step's
ops run as they are dispatched, so device_ms_frame is the dispatch time
and launches_per_frame 0 (no kernel is launched).

Against the original: the Systems run no full BA at the end of their
run_sequence (enable_global_ba=False); the original's ran one inside its
loop time.
"""

from __future__ import annotations

import argparse
import math
import time

from .. import bench


def bench_inputs(device, width: int, height: int, scene_frames: int):
    """(device, cfg, packed frames, card line) of the bench's default mode;
    a CUDA device without a card raises."""
    device = bench._device(device)
    t0 = time.perf_counter()
    scene = bench.bench_scene(scene_frames, width, height)
    cfg = bench.bench_config(width, height)
    pds = bench.packed_dataset(scene, cfg)
    bench.log(f"scene ready and packed in {time.perf_counter() - t0:.1f}s "
              f"({pds[0].packed.nbytes / 1e6:.2f} MB/frame wire)")
    return device, cfg, pds, bench.card_line(device)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_profile(fn, device) -> tuple[float, int]:
    """(ms, kernel launches) the device spent on fn(): every CUDA event
    torch.profiler recorded (kernels and copies, one stream), launches
    counting the kernels alone.  The profiler now and then records no
    device event; three empty sessions raise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        sync(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            sync(device)
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        launches = sum(1 for e in dev
                       if not e.name.startswith(("Memcpy", "Memset")))
        if launches:
            return sum(e.time_range.elapsed_us() for e in dev) / 1e3, launches
    raise RuntimeError("the profiler recorded no kernel in 3 sessions")


def drive(cfg, device, pds, start: int, n: int, ba: bool, sysm=None):
    """run_sequence over frames start .. start + n - 1, on `sysm` or a
    fresh System that first runs frames 0 .. start - 1 as warm frames:
    (System, ms per frame, {"given", "archived", "steps"}).  steps counts
    the frames the step ran, a padded tail chunk's padding included."""
    from ..pipeline import System

    if sysm is None:
        sysm = System(cfg, enable_local_ba=ba, enable_global_ba=False,
                      mode="fused", device=device)
        sysm.run_sequence(bench._View(pds, 0, start))
    tr = sysm.tracker
    n0, f0 = sysm.map.num_frames, tr.frame_id
    t0 = time.perf_counter()
    sysm.run_sequence(bench._View(pds, start, n))
    sync(device)
    ms = (time.perf_counter() - t0) / n * 1e3
    return sysm, ms, {"given": n, "archived": sysm.map.num_frames - n0,
                      "steps": tr.frame_id - f0}


def main(n_frames: int = 48, device="cuda", width: int = bench.W,
         height: int = bench.H, scene_frames: int = bench.N_FRAMES) -> dict:
    """The phases above, logged to stderr; returns them with the frame
    counts of every drive and "steps", the frames the step ran in all."""
    from ..pipeline import System

    device, cfg, pds, card = bench_inputs(device, width, height,
                                          scene_frames)
    sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  mode="fused", device=device)
    tr = sysm.tracker
    C = tr.chunk
    t0 = time.perf_counter()
    sysm.run_sequence(bench._View(pds, 0, 2 * C))
    steps = tr.frame_id
    bench.log(f"warmup ({2 * C} frames): {time.perf_counter() - t0:.1f}s")

    # upload: real packed chunks, each synced
    reps = max(2, n_frames // C)
    chunks = [[pds[(i * C + c) % len(pds)] for c in range(C)]
              for i in range(reps)]
    t0 = time.perf_counter()
    for ch in chunks:
        tr.device_inputs_chunk(ch)
        sync(device)
    up = (time.perf_counter() - t0) / (reps * C) * 1e3
    bench.log(f"upload: {up:.3f} ms/frame ({reps * C} frames) [{card}]")

    # dispatch: chunk steps on two pre-staged inputs, synced at the end
    staged = [tr.device_inputs_chunk(chunks[i]) for i in (0, 1)]
    for s in staged:
        s.pop("_T_cw_gt_host")
    state, fid = tr.state, tr.frame_id
    state, _ = tr.step_chunk(state, staged[0], fid)   # absorbs warm-up
    sync(device)
    t0 = time.perf_counter()
    for i in range(reps):
        state, vecs = tr.step_chunk(state, staged[i % 2], fid + i * C)
    sync(device)
    disp = (time.perf_counter() - t0) / (reps * C) * 1e3
    steps += (reps + 1) * C

    # device: two of the same chunk steps under the profiler
    def two_chunks():
        st = state
        for i in range(2):
            st, _ = tr.step_chunk(st, staged[i], fid + i * C)

    dev, per = disp, 0.0
    if device.type == "cuda":
        dev_ms, launches = device_profile(two_chunks, device)
        dev, per = dev_ms / (2 * C), launches / (2 * C)
        steps += 2 * C
    bench.log(f"step: {disp:.3f} ms/frame to dispatch ({reps} chunks of "
              f"{C}), {dev:.3f} ms/frame on the device, {per:.1f} launches "
              f"per frame [{card}]")

    out = {"device": str(device), "card": card, "chunk": C,
           "upload_ms_frame": up, "dispatch_ms_frame": disp,
           "device_ms_frame": dev, "launches_per_frame": per, "drives": []}
    for ba in (False, True):
        tag = "on" if ba else "off"
        nt = min(n_frames, len(pds) - 2 * C)
        s2, loop, counts = drive(cfg, device, pds, 2 * C, nt, ba)
        steps += s2.tracker.frame_id          # its warm frames included
        out["drives"].append(dict(counts, what=f"run_sequence, window BA "
                                               f"{tag}"))
        out[f"loop_ms_frame_ba_{tag}"] = loop
        out[f"gap_ms_frame_ba_{tag}"] = loop - max(up, disp)
        bench.log(f"loop: {loop:.3f} ms/frame ({nt} frames, window BA "
                  f"{tag}) = {1e3 / loop:.3f} fps; gap (loop - max(upload, "
                  f"dispatch)): {loop - max(up, disp):.3f} ms/frame [{card}]")
    out["steps"] = steps
    check_phases(out, "probe_loop")
    return out


def check_phases(out: dict, what: str) -> None:
    """Every time in `out` (a float key ending in "_ms", "_ms_frame" or
    "_s") finite and >= 0, every gap finite: else raise."""
    bad = [k for k, v in out.items() if isinstance(v, float) and not (
        math.isfinite(v) and (v >= 0.0 or k.startswith("gap")))]
    if bad:
        raise RuntimeError(f"{what}: phases not finite and >= 0: "
                           f"{ {k: out[k] for k in bad} }")


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    main(args.frames, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
