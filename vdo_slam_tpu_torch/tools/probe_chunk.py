"""Time each phase of the fused tracker's chunked drive, chunk by chunk; a
jax-free port of tools/probe_chunk.py.

    python -m vdo_slam_tpu_torch.tools.probe_chunk [--frames 48] [--device cpu]

On the bench's scene, config and pre-packed frames (as probe_loop takes
them), after 2 C warm frames through run_sequence, it drives the chunks
of the next `--frames` frames inline, as System.run_sequence drives them,
with the next chunk staged on one uploader thread as the original stages
it, and times per chunk:

  submit      handing the next chunk's staging to the uploader thread;
  grab_chunk  queueing the chunk's C steps and their output copy, and
              archiving the batch of chunks whose drain falls due (every
              fused_drain_chunks-th call waits for that batch's copy);
  stage_wait  waiting for the uploader's staged chunk.

Then the final drain and flush, the total ms per frame and fps, and
run_sequence over the span of frames after it on the same System (its own
drive: the next chunk staged on the calling thread).  The staging thread's
copies are queued on the calling thread's current CUDA stream, so the
steps that read them are queued after them.  The System runs no window BA,
as the original's, and no full BA (the original's ran one at the end of
each run_sequence).
"""

from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor

from .. import bench
from .probe_loop import bench_inputs, check_phases, drive, sync


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
    bench.log(f"warmup ({2 * C} frames): {time.perf_counter() - t0:.1f}s")
    drives = [{"what": "warm frames", "given": 2 * C,
               "archived": sysm.map.num_frames, "steps": tr.frame_id,
               "ba_failures": tr.ba_failures}]

    start = 2 * C
    n_chunks = min(n_frames, len(pds) - start) // C
    if n_chunks < 1:
        raise ValueError(f"probe_chunk: {len(pds)} frames leave no chunk of "
                         f"{C} after the {start} warm frames")
    chunks = [[pds[start + i * C + c] for c in range(C)]
              for i in range(n_chunks)]
    n0, f0 = sysm.map.num_frames, tr.frame_id
    stage = bench.on_callers_streams([device], tr.device_inputs_chunk)
    rows = []
    with ThreadPoolExecutor(1) as uploader:
        staged = tr.device_inputs_chunk(chunks[0])
        t_loop = time.perf_counter()
        for i in range(n_chunks):
            t0 = time.perf_counter()
            fut = (uploader.submit(stage, chunks[i + 1])
                   if i + 1 < n_chunks else None)
            t1 = time.perf_counter()
            tr.grab_chunk(chunks[i], staged)
            t2 = time.perf_counter()
            staged = fut.result() if fut is not None else None
            t3 = time.perf_counter()
            rows.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
        t4 = time.perf_counter()
        tr.flush()
        sync(device)
        t5 = time.perf_counter()
    n_inline = n_chunks * C
    total = t5 - t_loop
    drives.append({"what": "inline chunks", "given": n_inline,
                   "archived": sysm.map.num_frames - n0,
                   "steps": tr.frame_id - f0,
                   "ba_failures": tr.ba_failures})
    bench.log("chunk phases (ms): submit / grab_chunk / stage-wait")
    for i, (a, b, c) in enumerate(rows):
        bench.log(f"  chunk {i}: {a:9.3f} {b:9.3f} {c:9.3f}")
    bench.log(f"final drain+flush: {(t5 - t4) * 1e3:.3f} ms")
    bench.log(f"total: {total:.3f}s for {n_inline} frames = "
              f"{total / n_inline * 1e3:.3f} ms/frame "
              f"({n_inline / total:.3f} fps) [{card}]")

    start2 = start + n_inline
    nt2 = min(n_frames, len(pds) - start2)
    out = {"device": str(device), "card": card, "chunk": C,
           "chunks": n_chunks, "chunk_ms": rows,
           "submit_ms": sum(r[0] for r in rows) / n_chunks,
           "grab_chunk_ms": sum(r[1] for r in rows) / n_chunks,
           "stage_wait_ms": sum(r[2] for r in rows) / n_chunks,
           "drain_flush_ms": (t5 - t4) * 1e3,
           "total_s": total, "ms_frame": total / n_inline * 1e3,
           "fps": n_inline / total}
    if nt2 > 0:
        _, ms, counts = drive(cfg, device, pds, start2, nt2, False, sysm)
        drives.append(dict(counts, what="run_sequence"))
        out["run_sequence_ms_frame"] = ms
        out["run_sequence_fps"] = 1e3 / ms
        bench.log(f"run_sequence: {nt2} frames = {ms:.3f} ms/frame "
                  f"({1e3 / ms:.3f} fps) [{card}]")
    out["drives"] = drives
    out["steps"] = tr.frame_id
    check_phases(out, "probe_chunk")
    return out


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    main(args.frames, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
