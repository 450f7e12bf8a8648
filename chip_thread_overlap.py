#!/usr/bin/env python3
"""What a second host thread issuing CUDA work costs and sees, on one GPU:
the facts the fused tracker's background window solve rests on.

    python3 chip_thread_overlap.py      # needs a GPU; prints one JSON line

- the flags of a pool stream (torch.cuda.Stream): CU_STREAM_NON_BLOCKING
  (1) means it does not synchronize with the legacy default stream (0);
- what a new Python thread starts on: torch's current device and stream,
  and the intra-op thread count set on the main thread;
- the interpreter lock: N small elementwise ops (a 64x64 tensor, each
  `x * 0.999 + 0.001`) queued by the main thread alone, by a second thread
  alone on its own stream, and by both at once; the host seconds of each.
"""

from __future__ import annotations

import ctypes
import json
import sys
import threading
import time

N = 4000


def _work(n: int) -> float:
    import torch

    x = torch.ones(64, 64, device=torch.cuda.current_device())
    for _ in range(n):
        x = x * 0.999 + 0.001
    torch.cuda.current_stream().synchronize()
    return float(x.sum())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_thread_overlap: no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.Stream(dev)
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuStreamGetFlags.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_uint)]
    cuda.cuStreamGetFlags.restype = ctypes.c_int
    flags = {}
    for name, handle in (("pool", stream.cuda_stream), ("legacy", 0)):
        f = ctypes.c_uint()
        rc = cuda.cuStreamGetFlags(ctypes.c_void_p(handle), ctypes.byref(f))
        flags[name] = f.value if rc == 0 else f"error {rc}"
    seen, secs = {}, {}

    def on_thread(n: int, key: str):
        seen.update(device=torch.cuda.current_device(),
                    stream=torch.cuda.current_stream().cuda_stream,
                    intra_op_threads=torch.get_num_threads())
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            t0 = time.perf_counter()
            _work(n)
            secs[key] = time.perf_counter() - t0

    _work(100)                                   # warm-up, both threads
    th = threading.Thread(target=on_thread, args=(100, "warm"))
    th.start()
    th.join()
    t0 = time.perf_counter()
    _work(N)
    main_alone = time.perf_counter() - t0
    th = threading.Thread(target=on_thread, args=(N, "thread_alone"))
    th.start()
    th.join()
    t0 = time.perf_counter()
    th = threading.Thread(target=on_thread, args=(N, "thread_together"))
    th.start()
    _work(N)
    main_together = time.perf_counter() - t0
    th.join()
    both = time.perf_counter() - t0
    import subprocess

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "card": card, "stream_flags": flags, "new_thread": seen,
        "ops_per_thread": 2 * N, "main_alone_s": main_alone,
        "thread_alone_s": secs["thread_alone"],
        "main_together_s": main_together,
        "thread_together_s": secs["thread_together"],
        "together_wall_s": both}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
