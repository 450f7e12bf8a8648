"""Background-thread dataset prefetcher — a jax-free copy of
vdo_slam_tpu/io/prefetch.py.

Wraps any dataset
and keeps the next `depth` FrameData items materialized while the pipeline
consumes the current one (the reference's demo loop decodes synchronously on
the main thread, example/vdo_slam.cc:98-141).
"""

from __future__ import annotations

import queue
import threading


class ThreadedPrefetcher:
    def __init__(self, dataset, depth: int = 2):
        self.dataset = dataset
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for i in range(len(self.dataset)):
                if self._stop.is_set():
                    return
                self._q.put((i, self.dataset[i]))
        except Exception as e:  # surface errors at the consumer
            self._q.put((-1, e))
        self._q.put((None, None))

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        while True:
            i, item = self._q.get()
            if i is None:
                return
            if i == -1:
                raise item
            yield item

    def close(self):
        self._stop.set()


def iterate(dataset, depth: int = 2):
    """Iterate FrameData with background prefetch."""
    pf = ThreadedPrefetcher(dataset, depth)
    try:
        yield from pf
    finally:
        pf.close()
