"""Parallel host decode workers with a deterministic fan-in (the JAX
package's ``titok_tpu/data/workers.py``).

The reference hides decode latency behind 3 torch DataLoader worker
*processes* (``dataset/video_dataset.py:210-214``, ``num_workers=3``).
Here the workers are threads: the hot host-side calls (libav decode, the
swscale resize, the fused packer) drop the interpreter lock, so threads
run them in parallel with no serialization of frame buffers between
processes.

Determinism: each worker owns an independent item stream (its own rng, its
own shard or file slice) and the consumer merges them **round-robin**, one
item per worker per turn. The merged stream is a pure function of the
seed, independent of thread scheduling.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np

_SENTINEL = object()


class WorkerPool:
    """Run N item streams in background threads, merged round-robin.

    ``factories[w]()`` returns the w-th worker's iterator. Each worker
    fills a bounded queue (``depth`` items) so fast workers stay ahead of
    the consumer; the consumer takes one item from each live worker in
    turn. A worker whose stream ends leaves the rotation; iteration ends
    when all have. An exception raised inside a worker is raised to the
    consumer. The threads start at the first item taken and end when
    iteration ends or the iterator is closed (:meth:`stop` joins them).
    """

    def __init__(self, factories: list[Callable[[], Iterator]], depth: int = 8):
        if not factories:
            raise ValueError("WorkerPool needs at least one worker")
        self.factories = factories
        self.depth = depth
        self._queues: list[queue.Queue] = []
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()

    def _put(self, q: queue.Queue, item) -> bool:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _run(self, factory: Callable[[], Iterator], q: queue.Queue):
        try:
            for item in factory():
                if not self._put(q, item):
                    return
            self._put(q, _SENTINEL)
        except Exception as e:  # raised to the consumer
            self._put(q, e)

    def __iter__(self) -> Iterator:
        self._stop.clear()
        self._queues = [queue.Queue(maxsize=self.depth) for _ in self.factories]
        self._threads = [threading.Thread(target=self._run, args=(f, q), daemon=True)
                         for f, q in zip(self.factories, self._queues)]
        for t in self._threads:
            t.start()
        live = list(self._queues)
        try:
            while live:
                nxt = []
                for q in live:
                    item = q.get()
                    if item is _SENTINEL:
                        continue
                    if isinstance(item, Exception):
                        raise item
                    yield item
                    nxt.append(q)
                live = nxt
        finally:
            self.stop()

    def stop(self):
        """Stop the workers and wait for each up to 10 s: a worker ends at
        its next item (a daemon thread still decoding then ends with the
        process)."""
        self._stop.set()
        for t in self._threads:
            t.join(10.0)


def worker_seeds(seed: int, n: int) -> list[int]:
    """Independent per-worker seeds (stable across runs for a fixed seed),
    as the reference reseeds each worker (``dataset/video_dataset_csv.py:192-194``)."""
    ss = np.random.SeedSequence(seed)
    return [int(s.generate_state(1)[0]) for s in ss.spawn(n)]
