"""Host→device prefetching: background packing and copies that overlap the
step (the JAX package's ``titok_tpu/data/prefetch.py``).

A background thread runs the batch stream (packing in numpy), builds each
batch's extras (the discriminator's layout, ``build_disc_batch``) and
copies everything to the card: from pinned host memory, on a side stream,
with an event recorded after the copies. The consumer's stream waits on
that event before the step reads the tensors, and each tensor is marked
with ``record_stream`` for the consumer's stream, so the caching allocator
does not hand its memory out again while the step may still read it. So
the copy of batch N+1 overlaps the step on batch N, and the step never
reads a buffer mid-copy.

Emits ``(device tensors, PackedBatch, device extras)``, as the JAX loader
emits ``(device arrays, PackedBatch, device extras)``. For CPU runs the
"device" tensors are the host tensors. Errors raised in the thread
surface to the consumer. :meth:`stop` ends the thread and waits for it,
so no packing runs on after the loop (nor while the interpreter exits).
``group > 1`` (the JAX loader's stacked batches for ``steps_per_call``) is
not ported.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import torch

from titok_tpu_torch import resolve_device
from titok_tpu_torch.data.packing import host_tensors


class PrefetchLoader:
    def __init__(
        self,
        batch_iter_factory: Callable[[], Iterator],
        *,
        build_extras: Optional[Callable] = None,
        depth: int = 2,
        device=None,
        group: int = 1,
    ):
        if int(group) > 1:
            raise NotImplementedError(
                "PrefetchLoader(group > 1), the stacked batches of "
                "training.main.steps_per_call, is not ported yet (ROADMAP queue 1 item 13)")
        self.factory = batch_iter_factory
        self.build_extras = build_extras
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _put(self, tensors: dict):
        """Host tensors on the device: ``(device tensors, event)``, the
        event recorded on the copy stream after the copies (None on CPU)."""
        if not self._cuda:
            return tensors, None
        pinned = {k: v.pin_memory() for k, v in tensors.items()}
        with torch.cuda.stream(self._copy_stream):
            dev = {k: v.to(self.device, non_blocking=True) for k, v in pinned.items()}
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return dev, event

    def _enqueue(self, item) -> bool:
        """Put ``item`` for the consumer unless the loader is stopped."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _worker(self):
        try:
            for batch in self.factory():
                if self._stop.is_set():
                    return
                extras = self.build_extras(batch) if self.build_extras else {}
                dev, ev = self._put(host_tensors(batch))
                dev_extras, events = {}, [ev]
                for k, v in extras.items():
                    dev_extras[k], e = self._put(host_tensors(v))
                    events.append(e)
                if not self._enqueue((dev, batch, dev_extras, events)):
                    return
            self._enqueue(None)  # end of stream
        except Exception as e:  # surface errors to the consumer
            self._enqueue(e)

    def _ready(self, dev: dict, events) -> None:
        """Make the consumer's stream wait for the copies and keep their
        memory from reuse until its work on them is done."""
        if not self._cuda:
            return
        stream = torch.cuda.current_stream(self.device)
        for e in events:
            stream.wait_event(e)
        for t in dev.values():
            t.record_stream(stream)

    def __iter__(self):
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        while True:
            item = self._queue.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            dev, batch, dev_extras, events = item
            self._ready(dev, events)
            for v in dev_extras.values():
                self._ready(v, ())
            yield dev, batch, dev_extras

    def stop(self):
        """End the background thread, wait for it, and drop what it queued."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
