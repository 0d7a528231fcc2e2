"""Host→device prefetching: background packing and copies that overlap the
step (the JAX package's ``titok_tpu/data/prefetch.py``).

A background thread runs the batch stream (packing in numpy), builds each
batch's extras (the discriminator's layout, ``build_disc_batch``, and the
perceptual plan, ``build_perceptual_plan``) and copies everything to the
card: from pinned host memory, on a side stream,
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

``group = K > 1`` (``training.main.steps_per_call``, the input of
``TrainStepBuilder.make_train_step_scan``): K consecutive batches and
their extras are stacked on the host on a new leading axis and cross in
one transfer, as the JAX loader ships them in one ``device_put``. It emits
``(stacked device tensors, list of K PackedBatch, stacked device
extras)``; a final partial group of a finite stream is emitted with its
own, shorter length. ``transfers`` counts the transfers made: one a batch,
or one a group.
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
        self.group = int(group)
        self.transfers = 0
        self.factory = batch_iter_factory
        self.build_extras = build_extras
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _put(self, trees: list[dict]):
        """Host tensor dicts on the device in one transfer: ``(device dicts,
        event)``, the event recorded on the copy stream after the copies
        (None on CPU)."""
        self.transfers += 1
        if not self._cuda:
            return trees, None
        pinned = [{k: v.pin_memory() for k, v in t.items()} for t in trees]
        with torch.cuda.stream(self._copy_stream):
            dev = [{k: v.to(self.device, non_blocking=True) for k, v in t.items()}
                   for t in pinned]
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return dev, event

    def _item(self, pending: list):
        """The emitted item of ``(batch, host tensors, host extras)`` tuples:
        one batch, or a group stacked on a new leading axis; its tensors and
        extras on the device in one transfer."""
        batches, host, extras = (list(x) for x in zip(*pending))
        if self.group > 1:
            def stack(dicts):
                return {k: torch.stack([d[k] for d in dicts]) for k in dicts[0]}

            host, extras = stack(host), {n: stack([e[n] for e in extras]) for n in extras[0]}
        else:
            batches, host, extras = batches[0], host[0], extras[0]
        names = list(extras)
        dev, event = self._put([host, *(extras[n] for n in names)])
        return dev[0], batches, dict(zip(names, dev[1:])), event

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
            pending = []
            for batch in self.factory():
                if self._stop.is_set():
                    return
                extras = self.build_extras(batch) if self.build_extras else {}
                pending.append((batch, host_tensors(batch),
                                {k: host_tensors(v) for k, v in extras.items()}))
                if len(pending) == self.group:
                    if not self._enqueue(self._item(pending)):
                        return
                    pending = []
            # a finite stream's last partial group
            if pending and not self._enqueue(self._item(pending)):
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
            dev, batch, dev_extras, event = item
            self._ready(dev, (event,))
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
