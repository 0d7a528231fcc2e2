"""CSV-listed local video dataset (reference ``dataset/video_dataset_csv.py``;
the JAX package's ``titok_tpu/data/csv_dataset.py``, the same draws in the
same order).

Pipeline: an endless random file sampler over the CSV's ``path`` column
(``video_dataset_csv.py:54-57``) -> chunk sampler -> reservoir shuffle
buffer of 64 (train only, ``:122-131``) -> dynamic packer. The reference
decodes in DataLoader worker processes; here ``dataset.workers`` threads
decode (the libav calls drop the interpreter lock), merged round-robin.
"""

from __future__ import annotations

import csv
import functools
from typing import Iterator

import numpy as np

from titok_tpu_torch.data import _native
from titok_tpu_torch.data.chunking import clip_chunks, pack_chunks
from titok_tpu_torch.data.packing import PackedBatch
from titok_tpu_torch.data.workers import WorkerPool, worker_seeds


def read_csv_paths(path: str) -> list[str]:
    with open(path, newline="") as f:
        return [row["path"] for row in csv.DictReader(f)]


def _chunk_stream(paths, sampling, patch_size, rng, eval) -> Iterator[dict]:
    """Endless: a file drawn at random, its chunks, the next file."""
    while True:
        yield from clip_chunks(paths[int(rng.integers(len(paths)))], sampling, patch_size,
                               rng, eval)


def _worker_chunks(paths, sampling, patch_size, seed, eval):
    return _chunk_stream(paths, sampling, patch_size, np.random.default_rng(seed), eval)


def csv_batches(config, eval: bool = False, seed: int = 0,
                buffer_size: int = 64) -> Iterator[PackedBatch]:
    """PackedBatches forever (train) or until ``eval_samples`` chunks
    (``eval``). Raises here, before any batch, for a host library that
    cannot be built."""
    cs = config.training.sampling
    patch_size = list(config.tokenizer.model.patch_size)
    rng = np.random.default_rng(seed)
    paths = read_csv_paths(str(config.dataset.eval_dataset if eval
                               else config.dataset.train_dataset))
    _native.load("av")

    workers = int(config.dataset.get("workers", 0) or 0)
    if workers >= 1:
        seeds = worker_seeds(seed, workers)
        chunks = iter(WorkerPool([
            functools.partial(_worker_chunks, paths, cs, patch_size, seeds[w], eval)
            for w in range(workers)]))
    else:
        chunks = _chunk_stream(paths, cs, patch_size, rng, eval)
    return pack_chunks(config, chunks, rng, eval, buffer_size)
