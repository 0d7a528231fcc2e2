"""WebDataset-style tar-shard reader (reference ``dataset/video_dataset.py``
built on the webdataset package; the JAX package's
``titok_tpu/data/wds_dataset.py``, the same draws in the same order).

The reference pipeline's stages (``video_dataset.py:188-204``):

    ResampledShards -> split_by_worker -> tarfile_to_samples -> shuffle(8)
    -> video_process -> shuffle(64) -> dynamic_batching        (train)
    SimpleShardList -> split_by_worker -> tarfile_to_samples
    -> video_process -> dynamic_batching                        (eval)

with brace expansion of shard specs, tar members grouped by key (the
basename up to its first dot) and warn-and-continue on a bad shard or
clip. Remote ``hf://`` / ``http(s)://`` shards would need the network and
are rejected.
"""

from __future__ import annotations

import functools
import os
import re
import tarfile
from typing import Iterator

import numpy as np

from titok_tpu_torch.data import _native
from titok_tpu_torch.data.chunking import chunk_shuffle_buffer, clip_chunks, pack_chunks
from titok_tpu_torch.data.packing import PackedBatch
from titok_tpu_torch.data.workers import WorkerPool, worker_seeds

_BRACE_RE = re.compile(r"\{(\d+)\.\.(\d+)\}")
REMOTE_PREFIXES = ("hf://", "http://", "https://")


def expand_shards(spec: str) -> list[str]:
    """webdataset brace expansion: ``shard-{00000..00079}.tar``."""
    m = _BRACE_RE.search(spec)
    if not m:
        return [spec]
    lo, hi = m.group(1), m.group(2)
    out = []
    for i in range(int(lo), int(hi) + 1):
        out.extend(expand_shards(spec[: m.start()] + str(i).zfill(len(lo)) + spec[m.end():]))
    return out


def tarfile_to_samples(path: str) -> Iterator[dict]:
    """Group tar members by key -> ``{'__key__', '<ext>': bytes, ...}``."""
    with tarfile.open(path, "r|*") as tf:
        current_key = None
        sample: dict = {}
        for member in tf:
            if not member.isfile():
                continue
            key, _, ext = os.path.basename(member.name).partition(".")
            if key != current_key:
                if sample:
                    yield sample
                current_key = key
                sample = {"__key__": key}
            data = tf.extractfile(member)
            if data is not None:
                sample[ext] = data.read()
        if sample:
            yield sample


def _sample_stream(shards: list[str], rng: np.random.Generator,
                   resample: bool) -> Iterator[dict]:
    """ResampledShards (endless, shards drawn with replacement) or one
    epoch in a random order; a shard that cannot be read is skipped with a
    printed line (reference ``:191-194``)."""
    while True:
        order = (rng.integers(0, len(shards), size=len(shards)) if resample
                 else rng.permutation(len(shards)))
        for i in order:
            try:
                yield from tarfile_to_samples(shards[int(i)])
            except (OSError, EOFError, tarfile.TarError) as error:
                print(f"shard read fail ({shards[int(i)]}): {error}")
        if not resample:
            return


def _video_chunks(samples: Iterator[dict], sampling, patch_size, rng,
                  eval: bool) -> Iterator[dict]:
    for sample in samples:
        for vk in [k for k in sample if k == "mp4" or k.endswith(".mp4") or k == "avi"]:
            yield from clip_chunks(sample[vk], sampling, patch_size, rng, eval)


def _worker_chunks(shards, sampling, patch_size, seed, eval, w, workers):
    """Worker ``w`` of ``workers``: its shard slice ``shards[w::workers]``
    and its own rng stream (``split_by_worker``)."""
    rng = np.random.default_rng(seed)
    s = _sample_stream(shards[w::workers], rng, resample=not eval)
    if not eval:
        s = chunk_shuffle_buffer(s, 8, rng)
    return _video_chunks(s, sampling, patch_size, rng, eval)


def wds_batches(config, eval: bool = False, seed: int = 0) -> Iterator[PackedBatch]:
    """PackedBatches from ``dataset.train_dataset`` (endless) or
    ``dataset.eval_dataset`` (``eval``: one pass, the first ``eval_samples``
    chunks). ``dataset.workers`` > 0 decodes in that many threads (at most
    one a shard), merged round-robin. Raises here, before any batch, for a
    remote shard or a host library that cannot be built."""
    cs = config.training.sampling
    patch_size = list(config.tokenizer.model.patch_size)
    rng = np.random.default_rng(seed)
    shards = expand_shards(str(config.dataset.eval_dataset if eval
                               else config.dataset.train_dataset))
    remote = [s for s in shards if s.startswith(REMOTE_PREFIXES)]
    if remote:
        raise ValueError(f"remote shard {remote[0]!r} needs the network; stage shards "
                         "locally (python -m titok_tpu_torch.data.convert_to_wds)")
    _native.load("av")

    workers = min(int(config.dataset.get("workers", 0) or 0), len(shards))
    if workers >= 1:
        seeds = worker_seeds(seed, workers)
        chunks = iter(WorkerPool([
            functools.partial(_worker_chunks, shards, cs, patch_size, seeds[w], eval, w, workers)
            for w in range(workers)]))
    else:
        samples = _sample_stream(shards, rng, resample=not eval)
        if not eval:
            samples = chunk_shuffle_buffer(samples, 8, rng)  # wds.shuffle(8)
        chunks = _video_chunks(samples, cs, patch_size, rng, eval)
    return pack_chunks(config, chunks, rng, eval)
