"""Training orchestration (reference ``train.py``). So far the data-free
batch stream; the ``Trainer`` loop, checkpoints and logging are ROADMAP
queue 1 item 7."""

from __future__ import annotations

from typing import Iterator

import numpy as np

from titok_tpu_torch.data.packing import Packer, PackedBatch
from titok_tpu_torch.models.titok import compute_dtype


def synthetic_batches(config, seed: int = 0) -> Iterator[PackedBatch]:
    """Seeded random-clip stream through the packer at ``train_seq_len``,
    for data-free runs (``dataset.train_dataset: synthetic``): uniform
    [-1, 1] CTHW clips with each dim drawn between ``min_grid`` and
    ``max_grid`` in patch steps, rows rounded to the precision's dtype. The
    same seed gives the JAX package's training stream."""
    cs = config.training.sampling
    ps = list(config.tokenizer.model.patch_size)
    rng = np.random.default_rng(seed)

    def stream():
        while True:
            dims = [int(rng.integers(lo // p, hi // p + 1)) * p
                    for lo, hi, p in zip(cs.min_grid, cs.max_grid, ps)]
            yield {"video": rng.uniform(-1, 1, size=[3] + dims).astype(np.float32), "fps": 4}

    packer = Packer(seq_len=int(cs.train_seq_len), token_range=cs.token_range, patch_size=ps,
                    min_grid=cs.min_grid, rng=rng, dtype=compute_dtype(config))
    yield from packer(stream())
