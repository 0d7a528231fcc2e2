"""Codebook usage / entropy logging (reference
``train_utils/codebook_logging.py``; the JAX package's
``titok_tpu/train_utils/codebook_logging.py``).

Sliding window of the last ``codebook_size`` *samples* of token indices;
when full, reports the nonzero-bin usage percentage and the Shannon
entropy of the code histogram (:func:`codebook_scores`), then clears the
window.
"""

from __future__ import annotations

import numpy as np


def shannon_entropy(p: np.ndarray) -> float:
    p = p[p > 0]
    return float(-(p * np.log(p)).sum())


def codebook_scores(samples, codebook_size: int) -> dict:
    """Usage (percent of codes hit) and entropy of the code histogram of
    ``samples``, a list of index arrays."""
    freq = np.zeros(codebook_size, dtype=np.int64)
    for sample in samples:
        freq += np.bincount(sample, minlength=codebook_size)
    total = freq.sum()
    return {
        "codebook/usage_percent": float((freq > 0).sum()) / codebook_size * 100,
        "codebook/entropy": shannon_entropy(freq / max(total, 1)),
    }


class CodebookLogger:
    def __init__(self, codebook_size: int):
        self.codebook_size = int(codebook_size)
        self.window: list[np.ndarray] = []

    def __call__(self, per_sample_indices) -> None:
        for sample in per_sample_indices:
            if len(self.window) == self.codebook_size:
                self.window.pop(0)
            self.window.append(np.asarray(sample).ravel())

    def is_score_ready(self) -> bool:
        return len(self.window) == self.codebook_size

    def get_scores(self) -> dict | None:
        if not self.is_score_ready():
            return None
        scores = codebook_scores(self.window, self.codebook_size)
        self.window = []
        return scores
