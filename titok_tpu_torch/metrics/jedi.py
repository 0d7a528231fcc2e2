"""JEDi (the JAX package's ``titok_tpu/metrics/jedi.py``): the
polynomial-kernel MMD between the V-JEPA features of reconstructions and
targets, x100.

The extractor is looked up in this order: a ``feature_fn`` given by the
caller; a converted V-JEPA ``.npz`` (``jedi_vjepa_params`` /
``TITOK_VJEPA_PARAMS``, ``tools/convert_vjepa.py``), run on the card by
:class:`titok_tpu_torch.metrics.vjepa.VJEPAExtractor`; a torchscript
(``jedi_extractor_path`` / ``TITOK_JEDI_PATH``) on the same device; else
the first ``update`` raises.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np


def mmd_poly(X: np.ndarray, Y: np.ndarray, degree: int = 2, gamma=None,
             coef0: float = 0.0) -> float:
    """Polynomial-kernel MMD² (sklearn's ``polynomial_kernel``; ``gamma``
    None -> 1 / n_features), degree 2, coef0 0 by default."""
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y, np.float64)
    if gamma is None:
        gamma = 1.0 / X.shape[1]

    def k(a, b):
        return (gamma * a.dot(b.T) + coef0) ** degree

    m, n = len(X), len(Y)
    kxx = k(X, X)
    kyy = k(Y, Y)
    kxy = k(X, Y)
    return float(kxx.mean() + kyy.mean() - 2 * kxy.mean()) if m and n else 0.0


class TorchscriptVideoExtractor:
    """A local torchscript feature extractor on ``device`` (loaded there by
    ``map_location``): BCTHW float in [-1, 1] -> ``[B, D]``."""

    def __init__(self, path: str, device=None):
        import torch

        from titok_tpu_torch import resolve_device

        self.device = resolve_device(device)
        self.model = torch.jit.load(path, map_location=self.device).eval()

    def __call__(self, video_bcthw: np.ndarray) -> np.ndarray:
        import torch

        from titok_tpu_torch.metrics.fp32 import strict_fp32

        with strict_fp32():
            x = torch.from_numpy(np.ascontiguousarray(video_bcthw, np.float32)).to(self.device)
            return self.model(x).cpu().numpy()


class JEDiMetric:
    def __init__(self, feature_fn: Optional[Callable] = None,
                 model_name: str = "vit_large",
                 extractor_path: Optional[str] = None,
                 vjepa_params_path: Optional[str] = None,
                 device=None):
        self.feature_fn = feature_fn
        self.model_name = model_name
        self.extractor_path = extractor_path or os.environ.get("TITOK_JEDI_PATH")
        self.vjepa_params_path = vjepa_params_path or os.environ.get("TITOK_VJEPA_PARAMS")
        self.device = device
        self.reset()

    def update(self, recon_bcthw: np.ndarray, target_bcthw: np.ndarray) -> None:
        if self.feature_fn is None and self.vjepa_params_path:
            from titok_tpu_torch.metrics.vjepa import VJEPAExtractor, load_vjepa_params

            self.feature_fn = VJEPAExtractor(load_vjepa_params(self.vjepa_params_path),
                                             self.model_name, device=self.device)
        if self.feature_fn is None and self.extractor_path:
            self.feature_fn = TorchscriptVideoExtractor(self.extractor_path, device=self.device)
        if self.feature_fn is None:
            raise RuntimeError(
                "JEDi needs a V-JEPA feature extractor; pass feature_fn, "
                "set training.eval.jedi_vjepa_params / TITOK_VJEPA_PARAMS "
                "to a converted checkpoint (tools/convert_vjepa.py), or "
                "set training.eval.jedi_extractor_path / TITOK_JEDI_PATH "
                "to a local torchscript (zero-egress: the reference "
                "downloads jepa weights, jedi.py:24-70).")
        self.fake.append(np.asarray(self.feature_fn(recon_bcthw)))
        self.real.append(np.asarray(self.feature_fn(target_bcthw)))

    def compute(self) -> float:
        real = np.concatenate(self.real, axis=0)
        fake = np.concatenate(self.fake, axis=0)
        return mmd_poly(real, fake) * 100.0

    def reset(self) -> None:
        self.real: list[np.ndarray] = []
        self.fake: list[np.ndarray] = []
