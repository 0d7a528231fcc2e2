"""Image-level FID / Inception Score / MMD / PSNR / SSIM calculator (the
JAX package's ``titok_tpu/metrics/image_metrics.py``; a legacy utility,
not on the trainer's path).

The feature extractor is pluggable (``images_nchw -> (features,
logits)``, e.g. :class:`titok_tpu_torch.metrics.inception_v3.
InceptionExtractor`); the distances are numpy.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from titok_tpu_torch.metrics.fvd import compute_stats, frechet_distance
from titok_tpu_torch.metrics.jedi import mmd_poly
from titok_tpu_torch.metrics.psnr_ssim import PSNRMetric, SSIMMetric


def inception_score(logits: np.ndarray, eps: float = 1e-16) -> float:
    """IS = exp(E_x KL(p(y|x) || p(y)))."""
    logits = np.asarray(logits, np.float64)
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    p_yx = e / e.sum(axis=1, keepdims=True)
    p_y = p_yx.mean(axis=0, keepdims=True)
    kl = (p_yx * (np.log(p_yx + eps) - np.log(p_y + eps))).sum(axis=1)
    return float(np.exp(kl.mean()))


def calculate_fid(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """Fréchet distance over pooled features."""
    return frechet_distance(*compute_stats(feats_a), *compute_stats(feats_b))


class MetricCalculator:
    """Accumulate image batches; compute the configured metric dict."""

    def __init__(self, metrics=("psnr", "ssim"),
                 feature_fn: Optional[Callable] = None, data_range: float = 2.0):
        self.metrics = list(metrics)
        self.feature_fn = feature_fn
        self.psnr = PSNRMetric(data_range)
        self.ssim = SSIMMetric(data_range)
        self.reset()

    def update(self, recon_nchw: np.ndarray, target_nchw: np.ndarray) -> None:
        recon = np.clip(np.asarray(recon_nchw, np.float32), -1, 1)
        target = np.asarray(target_nchw, np.float32)
        if "psnr" in self.metrics:
            self.psnr.update(recon, target)
        if "ssim" in self.metrics:
            self.ssim.update(recon, target)
        if any(m in self.metrics for m in ("fid", "is", "mmd")):
            if self.feature_fn is None:
                raise RuntimeError(
                    "fid/is/mmd need a feature extractor (zero-egress: the "
                    "reference downloads InceptionV3, metrics.py:185-231)")
            fr, lr = self.feature_fn(recon)
            ft, _ = self.feature_fn(target)
            self.fake_feats.append(np.asarray(fr))
            self.real_feats.append(np.asarray(ft))
            self.fake_logits.append(np.asarray(lr))

    def compute(self) -> dict:
        out = {}
        if "psnr" in self.metrics:
            out["psnr"] = self.psnr.compute()
        if "ssim" in self.metrics:
            out["ssim"] = self.ssim.compute()
        if self.fake_feats:
            fake = np.concatenate(self.fake_feats, 0)
            real = np.concatenate(self.real_feats, 0)
            if "fid" in self.metrics:
                out["fid"] = calculate_fid(real, fake)
            if "mmd" in self.metrics:
                out["mmd"] = mmd_poly(real, fake) * 100.0  # degree-2 poly MMD x100
            if "is" in self.metrics:
                out["is"] = inception_score(np.concatenate(self.fake_logits, 0))
        return out

    def reset(self) -> None:
        self.psnr.reset()
        self.ssim.reset()
        self.real_feats: list = []
        self.fake_feats: list = []
        self.fake_logits: list = []
