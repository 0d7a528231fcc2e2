"""Fréchet Video Distance (the JAX package's ``titok_tpu/metrics/fvd.py``).

Per set, the mean and covariance of the I3D logits of its clips, then
``|mu1 - mu2|² + tr(S1 + S2 - 2 sqrtm(S1 S2))`` on the host (numpy and
scipy, as JAX's package computes it).

The extractor is picked by the file ``i3d_path`` (or ``TITOK_I3D_PATH``)
names: a converted ``.npz`` (``tools/convert_i3d.py``) runs
:class:`titok_tpu_torch.metrics.i3d.I3DExtractor` on the card; any other
file is loaded as a torchscript I3D, on the same device. Without a file
the first ``update`` raises.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from scipy.linalg import sqrtm


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """The Fréchet distance of two Gaussians (mean, covariance)."""
    diff = mu1 - mu2
    covmean = sqrtm(sigma1.dot(sigma2))
    if isinstance(covmean, tuple):  # older scipy returned (sqrtm, errest)
        covmean = covmean[0]
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def compute_stats(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Mean and covariance of ``[N, D]`` features."""
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


class I3DFeatureExtractor:
    """A torchscript I3D on ``device`` (loaded there by ``map_location``)."""

    def __init__(self, path: str, device=None):
        import torch

        from titok_tpu_torch import resolve_device

        self.device = resolve_device(device)
        self.model = torch.jit.load(path, map_location=self.device).eval()

    def __call__(self, video_bcthw: np.ndarray) -> np.ndarray:
        import torch
        import torch.nn.functional as F

        from titok_tpu_torch.metrics.fp32 import strict_fp32

        with strict_fp32():
            x = torch.from_numpy(np.ascontiguousarray(video_bcthw, np.float32)).to(self.device)
            b, c, t, h, w = x.shape
            if h != 224 or w != 224:
                x = F.interpolate(x, size=(t, 224, 224), mode="trilinear", align_corners=False)
            if t < 10:  # repeat the last frame
                x = torch.cat([x, x[:, :, -1:].repeat(1, 1, 10 - t, 1, 1)], dim=2)
            out = self.model(x, rescale=False, resize=False, return_features=True)
            return out.cpu().numpy()


class FVDCalculator:
    """Accumulates the I3D features of reconstructions and targets over an
    eval epoch."""

    def __init__(self, i3d_path: Optional[str] = None, device=None):
        self.i3d_path = i3d_path or os.environ.get("TITOK_I3D_PATH")
        self.device = device
        self._extractor = None
        self.reset()

    def _get_extractor(self):
        if self._extractor is None:
            if not self.i3d_path or not os.path.exists(self.i3d_path):
                raise RuntimeError(
                    "FVD needs local I3D weights: set TITOK_I3D_PATH or "
                    "training.eval.i3d_path to a converted .npz (preferred, "
                    "runs the port's I3D on the card — tools/convert_i3d.py) or a "
                    "torchscript .pt (zero-egress environment; the reference "
                    "downloads it from Dropbox, fvd.py:27-34).")
            if self.i3d_path.endswith(".npz"):
                from titok_tpu_torch.metrics.i3d import I3DExtractor, load_i3d_params

                self._extractor = I3DExtractor(load_i3d_params(self.i3d_path),
                                               device=self.device)
            else:
                self._extractor = I3DFeatureExtractor(self.i3d_path, device=self.device)
        return self._extractor

    def update(self, recon_bcthw: np.ndarray, target_bcthw: np.ndarray) -> None:
        ex = self._get_extractor()
        self.fake_feats.append(ex(recon_bcthw))
        self.real_feats.append(ex(target_bcthw))

    def compute(self) -> float:
        real = np.concatenate(self.real_feats, axis=0)
        fake = np.concatenate(self.fake_feats, axis=0)
        return frechet_distance(*compute_stats(real), *compute_stats(fake))

    def reset(self) -> None:
        self.real_feats: list[np.ndarray] = []
        self.fake_feats: list[np.ndarray] = []
