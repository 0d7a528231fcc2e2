"""PSNR / SSIM accumulators on the host, torchmetrics semantics (the JAX
package's ``titok_tpu/metrics/psnr_ssim.py``, numpy and scipy).

- PSNR: *global* accumulation, the sum of squared errors and the element
  count over every update; ``10*log10(range^2 / mse_total)``.
- SSIM: gaussian 11x11 window, sigma 1.5, k1 0.01, k2 0.03, the mean of the
  valid-region SSIM map per image, averaged over all images; images
  smaller than the window get a smaller odd window.
"""

from __future__ import annotations

import numpy as np


def _gaussian_kernel1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return k / k.sum()


def _filter2d_valid(img: np.ndarray, k1d: np.ndarray) -> np.ndarray:
    """Separable 2D valid-mode correlation over the last two axes."""
    from scipy.ndimage import correlate1d

    pad = len(k1d) // 2
    out = correlate1d(img, k1d, axis=-1, mode="constant")
    out = correlate1d(out, k1d, axis=-2, mode="constant")
    return out[..., pad:-pad, pad:-pad]


def ssim_image(x: np.ndarray, y: np.ndarray, data_range: float = 2.0,
               kernel_size: int = 11, sigma: float = 1.5,
               k1: float = 0.01, k2: float = 0.03) -> float:
    """SSIM of one CHW image pair, valid-window gaussian."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    min_dim = min(x.shape[-2:])
    if min_dim < kernel_size:
        kernel_size = min_dim if min_dim % 2 == 1 else min_dim - 1
    k = _gaussian_kernel1d(kernel_size, sigma)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_x = _filter2d_valid(x, k)
    mu_y = _filter2d_valid(y, k)
    sigma_x = _filter2d_valid(x * x, k) - mu_x**2
    sigma_y = _filter2d_valid(y * y, k) - mu_y**2
    sigma_xy = _filter2d_valid(x * y, k) - mu_x * mu_y

    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    return float((num / den).mean())


class PSNRMetric:
    """Global-accumulation PSNR (torchmetrics default)."""

    def __init__(self, data_range: float = 2.0):
        self.data_range = data_range
        self.reset()

    def update(self, pred: np.ndarray, target: np.ndarray) -> None:
        diff = np.asarray(pred, np.float64) - np.asarray(target, np.float64)
        self.sse += float((diff**2).sum())
        self.count += diff.size

    def compute(self) -> float:
        if self.count == 0:
            return float("nan")
        mse = self.sse / self.count
        return float(10 * np.log10(self.data_range**2 / max(mse, 1e-12)))

    def reset(self) -> None:
        self.sse = 0.0
        self.count = 0


class SSIMMetric:
    """Mean-over-images SSIM (torchmetrics default reduction)."""

    def __init__(self, data_range: float = 2.0):
        self.data_range = data_range
        self.reset()

    def update(self, pred: np.ndarray, target: np.ndarray) -> None:
        """pred/target: [N, C, H, W] image batches."""
        for p, t in zip(pred, target):
            self.total += ssim_image(p, t, self.data_range)
            self.count += 1

    def compute(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def reset(self) -> None:
        self.total = 0.0
        self.count = 0
