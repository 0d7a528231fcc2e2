"""Device-side SSIM over padded frame buffers (the JAX package's
``titok_tpu/metrics/ssim_device.py``).

The host metric's math (``psnr_ssim.py``, the torchmetrics default:
gaussian 11x11 window, sigma 1.5, valid mode, mean over the valid SSIM map
per image, then mean over images) over a static ``[K, Hmax, Wmax, C]``
buffer with per-frame real sizes:

- the separable gaussian filter as two banded matmuls ``A_h @ img @
  A_w^T`` (plain torch matmuls; Hmax is a few hundred);
- frames are zero-padded to (Hmax, Wmax); a window centred at (i, j) with
  ``pad <= i < H - pad`` touches only real rows, so restricting the map
  mean to those centres reproduces the host's valid-mode crop.

Frames smaller than the kernel (min dim < 11) need the host's
shrink-the-kernel fallback: the trainer routes such grids to the host hub.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _band_matrix(n: int, size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """[n, n] same-mode (zero-pad) gaussian correlation matrix."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    k /= k.sum()
    a = np.zeros((n, n), np.float64)
    pad = size // 2
    for i in range(n):
        for t, kv in enumerate(k):
            j = i - pad + t
            if 0 <= j < n:
                a[i, j] = kv
    return a.astype(np.float32)


def ssim_frames_stats(
    x: torch.Tensor,       # [K, H, W, C] recon (already clamped)
    y: torch.Tensor,       # [K, H, W, C] target
    hw: torch.Tensor,      # [K, 2] real (H, W) per frame
    weight: torch.Tensor,  # f32 [K] 1 = real frame, 0 = padding slot
    data_range: float = 2.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
):
    """Returns (ssim_sum, frame_count), f32 0-d tensors: per-frame mean SSIM
    summed over the weighted frames. Accumulate across batches; the metric
    is ``ssim_sum / frame_count``."""
    K, Hm, Wm, C = x.shape
    f32 = torch.float32
    ah = torch.from_numpy(_band_matrix(Hm, kernel_size, sigma)).to(x.device)
    aw = torch.from_numpy(_band_matrix(Wm, kernel_size, sigma)).to(x.device)

    def filt(img):  # [K, H, W, C] -> same-mode gaussian blur
        out = torch.einsum("hH,kHwc->khwc", ah, img)
        return torch.einsum("wW,khWc->khwc", aw, out)

    xf, yf = x.to(f32), y.to(f32)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_x = filt(xf)
    mu_y = filt(yf)
    sigma_x = filt(xf * xf) - mu_x**2
    sigma_y = filt(yf * yf) - mu_y**2
    sigma_xy = filt(xf * yf) - mu_x * mu_y

    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    ssim_map = num / den  # [K, Hm, Wm, C]

    pad = kernel_size // 2
    ii = torch.arange(Hm, dtype=f32, device=x.device)[None, :, None]
    jj = torch.arange(Wm, dtype=f32, device=x.device)[None, None, :]
    h = hw[:, 0].to(f32)[:, None, None]
    w = hw[:, 1].to(f32)[:, None, None]
    valid = ((ii >= pad) & (ii < h - pad) & (jj >= pad) & (jj < w - pad))
    valid = valid.to(f32)[..., None]  # [K, Hm, Wm, 1]

    per_frame = (ssim_map * valid).sum((1, 2, 3)) / torch.clamp(
        valid.sum((1, 2, 3)) * C, min=1.0)
    wsum = weight.to(f32)
    return (per_frame * wsum).sum(), wsum.sum()
