"""Device-side PSNR over packed buffers (the JAX package's
``titok_tpu/metrics/psnr_device.py``).

The squared-error sum of the eval epoch stays on the device: patchify is a
permutation of pixels, so the SSE over the valid packed patch rows equals
the pixel SSE of the host metric (``psnr_ssim.py``, global accumulation).

    sse, cnt = packed_psnr_stats(recon_rows, batch)
    # host: accumulate sse/cnt across batches; psnr = 10*log10(4 / (sse/cnt))
"""

from __future__ import annotations

import math

import torch

from titok_tpu_torch.ops.patchify import decode_rows


def packed_psnr_stats(recon_rows: torch.Tensor, batch: dict):
    """(sum_squared_error, pixel_count) over the valid patch rows, f32 0-d
    tensors, with the reconstruction clamped to [-1, 1] as the eval hub
    does."""
    target = decode_rows(batch["patches"], torch.float32)
    recon = torch.clamp(recon_rows.to(torch.float32), -1.0, 1.0)
    mask = ((~batch["token_mask"]) & (batch["segment_ids"] > 0)).to(torch.float32)[:, None]
    sse = ((recon - target) ** 2 * mask).sum()
    cnt = mask.sum() * recon_rows.shape[-1]
    return sse, cnt


def psnr_from_stats(sse: float, cnt: float, data_range: float = 2.0) -> float:
    mse = float(sse) / max(float(cnt), 1.0)
    return float(10 * math.log10(data_range**2 / max(mse, 1e-12)))
