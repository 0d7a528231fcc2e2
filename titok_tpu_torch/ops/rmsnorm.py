"""RMSNorm with fp32 statistics (the reference uses flash-attn's Triton
``RMSNorm``, reference ``transformer.py:5``).

Plain torch ops: statistics in fp32, eps 1e-5, fp32 weight, output cast
back to the input dtype.
"""

from __future__ import annotations

import torch
from torch import nn


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    normed = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (normed * weight.to(torch.float32)).to(x.dtype)


class RMSNorm(nn.Module):
    """Root-mean-square layer norm, weight-only (no bias)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)
