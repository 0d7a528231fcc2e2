"""Finite Scalar Quantization (FSQ) — https://arxiv.org/abs/2309.15505.

Semantics match the reference quantizer (reference ``model/quantizer/fsq.py``):
tanh bound with per-level half-width and even-level offset (``fsq.py:78-83``),
straight-through rounding (``fsq.py:48-51``), renormalization to [-1, 1]
(``fsq.py:85-90``), and a mixed-radix index codec with
``basis = cumprod([1] + levels[:-1])`` (``fsq.py:66,105-121``).

The whole quantizer is an fp32 island whatever the compute dtype: FSQ's
rounding boundary must not move with bf16 noise. Elementwise torch ops; no
parameters.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn


def round_ste(z: torch.Tensor) -> torch.Tensor:
    """Round with straight-through gradients (reference ``fsq.py:48-51``).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    return z + (torch.round(z) - z).detach()


class FSQ(nn.Module):
    """Stateless FSQ codec over the last axis (size ``len(levels)``). Its
    constants are non-persistent buffers: they follow the module's device
    and stay out of the state dict."""

    def __init__(self, levels: Sequence[int]):
        super().__init__()
        self.levels_list = [int(l) for l in levels]
        self.codebook_dim = len(self.levels_list)
        self.codebook_size = int(np.prod(self.levels_list))
        levels_np = np.asarray(self.levels_list, np.int32)
        consts = {
            "levels": torch.from_numpy(levels_np),
            "basis": torch.from_numpy(np.cumprod([1] + self.levels_list[:-1]).astype(np.int32)),
            "levels_f": torch.from_numpy(levels_np.astype(np.float32)),
            "half_width": torch.from_numpy((levels_np // 2).astype(np.float32)),
            "offset": torch.from_numpy(np.where(levels_np % 2 == 0, 0.5, 0.0).astype(np.float32)),
        }
        for name, t in consts.items():
            self.register_buffer(name, t, persistent=False)

    # -- quantization ---------------------------------------------------
    def bound(self, z: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
        """Bound ``z`` (reference ``fsq.py:78-83``)."""
        half_l = (self.levels_f - 1.0) * (1.0 + eps) / 2.0
        shift = torch.atanh(self.offset / half_l)
        return torch.tanh(z + shift) * half_l - self.offset

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """Quantize to the normalized [-1, 1] code grid (``fsq.py:85-90``)."""
        return round_ste(self.bound(z)) / self.half_width

    # -- index codec ------------------------------------------------------
    def codes_to_indices(self, zhat: torch.Tensor) -> torch.Tensor:
        """Normalized codes -> int32 codebook indices (``fsq.py:105-109``)."""
        # round to kill fp jitter before the integer dot with the basis
        zi = torch.round(zhat * self.half_width + self.half_width).to(torch.int32)
        return (zi * self.basis).sum(dim=-1).to(torch.int32)

    def indices_to_level_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """Indices -> per-level digit (``fsq.py:111-115``), int32 floor-div
        and mod."""
        idx = indices.to(torch.int32)[..., None]
        return torch.remainder(torch.div(idx, self.basis, rounding_mode="floor"),
                               self.levels)

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        """Inverse of ``codes_to_indices`` (``fsq.py:117-121``)."""
        level = self.indices_to_level_indices(indices).to(torch.float32)
        return (level - self.half_width) / self.half_width

    def implicit_codebook(self) -> np.ndarray:
        """All codebook vectors, shape [codebook_size, dim] (``fsq.py:75-76``)."""
        idx = torch.arange(self.codebook_size, dtype=torch.int32, device=self.levels.device)
        return self.indices_to_codes(idx).cpu().numpy()

    # -- forward ----------------------------------------------------------
    def forward(self, z: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """Quantize ``[..., dim]`` latents in fp32. Returns ``(codes,
        {'indices': int32[...]})`` with codes cast back to the input dtype."""
        orig_dtype = z.dtype
        codes = self.quantize(z.to(torch.float32))
        return codes.to(orig_dtype), {"indices": self.codes_to_indices(codes)}
