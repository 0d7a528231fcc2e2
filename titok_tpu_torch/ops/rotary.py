"""Rotary position embedding applied to ``[L, H, D]`` heads: a few
elementwise torch ops (reference ``model/base/rope.py:20-27``).

The tables come from ``models/rope.py`` (host, float64 angles). The
rotation sits with the ops so that the attention kernels' plain versions,
and a serving host that loads exported programs, need nothing of the
models.
"""

from __future__ import annotations

import torch


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` ``[L, H, D]`` by per-position tables ``[L, P]``: the
    first P (even, odd) pairs rotate in fp32, the rest pass through; the
    result is cast back to ``x``'s dtype (ref ``rope.py:20-27``)."""
    L, H, D = x.shape
    P = cos.shape[-1]
    xf = x.to(torch.float32).reshape(L, H, D // 2, 2)
    xr, xi = xf[..., 0], xf[..., 1]
    c = cos[:, None, :]  # [L, 1, P]
    s = sin[:, None, :]
    out_r = xr[..., :P] * c - xi[..., :P] * s
    out_i = xr[..., :P] * s + xi[..., :P] * c
    rot = torch.stack([out_r, out_i], dim=-1)
    out = torch.cat([rot, xf[:, :, P:, :]], dim=2).reshape(L, H, D)
    return out.to(x.dtype)
