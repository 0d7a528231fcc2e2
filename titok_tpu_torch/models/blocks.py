"""Packed ViT encoder/decoder (reference ``model/base/blocks.py``).

The host packer has already laid the clips out in one ``[S, ...]`` buffer
(``data/packing.py``); the modules compute row-wise over every slot and
select per slot type with ``token_mask``:

- Encoder (ref ``blocks.py:31-104``): ``decode_rows`` → ``proj_in`` → split
  pre-norms ``ln_pre_t``/``ln_pre_p`` per slot type → transformer →
  ``ln_post`` → ``proj_out`` to ``token_size`` channels, valid at token slots.
- Decoder (ref ``blocks.py:108-177``): quantized codes at token slots →
  ``proj_in`` + mask token → transformer → ``ln_post`` → ``proj_out`` to
  ``C*prod(patch)``, valid at patch slots.

The shared mask token is one learned **scalar** (``nn.Parameter(1,1)``
broadcast to the width, ``blocks.py:50,96``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from titok_tpu_torch.models.transformer import Dense, ResidualAttentionBlock
from titok_tpu_torch.ops.patchify import decode_rows
from titok_tpu_torch.ops.rmsnorm import RMSNorm

MODEL_DIMS = {
    # model_size: (layers, (q_heads, kv_heads)); width = 64 * q_heads
    # (reference model/base/utils.py:8-23)
    "tiny": (4, (4, 2)),
    "small": (8, (8, 2)),
    "base": (12, (12, 4)),
    "large": (24, (16, 4)),
}
HEAD_DIM = 64


def get_model_dims(model_size: str = "tiny", head_dim: int = HEAD_DIM,
                   mlp_ratio: float = 4.0):
    """width, layers, heads, mlp_ratio (reference ``utils.py:8-23``)."""
    layers, heads = MODEL_DIMS[model_size]
    return head_dim * heads[0], layers, heads, mlp_ratio


class _PackedViT(nn.Module):
    """What the encoder and the decoder share: mask token, split pre-norms,
    transformer and ``ln_post``."""

    def __init__(self, model_size: str, dtype, attn_impl: str, remat: bool = False):
        super().__init__()
        width, num_layers, heads, mlp_ratio = get_model_dims(model_size)
        self.width = width
        self.dtype = dtype
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dtype=torch.float32))
        self.ln_pre_t = RMSNorm(width)
        self.ln_pre_p = RMSNorm(width)
        self.model_layers = ResidualAttentionBlock(
            embed_dim=width, heads=heads, mlp_ratio=mlp_ratio,
            num_layer=num_layers, dtype=dtype, attn_impl=attn_impl, remat=remat)
        self.ln_post = RMSNorm(width)


class PackedEncoder(_PackedViT):
    """ViT encoder over a PackedBatch. Returns ``[S, out_channels]``
    (valid at token slots)."""

    def __init__(self, model_size: str = "tiny", patch_size: Sequence[int] = (4, 8, 8),
                 in_channels: int = 3, out_channels: int = 5, dtype=torch.bfloat16,
                 attn_impl: str = "auto", remat: bool = False):
        super().__init__(model_size, dtype, attn_impl, remat)
        self.proj_in = Dense(in_channels * math.prod(patch_size), self.width,
                             bias=True, dtype=dtype)
        self.proj_out = Dense(self.width, out_channels, bias=True, dtype=dtype)

    def forward(self, patches, token_mask, segment_ids, rope_cos, rope_sin):
        # uint8 wire rows normalize to [-1,1] here; float rows just cast
        x_p = self.proj_in(decode_rows(patches, self.dtype))
        mt = self.mask_token.to(self.dtype)  # scalar, broadcasts to width
        tok_row = self.ln_pre_t(mt.expand(1, self.width))
        x_pat = self.ln_pre_p(x_p + mt)
        x = torch.where(token_mask[:, None], tok_row, x_pat)
        x = self.model_layers(x, rope_cos, rope_sin, segment_ids)
        return self.proj_out(self.ln_post(x))


class PackedDecoder(_PackedViT):
    """ViT decoder over a PackedBatch. Takes ``[S, token_size]`` codes
    (valid at token slots) and returns ``[S, out_channels*prod(patch)]``
    patch pixels (valid at patch slots)."""

    def __init__(self, model_size: str = "tiny", patch_size: Sequence[int] = (4, 8, 8),
                 in_channels: int = 5, out_channels: int = 3, dtype=torch.bfloat16,
                 attn_impl: str = "auto", remat: bool = False):
        super().__init__(model_size, dtype, attn_impl, remat)
        self.proj_in = Dense(in_channels, self.width, bias=True, dtype=dtype)
        self.proj_out = Dense(self.width, out_channels * math.prod(patch_size),
                              bias=True, dtype=dtype)

    def forward(self, tokens, token_mask, segment_ids, rope_cos, rope_sin):
        t = self.proj_in(tokens.to(self.dtype))
        mt = self.mask_token.to(self.dtype)
        tok_rows = self.ln_pre_t(t + mt)
        pat_row = self.ln_pre_p(mt.expand(1, self.width))
        x = torch.where(token_mask[:, None], tok_rows, pat_row)
        x = self.model_layers(x, rope_cos, rope_sin, segment_ids)
        return self.proj_out(self.ln_post(x))
