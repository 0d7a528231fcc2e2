"""Transformer core: GQA attention with sigmoid output gate, GEGLU FFN, and
the KEEL alpha-scaled residual stack.

Semantics follow reference ``model/base/transformer.py``:

- ``Attn`` (ref ``:69-104``): RMSNorm pre-norm; one fused bias-free
  ``to_qkv`` projection producing q + output gate + k + v; RoPE on q and k
  (inside the attention kernels under ``attn_impl: flash_rope``); segment
  attention over the packed buffer; output gated by ``sigmoid(gate)``;
  bias-free ``out_proj``.
- ``GEGLU`` (ref ``:36-56``): inner dim ``mult*(2/3)*dim`` rounded up to a
  multiple of 32; RMSNorm pre-norm; ``gelu(gate) * x`` with exact (erf)
  GELU; no biases.
- ``ResidualAttentionBlock`` (ref ``:107-146``): layer 0 is a pre-LN
  residual; layers >= 1 use ``x = alpha*x + sublayer(x)`` followed by a
  post-RMSNorm with ``alpha = 2 * num_layers`` (KEEL). With ``remat`` each
  ``Attn`` and ``GEGLU`` call is checkpointed (the JAX package's
  ``nn.remat``): its activations are recomputed in the backward.

Submodule names mirror the flax module tree (``attn_0.to_qkv`` …), so the
flax parameters map onto the state dict mechanically (``weights.py``).
Linear layers keep fp32 parameters and compute in the compute dtype, as
flax ``Dense(dtype=bf16, param_dtype=f32)`` does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from titok_tpu_torch.models.rope import apply_rotary_emb
from titok_tpu_torch.ops.attention import segment_attention
from titok_tpu_torch.ops.rmsnorm import RMSNorm


class Dense(nn.Linear):
    """``nn.Linear`` with fp32 parameters that casts its input, weight and
    bias to ``dtype`` before the product (flax ``Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, out_features, bias=bias, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Attn(nn.Module):
    def __init__(self, dim: int, heads: Sequence[int], dtype=torch.bfloat16,
                 attn_impl: str = "auto"):
        super().__init__()
        self.dim = dim
        self.q_heads, self.kv_heads = heads
        self.head_dim = dim // self.q_heads
        self.gqa_dim = self.head_dim * self.kv_heads
        self.attn_impl = attn_impl
        self.pre_ln = RMSNorm(dim)
        self.to_qkv = Dense(dim, 2 * dim + 2 * self.gqa_dim, bias=False, dtype=dtype)
        self.out_proj = Dense(dim, dim, bias=False, dtype=dtype)

    def forward(self, x, rope_cos, rope_sin, segment_ids):
        S = x.shape[0]
        qkv = self.to_qkv(self.pre_ln(x))
        q, gate, k, v = torch.split(
            qkv, [self.dim, self.dim, self.gqa_dim, self.gqa_dim], dim=-1)
        q = q.reshape(S, self.q_heads, self.head_dim)
        k = k.reshape(S, self.kv_heads, self.head_dim)
        v = v.reshape(S, self.kv_heads, self.head_dim).contiguous()
        if self.attn_impl == "flash_rope":
            # the kernels rotate q and k as they load them: pass them raw
            # (copied out of the to_qkv row, as the kernels take [S, H*64])
            o = segment_attention(q.contiguous(), k.contiguous(), v, segment_ids,
                                  impl=self.attn_impl, rope_cos=rope_cos, rope_sin=rope_sin)
        else:
            q = apply_rotary_emb(q, rope_cos, rope_sin)
            k = apply_rotary_emb(k, rope_cos, rope_sin)
            o = segment_attention(q, k, v, segment_ids, impl=self.attn_impl)
        o = o.reshape(S, self.dim) * torch.sigmoid(gate)
        return self.out_proj(o)


class GEGLU(nn.Module):
    def __init__(self, dim: int, mult: float = 4.0, mult_of: int = 32,
                 dtype=torch.bfloat16):
        super().__init__()
        inner = int(mult * (2.0 / 3.0) * dim)
        inner = mult_of * ((inner + mult_of - 1) // mult_of)
        self.norm = RMSNorm(dim)
        self.w12 = Dense(dim, inner * 2, bias=False, dtype=dtype)
        self.w3 = Dense(inner, dim, bias=False, dtype=dtype)

    def forward(self, x):
        h1, gate = self.w12(self.norm(x)).chunk(2, dim=-1)
        return self.w3(F.gelu(gate, approximate="none") * h1)  # exact erf GELU


class ResidualAttentionBlock(nn.Module):
    def __init__(self, embed_dim: int = 512, heads: Sequence[int] = (8, 2),
                 mlp_ratio: float = 4.0, num_layer: int = 2, dtype=torch.bfloat16,
                 attn_impl: str = "auto", remat: bool = False):
        super().__init__()
        self.num_layer = num_layer
        self.remat = remat
        for i in range(num_layer):
            self.add_module(f"attn_{i}", Attn(embed_dim, heads, dtype=dtype,
                                              attn_impl=attn_impl))
            self.add_module(f"ffd_{i}", GEGLU(embed_dim, mult=mlp_ratio, dtype=dtype))
            if i > 0:
                self.add_module(f"attn_post_ln_{i - 1}", RMSNorm(embed_dim))
                self.add_module(f"ffd_post_ln_{i - 1}", RMSNorm(embed_dim))

    def _sublayer(self, module: nn.Module):
        """``module``, or under remat with grad enabled its checkpointed
        call: the backward replays its forward (serving never pays)."""
        if not (self.remat and torch.is_grad_enabled()):
            return module
        # no sublayer draws random numbers, so no RNG state to stash
        return lambda *args: checkpoint(module, *args, use_reentrant=False,
                                        preserve_rng_state=False)

    def forward(self, x, rope_cos, rope_sin, segment_ids):
        # 2 * layers (8, 16, 24 or 48) is exact in bf16, so the scalar equals
        # alpha cast to the compute dtype, as the reference multiplies
        alpha = float(self.num_layer * 2)
        for i in range(self.num_layer):
            attn = self._sublayer(getattr(self, f"attn_{i}"))
            ffd = self._sublayer(getattr(self, f"ffd_{i}"))
            if i == 0:  # standard pre-LN residual (ref :128-130)
                x = x + attn(x, rope_cos, rope_sin, segment_ids)
                x = x + ffd(x)
            else:  # KEEL: alpha-scaled residual + post-LN (ref :141-145)
                x = alpha * x + attn(x, rope_cos, rope_sin, segment_ids)
                x = getattr(self, f"attn_post_ln_{i - 1}")(x)
                x = alpha * x + ffd(x)
                x = getattr(self, f"ffd_post_ln_{i - 1}")(x)
        return x
