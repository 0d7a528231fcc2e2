"""Segment-masked (block-diagonal) attention over packed sequences.

Packed samples are *segments* of one ``[S, H, D]`` buffer, and the
reference's varlen mask (``flash_attn_varlen_func``, reference
``model/base/transformer.py:100``) becomes ``segment_ids[i] ==
segment_ids[j]``.

- :func:`segment_attention_reference` — dense masked attention in plain
  torch ops, O(S²) memory; the ground truth, on any device, when the caller
  asks for it.
- :func:`titok_tpu_torch.ops.flash_attention_mh.flash_segment_attention_mh`
  — the hand-written CUDA kernel for CUDA tensors (its plain version for
  CPU tensors); with ``impl='flash_rope'`` the kernels that rotate the
  unrotated q and k by the RoPE tables themselves.

Both handle GQA (q heads a multiple of kv heads) with an fp32 softmax.
"""

from __future__ import annotations

import torch

from titok_tpu_torch.ops.flash_attention_mh import flash_segment_attention_mh

NEG_INF = -1e30


def segment_attention_reference(
    q: torch.Tensor,  # [S, Hq, D]
    k: torch.Tensor,  # [S, Hkv, D]
    v: torch.Tensor,  # [S, Hkv, D]
    segment_ids: torch.Tensor,  # int32 [S]
    scale: float | None = None,
) -> torch.Tensor:
    """Dense masked attention. Returns [S, Hq, D] in q.dtype."""
    S, Hq, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hkv}")
    rep = Hq // Hkv
    if rep > 1:  # q head h reads kv head h // rep (jnp.repeat semantics)
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if scale is None:
        scale = D ** -0.5

    logits = torch.einsum(
        "qhd,khd->hqk", q.to(torch.float32), k.to(torch.float32)
    ) * scale
    mask = segment_ids[:, None] == segment_ids[None, :]  # [S, S]
    logits = torch.where(mask[None], logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum(
        "hqk,khd->qhd", probs.to(v.dtype).to(torch.float32), v.to(torch.float32)
    )
    return out.to(q.dtype)


def segment_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,
    scale: float | None = None,
    impl: str = "auto",
    rope_cos: torch.Tensor | None = None,
    rope_sin: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dispatching entry point used by the transformer.

    ``impl``: 'auto' and 'flash' take the hand-written CUDA kernel for CUDA
    tensors and its plain version for CPU tensors; 'flash_rope' the same
    with RoPE fused (pass UNROTATED q/k plus ``rope_cos``/``rope_sin``);
    'reference' is the dense version on any device. 'flash_v1' names a JAX
    kernel not ported yet.
    """
    if impl in ("auto", "flash"):
        return flash_segment_attention_mh(q, k, v, segment_ids, scale=scale)
    if impl == "flash_rope":
        if rope_cos is None or rope_sin is None:
            raise ValueError("attn_impl 'flash_rope' needs rope_cos and rope_sin")
        return flash_segment_attention_mh(q, k, v, segment_ids, scale=scale,
                                          rope_cos=rope_cos, rope_sin=rope_sin)
    if impl == "reference":
        return segment_attention_reference(q, k, v, segment_ids, scale)
    if impl == "flash_v1":
        raise NotImplementedError(
            "attn_impl 'flash_v1' (head-per-grid-row kernel) is not ported "
            "yet: ROADMAP queue 2 item 5, _flash_fwd/_flash_bwd")
    raise ValueError(f"unknown attention impl {impl!r}")
