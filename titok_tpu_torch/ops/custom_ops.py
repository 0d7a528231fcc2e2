"""The forward kernels as ``torch.library`` custom ops (namespace ``titok``).

Importing this module registers all four; a process that loads a program
exported by ``tools/export_model.py`` imports it first, and nothing of the
models. Each op is defined beside its kernel and plain version:

- ``titok::segment_attn_fwd`` (``flash_attention_mh.segment_attn_fwd``):
  the segment attention forward, ``(out like q, lse f32 [S, Hq])``;
- ``titok::segment_attn_rope_fwd`` (``flash_attention_mh.segment_attn_rope_fwd``):
  the same over unrotated q and k, RoPE fused;
- ``titok::segment_attn_v1_fwd`` (``flash_attention.segment_attn_v1_fwd``):
  the v1 forward;
- ``titok::vq_nearest`` (``vq_distance.vq_nearest_op``): EMA-VQ's nearest
  code, ``(indices int32 [S], dists f32 [S])``.

Each dispatches by device: the plain PyTorch version for CPU tensors, the
hand-written kernel for CUDA tensors (it launches or raises, and its launch
counter counts), no implementation for any other device. Each has a
``register_fake`` implementation of its outputs, so ``torch.export``
traces a call as one node, whichever device the program runs on later.
Only the no-grad forwards go through the ops: the training path keeps its
``autograd.Function``s.
"""

from __future__ import annotations

from titok_tpu_torch.ops.flash_attention import segment_attn_v1_fwd
from titok_tpu_torch.ops.flash_attention_mh import segment_attn_fwd, segment_attn_rope_fwd
from titok_tpu_torch.ops.vq_distance import vq_nearest_op

OPS = {
    "segment_attn_fwd": segment_attn_fwd,
    "segment_attn_rope_fwd": segment_attn_rope_fwd,
    "segment_attn_v1_fwd": segment_attn_v1_fwd,
    "vq_nearest": vq_nearest_op,
}
