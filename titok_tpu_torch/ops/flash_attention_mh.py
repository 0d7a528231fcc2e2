"""Segment-masked GQA flash-attention forward: hand-written CUDA kernel and
its plain PyTorch version.

Port of the JAX package's multi-head Pallas kernel (``_mh_fwd`` →
``_fwd_kernel`` in ``titok_tpu/ops/flash_attention_mh.py``). The kernel is
``csrc/flash_segment_attn_fwd.cu``; its source note says what bounds it on
the H100 and how it is laid out.

- :func:`flash_segment_attention_mh` — the entry point the model calls.
  For a CUDA tensor it launches the kernel or raises; for a CPU tensor it
  takes the plain version. There is no fallback on the card.
- :func:`_fwd` — the same, returning ``(out, lse)``.
- :func:`flash_segment_attention_mh_reference` — the plain version,
  computed densely with a logsumexp.

``launches`` counts kernel launches per instantiation; a run reads it to
show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

NEG_INF = -1e30
PAD_ID = 2**30  # pad slots (segment 0) sit after every sample

# kernel launches per instantiation ("bf16": mma.sync kernel, "f32": FMA kernel)
launches = {"bf16": 0, "f32": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _remap_pad(segment_ids: torch.Tensor) -> torch.Tensor:
    """Pad slots (id 0) sit after all samples; remap them above every real
    id so the ids stay non-decreasing."""
    return torch.where(segment_ids == 0,
                       torch.full_like(segment_ids, PAD_ID, dtype=torch.int32),
                       segment_ids.to(torch.int32))


def flash_segment_attention_mh_reference(
    q: torch.Tensor,  # [S, Hq, D]
    k: torch.Tensor,  # [Sk, Hkv, D]
    v: torch.Tensor,
    segment_ids: torch.Tensor,  # int32 [S]
    scale: float | None = None,
    k_segment_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function computed densely: ``(out [S,Hq,D] in q's
    dtype, lse [S,Hq] f32)``.

    Same arithmetic as the kernel: fp32 logits, masked logits ``-1e30``,
    ``p = mask ? exp(s - m) : 0`` rounded to v's dtype before the PV
    product, ``out = acc / max(l, 1e-30)`` and ``lse = m + log(l)``."""
    S, Hq, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hkv}")
    rep = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    seg_q = _remap_pad(segment_ids)
    seg_k = seg_q if k_segment_ids is None else _remap_pad(k_segment_ids)
    kr = k.repeat_interleave(rep, dim=1).to(torch.float32)
    vr = v.repeat_interleave(rep, dim=1)

    s = torch.einsum("qhd,khd->hqk", q.to(torch.float32), kr) * scale
    mask = (seg_q[:, None] == seg_k[None, :])[None]  # [1, S, Sk]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    acc = torch.einsum("hqk,khd->qhd", p.to(v.dtype).to(torch.float32),
                       vr.to(torch.float32))
    out = (acc / l.permute(1, 0, 2)).to(q.dtype)
    lse = (m + torch.log(l))[..., 0].transpose(0, 1).contiguous()
    return out, lse


def _check(q, k, v, seg_q, seg_k) -> None:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"want q [S,Hq,D], k/v [Sk,Hkv,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    S, Hq, D = q.shape
    Sk, Hkv, Dk = k.shape
    if D != 64 or Dk != 64:
        raise ValueError(f"the kernel takes head_dim 64, got {D}/{Dk}")
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hkv}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must all be bf16 or all f32, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if seg_q.dtype != torch.int32 or seg_k.dtype != torch.int32:
        raise ValueError("segment ids must be int32")
    if seg_q.shape != (S,) or seg_k.shape != (Sk,):
        raise ValueError(f"segment ids {tuple(seg_q.shape)}/{tuple(seg_k.shape)} "
                         f"do not match S={S}, Sk={Sk}")
    for name, t in (("q", q), ("k", k), ("v", v), ("segment_ids", seg_q),
                    ("k_segment_ids", seg_k)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


@functools.cache
def _kernel():
    """The C entry point of ``csrc/flash_segment_attn_fwd.cu``, built at
    first use."""
    from titok_tpu_torch.ops import _build

    fn = _build.load("flash_segment_attn_fwd").flash_segment_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _fwd(q, k, v, segment_ids, scale=None,
         k_segment_ids=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out [S,Hq,D], lse [S,Hq] f32)``: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_segment_attention_mh_reference(
            q, k, v, segment_ids, scale, k_segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    seg_k = segment_ids if k_segment_ids is None else k_segment_ids
    _check(q, k, v, segment_ids, seg_k)
    S, Hq, D = q.shape
    Sk, Hkv, _ = k.shape
    if scale is None:
        scale = D ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((S, Hq), dtype=torch.float32, device=q.device)
    is_bf16 = q.dtype == torch.bfloat16
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        segment_ids.data_ptr(), seg_k.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), S, Sk, Hq, Hkv, float(scale),
                        int(is_bf16), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_segment_attn_fwd launch failed: CUDA error {err}")
    launches["bf16" if is_bf16 else "f32"] += 1
    return out, lse


def flash_segment_attention_mh(
    q: torch.Tensor,  # [S, Hq, D]
    k: torch.Tensor,  # [Sk, Hkv, D]
    v: torch.Tensor,
    segment_ids: torch.Tensor,  # int32 [S], non-decreasing; 0 = pad, at the end
    scale: float | None = None,
    k_segment_ids: torch.Tensor | None = None,  # int32 [Sk] (defaults to q's)
    max_seg_len: int | None = None,
) -> torch.Tensor:
    """Segment-masked attention ``[S, Hq, D]`` in q's dtype.

    Segment ids must be non-decreasing once pad (0) is remapped above every
    real id, as the packer lays them out. ``max_seg_len`` is accepted for
    parity with the JAX entry point and not needed: each kernel block
    visits exactly the kv rows its segments span, so nothing is ever
    truncated."""
    del max_seg_len
    return _fwd(q, k, v, segment_ids, scale, k_segment_ids)[0]
