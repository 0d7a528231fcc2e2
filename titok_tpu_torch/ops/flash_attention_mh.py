"""Segment-masked GQA flash attention: hand-written CUDA kernels (forward
and backward, plain and with RoPE fused) and their plain PyTorch versions.

Port of the JAX package's multi-head Pallas kernels in
``titok_tpu/ops/flash_attention_mh.py``: the forward ``_mh_fwd`` →
``_fwd_kernel`` becomes ``csrc/flash_segment_attn_fwd.cu``; the backward
``_mh_bwd`` → ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (the
``custom_vjp`` of ``_mh``) becomes ``csrc/flash_segment_attn_bwd.cu``. The
RoPE-fused pair (``attn_impl: flash_rope``: ``_rope_fwd`` →
``_fwd_kernel_rope``, ``_rope_bwd`` → ``_bwd_dq_kernel_rope`` and
``_bwd_dkv_kernel_rope``, the ``custom_vjp`` ``_mh_rope``) is the
``kRope`` instantiation of the same kernels, with entries of their own.
The source notes say what bounds each on the H100 and how it is laid out.

- :func:`flash_segment_attention_mh` — the entry point the model calls.
  When grad is enabled and an input requires grad it goes through
  :class:`_FlashSegmentAttn`, whose backward runs the backward kernels;
  otherwise (serving, ``torch.inference_mode``) only the forward kernel.
  For a CUDA tensor every wrapper launches its kernel or raises; for a CPU
  tensor it takes the plain version. There is no fallback on the card.
- :func:`_fwd` / :func:`_bwd` — the forward ``(out, lse)`` and the
  backward ``(dq, dk, dv)``.
- :func:`flash_segment_attention_mh_reference` and
  :func:`flash_segment_attention_mh_bwd_reference` — the plain versions,
  computed densely one head and one block of q rows at a time: on the
  packed layout (non-decreasing ids) each segment against its own keys,
  so a 4096-row eval batch of four clips costs a quarter of the dense
  S x S scores (the stacked discriminator buffer has 24,752 rows: one
  dense f32 score matrix for all heads would not fit).
- With ``rope_cos``/``rope_sin`` tables, q and k come in unrotated and
  the rope kernels rotate them as they load them: :class:`_FlashSegmentAttnRope`,
  :func:`_rope_fwd` / :func:`_rope_bwd`, and the plain versions
  :func:`flash_segment_attention_mh_rope_reference` /
  :func:`flash_segment_attention_mh_rope_bwd_reference`.

``launches`` counts kernel launches per kernel and instantiation; a run
reads it to show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from titok_tpu_torch.models.rope import apply_rotary_emb

NEG_INF = -1e30
PAD_ID = 2**30  # pad slots (segment 0) sit after every sample

# kernel launches per kernel and instantiation: "bf16"/"f32" are the forward
# (mma.sync and FMA kernels), "bwd_dq_*"/"bwd_dkv_*" the two backward
# kernels, "rope_*" the same three with RoPE fused, "v1_*" the three v1
# kernels of ops/flash_attention.py
launches = {"bf16": 0, "f32": 0, "bwd_dq_bf16": 0, "bwd_dkv_bf16": 0,
            "bwd_dq_f32": 0, "bwd_dkv_f32": 0,
            "rope_bf16": 0, "rope_f32": 0, "rope_bwd_dq_bf16": 0, "rope_bwd_dkv_bf16": 0,
            "rope_bwd_dq_f32": 0, "rope_bwd_dkv_f32": 0,
            "v1_bf16": 0, "v1_f32": 0, "v1_bwd_dq_bf16": 0, "v1_bwd_dkv_bf16": 0,
            "v1_bwd_dq_f32": 0, "v1_bwd_dkv_f32": 0}
# elements of one dense f32 [q rows, keys] block in the plain versions (1 GiB)
_DENSE_ELEMS = 2**28
# q rows below which a segment shares its dense block with the next
_MIN_BLOCK_ROWS = 64


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _remap_pad(segment_ids: torch.Tensor) -> torch.Tensor:
    """Pad slots (id 0) sit after all samples; remap them above every real
    id so the ids stay non-decreasing."""
    return torch.where(segment_ids == 0,
                       torch.full_like(segment_ids, PAD_ID, dtype=torch.int32),
                       segment_ids.to(torch.int32))


def _segment_blocks(seg_q: torch.Tensor, seg_k: torch.Tensor) -> list[tuple]:
    """``(first q row, end q row, first key, end key, masked)`` blocks that
    hold every live score: with both id vectors non-decreasing (the packed
    layout), each run of one id in ``seg_q`` against the keys of that id
    (unmasked: every score in it is live), runs of fewer than
    ``_MIN_BLOCK_ROWS`` rows merged with the next (masked); else one masked
    block of all rows and keys."""
    S, Sk = seg_q.shape[0], seg_k.shape[0]
    whole = [(0, S, 0, Sk, True)]
    if S < 2 or not (bool((seg_q[1:] >= seg_q[:-1]).all())
                     and bool((seg_k[1:] >= seg_k[:-1]).all())):
        return whole
    ids, counts = torch.unique_consecutive(seg_q, return_counts=True)
    lo = torch.searchsorted(seg_k, ids).tolist()
    hi = torch.searchsorted(seg_k, ids, right=True).tolist()
    ends = torch.cumsum(counts, 0).tolist()
    blocks, a = [], 0
    for i, b in enumerate(ends):
        if blocks and blocks[-1][1] - blocks[-1][0] < _MIN_BLOCK_ROWS:
            a0, _, lo0, _, _ = blocks.pop()
            blocks.append((a0, b, lo0, hi[i], True))
        else:
            blocks.append((a, b, lo[i], hi[i], False))
        a = b
    # a block whose rows see no key keeps the dense form (all masked)
    return [(a, b, lo, hi, m) if hi > lo else (a, b, 0, Sk, True) for a, b, lo, hi, m in blocks]


def _dense_blocks(S: int, Sk: int, Hq: int, blocks: list[tuple] | None = None):
    """(head, first q row, end q row, first key, end key, masked) blocks of
    at most ``_DENSE_ELEMS`` scores each: the q rows of each of ``blocks``
    (:func:`_segment_blocks`; default one masked block of all rows and
    keys) cut into chunks."""
    for h in range(Hq):
        for a0, b0, lo, hi, masked in blocks or [(0, S, 0, Sk, True)]:
            chunk = max(1, _DENSE_ELEMS // max(hi - lo, 1))
            for a in range(a0, b0, chunk):
                yield h, a, min(a + chunk, b0), lo, hi, masked


def _prepare(q, k, segment_ids, scale, k_segment_ids):
    """What both plain versions set up: the GQA ratio, the scale and the
    remapped ids."""
    Hq, D = q.shape[1:]
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hkv}")
    if scale is None:
        scale = D ** -0.5
    seg_q = _remap_pad(segment_ids)
    seg_k = seg_q if k_segment_ids is None else _remap_pad(k_segment_ids)
    return Hq // Hkv, scale, seg_q, seg_k


def flash_segment_attention_mh_reference(
    q: torch.Tensor,  # [S, Hq, D]
    k: torch.Tensor,  # [Sk, Hkv, D]
    v: torch.Tensor,
    segment_ids: torch.Tensor,  # int32 [S]
    scale: float | None = None,
    k_segment_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function computed densely: ``(out [S,Hq,D] in
    q's dtype, lse [S,Hq] f32)``.

    Same arithmetic as the kernel: fp32 logits, masked logits ``-1e30``,
    ``p = mask ? exp(s - m) : 0`` rounded to v's dtype before the PV
    product, ``out = acc / max(l, 1e-30)`` and ``lse = m + log(l)``."""
    S, Hq, D = q.shape
    rep, scale, seg_q, seg_k = _prepare(q, k, segment_ids, scale, k_segment_ids)
    out = torch.empty_like(q)
    lse = torch.empty((S, Hq), dtype=torch.float32, device=q.device)
    blocks = _segment_blocks(seg_q, seg_k)
    for h, a, b, lo, hi, masked in _dense_blocks(S, k.shape[0], Hq, blocks):
        kf = k[lo:hi, h // rep].to(torch.float32)
        s = (q[a:b, h].to(torch.float32) @ kf.T) * scale
        if masked:
            mask = seg_q[a:b, None] == seg_k[None, lo:hi]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        if masked:
            p = torch.where(mask, p, torch.zeros_like(s))
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        acc = p.to(v.dtype).to(torch.float32) @ v[lo:hi, h // rep].to(torch.float32)
        out[a:b, h] = (acc / l).to(q.dtype)
        lse[a:b, h] = (m + torch.log(l))[:, 0]
    return out, lse


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) per head, f32 ``[S, Hq]`` (plain torch ops, as JAX
    computes it outside Pallas)."""
    return (dout.to(torch.float32) * out.to(torch.float32)).sum(-1)


def flash_segment_attention_mh_bwd_reference(
    q: torch.Tensor,  # [S, Hq, D]
    k: torch.Tensor,  # [Sk, Hkv, D]
    v: torch.Tensor,
    segment_ids: torch.Tensor,  # int32 [S]
    out: torch.Tensor,  # [S, Hq, D], the forward's output
    lse: torch.Tensor,  # f32 [S, Hq], the forward's logsumexp
    dout: torch.Tensor,  # [S, Hq, D], the output gradient
    scale: float | None = None,
    k_segment_ids: torch.Tensor | None = None,
    f32_grads: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function computed densely: ``(dq, dk, dv)`` in
    q's dtype (in f32, unrounded, with ``f32_grads``); dk/dv summed over
    each kv head's group of q heads.

    Same arithmetic as the kernels (and ``_bwd_dq_kernel`` /
    ``_bwd_dkv_kernel``): ``p = mask ? exp(s - lse) : 0``, ``ds = p * (dp -
    delta) * scale`` with ``delta = rowsum(dO * O)``; p and ds are rounded
    to q's dtype before the products ``dV = P^T dO``, ``dQ = dS K`` and
    ``dK = dS^T Q``, which accumulate in f32."""
    S, Hq, D = q.shape
    rep, scale, seg_q, seg_k = _prepare(q, k, segment_ids, scale, k_segment_ids)
    dt = q.dtype
    delta = _delta(out, dout)
    f32 = torch.float32
    dq = torch.empty(q.shape, dtype=f32, device=q.device)
    dk = torch.zeros(k.shape, dtype=f32, device=q.device)
    dv = torch.zeros(v.shape, dtype=f32, device=q.device)
    blocks = _segment_blocks(seg_q, seg_k)
    for h, a, b, lo, hi, masked in _dense_blocks(S, k.shape[0], Hq, blocks):
        hk = h // rep
        qf, dof = q[a:b, h].to(f32), dout[a:b, h].to(f32)
        kf, vf = k[lo:hi, hk].to(f32), v[lo:hi, hk].to(f32)
        s = (qf @ kf.T) * scale
        p = torch.exp(s - lse[a:b, h, None])
        if masked:
            p = torch.where(seg_q[a:b, None] == seg_k[None, lo:hi], p, torch.zeros_like(s))
        dv[lo:hi, hk] += p.to(dt).to(f32).T @ dof
        ds = p * (dof @ vf.T - delta[a:b, h, None]) * scale
        ds = ds.to(dt).to(f32)
        dq[a:b, h] = ds @ kf
        dk[lo:hi, hk] += ds.T @ qf
    if f32_grads:
        return dq, dk, dv
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _k_tables(cos, sin, k_cos, k_sin):
    """k's tables: its own when given, else q's (then k has q's rows)."""
    if (k_cos is None) != (k_sin is None):
        raise ValueError("give both k_rope_cos and k_rope_sin, or neither")
    return (cos, sin) if k_cos is None else (k_cos, k_sin)


def _inverse_rotary_f32(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`apply_rotary_emb` on an f32 ``[L, H, D]``
    gradient, kept in f32: pair p < P becomes ``(x0 c + x1 s, x1 c - x0
    s)``, one rounding per product and sum, as the backward kernels apply
    it to their accumulators."""
    L, H, D = x.shape
    P = cos.shape[-1]
    xf = x.reshape(L, H, D // 2, 2)
    x0, x1 = xf[:, :, :P, 0], xf[:, :, :P, 1]
    c, s = cos[:, None, :], sin[:, None, :]
    rot = torch.stack([x0 * c + x1 * s, x1 * c - x0 * s], dim=-1)
    return torch.cat([rot, xf[:, :, P:, :]], dim=2).reshape(L, H, D)


def flash_segment_attention_mh_rope_reference(
    q, k, v, segment_ids, rope_cos, rope_sin, scale=None, k_segment_ids=None,
    k_rope_cos=None, k_rope_sin=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The rope forward kernel's function: q and k rotated by the port's
    :func:`apply_rotary_emb` (fp32, rounded to their dtype), then the plain
    forward. ``rope_cos``/``rope_sin`` f32 ``[S, P]``; k's tables
    ``[Sk, P]`` default to q's."""
    kc, ks = _k_tables(rope_cos, rope_sin, k_rope_cos, k_rope_sin)
    return flash_segment_attention_mh_reference(
        apply_rotary_emb(q, rope_cos, rope_sin), apply_rotary_emb(k, kc, ks), v,
        segment_ids, scale, k_segment_ids)


def flash_segment_attention_mh_rope_bwd_reference(
    q, k, v, segment_ids, rope_cos, rope_sin, out, lse, dout, scale=None,
    k_segment_ids=None, k_rope_cos=None, k_rope_sin=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rope backward kernels' function: the plain backward on the
    rotated q and k with dq and dk kept in f32, the inverse rotation
    applied in f32, then one rounding to q's dtype (the kernels' roundings,
    not those of autograd through :func:`apply_rotary_emb`, which would
    round the rotated grads twice)."""
    kc, ks = _k_tables(rope_cos, rope_sin, k_rope_cos, k_rope_sin)
    dq, dk, dv = flash_segment_attention_mh_bwd_reference(
        apply_rotary_emb(q, rope_cos, rope_sin), apply_rotary_emb(k, kc, ks), v, segment_ids,
        out, lse, dout, scale, k_segment_ids, f32_grads=True)
    dt = q.dtype
    return (_inverse_rotary_f32(dq, rope_cos, rope_sin).to(dt),
            _inverse_rotary_f32(dk, kc, ks).to(dt), dv.to(dt))


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


def _check_rope(q, k, cos, sin, k_cos, k_sin) -> int:
    """The tables the rope kernels take: f32, contiguous, on q's device,
    ``[S, P]`` for q and ``[Sk, P]`` for k with one P in 1..32. Returns P."""
    S, Sk = q.shape[0], k.shape[0]
    P = cos.shape[-1] if cos.dim() == 2 else -1
    for name, t, rows in (("rope_cos", cos, S), ("rope_sin", sin, S),
                          ("k_rope_cos", k_cos, Sk), ("k_rope_sin", k_sin, Sk)):
        if t.shape != (rows, P) or not 1 <= P <= 32:
            raise ValueError(f"{name} is {tuple(t.shape)}: want [{rows}, P] with one P "
                             f"in 1..32 (S={S}, Sk={Sk})")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32, got {t.dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {q.device}")
    return P


def bind_fwd(lib: ctypes.CDLL):
    """The C entries of a ``flash_segment_attn_fwd`` library with their
    argument types: ``(plain, rope)``. The rope entry takes q, k, v, the ids
    and the four tables, then P, then what the plain entry takes after its
    ids."""
    fwd, rope = lib.flash_segment_attn_fwd, lib.flash_segment_attn_rope_fwd
    fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    rope.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    for fn in (fwd, rope):
        fn.restype = ctypes.c_int
    return fwd, rope


def bind_bwd(lib: ctypes.CDLL):
    """The C entries of a ``flash_segment_attn_bwd`` library with their
    argument types: ``(dq, dkv, rope_dq, rope_dkv)``."""
    fns = (lib.flash_segment_attn_bwd_dq, lib.flash_segment_attn_bwd_dkv,
           lib.flash_segment_attn_rope_bwd_dq, lib.flash_segment_attn_rope_bwd_dkv)
    for fn, n_ptr in zip(fns[:2], (9, 10)):
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    for fn, n_ptr in zip(fns[2:], (4, 5)):
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] + [ctypes.c_void_p] * n_ptr + [
            ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    for fn in fns:
        fn.restype = ctypes.c_int
    return fns


@functools.cache
def _libs():
    """``bind_fwd`` and ``bind_bwd`` of ``csrc/flash_segment_attn_{fwd,bwd}.cu``,
    built at first use."""
    from titok_tpu_torch.ops import _build

    return (bind_fwd(_build.load("flash_segment_attn_fwd")),
            bind_bwd(_build.load("flash_segment_attn_bwd")))


def _kernel():
    """The plain forward entry."""
    return _libs()[0][0]


def _bwd_kernels():
    """The plain backward entries ``(dq, dkv)``."""
    return _libs()[1][:2]


def _rope_kernels():
    """The three rope entries ``(forward, dq, dkv)``."""
    (_, fwd), (_, _, dq, dkv) = _libs()
    return fwd, dq, dkv


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


def _check_bwd(q, out, lse, dout) -> None:
    S, Hq, _ = q.shape
    for name, t, shape, dtype in (("out", out, q.shape, q.dtype),
                                  ("dout", dout, q.shape, q.dtype),
                                  ("lse", lse, (S, Hq), torch.float32)):
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype}, want "
                             f"{tuple(shape)} {dtype}")
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"tensor on {q.device}")


def _bwd(q, k, v, segment_ids, out, lse, dout, scale=None,
         k_segment_ids=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``: the two backward kernels for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_segment_attention_mh_bwd_reference(
            q, k, v, segment_ids, out, lse, dout, scale, k_segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    seg_k = segment_ids if k_segment_ids is None else k_segment_ids
    _check(q, k, v, segment_ids, seg_k)
    _check_bwd(q, out, lse, dout)
    S, Hq, D = q.shape
    Sk, Hkv, _ = k.shape
    if scale is None:
        scale = D ** -0.5
    delta = _delta(out, dout)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    key = "bf16" if q.dtype == torch.bfloat16 else "f32"
    dq_fn, dkv_fn = _bwd_kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
                  seg_k.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr())
        tail = (S, Sk, Hq, Hkv, float(scale), int(key == "bf16"), stream)
        err = dq_fn(*common, dq.data_ptr(), *tail)
        if err != 0:
            raise RuntimeError(f"flash_segment_attn_bwd_dq launch failed: CUDA error {err}")
        launches[f"bwd_dq_{key}"] += 1
        err = dkv_fn(*common, dk.data_ptr(), dv.data_ptr(), *tail)
        if err != 0:
            raise RuntimeError(f"flash_segment_attn_bwd_dkv launch failed: CUDA error {err}")
        launches[f"bwd_dkv_{key}"] += 1
    return dq, dk, dv


def _rope_fwd(q, k, v, segment_ids, cos, sin, scale=None, k_segment_ids=None, k_cos=None,
              k_sin=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of attention over unrotated q and k with RoPE fused:
    the rope forward kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_segment_attention_mh_rope_reference(
            q, k, v, segment_ids, cos, sin, scale, k_segment_ids, k_cos, k_sin)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    seg_k = segment_ids if k_segment_ids is None else k_segment_ids
    k_cos, k_sin = _k_tables(cos, sin, k_cos, k_sin)
    _check(q, k, v, segment_ids, seg_k)
    P = _check_rope(q, k, cos, sin, k_cos, k_sin)
    S, Hq, D = q.shape
    Sk, Hkv, _ = k.shape
    if scale is None:
        scale = D ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((S, Hq), dtype=torch.float32, device=q.device)
    is_bf16 = q.dtype == torch.bfloat16
    with torch.cuda.device(q.device):
        err = _rope_kernels()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(), seg_k.data_ptr(),
            cos.data_ptr(), sin.data_ptr(), k_cos.data_ptr(), k_sin.data_ptr(), P,
            out.data_ptr(), lse.data_ptr(), S, Sk, Hq, Hkv, float(scale), int(is_bf16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_segment_attn_rope_fwd launch failed: CUDA error {err}")
    launches["rope_bf16" if is_bf16 else "rope_f32"] += 1
    return out, lse


def _rope_bwd(q, k, v, segment_ids, cos, sin, out, lse, dout, scale=None, k_segment_ids=None,
              k_cos=None, k_sin=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` with respect to the unrotated q and k: the rope dq
    and dk/dv kernels for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_segment_attention_mh_rope_bwd_reference(
            q, k, v, segment_ids, cos, sin, out, lse, dout, scale, k_segment_ids, k_cos, k_sin)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    seg_k = segment_ids if k_segment_ids is None else k_segment_ids
    k_cos, k_sin = _k_tables(cos, sin, k_cos, k_sin)
    _check(q, k, v, segment_ids, seg_k)
    _check_bwd(q, out, lse, dout)
    P = _check_rope(q, k, cos, sin, k_cos, k_sin)
    S, Hq, D = q.shape
    Sk, Hkv, _ = k.shape
    if scale is None:
        scale = D ** -0.5
    delta = _delta(out, dout)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    key = "bf16" if q.dtype == torch.bfloat16 else "f32"
    _, dq_fn, dkv_fn = _rope_kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
                  seg_k.data_ptr(), cos.data_ptr(), sin.data_ptr(), k_cos.data_ptr(),
                  k_sin.data_ptr(), P, dout.data_ptr(), lse.data_ptr(), delta.data_ptr())
        tail = (S, Sk, Hq, Hkv, float(scale), int(key == "bf16"), stream)
        err = dq_fn(*common, dq.data_ptr(), *tail)
        if err != 0:
            raise RuntimeError(f"flash_segment_attn_rope_bwd_dq launch failed: CUDA error {err}")
        launches[f"rope_bwd_dq_{key}"] += 1
        err = dkv_fn(*common, dk.data_ptr(), dv.data_ptr(), *tail)
        if err != 0:
            raise RuntimeError(f"flash_segment_attn_rope_bwd_dkv launch failed: CUDA error {err}")
        launches[f"rope_bwd_dkv_{key}"] += 1
    return dq, dk, dv


class _FlashSegmentAttn(torch.autograd.Function):
    """Segment attention with the hand-written backward (the ``custom_vjp``
    ``_mh`` of the JAX package): the forward saves ``out`` and ``lse``, the
    backward runs the dq and dk/dv kernels (plain version on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, k_segment_ids, scale):
        out, lse = _fwd(q, k, v, segment_ids, scale, k_segment_ids)
        ctx.save_for_backward(q, k, v, segment_ids, k_segment_ids, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, k_segment_ids, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, segment_ids, out, lse,
                          dout.to(q.dtype).contiguous(), ctx.scale, k_segment_ids)
        return dq, dk, dv, None, None, None


class _FlashSegmentAttnRope(torch.autograd.Function):
    """Attention with RoPE fused (the ``custom_vjp`` ``_mh_rope`` of the JAX
    package): the forward saves the raw q and k, the tables, ``out`` and
    ``lse``; the backward runs the rope dq and dk/dv kernels (plain version
    on the CPU). The tables get no grads. Under checkpointing the forward
    runs again in the backward, kernel launch included."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, k_segment_ids, cos, sin, k_cos, k_sin, scale):
        out, lse = _rope_fwd(q, k, v, segment_ids, cos, sin, scale, k_segment_ids, k_cos,
                             k_sin)
        ctx.save_for_backward(q, k, v, segment_ids, k_segment_ids, cos, sin, k_cos, k_sin,
                              out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, k_segment_ids, cos, sin, k_cos, k_sin, out, lse = \
            ctx.saved_tensors
        dq, dk, dv = _rope_bwd(q, k, v, segment_ids, cos, sin, out, lse,
                               dout.to(q.dtype).contiguous(), ctx.scale, k_segment_ids,
                               k_cos, k_sin)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_segment_attention_mh(
    q: torch.Tensor,  # [S, Hq, D]
    k: torch.Tensor,  # [Sk, Hkv, D]
    v: torch.Tensor,
    segment_ids: torch.Tensor,  # int32 [S], non-decreasing; 0 = pad, at the end
    scale: float | None = None,
    k_segment_ids: torch.Tensor | None = None,  # int32 [Sk] (defaults to q's)
    max_seg_len: int | None = None,
    rope_cos: torch.Tensor | None = None,  # f32 [S, P]: fuse RoPE of q (and k)
    rope_sin: torch.Tensor | None = None,
    k_rope_cos: torch.Tensor | None = None,  # f32 [Sk, P] (defaults to q's)
    k_rope_sin: torch.Tensor | None = None,
) -> torch.Tensor:
    """Segment-masked attention ``[S, Hq, D]`` in q's dtype, differentiable
    in q, k and v.

    Segment ids must be non-decreasing once pad (0) is remapped above every
    real id, as the packer lays them out. ``max_seg_len`` is accepted for
    parity with the JAX entry point and not needed: each kernel block
    visits exactly the rows its segments span, so nothing is ever
    truncated. With ``rope_cos``/``rope_sin``, q and k are the UNROTATED
    projections: the kernels rotate them (the first P pairs of each head)
    as they load them, and the grads are those of the unrotated q and k."""
    del max_seg_len
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if rope_cos is not None:
        if rope_sin is None:
            raise ValueError("rope_cos needs rope_sin")
        if grad:
            return _FlashSegmentAttnRope.apply(q, k, v, segment_ids, k_segment_ids, rope_cos,
                                               rope_sin, k_rope_cos, k_rope_sin, float(scale))
        return _rope_fwd(q, k, v, segment_ids, rope_cos, rope_sin, scale, k_segment_ids,
                         k_rope_cos, k_rope_sin)[0]
    if grad:
        return _FlashSegmentAttn.apply(q, k, v, segment_ids, k_segment_ids, float(scale))
    return _fwd(q, k, v, segment_ids, scale, k_segment_ids)[0]
