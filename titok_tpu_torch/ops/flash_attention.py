"""Segment-masked GQA flash attention, the v1 kernels (``attn_impl:
flash_v1``): hand-written CUDA kernels and their plain PyTorch versions.

Port of the JAX package's ``titok_tpu/ops/flash_attention.py``: the forward
``_flash_fwd`` → ``_fwd_kernel`` and the backward ``_flash_bwd`` →
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (the ``custom_vjp`` of
``_flash``) become ``csrc/flash_segment_attn_v1.cu``. It computes the
function of ``flash_attention_mh`` for q, k and v of one length; what is
v1's own is where the forward rounds p (against the running max after each
64-row kv tile aligned to row 0 of S) and that dk/dv is computed for each q
head and rounded to the input dtype before the sum over each GQA group (JAX
sums in XLA).

Every kernel is an instantiation of the multi-head kernels' pipelined
templates (``csrc/segment_attn_{fwd,dq,dkv}.cuh``): each CTA searches the
ids for its exact interval, so no v1 kernel reads tile intervals and the
wrapper computes none. In bf16 the forward's kv tiles are aligned to row 0
as above, and dk/dv rounds each head before the group sum; in f32 nothing
is rounded, so the forward and dk/dv are the multi-head f32 kernels on one
id vector. The dq is the multi-head dq in either dtype. The dk/dv kernel
writes the group sums itself, in either dtype. The source notes say what
bounds the kernels on the H100.

- :func:`flash_segment_attention` — the entry point ``attn_impl:
  flash_v1`` reaches. With grad enabled and an input that requires grad
  it goes through :class:`_FlashSegmentAttnV1`, whose backward runs the
  dq and dk/dv kernels; otherwise only the forward kernel, through the
  custom op :func:`segment_attn_v1_fwd` (``ops/custom_ops.py``). For a CUDA
  tensor every wrapper launches its kernel or raises; for a CPU tensor it
  takes the plain version. There is no fallback on the card.
- :func:`flash_segment_attention_reference` and
  :func:`flash_segment_attention_bwd_reference` — the plain versions. The
  forward repeats the kernel's online softmax tile by tile (p rounded to
  v's dtype against the running max after each kv tile of ``block`` rows),
  so in bf16 it rounds p where the kernel does; the backward rounds each q
  head's dk/dv before the group sum.
- :func:`launch_fwd`, :func:`launch_bwd_dq`, :func:`launch_bwd_dkv` — the
  kernels' C entries.

Launches are counted in ``flash_attention_mh.launches`` under ``v1_*``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from titok_tpu_torch.ops.flash_attention_mh import (
    NEG_INF,
    _check,
    _check_bwd,
    _delta,
    _out_lse_fake,
    _remap_pad,
    launches,
)

# the kv tile of the bf16 forward, aligned to row 0: where the kernel rounds p
# against a new max
BLOCK = 64
# elements of one dense f32 [q rows, S] block in the plain versions (256 MiB)
_DENSE_ELEMS = 2**26


def _prepare(q, k, segment_ids, scale):
    S, Hq, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hkv}")
    if k.shape[0] != S or segment_ids.shape != (S,):
        raise ValueError(f"v1 attention needs one length: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, ids {tuple(segment_ids.shape)}")
    return Hq // Hkv, (D ** -0.5 if scale is None else scale), _remap_pad(segment_ids)


def _row_chunks(S: int, Hq: int):
    """(head, first q row, end q row) with at most ``_DENSE_ELEMS`` scores."""
    chunk = max(1, _DENSE_ELEMS // max(S, 1))
    for h in range(Hq):
        for a in range(0, S, chunk):
            yield h, a, min(a + chunk, S)


def group_sum(x_h: torch.Tensor, hkv: int) -> torch.Tensor:
    """``[S, Hq, D]`` per-q-head grads → ``[S, Hkv, D]``: summed over each
    kv head's group of q heads in f32, rounded once to ``x_h``'s dtype
    (JAX: ``dk_h.reshape(Hkv, rep, S, D).sum(1)``)."""
    S, Hq, D = x_h.shape
    return x_h.view(S, hkv, Hq // hkv, D).sum(2, dtype=torch.float32).to(x_h.dtype)


def flash_segment_attention_reference(
    q: torch.Tensor,  # [S, Hq, D]
    k: torch.Tensor,  # [S, Hkv, D]
    v: torch.Tensor,
    segment_ids: torch.Tensor,  # int32 [S]
    scale: float | None = None,
    block: int = BLOCK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function: ``(out [S,Hq,D] in q's dtype, lse
    [S,Hq] f32)``, computed densely one head and one chunk of q rows at a
    time, with the kernel's roundings.

    The kernel's online softmax visits kv tiles of ``block`` rows in order:
    after tile t the running max is ``m_t`` (a cumulative max over tiles),
    ``p = mask ? exp(s - m_t) : 0`` is rounded to v's dtype before the PV
    product, and earlier sums are rescaled by ``exp(m_{t-1} - m_t)``. Here
    the same ``m_t`` come from ``cummax`` over the tile maxima, and each
    tile's sums are rescaled to the final max at once, which differs from
    the kernel's chain of rescalings only in f32 rounding. ``l`` sums the
    unrounded p; ``out = acc / max(l, 1e-30)``, ``lse = m + log(l)``.
    Tiles the kernel skips are fully masked here, which changes nothing."""
    S, Hq, D = q.shape
    rep, scale, seg = _prepare(q, k, segment_ids, scale)
    f32 = torch.float32
    n = -(-S // block)
    pad = n * block - S
    out = torch.empty_like(q)
    lse = torch.empty((S, Hq), dtype=f32, device=q.device)
    for h, a, b in _row_chunks(S, Hq):
        s = (q[a:b, h].to(f32) @ k[:, h // rep].to(f32).T) * scale
        mask = seg[a:b, None] == seg[None, :]
        if pad:
            s = torch.nn.functional.pad(s, (0, pad))
            mask = torch.nn.functional.pad(mask, (0, pad))
        s = torch.where(mask, s, torch.full_like(s, NEG_INF)).view(b - a, n, block)
        mask = mask.view(b - a, n, block)
        m_t = torch.cummax(s.amax(-1), dim=1).values  # running max after each tile
        p = torch.where(mask, torch.exp(s - m_t[..., None]), torch.zeros_like(s))
        m = m_t[:, -1:]
        c = torch.exp(m_t - m)  # each tile's rescaling to the final max
        l = torch.clamp((p.sum(-1) * c).sum(-1, keepdim=True), min=1e-30)
        pv = (p.to(v.dtype).to(f32) * c[..., None]).view(b - a, n * block)[:, :S]
        acc = pv @ v[:, h // rep].to(f32)
        out[a:b, h] = (acc / l).to(q.dtype)
        lse[a:b, h] = (m + torch.log(l))[:, 0]
    return out, lse


def flash_segment_attention_bwd_reference(
    q: torch.Tensor,  # [S, Hq, D]
    k: torch.Tensor,  # [S, Hkv, D]
    v: torch.Tensor,
    segment_ids: torch.Tensor,  # int32 [S]
    out: torch.Tensor,  # [S, Hq, D], the forward's output
    lse: torch.Tensor,  # f32 [S, Hq], the forward's logsumexp
    dout: torch.Tensor,  # [S, Hq, D]
    scale: float | None = None,
    per_head: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function: ``(dq, dk, dv)`` in q's dtype, or
    with ``per_head`` ``(dq, dk_h, dv_h)`` with dk_h/dv_h ``[S, Hq, D]``,
    each q head's share.

    Same arithmetic as ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``: ``p = mask
    ? exp(s - lse) : 0``, ``dp = dO V^T``, ``ds = p * (dp - delta) * scale``
    with ``delta = rowsum(dO * O)``; p and ds rounded to the input dtype
    before ``dQ = dS K``, ``dV_h = P^T dO`` and ``dK_h = dS^T Q``, which
    accumulate in f32. Each q head's dk/dv is rounded to the input dtype,
    then :func:`group_sum` adds each group's heads."""
    S, Hq, D = q.shape
    rep, scale, seg = _prepare(q, k, segment_ids, scale)
    dt, f32 = q.dtype, torch.float32
    delta = _delta(out, dout)
    dq = torch.empty(q.shape, dtype=f32, device=q.device)
    dk_h = torch.zeros(q.shape, dtype=f32, device=q.device)
    dv_h = torch.zeros(q.shape, dtype=f32, device=q.device)
    for h, a, b in _row_chunks(S, Hq):
        kf, vf = k[:, h // rep].to(f32), v[:, h // rep].to(f32)
        qf, dof = q[a:b, h].to(f32), dout[a:b, h].to(f32)
        mask = seg[a:b, None] == seg[None, :]
        s = (qf @ kf.T) * scale
        p = torch.where(mask, torch.exp(s - lse[a:b, h, None]), torch.zeros_like(s))
        dv_h[:, h] += p.to(dt).to(f32).T @ dof
        ds = (p * (dof @ vf.T - delta[a:b, h, None]) * scale).to(dt).to(f32)
        dq[a:b, h] = ds @ kf
        dk_h[:, h] += ds.T @ qf
    dq, dk_h, dv_h = dq.to(dt), dk_h.to(dt), dv_h.to(dt)
    if per_head:
        return dq, dk_h, dv_h
    Hkv = k.shape[1]
    return dq, group_sum(dk_h, Hkv), group_sum(dv_h, Hkv)


def bind_v1(lib: ctypes.CDLL):
    """The three C entry points of a ``flash_segment_attn_v1`` library (fwd,
    dq, dkv) with their argument types. Each takes q, k, v and the ids, then
    its own buffers, then S, the head counts, the scale, the dtype flag and
    the stream; none takes tile intervals."""
    fns = (lib.flash_segment_attn_v1_fwd, lib.flash_segment_attn_v1_bwd_dq,
           lib.flash_segment_attn_v1_bwd_dkv)
    for fn, n_ptr in zip(fns, (2, 4, 5)):
        fn.argtypes = [ctypes.c_void_p] * (4 + n_ptr) + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


@functools.cache
def _kernels():
    """:func:`bind_v1` of ``csrc/flash_segment_attn_v1.cu``, built at first
    use."""
    from titok_tpu_torch.ops import _build

    return bind_v1(_build.load("flash_segment_attn_v1"))


def _key(q: torch.Tensor) -> str:
    return "bf16" if q.dtype == torch.bfloat16 else "f32"


def _common(q, k, v, seg):
    """Checks of a launch; returns (key, S, Hq, Hkv, stream)."""
    if q.device.type != "cuda":
        raise ValueError(f"the v1 kernels run on CUDA tensors, got {q.device}")
    S, Hq, _ = q.shape
    if k.shape[0] != S:
        raise ValueError(f"v1 attention needs Sq == Sk, got {S} and {k.shape[0]}")
    _check(q, k, v, seg, seg)
    return _key(q), S, Hq, k.shape[1], torch.cuda.current_stream(q.device).cuda_stream


def launch_fwd(q, k, v, seg, scale) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA tensors: ``(out, lse [S, Hq] f32)``."""
    key, S, Hq, Hkv, stream = _common(q, k, v, seg)
    out = torch.empty_like(q)
    lse = torch.empty((S, Hq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernels()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                            out.data_ptr(), lse.data_ptr(), S, Hq, Hkv, float(scale),
                            int(key == "bf16"), stream)
    if err != 0:
        raise RuntimeError(f"flash_segment_attn_v1_fwd launch failed: CUDA error {err}")
    launches[f"v1_{key}"] += 1
    return out, lse


def launch_bwd_dq(q, k, v, seg, dout, lse, delta, scale) -> torch.Tensor:
    """The dq kernel, the row 2 dq on one id vector."""
    key, S, Hq, Hkv, stream = _common(q, k, v, seg)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernels()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                            S, Hq, Hkv, float(scale), int(key == "bf16"), stream)
    if err != 0:
        raise RuntimeError(f"flash_segment_attn_v1_bwd_dq launch failed: CUDA error {err}")
    launches[f"v1_bwd_dq_{key}"] += 1
    return dq


def launch_bwd_dkv(q, k, v, seg, dout, lse, delta, scale) -> tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel: ``(dk, dv)`` ``[S, Hkv, D]``, summed over each
    group in the kernel; in bf16 each q head's share rounded to bf16 first,
    as :func:`group_sum` sums the plain version's."""
    key, S, Hq, Hkv, stream = _common(q, k, v, seg)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _kernels()[2](q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                            dv.data_ptr(), S, Hq, Hkv, float(scale), int(key == "bf16"), stream)
    if err != 0:
        raise RuntimeError(f"flash_segment_attn_v1_bwd_dkv launch failed: CUDA error {err}")
    launches[f"v1_bwd_dkv_{key}"] += 1
    return dk, dv


def _fwd(q, k, v, segment_ids, scale=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: the forward kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_segment_attention_reference(q, k, v, segment_ids, scale)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return launch_fwd(q, k, v, segment_ids, scale)


def _bwd(q, k, v, segment_ids, out, lse, dout,
         scale=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``: the dq and dk/dv kernels for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_segment_attention_bwd_reference(q, k, v, segment_ids, out, lse, dout, scale)
    _check_bwd(q, out, lse, dout)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    delta = _delta(out, dout)
    dq = launch_bwd_dq(q, k, v, segment_ids, dout, lse, delta, scale)
    dk, dv = launch_bwd_dkv(q, k, v, segment_ids, dout, lse, delta, scale)
    return dq, dk, dv


@torch.library.custom_op("titok::segment_attn_v1_fwd", mutates_args=(), device_types="cpu")
def segment_attn_v1_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        segment_ids: torch.Tensor,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The v1 forward ``(out, lse)`` as the custom op
    ``torch.ops.titok.segment_attn_v1_fwd``: the plain version for CPU
    tensors, the kernel (launch counted) for CUDA tensors, no
    implementation for any other device. What :func:`flash_segment_attention`
    calls without grad."""
    return flash_segment_attention_reference(q, k, v, segment_ids, scale)


@segment_attn_v1_fwd.register_kernel("cuda")
def _(q, k, v, segment_ids, scale):
    return launch_fwd(q, k, v, segment_ids, scale)


@segment_attn_v1_fwd.register_fake
def _(q, k, v, segment_ids, scale):
    return _out_lse_fake(q)


class _FlashSegmentAttnV1(torch.autograd.Function):
    """v1 attention with the hand-written backward (the ``custom_vjp``
    ``_flash`` of the JAX package): the forward saves ``out`` and ``lse``,
    the backward runs the dq and dk/dv kernels (plain version on the CPU).
    Under checkpointing the forward runs again in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, scale):
        out, lse = _fwd(q, k, v, segment_ids, scale)
        ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, segment_ids, out, lse, dout.to(q.dtype).contiguous(),
                          ctx.scale)
        return dq, dk, dv, None, None


def flash_segment_attention(
    q: torch.Tensor,  # [S, Hq, D]
    k: torch.Tensor,  # [S, Hkv, D]
    v: torch.Tensor,
    segment_ids: torch.Tensor,  # int32 [S], non-decreasing; 0 = pad, at the end
    scale: float | None = None,
) -> torch.Tensor:
    """Segment-masked attention ``[S, Hq, D]`` in q's dtype through the v1
    kernels, differentiable in q, k and v. q, k and v have one length S;
    ids must be non-decreasing once pad (0) is remapped above every real id,
    as the packer lays them out (the kernels' search of the ids relies on
    it)."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashSegmentAttnV1.apply(q, k, v, segment_ids, scale)
    return segment_attn_v1_fwd(q, k, v, segment_ids, scale)[0]
