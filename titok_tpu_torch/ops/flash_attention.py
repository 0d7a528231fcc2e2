"""Segment-masked GQA flash attention, the v1 kernels (``attn_impl:
flash_v1``): hand-written CUDA kernels and their plain PyTorch versions.

Port of the JAX package's ``titok_tpu/ops/flash_attention.py``: the forward
``_flash_fwd`` → ``_fwd_kernel`` and the backward ``_flash_bwd`` →
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (the ``custom_vjp`` of
``_flash``) become ``csrc/flash_segment_attn_v1.cu``. It computes the
function of ``flash_attention_mh`` for q, k and v of one length, with v1's
own design: per-tile [min, max] ids computed here by torch ops (JAX's
``_block_minmax``), tile pairs skipped where those intervals do not
overlap, and dk/dv computed for each q head and rounded to the input dtype
before the sum over each GQA group, which is a torch op here as it is an
XLA op in JAX. The source notes say what bounds the kernels on the H100.

- :func:`flash_segment_attention` — the entry point ``attn_impl:
  flash_v1`` reaches. With grad enabled and an input that requires grad
  it goes through :class:`_FlashSegmentAttnV1`, whose backward runs the
  dq and dk/dv kernels; otherwise only the forward kernel. For a CUDA
  tensor every wrapper launches its kernel or raises; for a CPU tensor it
  takes the plain version. There is no fallback on the card.
- :func:`flash_segment_attention_reference` and
  :func:`flash_segment_attention_bwd_reference` — the plain versions. The
  forward repeats the kernel's online softmax tile by tile (p rounded to
  v's dtype against the running max after each kv tile of ``block`` rows),
  so in bf16 it rounds p where the kernel does; the backward rounds each q
  head's dk/dv before the group sum.
- :func:`launch_fwd`, :func:`launch_bwd_dq`, :func:`launch_bwd_dkv` — the
  kernels' C entries on given tile intervals (:func:`tile_minmax`).

Launches are counted in ``flash_attention_mh.launches`` under ``v1_*``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from titok_tpu_torch.ops.flash_attention_mh import (
    NEG_INF,
    PAD_ID,
    _check,
    _check_bwd,
    _delta,
    _remap_pad,
    launches,
)

# tile rows (q, kv) of each kernel, as csrc/flash_segment_attn_v1.cu has them
TILES = {"fwd": {"bf16": (64, 64), "f32": (64, 32)},
         "dq": {"bf16": (64, 64), "f32": (32, 32)},
         "dkv": {"bf16": (64, 64), "f32": (32, 32)}}
# the kv tile of the bf16 forward: where the kernel rounds p against a new max
BLOCK = TILES["fwd"]["bf16"][1]
# ids of the rows that complete the last tile (JAX pads S with 2^30 + 1)
TAIL_ID = PAD_ID + 1
# elements of one dense f32 [q rows, S] block in the plain versions (256 MiB)
_DENSE_ELEMS = 2**26


def tile_minmax(segment_ids: torch.Tensor, tile: int) -> torch.Tensor:
    """int32 ``[ceil(S / tile), 2]``: (min, max) of the remapped ids of each
    tile of ``tile`` rows, the last tile completed with ``TAIL_ID`` (JAX's
    ``_block_minmax`` of the padded ids)."""
    seg = _remap_pad(segment_ids)
    S = seg.shape[0]
    n = -(-S // tile)
    if n * tile != S:
        seg = torch.cat([seg, seg.new_full((n * tile - S,), TAIL_ID)])
    s = seg.view(n, tile)
    return torch.stack([s.amin(1), s.amax(1)], dim=1).contiguous()


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


@functools.cache
def _kernels():
    """The three C entry points of ``csrc/flash_segment_attn_v1.cu`` (fwd,
    dq, dkv), built at first use. Each takes q, k, v, the ids, the q and kv
    tile intervals and their tile sizes, then its own buffers, then S, the
    head counts, the scale, the dtype flag and the stream."""
    from titok_tpu_torch.ops import _build

    lib = _build.load("flash_segment_attn_v1")
    fns = (lib.flash_segment_attn_v1_fwd, lib.flash_segment_attn_v1_bwd_dq,
           lib.flash_segment_attn_v1_bwd_dkv)
    for fn, n_ptr in zip(fns, (2, 4, 5)):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * n_ptr + [
            ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


def _key(q: torch.Tensor) -> str:
    return "bf16" if q.dtype == torch.bfloat16 else "f32"


def _check_mm(S: int, tiles: tuple[int, int], qmm: torch.Tensor, kmm: torch.Tensor, device):
    for name, mm, tile in (("qmm", qmm, tiles[0]), ("kmm", kmm, tiles[1])):
        want = (-(-S // tile), 2)
        if mm.shape != want or mm.dtype != torch.int32 or mm.device != device \
                or not mm.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 {want} on {device} (tiles of "
                             f"{tile} rows), got {tuple(mm.shape)} {mm.dtype} {mm.device}")


def _common(q, k, v, seg, qmm, kmm, kind):
    """Checks of a launch; returns (key, tiles, S, Hq, Hkv, stream)."""
    if q.device.type != "cuda":
        raise ValueError(f"the v1 kernels run on CUDA tensors, got {q.device}")
    S, Hq, _ = q.shape
    if k.shape[0] != S:
        raise ValueError(f"v1 attention needs Sq == Sk, got {S} and {k.shape[0]}")
    _check(q, k, v, seg, seg)
    key = _key(q)
    tiles = TILES[kind][key]
    _check_mm(S, tiles, qmm, kmm, q.device)
    return key, tiles, S, Hq, k.shape[1], torch.cuda.current_stream(q.device).cuda_stream


def launch_fwd(q, k, v, seg, qmm, kmm, scale) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA tensors and the tile intervals ``qmm`` /
    ``kmm`` (``TILES['fwd']``): ``(out, lse [S, Hq] f32)``."""
    key, tiles, S, Hq, Hkv, stream = _common(q, k, v, seg, qmm, kmm, "fwd")
    out = torch.empty_like(q)
    lse = torch.empty((S, Hq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernels()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                            qmm.data_ptr(), kmm.data_ptr(), *tiles, out.data_ptr(),
                            lse.data_ptr(), S, Hq, Hkv, float(scale), int(key == "bf16"),
                            stream)
    if err != 0:
        raise RuntimeError(f"flash_segment_attn_v1_fwd launch failed: CUDA error {err}")
    launches[f"v1_{key}"] += 1
    return out, lse


def launch_bwd_dq(q, k, v, seg, qmm, kmm, dout, lse, delta, scale) -> torch.Tensor:
    """The dq kernel on the tile intervals of ``TILES['dq']``."""
    key, tiles, S, Hq, Hkv, stream = _common(q, k, v, seg, qmm, kmm, "dq")
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernels()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                            qmm.data_ptr(), kmm.data_ptr(), *tiles, dout.data_ptr(),
                            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), S, Hq, Hkv,
                            float(scale), int(key == "bf16"), stream)
    if err != 0:
        raise RuntimeError(f"flash_segment_attn_v1_bwd_dq launch failed: CUDA error {err}")
    launches[f"v1_bwd_dq_{key}"] += 1
    return dq


def launch_bwd_dkv(q, k, v, seg, qmm, kmm, dout, lse, delta,
                   scale) -> tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel on the tile intervals of ``TILES['dkv']``: each q
    head's ``(dk_h, dv_h)``, ``[S, Hq, D]`` in the input dtype."""
    key, tiles, S, Hq, Hkv, stream = _common(q, k, v, seg, qmm, kmm, "dkv")
    dk_h, dv_h = torch.empty_like(q), torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernels()[2](q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                            qmm.data_ptr(), kmm.data_ptr(), *tiles, dout.data_ptr(),
                            lse.data_ptr(), delta.data_ptr(), dk_h.data_ptr(), dv_h.data_ptr(),
                            S, Hq, Hkv, float(scale), int(key == "bf16"), stream)
    if err != 0:
        raise RuntimeError(f"flash_segment_attn_v1_bwd_dkv launch failed: CUDA error {err}")
    launches[f"v1_bwd_dkv_{key}"] += 1
    return dk_h, dv_h


def _intervals(seg: torch.Tensor, tiles: tuple[int, int]):
    """(qmm, kmm) of one id vector at the q and kv tile sizes."""
    qmm = tile_minmax(seg, tiles[0])
    return qmm, (qmm if tiles[1] == tiles[0] else tile_minmax(seg, tiles[1]))


def _fwd(q, k, v, segment_ids, scale=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: the forward kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_segment_attention_reference(q, k, v, segment_ids, scale)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return launch_fwd(q, k, v, segment_ids,
                      *_intervals(segment_ids, TILES["fwd"][_key(q)]), scale)


def _bwd(q, k, v, segment_ids, out, lse, dout,
         scale=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``: the dq and dk/dv kernels and the group sum for CUDA
    tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_segment_attention_bwd_reference(q, k, v, segment_ids, out, lse, dout, scale)
    _check_bwd(q, out, lse, dout)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    delta = _delta(out, dout)
    tiles = TILES["dq"][_key(q)]  # dq and dk/dv share their tiles
    qmm, kmm = _intervals(segment_ids, tiles)
    dq = launch_bwd_dq(q, k, v, segment_ids, qmm, kmm, dout, lse, delta, scale)
    dk_h, dv_h = launch_bwd_dkv(q, k, v, segment_ids, qmm, kmm, dout, lse, delta, scale)
    return dq, group_sum(dk_h, k.shape[1]), group_sum(dv_h, k.shape[1])


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
    as the packer lays them out (tile skipping relies on it)."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashSegmentAttnV1.apply(q, k, v, segment_ids, scale)
    return _fwd(q, k, v, segment_ids, scale)[0]
