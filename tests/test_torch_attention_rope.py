"""The port's RoPE-fused attention (``attn_impl: flash_rope``) against the
JAX package on the CPU: the plain versions of the rope kernels against the
Pallas ``_rope_fwd`` and the ``custom_vjp`` ``_mh_rope``, run in interpret
mode.

- forward: ``(out, lse)`` of :func:`flash_segment_attention_mh_rope_reference`
  against ``_rope_fwd``, as ``flash_segment_attention_mh`` prepares it
  (pad remap, rows padded to the block, tables expanded, pad rows rotated
  by the identity);
- backward: :func:`flash_segment_attention_mh_rope_bwd_reference` against
  ``jax.grad`` through ``flash_segment_attention_mh(..., rope_cos=...)``;
- separate k ids and k tables.

Tolerances: f32 1e-5 on the forward (2e-5 on out, as the unfused port
tests hold ``_mh_fwd``: another summation order) and 2e-4 on the grads, as
JAX's own fused-rope gradient test holds its kernels; bf16 forward at the
unfused bf16 limits (3e-2 + 1e-2 relative, lse 1e-3: two bf16 roundings,
of p and of out, at other places in the two frameworks).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from titok_tpu.ops.flash_attention import _remap_pad  # noqa: E402
from titok_tpu.ops.flash_attention_mh import (  # noqa: E402
    _choose_blocks,
    _rope_fwd,
    expand_rope_tables,
    flash_segment_attention_mh as j_flash,
)
from titok_tpu_torch.ops import flash_attention_mh as fa  # noqa: E402
from titok_tpu_torch.ops.attention import segment_attention  # noqa: E402


# (S, Hq, Hkv, segment lengths, P): P = 30 is the model's (head dim 64, 3
# grid axes); P = 16 leaves 16 pairs to pass through
CASES = [
    (128, 4, 2, (60, 50, 10), 30),
    (160, 4, 2, (1, 2, 63, 64, 25), 16),
    (192, 12, 4, (100, 1, 80), 30),  # ragged GQA ratio 3, pad rows
]


def _seg(S, lengths):
    seg = np.zeros((S,), np.int32)
    off = 0
    for i, n in enumerate(lengths):
        seg[off:off + n] = i + 1
        off += n
    return seg


def _inputs(rng, S, Hq, Hkv, lengths, P, D=64):
    q = rng.normal(size=(S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, size=(S, P))
    return q, k, v, _seg(S, lengths), np.cos(ang).astype(np.float32), \
        np.sin(ang).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_rope_fwd(q, k, v, seg, cos, sin, block=64, k_seg=None, k_cos=None, k_sin=None):
    """``_rope_fwd`` as ``flash_segment_attention_mh`` prepares it: pad
    remap, rows padded to the block with id 2**30 + 1, expanded tables
    padded with the identity rotation; interpret mode."""
    S, Hq, D = q.shape
    Sk, Hkv, _ = k.shape
    bq, bk = _choose_blocks(S, Sk, block, block, Hq)
    Sp, Skp = -(-S // bq) * bq, -(-Sk // bk) * bk
    seg_q = np.asarray(_remap_pad(jnp.asarray(seg)))
    seg_k = seg_q if k_seg is None else np.asarray(_remap_pad(jnp.asarray(k_seg)))
    ceq, seq_ = (np.asarray(t) for t in expand_rope_tables(jnp.asarray(cos), jnp.asarray(sin), D))
    if k_cos is None:
        cek, sek = ceq, seq_
    else:
        cek, sek = (np.asarray(t) for t in expand_rope_tables(jnp.asarray(k_cos),
                                                              jnp.asarray(k_sin), D))

    def pad(x, n, fill=0):
        return jnp.asarray(np.pad(x, [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1),
                                  constant_values=fill))

    with pltpu.force_tpu_interpret_mode():
        out, lse = _rope_fwd(
            pad(q.reshape(S, Hq * D), Sp), pad(k.reshape(Sk, Hkv * D), Skp),
            pad(v.reshape(Sk, Hkv * D), Skp), pad(seg_q, Sp, 2**30 + 1),
            pad(seg_k, Skp, 2**30 + 1), pad(ceq, Sp, 1.0), pad(seq_, Sp, 0.0),
            pad(cek, Skp, 1.0), pad(sek, Skp, 0.0), D ** -0.5, bq, bk, Hq, Hkv, D, None)
    return np.asarray(out)[:S].reshape(S, Hq, D), np.asarray(lse)[:S]


def _jax_rope_grads(q, k, v, seg, cos, sin, dout, k_seg=None, k_cos=None, k_sin=None):
    """``jax.grad`` of ``sum(out * dout)`` through the JAX entry point with
    the tables: the custom_vjp ``_mh_rope``'s kernels, in interpret mode."""
    def loss(q, k, v):
        o = j_flash(q, k, v, jnp.asarray(seg), block_q=64, block_k=64,
                    k_segment_ids=None if k_seg is None else jnp.asarray(k_seg),
                    rope_cos=jnp.asarray(cos), rope_sin=jnp.asarray(sin),
                    k_rope_cos=None if k_cos is None else jnp.asarray(k_cos),
                    k_rope_sin=None if k_sin is None else jnp.asarray(k_sin))
        return (o * jnp.asarray(dout)).sum()

    with pltpu.force_tpu_interpret_mode():
        g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in g]


@pytest.mark.parametrize("S,Hq,Hkv,lengths,P", CASES)
def test_plain_rope_forward_matches_jax_rope_fwd(rng, S, Hq, Hkv, lengths, P):
    q, k, v, seg, cos, sin = _inputs(rng, S, Hq, Hkv, lengths, P)
    want_out, want_lse = _jax_rope_fwd(q, k, v, seg, cos, sin)
    got_out, got_lse = fa.flash_segment_attention_mh_rope_reference(*_t(q, k, v, seg, cos, sin))
    assert got_out.dtype == torch.float32 and got_lse.shape == (S, Hq)
    np.testing.assert_allclose(got_out.numpy(), want_out, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-5, rtol=0)


def test_plain_rope_forward_bf16_matches_jax(rng):
    """bf16 inputs: the rotated q and k are rounded to bf16 before the
    products, p before the PV product, as ``_fwd_kernel_rope`` does."""
    q, k, v, seg, cos, sin = _inputs(rng, 128, 4, 2, (70, 50), 30)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got_out, got_lse = fa.flash_segment_attention_mh_rope_reference(
        qb, kb, vb, *_t(seg, cos, sin))
    assert got_out.dtype == torch.bfloat16
    want_out, want_lse = _jax_rope_fwd(*(np.asarray(jnp.asarray(x.float().numpy(), jnp.bfloat16))
                                         for x in (qb, kb, vb)), seg, cos, sin)
    np.testing.assert_allclose(got_out.float().numpy(), np.asarray(want_out, np.float32),
                               atol=3e-2, rtol=1e-2)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("S,Hq,Hkv,lengths,P", CASES[1:])
def test_plain_rope_backward_matches_jax_grad(rng, S, Hq, Hkv, lengths, P):
    q, k, v, seg, cos, sin = _inputs(rng, S, Hq, Hkv, lengths, P)
    dout = rng.normal(size=q.shape).astype(np.float32)
    want = _jax_rope_grads(q, k, v, seg, cos, sin, dout)
    tq, tk, tv, tseg, tcos, tsin = _t(q, k, v, seg, cos, sin)
    out, lse = fa.flash_segment_attention_mh_rope_reference(tq, tk, tv, tseg, tcos, tsin)
    got = fa.flash_segment_attention_mh_rope_bwd_reference(
        tq, tk, tv, tseg, tcos, tsin, out, lse, torch.from_numpy(dout))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=2e-4, rtol=1e-4, err_msg=name)


def test_plain_rope_separate_k_ids_and_tables_match_jax(rng):
    """q rows against a kv buffer of another length with its own ids and
    its own tables (``k_rope_cos``), forward and grads."""
    q, _, _, seg, cos, sin = _inputs(rng, 128, 4, 2, (70, 50), 30)
    _, k, v, k_seg, k_cos, k_sin = _inputs(rng, 192, 4, 2, (100, 70, 20), 30)
    dout = rng.normal(size=q.shape).astype(np.float32)
    want_out, want_lse = _jax_rope_fwd(q, k, v, seg, cos, sin, k_seg=k_seg, k_cos=k_cos,
                                       k_sin=k_sin)
    want = _jax_rope_grads(q, k, v, seg, cos, sin, dout, k_seg, k_cos, k_sin)
    tq, tk, tv, tseg, tcos, tsin, tkseg, tkcos, tksin = _t(q, k, v, seg, cos, sin, k_seg, k_cos,
                                                           k_sin)
    out, lse = fa.flash_segment_attention_mh_rope_reference(
        tq, tk, tv, tseg, tcos, tsin, k_segment_ids=tkseg, k_rope_cos=tkcos, k_rope_sin=tksin)
    np.testing.assert_allclose(out.numpy(), want_out, atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=0)
    got = fa.flash_segment_attention_mh_rope_bwd_reference(
        tq, tk, tv, tseg, tcos, tsin, out, lse, torch.from_numpy(dout), k_segment_ids=tkseg,
        k_rope_cos=tkcos, k_rope_sin=tksin)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=2e-4, rtol=1e-4, err_msg=name)


def test_flash_rope_autograd_on_cpu_equals_the_unfused_chain(rng):
    """``segment_attention(impl='flash_rope')`` on CPU tensors goes through
    the rope ``autograd.Function`` and its plain versions, launches no
    kernel, and in f32 equals autograd through ``apply_rotary_emb`` and the
    unfused entry point (the rotation's roundings are the same ops)."""
    from titok_tpu_torch.models.rope import apply_rotary_emb

    q, k, v, seg, cos, sin = _t(*_inputs(rng, 128, 4, 2, (60, 50, 10), 30))
    before = dict(fa.launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = segment_attention(*leaves, seg, impl="flash_rope", rope_cos=cos, rope_sin=sin)
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = segment_attention(apply_rotary_emb(ref_leaves[0], cos, sin),
                            apply_rotary_emb(ref_leaves[1], cos, sin), ref_leaves[2], seg,
                            impl="flash")
    assert torch.equal(out, ref)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad((out * w).sum(), leaves)
    want = torch.autograd.grad((ref * w).sum(), ref_leaves)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    assert fa.launches == before
    with pytest.raises(ValueError, match="rope_cos"):
        segment_attention(q, k, v, seg, impl="flash_rope")
