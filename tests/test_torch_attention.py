"""The port's segment attention against the JAX package, in f32 on the CPU:
the dense reference, and the plain version of the CUDA kernel
(``(out, lse)``) against the Pallas ``_mh_fwd`` run in interpret mode."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from titok_tpu.ops.attention import segment_attention_reference as j_reference  # noqa: E402
from titok_tpu.ops.flash_attention import _remap_pad  # noqa: E402
from titok_tpu.ops.flash_attention_mh import _choose_blocks, _mh_fwd  # noqa: E402
from titok_tpu_torch.ops import flash_attention_mh as fa  # noqa: E402
from titok_tpu_torch.ops.attention import (  # noqa: E402
    segment_attention,
    segment_attention_reference,
)

# (S, Hq, Hkv, segment lengths): ragged lengths, pad rows at the end, S
# not a multiple of the block, GQA 4/2 and 16/4
CASES = [
    (300, 4, 2, (120, 100, 50)),
    (256, 4, 2, (1, 2, 63, 64, 65, 17)),
    (384, 16, 4, (200, 1, 150)),
    (200, 4, 4, (200,)),
]


def _inputs(rng, S, Hq, Hkv, segs, D=64):
    q = rng.normal(size=(S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    seg = np.zeros((S,), np.int32)
    off = 0
    for i, n in enumerate(segs):
        seg[off:off + n] = i + 1
        off += n
    return q, k, v, seg


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_mh_fwd(q, k, v, seg, block=128, k_seg=None):
    """``_mh_fwd`` as ``flash_segment_attention_mh`` prepares it: pad
    remap, rows padded to the block with id 2**30 + 1; interpret mode."""
    S, Hq, D = q.shape
    Sk, Hkv, _ = k.shape
    bq, bk = _choose_blocks(S, Sk, block, block, Hq)
    Sp, Skp = -(-S // bq) * bq, -(-Sk // bk) * bk
    seg_q = np.asarray(_remap_pad(jnp.asarray(seg)))
    seg_k = seg_q if k_seg is None else np.asarray(_remap_pad(jnp.asarray(k_seg)))
    big2 = 2**30 + 1

    def pad(x, n, fill=0):
        return np.pad(x, [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1),
                      constant_values=fill)

    with pltpu.force_tpu_interpret_mode():
        out, lse = _mh_fwd(
            jnp.asarray(pad(q.reshape(S, Hq * D), Sp)),
            jnp.asarray(pad(k.reshape(Sk, Hkv * D), Skp)),
            jnp.asarray(pad(v.reshape(Sk, Hkv * D), Skp)),
            jnp.asarray(pad(seg_q, Sp, big2)), jnp.asarray(pad(seg_k, Skp, big2)),
            D ** -0.5, bq, bk, Hq, Hkv, D, None)
    return np.asarray(out)[:S].reshape(S, Hq, D), np.asarray(lse)[:S]


@pytest.mark.parametrize("S,Hq,Hkv,segs", CASES)
def test_reference_matches_jax(rng, S, Hq, Hkv, segs):
    q, k, v, seg = _inputs(rng, S, Hq, Hkv, segs)
    want = np.asarray(j_reference(q, k, v, seg))
    got = segment_attention_reference(*_t(q, k, v, seg)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("S,Hq,Hkv,segs", CASES)
def test_plain_out_lse_match_jax_mh_fwd(rng, S, Hq, Hkv, segs):
    q, k, v, seg = _inputs(rng, S, Hq, Hkv, segs)
    want_out, want_lse = _jax_mh_fwd(q, k, v, seg)
    got_out, got_lse = fa.flash_segment_attention_mh_reference(*_t(q, k, v, seg))
    assert got_out.dtype == torch.float32 and got_lse.shape == (S, Hq)
    np.testing.assert_allclose(got_out.numpy(), want_out, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=2e-5, rtol=0)


def test_plain_separate_k_segments_match_jax(rng):
    """q rows against a kv buffer of another length with its own ids (the
    context-parallel layout: q local, kv gathered)."""
    q, _, _, seg = _inputs(rng, 192, 4, 2, (100, 60))
    _, k, v, k_seg = _inputs(rng, 320, 4, 2, (150, 110, 40))
    want_out, want_lse = _jax_mh_fwd(q, k, v, seg, k_seg=k_seg)
    got_out, got_lse = fa.flash_segment_attention_mh_reference(
        *_t(q, k, v, seg), k_segment_ids=torch.from_numpy(k_seg))
    np.testing.assert_allclose(got_out.numpy(), want_out, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=2e-5, rtol=0)


def test_plain_bf16_rounds_p_like_the_kernel(rng):
    """bf16 inputs: p is rounded to bf16 before the PV product, as in
    ``_fwd_kernel``; held to JAX's bf16 ``_mh_fwd`` at bf16 tolerance."""
    q, k, v, seg = _inputs(rng, 256, 4, 2, (100, 90, 40))
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got_out, got_lse = fa.flash_segment_attention_mh_reference(qb, kb, vb,
                                                               torch.from_numpy(seg))
    assert got_out.dtype == torch.bfloat16
    f32 = [x.float().numpy() for x in (qb, kb, vb)]
    want_out, want_lse = _jax_mh_fwd(*(np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in f32),
                                     seg)
    np.testing.assert_allclose(got_out.float().numpy(), np.asarray(want_out, np.float32),
                               atol=3e-2, rtol=1e-2)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-3, rtol=0)


def test_dispatcher_on_cpu(rng):
    q, k, v, seg = _t(*_inputs(rng, 128, 4, 2, (60, 50)))
    dense = segment_attention(q, k, v, seg, impl="reference")
    before = dict(fa.launches)
    for impl in ("auto", "flash"):
        out = segment_attention(q, k, v, seg, impl=impl)
        torch.testing.assert_close(out, dense, atol=1e-5, rtol=0)
    # flash_rope on unrotated q, k with identity tables is plain attention
    ones, zeros = torch.ones(q.shape[0], 30), torch.zeros(q.shape[0], 30)
    out = segment_attention(q, k, v, seg, impl="flash_rope", rope_cos=ones, rope_sin=zeros)
    torch.testing.assert_close(out, dense, atol=1e-5, rtol=0)
    # flash_v1 (the v1 kernels' plain version on CPU tensors) is the same function
    out = segment_attention(q, k, v, seg, impl="flash_v1")
    torch.testing.assert_close(out, dense, atol=1e-5, rtol=0)
    assert fa.launches == before  # CPU tensors take the plain version
    with pytest.raises(ValueError):
        segment_attention(q, k, v, seg, impl="nope")


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    q, k, v, seg = _t(*_inputs(rng, 64, 4, 3, (64,)))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_segment_attention_mh_reference(q, k, v, seg)
    q, k, v, seg = _t(*_inputs(rng, 64, 4, 2, (64,), D=32))
    with pytest.raises(ValueError, match="head_dim 64"):
        fa._check(q, k, v, seg, seg)
    q, k, v, seg = _t(*_inputs(rng, 64, 4, 2, (64,)))
    with pytest.raises(ValueError, match="int32"):
        fa._check(q, k, v, seg.long(), seg)
    with pytest.raises(ValueError, match="contiguous"):
        fa._check(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, seg, seg)
    with pytest.raises(ValueError, match="bf16 or all f32"):
        fa._check(q.half(), k.half(), v.half(), seg, seg)
