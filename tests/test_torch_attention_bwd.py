"""The backward of the port's segment attention against the JAX package, on
the CPU: the plain backward (the function the CUDA backward kernels
compute) against ``jax.vjp`` through JAX's ``flash_segment_attention_mh``,
whose ``custom_vjp`` runs the Pallas ``_mh_bwd`` in interpret mode; and the
port's ``autograd.Function`` against autograd through the dense
reference."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from titok_tpu.ops.flash_attention_mh import (  # noqa: E402
    flash_segment_attention_mh as j_flash_mh,
)
from titok_tpu_torch.losses.loss_module import stacked_segment_ids  # noqa: E402
from titok_tpu_torch.ops import flash_attention_mh as fa  # noqa: E402
from titok_tpu_torch.ops.attention import segment_attention_reference  # noqa: E402


def _seg(lengths, S):
    seg = np.zeros((S,), np.int32)
    off = 0
    for i, n in enumerate(lengths):
        seg[off:off + n] = i + 1
        off += n
    return seg


def _stacked_disc_ids():
    """Four copies of a disc buffer (Bmax 3, two samples, pad rows) stacked
    as the discriminator's one packed pass lays them out: no id is 0."""
    seg = torch.from_numpy(_seg([30, 22], 60))
    return stacked_segment_ids(seg, 4, 4).numpy()


# name -> (S, Hq, Hkv, q ids, Sk or None, k ids or None); each case is one
# interpret-mode compile, so GQA 4/1 rides on the ragged case
CASES = {
    "ragged pad 4/1": (200, 4, 1, _seg([1, 60, 64, 45], 200), None, None),
    "stacked disc ids 4/2": (240, 4, 2, _stacked_disc_ids(), None, None),
    "Sk != S 4/2": (192, 4, 2, _seg([100, 60], 192), 320, _seg([150, 110, 40], 320)),
}


def _inputs(seed, S, Hq, Hkv, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    q = rng.normal(size=(S, Hq, 64)).astype(np.float32)
    k = rng.normal(size=(Sk, Hkv, 64)).astype(np.float32)
    v = rng.normal(size=(Sk, Hkv, 64)).astype(np.float32)
    do = rng.normal(size=(S, Hq, 64)).astype(np.float32)
    return q, k, v, do


def _jax_vjp(q, k, v, do, seg, k_seg):
    kw = {} if k_seg is None else {"k_segment_ids": jnp.asarray(k_seg)}
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: j_flash_mh(a, b, c, jnp.asarray(seg), block_q=64,
                                                    block_k=64, **kw),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do))]


def _port_bwd(q, k, v, do, seg, k_seg, dtype=torch.float32):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v, do)]
    seg_t = torch.from_numpy(seg)
    k_seg_t = None if k_seg is None else torch.from_numpy(k_seg)
    out, lse = fa.flash_segment_attention_mh_reference(t[0], t[1], t[2], seg_t,
                                                       k_segment_ids=k_seg_t)
    grads = fa.flash_segment_attention_mh_bwd_reference(t[0], t[1], t[2], seg_t, out, lse,
                                                         t[3], k_segment_ids=k_seg_t)
    for g, x in zip(grads, t):
        assert g.dtype == dtype and g.shape == x.shape
    return [g.to(torch.float32).numpy() for g in grads]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_mh_bwd(case):
    S, Hq, Hkv, seg, Sk, k_seg = CASES[case]
    q, k, v, do = _inputs(len(case), S, Hq, Hkv, Sk)
    want = _jax_vjp(q, k, v, do, seg, k_seg)
    got = _port_bwd(q, k, v, do, seg, k_seg)
    for name, a, b in zip("dq dk dv".split(), got, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)


def test_plain_backward_bf16_rounds_like_the_kernels():
    """bf16 inputs: p and ds rounded to bf16 before the products, as in
    ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``. Both sides round the same
    values, but at other places in the f32 sums and through JAX's own
    bf16 forward, so the grads (about 1 in size) are held at 3e-2 + 2e-2
    relative, the bf16 forward's tolerance scaled by the longer chain."""
    S, Hq, Hkv, seg, _, _ = CASES["stacked disc ids 4/2"]
    q, k, v, do = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                   for x in _inputs(1, S, Hq, Hkv))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: j_flash_mh(a, b, c, jnp.asarray(seg), block_q=64,
                                                    block_k=64),
                         *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
        want = [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do, jnp.bfloat16))]
    got = _port_bwd(q, k, v, do, seg, None, torch.bfloat16)
    for name, a, b in zip("dq dk dv".split(), got, want):
        np.testing.assert_allclose(a, b, atol=3e-2, rtol=2e-2, err_msg=name)


@pytest.mark.parametrize("case", ["ragged pad 4/1", "stacked disc ids 4/2"])
def test_autograd_function_matches_dense_autograd(case):
    """On CPU tensors the entry point's ``autograd.Function`` (plain forward
    and backward) gives autograd's grads through the dense reference."""
    S, Hq, Hkv, seg, _, _ = CASES[case]
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(7, S, Hq, Hkv))
    seg_t = torch.from_numpy(seg)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_segment_attention_mh(*leaves, seg_t)
    assert type(out.grad_fn).__name__ == "_FlashSegmentAttnBackward"
    got = torch.autograd.grad(out, leaves, do)
    leaves_d = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(segment_attention_reference(*leaves_d, seg_t), leaves_d, do)
    for name, a, b in zip("dq dk dv".split(), got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=name)
    before = dict(fa.launches)
    with torch.inference_mode():  # serving: forward only, no Function
        assert fa.flash_segment_attention_mh(q, k, v, seg_t).grad_fn is None
    with torch.no_grad():
        assert fa.flash_segment_attention_mh(*leaves, seg_t).grad_fn is None
    assert fa.launches == before  # CPU tensors take the plain versions


def test_plain_versions_chunk_the_dense_blocks(monkeypatch):
    """The plain versions loop over heads and chunks of q rows so a 24,752-row
    stacked buffer fits; the chunking does not change what they compute."""
    S, Hq, Hkv, seg, Sk, k_seg = CASES["Sk != S 4/2"]
    q, k, v, do = _inputs(3, S, Hq, Hkv, Sk)
    whole = _port_bwd(q, k, v, do, seg, k_seg)
    monkeypatch.setattr(fa, "_DENSE_ELEMS", 50 * Sk)  # 4 chunks of q rows per head
    assert len(list(fa._dense_blocks(S, Sk, Hq))) == Hq * 4
    chunked = _port_bwd(q, k, v, do, seg, k_seg)
    for a, b in zip(chunked, whole):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
