"""The v1 attention of the port (``attn_impl: flash_v1``,
``titok_tpu_torch/ops/flash_attention.py``) against the JAX package's
``titok_tpu/ops/flash_attention.py`` on the CPU.

The JAX kernels run in Pallas interpret mode at block 128, as
``tests/test_flash_attention.py`` runs them; the port's CPU path is the
kernels' plain version. The plain forward rounds p against the running max
after each kv tile of ``block`` rows, so at ``block=128`` it rounds where
JAX's kernel does at block 128 (the CUDA kernel's tile is 64). Tolerances:
f32 atol 2e-5 (fp32 sum order only); bf16 forward and grads within one bf16
ulp of the largest value (2**-7 of max|want|), since the sum order may
move an output to its neighbouring bf16 value."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from titok_tpu.models.titok import TiTok as JTiTok  # noqa: E402
from titok_tpu.models.titok import TiTokModel as JTiTokModel  # noqa: E402
from titok_tpu.ops.flash_attention import flash_segment_attention as j_flash  # noqa: E402
from titok_tpu_torch.models.titok import TiTok, TiTokModel  # noqa: E402
from titok_tpu_torch.ops import flash_attention as f1  # noqa: E402
from titok_tpu_torch.ops import flash_attention_mh as fa  # noqa: E402
from titok_tpu_torch.ops.attention import segment_attention, segment_attention_reference  # noqa: E402
from titok_tpu_torch.weights import from_flax_params  # noqa: E402


BLOCK = 128
# (S, Hq, Hkv, segment lengths): pad rows after the segments in the first
# and last; the last is not a block multiple (ragged)
CASES = {
    "S256 4/2 pad": (256, 4, 2, (100, 90, 40)),
    "S256 6/2 one segment": (256, 6, 2, (256,)),
    "S300 4/2 ragged pad": (300, 4, 2, (120, 1, 150)),
}


def _inputs(rng, S, hq, hkv, segs):
    q = rng.normal(size=(S, hq, 64)).astype(np.float32)
    k = rng.normal(size=(S, hkv, 64)).astype(np.float32)
    v = rng.normal(size=(S, hkv, 64)).astype(np.float32)
    seg = np.zeros((S,), np.int32)
    off = 0
    for i, n in enumerate(segs):
        seg[off:off + n] = i + 1
        off += n
    return q, k, v, seg


def _jax_fwd(q, k, v, seg):
    with pltpu.force_tpu_interpret_mode():
        return j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
                       block_q=BLOCK, block_k=BLOCK)


def _jax_vjp(q, k, v, seg, do):
    def f(q, k, v):
        return j_flash(q, k, v, jnp.asarray(seg), block_q=BLOCK, block_k=BLOCK)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(do)


@pytest.fixture(scope="module")
def jax_vjp():
    """:func:`_jax_vjp`, each set of inputs computed once in this file: the
    f32 backward tests at S256 4/2 draw the same inputs from the same seed,
    and JAX's vjp in interpret mode is the slowest part of either."""
    cache = {}

    def cached(q, k, v, seg, do):
        key = tuple((np.asarray(x).dtype.str, np.asarray(x).tobytes()) for x in (q, k, v, seg, do))
        if key not in cache:
            cache[key] = _jax_vjp(q, k, v, seg, do)
        return cache[key]

    return cached


def _bf16(x):
    """numpy f32 -> (jax bf16, torch bf16) holding the same values."""
    jb = jnp.asarray(x, jnp.bfloat16)
    return jb, torch.from_numpy(np.array(jb.astype(jnp.float32))).to(torch.bfloat16)


def _within_ulp(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0**-7 * np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax_f32(rng, case):
    q, k, v, seg = _inputs(rng, *CASES[case])
    out, lse = f1.flash_segment_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v, seg)), block=BLOCK)
    np.testing.assert_allclose(out.numpy(), np.asarray(_jax_fwd(q, k, v, seg)), atol=2e-5, rtol=0)
    # the same function as the dense reference and the row 1-2 plain version
    dense = segment_attention_reference(*(torch.from_numpy(x) for x in (q, k, v, seg)))
    torch.testing.assert_close(out, dense, atol=2e-5, rtol=0)
    _, mh_lse = fa.flash_segment_attention_mh_reference(*(torch.from_numpy(x) for x in (q, k, v, seg)))
    torch.testing.assert_close(lse, mh_lse, atol=2e-5, rtol=0)


def test_forward_matches_jax_bf16(rng):
    """bf16: p rounded against the running max of each 128-row tile, as
    JAX's kernel rounds it; at most one bf16 ulp apart, in a few entries."""
    q, k, v, seg = _inputs(rng, *CASES["S300 4/2 ragged pad"])
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    want = np.asarray(_jax_fwd(jq, jk, jv, seg), np.float32)
    got, _ = f1.flash_segment_attention_reference(tq, tk, tv, torch.from_numpy(seg), block=BLOCK)
    assert got.dtype == torch.bfloat16
    _within_ulp(got, want)
    assert (got.float().numpy() != want).mean() < 1e-2


@pytest.mark.parametrize("case", ["S256 4/2 pad", "S300 4/2 ragged pad"])
def test_backward_matches_jax_vjp_f32(rng, case, jax_vjp):
    S, hq, hkv, segs = CASES[case]
    if case.startswith("S300"):
        hq = 6  # GQA ratio 3 with the ragged layout
    q, k, v, seg = _inputs(rng, S, hq, hkv, segs)
    do = rng.normal(size=q.shape).astype(np.float32)
    _, want = jax_vjp(*(jnp.asarray(x) for x in (q, k, v)), seg, jnp.asarray(do))
    tq, tk, tv, tseg, tdo = (torch.from_numpy(x) for x in (q, k, v, seg, do))
    out, lse = f1.flash_segment_attention_reference(tq, tk, tv, tseg)
    got = f1.flash_segment_attention_bwd_reference(tq, tk, tv, tseg, out, lse, tdo)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=0, err_msg=name)
    # autograd through the entry point takes the same plain backward
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    grads = torch.autograd.grad(f1.flash_segment_attention(*leaves, tseg), leaves, tdo)
    for a, b in zip(grads, got):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_bf16_dkv_round_each_q_head_before_the_group_sum(rng):
    """GQA ratio 4 in bf16: v1 rounds each q head's dk/dv to bf16, then sums
    the group; the row 2 plain version sums the group in f32 and rounds
    once. The v1 plain version is JAX's v1 within one ulp and equal to it
    on more entries than the row 2 version is."""
    q, k, v, seg = _inputs(rng, 256, 8, 2, (100, 90, 40))
    do = rng.normal(size=q.shape).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _bf16(q), _bf16(k), _bf16(v), _bf16(do)
    jout, want = _jax_vjp(jq, jk, jv, seg, jdo)
    tseg = torch.from_numpy(seg)
    _, lse = f1.flash_segment_attention_reference(tq, tk, tv, tseg)
    out = torch.from_numpy(np.array(jout.astype(jnp.float32))).to(torch.bfloat16)
    dq, dk, dv = f1.flash_segment_attention_bwd_reference(tq, tk, tv, tseg, out, lse, tdo)
    _, dk_h, dv_h = f1.flash_segment_attention_bwd_reference(tq, tk, tv, tseg, out, lse, tdo,
                                                             per_head=True)
    assert dk_h.dtype == torch.bfloat16 and dk_h.shape == q.shape
    assert torch.equal(dk, f1.group_sum(dk_h, 2)) and torch.equal(dv, f1.group_sum(dv_h, 2))
    _, mh_dk, mh_dv = fa.flash_segment_attention_mh_bwd_reference(tq, tk, tv, tseg, out, lse, tdo)
    for got, mh, ref in ((dq, None, want[0]), (dk, mh_dk, want[1]), (dv, mh_dv, want[2])):
        _within_ulp(got, ref)
        if mh is not None:
            ref = np.asarray(ref, np.float32)
            same_v1 = (got.float().numpy() == ref).mean()
            same_mh = (mh.float().numpy() == ref).mean()
            assert same_v1 > same_mh, (same_v1, same_mh)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("heads", [(4, 2), (8, 1)], ids=["4/2", "8/1"])
def test_bwd_cpu_path_matches_jax_vjp(rng, heads, dtype, jax_vjp):
    """``_bwd`` on CPU tensors, the backward that autograd runs, against
    JAX's v1 vjp: f32 within 2e-5; bf16 within one ulp, dk/dv with each q
    head rounded before the group sum (at 8/1 one kv head sums eight)."""
    hq, hkv = heads
    q, k, v, seg = _inputs(rng, 256, hq, hkv, (100, 90, 40))
    do = rng.normal(size=q.shape).astype(np.float32)
    tseg = torch.from_numpy(seg)
    if dtype == "f32":
        ins = [(jnp.asarray(x), torch.from_numpy(x)) for x in (q, k, v, do)]
    else:
        ins = [_bf16(x) for x in (q, k, v, do)]
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = ins
    jout, want = jax_vjp(jq, jk, jv, seg, jdo)
    _, lse = f1.flash_segment_attention_reference(tq, tk, tv, tseg)
    out = torch.from_numpy(np.array(jout.astype(jnp.float32))).to(tq.dtype)
    got = f1._bwd(tq, tk, tv, tseg, out, lse, tdo)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tq.dtype and a.shape == tuple(b.shape), name
        if dtype == "f32":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=0, err_msg=name)
        else:
            _within_ulp(a, b)


def test_flash_v1_on_cpu_launches_no_kernel(rng):
    q, k, v, seg = (torch.from_numpy(x) for x in _inputs(rng, *CASES["S256 4/2 pad"]))
    before = dict(fa.launches)
    out = segment_attention(q, k, v, seg, impl="flash_v1")
    torch.testing.assert_close(out, segment_attention_reference(q, k, v, seg), atol=2e-5, rtol=0)
    assert fa.launches == before
    with pytest.raises(ValueError, match="one length"):
        f1.flash_segment_attention_reference(q, k[:200], v[:200], seg)


def test_bf16_cpu_path_is_the_plain_version_and_launches_nothing(rng, monkeypatch):
    """bf16 CPU tensors through the entry point and its autograd backward
    take the plain versions, bit for bit: no kernel is built or launched."""
    def unreachable(*a, **k):
        raise AssertionError("the CPU path reached a kernel")

    monkeypatch.setattr(f1, "_kernels", unreachable)
    q, k, v, seg = _inputs(rng, *CASES["S300 4/2 ragged pad"])
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    tseg = torch.from_numpy(seg)
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(torch.bfloat16)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    before = dict(fa.launches)
    out = f1.flash_segment_attention(*leaves, tseg)
    grads = torch.autograd.grad(out, leaves, do)
    assert fa.launches == before
    want_out, want_lse = f1.flash_segment_attention_reference(tq, tk, tv, tseg)
    assert out.dtype == torch.bfloat16 and torch.equal(out, want_out)
    want = f1.flash_segment_attention_bwd_reference(tq, tk, tv, tseg, want_out, want_lse, do)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


def test_f32_bwd_cpu_path_is_the_plain_version_and_launches_nothing(rng, monkeypatch):
    """f32 CPU tensors through ``_bwd``, the backward autograd runs, take
    the plain version, bit for bit: no kernel is built or launched."""
    def unreachable(*a, **k):
        raise AssertionError("the CPU path reached a kernel")

    monkeypatch.setattr(f1, "_kernels", unreachable)
    q, k, v, seg = (torch.from_numpy(x) for x in _inputs(rng, *CASES["S300 4/2 ragged pad"]))
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    out, lse = f1.flash_segment_attention_reference(q, k, v, seg)
    before = dict(fa.launches)
    got = f1._bwd(q, k, v, seg, out, lse, do)
    assert fa.launches == before
    want = f1.flash_segment_attention_bwd_reference(q, k, v, seg, out, lse, do)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_bind_v1_binds_entries_without_tile_intervals():
    """``bind_v1`` gives each C entry q, k, v and the ids, then its own
    buffers (fwd: out, lse; dq: dO, lse, delta, dq; dk/dv: dO, lse, delta,
    dk, dv), then S, the heads, the scale, the dtype flag and the stream:
    no tile intervals or tile sizes. A stub library, so nothing is built."""
    import ctypes
    import types

    def entry():
        return types.SimpleNamespace(argtypes=None, restype=None)

    names = ("flash_segment_attn_v1_fwd", "flash_segment_attn_v1_bwd_dq",
             "flash_segment_attn_v1_bwd_dkv")
    lib = types.SimpleNamespace(**{n: entry() for n in names})
    fns = f1.bind_v1(lib)
    assert fns == tuple(getattr(lib, n) for n in names)
    P, I = ctypes.c_void_p, ctypes.c_int
    tail = [I, I, I, ctypes.c_float, I, P]
    for fn, n_bufs in zip(fns, (2, 4, 5)):
        assert fn.argtypes == [P] * 4 + [P] * n_bufs + tail and fn.restype is I


# v1 against the row 1-2 plain versions in f32, where v1 rounds nothing:
# the same function, so within fp32 sum order (1e-6)
V1_F32_HEADS = {"4/2": (4, 2), "12/4": (12, 4), "8/1": (8, 1), "4/4": (4, 4)}


@pytest.mark.parametrize("heads", list(V1_F32_HEADS))
def test_f32_v1_is_the_row_1_2_function(rng, heads):
    """The plain v1 forward and backward in f32 against
    ``flash_attention_mh``'s plain f32 versions on one id vector: out, lse,
    dq and the group-summed dk/dv within 1e-6, at every head split the
    kernels take (4/2 one head a forward CTA, 12/4 three, 8/1 four with the
    dk/dv's heads in two chunks, 4/4 a group of one)."""
    hq, hkv = V1_F32_HEADS[heads]
    q, k, v, seg = (torch.from_numpy(x) for x in _inputs(rng, 200, hq, hkv, (70, 1, 64, 45)))
    do = torch.from_numpy(rng.normal(size=tuple(q.shape)).astype(np.float32))
    out, lse = f1.flash_segment_attention_reference(q, k, v, seg)
    m_out, m_lse = fa.flash_segment_attention_mh_reference(q, k, v, seg)
    torch.testing.assert_close(out, m_out, atol=1e-6, rtol=0)
    torch.testing.assert_close(lse, m_lse, atol=1e-6, rtol=0)
    got = f1.flash_segment_attention_bwd_reference(q, k, v, seg, out, lse, do)
    want = fa.flash_segment_attention_mh_bwd_reference(q, k, v, seg, out, lse, do)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=name)


def test_tiny_model_forward_matches_jax(rng):
    """The tiny tokenizer (patch (2,4,4), f32) through ``flash_v1`` against
    JAX's forward with dense attention, same weights: indices exact, recon
    within 1e-5."""
    jmodel = JTiTokModel(JTiTok(patch_size=(2, 4, 4), dtype=jnp.float32, attn_impl="reference"),
                         seq_len=256, min_grid=(2, 8, 8), seed=7)
    params = from_flax_params(jax.tree.map(np.asarray, jmodel.params))
    port = TiTokModel(TiTok(patch_size=(2, 4, 4), dtype=torch.float32, attn_impl="flash_v1"),
                      params=params, seq_len=256, min_grid=(2, 8, 8), device="cpu")
    clips = [rng.uniform(-1, 1, (3, 4, 8, 8)).astype(np.float32),
             rng.uniform(-1, 1, (3, 2, 16, 12)).astype(np.float32)]
    tcs = [5, 9]
    recon, aux = port.forward(clips, tcs)
    want_recon, want_aux = jmodel.forward(clips, tcs)
    for a, b in zip(aux["indices"], want_aux["indices"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(recon, want_recon):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_flash_v1_under_remat_matches_no_remat(rng):
    """``training.main.remat`` with ``flash_v1``: the checkpointed ``Attn``
    replays the v1 forward in the backward; loss and grads equal those
    without remat."""
    from titok_tpu_torch.data.packing import pack_samples, to_device
    from titok_tpu_torch.models.titok import init_params, state_tensors

    clips = [rng.uniform(-1, 1, (3, 4, 8, 8)).astype(np.float32),
             rng.uniform(-1, 1, (3, 2, 16, 12)).astype(np.float32)]
    batch = to_device(pack_samples(clips, [5, 9], seq_len=128, max_samples=4,
                                   patch_size=(2, 4, 4)), "cpu")
    params = None
    grads = {}
    for remat in (False, True):
        model = TiTok(patch_size=(2, 4, 4), dtype=torch.float32, attn_impl="flash_v1",
                      remat=remat)
        params = params or state_tensors(init_params(model, 3))
        model.load_state_dict(params)
        recon, _ = model(batch)
        loss = recon.square().mean()
        grads[remat] = (loss.detach(), torch.autograd.grad(loss, list(model.parameters())))
    assert torch.equal(grads[True][0], grads[False][0])
    for a, b in zip(grads[True][1], grads[False][1]):
        assert torch.equal(a, b)
