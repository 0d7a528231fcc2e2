"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the segment-attention forward and its backward (dq and dk/dv kernels), with
RoPE fused and in their v1 form (``attn_impl: flash_v1``), the VQ
nearest-neighbour kernel, train steps (FSQ, EMA-VQ, flash_rope with remat,
flash_v1) that go through them, and a short ``Trainer.fit``.

Every test here needs a CUDA card and the CUDA toolkit; without one it skips
(the fixture decides, never the import). This file imports no JAX, so it
runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from titok_tpu_torch.ops import flash_attention_mh as fa
from titok_tpu_torch.ops import vq_distance as vd

pytestmark = pytest.mark.gpu

# (out atol, out rtol, lse atol): f32 differs from the plain version by FMA
# order only; bf16 by two bf16 roundings (p and out) and the sum order
TOL = {torch.float32: (1e-5, 0.0, 1e-5), torch.bfloat16: (3e-2, 1e-2, 1e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _segments(lengths, S):
    seg = np.zeros((S,), np.int32)
    off = 0
    for i, n in enumerate(lengths):
        seg[off:off + n] = i + 1
        off += n
    return torch.from_numpy(seg)


def _inputs(dev, dtype, S, hq, hkv, seed=0, Sk=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    Sk = S if Sk is None else Sk
    q = torch.randn(S, hq, 64, generator=g, device=dev).to(dtype)
    k = torch.randn(Sk, hkv, 64, generator=g, device=dev).to(dtype)
    v = torch.randn(Sk, hkv, 64, generator=g, device=dev).to(dtype)
    return q, k, v


def _assert_close(out, lse, ref_out, ref_lse, dtype):
    atol, rtol, lse_atol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=lse_atol, rtol=0)


CASES = {
    "serving 10x576 4/2": ([576] * 10, 6144, 4, 2),
    "large heads 16/4": ([576] * 10, 6144, 16, 4),
    "base heads 12/4": ([1152, 1088, 640, 576, 513], 4096, 12, 4),
    "ragged 1..1892, pad": ([1, 2, 63, 64, 65, 127, 1892, 700, 5, 333], 3299, 4, 2),
    "one row": ([1], 1, 4, 2),
    "all pad": ([], 100, 4, 2),
    "MHA 4/4": ([50, 70], 130, 4, 4),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(cuda, dtype, case):
    lengths, S, hq, hkv = CASES[case]
    q, k, v = _inputs(cuda, dtype, S, hq, hkv)
    seg = _segments(lengths, S).to(cuda)
    key = "bf16" if dtype == torch.bfloat16 else "f32"
    before = fa.launches[key]
    out, lse = fa._fwd(q, k, v, seg)
    torch.cuda.synchronize()
    assert fa.launches[key] == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32 and lse.shape == (S, hq)
    ref_out, ref_lse = fa.flash_segment_attention_mh_reference(q, k, v, seg)
    _assert_close(out, lse, ref_out, ref_lse, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernel_separate_k_segments(cuda, dtype):
    q, k, v = _inputs(cuda, dtype, 200, 4, 2, Sk=333)
    seg_q = _segments([90, 110], 200).to(cuda)
    seg_k = _segments([60, 140, 100], 333).to(cuda)
    out, lse = fa._fwd(q, k, v, seg_q, k_segment_ids=seg_k)
    ref_out, ref_lse = fa.flash_segment_attention_mh_reference(q, k, v, seg_q,
                                                               k_segment_ids=seg_k)
    _assert_close(out, lse, ref_out, ref_lse, dtype)


def test_wrapper_raises_on_cuda_instead_of_falling_back(cuda):
    q, k, v = _inputs(cuda, torch.float32, 128, 4, 2)
    seg = _segments([128], 128).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_segment_attention_mh(q.transpose(0, 1).contiguous().transpose(0, 1),
                                      k, v, seg)
    with pytest.raises(ValueError, match="int32"):
        fa.flash_segment_attention_mh(q, k, v, seg.long())
    with pytest.raises(ValueError, match="bf16 or all f32"):
        fa.flash_segment_attention_mh(q.half(), k.half(), v.half(), seg)
    with pytest.raises(ValueError, match="is on"):
        fa.flash_segment_attention_mh(q, k, v, seg.cpu())


def test_serving_path_launches_the_kernel(cuda):
    """A tiny-width model at the serving layout goes through the kernel:
    4 launches per encode group, 8 per forward group."""
    from titok_tpu_torch.models.titok import TiTok, TiTokModel

    model = TiTokModel(TiTok(patch_size=(2, 4, 4)), seq_len=256, min_grid=(2, 8, 8),
                       device=cuda)
    rng = np.random.default_rng(0)
    clips = [rng.uniform(-1, 1, (3, 4, 8, 8)).astype(np.float32) for _ in range(3)]
    fa.reset_launches()
    idx = model.encode(clips, [3, 5, 7])
    assert fa.launches["bf16"] == 4
    recon, _ = model.forward(clips, [3, 5, 7])
    assert fa.launches["bf16"] == 12
    assert [len(i) for i in idx] == [3, 5, 7]
    assert all(np.isfinite(r).all() for r in recon)


# backward vs plain, each of dq, dk, dv against the plain version's b:
# (atol_frac, rtol, nrel) for |d| <= atol_frac * M + rtol * |b| per entry
# and rms(d) <= nrel * R per output, M the largest |entry| and R the rms of
# the plain dq, dk, dv together. The grads are small (max|b| 0.7-1.3 at the
# bench shape), so the absolute part scales with them; over all three
# outputs it also covers one that is only round-off (one row: dq = dk = 0).
# bf16: both sides round p, ds and the outputs at the same places and sum
# in another order, so an output may land one bf16 ulp (< 0.8 % of |b|)
# away; f32: FMA order only. The same limits as chip_smoke.py's, which
# says how they were set and where planted faults show what they reject.
BWD_TOL = {torch.float32: (1e-6, 1e-4, 3e-6), torch.bfloat16: (1.5e-3, 1e-2, 5e-4)}


def _assert_bwd_close(got, want, dtype):
    atol_frac, rtol, nrel = BWD_TOL[dtype]
    bs = [b.float() for b in want]
    M = max(b.abs().max().item() for b in bs)
    R = torch.cat([b.flatten() for b in bs]).square().mean().sqrt().item()
    for name, a, b32 in zip(("dq", "dk", "dv"), got, bs):
        a32 = a.float()
        torch.testing.assert_close(a32, b32, atol=atol_frac * M, rtol=rtol, msg=name)
        rms_d = (a32 - b32).square().mean().sqrt().item()
        assert rms_d <= nrel * R, (name, rms_d, R)


def _stacked_ids(S1, lengths, copies):
    """``copies`` disc buffers of S1 rows stacked as the discriminator's
    packed pass lays them out (pads get a per-copy id, no id is 0)."""
    from titok_tpu_torch.losses.loss_module import stacked_segment_ids

    return stacked_segment_ids(_segments(lengths, S1), copies, len(lengths) + 2)


BWD_CASES = {
    "bench 10x576 4/2": (lambda: _segments([576] * 10, 6144), 4, 2),
    "large heads 16/4": (lambda: _segments([576] * 10, 6144), 16, 4),
    "base heads 12/4": (lambda: _segments([1152, 1088, 640, 576, 513], 4096), 12, 4),
    "ragged 1..1892, pad": (lambda: _segments([1, 2, 63, 64, 65, 127, 1892, 700, 5, 333], 3299),
                            4, 2),
    "stacked disc ids x4": (lambda: _stacked_ids(700, [300, 1, 250, 120], 4), 4, 2),
    "one row": (lambda: _segments([1], 1), 4, 2),
}


def _bwd_inputs(dev, dtype, seg, hq, hkv, seed=1, Sk=None, k_seg=None):
    S = seg.shape[0]
    q, k, v = _inputs(dev, dtype, S, hq, hkv, seed=seed, Sk=Sk)
    out, lse = fa._fwd(q, k, v, seg, k_segment_ids=k_seg)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dout = torch.randn(S, hq, 64, generator=g, device=dev).to(dtype)
    return q, k, v, out, lse, dout


def _check_bwd(dev, dtype, seg, hq, hkv, Sk=None, k_seg=None):
    q, k, v, out, lse, dout = _bwd_inputs(dev, dtype, seg, hq, hkv, Sk=Sk, k_seg=k_seg)
    key = "bf16" if dtype == torch.bfloat16 else "f32"
    before = (fa.launches[f"bwd_dq_{key}"], fa.launches[f"bwd_dkv_{key}"])
    got = fa._bwd(q, k, v, seg, out, lse, dout, k_segment_ids=k_seg)
    torch.cuda.synchronize()
    assert (fa.launches[f"bwd_dq_{key}"], fa.launches[f"bwd_dkv_{key}"]) == \
        (before[0] + 1, before[1] + 1)
    want = fa.flash_segment_attention_mh_bwd_reference(q, k, v, seg, out, lse, dout,
                                                       k_segment_ids=k_seg)
    for name, a, x in zip(("dq", "dk", "dv"), got, (q, k, v)):
        assert a.dtype == dtype and a.shape == x.shape, name
        assert bool(torch.isfinite(a.float()).all()), name
    _assert_bwd_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_bwd_kernels_match_plain(cuda, dtype, case):
    make_seg, hq, hkv = BWD_CASES[case]
    _check_bwd(cuda, dtype, make_seg().to(cuda), hq, hkv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_bwd_kernels_separate_k_segments(cuda, dtype):
    seg_q = _segments([90, 110], 200).to(cuda)
    seg_k = _segments([60, 140, 100], 333).to(cuda)
    _check_bwd(cuda, dtype, seg_q, 4, 2, Sk=333, k_seg=seg_k)


def test_bwd_raises_on_cuda_instead_of_falling_back(cuda):
    seg = _segments([128], 128).to(cuda)
    q, k, v, out, lse, dout = _bwd_inputs(cuda, torch.float32, seg, 4, 2)
    with pytest.raises(ValueError, match="dout must be a contiguous"):
        fa._bwd(q, k, v, seg, out, lse, dout.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="lse is"):
        fa._bwd(q, k, v, seg, out, lse.double(), dout)
    with pytest.raises(ValueError, match="dout is"):
        fa._bwd(q, k, v, seg, out, lse, dout.to(torch.bfloat16))
    with pytest.raises(ValueError, match="int32"):
        fa._bwd(q, k, v, seg.long(), out, lse, dout)


def _small_train_config(*extra):
    import os

    from titok_tpu_torch.config import load_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return load_config(os.path.join(repo, "configs", "tiny.yaml"), [
        "tokenizer.model.patch_size=[2,4,4]", "discriminator.model.patch_size=[2,4,4]",
        "tokenizer.losses.perceptual_weight=0", "training.sampling.min_grid=[2,8,8]",
        "training.sampling.max_grid=[4,16,16]", "training.sampling.token_range=[1,8]",
        "training.sampling.train_seq_len=256", "optimizer.warmup_steps=0", *extra])


def test_bf16_grads_reach_every_parameter(cuda):
    """bf16 compute with fp32 params, through the kernels: the generator
    loss reaches every generator parameter through the per-call casts of
    ``Dense`` and FSQ's straight-through rounding, and the discriminator
    loss every discriminator parameter, with finite, non-zero grads."""
    from titok_tpu_torch.data.packing import build_disc_batch, to_device
    from titok_tpu_torch.losses.loss_module import LossSystem
    from titok_tpu_torch.models.titok import make_titok
    from titok_tpu_torch.training.train_step import TrainStepBuilder
    from titok_tpu_torch.training.trainer import synthetic_batches

    cfg = _small_train_config()
    ls = LossSystem(cfg)
    state = TrainStepBuilder(make_titok(cfg), ls, cfg).init_state(device=cuda)
    batch = next(synthetic_batches(cfg, seed=1))
    bt, dt = to_device(batch, cuda), to_device(build_disc_batch(batch, ls.disc_tokens), cuda)
    recon, _ = state.model(bt)
    assert recon.dtype == torch.bfloat16
    for module, loss in ((state.model, ls.generator_loss(recon, bt, dt)[0]),
                         (state.disc_model, ls.discriminator_loss(recon.detach(), bt, dt)[0])):
        params = list(module.parameters())
        assert all(p.dtype == torch.float32 for p in params)
        grads = torch.autograd.grad(loss, params)  # raises if a param is unused
        assert all(bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0) for g in grads)


def test_train_step_launches_both_backward_kernels(cuda):
    """One GAN train step of a small-patch tiny model on the card: every
    attention layer runs the forward kernel once and both backward kernels
    once (generator pass: encoder 4 + decoder 4 + the stacked disc pass 4;
    discriminator pass: 4), all in bf16, and the metrics are finite."""
    import itertools

    from titok_tpu_torch.data.packing import build_disc_batch, to_device
    from titok_tpu_torch.losses.loss_module import LossSystem
    from titok_tpu_torch.models.titok import make_titok
    from titok_tpu_torch.training.train_step import TrainStepBuilder
    from titok_tpu_torch.training.trainer import synthetic_batches

    cfg = _small_train_config()
    ls = LossSystem(cfg)
    builder = TrainStepBuilder(make_titok(cfg), ls, cfg)
    state = builder.init_state(device=cuda)
    step = builder.make_train_step()
    (batch,) = itertools.islice(synthetic_batches(cfg, seed=0), 1)
    disc = build_disc_batch(batch, ls.disc_tokens)
    fa.reset_launches()
    state, metrics, indices = step(state, to_device(batch, cuda), to_device(disc, cuda))
    torch.cuda.synchronize()
    assert fa.launches["bf16"] == 16
    assert fa.launches["bwd_dq_bf16"] == 16 and fa.launches["bwd_dkv_bf16"] == 16
    assert fa.launches["f32"] == fa.launches["bwd_dq_f32"] == 0
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["nonfinite_grad/generator"]) == 0.0
    assert int(indices.max()) < 4375 and int(indices.min()) >= 0


# VQ nearest-neighbour kernel against its plain version: vd.gate holds every
# row's chosen code within eps * (1 + |d*|) of the plain minimum d* (the
# kernel contracts the dot product into FMAs, the plain version rounds each
# product), the partial distance as close, and with exact=True every index
# equal to the plain version's: a codebook without near ties, duplicated
# rows (the lower index wins) and exact ties.
VQ_EPS = 1e-6


def _vq_inputs(dev, kind, S, N, D, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "normal":
        return (torch.randn(S, D, generator=g, device=dev),
                torch.randn(N, D, generator=g, device=dev))
    if kind == "ties":  # integer codes, z on midpoints: equal distances, exactly
        cb = torch.randint(-3, 4, (N, D), generator=g, device=dev).float()
        a = torch.randint(0, N, (S,), generator=g, device=dev)
        b = torch.randint(0, N, (S,), generator=g, device=dev)
        return (cb[a] + cb[b]) / 2, cb
    cb = torch.randn(N, D, generator=g, device=dev) * 10.0
    if kind == "duplicated":  # the second half repeats the first
        cb[N // 2:] = cb[: N - N // 2]
    pick = torch.randint(0, N, (S,), generator=g, device=dev)
    return cb[pick] + 0.05 * torch.randn(S, D, generator=g, device=dev), cb


VQ_CASES = {
    "base_vq 4096x16384x8": ("normal", 4096, 16384, 8, False),
    "ragged S 3299, N 1000": ("normal", 3299, 1000, 8, False),
    "tiny N 1": ("normal", 300, 1, 8, True),
    "N 37 under one tile, D 4": ("normal", 777, 37, 4, False),
    "separated": ("separated", 4096, 16384, 8, True),
    "duplicated rows": ("duplicated", 4096, 16384, 8, True),
    "exact ties": ("ties", 2000, 500, 8, True),
}


@pytest.mark.parametrize("case", list(VQ_CASES))
def test_vq_kernel_matches_plain(cuda, case):
    kind, S, N, D, exact = VQ_CASES[case]
    z, cb = _vq_inputs(cuda, kind, S, N, D)
    before = vd.launches["f32"]
    idx, dist = vd.vq_nearest(z, cb)
    torch.cuda.synchronize()
    assert vd.launches["f32"] == before + 1
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32 and idx.shape == (S,)
    g = vd.gate(z, cb, idx, dist, eps=VQ_EPS, exact=exact)
    assert g["ok"], g
    assert g["same"] >= 0.999, g
    if kind == "duplicated":
        assert bool((idx < N // 2).all())


def test_vq_gate_rejects_planted_faults(cuda):
    """The kernel run with its last codebook tile skipped, and with ties
    sent to the highest index (the kernel on the reversed codebook), fails
    the gate."""
    z, cb = _vq_inputs(cuda, "normal", 4096, 16384, 8)
    skip = vd.vq_nearest(z, cb[: -vd.TILE_N].contiguous())
    assert not vd.gate(z, cb, *skip, eps=VQ_EPS)["ok"]
    zd, cbd = _vq_inputs(cuda, "duplicated", 4096, 16384, 8)
    hi_i, hi_d = vd.vq_nearest(zd, cbd.flip(0).contiguous())
    hi_i = (cbd.shape[0] - 1 - hi_i).to(torch.int32)
    assert not vd.gate(zd, cbd, hi_i, hi_d, eps=VQ_EPS, exact=True)["ok"]


def test_vq_wrapper_raises_on_cuda_instead_of_falling_back(cuda):
    z, cb = _vq_inputs(cuda, "normal", 64, 128, 8)
    with pytest.raises(ValueError, match="f32"):
        vd.vq_nearest(z.half(), cb.half())
    with pytest.raises(ValueError, match="contiguous"):
        vd.vq_nearest(z, cb.t().contiguous().t())
    with pytest.raises(ValueError, match="D <= 16"):
        vd.vq_nearest(torch.zeros(4, 17, device=cuda), torch.zeros(8, 17, device=cuda))
    with pytest.raises(ValueError, match="is on"):
        vd.vq_nearest(z, cb.cpu())


def test_vq_train_step_launches_the_kernels(cuda):
    """One GAN train step of a small EMA-VQ model on the card: the VQ
    kernel once (the generator's forward), the attention kernels 16 times
    each, and the codebook moves."""
    import itertools

    from titok_tpu_torch.data.packing import build_disc_batch, to_device
    from titok_tpu_torch.losses.loss_module import LossSystem
    from titok_tpu_torch.models.titok import make_titok
    from titok_tpu_torch.training.train_step import TrainStepBuilder
    from titok_tpu_torch.training.trainer import synthetic_batches

    cfg = _small_train_config("tokenizer.model.quantizer=vq",
                              "tokenizer.model.vq={codebook_size: 512, dim: 8}")
    ls = LossSystem(cfg)
    builder = TrainStepBuilder(make_titok(cfg), ls, cfg)
    (batch,) = itertools.islice(synthetic_batches(cfg, seed=0), 1)
    bt = to_device(batch, cuda)
    state = builder.init_state(device=cuda, batch=bt)
    step = builder.make_train_step()
    cb0 = state.model.quantize.codebook.clone()
    disc = build_disc_batch(batch, ls.disc_tokens)
    fa.reset_launches()
    vd.reset_launches()
    state, metrics, indices = step(state, bt, to_device(disc, cuda))
    torch.cuda.synchronize()
    assert vd.launches["f32"] == 1
    assert fa.launches["bf16"] == fa.launches["bwd_dq_bf16"] == fa.launches["bwd_dkv_bf16"] == 16
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["gen/vq_perplexity"]) > 1.0
    assert int(indices.max()) < 512 and int(indices.min()) >= 0
    assert not torch.equal(state.model.quantize.codebook, cb0)


# RoPE fused into the attention kernels (attn_impl: flash_rope): each rope
# kernel against its plain version (apply_rotary_emb, then the plain
# forward; the plain backward on the rotated q and k with dq and dk
# inverse-rotated in f32 and rounded once), under the limits of the unfused
# kernels (TOL, BWD_TOL).


def _rope_tables(dev, S, P, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    ang = torch.rand(S, P, generator=g, device=dev) * (2 * np.pi)
    return ang.cos(), ang.sin()


ROPE_CASES = {
    "4/2 P30 ragged, pad": ([1, 2, 63, 64, 65, 127, 300, 5], 700, 4, 2, 30),
    "16/4 P30": ([513, 1040, 416], 2100, 16, 4, 30),
    "12/4 P16 (pass-through pairs)": ([200, 333, 64], 640, 12, 4, 16),
    "stacked disc ids x4 4/2 P30": (None, None, 4, 2, 30),
}


def _rope_case(dev, dtype, case, seed=3):
    lengths, S, hq, hkv, P = ROPE_CASES[case]
    if lengths is None:
        seg = _stacked_ids(400, [200, 1, 150, 40], 4).to(dev)
    else:
        seg = _segments(lengths, S).to(dev)
    S = seg.shape[0]
    q, k, v = _inputs(dev, dtype, S, hq, hkv, seed=seed)
    cos, sin = _rope_tables(dev, S, P, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dout = torch.randn(S, hq, 64, generator=g, device=dev).to(dtype)
    return q, k, v, seg, cos, sin, dout


def _check_rope(dev, dtype, q, k, v, seg, cos, sin, dout, k_seg=None, k_cos=None, k_sin=None):
    key = "bf16" if dtype == torch.bfloat16 else "f32"
    names = (f"rope_{key}", f"rope_bwd_dq_{key}", f"rope_bwd_dkv_{key}")
    before = [fa.launches[n] for n in names]
    out, lse = fa._rope_fwd(q, k, v, seg, cos, sin, None, k_seg, k_cos, k_sin)
    got = fa._rope_bwd(q, k, v, seg, cos, sin, out, lse, dout, None, k_seg, k_cos, k_sin)
    torch.cuda.synchronize()
    assert [fa.launches[n] for n in names] == [b + 1 for b in before]
    ref_out, ref_lse = fa.flash_segment_attention_mh_rope_reference(
        q, k, v, seg, cos, sin, None, k_seg, k_cos, k_sin)
    _assert_close(out, lse, ref_out, ref_lse, dtype)
    # the backward from the kernel's own out and lse, as autograd runs it
    want = fa.flash_segment_attention_mh_rope_bwd_reference(
        q, k, v, seg, cos, sin, out, lse, dout, None, k_seg, k_cos, k_sin)
    for name, a, x in zip(("dq", "dk", "dv"), got, (q, k, v)):
        assert a.dtype == dtype and a.shape == x.shape, name
        assert bool(torch.isfinite(a.float()).all()), name
    _assert_bwd_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(ROPE_CASES))
def test_rope_kernels_match_plain(cuda, dtype, case):
    _check_rope(cuda, dtype, *_rope_case(cuda, dtype, case))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_rope_kernels_separate_k_ids_and_tables(cuda, dtype):
    seg_q = _segments([90, 110], 200).to(cuda)
    seg_k = _segments([60, 140, 100], 333).to(cuda)
    q, _, _ = _inputs(cuda, dtype, 200, 4, 2, seed=5)
    _, k, v = _inputs(cuda, dtype, 333, 4, 2, seed=6)
    cos, sin = _rope_tables(cuda, 200, 30, 7)
    k_cos, k_sin = _rope_tables(cuda, 333, 30, 8)
    dout = torch.randn(200, 4, 64, device=cuda).to(dtype)
    _check_rope(cuda, dtype, q, k, v, seg_q, cos, sin, dout, seg_k, k_cos, k_sin)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_rope_forward_equals_unfused_bit_for_bit(cuda, dtype):
    """The rope forward kernel on raw q, k equals apply_rotary_emb (one
    rounding per product and sum, as the kernel rotates) followed by the
    unfused forward kernel, bit for bit."""
    from titok_tpu_torch.models.rope import apply_rotary_emb

    q, k, v, seg, cos, sin, _ = _rope_case(cuda, dtype, "16/4 P30")
    out, lse = fa._rope_fwd(q, k, v, seg, cos, sin)
    ref_out, ref_lse = fa._fwd(apply_rotary_emb(q, cos, sin), apply_rotary_emb(k, cos, sin),
                               v, seg)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)


def test_rope_wrapper_raises_on_cuda_instead_of_falling_back(cuda):
    q, k, v, seg, cos, sin, _ = _rope_case(cuda, torch.float32, "4/2 P30 ragged, pad")
    with pytest.raises(ValueError, match="f32"):
        fa.flash_segment_attention_mh(q, k, v, seg, rope_cos=cos.double(), rope_sin=sin.double())
    with pytest.raises(ValueError, match="P"):
        fa.flash_segment_attention_mh(q, k, v, seg, rope_cos=cos[:, :20].contiguous(),
                                      rope_sin=sin[:, :21].contiguous())
    with pytest.raises(ValueError, match="1..32"):
        wide = torch.zeros(q.shape[0], 33, device=cuda)
        fa.flash_segment_attention_mh(q, k, v, seg, rope_cos=wide, rope_sin=wide)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_segment_attention_mh(q, k, v, seg, rope_cos=cos.t().contiguous().t(),
                                      rope_sin=sin)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_segment_attention_mh(q, k, v, seg, rope_cos=cos.cpu(), rope_sin=sin.cpu())


def test_flash_rope_remat_train_step_launches(cuda):
    """One GAN step of a small tiny model with attn_impl flash_rope and
    remat on: the rope kernels only, each dq and dk/dv kernel once per
    attention layer (encoder 4 + decoder 4 + stacked disc 4 in the
    generator pass, disc 4 in the discriminator pass) and the rope forward
    twice per layer (the forward, and its replay in the backward)."""
    import itertools

    from titok_tpu_torch.data.packing import build_disc_batch, to_device
    from titok_tpu_torch.losses.loss_module import LossSystem
    from titok_tpu_torch.models.titok import make_titok
    from titok_tpu_torch.training.train_step import TrainStepBuilder
    from titok_tpu_torch.training.trainer import synthetic_batches

    cfg = _small_train_config("training.main.attn_impl=flash_rope", "training.main.remat=true")
    ls = LossSystem(cfg)
    builder = TrainStepBuilder(make_titok(cfg), ls, cfg)
    state = builder.init_state(device=cuda)
    step = builder.make_train_step()
    (batch,) = itertools.islice(synthetic_batches(cfg, seed=0), 1)
    disc = build_disc_batch(batch, ls.disc_tokens)
    fa.reset_launches()
    state, metrics, indices = step(state, to_device(batch, cuda), to_device(disc, cuda))
    torch.cuda.synchronize()
    n = 4 + 4 + 4 + 4
    assert fa.launches == {**{k: 0 for k in fa.launches}, "rope_bf16": 2 * n,
                           "rope_bwd_dq_bf16": n, "rope_bwd_dkv_bf16": n}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["nonfinite_grad/generator"]) == 0.0
    assert int(indices.max()) < 4375 and int(indices.min()) >= 0


# the v1 kernels (attn_impl: flash_v1): forward, dq and per-q-head dk/dv,
# Sq == Sk, tile pairs skipped by interval overlap. Forward: the row 1
# limits and rms(out - plain) <= nrel * rms(plain) (the plain version rounds
# p against the same running max per 64-row kv tile as the kernel, so in
# bf16 they differ only where the sum order moves an output to its
# neighbouring bf16 value); grads: the backward limits above.
V1_CASES = {
    "bench 10x576 4/2": ([576] * 10, 6144, 4, 2),
    "base_vq layout 12/4": ([513, 1040, 416, 832, 608], 4096, 12, 4),
    "ragged 1..1892, pad": ([1, 2, 63, 64, 65, 127, 1892, 700, 5, 333], 3299, 4, 2),
    "one row": ([1], 1, 4, 2),
    "all pad": ([], 100, 4, 2),
    "MHA 4/4": ([50, 70], 130, 4, 4),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(V1_CASES))
def test_v1_kernels_match_plain(cuda, dtype, case):
    from titok_tpu_torch.ops import flash_attention as f1

    lengths, S, hq, hkv = V1_CASES[case]
    q, k, v = _inputs(cuda, dtype, S, hq, hkv, seed=3)
    dout = torch.randn(S, hq, 64, generator=torch.Generator(device=cuda).manual_seed(4),
                       device=cuda).to(dtype)
    seg = _segments(lengths, S).to(cuda)
    key = "bf16" if dtype == torch.bfloat16 else "f32"
    names = (f"v1_{key}", f"v1_bwd_dq_{key}", f"v1_bwd_dkv_{key}")
    before = {n: fa.launches[n] for n in names}
    out, lse = f1._fwd(q, k, v, seg)
    grads = f1._bwd(q, k, v, seg, out, lse, dout)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in names} == {n: 1 for n in names}
    ref_out, ref_lse = f1.flash_segment_attention_reference(q, k, v, seg)
    _assert_close(out, lse, ref_out, ref_lse, dtype)
    nrel = BWD_TOL[dtype][2]
    d = (out.float() - ref_out.float()).square().mean().sqrt().item()
    assert d <= nrel * max(ref_out.float().square().mean().sqrt().item(), 1e-30)
    want = f1.flash_segment_attention_bwd_reference(q, k, v, seg, out, lse, dout)
    for a, x in zip(grads, (q, k, v)):
        assert a.dtype == dtype and a.shape == x.shape and bool(torch.isfinite(a.float()).all())
    _assert_bwd_close(grads, want, dtype)


def test_v1_wrappers_raise_on_cuda_instead_of_falling_back(cuda):
    from titok_tpu_torch.ops import flash_attention as f1

    seg = _segments([128], 128).to(cuda)
    q, k, v = _inputs(cuda, torch.float32, 128, 4, 2)
    with pytest.raises(ValueError, match="Sq == Sk"):
        f1._fwd(q, k[:100].contiguous(), v[:100].contiguous(), seg)
    with pytest.raises(ValueError, match="int32"):
        f1._fwd(q, k, v, seg.long())
    qmm = f1.tile_minmax(seg, 64)
    with pytest.raises(ValueError, match="tiles of 32 rows"):
        f1.launch_fwd(q, k, v, seg, qmm, qmm, 0.125)  # the f32 forward's kv tiles are 32


def test_flash_v1_train_step_launches(cuda):
    """One GAN step of a small tiny model with attn_impl flash_v1: the v1
    kernels only, each once per attention layer (encoder 4 + decoder 4 +
    stacked disc 4 in the generator pass, disc 4 in the discriminator
    pass), none of the row 1-4 kernels."""
    import itertools

    from titok_tpu_torch.data.packing import build_disc_batch, to_device
    from titok_tpu_torch.losses.loss_module import LossSystem
    from titok_tpu_torch.models.titok import make_titok
    from titok_tpu_torch.training.train_step import TrainStepBuilder
    from titok_tpu_torch.training.trainer import synthetic_batches

    cfg = _small_train_config("training.main.attn_impl=flash_v1")
    ls = LossSystem(cfg)
    builder = TrainStepBuilder(make_titok(cfg), ls, cfg)
    state = builder.init_state(device=cuda)
    step = builder.make_train_step()
    (batch,) = itertools.islice(synthetic_batches(cfg, seed=0), 1)
    disc = build_disc_batch(batch, ls.disc_tokens)
    fa.reset_launches()
    state, metrics, indices = step(state, to_device(batch, cuda), to_device(disc, cuda))
    torch.cuda.synchronize()
    n = 4 + 4 + 4 + 4
    assert fa.launches == {**{k: 0 for k in fa.launches}, "v1_bf16": n,
                           "v1_bwd_dq_bf16": n, "v1_bwd_dkv_bf16": n}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["nonfinite_grad/generator"]) == 0.0
    assert int(indices.max()) < 4375 and int(indices.min()) >= 0


def test_trainer_fit_on_the_card(cuda, tmp_path):
    """``Trainer.fit`` of 2 steps on the card through the v1 kernels: the
    prefetch thread's copies, the train step, the eval with PSNR/SSIM
    summed on the device (16x16 frames and up), the final checkpoint."""
    import json
    import os

    from titok_tpu_torch.train_utils.checkpoints import CheckpointManager
    from titok_tpu_torch.training.trainer import Trainer

    cfg = _small_train_config(
        "training.main.attn_impl=flash_v1", "training.main.max_steps=2",
        "training.sampling.min_grid=[2,16,16]", "training.sampling.max_grid=[4,24,24]",
        "training.sampling.eval_seq_len=256", "training.eval.eval_samples=4",
        "training.eval.eval_step_interval=1", "general.wandb.log_step_interval=1",
        "dataset.train_dataset=synthetic", "dataset.eval_dataset=synthetic",
        f"general.checkpoints.save_path={tmp_path}")
    fa.reset_launches()
    state = Trainer(cfg).fit()
    torch.cuda.synchronize()
    assert state.step == 2 and next(state.model.parameters()).is_cuda
    assert fa.launches["v1_bwd_dq_bf16"] == 2 * 16 and fa.launches["bf16"] == 0
    rows = [json.loads(line) for line in open(os.path.join(tmp_path, "metrics.jsonl"))]
    assert [r["step"] for r in rows if "train/gen/total_loss" in r] == [0, 1]
    evals = [r for r in rows if "eval/psnr" in r]
    assert [r["step"] for r in evals] == [1, 2] and all("eval/ssim" in r for r in evals)
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
