"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the segment-attention forward and its backward (dq and dk/dv kernels), with
RoPE fused and in their v1 form (``attn_impl: flash_v1``), the VQ
nearest-neighbour kernel, train steps (FSQ, EMA-VQ, flash_rope with remat,
flash_v1) that go through them, and a short ``Trainer.fit``; and the
perceptual loss's modules (LPIPS, ``crop_resize``) against the CPU.

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


def _vq_inputs(dev, kind, S, N, D, seed=0, shift=None):
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
    if kind == "duplicated":  # codes [shift, 2 shift) repeat codes [0, shift)
        shift = N // 2 if shift is None else shift
        cb[shift:2 * shift] = cb[:shift].clone()
    pick = torch.randint(0, N, (S,), generator=g, device=dev)
    return cb[pick] + 0.05 * torch.randn(S, D, generator=g, device=dev), cb


def _vq_shifts():
    """Where a code's duplicate lands at the base_vq plan: the next lane
    group's range, the next warp's, the next cluster rank's."""
    p = vd.plan_for(4096, 16384)
    return {"group": p.per_range, "warp": p.per_range * vd.GROUPS,
            "rank": p.per_range * vd.GROUPS * p.warps}


VQ_CASES = {
    "base_vq 4096x16384x8": ("normal", 4096, 16384, 8, False, None),
    "unpadded S 3409x16384x8": ("normal", 3409, 16384, 8, False, None),
    "unpadded S 1152x16384x8": ("normal", 1152, 16384, 8, False, None),
    "ragged S 3299, N 1000": ("normal", 3299, 1000, 8, False, None),
    "tiny N 1": ("normal", 300, 1, 8, True, None),
    "N 37 under one step, D 4": ("normal", 777, 37, 4, False, None),
    "separated": ("separated", 4096, 16384, 8, True, None),
    "duplicated rows": ("duplicated", 4096, 16384, 8, True, None),
    "duplicates in the next lane group": ("duplicated", 4096, 16384, 8, True, "group"),
    "duplicates in the next warp": ("duplicated", 4096, 16384, 8, True, "warp"),
    "duplicates in the next cluster rank": ("duplicated", 4096, 16384, 8, True, "rank"),
    "exact ties": ("ties", 2000, 500, 8, True, None),
}


@pytest.mark.parametrize("case", list(VQ_CASES))
def test_vq_kernel_matches_plain(cuda, case):
    kind, S, N, D, exact, where = VQ_CASES[case]
    shift = _vq_shifts()[where] if where else None
    z, cb = _vq_inputs(cuda, kind, S, N, D, shift=shift)
    before = vd.launches["f32"]
    idx, dist = vd.vq_nearest(z, cb)
    torch.cuda.synchronize()
    assert vd.launches["f32"] == before + 1
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32 and idx.shape == (S,)
    g = vd.gate(z, cb, idx, dist, eps=VQ_EPS, exact=exact)
    assert g["ok"], g
    assert g["same"] >= 0.999, g
    if kind == "duplicated":  # never the repeating copy
        shift = N // 2 if shift is None else shift
        assert not bool(((idx >= shift) & (idx < 2 * shift)).any())


def test_vq_kernel_same_bits_and_nan_row(cuda):
    """Two launches give the same bits; a row of NaNs gives (0, +inf) and
    leaves the other rows as they were."""
    z, cb = _vq_inputs(cuda, "normal", 4096, 16384, 8)
    a_i, a_d = vd.vq_nearest(z, cb)
    b_i, b_d = vd.vq_nearest(z, cb)
    assert torch.equal(a_i, b_i) and torch.equal(a_d.view(torch.int32), b_d.view(torch.int32))
    zn = z.clone()
    zn[5] = float("nan")
    n_i, n_d = vd.vq_nearest(zn, cb)
    assert int(n_i[5]) == 0 and float(n_d[5]) == float("inf")
    keep = torch.arange(4096, device=cuda) != 5
    assert torch.equal(n_i[keep], a_i[keep]) and torch.equal(n_d[keep], a_d[keep])


def test_vq_gate_rejects_planted_faults(cuda):
    """The kernel run with its last step of codes skipped, with ties sent
    to the highest index (the kernel on the reversed codebook), and with
    ties across cluster ranks sent to the later rank (the kernel on a
    codebook whose copies in the first rank are out of reach, so that the
    cross-rank reduction takes the second rank's), fails the gate."""
    z, cb = _vq_inputs(cuda, "normal", 4096, 16384, 8)
    skip = vd.vq_nearest(z, cb[: -vd.TILE].contiguous())
    assert not vd.gate(z, cb, *skip, eps=VQ_EPS)["ok"]
    zd, cbd = _vq_inputs(cuda, "duplicated", 4096, 16384, 8)
    hi_i, hi_d = vd.vq_nearest(zd, cbd.flip(0).contiguous())
    hi_i = (cbd.shape[0] - 1 - hi_i).to(torch.int32)
    assert not vd.gate(zd, cbd, hi_i, hi_d, eps=VQ_EPS, exact=True)["ok"]
    r = _vq_shifts()["rank"]
    zr, cbr = _vq_inputs(cuda, "duplicated", 4096, 16384, 8, seed=2, shift=r)
    far = cbr.clone()
    far[:r] += 1e4
    rk_i, rk_d = vd.vq_nearest(zr, far)
    assert bool(((rk_i >= r) & (rk_i < 2 * r)).any())  # the later rank's copies won
    assert not vd.gate(zr, cbr, rk_i, rk_d, eps=VQ_EPS, exact=True)["ok"]


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
    "12/4 P7 (odd P: tables read 4 bytes at a time)": ([200, 333, 64], 640, 12, 4, 7),
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


# The edges of the pipelined bf16 kernels (forward, dq, dk/dv, and the v1
# dk/dv, which is the dk/dv kernel with each q head rounded before the group
# sum): segments of 1 row and around 64 and 128 rows (the q and kv tiles,
# and the 128-row q tile a forward CTA takes when it holds one head), S and
# Sk not multiples of 128, and every head split the kernels choose (a CTA
# takes 4, 3 or 2 q heads of a group, or one head; at 8/1 the plain dq takes
# 2 heads a CTA and the rope dq 4, and dk/dv walks 8 heads with 4 warp
# groups: v1 in two chunks of 4 heads, each folded into a running sum).
# The f32 kinds ("plain f32", "rope P30 f32") hold the pipelined f32 forward
# and dk/dv at the same edges: their 64-row q and kv tiles, the dk/dv's
# 32-row q units, 4, 3, 2 or 1 q heads a forward CTA and as many warp groups
# a dk/dv CTA, and their swizzled tiles.
EDGE_LENGTHS = [1, 63, 64, 65, 127, 128, 129, 1, 200]  # 778 rows, then pad
EDGE_HEADS = {"MHA 4/4": (4, 4), "4/2": (4, 2), "12/4": (12, 4), "16/4": (16, 4),
              "8/1": (8, 1)}


EDGE_KINDS = ["plain", "rope P30", "v1", "plain f32", "rope P30 f32"]


def _edge_dtype(kind):
    """The kind without its dtype suffix, and the dtype (bf16 unless " f32")."""
    if kind.endswith(" f32"):
        return kind.removesuffix(" f32"), torch.float32
    return kind, torch.bfloat16


def _check_v1(dev, dtype, seg, hq, hkv, seed):
    """The three v1 kernels against their plain versions, one launch each;
    the kernel's group-summed dk/dv against the plain version's."""
    from titok_tpu_torch.ops import flash_attention as f1

    S = seg.shape[0]
    q, k, v = _inputs(dev, dtype, S, hq, hkv, seed=seed)
    dout = torch.randn(S, hq, 64, generator=torch.Generator(device=dev).manual_seed(seed + 1),
                       device=dev).to(dtype)
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


@pytest.mark.parametrize("kind", EDGE_KINDS)
@pytest.mark.parametrize("heads", list(EDGE_HEADS))
def test_tile_edges_match_plain(cuda, heads, kind):
    hq, hkv = EDGE_HEADS[heads]
    kind, dtype = _edge_dtype(kind)
    seg = _segments(EDGE_LENGTHS, 809).to(cuda)
    if kind == "v1":
        _check_v1(cuda, dtype, seg, hq, hkv, seed=11)
    elif kind == "rope P30":
        q, k, v = _inputs(cuda, dtype, 809, hq, hkv, seed=11)
        cos, sin = _rope_tables(cuda, 809, 30, 12)
        dout = torch.randn(809, hq, 64, generator=torch.Generator(device=cuda).manual_seed(13),
                           device=cuda).to(dtype)
        _check_rope(cuda, dtype, q, k, v, seg, cos, sin, dout)
    else:
        q, k, v = _inputs(cuda, dtype, 809, hq, hkv, seed=11)
        out, lse = fa._fwd(q, k, v, seg)
        _assert_close(out, lse, *fa.flash_segment_attention_mh_reference(q, k, v, seg), dtype)
        _check_bwd(cuda, dtype, seg, hq, hkv)


@pytest.mark.parametrize("kind", ["plain", "rope P30", "plain f32", "rope P30 f32"])
@pytest.mark.parametrize("heads", ["MHA 4/4", "16/4"])
def test_tile_edges_separate_k_ids_and_tables(cuda, heads, kind):
    """Sk != S, neither a multiple of 128, k's own ids (and tables)."""
    hq, hkv = EDGE_HEADS[heads]
    kind, dtype = _edge_dtype(kind)
    rope = kind == "rope P30"
    seg_q = _segments([1, 64, 129, 100], 300).to(cuda)
    seg_k = _segments([63, 65, 128, 130, 1], 461).to(cuda)
    q, _, _ = _inputs(cuda, dtype, 300, hq, hkv, seed=21)
    _, k, v = _inputs(cuda, dtype, 461, hq, hkv, seed=22)
    if rope:
        cos, sin = _rope_tables(cuda, 300, 30, 23)
        k_cos, k_sin = _rope_tables(cuda, 461, 30, 24)
        dout = torch.randn(300, hq, 64, generator=torch.Generator(device=cuda).manual_seed(25),
                           device=cuda).to(dtype)
        _check_rope(cuda, dtype, q, k, v, seg_q, cos, sin, dout, seg_k, k_cos, k_sin)
    else:
        out, lse = fa._fwd(q, k, v, seg_q, k_segment_ids=seg_k)
        _assert_close(out, lse, *fa.flash_segment_attention_mh_reference(
            q, k, v, seg_q, k_segment_ids=seg_k), dtype)
        _check_bwd(cuda, dtype, seg_q, hq, hkv, Sk=461, k_seg=seg_k)


@pytest.mark.parametrize("kind", EDGE_KINDS)
@pytest.mark.parametrize("heads", ["4/2", "12/4", "16/4", "8/1"])
def test_dkv_two_launches_give_identical_bits(cuda, heads, kind):
    """The dk/dv kernel sums its warp groups' partial dk/dv in a fixed order
    (no atomics), and each dq element is one CTA's sum over its kv tiles in
    ascending order: two launches on the same inputs give the same bits (v1:
    its dq and its dk/dv, which adds the rounded heads in head order; f32:
    the pipelined dk/dv's warp groups, the dq of one CTA per q tile)."""
    hq, hkv = EDGE_HEADS[heads]
    kind, dtype = _edge_dtype(kind)
    seg = _segments([513, 1040, 416, 832, 608], 4096).to(cuda)
    q, k, v = _inputs(cuda, dtype, 4096, hq, hkv, seed=31)
    dout = torch.randn(4096, hq, 64, generator=torch.Generator(device=cuda).manual_seed(32),
                       device=cuda).to(dtype)
    if kind == "v1":
        from titok_tpu_torch.ops import flash_attention as f1

        out, lse = f1._fwd(q, k, v, seg)
        runs = [f1._bwd(q, k, v, seg, out, lse, dout) for _ in range(2)]
    elif kind == "rope P30":
        cos, sin = _rope_tables(cuda, 4096, 30, 33)
        out, lse = fa._rope_fwd(q, k, v, seg, cos, sin)
        runs = [fa._rope_bwd(q, k, v, seg, cos, sin, out, lse, dout) for _ in range(2)]
    else:
        out, lse = fa._fwd(q, k, v, seg)
        runs = [fa._bwd(q, k, v, seg, out, lse, dout) for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


# The f32 dq template (`bwd_dq_f32_pipe`: the dq of rows 2 and 4 and the v1
# f32 dq): every head split it takes (4 q heads a CTA at 16/4 and 8/1, 8
# rows a thread; 3 at 12/4; one at 4/2 and 1/1, each kv tile in two passes
# of 32 columns), ragged S with pad rows, plain and rope with P 30, 16
# (pairs passed through) and 7 (odd P), and k's own ids (Sk != S). The
# backward is gated whole (dq, dk, dv) under the f32 limits (BWD_TOL).
F32_DQ_HEADS = {"16/4": (16, 4), "12/4": (12, 4), "4/2": (4, 2), "8/1": (8, 1), "1/1": (1, 1)}
F32_DQ_KINDS = {"plain": None, "rope P30": 30, "rope P16": 16, "rope P7": 7}


def _check_f32(dev, kind, seg, hq, hkv, seed, Sk=None, k_seg=None):
    """The f32 backward of ``kind`` (from the kernel forward's out and lse)
    against its plain version, one launch of each kernel."""
    P = F32_DQ_KINDS[kind]
    if P is None:
        _check_bwd(dev, torch.float32, seg, hq, hkv, Sk=Sk, k_seg=k_seg)
        return
    S = seg.shape[0]
    q, _, _ = _inputs(dev, torch.float32, S, hq, hkv, seed=seed)
    _, k, v = _inputs(dev, torch.float32, S if Sk is None else Sk, hq, hkv, seed=seed + 1)
    cos, sin = _rope_tables(dev, S, P, seed + 2)
    k_cos, k_sin = (None, None) if Sk is None else _rope_tables(dev, Sk, P, seed + 3)
    dout = torch.randn(S, hq, 64, generator=torch.Generator(device=dev).manual_seed(seed + 4),
                       device=dev)
    _check_rope(dev, torch.float32, q, k, v, seg, cos, sin, dout, k_seg, k_cos, k_sin)


@pytest.mark.parametrize("kind", list(F32_DQ_KINDS))
@pytest.mark.parametrize("heads", list(F32_DQ_HEADS))
def test_f32_dq_matches_plain(cuda, heads, kind):
    hq, hkv = F32_DQ_HEADS[heads]
    seg = _segments([1, 2, 63, 64, 65, 127, 300, 5, 129], 821).to(cuda)  # 756 rows, then pad
    _check_f32(cuda, kind, seg, hq, hkv, seed=51)


@pytest.mark.parametrize("kind", ["plain", "rope P30"])
@pytest.mark.parametrize("heads", list(F32_DQ_HEADS))
def test_f32_dq_separate_k_ids(cuda, heads, kind):
    hq, hkv = F32_DQ_HEADS[heads]
    seg_q = _segments([1, 64, 129, 100], 300).to(cuda)
    seg_k = _segments([63, 65, 128, 130, 1], 461).to(cuda)
    _check_f32(cuda, kind, seg_q, hq, hkv, seed=61, Sk=461, k_seg=seg_k)


@pytest.mark.parametrize("kind", ["plain", "rope P30"])
def test_f32_dq_same_bits_across_launches_and_head_splits(cuda, kind):
    """Each f32 dq element is one fmaf chain over its q tile's kv rows in
    ascending order, the q tile 64 rows whatever the split: two launches
    give the same bits, and a (row, head) gets the same bits whatever head
    split its group size picks (16/4: 4 heads a CTA, 8 rows a thread; 3/1:
    3 heads, 4 rows; 2/1 and 1/1: one head, two passes of 32 kv columns).
    The smaller groups are q heads 0.. of kv head 0, with the 16/4
    forward's out and lse."""
    S = 4096
    seg = _segments([513, 1040, 416, 832, 608], S).to(cuda)
    q, k, v = _inputs(cuda, torch.float32, S, 16, 4, seed=71)
    dout = torch.randn(S, 16, 64, generator=torch.Generator(device=cuda).manual_seed(72),
                       device=cuda)
    tabs = _rope_tables(cuda, S, 30, 73) if kind == "rope P30" else None
    out, lse = fa._fwd(q, k, v, seg) if tabs is None else fa._rope_fwd(q, k, v, seg, *tabs)

    def dq_at(hq, hkv):
        qh, oh, dh = (x[:, :hq].contiguous() for x in (q, out, dout))
        kh, vh = (x[:, :hkv].contiguous() for x in (k, v))
        lh = lse[:, :hq].contiguous()
        if tabs is None:
            return fa._bwd(qh, kh, vh, seg, oh, lh, dh)[0]
        return fa._rope_bwd(qh, kh, vh, seg, *tabs, oh, lh, dh)[0]

    full = [dq_at(16, 4) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(full[0], full[1])
    for hq in (3, 2, 1):
        assert torch.equal(dq_at(hq, 1), full[0][:, :hq]), hq


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


# the v1 kernels (attn_impl: flash_v1): forward, dq and group-summed dk/dv,
# Sq == Sk, each CTA searching the one id vector for its interval. Forward:
# the row 1 limits and rms(out - plain) <= nrel * rms(plain) (the plain version rounds
# p against the same running max per 64-row kv tile as the kernel, so in
# bf16 they differ only where the sum order moves an output to its
# neighbouring bf16 value); grads: the backward limits above.
V1_CASES = {
    "bench 10x576 4/2": ([576] * 10, 6144, 4, 2),
    "base_vq layout 12/4": ([513, 1040, 416, 832, 608], 4096, 12, 4),
    "base_vq layout 8/1": ([513, 1040, 416, 832, 608], 4096, 8, 1),
    "ragged 1..1892, pad": ([1, 2, 63, 64, 65, 127, 1892, 700, 5, 333], 3299, 4, 2),
    "one row": ([1], 1, 4, 2),
    "all pad": ([], 100, 4, 2),
    "MHA 4/4": ([50, 70], 130, 4, 4),
    # one head a group (the bf16 forward's 128-row q tiles): 64-aligned, and
    # segments that start mid-tile, the first tile's lo rounded to row 0, a
    # last tile of S that is part pad
    "bench 10x576 4/4": ([576] * 10, 6144, 4, 4),
    "mid-tile 4/4": ([37, 100, 64, 27, 600, 1, 63, 90], 1030, 4, 4),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(V1_CASES))
def test_v1_kernels_match_plain(cuda, dtype, case):
    lengths, S, hq, hkv = V1_CASES[case]
    _check_v1(cuda, dtype, _segments(lengths, S).to(cuda), hq, hkv, seed=3)


def test_v1_wrappers_raise_on_cuda_instead_of_falling_back(cuda):
    from titok_tpu_torch.ops import flash_attention as f1

    seg = _segments([128], 128).to(cuda)
    q, k, v = _inputs(cuda, torch.float32, 128, 4, 2)
    with pytest.raises(ValueError, match="Sq == Sk"):
        f1._fwd(q, k[:100].contiguous(), v[:100].contiguous(), seg)
    with pytest.raises(ValueError, match="int32"):
        f1._fwd(q, k, v, seg.long())
    out, lse = f1._fwd(q, k, v, seg)
    with pytest.raises(ValueError, match="lse is"):  # the backward checks what it is given
        f1._bwd(q, k, v, seg, out, lse[:, :2].contiguous(), torch.ones_like(q))


# the bf16 v1 forward and dq are the row 1 forward and the row 2 dq
# templates: the dq the same function on one id vector, so the same bits
# everywhere; the forward with its kv tiles aligned to row 0, so the same
# bits where every segment starts at a multiple of 64
V1_ALIGNED = {
    "bench 10x576 4/2": ([576] * 10, 6144, 4, 2),
    "64-aligned 12/4": ([64, 128, 640, 192, 1024], 2112, 12, 4),
    "64-aligned 4/4": ([64, 128, 640, 192, 1024], 2112, 4, 4),
    "64-aligned 8/1": ([64, 128, 640, 192, 1024], 2112, 8, 1),
}


@pytest.mark.parametrize("case", list(V1_ALIGNED) + ["ragged 1..1892, pad", "mid-tile 4/4"])
def test_v1_bf16_dq_is_the_row2_dq_and_forward_row1_where_aligned(cuda, case):
    from titok_tpu_torch.ops import flash_attention as f1

    lengths, S, hq, hkv = V1_ALIGNED[case] if case in V1_ALIGNED else V1_CASES[case]
    seg = _segments(lengths, S).to(cuda)
    q, k, v = _inputs(cuda, torch.bfloat16, S, hq, hkv, seed=41)
    dout = torch.randn(S, hq, 64, generator=torch.Generator(device=cuda).manual_seed(42),
                       device=cuda).to(torch.bfloat16)
    out, lse = f1._fwd(q, k, v, seg)
    m_out, m_lse = fa._fwd(q, k, v, seg)
    if case in V1_ALIGNED:
        assert torch.equal(out, m_out) and torch.equal(lse, m_lse)
    else:  # p rounds against other maxima: the row 1 limits
        _assert_close(out, lse, m_out, m_lse, torch.bfloat16)
    assert torch.equal(f1._bwd(q, k, v, seg, out, lse, dout)[0],
                       fa._bwd(q, k, v, seg, out, lse, dout)[0])


@pytest.mark.parametrize("case", list(V1_ALIGNED) + ["ragged 1..1892, pad", "mid-tile 4/4"])
def test_v1_f32_dq_is_the_row2_dq(cuda, case):
    """The v1 f32 dq is the row 2 f32 dq on one id vector: the same bits."""
    from titok_tpu_torch.ops import flash_attention as f1

    lengths, S, hq, hkv = V1_ALIGNED[case] if case in V1_ALIGNED else V1_CASES[case]
    seg = _segments(lengths, S).to(cuda)
    q, k, v = _inputs(cuda, torch.float32, S, hq, hkv, seed=45)
    dout = torch.randn(S, hq, 64, generator=torch.Generator(device=cuda).manual_seed(46),
                       device=cuda)
    out, lse = f1._fwd(q, k, v, seg)
    before = (fa.launches["v1_bwd_dq_f32"], fa.launches["bwd_dq_f32"])
    got = f1._bwd(q, k, v, seg, out, lse, dout)[0]
    want = fa._bwd(q, k, v, seg, out, lse, dout)[0]
    torch.cuda.synchronize()
    assert (fa.launches["v1_bwd_dq_f32"], fa.launches["bwd_dq_f32"]) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", list(V1_ALIGNED) + ["ragged 1..1892, pad", "mid-tile 4/4"])
def test_v1_f32_forward_and_dkv_are_rows_1_2(cuda, case):
    """In f32 v1 rounds nothing: its forward is the row 1 f32 forward and its
    dk/dv the row 2 f32 dk/dv (summed over each group in the kernel) on one
    id vector, the same bits on every layout, aligned or not."""
    from titok_tpu_torch.ops import flash_attention as f1

    lengths, S, hq, hkv = V1_ALIGNED[case] if case in V1_ALIGNED else V1_CASES[case]
    seg = _segments(lengths, S).to(cuda)
    q, k, v = _inputs(cuda, torch.float32, S, hq, hkv, seed=47)
    dout = torch.randn(S, hq, 64, generator=torch.Generator(device=cuda).manual_seed(48),
                       device=cuda)
    names = ("v1_f32", "f32", "v1_bwd_dkv_f32", "bwd_dkv_f32")
    before = {n: fa.launches[n] for n in names}
    out, lse = f1._fwd(q, k, v, seg)
    m_out, m_lse = fa._fwd(q, k, v, seg)
    got = f1._bwd(q, k, v, seg, out, lse, dout)
    want = fa._bwd(q, k, v, seg, out, lse, dout)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in names} == {n: 1 for n in names}
    assert torch.equal(out, m_out) and torch.equal(lse, m_lse)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and torch.equal(a, b), name


def test_v1_wrappers_compute_no_tile_intervals(cuda, monkeypatch):
    """No v1 kernel reads tile intervals, in either dtype: the entries take
    none, and the forward and the backward (through autograd, as the model
    calls them) run with the reductions that computed them (``amin``,
    ``amax``) made to raise, one launch of each kernel."""
    import inspect

    from titok_tpu_torch.ops import flash_attention as f1

    for fn in (f1.launch_fwd, f1.launch_bwd_dq, f1.launch_bwd_dkv):
        assert not {"qmm", "kmm"} & set(inspect.signature(fn).parameters), fn.__name__
    assert not any(hasattr(f1, n) for n in ("TILES", "tile_minmax", "_intervals"))

    def no_intervals(*a, **k):
        raise AssertionError("a tile interval was computed")

    monkeypatch.setattr(torch.Tensor, "amin", no_intervals)
    monkeypatch.setattr(torch.Tensor, "amax", no_intervals)
    seg = _segments([100, 200, 28], 400).to(cuda)
    for dtype, key in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v = (x.requires_grad_() for x in _inputs(cuda, dtype, 400, 4, 2, seed=43))
        fa.reset_launches()
        out = f1.flash_segment_attention(q, k, v, seg)
        grads = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
        torch.cuda.synchronize()
        assert fa.launches == {**{n: 0 for n in fa.launches}, f"v1_{key}": 1,
                               f"v1_bwd_dq_{key}": 1, f"v1_bwd_dkv_{key}": 1}
        assert all(g.shape == x.shape and bool(torch.isfinite(g.float()).all())
                   for g, x in zip(grads, (q, k, v)))
        mm = torch.zeros((7, 2), dtype=torch.int32, device=cuda)
        with pytest.raises(TypeError):  # an entry given tile intervals refuses them
            f1.launch_fwd(q.detach(), k.detach(), v.detach(), seg, mm, mm, 0.125)


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


def test_per_sample_mean_same_bits_twice(cuda):
    """The loss's per-sample means over a buffer the size of the large
    stacked discriminator pass (33,008 rows: 4 copies of 8,252): two calls
    on the same inputs give the same bits (each segment's sum adds in a
    fixed order), within float32 rounding of a float64 sum."""
    from titok_tpu_torch.losses.loss_module import _per_sample_mean

    seg = _stacked_ids(8252, [500] * 16, 4).to(cuda)
    n = int(seg.max()) + 1
    g = torch.Generator(device=cuda).manual_seed(81)
    vals = torch.randn(seg.shape[0], generator=g, device=cuda) * 100 + 10
    mask = torch.rand(seg.shape[0], generator=g, device=cuda) < 0.9
    a = _per_sample_mean(vals, seg, mask, n)
    b = _per_sample_mean(vals, seg, mask, n)
    torch.cuda.synchronize()
    assert seg.shape[0] == 33008 and a.shape == (n - 1,) and torch.equal(a, b)
    w = mask.double()
    zeros = torch.zeros(n, dtype=torch.float64, device=cuda)
    sums = zeros.index_add(0, seg.long(), vals.double() * w)
    cnts = zeros.index_add(0, seg.long(), w)
    torch.testing.assert_close(a.double(), (sums / cnts.clamp(min=1.0))[1:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [13, 14, 15, 16])
def test_lpips_and_crop_resize_card_match_cpu(cuda, tmp_path, seed):
    """The perceptual loss's modules on the card against the same modules
    and weights on the CPU, fp32 with TF32 off (the fixture): ``crop_resize``
    of 4 frames at 40x48 to 64² (scale 1, fractional up- and down-scales),
    then LPIPS and Gram of them against a perturbed copy, and the gradient
    with respect to that copy. Limits: the sums run in another order on each
    side (cuDNN's and oneDNN's convolutions, cuBLAS's and MKL's matmuls).
    The gradient is held by its norm, not entry by entry: LPIPS's backward
    through ReLU and max pool is discontinuous, so features that differ in
    their last bits route a few units' gradients differently, and each
    such unit moves the gradient over its whole receptive field; a clamped
    patch of equal pixels gives equal features, whose max-pool ties each
    library breaks its own way. The four seeds include such cases."""
    import warnings

    from titok_tpu_torch.losses.lpips import LPIPS, load_lpips_params
    from titok_tpu_torch.ops.frames import crop_resize

    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.uniform(-1, 1, (4, 40, 48, 3)).astype(np.float32))
    plan = {"scale": torch.tensor([[1.0, 1.0], [1.37, 1.6], [0.8, 0.8], [2.0, 2.0]]),
            "translation": torch.tensor([[-3.0, -5.0], [-2.3, -0.75], [-1.5, 0.0], [-10.5, -7.25]])}
    tgt = crop_resize(frames, plan, 64)
    tgt_g = crop_resize(frames.to(cuda), {k: v.to(cuda) for k, v in plan.items()}, 64)
    torch.testing.assert_close(tgt_g.cpu(), tgt, atol=1e-5, rtol=0)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        sd = {k: torch.from_numpy(v)
              for k, v in load_lpips_params(str(tmp_path / "missing.npz")).items()}
    rec = torch.clamp(tgt + 0.2 * torch.from_numpy(rng.standard_normal(tgt.shape)).float(), -1, 1)
    out = {}
    for dev in ("cpu", cuda):
        m = LPIPS().to(dev)
        m.load_state_dict(sd)
        x = rec.to(dev).requires_grad_()
        lp, gram = m(x, tgt.to(dev))
        (g,) = torch.autograd.grad(lp.sum() + gram.sum(), x)
        out[str(dev)] = [t.detach().cpu() for t in (lp, gram, g)]
    (lp, gram, g), (lp_g, gram_g, g_g) = out["cpu"], out[str(cuda)]
    assert bool((lp > 0).all()) and bool((gram > 0).all())
    torch.testing.assert_close(lp_g, lp, rtol=1e-4, atol=0)
    torch.testing.assert_close(gram_g, gram, rtol=1e-4, atol=0)
    # a wrong backward is off by the order of the gradient itself
    assert float((g_g - g).norm()) <= 1e-2 * float(g.norm())
