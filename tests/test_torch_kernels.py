"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and the CUDA toolkit; without one it skips
(the fixture decides, never the import). This file imports no JAX, so it
runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from titok_tpu_torch.ops import flash_attention_mh as fa

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
