"""The A/B tool of the segment-attention kernels (``titok_tpu_torch/tools/
compare_attn.py``) on the CPU: its shapes and its bound, which must be the
one ``chip_smoke.py`` reports for the same kernel, so that the two tools'
shares of bound can be set side by side, and the tile intervals it gives
older builds whose v1 entries take them. Timing needs a card and is not
tested here."""

import numpy as np
import pytest

import chip_smoke
from titok_tpu_torch.tools import compare_attn as ca


@pytest.mark.parametrize("shape", list(ca.SHAPES))
@pytest.mark.parametrize("kind", list(ca.KINDS) + [f"{k} f32" for k in ca.F32_KINDS])
def test_bound_matches_chip_smoke(shape, kind):
    """Each kind's bound in bf16 and, for the kinds timed in f32 ("... f32"),
    in f32: 4-byte elements and the fp32 FMA peak."""
    seg, hq, hkv = ca.SHAPES[shape]
    S, D = len(seg), 64
    dtype = "f32" if kind.endswith(" f32") else "bf16"
    kind = kind.removesuffix(" f32")
    got, by = ca.bound_ms(kind, seg, hq, hkv, dtype)
    base = kind.removeprefix("rope_").removeprefix("v1_")  # v1: the same work as rows 1-2
    if kind.startswith("rope_"):
        want, want_by, _, _ = chip_smoke.rope_bound_ms(seg, seg, hq, hkv, D, dtype, base,
                                                       ca.P, False)
    elif base == "fwd":
        want, want_by, _, _ = chip_smoke.attn_bound_ms(seg, S, hq, hkv, D, dtype)
    else:
        want, want_by, _, _ = chip_smoke.bwd_bound_ms(seg, S, S, hq, hkv, D, dtype,
                                                      3 if base == "dq" else 4, (base,))
    assert got == pytest.approx(want, rel=1e-12) and by == want_by
    if dtype == "f32":  # the FMA peak bounds every f32 kind at these shapes
        assert by == "operations"


def test_shapes_are_the_three_layouts():
    bench, base, large = (ca.SHAPES[k] for k in ("bench 4/2", "base_vq 12/4", "large 16/4"))
    assert (len(bench[0]), bench[1:]) == (6144, (4, 2))
    assert np.array_equal(bench[0], chip_smoke.segments([576] * 10, 6144))
    assert base[1:] == (12, 4) and large[1:] == (16, 4)
    for seg in (base[0], large[0]):
        assert np.array_equal(seg, chip_smoke.BASE_SEG)


@pytest.mark.parametrize("S", ca.VQ_SHAPES)
def test_vq_bound_matches_chip_smoke(S):
    """The VQ kind's bound at base_vq's shape and the two smaller S is
    ``chip_smoke.py``'s: the FMA peak bounds it."""
    got, by = ca.vq_bound_ms(S)
    want, want_by, flops, _ = chip_smoke.vq_bound_ms(S, ca.VQ_N, ca.VQ_D)
    assert got == pytest.approx(want, rel=1e-12) and by == want_by == "operations"
    assert flops == 2.0 * S * 16384 * 8


def test_vq_old_build_splits():
    """The code ranges a two-launch build's wrapper chose: 32 at every
    base_vq shape, so 8, 7 and 3 row blocks of 512 give 256, 224 and 96
    CTAs."""
    assert [ca._old_vq_splits(S, ca.VQ_N) for S in ca.VQ_SHAPES] == [32, 32, 32]
    assert ca._old_vq_splits(100, 300) == 1


def test_tile_minmax_pads_the_last_tile():
    """The tile intervals that builds whose v1 entries take them were given
    (the tool's copy of their wrapper's ``tile_minmax``): the last tile
    completed with ``TAIL_ID``, pad (0) remapped above every real id."""
    import torch

    from titok_tpu_torch.ops import flash_attention_mh as fa

    seg = torch.tensor([1, 1, 2, 2, 2, 0, 0], dtype=torch.int32)
    got = ca.tile_minmax(seg, 4)
    assert got.dtype == torch.int32 and got.tolist() == [[1, 2], [2, ca.TAIL_ID]]
    assert ca.tile_minmax(seg, 7).tolist() == [[1, fa.PAD_ID]]
    assert ca.TAIL_ID == fa.PAD_ID + 1


@pytest.mark.parametrize("kind", ["v1_fwd", "v1_dkv"])
@pytest.mark.parametrize("err", [0.0, 3e-7, 3e-5], ids=["same", "sum order", "fault"])
def test_f32_gate_is_chip_smokes(kind, err):
    """The tool's f32 gate, which holds the f32 v1 forward's and dk/dv's
    outputs to OLD's, is ``chip_smoke.py``'s: the same verdict on the same
    outputs, which pass at fp32 sum-order noise and fail at a fault."""
    import torch

    assert ca.F32_FWD_ATOL == chip_smoke.TOL["f32"][0] == chip_smoke.TOL["f32"][2]
    assert ca.F32_BWD_GATE == chip_smoke.BWD_TOL["f32"]
    g = torch.Generator().manual_seed(3)
    want = [torch.randn(64, 2, 64, generator=g), torch.randn(64, 2, 64, generator=g)]
    if kind == "v1_fwd":
        want[1] = want[1][..., 0].contiguous()  # lse [S, H]
    got = [w + err * torch.randn(w.shape, generator=g) for w in want]
    ok, _ = ca.f32_gate(kind, got, want)
    if kind == "v1_fwd":
        want_ok, _ = chip_smoke.v1_fwd_gate(got[0], got[1], want[0], want[1], "f32")
    else:
        want_ok, _ = chip_smoke.bwd_gate(got, want, "f32")
    assert ok == want_ok == (err < 1e-6)
