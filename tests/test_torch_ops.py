"""The port's host code and elementwise ops against the JAX package, on the
CPU: patchify, decode_rows, RoPE tables and rotation, RMSNorm, and the
packer (every PackedBatch buffer equal, bit for bit)."""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from titok_tpu.data import packing as jpack  # noqa: E402
from titok_tpu.models import rope as jrope  # noqa: E402
from titok_tpu.ops.rmsnorm import rms_norm as j_rms_norm  # noqa: E402
from titok_tpu_torch.data import packing as tpack  # noqa: E402
from titok_tpu_torch.models import rope as trope  # noqa: E402
from titok_tpu_torch.ops import patchify as tpatch  # noqa: E402
from titok_tpu_torch.ops.rmsnorm import RMSNorm, rms_norm  # noqa: E402

# titok_tpu.ops re-exports the function patchify, which shadows the module
jpatch = importlib.import_module("titok_tpu.ops.patchify")

PATCH = [2, 4, 4]


def test_decode_rows_uint8_bit_exact(rng):
    rows = rng.integers(0, 256, (64, 96), dtype=np.uint8)
    rows[0, :] = np.arange(96, dtype=np.uint8)
    rows[1, :] = np.arange(160, 256, dtype=np.uint8)
    want = jpatch.decode_rows(rows)
    want_dev = np.asarray(jpatch.decode_rows(jnp.asarray(rows)))
    np.testing.assert_array_equal(tpatch.decode_rows(rows), want)
    np.testing.assert_array_equal(want_dev, want)
    got_t = tpatch.decode_rows(torch.from_numpy(rows))
    assert got_t.dtype == torch.float32
    np.testing.assert_array_equal(got_t.numpy(), want)
    # float rows only cast
    f = rng.uniform(-1, 1, (8, 96)).astype(np.float32)
    assert tpatch.decode_rows(torch.from_numpy(f), torch.bfloat16).dtype == torch.bfloat16
    np.testing.assert_array_equal(tpatch.decode_rows(f), f)


@pytest.mark.parametrize("dims", [(3, 4, 8, 8), (1, 8, 12, 16)])
def test_patchify_roundtrip_matches_jax(rng, dims):
    vid = rng.uniform(-1, 1, dims).astype(np.float32)
    rows = tpatch.patchify(vid, PATCH)
    np.testing.assert_array_equal(rows, jpatch.patchify(vid, PATCH))
    grid = [d // p for d, p in zip(dims[1:], PATCH)]
    back = tpatch.unpatchify(rows, grid, PATCH, dims[0])
    np.testing.assert_array_equal(back, jpatch.unpatchify(rows, grid, PATCH, dims[0]))
    np.testing.assert_array_equal(back, vid)


def test_patchify_thwc_u8_matches_jax(rng):
    vid = rng.integers(0, 256, (4, 8, 12, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tpatch.patchify_thwc_u8(vid, PATCH),
                                  jpatch.patchify_thwc_u8(vid, PATCH))


def test_rope_tables_match_jax():
    grid, tc = np.array([2, 3, 4]), 5
    pos = trope.positions_for_sample(grid, tc)
    np.testing.assert_array_equal(pos, jrope.positions_for_sample(grid, tc))
    np.testing.assert_array_equal(trope.rope_inv_freqs(64, 3), jrope.rope_inv_freqs(64, 3))
    for a, b in zip(trope.rope_cos_sin(pos, 64, 3), jrope.rope_cos_sin(pos, 64, 3)):
        assert a.dtype == np.float32 and a.shape == (len(pos), 30)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("heads", [4, 2])
def test_apply_rotary_emb_matches_jax(rng, heads):
    L, D = 40, 64
    x = rng.normal(size=(L, heads, D)).astype(np.float32)
    pos = rng.uniform(0, 50, (L, 3))
    cos, sin = jrope.rope_cos_sin(pos, D, 3)
    want = np.asarray(jrope.apply_rotary_emb(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin)))
    got = trope.apply_rotary_emb(torch.from_numpy(x), torch.from_numpy(cos),
                                 torch.from_numpy(sin)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # dims past the 30 rotated pairs pass through untouched
    np.testing.assert_array_equal(got[..., 60:], x[..., 60:])


def test_rms_norm_matches_jax(rng):
    x = (rng.normal(size=(33, 256)) * 3).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (256,)).astype(np.float32)
    want = np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(w)))
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    norm = RMSNorm(256)
    assert norm.weight.dtype == torch.float32
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert norm(xb).dtype == torch.bfloat16


def _mixed_clips(rng):
    return [
        rng.uniform(-1, 1, (3, 4, 8, 8)).astype(np.float32),
        rng.integers(0, 256, (2, 12, 8, 3), dtype=np.uint8),
        rng.uniform(-1, 1, (3, 2, 16, 4)).astype(np.float32),
        rng.integers(0, 256, (4, 4, 8, 3), dtype=np.uint8),
    ]


def test_pack_samples_buffers_equal_jax(rng):
    clips = _mixed_clips(rng)
    tcs = [3, 1, 7, 2]
    kw = dict(seq_len=160, max_samples=6, patch_size=PATCH, head_dim=64,
              fps=[3.0, 4.0, 5.0, 3.5])
    got = tpack.pack_samples(clips, tcs, **kw)
    want = jpack.pack_samples(clips, tcs, **kw)
    for field in ("patches", "segment_ids", "token_mask", "rope_cos", "rope_sin",
                  "token_counts", "grid_sizes", "grids", "sample_valid", "fps"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    # pad rows: segment 0 at the end, identity rotation
    pad = got.segment_ids == 0
    assert pad[-1] and not pad[0]
    assert np.all(got.rope_cos[pad] == 1.0) and np.all(got.rope_sin[pad] == 0.0)


def test_pack_grid_only_and_unpack_match_jax(rng):
    kw = dict(seq_len=96, max_samples=4, patch_size=PATCH)
    dims = [(4, 8, 8), (2, 8, 12)]
    got = tpack.pack_samples([tpack.GridOnly(d) for d in dims], [2, 5], **kw)
    want = jpack.pack_samples([jpack.GridOnly(d) for d in dims], [2, 5], **kw)
    for field in ("patches", "segment_ids", "token_mask", "rope_cos", "rope_sin"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert not got.patches.any()
    assert tpack.video_dims(tpack.GridOnly(dims[0])) == dims[0]

    recon = rng.normal(size=(96, 96)).astype(np.float32)
    idx = rng.integers(0, 4375, (96,)).astype(np.int32)
    for a, b in zip(tpack.unpack_videos(recon, got, PATCH), jpack.unpack_videos(recon, want, PATCH)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tpack.unpack_indices(idx, got), jpack.unpack_indices(idx, want)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tpack.sample_offsets(got.token_counts, got.grid_sizes),
        jpack.sample_offsets(want.token_counts, want.grid_sizes))
    assert tpack.max_samples_for(4096, (8, 128, 128), (4, 8, 8)) == \
        jpack.max_samples_for(4096, (8, 128, 128), (4, 8, 8))


def test_to_device_tensors(rng):
    batch = tpack.pack_samples(_mixed_clips(rng)[:2], [3, 1], seq_len=80, max_samples=3,
                               patch_size=PATCH)
    t = tpack.to_device(batch, "cpu")
    assert set(t) == set(batch.device_arrays())
    assert t["segment_ids"].dtype == torch.int32 and t["token_mask"].dtype == torch.bool
    assert t["patches"].dtype == torch.float32 and t["patches"].is_contiguous()
    np.testing.assert_array_equal(t["rope_cos"].numpy(), batch.rope_cos)
