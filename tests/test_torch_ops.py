"""The port's host code and elementwise ops against the JAX package, on the
CPU: patchify, decode_rows, RoPE tables and rotation, RMSNorm, and the
packer (every PackedBatch buffer equal, bit for bit)."""

import importlib
import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.reference_native import reference_native_lib  # noqa: E402, F401
from tests.torch_threads import one_torch_thread  # noqa: E402, F401
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


# The JAX packer normalizes uint8 clips with the C++ `patchify_normalize`
# (`x * (2/255) - 1`) when `libtitok_native.so` loads, and with a numpy
# fallback (`x / 255 * 2 - 1`) when it does not. The library is built at
# first use; under xdist several workers may build it into the same file at
# once, and a worker that fails to load it takes the fallback. The two
# formulas differ by 1 ulp on 111 of the 256 byte values, so rows of uint8
# clips are held to 1 ulp of [-1, 1] (2**-23) whichever path JAX took;
# float clips and every other field stay bit-exact.
_U8_ULP = 2.0 ** -23
_FIELDS = ("patches", "segment_ids", "token_mask", "rope_cos", "rope_sin",
           "token_counts", "grid_sizes", "grids", "sample_valid", "fps")


def _assert_packed_equal(got, want, clips):
    for field in _FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        if field != "patches":
            np.testing.assert_array_equal(a, b, err_msg=field)
    offs = tpack.sample_offsets(got.token_counts, got.grid_sizes)
    u8 = np.zeros(got.seq_len, bool)
    for b, clip in enumerate(clips):
        if clip.dtype == np.uint8:
            u8[offs[b] + got.token_counts[b]: offs[b + 1]] = True
    np.testing.assert_array_equal(got.patches[~u8], want.patches[~u8])
    np.testing.assert_allclose(got.patches[u8], want.patches[u8], atol=_U8_ULP, rtol=0)


def _pack_both(rng):
    clips = _mixed_clips(rng)
    tcs = [3, 1, 7, 2]
    kw = dict(seq_len=160, max_samples=6, patch_size=PATCH, head_dim=64,
              fps=[3.0, 4.0, 5.0, 3.5])
    return clips, tpack.pack_samples(clips, tcs, **kw), jpack.pack_samples(clips, tcs, **kw)


def test_pack_samples_buffers_equal_jax(rng):
    clips, got, want = _pack_both(rng)
    _assert_packed_equal(got, want, clips)
    # pad rows: segment 0 at the end, identity rotation
    pad = got.segment_ids == 0
    assert pad[-1] and not pad[0]
    assert np.all(got.rope_cos[pad] == 1.0) and np.all(got.rope_sin[pad] == 0.0)


def test_pack_samples_within_ulp_of_jax_numpy_fallback(rng, monkeypatch):
    """JAX pinned to its numpy normalize (`x/255*2-1`): the port's f32
    `x*(2/255)-1` stays within 1 ulp."""
    from titok_tpu.data import video_reader

    def unavailable(*args, **kwargs):
        raise OSError("native library not loaded")

    monkeypatch.setattr(video_reader, "patchify_normalize", unavailable)
    clips, got, want = _pack_both(rng)
    _assert_packed_equal(got, want, clips)
    vid = clips[1]
    fallback = jpatch.patchify(vid.astype(np.float32).transpose(3, 0, 1, 2) / 255 * 2 - 1, PATCH)
    np.testing.assert_allclose(tpack._video_rows(vid, PATCH), fallback, atol=_U8_ULP, rtol=0)


def test_packer_and_disc_batch_equal_jax():
    """The streaming packer and the discriminator layout, same seed: every
    array bit for bit (float clips, as the synthetic stream makes)."""
    from tests.util import tiny_config
    from titok_tpu.training.trainer import synthetic_batches as j_synthetic_batches
    from titok_tpu_torch.config import Config
    from titok_tpu_torch.training.trainer import synthetic_batches

    cfg = tiny_config()
    got = list(itertools.islice(synthetic_batches(Config(cfg.to_dict()), seed=11), 4))
    want = list(itertools.islice(j_synthetic_batches(cfg, seed=11), 4))
    stream = [np.random.default_rng(2).uniform(-1, 1, (3, 2 * (i % 2 + 1), 8, 4 * (i % 3 + 1)))
              .astype(np.float32) for i in range(20)]
    kw = dict(seq_len=64, token_range=(1, 8), patch_size=PATCH, min_grid=(2, 8, 4))
    got += list(tpack.Packer(**kw, rng=np.random.default_rng(5))(
        {"video": v, "fps": 3.0} for v in stream))
    want += list(jpack.Packer(**kw, rng=np.random.default_rng(5))(
        {"video": v, "fps": 3.0} for v in stream))
    assert len(got) == len(want) == 7  # 4 + 3: the partial final batch is dropped
    for g, w in zip(got, want):
        for field in _FIELDS:
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field), err_msg=field)
        gd, wd = tpack.build_disc_batch(g, 4), jpack.build_disc_batch(w, 4)
        for field, val in wd.device_arrays().items():
            a = gd.device_arrays()[field]
            assert a.dtype == val.dtype and a.shape == val.shape, field
            np.testing.assert_array_equal(a, val, err_msg=field)
    t = tpack.to_device(tpack.build_disc_batch(got[0], 4), "cpu")
    assert t["segment_ids"].shape[0] == got[0].seq_len + 4 * got[0].sample_valid.shape[0]
    assert t["is_patch"].dtype == torch.bool


def test_bf16_training_stream_equals_jax():
    """At 'bf16-mixed' the JAX packer stores the rows in bf16; the port
    rounds them to bf16 and keeps them in f32: the same values."""
    from tests.util import tiny_config
    from titok_tpu.training.trainer import synthetic_batches as j_synthetic_batches
    from titok_tpu_torch.config import Config
    from titok_tpu_torch.training.trainer import synthetic_batches

    cfg = tiny_config(**{"training.main.precision": "bf16-mixed"})
    got = list(itertools.islice(synthetic_batches(Config(cfg.to_dict()), seed=4), 2))
    want = list(itertools.islice(j_synthetic_batches(cfg, seed=4), 2))
    exact = list(itertools.islice(synthetic_batches(Config(tiny_config().to_dict()), seed=4), 2))
    for g, w, x in zip(got, want, exact):
        assert g.patches.dtype == np.float32 and w.patches.dtype != np.float32
        np.testing.assert_array_equal(g.patches, w.patches.astype(np.float32))
        np.testing.assert_array_equal(g.segment_ids, w.segment_ids)
        # rounded, not copied: within half a bf16 ulp of the f32 rows of '32'
        assert not np.array_equal(g.patches, x.patches)
        np.testing.assert_allclose(g.patches, x.patches, atol=0, rtol=2.0 ** -8)


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
