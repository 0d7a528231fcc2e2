"""The port's FSQ against the JAX package's, on the CPU.

The rounding and the index codec are bit-exact. ``bound`` is held to 1e-6:
XLA's CPU ``tanh`` is a rational approximation that differs from
``torch.tanh`` (the reference's op) in the last bits on most inputs, so the
bounded values themselves cannot be bit-equal; the tests feed the same
bounded values to both codecs to hold everything after ``tanh`` exactly.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from titok_tpu.models.quantizer import FSQ as JFSQ  # noqa: E402
from titok_tpu_torch.models.quantizer import FSQ, round_ste  # noqa: E402

LEVELS = [[7, 5, 5, 5, 5], [8, 8, 8, 6, 5]]


@pytest.mark.parametrize("levels", LEVELS)
def test_bound_matches_jax(rng, levels):
    """tanh within 4 ulp (3 seen); bound = tanh * half_l - offset with
    half_l <= 3.5, so within 1e-6."""
    z = (rng.normal(size=(4000, 5)) * 2).astype(np.float32)
    np.testing.assert_array_max_ulp(torch.tanh(torch.from_numpy(z)).numpy(),
                                    np.asarray(jnp.tanh(jnp.asarray(z))), maxulp=4)
    want = np.asarray(JFSQ(levels).bound(jnp.asarray(z)))
    got = FSQ(levels).bound(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("levels", LEVELS)
def test_rounding_and_codes_bit_exact_on_boundaries(levels):
    """Bounded values on and next to every rounding boundary (half
    integers: round half to even) give identical codes and indices."""
    jf, tf = JFSQ(levels), FSQ(levels)
    halves = np.arange(-4.5, 5.0, 1.0, dtype=np.float32)
    vals = np.concatenate([halves, np.nextafter(halves, np.float32(-9)),
                           np.nextafter(halves, np.float32(9)),
                           np.arange(-4, 5, dtype=np.float32)])
    b = np.repeat(vals[:, None], len(levels), axis=1)
    hw = np.asarray([l // 2 for l in levels], np.float32)
    b = np.clip(b, -hw, hw)  # inside each level's range
    want_codes = np.asarray(jnp.round(jnp.asarray(b)) / jnp.asarray(hw))
    got_codes = (round_ste(torch.from_numpy(b)) / torch.from_numpy(hw)).numpy()
    np.testing.assert_array_equal(got_codes, want_codes)
    np.testing.assert_array_equal(
        tf.codes_to_indices(torch.from_numpy(got_codes)).numpy(),
        np.asarray(jf.codes_to_indices(jnp.asarray(want_codes))))


@pytest.mark.parametrize("levels", LEVELS)
def test_quantize_indices_equal_jax(rng, levels):
    """End to end from latents: codes and indices equal JAX's wherever the
    bounded value is not within a few ulp of a rounding boundary."""
    z = (rng.normal(size=(20000, 5)) * 1.5).astype(np.float32)
    jcodes, jaux = JFSQ(levels)(jnp.asarray(z))
    codes, aux = FSQ(levels)(torch.from_numpy(z))
    assert codes.dtype == torch.float32 and aux["indices"].dtype == torch.int32
    b = np.asarray(JFSQ(levels).bound(jnp.asarray(z)))
    near = (np.abs(np.abs(b - np.floor(b)) - 0.5) < 1e-5).any(axis=1)
    assert near.sum() < 20
    np.testing.assert_array_equal(codes.numpy()[~near], np.asarray(jcodes)[~near])
    np.testing.assert_array_equal(aux["indices"].numpy()[~near],
                                  np.asarray(jaux["indices"])[~near])
    # codes are cast back to the input dtype (fp32 island inside)
    cb, _ = FSQ(levels)(torch.from_numpy(z[:8]).to(torch.bfloat16))
    assert cb.dtype == torch.bfloat16


@pytest.mark.parametrize("levels", LEVELS)
def test_indices_to_codes_whole_codebook(levels):
    jf, tf = JFSQ(levels), FSQ(levels)
    n = int(np.prod(levels))
    idx = np.arange(n, dtype=np.int32)
    got = tf.indices_to_codes(torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jf.indices_to_codes(jnp.asarray(idx))))
    np.testing.assert_array_equal(tf.implicit_codebook(), jf.implicit_codebook())
    back = tf.codes_to_indices(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(back, idx)
    assert tf.codebook_size == n == (4375 if levels[0] == 7 else 15360)
