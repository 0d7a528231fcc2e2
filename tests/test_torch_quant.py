"""The port's int8 serving quantization (``titok_tpu_torch/serving/quant.py``)
against the JAX package's (``titok_tpu/serving/quant.py``) on the CPU, with
the same weights carried over by ``weights.from_flax_params``.

The tiny model of ``tests/test_quant.py`` (``tiny_config``: patch (2,4,4),
f32, seq 256, ``min_grid`` (4,16,16)) at its init, and the same model with
its Dense kernels scaled by 4 on both sides (at the init's std 0.02 every
latent token lands on one FSQ code; at 4x they spread over 22, so the
index comparison with JAX compares something). Held:

- ``quantize_kernel`` and ``quantize_params``: q and s bit for bit JAX's
  (transposed), as many quantized layers as JAX has 2-D kernels;
  ``dequantize_params`` within 0.005 x amax;
- ``_int8_dense``: w8a8 bit for bit JAX's on identical inputs, the K = 5
  and N = 5 layers (padded here) included; w8a16 within 1e-5 relative (f32
  sums in another order);
- the quantized model against its own f32 model at ``tests/test_quant.py``'s
  thresholds (indices >= 0.98, PSNR > 40 dB), the original left untouched;
- the quantized model against JAX's quantized model, at the init and at
  4x: indices and reconstructions within the bounds of :data:`AGAINST_JAX`;
- a partly quantized model runs its float layer as a ``Dense``."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402

from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from tests.util import tiny_config  # noqa: E402
from titok_tpu.models.titok import TiTokModel as JTiTokModel  # noqa: E402
from titok_tpu.models.titok import make_titok as j_make_titok  # noqa: E402
from titok_tpu.serving import quant as jquant  # noqa: E402
from titok_tpu_torch.models.titok import TiTok, TiTokModel  # noqa: E402
from titok_tpu_torch.models.transformer import Dense  # noqa: E402
from titok_tpu_torch.serving import quant  # noqa: E402
from titok_tpu_torch.weights import from_flax_params  # noqa: E402

PATCH = (2, 4, 4)
TOKENS = [32, 64]
# the quantized port against JAX's quantized model, per (Dense scale, mode):
# the least share of identical indices, and the largest |difference| of the
# two decodes of JAX's indices on [-1, 1]. The int8 products agree bit for
# bit; what differs is the f32 arithmetic around them (XLA's and torch's
# sums), which moves a bf16 rounding of an activation (w8a16) or an int8
# rounding of one (w8a8) now and then. Measured: at the init every index
# equal, recon 6.9e-4 (w8a16) and 8.4e-4 (w8a8); at 4x indices 100.0 % and
# 96.9 %, recon 0.0107 and 0.0498. Bounds about 3x those.
AGAINST_JAX = {(1.0, "w8a16"): (0.99, 3e-3), (1.0, "w8a8"): (0.99, 3e-3),
               (4.0, "w8a16"): (0.99, 0.03), (4.0, "w8a8"): (0.93, 0.15)}


def _models(scale: float):
    """JAX's tiny model with its Dense kernels scaled by ``scale``, the
    port's on the same weights, and two clips."""
    jm = JTiTokModel(j_make_titok(tiny_config()), seq_len=256, min_grid=(4, 16, 16))
    jm.params = jtu.tree_map_with_path(
        lambda p, x: x * scale if jtu.keystr(p).endswith("['kernel']") else x, jm.params)
    port = TiTokModel(TiTok(patch_size=PATCH, dtype=torch.float32),
                      params=from_flax_params(jax.tree.map(np.asarray, jm.params)),
                      seq_len=256, min_grid=(4, 16, 16), device="cpu")
    rng = np.random.default_rng(0)
    vids = [rng.random((3, 4, 16, 16), np.float32) * 2 - 1,
            rng.random((3, 8, 16, 16), np.float32) * 2 - 1]
    return jm, port, vids


@pytest.fixture(scope="module")
def models():
    return _models(1.0)


@pytest.fixture(scope="module")
def spread():
    return _models(4.0)


def test_quantize_kernel_bits_equal_jax():
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((64, 48)) * 0.3).astype(np.float32)  # flax [in, out]
    want = jquant.quantize_kernel(w)
    got = quant.quantize_kernel(torch.from_numpy(w.T.copy()))
    assert got["q"].dtype == torch.int8 and got["q"].shape == (48, 64)
    assert got["s"].dtype == torch.float32 and got["s"].shape == (48,)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]).T)
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    # symmetric per-channel int8: at most half an lsb a channel
    back = got["q"].float() * got["s"][:, None]
    assert bool((back - torch.from_numpy(w.T)).abs().le(0.5 * got["s"][:, None] + 1e-7).all())


def test_quantize_params_equal_jax(models):
    jm, port, *_ = models
    jq = {jtu.keystr(k): v for k, v in jtu.tree_flatten_with_path(
        jquant.quantize_params(jm.params))[0]}
    sd = port.module.state_dict()
    qp = quant.quantize_params(sd)
    n_kernels = sum(jtu.keystr(k).endswith("['kernel']") and np.ndim(v) == 2
                    for k, v in jtu.tree_flatten_with_path(jm.params)[0])
    quantized = {k: v for k, v in qp.items() if isinstance(v, dict)}
    assert len(quantized) == n_kernels == sum(k.endswith("['q']") for k in jq) > 0
    for name, entry in quantized.items():
        jkey = "".join(f"['{p}']" for p in name.split(".")[:-1]) + "['kernel']"
        np.testing.assert_array_equal(entry["q"].numpy(), np.asarray(jq[jkey + "['q']"]).T, name)
        np.testing.assert_array_equal(entry["s"].numpy(), np.asarray(jq[jkey + "['s']"]), name)
    for name, v in qp.items():  # everything else passes through
        if name not in quantized:
            assert v is sd[name], name
    for name, v in quant.dequantize_params(qp).items():
        amax = max(float(sd[name].abs().max()), 1e-12)
        assert float((v - sd[name]).abs().max()) <= 0.005 * amax + 1e-7, name


@pytest.mark.parametrize("mode", quant.MODES)
@pytest.mark.parametrize("K,N", [(5, 256), (256, 5), (256, 768), (40, 24)])
def test_int8_dense_equals_jax(mode, K, N):
    """One layer on identical inputs: the decoder's ``proj_in`` (K 5), the
    FSQ encoder's ``proj_out`` (N 5), a ``to_qkv`` and a small one; rows
    that need the activation scale, a zero row, a bias."""
    rng = np.random.default_rng(K * 1000 + N)
    x = (rng.standard_normal((40, K)) * rng.uniform(0.1, 3.0, (40, 1))).astype(np.float32)
    x[7] = 0.0
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(N) * 0.1).astype(np.float32)
    jk = jquant.quantize_kernel(w)
    want = np.asarray(jquant._int8_dense(jnp.asarray(x), jk["q"], jk["s"], bias, mode,
                                         jnp.float32))
    layer = quant.Int8Dense(**quant.quantize_kernel(torch.from_numpy(w.T.copy())),
                            bias=torch.from_numpy(bias), compute_dtype=torch.float32, mode=mode)
    assert layer.q.shape == (-(-N // 8) * 8, -(-K // 8) * 8)  # padded to multiples of 8
    got = layer(torch.from_numpy(x)).numpy()
    assert got.shape == (40, N) and got.dtype == np.float32
    if mode == "w8a8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("mode", quant.MODES)
def test_quantized_model_against_f32(mode, models):
    _, port, vids = models
    grids = [v.shape[1:] for v in vids]
    idx_f32 = port.encode(vids, TOKENS)
    rec_f32 = port.decode_indices(idx_f32, grids)
    qm = quant.quantize_model(port, mode)
    idx_q = qm.encode(vids, TOKENS)
    agree = np.mean([np.mean(a == b) for a, b in zip(idx_f32, idx_q)])
    assert agree >= 0.98, agree
    for a, b in zip(rec_f32, qm.decode_indices(idx_f32, grids)):
        mse = float(np.mean((a - b) ** 2))
        assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 40.0, mode
    # the original model is untouched: float Denses, the same outputs
    assert qm.module is not port.module
    assert all(not isinstance(m, quant.Int8Dense) for m in port.module.modules())
    for a, b in zip(rec_f32, port.decode_indices(idx_f32, grids)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", quant.MODES)
@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_quantized_model_against_jax(scale, mode, models, spread):
    jm, port, vids = models if scale == 1.0 else spread
    share_min, atol = AGAINST_JAX[(scale, mode)]
    qm, jq = quant.quantize_model(port, mode), jquant.quantize_model(jm, mode=mode)
    want_idx = jq.encode(vids, TOKENS)
    share = np.mean(np.concatenate([a == np.asarray(b)
                                    for a, b in zip(qm.encode(vids, TOKENS), want_idx)]))
    assert share >= share_min, (scale, mode, share)
    grids = [v.shape[1:] for v in vids]
    for a, b in zip(qm.decode_indices(want_idx, grids), jq.decode_indices(want_idx, grids)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol)


def test_partly_quantized_model_falls_through(spread):
    """The encoder's ``proj_in`` left in float: it stays a ``Dense`` and
    runs as before, every other layer is int8, and the result is JAX's with
    the same mixed tree (``quantized_apply``)."""
    jm, port, vids = spread
    qp = quant.quantize_params(port.module.state_dict())
    qp["encoder.proj_in.weight"] = port.module.encoder.proj_in.weight.detach()
    mixed = quant.quantize_module(port.module, "w8a16", qp)
    assert type(mixed.encoder.proj_in) is Dense
    assert isinstance(mixed.encoder.proj_out, quant.Int8Dense)
    assert sum(isinstance(m, quant.Int8Dense) for m in mixed.modules()) == \
        sum(isinstance(m, Dense) for m in port.module.modules()) - 1
    jp = jquant.quantize_params(jm.params)
    jp["encoder"]["proj_in"]["kernel"] = np.asarray(jm.params["encoder"]["proj_in"]["kernel"])
    batch = jm._pack(vids, TOKENS).device_arrays()
    _, jaux = jax.jit(lambda p, b: jquant.quantized_apply(jm.module, {"params": p}, b, None,
                                                          mode="w8a16"))(jp, batch)
    with torch.no_grad():
        _, aux = mixed({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()})
    tm = batch["token_mask"]
    share = float(np.mean(aux["indices"].numpy()[tm] == np.asarray(jaux["indices"])[tm]))
    assert share >= 0.95, share  # measured 97.9 % (2 of 96 tokens flip)
