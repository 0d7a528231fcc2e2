"""The port's V-JEPA (``titok_tpu_torch/metrics/vjepa.py``) and JEDi
against the JAX package's on the CPU, at the ``test_tiny`` spec.

Weights: the torch mirror of the jepa encoder and probe
(``tests/torch_vjepa_mirror.py``, N(0, 0.05²)) through
``tools/convert_vjepa.py``. Pooled features within 1e-6 (the CPU shows
3e-8 on features of about 0.2), on the pretrain grid and on a non-square
grid, where the pretrain table is interpolated (within 1e-6 of JAX's
``jax.image.resize``) and a recomputed table would miss by more than
1e-2. The host preprocessing, the sin-cos tables and ``mmd_poly`` are the
same bits."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from tests.torch_vjepa_mirror import TorchVJEPAFeatures  # noqa: E402
from titok_tpu.metrics import jedi as jjedi  # noqa: E402
from titok_tpu.metrics import vjepa as jvjepa  # noqa: E402
from titok_tpu_torch.metrics import jedi, vjepa  # noqa: E402
from tools.convert_vjepa import convert_mirror_state_dict  # noqa: E402

SPEC = vjepa.SPECS["test_tiny"]
ATOL = 1e-6


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    torch.manual_seed(7)
    m = TorchVJEPAFeatures(jvjepa.SPECS["test_tiny"])
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0, 0.05)
    flat = convert_mirror_state_dict({k: v.detach().numpy() for k, v in m.state_dict().items()})
    path = str(tmp_path_factory.mktemp("vjepa") / "vjepa.npz")
    np.savez(path, **flat)
    return path


@pytest.fixture(scope="module")
def models(npz):
    ours = vjepa.VJEPAFeatures(SPEC).eval()
    ours.load_state_dict({k: torch.from_numpy(v) for k, v in vjepa.load_vjepa_params(npz).items()})
    return ours, jvjepa.load_vjepa_params(npz)


@pytest.mark.parametrize("thw", [(4, 32, 32), (6, 32, 56)], ids=["pretrain_grid", "non_square"])
def test_pooled_features_match_jax(models, thw):
    ours, params = models
    x = np.random.default_rng(thw[2]).normal(size=(2, *thw, 3)).astype(np.float32)
    want = np.asarray(jvjepa.VJEPAFeatures(jvjepa.SPECS["test_tiny"]).apply({"params": params}, x))
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, SPEC.embed_dim)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_pos_table_interpolated_on_non_square_grid():
    """The pretrain grid (2, 4, 4) onto (3, 4, 7): the pretrain table
    resampled, as JAX does, not a table recomputed for the new grid."""
    table = vjepa.get_3d_sincos_pos_embed(SPEC.embed_dim, *SPEC.grid)
    want = np.asarray(jvjepa.interpolate_pos_embed(jnp.asarray(table), SPEC.grid, (3, 4, 7)))
    got = vjepa.interpolate_pos_embed(torch.from_numpy(table), SPEC.grid, (3, 4, 7)).numpy()
    assert got.shape == (3 * 4 * 7, SPEC.embed_dim)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.abs(vjepa.get_3d_sincos_pos_embed(SPEC.embed_dim, 3, 4, 7) - want).max() > 1e-2


@pytest.mark.parametrize("hw", [(48, 64), (224, 160), (32, 32), (41, 57)])
def test_host_preprocessing_bit_for_bit(hw):
    """Short-side bicubic resize, normalisation, frames repeated up to
    ``frames_per_clip``: the same bits as JAX's numpy code."""
    v = np.random.default_rng(hw[0]).uniform(-1.2, 1.2, size=(2, 3, 3, *hw)).astype(np.float32)
    want = jvjepa.preprocess_bcthw(v, jvjepa.SPECS["test_tiny"])
    got = vjepa.preprocess_bcthw(v, SPEC)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("uniform_power", [True, False])
def test_sincos_tables_and_mmd_equal(uniform_power):
    np.testing.assert_array_equal(vjepa.get_3d_sincos_pos_embed(1024, 8, 14, 17, uniform_power),
                                  jvjepa.get_3d_sincos_pos_embed(1024, 8, 14, 17, uniform_power))
    rng = np.random.default_rng(int(uniform_power))
    a, b = rng.normal(size=(5, 24)), rng.normal(loc=0.3, size=(6, 24))
    assert jedi.mmd_poly(a, b) == jjedi.mmd_poly(a, b)
    assert jedi.mmd_poly(a, b, degree=3, gamma=0.5, coef0=1.0) == \
        jjedi.mmd_poly(a, b, degree=3, gamma=0.5, coef0=1.0)


def test_jedi_matches_jax_and_lookup_order(npz, tmp_path):
    """``JEDiMetric``: ``feature_fn`` first, then the params ``.npz`` (the
    port's V-JEPA on the device asked for), then a torchscript (loaded
    there), else JAX's ``RuntimeError``. Both packages' JEDi agree within
    1e-5 relative on clips that are resized and frame-padded."""
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, size=(2, 3, 2, 40, 56)).astype(np.float32)
    b = rng.uniform(-1, 1, size=(2, 3, 3, 56, 40)).astype(np.float32)
    ours = jedi.JEDiMetric(model_name="test_tiny", vjepa_params_path=npz, device="cpu")
    theirs = jjedi.JEDiMetric(model_name="test_tiny", vjepa_params_path=npz)
    for x, y in ((a, a[::-1]), (b, b[::-1])):
        ours.update(x, y)
        theirs.update(x, y)
    assert isinstance(ours.feature_fn, vjepa.VJEPAExtractor)
    for p, q in zip(ours.real + ours.fake, theirs.real + theirs.fake):
        np.testing.assert_allclose(p, q, atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours.compute(), theirs.compute(), rtol=1e-5)
    ours.reset()
    ours.update(a, a)
    assert ours.compute() == pytest.approx(0.0, abs=1e-9)

    def mean_fn(v):
        return np.asarray(v).reshape(len(v), 3, -1).mean(-1)

    first = jedi.JEDiMetric(mean_fn, vjepa_params_path=npz, device="cpu")
    first.update(a, a)
    assert first.feature_fn is mean_fn

    class Mean(torch.nn.Module):
        def forward(self, x):
            return x.mean(dim=(2, 3, 4))

    pt = str(tmp_path / "embed.pt")
    torch.jit.script(Mean()).save(pt)
    m = jedi.JEDiMetric(extractor_path=pt, device="cpu")
    m.update(a, b[:, :, :2, :40, :56])
    assert isinstance(m.feature_fn, jedi.TorchscriptVideoExtractor)
    assert m.feature_fn.device == torch.device("cpu")
    np.testing.assert_allclose(m.real[0], mean_fn(b[:, :, :2, :40, :56]), rtol=1e-5)
    with pytest.raises(RuntimeError, match="JEDi needs a V-JEPA feature extractor"):
        jedi.JEDiMetric(device="cpu").update(a, a)
