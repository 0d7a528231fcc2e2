"""The port's TiTok against the JAX package on the CPU, with the same
weights carried over by ``weights.from_flax_params``: the golden trace,
the tokenizer API, and the rules of the package (no JAX imports, a card by
default)."""

import ast
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from titok_tpu.config import load_config as j_load_config  # noqa: E402
from titok_tpu.models.titok import TiTok as JTiTok  # noqa: E402
from titok_tpu.models.titok import TiTokModel as JTiTokModel  # noqa: E402
from titok_tpu.models.titok import make_titok as j_make_titok  # noqa: E402
from titok_tpu_torch import resolve_device  # noqa: E402
from titok_tpu_torch.config import load_config  # noqa: E402
from titok_tpu_torch.models.titok import TiTok, TiTokModel, init_params, make_titok  # noqa: E402
from titok_tpu_torch.weights import from_flax_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "titok_tiny_trace.npz")
PATCH = (2, 4, 4)


@pytest.fixture(scope="module")
def golden_jax():
    """The golden test's JAX model (seed 7, patch (2,4,4), f32, seq 256)."""
    return JTiTokModel(
        JTiTok(patch_size=PATCH, dtype=jnp.float32, attn_impl="reference"),
        seq_len=256, min_grid=(2, 8, 8), seed=7)


@pytest.fixture(scope="module")
def golden_params(golden_jax):
    return from_flax_params(jax.tree.map(np.asarray, golden_jax.params))


def _port(params, attn_impl="reference"):
    return TiTokModel(TiTok(patch_size=PATCH, dtype=torch.float32, attn_impl=attn_impl),
                      params=params, seq_len=256, min_grid=(2, 8, 8), device="cpu")


@pytest.mark.parametrize("attn_impl", ["reference", "auto"])
def test_golden_trace(golden_params, attn_impl):
    data = np.load(GOLDEN)
    recon, aux = _port(golden_params, attn_impl).forward([data["vid0"], data["vid1"]], [5, 9])
    np.testing.assert_array_equal(aux["indices"][0], data["idx0"])
    np.testing.assert_array_equal(aux["indices"][1], data["idx1"])
    np.testing.assert_allclose(recon[0], data["recon0"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(recon[1], data["recon1"], atol=1e-5, rtol=0)


def _clips(rng):
    return [rng.uniform(-1, 1, (3, 4, 8, 8)).astype(np.float32),
            rng.integers(0, 256, (2, 12, 8, 3), dtype=np.uint8),
            rng.uniform(-1, 1, (3, 2, 16, 12)).astype(np.float32)], [3, 8, 1]


def test_tokenizer_api_matches_jax(rng, golden_jax, golden_params):
    clips, tcs = _clips(rng)
    port = _port(golden_params)
    idx = port.encode(clips, tcs)
    want_idx = golden_jax.encode(clips, tcs)
    for a, b in zip(idx, want_idx):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.encode(clips, tcs, split_indices=False),
                                  np.concatenate(want_idx))

    recon, aux = port.forward(clips, tcs)
    want_recon, want_aux = golden_jax.forward(clips, tcs)
    for a, b in zip(aux["indices"], want_aux["indices"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(recon, want_recon):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)

    grids = [(4, 8, 8), (2, 12, 8), (2, 16, 12)]
    dec = port.decode_indices(idx, grids)
    want_dec = golden_jax.decode_indices(want_idx, grids)
    flat = port.decode_indices(np.concatenate(idx), grids, token_counts=tcs)
    for a, b, c in zip(dec, want_dec, flat):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(a, c)


def test_groups_split_like_jax(golden_jax, golden_params):
    port = _port(golden_params)
    clips = [np.zeros((3, 4, 8, 8), np.float32)] * 5
    tcs = [100, 100, 100, 20, 5]
    assert port._groups(clips, tcs) == golden_jax._groups(clips, tcs)
    with pytest.raises(ValueError, match="budget"):
        port._groups([np.zeros((3, 8, 32, 32), np.float32)], [1])


def test_tiny_config_state_dict_matches_flax_tree():
    """``make_titok`` on the tiny config builds the flax tree's parameters
    under the same names and shapes (full width 256, GEGLU inner 704). The
    flax tree is JAX's init traced for its shapes (``jax.eval_shape``),
    which gives the init's names and shapes without running it."""
    cfg_path = os.path.join(REPO, "configs", "tiny.yaml")
    port = make_titok(load_config(cfg_path))
    jmod = j_make_titok(j_load_config(cfg_path))
    jm = JTiTokModel(jmod, params={}, seq_len=64, min_grid=(4, 8, 8))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jm._dummy_batch(),
                                              jm.vq_state)["params"])
    flat = from_flax_params(jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes))
    sd = port.state_dict()
    assert set(flat) == set(sd)
    for name, val in flat.items():
        assert tuple(sd[name].shape) == val.shape, name
    assert sd["encoder.model_layers.ffd_0.w3.weight"].shape == (256, 704)
    assert sd["encoder.model_layers.attn_0.to_qkv.weight"].shape == (768, 256)
    assert port.dtype == torch.bfloat16 and port.codebook_size == 4375
    assert set(init_params(port, 0)) == set(sd)


def test_unported_options_raise():
    """EMA-VQ is ported; its context-parallel lookup (vq_nearest_cp) is
    not, nor is any parallel mode."""
    from titok_tpu_torch.models.vq import EMAVQ

    assert TiTok(quantizer="vq").token_size == 8
    with pytest.raises(NotImplementedError, match="not ported"):
        EMAVQ(16, 2, cp_mesh=object())
    with pytest.raises(ValueError, match="quantizer"):
        TiTok(quantizer="lfq")
    cfg = load_config(os.path.join(REPO, "configs", "tiny.yaml"))
    with pytest.raises(NotImplementedError, match="not ported"):
        make_titok(cfg, cp_mesh=object())


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TiTokModel(TiTok(patch_size=PATCH), seq_len=64, min_grid=(2, 8, 8))
    with pytest.raises(RuntimeError):
        resolve_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "titok_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    banned = ("jax", "flax", "titok_tpu", "optax", "orbax", "PIL")
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in banned, f"{path} imports {mod}"
