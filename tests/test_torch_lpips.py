"""The port's perceptual loss against the JAX package on the CPU in f32:
LPIPS and the Gram loss (``losses/lpips.py``), the ``.npz`` loader, the
random-VGG fallback and its gate, the perceptual plan (equal array for
array from one seed), ``crop_resize`` against ``jax.image.
scale_and_translate``, and ``generator_loss`` with the perceptual terms, its
value and its gradient with respect to the reconstruction rows.

Both packages get one numpy-seeded weight set: the port's state dict, and
for JAX the same weights as a flax tree (the inverse of
``weights.from_flax_params``), so no test pays for flax's init. Last, two
CPU steps of the port's ``Trainer.fit`` with LPIPS on."""

import os
import re
import shutil
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from tests.util import PATCH, tiny_config  # noqa: E402
from titok_tpu.data import packing as jpack  # noqa: E402
from titok_tpu.losses import lpips as jlpips  # noqa: E402
from titok_tpu.losses.loss_module import LossSystem as JLossSystem  # noqa: E402
from titok_tpu.ops import frames as jframes  # noqa: E402
from titok_tpu_torch.config import Config  # noqa: E402
from titok_tpu_torch.data import packing as tpack  # noqa: E402
from titok_tpu_torch.losses import lpips as tlpips  # noqa: E402
from titok_tpu_torch.losses.loss_module import LossSystem  # noqa: E402
from titok_tpu_torch.ops import frames as tframes  # noqa: E402
from titok_tpu_torch.weights import from_flax_params  # noqa: E402

# port vs JAX, the worst seen on the CPU over these tests: LPIPS 1.5e-7 and
# Gram 9.7e-7 relative (values 0.34-0.40 and 0.035-0.13); crop_resize 2.4e-7
# absolute on frames in [-1, 1]; the generator loss's terms 2.3e-7 relative,
# its grad 1.9e-6 of max|g| (0.018)
LPIPS_RTOL = 1e-5
CROP_ATOL = 1e-6
GRAD_TOL = 1e-5


def _flax_tree(seed: int = 0) -> dict:
    """One numpy-seeded LPIPS weight set as a flax tree: He-normal conv
    kernels (HWIO), small biases, positive lin kernels ``[1, 1, C, 1]``."""
    rng = np.random.default_rng(seed)
    net, cin, i = {}, 3, 0
    for v in tlpips.VGG16_CFG:
        if v != "M":
            std = np.sqrt(2.0 / (9 * cin))
            net[f"conv{i}"] = {"kernel": (rng.standard_normal((3, 3, cin, v)) * std)
                               .astype(np.float32),
                               "bias": (rng.standard_normal(v) * 0.01).astype(np.float32)}
            cin, i = v, i + 1
    tree = {"net": net}
    for k, c in enumerate(tlpips.LPIPS_CHANNELS):
        tree[f"lin{k}"] = {"kernel": rng.uniform(0, 2, (1, 1, c, 1)).astype(np.float32)}
    return tree


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def weights():
    tree = _flax_tree(0)
    return tree, from_flax_params(tree)


def _port_lpips(sd) -> tlpips.LPIPS:
    m = tlpips.LPIPS()
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return m.requires_grad_(False)


def _frame_pair(rng, K, s):
    x = rng.uniform(-1, 1, (K, s, s, 3)).astype(np.float32)
    y = np.clip(x + 0.3 * rng.standard_normal(x.shape), -1, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("size", [16, 32])
def test_lpips_and_gram_match_jax(weights, size):
    tree, sd = weights
    x, y = _frame_pair(np.random.default_rng(size), 3, size)
    lp_j, gram_j = jax.jit(jlpips.LPIPS().apply)({"params": tree}, x, y)
    with torch.no_grad():
        lp, gram = _port_lpips(sd)(torch.from_numpy(x), torch.from_numpy(y))
    assert lp.shape == gram.shape == (3,)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=LPIPS_RTOL, atol=0)
    np.testing.assert_allclose(gram.numpy(), np.asarray(gram_j), rtol=LPIPS_RTOL, atol=0)
    assert float(lp.min()) > 0 and float(gram.min()) > 0


def test_npz_loader_matches_jax(weights, tmp_path):
    """One ``.npz`` in ``tools/convert_lpips.py``'s layout serves both
    packages: the port's state dict equals the JAX tree's mapping."""
    tree, sd = weights
    flat = _flatten(tree)
    path = str(tmp_path / "lpips_vgg.npz")
    np.savez(path, **flat)
    got = tlpips.load_lpips_params(path)
    jtree = jax.tree_util.tree_map(np.asarray, jlpips.load_lpips_params(path))
    want = from_flax_params(jtree)
    assert set(got) == set(want) == set(sd) == set(tlpips.LPIPS().state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], sd[k], err_msg=k)
    assert got["net.conv0.weight"].shape == (64, 3, 3, 3)
    assert got["lin4.weight"].shape == (1, 512, 1, 1)
    ours, theirs = _flatten(tlpips.unflatten(flat)), _flatten(jlpips._unflatten(flat))
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]), err_msg=k)


def test_random_fallback_is_a_positive_semimetric():
    """Without the file: a warning, lin weights ``|w|`` at mean 1, zero
    distance for equal inputs, and a distance that is positive and grows
    with the perturbation, on the pretrained LPIPS scale (as
    ``tests/test_lpips.py`` checks JAX's fallback)."""
    with pytest.warns(UserWarning, match="LPIPS weights not found"):
        sd = tlpips.load_lpips_params("/nonexistent/path.npz")
    for k in range(5):
        lin = sd[f"lin{k}.weight"]
        assert (lin >= 0).all()
        np.testing.assert_allclose(lin.mean(), 1.0, rtol=1e-5)
    assert all(not sd[f"net.conv{i}.bias"].any() for i in range(13))
    m = _port_lpips(sd)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
    small = torch.clamp(x + 0.05 * torch.from_numpy(rng.standard_normal(x.shape)).float(), -1, 1)
    big = torch.clamp(x + 0.5 * torch.from_numpy(rng.standard_normal(x.shape)).float(), -1, 1)
    with torch.no_grad():
        lp0, gram0 = m(x, x)
        lp_small, _ = m(x, small)
        lp_big, _ = m(x, big)
    assert float(lp0.abs().max()) == 0.0 and float(gram0.abs().max()) == 0.0
    assert float(lp_small.min()) > 0.0
    assert float(lp_big.mean()) > float(lp_small.mean())
    assert 0.01 < float(lp_big.mean()) < 5.0


def _fit_config(path, **over):
    return Config(tiny_config(**{
        "dataset.train_dataset": "synthetic", "dataset.eval_dataset": "synthetic",
        "general.checkpoints.save_path": str(path), "training.main.max_steps": 2,
        "training.eval.eval_step_interval": 0, "tokenizer.losses.perceptual_weight": 1.0,
        **over}).to_dict())


def test_random_lpips_is_gated(tmp_path):
    """A perceptual loss without weights raises at ``Trainer(...)`` unless
    ``allow_random_lpips`` is set, as in the JAX trainer."""
    from titok_tpu_torch.training.trainer import Trainer

    over = {"tokenizer.losses.lpips_weights": str(tmp_path / "missing.npz")}
    with pytest.raises(RuntimeError, match="LPIPS weights"):
        Trainer(_fit_config(tmp_path, **over), device="cpu")
    over["tokenizer.losses.allow_random_lpips"] = True
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        t = Trainer(_fit_config(tmp_path, **over), device="cpu")
    assert all((t.lpips_params[f"lin{k}.weight"] >= 0).all() for k in range(5))


def _mixed_batch(pack):
    """Three clips, one with frames below the 16-pixel sample size and one
    smaller than the 24x24 max grid (edge-clamped when gathered)."""
    rng = np.random.default_rng(11)
    vids = [rng.uniform(-1, 1, (3, *d)).astype(np.float32)
            for d in ((4, 8, 12), (2, 16, 16), (4, 20, 24))]
    return pack.pack_samples(vids, [2, 3, 5], seq_len=160, max_samples=4, patch_size=PATCH)


PLAN_KW = dict(sample_size=16, patch_size=PATCH, max_grid_hw=(24, 24))


@pytest.mark.parametrize("num_frames", [7, 13])
def test_perceptual_plan_equals_jax(num_frames):
    """Equal arrays from one seed: the same draws in the same order (the
    `or` skips ``rng.random()`` for a frame below the sample size), and the
    generators left in the same state. 13 frames cycle the batch's 10."""
    jb, pb = _mixed_batch(jpack), _mixed_batch(tpack)
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    want = jframes.build_perceptual_plan(jb, num_frames=num_frames, rng=jrng, **PLAN_KW)
    got = tframes.build_perceptual_plan(pb, num_frames=num_frames, rng=trng, **PLAN_KW)
    for k, v in want.device_arrays().items():
        assert getattr(got, k).dtype == v.dtype, k
        np.testing.assert_array_equal(getattr(got, k), v, err_msg=k)
    assert jrng.bit_generator.state == trng.bit_generator.state
    scales = got.scale[:, 0]
    assert (scales > 1).any() and (scales == 1).any()  # both branches taken
    assert (got.weight == 1).all()


CROP_CASES = {
    # (scale (y, x), translation (y, x)) of 20x24 frames to 16x16
    "scale 1": ((1.0, 1.0), (-3.0, -5.0)),
    "up-scale, fractional": ((1.37, 1.6), (-2.3, -0.75)),
    "down-scale": ((0.8, 0.8), (-1.5, 0.0)),
}


@pytest.mark.parametrize("case", list(CROP_CASES))
def test_crop_resize_matches_jax(case):
    """Against JAX's ``crop_resize`` run eagerly, op by op, as
    ``scale_and_translate`` defines it (under jit XLA reorders the
    contraction: up to 5e-6 apart at these shapes)."""
    scale, translation = CROP_CASES[case]
    K = 3
    rng = np.random.default_rng(5)
    frames = rng.uniform(-1, 1, (K, 20, 24, 3)).astype(np.float32)
    sc = np.tile(np.float32(scale), (K, 1)) * np.float32([[1.0], [1.1], [0.9]])
    tr = np.tile(np.float32(translation), (K, 1)) + np.float32([[0.0], [-0.4], [0.25]])
    want = jframes.crop_resize(jnp.asarray(frames), {"scale": sc, "translation": tr}, 16)
    got = tframes.crop_resize(torch.from_numpy(frames), {
        "scale": torch.from_numpy(sc), "translation": torch.from_numpy(tr)}, 16)
    assert got.shape == (K, 16, 16, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CROP_ATOL, rtol=0)


def test_extract_perceptual_frames_edge_clamped_matches_jax():
    """Frames gathered from packed rows at the padded 24x24 size (a clip's
    edge rows repeated) and then cropped and resized, as JAX does."""
    jb, pb = _mixed_batch(jpack), _mixed_batch(tpack)
    jplan = jframes.build_perceptual_plan(jb, num_frames=13, rng=np.random.default_rng(4),
                                          **PLAN_KW)
    plan = tframes.build_perceptual_plan(pb, num_frames=13, rng=np.random.default_rng(4),
                                         **PLAN_KW)
    want = jframes.extract_perceptual_frames(
        jnp.asarray(jb.patches), {k: jnp.asarray(v) for k, v in jplan.device_arrays().items()},
        PATCH, 16)
    got = tframes.extract_perceptual_frames(torch.from_numpy(pb.patches),
                                            tpack.to_device(plan, "cpu"), PATCH, 16)
    assert got.shape == (13, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CROP_ATOL, rtol=0)


def test_generator_loss_and_recon_grad_match_jax(weights):
    """``generator_loss`` with ``perceptual_weight`` and ``gram_weight`` >
    0 (disc off): every term and the total, and the gradient with respect
    to the reconstruction rows, which reaches them through LPIPS, the crop
    and resize and the frame gather."""
    tree, sd = weights
    cfg = tiny_config(**{"tokenizer.losses.perceptual_weight": 1.0,
                         "tokenizer.losses.gram_weight": 0.5})
    jb, pb = _mixed_batch(jpack), _mixed_batch(tpack)
    jls, pls = JLossSystem(cfg), LossSystem(Config(cfg.to_dict()))
    assert pls.num_frames == jls.num_frames == 3
    pls.lpips.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    kw = dict(num_frames=3, sample_size=16, patch_size=PATCH, max_grid_hw=(16, 16))
    jplan = jframes.build_perceptual_plan(jb, rng=np.random.default_rng(2), **kw)
    plan = tframes.build_perceptual_plan(pb, rng=np.random.default_rng(2), **kw)
    recon = (jb.patches + np.random.default_rng(6).normal(0, 0.3, jb.patches.shape)) \
        .astype(np.float32)
    arrs = {k: jnp.asarray(v) for k, v in jb.device_arrays().items()}
    jperc = {k: jnp.asarray(v) for k, v in jplan.device_arrays().items()}
    (j_total, j_terms), j_grad = jax.jit(jax.value_and_grad(
        lambda r: jls.generator_loss(tree, {}, r, arrs, None, jperc), has_aux=True))(
        jnp.asarray(recon))

    r = torch.from_numpy(recon).requires_grad_()
    total, terms = pls.generator_loss(r, tpack.to_device(pb, "cpu"), None,
                                      tpack.to_device(plan, "cpu"))
    (grad,) = torch.autograd.grad(total, r)
    assert set(terms) == set(j_terms) == {"gen/recon_loss", "gen/perceptual_loss",
                                          "gen/gram_loss", "gen/total_loss"}
    for k, v in j_terms.items():
        np.testing.assert_allclose(float(terms[k].detach()), float(v), rtol=LPIPS_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=LPIPS_RTOL)
    j_grad = np.asarray(j_grad)
    gmax = np.abs(j_grad).max()
    np.testing.assert_allclose(grad.numpy(), j_grad, atol=GRAD_TOL * gmax, rtol=0)
    # the perceptual terms reach rows the L1 term alone does not move so
    l1 = pls.generator_loss(r, tpack.to_device(pb, "cpu"), None, None)[0]
    (g_l1,) = torch.autograd.grad(l1, r)
    assert float((grad - g_l1).abs().max()) > 1e-3 * gmax


def test_fit_with_lpips_on(weights, tmp_path):
    """Two CPU steps of the port's ``Trainer.fit`` with LPIPS on:
    ``gen/perceptual_loss`` logged, finite and positive; the LPIPS weights
    unchanged; no LPIPS tensor in the checkpoint or the optimizer."""
    import json

    from titok_tpu_torch.train_utils.checkpoints import CheckpointManager, _read
    from titok_tpu_torch.training.trainer import Trainer

    tree, sd = weights
    path = str(tmp_path / "lpips_vgg.npz")
    np.savez(path, **_flatten(tree))
    run = tmp_path / "run"
    trainer = Trainer(_fit_config(run, **{"tokenizer.losses.lpips_weights": path}),
                      device="cpu")
    state = trainer.fit()
    assert state.step == 2
    rows = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    perc = [r["train/gen/perceptual_loss"] for r in rows if "train/gen/total_loss" in r]
    assert len(perc) == 2 and all(np.isfinite(v) and v > 0 for v in perc)
    lp = trainer.loss_system.lpips
    assert not any(p.requires_grad for p in lp.parameters())
    for k, v in lp.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    payload = _read(os.path.join(run, str(CheckpointManager(str(run)).latest_step())))
    names = [k for part in ("gen", "disc") for k in payload[part]]
    assert names and not any(re.match(r"(lpips\.|net\.conv\d|lin\d)", k) for k in names)
    assert not any(v.shape == (64, 3, 3, 3) for part in ("gen", "disc")
                   for v in payload[part].values())
    n_gen = sum(1 for _ in state.model.parameters())
    assert len(payload["gen_opt"]["param_groups"][0]["params"]) == n_gen
    shutil.rmtree(run)
