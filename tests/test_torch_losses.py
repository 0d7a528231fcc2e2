"""The port's loss system against the JAX package's ``LossSystem`` on the
CPU in f32: the generator and discriminator losses term by term, from the
same discriminator params, reconstruction and R1/R2 noise, and the
generator loss's gradient with respect to the reconstruction rows (through
the discriminator's attention backward). Both packages build the
discriminator in bf16 whatever the precision: each test runs it so, at
tolerances that admit the two frameworks' bf16 roundings, and with both
sides rebuilt in f32 (``f32_disc``), at tight ones."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_train_step import f32_disc, to_flax  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from tests.util import PATCH, synthetic_videos, tiny_config  # noqa: E402
from titok_tpu.data import packing as jpack  # noqa: E402
from titok_tpu.losses.loss_module import LossSystem as JLossSystem  # noqa: E402
from titok_tpu_torch.config import Config  # noqa: E402
from titok_tpu_torch.data import packing as tpack  # noqa: E402
from titok_tpu_torch.losses import loss_module as tloss  # noqa: E402
from titok_tpu_torch.weights import from_flax_params  # noqa: E402


# per discriminator dtype: (loss terms atol, recon grad (atol, rtol)). With
# the bf16 discriminator the two frameworks round its activations
# differently: on the CPU the terms came 4.4e-4 apart (sizes up to 0.7) and
# the recon grads 4.0e-7 (max|g| 4.4e-4); f32: 6e-8 and 3e-11.
TOL = {"f32": (1e-5, (1e-7, 1e-4)), "bf16": (2e-3, (1e-6, 5e-3))}


@pytest.fixture(scope="module", params=["f32", "bf16"])
def systems(request):
    cfg = tiny_config(**{"tokenizer.losses.disc_weight": 0.4})
    pcfg = Config(cfg.to_dict())
    pcfg.set_dotted("training.main.attn_impl", "auto")
    rng = np.random.default_rng(5)
    vids = synthetic_videos(rng, 3)
    kw = dict(seq_len=128, max_samples=4, patch_size=PATCH)
    jb = jpack.pack_samples(vids, [2, 3, 5], **kw)
    pb = tpack.pack_samples(vids, [2, 3, 5], **kw)
    jd, pd = jpack.build_disc_batch(jb, 4), tpack.build_disc_batch(pb, 4)

    jls = JLossSystem(cfg)
    pls = tloss.LossSystem(pcfg)
    if request.param == "f32":
        f32_disc(pcfg, pls, jls)
    disc_sd = pls.init_disc_params(1)
    pls.disc_model.load_state_dict({k: torch.from_numpy(v) for k, v in disc_sd.items()})
    dparams = to_flax(disc_sd)
    assert all(np.array_equal(v, disc_sd[k]) for k, v in from_flax_params(dparams).items())
    recon = (jb.patches + rng.normal(0, 0.3, jb.patches.shape)).astype(np.float32)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(9), jd.patch_gather.shape + (
        jb.patches.shape[1],), jnp.float32))
    return dict(dtype=request.param, jls=jls, pls=pls, dparams=dparams, jb=jb, jd=jd,
                pb=tpack.to_device(pb, "cpu"), pd=tpack.to_device(pd, "cpu"),
                recon=recon, noise=noise)


def _assert_terms(got: dict, want: dict, atol: float):
    assert set(got) == set(want)
    for key, val in want.items():
        np.testing.assert_allclose(float(got[key].detach()), float(val), atol=atol, rtol=0,
                                   err_msg=key)


def test_generator_loss_and_recon_grad_match_jax(systems):
    s = systems
    jls, arrs, darrs = s["jls"], s["jb"].device_arrays(), s["jd"].device_arrays()

    def loss(recon):
        return jls.generator_loss({}, s["dparams"], recon, arrs, darrs, None)

    (j_total, j_terms), j_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(s["recon"]))
    recon = torch.from_numpy(s["recon"]).requires_grad_()
    total, terms = s["pls"].generator_loss(recon, s["pb"], s["pd"])
    (grad,) = torch.autograd.grad(total, recon)
    atol, (g_atol, g_rtol) = TOL[s["dtype"]]
    _assert_terms(terms, j_terms, atol)
    assert set(terms) == {"gen/recon_loss", "gen/g_loss", "gen/total_loss"}
    np.testing.assert_allclose(float(total.detach()), float(j_total), atol=atol, rtol=0)
    # L1 part ~1e-3 per entry, the GAN part through 4 disc layers smaller
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), atol=g_atol, rtol=g_rtol)
    assert np.abs(np.asarray(j_grad)).max() > 1e-4


def test_discriminator_loss_matches_jax(systems):
    s = systems
    jls, arrs, darrs = s["jls"], s["jb"].device_arrays(), s["jd"].device_arrays()
    # JAX draws its noise from the key it is given; the port takes the draw
    key = jax.random.PRNGKey(9)
    j_total, j_terms = jax.jit(lambda r: jls.discriminator_loss(
        s["dparams"], r, arrs, darrs, key))(jnp.asarray(s["recon"]))
    total, terms = s["pls"].discriminator_loss(
        torch.from_numpy(s["recon"]), s["pb"], s["pd"], noise=torch.from_numpy(s["noise"]))
    atol = TOL[s["dtype"]][0]
    _assert_terms(terms, j_terms, atol)
    assert float(terms["disc/r1_penalty"].detach()) > 0
    np.testing.assert_allclose(float(total.detach()), float(j_total), atol=atol, rtol=0)


def test_stacked_disc_pass_equals_separate_passes(systems):
    """One packed pass over n copies (ids kept non-decreasing, no id 0)
    equals n separate passes."""
    s = systems
    pls, pd = s["pls"], s["pd"]
    rows = torch.from_numpy(s["jb"].patches)
    r = [pls._disc_rows(rows + 0.1 * i, pd) for i in range(3)]
    with torch.no_grad():
        stacked = pls.disc_logits_stacked(r, pd)
        singles = torch.stack([pls.disc_logits(x, pd) for x in r])
    torch.testing.assert_close(stacked, singles, atol=1e-5, rtol=0)
    segs = tloss.stacked_segment_ids(pd["segment_ids"], 3, pd["sample_valid"].shape[0] + 1)
    assert bool((segs[1:] >= segs[:-1]).all()) and bool((segs > 0).all())


def test_per_sample_mean_and_masked_mean():
    vals = torch.tensor([1.0, 2.0, 3.0, 10.0, 99.0])
    seg = torch.tensor([1, 1, 2, 2, 0], dtype=torch.int32)
    mask = torch.tensor([True, True, False, True, True])
    torch.testing.assert_close(tloss._per_sample_mean(vals, seg, mask, 3),
                               torch.tensor([1.5, 10.0]))
    assert float(tloss._masked_mean(torch.tensor([1.0, 5.0, 100.0]),
                                    torch.tensor([True, True, False]))) == 3.0


@pytest.mark.parametrize("weights,samples", [((1.0, 0.0), 24), ((0.0, 0.5), 2),
                                             ((1.0, 0.5), -1)],
                         ids=["perceptual", "gram", "both, all frames"])
def test_perceptual_losses_accepted_and_num_frames_match_jax(weights, samples):
    """A positive ``perceptual_weight`` or ``gram_weight`` builds the loss
    system with LPIPS, and K as JAX builds it: samples + 1, or for -1 the
    static worst case, max_grid[0] x the most samples a batch can hold."""
    perceptual, gram = weights
    cfg = tiny_config(**{"tokenizer.losses.perceptual_weight": perceptual,
                         "tokenizer.losses.gram_weight": gram,
                         "tokenizer.losses.perceptual_samples_per_step": samples})
    jls, pls = JLossSystem(cfg), tloss.LossSystem(Config(cfg.to_dict()))
    assert pls.use_perceptual and jls.use_perceptual
    assert (pls.num_frames, pls.sample_size) == (jls.num_frames, jls.sample_size)
    assert pls.num_frames == (samples + 1 if samples > 0 else
                              4 * jpack.max_samples_for(128, [2, 8, 8], PATCH, 1))
    assert not any(p.requires_grad for p in pls.lpips.parameters())
