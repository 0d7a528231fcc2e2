"""The flash_rope + remat slice of the port against the JAX package on the
CPU, at a tiny size with the large config's FSQ (levels [8, 8, 8, 6, 5]):
``attn_impl: flash_rope`` (RoPE fused into the attention kernels; on CPU
tensors their plain versions) and ``training.main.remat: true``
(checkpointed ``Attn`` and ``GEGLU`` sublayers).

- the tokenizer forward against JAX's ``flash_rope`` in interpret mode;
- one GAN train step against JAX's (with its ``reference`` attention:
  JAX's Pallas interpret mode runs through a host callback, which
  ``nn.remat`` cannot partially evaluate; JAX's own tests hold
  ``flash_rope`` equal to ``reference``, ``tests/test_flash_attention.py``);
- remat against no remat in the port: identical losses and grads;
- the params of a JAX model built with remat load into the port.
"""

import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from tests.util import PATCH, synthetic_videos, tiny_config  # noqa: E402
from titok_tpu.config import Config as JConfig  # noqa: E402
from titok_tpu.data.packing import build_disc_batch as j_build_disc_batch  # noqa: E402
from titok_tpu.data.packing import pack_samples as j_pack_samples  # noqa: E402
from titok_tpu.losses.loss_module import LossSystem as JLossSystem  # noqa: E402
from titok_tpu.models.titok import make_titok as j_make_titok  # noqa: E402
from titok_tpu.training.train_step import TrainState as JTrainState  # noqa: E402
from titok_tpu.training.train_step import TrainStepBuilder as JTrainStepBuilder  # noqa: E402
from titok_tpu.training.trainer import synthetic_batches as j_synthetic_batches  # noqa: E402
from titok_tpu_torch.config import Config  # noqa: E402
from titok_tpu_torch.data.packing import build_disc_batch, pack_samples, to_device  # noqa: E402
from titok_tpu_torch.losses.loss_module import LossSystem  # noqa: E402
from titok_tpu_torch.models.blocks import PackedEncoder  # noqa: E402
from titok_tpu_torch.models.titok import init_params, make_titok  # noqa: E402
from titok_tpu_torch.ops import flash_attention_mh as fa  # noqa: E402
from titok_tpu_torch.training.train_step import TrainStepBuilder  # noqa: E402
from titok_tpu_torch.training.trainer import synthetic_batches  # noqa: E402
from titok_tpu_torch.weights import from_flax_params  # noqa: E402


SLICE = {
    "tokenizer.model.fsq_levels": [8, 8, 8, 6, 5],
    "training.main.attn_impl": "flash_rope",
    "training.main.remat": True,
}


def _configs(**over):
    jcfg = tiny_config(**{**SLICE, "tokenizer.losses.disc_weight": 0.4,
                          "optimizer.learning_rate": 1e-3, **over})
    return jcfg, Config(jcfg.to_dict())


def _to_flax(state_dict: dict) -> dict:
    """A port state dict as a nested flax params tree (the inverse of
    ``from_flax_params``)."""
    tree: dict = {}
    for name, val in state_dict.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        if leaf == "weight" and val.ndim == 2:
            node["kernel"] = jnp.asarray(val.T)
        else:
            node[leaf] = jnp.asarray(val)
    return tree


def _j_init(jcfg, batch):
    """The JAX model's own init, traced with its dense attention: the
    params do not depend on attn_impl, and the Pallas kernels in
    interpret mode would only make the init slower."""
    cfg = JConfig(jcfg.to_dict())
    cfg.set_dotted("training.main.attn_impl", "reference")
    return j_make_titok(cfg).init(jax.random.PRNGKey(0), batch.device_arrays())["params"]


def test_flash_rope_remat_forward_matches_jax():
    """The port's forward (plain rope kernels, f32) against JAX's
    ``flash_rope`` kernels in interpret mode (with remat, which an
    inference forward does not engage), from the JAX model's own init:
    indices exact, recon within 1e-5 (two summation orders of the same
    algorithm; the golden trace holds the unfused path to the same)."""
    jcfg, pcfg = _configs()
    batch = j_pack_samples(synthetic_videos(np.random.default_rng(0), 3), [2, 5, 8],
                           seq_len=128, max_samples=8, patch_size=PATCH)
    jmodel = j_make_titok(jcfg)
    assert jmodel.remat and jmodel.attn_impl == "flash_rope"
    params = _j_init(jcfg, batch)
    with pltpu.force_tpu_interpret_mode():
        want_rec, want_aux = jax.jit(jmodel.apply)({"params": params}, batch.device_arrays())

    module = make_titok(pcfg)
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                            from_flax_params(jax.tree.map(np.asarray, params)).items()})
    pbatch = pack_samples(synthetic_videos(np.random.default_rng(0), 3), [2, 5, 8],
                          seq_len=128, max_samples=8, patch_size=list(PATCH))
    before = dict(fa.launches)
    with torch.no_grad():
        rec, aux = module(to_device(pbatch, "cpu"))
    assert fa.launches == before  # CPU tensors: the plain versions
    tok = pbatch.token_mask
    np.testing.assert_array_equal(aux["indices"].numpy()[tok],
                                  np.asarray(want_aux["indices"])[tok])
    patch = (~tok) & (pbatch.segment_ids > 0)
    np.testing.assert_allclose(rec.numpy()[patch], np.asarray(want_rec)[patch], atol=1e-5,
                               rtol=0)


def test_from_flax_params_of_a_remat_model_loads_into_the_port():
    """flax ``nn.remat`` keeps the parameter names: the params of a JAX
    model built with remat map onto the same state dict as without, and
    load strictly into the port's remat model."""
    jcfg, pcfg = _configs()
    batch = j_pack_samples(synthetic_videos(np.random.default_rng(1), 2), [3, 4],
                           seq_len=128, max_samples=8, patch_size=PATCH)
    trees = {}
    for remat in (True, False):
        jcfg.set_dotted("training.main.remat", remat)
        trees[remat] = from_flax_params(jax.tree.map(np.asarray, _j_init(jcfg, batch)))
    assert set(trees[True]) == set(trees[False])
    module = make_titok(pcfg)
    assert module.encoder.model_layers.remat and module.decoder.model_layers.remat
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in trees[True].items()})
    assert set(module.state_dict()) == set(trees[True])


def _f32_disc(pcfg, pls, jls):
    """Both discriminators rebuilt to compute in f32 (both packages build
    them in bf16), their attn_impl and remat kept, so the comparison is of
    the algorithm."""
    pls.disc_model = PackedEncoder(
        model_size=pcfg.discriminator.model.model_size, patch_size=pls.patch_size,
        in_channels=3, out_channels=1, dtype=torch.float32, attn_impl="flash_rope",
        remat=True)
    jls.disc_model = jls.disc_model.clone(dtype=jnp.float32)


def test_flash_rope_remat_gan_step_matches_jax():
    """One GAN step of the slice's config: the port's plain rope kernels
    under checkpointing against JAX's step under ``nn.remat`` with its
    dense ``reference`` attention (its Pallas interpret mode cannot run
    under ``nn.remat``; JAX's tests hold ``flash_rope`` equal to
    ``reference``), from the same params, batch and R1/R2 noise, both
    discriminators in f32: losses, lrs and grad norms at rtol 1e-4 (atol
    1e-6), indices exact."""
    jcfg, pcfg = _configs()
    jcfg.set_dotted("training.main.attn_impl", "reference")
    (jbatch,) = itertools.islice(j_synthetic_batches(jcfg, seed=3), 1)
    jls, ls = JLossSystem(jcfg), LossSystem(pcfg)
    _f32_disc(pcfg, ls, jls)
    jb = JTrainStepBuilder(j_make_titok(jcfg), jls, jcfg)
    jb.make_optimizers()
    pb = TrainStepBuilder(make_titok(pcfg), ls, pcfg)
    gen_sd, disc_sd = init_params(pb.model, 0), ls.init_disc_params(1)
    pstate = pb.init_state(gen_params=gen_sd, disc_params=disc_sd, device="cpu")
    gen_tree, disc_tree = _to_flax(gen_sd), _to_flax(disc_sd)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), gen_params=gen_tree,
                         gen_opt=jb.gen_tx.init(gen_tree), disc_params=disc_tree,
                         disc_opt=jb.disc_tx.init(disc_tree), rng=jax.random.PRNGKey(0))
    jdisc = j_build_disc_batch(jbatch, jls.disc_tokens)
    _, noise_key, _ = jax.random.split(jstate.rng, 3)
    noise = np.array(jax.random.normal(
        noise_key, (jdisc.segment_ids.shape[0], jbatch.patches.shape[1]), jnp.float32))
    jstate, jm, jidx = jax.jit(jb.make_train_step({}))(
        jstate, jbatch.device_arrays(), jdisc.device_arrays(), None)

    pbatch = next(synthetic_batches(pcfg, seed=3))
    np.testing.assert_array_equal(pbatch.patches, jbatch.patches)
    _, pm, pidx = pb.make_train_step()(
        pstate, to_device(pbatch, "cpu"), to_device(build_disc_batch(pbatch, ls.disc_tokens),
                                                    "cpu"),
        noise=torch.from_numpy(noise))
    assert set(pm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    tok = pbatch.token_mask
    np.testing.assert_array_equal(pidx.numpy()[tok], np.asarray(jidx)[tok])


def test_remat_step_equals_no_remat_step():
    """Checkpointing recomputes the same ops on the same inputs: on the
    CPU the port's remat and non-remat models give identical generator and
    discriminator losses and identical grads of every parameter of both."""
    runs = {}
    for remat in (True, False):
        _, pcfg = _configs(**{"training.main.remat": remat})
        ls = LossSystem(pcfg)
        pb = TrainStepBuilder(make_titok(pcfg), ls, pcfg)
        assert ls.disc_model.model_layers.remat == remat
        state = pb.init_state(seed=0, device="cpu")
        batch = next(synthetic_batches(pcfg, seed=3))
        bt = to_device(batch, "cpu")
        dt = to_device(build_disc_batch(batch, ls.disc_tokens), "cpu")
        noise = torch.from_numpy(np.random.default_rng(5).normal(
            size=(dt["segment_ids"].shape[0], bt["patches"].shape[1])).astype(np.float32))
        recon, _ = state.model(bt)
        g_loss, _ = ls.generator_loss(recon, bt, dt)
        d_loss, _ = ls.discriminator_loss(recon.detach(), bt, dt, noise=noise)
        grads = (torch.autograd.grad(g_loss, list(state.model.parameters()))
                 + torch.autograd.grad(d_loss, list(state.disc_model.parameters())))
        runs[remat] = (g_loss.item(), d_loss.item()), grads
    assert runs[True][0] == runs[False][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1], runs[False][1]))
