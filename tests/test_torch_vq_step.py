"""The port's EMA-VQ GAN train step against the JAX package's, on the CPU
in f32: three steps of ``TrainStepBuilder`` from one carried state (params,
codebook and EMA statistics), the same batches and R1/R2 noise.

Its own file, so that ``--dist loadfile`` puts the jitted JAX step on a
worker of its own. The discriminator computes in f32 on both sides (see
``tests/test_torch_train_step.py``), dense attention on the JAX side and
the attention entry point on the port's (its plain versions on the CPU),
``dead_steps`` large enough that no code is revived: the two programs draw
different random numbers."""

import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_train_step import f32_disc, to_flax  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from tests.util import tiny_config  # noqa: E402
from titok_tpu.data.packing import build_disc_batch as j_build_disc_batch  # noqa: E402
from titok_tpu.losses.loss_module import LossSystem as JLossSystem  # noqa: E402
from titok_tpu.models.titok import make_titok as j_make_titok  # noqa: E402
from titok_tpu.models.vq import VQState  # noqa: E402
from titok_tpu.training.train_step import TrainState as JTrainState  # noqa: E402
from titok_tpu.training.train_step import TrainStepBuilder as JTrainStepBuilder  # noqa: E402
from titok_tpu.training.trainer import synthetic_batches as j_synthetic_batches  # noqa: E402
from titok_tpu_torch.config import Config  # noqa: E402
from titok_tpu_torch.data.packing import build_disc_batch, to_device  # noqa: E402
from titok_tpu_torch.losses.loss_module import LossSystem  # noqa: E402
from titok_tpu_torch.models.titok import init_params, make_titok  # noqa: E402
from titok_tpu_torch.models.vq import STATE_NAMES  # noqa: E402
from titok_tpu_torch.training.train_step import TrainStepBuilder  # noqa: E402
from titok_tpu_torch.training.trainer import synthetic_batches  # noqa: E402
from titok_tpu_torch.weights import from_flax_train_state  # noqa: E402


def _configs():
    over = {
        "tokenizer.model.quantizer": "vq",
        "tokenizer.model.vq": {"codebook_size": 256, "dim": 4, "dead_steps": 10_000},
        "tokenizer.losses.disc_weight": 0.4,
        "optimizer.warmup_steps": 2,
        "optimizer.learning_rate": 1e-3,
    }
    jcfg = tiny_config(**over)
    pcfg = Config(jcfg.to_dict())
    pcfg.set_dotted("training.main.attn_impl", "auto")
    return jcfg, pcfg


def test_three_vq_gan_steps_match_jax():
    """Per step: every metric (losses, ``gen/commit_loss``,
    ``gen/vq_perplexity``, grad norms, lrs, ``vq/dead_code_fraction``) at
    rtol 1e-4 and atol 1e-6, the tolerances of the FSQ GAN-step test with
    the f32 discriminator; the indices at token slots exact; the codebook
    and EMA statistics after the update within 1e-5 (the batch sums of
    latents that carry the two frameworks' rounding, 1e-6 relative, times
    1 - decay, over smoothed counts near 1).

    The carried state is built so that indices can be exact: the
    generator's dense kernels at 4x the reference init (at 1x every token
    latent of a batch sits within about 0.003 of one point), and a
    codebook on a 4^4 grid of spacing 0.6 around the first batch's mean
    latent, so usage spreads and no latent lies within rounding of a tie.
    The data-dependent init (codes drawn from the latents, 5 % jitter) puts
    codes within 1e-4 of each other, and there the two programs' rounding
    flips 60 % of the assignments."""
    jcfg, pcfg = _configs()
    jbatches = list(itertools.islice(j_synthetic_batches(jcfg, seed=4), 3))
    pbatches = list(itertools.islice(synthetic_batches(pcfg, seed=4), 3))

    ls, jls = LossSystem(pcfg), JLossSystem(jcfg)
    f32_disc(pcfg, ls, jls)
    pb = TrainStepBuilder(make_titok(pcfg), ls, pcfg)
    gen_sd, disc_sd = init_params(pb.model, 0), ls.init_disc_params(1)
    for name, w in gen_sd.items():
        if w.ndim == 2 and not name.endswith("mask_token"):
            gen_sd[name] = w * np.float32(4.0)
    pstate = pb.init_state(gen_params=gen_sd, disc_params=disc_sd, device="cpu",
                           batch=to_device(pbatches[0], "cpu"))
    vq = pstate.model.quantize
    with torch.no_grad():
        _, aux = pstate.model.encode_packed(to_device(pbatches[0], "cpu"))
    center = aux["z"][torch.from_numpy(pbatches[0].token_mask)].mean(0).numpy()
    grid = np.stack(np.meshgrid(*[np.arange(4)] * 4, indexing="ij"), -1).reshape(-1, 4)
    cb = (center + 0.6 * (grid - 1.5)).astype(np.float32)
    state0 = {"codebook": cb, "ema_counts": np.ones(256, np.float32), "ema_sums": cb.copy(),
              "ages": np.zeros(256, np.float32)}
    vq.set_state(state0)
    pstep = pb.make_train_step()

    jb = JTrainStepBuilder(j_make_titok(jcfg), jls, jcfg)
    jb.make_optimizers()
    gen_tree, disc_tree = to_flax(gen_sd), to_flax(disc_sd)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), gen_params=gen_tree,
                         gen_opt=jb.gen_tx.init(gen_tree), disc_params=disc_tree,
                         disc_opt=jb.disc_tx.init(disc_tree), rng=jax.random.PRNGKey(0),
                         vq_state=VQState(**{n: jnp.asarray(v) for n, v in state0.items()}))
    carried, _ = from_flax_train_state(jstate)
    for n in STATE_NAMES:
        assert np.array_equal(carried[f"quantize.{n}"], state0[n])
    jstep = jax.jit(jb.make_train_step({}))
    jdiscs = [j_build_disc_batch(b, jls.disc_tokens) for b in jbatches]

    for k in range(3):
        np.testing.assert_array_equal(pbatches[k].patches, jbatches[k].patches)
        _, noise_key, _ = jax.random.split(jstate.rng, 3)
        sd, P = jdiscs[k].segment_ids.shape[0], jbatches[k].patches.shape[1]
        noise = np.array(jax.random.normal(noise_key, (sd, P), jnp.float32))
        jstate, jm, jidx = jstep(jstate, jbatches[k].device_arrays(),
                                 jdiscs[k].device_arrays(), None)
        pdisc = build_disc_batch(pbatches[k], ls.disc_tokens)
        pstate, pm, pidx = pstep(pstate, to_device(pbatches[k], "cpu"),
                                 to_device(pdisc, "cpu"), noise=torch.from_numpy(noise))
        assert set(pm) == set(jm)
        for key in ("gen/commit_loss", "gen/vq_perplexity", "vq/dead_code_fraction"):
            assert key in pm
        for key in jm:
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {k}: {key}")
        if k == 0:  # 28 of 32 tokens on distinct codes; later steps collapse usage
            assert float(pm["gen/vq_perplexity"]) > 16.0
        tok = pbatches[k].token_mask
        np.testing.assert_array_equal(pidx.numpy()[tok], np.asarray(jidx)[tok])
        for n in STATE_NAMES:
            np.testing.assert_allclose(getattr(vq, n).numpy(), np.asarray(getattr(jstate.vq_state, n)),
                                       atol=1e-5, rtol=0, err_msg=f"step {k}: {n}")
    assert not np.allclose(vq.codebook.numpy(), state0["codebook"])


def test_init_state_draws_the_codebook_from_the_first_batch(monkeypatch):
    """Without a codebook in ``gen_params`` the port's ``init_state``
    draws it from the first batch's valid latents (as the JAX package's
    does): every code within the latents' range, usage spread (JAX's
    property test asks perplexity > 4 of 256 after one step); without a
    batch it raises, and without a card unless given ``device="cpu"``."""
    _, pcfg = _configs()
    pcfg.set_dotted("tokenizer.losses.disc_weight", 0.0)
    batch = to_device(next(synthetic_batches(pcfg, seed=4)), "cpu")
    pb = TrainStepBuilder(make_titok(pcfg), LossSystem(pcfg), pcfg)
    with pytest.raises(ValueError, match="first batch"):
        pb.init_state(device="cpu")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pb.init_state(batch=batch)
    state = pb.init_state(device="cpu", batch=batch)
    vq = state.model.quantize
    with torch.no_grad():
        _, aux = state.model.encode_packed(batch)
    z = aux["z"][batch["token_mask"]]
    lo, hi = z.min(0).values, z.max(0).values
    slack = 0.25 * (hi - lo)  # the jitter is 5 % of the std
    assert bool(((vq.codebook >= lo - slack) & (vq.codebook <= hi + slack)).all())
    assert float(aux["perplexity"]) > 4.0
    assert torch.equal(vq.ema_sums, vq.codebook) and torch.equal(vq.ema_counts, torch.ones(256))
