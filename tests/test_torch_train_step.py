"""The port's train step against the JAX package's, on the CPU in f32: the
lr schedule, the optimizer (optax-style clipping, AdamW, non-finite guard)
against the optax chain, and three whole GAN train steps of
``TrainStepBuilder`` from the same params, batches and R1/R2 noise.

The JAX side runs dense attention (``attn_impl: reference``); the port
runs its attention entry point, whose ``autograd.Function`` takes the
plain forward and backward on CPU tensors. Both packages build the
discriminator in bf16 whatever the precision. The GAN-step test runs it
so, and once more with both sides' discriminator rebuilt in f32
(:func:`f32_disc`), where the comparison is of the algorithm alone, not of
two frameworks' bf16 rounding, and holds tighter tolerances."""

import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from tests.util import tiny_config  # noqa: E402
from titok_tpu.data.packing import build_disc_batch as j_build_disc_batch  # noqa: E402
from titok_tpu.losses.loss_module import LossSystem as JLossSystem  # noqa: E402
from titok_tpu.models.titok import make_titok as j_make_titok  # noqa: E402
from titok_tpu.train_utils.lr_schedulers import get_scheduler as j_get_scheduler  # noqa: E402
from titok_tpu.training.train_step import TrainState as JTrainState  # noqa: E402
from titok_tpu.training.train_step import TrainStepBuilder as JTrainStepBuilder  # noqa: E402
from titok_tpu.training.trainer import synthetic_batches as j_synthetic_batches  # noqa: E402
from titok_tpu_torch.config import Config  # noqa: E402
from titok_tpu_torch.data.packing import build_disc_batch, to_device  # noqa: E402
from titok_tpu_torch.losses.loss_module import LossSystem  # noqa: E402
from titok_tpu_torch.models.titok import init_params, make_titok  # noqa: E402
from titok_tpu_torch.train_utils.lr_schedulers import get_scheduler  # noqa: E402
from titok_tpu_torch.training.train_step import TrainStepBuilder, optimizer_step  # noqa: E402
from titok_tpu_torch.training.trainer import synthetic_batches  # noqa: E402
from titok_tpu_torch.weights import from_flax_train_state  # noqa: E402


@pytest.mark.parametrize("warm,total,lr,elr", [(2, 100, 1e-3, 1e-4), (0, 10, 3e-4, 0.0),
                                               (5, 6, 1e-4, 1e-5)])
def test_lr_schedule_matches_jax(warm, total, lr, elr):
    got = get_scheduler("cosine", warm, total, lr, elr)
    want = j_get_scheduler("cosine", warm, total, lr, elr)
    for step in range(total + 3):
        np.testing.assert_allclose(got(step), float(want(step)), atol=1e-9, rtol=1e-6)
    if warm:
        assert got(0) == 0.0
    with pytest.raises(ValueError, match="unknown"):
        get_scheduler("linear", 1, 2)


def test_optimizer_matches_optax_chain(rng):
    """clip_by_global_norm(1.0) -> adamw over 6 steps on a small tree,
    the schedule's lr at each update count, step 3's grads non-finite:
    the guard zeroes them and both optimizers still step (moments decay,
    weight decay applies, the count advances)."""
    shapes = [(7, 5), (5,), (3, 2, 4)]
    params0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]
             for scale in (0.1, 2.0, 0.3, 1.0, 5.0, 0.05)]
    grads[3][1][2] = np.nan
    sched = get_scheduler("cosine", 2, 10, 1e-2, 1e-3)
    j_sched = j_get_scheduler("cosine", 2, 10, 1e-2, 1e-3)

    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(j_sched, b1=0.5, b2=0.96, weight_decay=1e-2, eps=1e-8))
    jp = [jnp.asarray(p) for p in params0]
    opt_state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params0]
    opt = torch.optim.AdamW(tp, lr=0.0, betas=(0.5, 0.96), eps=1e-8, weight_decay=1e-2)
    for k, g in enumerate(grads):
        jg = [jnp.asarray(x) for x in g]
        norm = float(optax.global_norm(jg))
        ok = np.isfinite(norm)
        jg = [jnp.where(ok, x, jnp.zeros_like(x)) for x in jg]
        updates, opt_state = update(jg, opt_state, jp)
        jp = optax.apply_updates(jp, updates)

        t_norm, bad, _ = optimizer_step(opt, tp, [torch.from_numpy(x) for x in g],
                                        sched(k), max_grad_norm=1.0)
        assert float(bad) == (0.0 if ok else 1.0)
        if ok:
            np.testing.assert_allclose(float(t_norm), norm, rtol=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6, rtol=0)
    assert opt.state[tp[0]]["step"] == len(grads)


# (rtol, atol) of the metrics with the bf16 discriminator: [False] every
# metric but [True] the discriminator's per-parameter grad norms
BF16_DISC_TOL = {False: (1e-2, 1e-2), True: (1e-2, 3e-2)}


def to_flax(state_dict: dict) -> dict:
    """A port state dict (numpy) as a nested flax params tree, the inverse
    of ``weights.from_flax_params``: both frameworks start from the port's
    seeded init, and JAX skips its op-by-op ``init``."""
    tree: dict = {}
    for name, val in state_dict.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        if leaf == "weight" and val.ndim == 2:  # Dense: torch [out, in] -> flax kernel [in, out]
            node["kernel"] = jnp.asarray(val.T)
        else:
            node[leaf] = jnp.asarray(val)
    return tree


def f32_disc(pcfg, pls, jls=None):
    """Rebuild the port's discriminator (and the JAX one, when given) to
    compute in f32; both packages build it in bf16."""
    from titok_tpu_torch.models.blocks import PackedEncoder

    pls.disc_model = PackedEncoder(
        model_size=pcfg.discriminator.model.model_size, patch_size=pls.patch_size,
        in_channels=3, out_channels=1, dtype=torch.float32,
        attn_impl=str(pcfg.training.main.get("attn_impl", "auto")))
    if jls is not None:
        jls.disc_model = jls.disc_model.clone(dtype=jnp.float32)


def _configs():
    over = {
        "tokenizer.losses.disc_weight": 0.4,
        "optimizer.warmup_steps": 2,
        "optimizer.learning_rate": 1e-3,
        "training.eval.log_grad_norms": True,
    }
    jcfg = tiny_config(**over)
    pcfg = Config(jcfg.to_dict())
    pcfg.set_dotted("training.main.attn_impl", "auto")
    return jcfg, pcfg


@pytest.mark.parametrize("disc_dtype", ["f32", "bf16"])
def test_three_gan_steps_match_jax(disc_dtype):
    """Metrics agree at every step; after step 1, the first at lr > 0, the
    params agree.

    f32 discriminator: losses, total grad norms, lrs and zeroed counts at
    rtol 1e-4 (atol 1e-6 for the terms near 0); the per-parameter grad
    norms (``log_grad_norms``) at rtol 1e-3, since a small tensor's norm,
    such as a 1-channel bias's, sums few terms and keeps more of the two
    frameworks' rounding. The params at atol 1e-5 on >= 99.9 % of entries
    and within 2*lr everywhere (Adam's m/sqrt(v) turns grad differences of
    1e-7 on near-zero entries into steps of up to lr). Worst case seen on
    the CPU: metrics 4.5e-5 apart relative to their size (per-parameter
    norms 1.2e-4), params 8.0e-7 apart and none past 1e-5.

    bf16 discriminator, as both packages build it: its activations carry
    the two frameworks' different bf16 roundings. Worst case seen on the
    CPU: losses and total grad norms 4.5e-3 apart (logits_relative; sizes
    up to 0.8), the discriminator's per-parameter grad norms 1.2e-2 (sizes
    up to 0.3; near-cancelling ones, such as the output bias's, differ by
    85 % relative), the generator's 4.2e-5. So the metrics are held at
    ``BF16_DISC_TOL`` and the params within 2*lr everywhere."""
    jcfg, pcfg = _configs()
    jbatches = list(itertools.islice(j_synthetic_batches(jcfg, seed=3), 3))
    pbatches = list(itertools.islice(synthetic_batches(pcfg, seed=3), 3))

    jmodel = j_make_titok(jcfg)
    jls = JLossSystem(jcfg)
    ls = LossSystem(pcfg)
    if disc_dtype == "f32":
        f32_disc(pcfg, ls, jls)
    jb = JTrainStepBuilder(jmodel, jls, jcfg)
    jb.make_optimizers()
    jdiscs = [j_build_disc_batch(b, jls.disc_tokens) for b in jbatches]

    pb = TrainStepBuilder(make_titok(pcfg), ls, pcfg)
    gen_sd, disc_sd = init_params(pb.model, 0), ls.init_disc_params(1)
    pstate = pb.init_state(gen_params=gen_sd, disc_params=disc_sd, device="cpu")
    pstep = pb.make_train_step()
    gen_tree, disc_tree = to_flax(gen_sd), to_flax(disc_sd)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), gen_params=gen_tree,
                         gen_opt=jb.gen_tx.init(gen_tree), disc_params=disc_tree,
                         disc_opt=jb.disc_tx.init(disc_tree), rng=jax.random.PRNGKey(0))
    for got, want in zip(from_flax_train_state(jstate), (gen_sd, disc_sd)):
        assert set(got) == set(want)
        assert all(np.array_equal(got[n], want[n]) for n in want)
    jstep = jax.jit(jb.make_train_step({}))

    lr1 = pb.gen_sched(1)
    for k in range(3):
        np.testing.assert_array_equal(pbatches[k].patches, jbatches[k].patches)
        # the noise JAX draws inside its step (train_step.py:234, loss_module.py:264)
        _, noise_key, _ = jax.random.split(jstate.rng, 3)
        sd, P = jdiscs[k].segment_ids.shape[0], jbatches[k].patches.shape[1]
        noise = np.array(jax.random.normal(noise_key, (sd, P), jnp.float32))

        jstate, jm, jidx = jstep(jstate, jbatches[k].device_arrays(),
                                 jdiscs[k].device_arrays(), None)
        pdisc = build_disc_batch(pbatches[k], ls.disc_tokens)
        pstate, pm, pidx = pstep(pstate, to_device(pbatches[k], "cpu"),
                                 to_device(pdisc, "cpu"), noise=torch.from_numpy(noise))
        assert set(pm) == set(jm)
        for key in jm:
            if disc_dtype == "f32":
                rtol, atol = (1e-3 if key.startswith("grad_2.0_norm/") else 1e-4), 1e-6
            else:
                rtol, atol = BF16_DISC_TOL[key.startswith("grad_2.0_norm/disc/")]
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=rtol, atol=atol,
                                       err_msg=f"step {k}: {key}")
        tok = pbatches[k].token_mask
        np.testing.assert_array_equal(pidx.numpy()[tok], np.asarray(jidx)[tok])
        if k == 1:
            assert lr1 > 0
            got_gen, got_disc = pstate.model.state_dict(), pstate.disc_model.state_dict()
            want_gen, want_disc = from_flax_train_state(jstate)
            for got, want in ((got_gen, want_gen), (got_disc, want_disc)):
                diff = np.concatenate([np.abs(got[n].numpy() - w).ravel()
                                       for n, w in want.items()])
                if disc_dtype == "f32":
                    assert (diff <= 1e-5).mean() >= 0.999, (diff > 1e-5).mean()
                assert diff.max() <= 2 * lr1, diff.max()


@pytest.mark.parametrize("key,value,match", [
    # ported: remat is accepted and reaches every transformer stack
    pytest.param("training.main.remat", True, None, id="training.main.remat-True-remat"),
    # ported: the K-step call equals K single steps
    pytest.param("training.main.steps_per_call", 4, None,
                 id="training.main.steps_per_call-4-steps_per_call"),
])
def test_unported_options_raise(key, value, match):
    _, pcfg = _configs()
    pcfg.set_dotted(key, value)
    pb = TrainStepBuilder(make_titok(pcfg), LossSystem(pcfg), pcfg)
    if key == "training.main.steps_per_call":
        _scan_equals_single_steps(pcfg, value)
        return
    pb.make_optimizers()
    stacks = [pb.model.encoder, pb.model.decoder, pb.loss_system.disc_model]
    assert all(m.model_layers.remat for m in stacks)


def _scan_equals_single_steps(pcfg, K):
    """``make_train_step_scan(K)`` on K batches stacked on a leading axis
    (with the discriminator on, its R1/R2 noise drawn from the state's
    generator) trains the same bits as K calls of the single step: params
    of both modules, the noise generator's state, and the metrics and
    indices, which come back stacked ``[K]``, the learning rates on the
    host."""
    states, ls = [], []
    for _ in range(2):
        ls.append(LossSystem(pcfg))
        b = TrainStepBuilder(make_titok(pcfg), ls[-1], pcfg)
        states.append((b, b.init_state(device="cpu")))
    batches = [to_device(b, "cpu") for b in itertools.islice(synthetic_batches(pcfg, seed=3), K)]
    discs = [to_device(build_disc_batch(b, ls[0].disc_tokens), "cpu")
             for b in itertools.islice(synthetic_batches(pcfg, seed=3), K)]
    (b1, one), (bk, many) = states
    step = b1.make_train_step()
    single = [step(one, b, d)[1:] for b, d in zip(batches, discs)]
    stack = lambda ds: {k: torch.stack([d[k] for d in ds]) for k in ds[0]}  # noqa: E731
    many, metrics, indices = bk.make_train_step_scan(K)(many, stack(batches), stack(discs))
    assert one.step == many.step == K and indices.shape == (K, batches[0]["patches"].shape[0])
    for k, v in metrics.items():
        want = [m[k] for m, _ in single]
        if isinstance(v, torch.Tensor):
            assert v.shape == (K,) and torch.equal(v, torch.stack(want)), k
        else:
            np.testing.assert_array_equal(v, want, err_msg=k)
    assert torch.equal(indices, torch.stack([ix for _, ix in single]))
    for a, b in ((one.model, many.model), (one.disc_model, many.disc_model)):
        assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                     b.state_dict().values()))
    assert torch.equal(one.noise_gen.get_state(), many.noise_gen.get_state())


def test_eval_step_runs_the_model_without_grad():
    _, pcfg = _configs()
    pb = TrainStepBuilder(make_titok(pcfg), LossSystem(pcfg), pcfg)
    state = pb.init_state(device="cpu")
    batch = to_device(next(synthetic_batches(pcfg, seed=2)), "cpu")
    recon, indices = pb.make_eval_step()(batch)
    want, aux = state.model(batch)
    assert recon.grad_fn is None and recon.shape == batch["patches"].shape
    torch.testing.assert_close(recon, want.detach())
    assert torch.equal(indices, aux["indices"]) and indices.dtype == torch.int32
