"""``optimizer.name: adafactor`` on the port
(``titok_tpu_torch/training/adafactor.py``) against the JAX package's own
optax chain (``titok_tpu/training/train_step.py:make_optimizers``:
``clip_by_global_norm -> scale_by_factored_rms -> clip_by_block_rms(1) ->
ema(bf16) -> add_decayed_weights -> scale_by_learning_rate``, jitted as the
JAX trainer runs it), on the CPU in f32:

- 5 updates of the tiny generator's params (converted by
  ``weights.from_flax_params``) with momentum 0.9 and weight decay 1e-4,
  and of the discriminator's with neither, from seeded numpy grads; the
  fourth update's grads non-finite (the
  guard zeroes them and both still step). Held: the params within
  ``PARAM_TOL * lr`` of JAX's after each update (with momentum 1e-2: a bf16
  momentum that rounds the other way carries a difference of 2^-8 of its
  size into the next updates; worst seen 5.7e-3, and 7.0e-3 in the GAN
  step; without, 1e-3: worst seen 2.4e-4, an f32 ulp of a weight near 1);
  ``v_row``, ``v_col`` and ``v`` within ``MOMENT_RTOL`` (1e-5; worst seen
  3.6e-7); the bf16 momentum at least 99.9 % identical bits (seen 99.989 %,
  99.95 % in the GAN step), every other entry within one bf16 ulp of its
  tensor's largest entry (seen half of one); the counts;
- one GAN train step of ``TrainStepBuilder`` against JAX's, the
  discriminator off (``tests/test_torch_trainer.py`` says why);
- the counterparts of ``tests/test_optimizers.py``: the loss falls on one
  repeated batch, the state is smaller than AdamW's with a bf16 momentum,
  momentum 0 drops the accumulator, an unknown name raises;
- a zeroed step by hand, a checkpoint round trip whose next step is the
  same bits, and a resume with the other optimizer refused. (A resumed run
  bit for bit a straight one: ``chip_smoke.py``'s ``phase_resume_f32``.)"""

import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tests.test_torch_train_step import to_flax  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from tests.util import PATCH, synthetic_videos, tiny_config  # noqa: E402
from titok_tpu.losses.loss_module import LossSystem as JLossSystem  # noqa: E402
from titok_tpu.models.titok import make_titok as j_make_titok  # noqa: E402
from titok_tpu.training.train_step import TrainState as JTrainState  # noqa: E402
from titok_tpu.training.train_step import TrainStepBuilder as JTrainStepBuilder  # noqa: E402
from titok_tpu.training.trainer import synthetic_batches as j_synthetic_batches  # noqa: E402
from titok_tpu_torch.config import Config  # noqa: E402
from titok_tpu_torch.data.packing import pack_samples, to_device  # noqa: E402
from titok_tpu_torch.losses.loss_module import LossSystem  # noqa: E402
from titok_tpu_torch.models.titok import init_params, make_titok  # noqa: E402
from titok_tpu_torch.train_utils.checkpoints import CheckpointManager  # noqa: E402
from titok_tpu_torch.training.adafactor import Adafactor, factored_dims  # noqa: E402
from titok_tpu_torch.training.train_step import TrainStepBuilder, optimizer_step  # noqa: E402
from titok_tpu_torch.training.trainer import synthetic_batches  # noqa: E402
from titok_tpu_torch.weights import from_flax_params  # noqa: E402

PARAM_TOL = {True: 1e-2, False: 1e-3}  # x lr, with and without momentum
MOMENT_RTOL = 1e-5
GAN_MOMENT_RTOL = 1e-3
SAME_BITS = 0.999


def _cfgs(**over):
    jcfg = tiny_config(**{"optimizer.name": "adafactor", **over})
    return jcfg, Config(jcfg.to_dict())


def _flat(tree, prefix=""):
    """A flax-shaped tree (params, or a moment of them) as port names; the
    leaves as numpy, a Dense kernel's under ``weight`` in flax layout."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + ("weight" if k == "kernel" else k)] = np.asarray(v)
    return out


def _port_layout(a: np.ndarray) -> np.ndarray:
    """A flax-layout tensor as the port keeps it (a Dense kernel transposed)."""
    return a.T if a.ndim == 2 else a


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().astype(np.int32)


def _jax_moments(chain_state, flat=_flat) -> tuple[int, dict]:
    """The count and, by port name, the moments (``v_row``, ``v_col``,
    ``v`` and the ema's ``m``, flax layout) of a JAX chain's state."""
    fs = next(s for s in chain_state if hasattr(s, "v_row"))
    ema = [s for s in chain_state if hasattr(s, "ema")]
    parts = {k: flat(getattr(fs, k)) for k in ("v_row", "v_col", "v")}
    if ema:
        parts["m"] = flat(ema[0].ema)
    names = parts["v"].keys()
    return int(fs.count), {n: {k: parts[k][n] for k in parts} for n in names}


def _assert_moments_match(opt: Adafactor, params: dict, count: int, moments: dict,
                          momentum: bool, rtol: float = MOMENT_RTOL, of_max: bool = False):
    """The port's state against JAX's moments (see the module's docstring
    for the tolerances); ``of_max``: ``v_row``, ``v_col`` and ``v`` within
    ``rtol`` of each tensor's largest entry rather than of each entry."""
    same = total = 0
    for name, p in params.items():
        st, want = opt.state[p], moments[name]
        assert st["step"] == count
        for key in ("v_row", "v_col", "v"):
            if key not in st:  # JAX keeps a (1,) placeholder there
                assert want[key].shape == (1,), (name, key)
                continue
            b = _port_layout(want[key]) if key == "v" else want[key]
            np.testing.assert_allclose(st[key].numpy(), b, rtol=0 if of_max else rtol,
                                       atol=rtol * np.abs(b).max() if of_max else 0,
                                       err_msg=f"{name} {key}")
        assert ("m" in st) == ("m" in want) == momentum
        if not momentum:
            continue
        m, b = st["m"], _port_layout(want["m"])
        assert m.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        bt = torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16)
        same += int((_bf16_bits(m) == _bf16_bits(bt)).sum())
        total += m.numel()
        bf = bt.float()
        ulp = 2.0 ** (np.floor(np.log2(bf.abs().max().item())) - 7)
        assert (m.float() - bf).abs().max().item() <= ulp, name
    if momentum:
        assert same / total >= SAME_BITS, same / total


@pytest.mark.parametrize("tree,momentum,wd", [("gen", 0.9, 1e-4), ("disc", 0.0, 0.0)])
def test_adafactor_matches_jax_chain(tree, momentum, wd):
    """The generator's tree under the generator's chain, or the
    discriminator's under its own (lr x ``disc_lr_ratio``), applied tensor
    by tensor on both sides: one jitted update a shape, not one program for
    the whole tree. The grads' global norm stays below ``max_grad_norm``,
    where the chain's global clip is the identity for a tensor alone as for
    the tree (the GAN step below clips)."""
    jcfg, pcfg = _cfgs(**{"optimizer.adafactor_momentum": momentum,
                          "optimizer.weight_decay": wd, "tokenizer.losses.disc_weight": 0.4})
    jb = JTrainStepBuilder(j_make_titok(jcfg), JLossSystem(jcfg), jcfg)
    ls = LossSystem(pcfg)
    pb = TrainStepBuilder(make_titok(pcfg), ls, pcfg)
    pb.make_optimizers()
    max_norm = float(pcfg.training.main.max_grad_norm)
    gen_tx, disc_tx = jb.make_optimizers()
    for tx, sched, sd in ([(gen_tx, pb.gen_sched, init_params(pb.model, 0))] if tree == "gen"
                          else [(disc_tx, pb.disc_sched, ls.init_disc_params(1))]):
        assert sum(factored_dims(tuple(v.shape)) is not None for v in sd.values()) > 0
        jp = {n: {"kernel" if v.ndim == 2 else "x": jnp.asarray(_port_layout(v))}
              for n, v in sd.items()}  # one flax-layout tree a tensor
        jstate = {n: tx.init(t) for n, t in jp.items()}
        update = jax.jit(tx.update)
        params = {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, v in sd.items()}
        opt = pb._optimizer(list(params.values()))
        assert isinstance(opt, Adafactor)
        rng = np.random.default_rng(7)
        names = list(sd)
        for k in range(5):
            g = {n: (rng.normal(size=v.shape) * 1e-4).astype(np.float32) for n, v in sd.items()}
            if k == 3:
                g[names[1]].flat[0] = np.nan
            norm = np.sqrt(sum(float(np.sum(x.astype(np.float64) ** 2)) for x in g.values()))
            ok = bool(np.isfinite(norm))
            assert ok == (k != 3) and (not ok or norm < max_norm)
            for n in names:
                gn = _port_layout(g[n]) if ok else np.zeros_like(_port_layout(g[n]))
                updates, jstate[n] = update({next(iter(jp[n])): jnp.asarray(gn)}, jstate[n],
                                            jp[n])
                jp[n] = optax.apply_updates(jp[n], updates)
            _, bad, _ = optimizer_step(opt, list(params.values()),
                                       [torch.from_numpy(g[n]) for n in params], sched(k),
                                       max_norm)
            assert float(bad) == (0.0 if ok else 1.0)
            diff = np.concatenate([
                np.abs(p.detach().numpy() - _port_layout(np.asarray(next(iter(jp[n].values())))))
                .ravel() for n, p in params.items()])
            assert diff.max() <= PARAM_TOL[bool(momentum)] * sched(k), (k, diff.max())
        moments = {}
        for n, st in jstate.items():
            count, one = _jax_moments(st, flat=lambda t, n=n: {
                n: np.asarray(next(iter(t.values())))})
            assert count == 5
            moments.update(one)
        _assert_moments_match(opt, params, 5, moments, bool(momentum))


def test_adafactor_gan_step_matches_jax():
    """Two train steps of ``TrainStepBuilder`` (the first at lr 0 in the
    warm-up), discriminator off: metrics within 1e-4 relative, params
    within ``PARAM_TOL * lr``, indices identical; the moments as in
    :func:`test_adafactor_matches_jax_chain`, but ``v_row``, ``v_col`` and
    ``v`` within 1e-3 of each tensor's largest entry (worst seen 1.1e-4):
    the two frameworks' grads differ most, relatively, where they nearly
    cancel (2.2e-3 of its own size seen on an entry 3e-4 the size of its
    tensor's largest)."""
    jcfg, pcfg = _cfgs(**{"optimizer.learning_rate": 1e-3})
    pcfg.set_dotted("training.main.attn_impl", "auto")
    jbatches = list(itertools.islice(j_synthetic_batches(jcfg, seed=3), 2))
    pbatches = list(itertools.islice(synthetic_batches(pcfg, seed=3), 2))
    jb = JTrainStepBuilder(j_make_titok(jcfg), JLossSystem(jcfg), jcfg)
    jb.make_optimizers()
    pb = TrainStepBuilder(make_titok(pcfg), LossSystem(pcfg), pcfg)
    gen_sd = init_params(pb.model, 0)
    pstate = pb.init_state(gen_params=gen_sd, device="cpu")
    assert isinstance(pstate.gen_opt, Adafactor) and pstate.disc_opt is None
    pstep = pb.make_train_step()
    tree = to_flax(gen_sd)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), gen_params=tree,
                         gen_opt=jb.gen_tx.init(tree), disc_params={}, disc_opt=(),
                         rng=jax.random.PRNGKey(0))
    jstep = jax.jit(jb.make_train_step({}))
    for k in range(2):
        np.testing.assert_array_equal(pbatches[k].patches, jbatches[k].patches)
        jstate, jm, jidx = jstep(jstate, jbatches[k].device_arrays(), None, None)
        pstate, pm, pidx = pstep(pstate, to_device(pbatches[k], "cpu"), None)
        assert set(pm) == set(jm)
        for key in jm:
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {k}: {key}")
        tok = pbatches[k].token_mask
        np.testing.assert_array_equal(pidx.numpy()[tok], np.asarray(jidx)[tok])
    lr1 = pb.gen_sched(1)
    assert lr1 > 0
    want = from_flax_params(jax.tree_util.tree_map(np.asarray, jstate.gen_params))
    got = pstate.model.state_dict()
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w, rtol=0, atol=PARAM_TOL[True] * lr1,
                                   err_msg=n)
    count, moments = _jax_moments(jstate.gen_opt)
    assert count == 2
    _assert_moments_match(pstate.gen_opt, dict(pstate.model.named_parameters()), 2, moments,
                          True, rtol=GAN_MOMENT_RTOL, of_max=True)


def test_zeroed_step_decays_the_moments_and_applies_weight_decay():
    """A non-finite grad: the guard zeroes it and the optimizer still steps,
    as JAX's chain does on zero grads: the count advances, ``v`` decays
    toward the 1e-30 floor, the update is the decayed momentum plus weight
    decay."""
    torch.manual_seed(0)
    p = torch.nn.Parameter(torch.randn(3, 5))
    opt = Adafactor([p], momentum=0.9, weight_decay=0.1)
    optimizer_step(opt, [p], [torch.randn(3, 5)], 0.5)
    v0, m0, p0 = opt.state[p]["v"].clone(), opt.state[p]["m"].clone(), p.detach().clone()
    grad = torch.zeros(3, 5)
    grad[1, 2] = float("nan")
    _, bad, _ = optimizer_step(opt, [p], [grad], 0.5)
    assert float(bad) == 1.0 and opt.state[p]["step"] == 2
    decay = np.float32(1) - np.float32(2) ** np.float32(-0.8)
    want_v = v0 * float(decay) + float(np.float32(1) - decay) * 1e-30
    assert torch.equal(opt.state[p]["v"], want_v)
    u = m0.float() * float(torch.tensor(0.9, dtype=torch.bfloat16))
    assert torch.equal(opt.state[p]["m"], u.to(torch.bfloat16))
    assert torch.equal(p.detach(), p0 + (u + p0 * 0.1) * float(np.float32(-0.5)))


def _state(pcfg, seed=0):
    pb = TrainStepBuilder(make_titok(pcfg), LossSystem(pcfg), pcfg)
    return pb, pb.init_state(seed=seed, device="cpu")


def test_adafactor_overfit():
    """One repeated batch, packed as ``tests/test_optimizers.py`` packs its
    own: the loss falls below 0.9 of the first in 12 steps; every loss
    finite."""
    _, pcfg = _cfgs()
    pb, state = _state(pcfg)
    step = pb.make_train_step()
    rng = np.random.default_rng(0)
    vids = synthetic_videos(rng, 3)
    batch = to_device(pack_samples(vids, [int(rng.integers(1, 8)) for _ in vids],
                                   seq_len=int(pcfg.training.sampling.train_seq_len),
                                   max_samples=8, patch_size=PATCH), "cpu")
    losses = []
    for _ in range(12):
        state, m, _ = step(state, batch, None)
        losses.append(float(m["gen/total_loss"]))
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < 0.9 * losses[0], losses


def _opt_bytes(opt) -> int:
    return sum(v.numel() * v.element_size() for s in opt.state.values()
               for v in s.values() if isinstance(v, torch.Tensor))


def _stepped(pcfg):
    pb, state = _state(pcfg)
    batch = to_device(next(synthetic_batches(pcfg, seed=1)), "cpu")
    state, _, _ = pb.make_train_step()(state, batch, None)
    return state


def test_adafactor_state_is_smaller_and_bf16_momentum():
    """AdamW keeps 8 B a param (f32 m and v); adafactor the bf16 momentum,
    2 B a param, with the factored vectors, under 0.6 of AdamW's."""
    af = _stepped(_cfgs()[1]).gen_opt
    aw = _stepped(Config(tiny_config().to_dict())).gen_opt
    assert isinstance(aw, torch.optim.AdamW)
    assert _opt_bytes(af) < 0.6 * _opt_bytes(aw)
    states = list(af.state.values())
    assert any("v_row" in s and "v_col" in s for s in states)
    assert {s["m"].dtype for s in states} == {torch.bfloat16}


def test_adafactor_no_momentum_drops_accumulator():
    st = _stepped(_cfgs(**{"optimizer.adafactor_momentum": 0})[1]).gen_opt
    st_m = _stepped(_cfgs()[1]).gen_opt
    assert all("m" not in s for s in st.state.values())
    assert _opt_bytes(st) < _opt_bytes(st_m)


def test_unknown_optimizer_rejected():
    pcfg = Config(tiny_config(**{"optimizer.name": "sgd"}).to_dict())
    pb = TrainStepBuilder(make_titok(pcfg), LossSystem(pcfg), pcfg)
    with pytest.raises(ValueError, match="sgd"):
        pb.make_optimizers()


def _gan_cfg(tmp_path, name="adafactor", **over):
    _, pcfg = _cfgs(**{"optimizer.name": name, "tokenizer.losses.disc_weight": 0.4,
                       "training.main.attn_impl": "flash_v1",
                       "dataset.train_dataset": "synthetic", "dataset.eval_dataset": "synthetic",
                       "training.eval.eval_step_interval": 0,
                       "general.checkpoints.save_interval": 0,
                       "general.checkpoints.save_path": str(tmp_path), **over})
    return pcfg


def test_checkpoint_round_trip_next_step_is_bit_exact(tmp_path):
    """The optimizer's state (counts, factored vectors, bf16 momentum)
    survives a save and a restore into a fresh state, and the next step
    from each is the same bits. (Discriminator off: its bf16 tower is slow
    on the CPU, and its optimizer is the same class; the card's resume
    check runs both.)"""
    pcfg = _gan_cfg(tmp_path, **{"tokenizer.losses.disc_weight": 0.0})
    pb, state = _state(pcfg)
    batches = [to_device(b, "cpu") for b in itertools.islice(synthetic_batches(pcfg, seed=2), 2)]
    step = pb.make_train_step()
    state, _, _ = step(state, batches[0], None)
    ckpt = CheckpointManager(str(tmp_path), save_interval=0)
    assert ckpt.save(1, state)
    pb2, fresh = _state(pcfg, seed=5)
    ckpt.restore(fresh)
    assert fresh.step == 1
    for a, b in ((state.gen_opt, fresh.gen_opt),):
        sa, sb = a.state_dict()["state"], b.state_dict()["state"]
        assert sa.keys() == sb.keys()
        for i in sa:
            assert sa[i].keys() == sb[i].keys()
            for key, v in sa[i].items():
                w = sb[i][key]
                assert (torch.equal(v, w) and v.dtype == w.dtype) if torch.is_tensor(v) \
                    else v == w, (i, key)
    state, m1, _ = step(state, batches[1], None)
    fresh, m2, _ = pb2.make_train_step()(fresh, batches[1], None)
    assert {k: float(v) for k, v in m1.items()} == {k: float(v) for k, v in m2.items()}
    sa, sb = state.model.state_dict(), fresh.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_resume_with_the_other_optimizer_is_refused(tmp_path):
    """An AdamW checkpoint does not load into an adafactor run (nor the
    reverse): the error names both, and the state is left as it was."""
    for saved, running in (("adamw", "adafactor"), ("adafactor", "adamw")):
        pcfg = _gan_cfg(tmp_path / saved, name=saved)
        _, state = _state(pcfg)
        CheckpointManager(str(tmp_path / saved)).save(3, state)
        _, other = _state(_gan_cfg(tmp_path / saved, name=running), seed=4)
        before = {k: v.clone() for k, v in other.model.state_dict().items()}
        with pytest.raises(ValueError, match=f"{saved} state.*optimizer.name={running}"):
            CheckpointManager(str(tmp_path / saved)).restore_newest(other)
        assert other.step == 0
        assert all(torch.equal(before[k], v) for k, v in other.model.state_dict().items())
