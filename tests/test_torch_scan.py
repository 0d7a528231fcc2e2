"""``training.main.steps_per_call`` in the port against K = 1 and against the
JAX package's ``_fit_scan``, on the CPU.

- ``Trainer.fit`` at K = 3 and ``max_steps`` 7 (two calls and a tail of
  1): its ``metrics.jsonl`` steps, eval steps and checkpoint steps follow
  the interval crossings of JAX's ``_fit_scan`` on the same config, and its
  values agree with JAX's within 1e-4 relative (the port starts from JAX's
  init, as ``tests/test_torch_trainer.py`` does; the discriminator is off,
  for the reason that file gives); and it trains the same bits as K = 1
  (params, and every logged metric but the timings). The K-step call with
  the discriminator on is held to K single steps bit for bit in
  ``tests/test_torch_train_step.py``;
- SIGTERM under K > 1: the save at the end of the call, exit 143.

Tiny shapes: ``tests/util.py``'s config (f32, patch (2, 4, 4), seq 128,
synthetic clips)."""

import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from tests.util import tiny_config  # noqa: E402
from titok_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from titok_tpu_torch.config import Config  # noqa: E402
from titok_tpu_torch.losses.loss_module import LossSystem  # noqa: E402
from titok_tpu_torch.models.titok import make_titok  # noqa: E402
from titok_tpu_torch.train_utils.checkpoints import CheckpointManager  # noqa: E402
from titok_tpu_torch.training.train_step import TrainStepBuilder  # noqa: E402
from titok_tpu_torch.training.trainer import Trainer, synthetic_batches  # noqa: E402
from titok_tpu_torch.weights import from_flax_train_state  # noqa: E402

# the scan cells of tests/test_trainer_integration.py: 7 steps at K 3, a
# tail of 1; eval and checkpoints every 2 steps, so each call's window
# crosses a multiple
OVER = {"dataset.train_dataset": "synthetic", "dataset.eval_dataset": "synthetic",
        "training.main.max_steps": 7, "training.eval.eval_step_interval": 2,
        "general.checkpoints.save_interval": 2, "general.checkpoints.keep_prior": -1}


def _pcfg(path, **over) -> Config:
    cfg = Config(tiny_config(**{**OVER, "general.checkpoints.save_path": str(path),
                                **over}).to_dict())
    cfg.set_dotted("training.main.attn_impl", "auto")
    return cfg


def _rows(path) -> list[dict]:
    return [json.loads(line) for line in open(os.path.join(path, "metrics.jsonl"))]


def _values(rows) -> list[dict]:
    return [{k: v for k, v in r.items() if k != "time" and not k.startswith("perf/")}
            for r in rows]


def _same(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _leave_nothing(tmp_path):
    for p in tmp_path.iterdir():
        shutil.rmtree(p) if p.is_dir() else p.unlink()


def test_fit_scan_matches_k1_and_jax_fit_scan(tmp_path):
    """From JAX's init: the port at K = 3 against JAX's ``_fit_scan``, the
    same rows at the same steps (train rows 0-6; eval at the crossings 3
    and 6 and the final 7), the same checkpoint steps (3 and 6 at the
    crossings, 7 at the end), values within 1e-4 relative; and against the
    port at K = 1 (no eval, no periodic save): the same bits, params and
    every train row."""
    k3 = {"training.main.steps_per_call": 3}
    jcfg = tiny_config(**{**OVER, **k3, "general.checkpoints.save_path": str(tmp_path / "jax")})
    jtrainer = JTrainer(jcfg)
    init, gen = jtrainer._init_state, {}

    def keep_init(seed):  # JAX's init, read before its fit donates it
        state = init(seed)
        gen.update(from_flax_train_state(state)[0])
        return state

    jtrainer._init_state = keep_init
    jtrainer.fit()
    init_dir = tmp_path / "init"
    cfg = _pcfg(tmp_path / "unused")
    CheckpointManager(str(init_dir)).save(0, TrainStepBuilder(
        make_titok(cfg), LossSystem(cfg), cfg).init_state(gen_params=gen, device="cpu"))
    from_jax = {"general.checkpoints.init_from_checkpoint": str(init_dir / "0")}
    three = Trainer(_pcfg(tmp_path / "port", **k3, **from_jax), device="cpu").fit()
    one = Trainer(_pcfg(tmp_path / "k1", **from_jax, **{
        "training.eval.eval_step_interval": 0, "general.checkpoints.save_interval": 0}),
        device="cpu").fit()

    want, got = _values(_rows(tmp_path / "jax")), _values(_rows(tmp_path / "port"))
    assert [(r["step"], "eval/psnr" in r) for r in got] == \
        [(r["step"], "eval/psnr" in r) for r in want]
    assert [r["step"] for r in got if "eval/psnr" in r] == [3, 6, 7]
    for g, w in zip(got, want):
        assert set(g) == set(w), g["step"]
        for k in set(w) - {"step"}:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {g['step']}: {k}")
    jsteps = sorted(int(d) for d in os.listdir(tmp_path / "jax") if d.isdigit())
    assert CheckpointManager(str(tmp_path / "port")).all_steps() == jsteps == [3, 6, 7]

    assert one.step == three.step == 7
    assert _same(one.model.state_dict(), three.model.state_dict())
    train = [r for r in got if "train/gen/total_loss" in r]
    assert _values(_rows(tmp_path / "k1")) == train and len(train) == 7
    _leave_nothing(tmp_path)


def test_sigterm_under_steps_per_call_saves_and_exits_143(tmp_path):
    """A SIGTERM that arrives while the loader packs the fifth batch is
    acted on at the end of the K-step call it arrived in: the state of a
    whole number of calls is saved and the run exits 143."""
    cfg = _pcfg(tmp_path / "run", **{"training.main.max_steps": 50,
                                     "training.main.steps_per_call": 2,
                                     "training.eval.eval_step_interval": 0,
                                     "general.checkpoints.save_interval": 0})

    def stream(config, eval=False, seed=0):
        for i, batch in enumerate(synthetic_batches(config, eval=eval, seed=seed)):
            if i == 4 and not eval:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exc:
        Trainer(cfg, batches_fn=stream, device="cpu").fit()
    assert exc.value.code == 143 and signal.getsignal(signal.SIGTERM) is before
    step = CheckpointManager(str(tmp_path / "run")).latest_step()
    assert step is not None and step % 2 == 0 and 2 <= step < 50
    _leave_nothing(tmp_path)
