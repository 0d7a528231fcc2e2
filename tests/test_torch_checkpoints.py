"""The port's checkpoints (``titok_tpu_torch/train_utils/checkpoints.py``)
and the trainer's save paths, with the behaviours of
``tests/test_checkpoints.py``: periodic-save policy (``save_interval`` 0
means none), re-saving a step is a no-op, ``keep_prior``, host snapshots
(the newer of snapshot and checkpoint wins; none at checkpoint steps), the
time-bounded preemption save, the SIGTERM save at a step boundary,
``init_from_checkpoint`` across disc-off and disc-on states with the VQ
codebook travelling with the encoder; and resume on the CPU, bit for bit:
4 steps straight against 2 steps, a save, a new trainer that resumes, and
2 more. No JAX here."""

import itertools
import json
import os
import shutil
import signal
import threading
import time
import types

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.util import tiny_config
from titok_tpu_torch.config import Config
from titok_tpu_torch.data.packing import build_disc_batch
from titok_tpu_torch.losses.loss_module import LossSystem
from titok_tpu_torch.models.titok import make_titok
from titok_tpu_torch.train_utils.checkpoints import CheckpointManager, restore_weights_only
from titok_tpu_torch.training.train_step import TrainStepBuilder
from titok_tpu_torch.training.trainer import Trainer, synthetic_batches


def _leave_nothing(tmp_path):
    """Remove what a passing test wrote under ``tmp_path``: pytest keeps the
    basetemps of the last three runs, and the checkpoints these tests write
    (150-350 MB each) helped fill the disk in whole runs of the suite. A test
    that fails before this keeps its files."""
    for p in tmp_path.iterdir():
        if p.is_dir():
            shutil.rmtree(p)
        else:
            p.unlink()


VQ = {"tokenizer.model.quantizer": "vq",
      "tokenizer.model.vq": {"codebook_size": 64, "dim": 4}}


def _cfg(tmp_path=None, **over) -> Config:
    cfg = Config(tiny_config(**over).to_dict())
    cfg.set_dotted("training.main.attn_impl", "flash_v1")
    cfg.set_dotted("dataset.train_dataset", "synthetic")
    cfg.set_dotted("dataset.eval_dataset", "synthetic")
    if tmp_path is not None:
        cfg.set_dotted("general.checkpoints.save_path", str(tmp_path))
    return cfg


def _state(cfg, seed=0):
    builder = TrainStepBuilder(make_titok(cfg), LossSystem(cfg), cfg)
    batch = None
    if cfg.tokenizer.model.get("quantizer", "fsq") == "vq":
        from titok_tpu_torch.data.packing import to_device

        batch = to_device(next(synthetic_batches(cfg, seed=seed)), "cpu")
    return builder.init_state(seed=seed, device="cpu", batch=batch)


def _same(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_save_interval_zero_disables_periodic_saves(tmp_path):
    state = _state(_cfg())
    ckpt = CheckpointManager(str(tmp_path / "ck"), save_interval=0)
    assert ckpt.maybe_save(1, state) is False
    assert ckpt.maybe_save(1000, state) is False
    assert ckpt.latest_step() is None
    assert ckpt.save(7, state)  # explicit saves still work (final / preemption)
    assert ckpt.latest_step() == 7


def test_periodic_policy_resave_and_keep_prior(tmp_path):
    """orbax's policy: the first save whatever the step, then multiples of
    the interval above the newest; re-saving a step is a no-op; the
    ``keep_prior`` newest stay (-1: all)."""
    state = _state(_cfg())
    ckpt = CheckpointManager(str(tmp_path / "ck"), save_interval=4, keep=2)
    saved = [s for s in range(13) if ckpt.maybe_save(s, state)]
    assert saved == [0, 4, 8, 12]
    assert ckpt.all_steps() == [8, 12]
    assert ckpt.save(12, state) is False  # no raise, nothing written
    assert ckpt.maybe_save(11, state) is False  # below the newest
    keep_all = CheckpointManager(str(tmp_path / "all"), save_interval=1, keep=-1)
    for s in range(4):
        keep_all.save(s, state)
    assert keep_all.all_steps() == [0, 1, 2, 3]
    assert not [n for n in os.listdir(ckpt.directory) if "tmp" in n]
    _leave_nothing(tmp_path)


def test_host_snapshot_newer_wins(tmp_path):
    cfg = _cfg()
    state = _state(cfg, seed=1)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    ckpt = CheckpointManager(str(tmp_path / "ck"), save_interval=1)
    state.step = 2
    ckpt.save(2, state)
    state.step = 5
    ckpt.save_snapshot(5, state)
    assert ckpt.latest_snapshot_step() == 5

    fresh = _state(cfg, seed=2)
    assert not _same(fresh.model.state_dict(), want)
    restored = ckpt.restore_newest(fresh)
    assert restored.step == 5  # the snapshot won (5 > 2)
    assert _same(restored.model.state_dict(), want)

    state.step = 7
    ckpt.save(7, state)
    assert ckpt.restore_newest(_state(cfg, seed=3)).step == 7  # a newer checkpoint wins
    state.step = 9
    ckpt.save_snapshot(9, state)
    assert [n for n in os.listdir(ckpt.snapshot_dir) if n.isdigit()] == ["9"]


def test_host_snapshot_skips_checkpoint_steps():
    calls = []
    ckpt = types.SimpleNamespace(save_interval=1000,
                                 save_snapshot=lambda step, state: calls.append(step))
    cfg = Config({"general": {"checkpoints": {"host_snapshot_interval": 250}}})
    trainer = types.SimpleNamespace(config=cfg, ckpt=ckpt)
    for step in (0, 250, 500, 750, 1000, 1250, 2000):
        Trainer._maybe_host_snapshot(trainer, types.SimpleNamespace(step=step), step)
    assert calls == [250, 500, 750, 1250]


def test_preemption_save_is_time_bounded(tmp_path, monkeypatch):
    trainer = Trainer(_cfg(tmp_path / "run"), device="cpu")
    state = _state(trainer.config)
    monkeypatch.setattr(trainer.ckpt, "save", lambda step, st: time.sleep(60))
    t0 = time.time()
    assert trainer._save_with_fallback(state, timeout_s=2.0) is False
    assert time.time() - t0 < 30


def test_disc_off_checkpoint_into_disc_on_state(tmp_path):
    off = _state(_cfg(), seed=1)  # tiny_config: disc_weight 0
    assert off.disc_opt is None
    ckpt = CheckpointManager(str(tmp_path / "ck"), save_interval=1)
    ckpt.save(0, off)
    on = _state(_cfg(**{"tokenizer.losses.disc_weight": 0.4}), seed=2)
    fresh_disc = {k: v.clone() for k, v in on.disc_model.state_dict().items()}
    fresh_opt = on.gen_opt.state_dict()
    report = {}
    restored = restore_weights_only(str(tmp_path / "ck" / "0"), on, report=report)
    assert _same(restored.model.state_dict(), off.model.state_dict())
    assert _same(restored.disc_model.state_dict(), fresh_disc)  # kept its init
    assert len(report["missing"]) == len(fresh_disc)
    assert all(k.startswith("disc/") for k in report["missing"])
    assert restored.step == 0 and restored.gen_opt.state_dict() == fresh_opt


def test_disc_on_checkpoint_into_disc_off_state(tmp_path):
    on = _state(_cfg(**{"tokenizer.losses.disc_weight": 0.4}), seed=1)
    ckpt = CheckpointManager(str(tmp_path / "ck"), save_interval=1)
    ckpt.save(0, on)
    report = {}
    restored = restore_weights_only(str(tmp_path / "ck" / "0"), _state(_cfg(), seed=2),
                                    report=report)
    assert _same(restored.model.state_dict(), on.model.state_dict())
    assert restored.disc_opt is None and report["missing"] == [] == report["mismatched"]


def test_vq_codebook_travels_with_init_from_checkpoint(tmp_path):
    a = _state(_cfg(**VQ), seed=1)
    cb = torch.arange(64 * 4, dtype=torch.float32).reshape(64, 4)
    a.model.quantize.codebook.copy_(cb)
    ckpt = CheckpointManager(str(tmp_path / "ck"), save_interval=1)
    ckpt.save(0, a)
    b = _state(_cfg(**VQ), seed=2)
    assert not torch.equal(b.model.quantize.codebook, cb)
    restored = restore_weights_only(str(tmp_path / "ck" / "0"), b)
    assert torch.equal(restored.model.quantize.codebook, cb)
    assert _same(restored.model.state_dict(), a.model.state_dict())
    # an FSQ state loads the encoder and decoder and reports the codebook
    report = {}
    fsq = restore_weights_only(str(tmp_path / "ck" / "0"), _state(_cfg(), seed=3),
                               report=report)
    assert "quantize.codebook" not in fsq.model.state_dict()
    assert "gen/quantize.codebook" in report["unexpected"]
    vq_sd = a.model.state_dict()
    assert all(torch.equal(v, vq_sd[k]) for k, v in fsq.model.state_dict().items()
               if not k.startswith(("encoder.proj_out", "decoder.proj_in")))


def _two_batches(config, eval=False, seed=0):
    """The synthetic stream with period 2 (the eval stream as it is): a
    trainer restarts its stream on resume, as the JAX package's does, so a
    period-2 stream gives a run resumed at an even step the batches of the
    straight run."""
    if eval:
        return synthetic_batches(config, eval=True, seed=seed)
    return itertools.cycle(list(itertools.islice(synthetic_batches(config, seed=seed), 2)))


def _run(cfg, **over):
    for k, v in over.items():
        cfg.set_dotted(k, v)
    state = Trainer(cfg, batches_fn=_two_batches, device="cpu").fit()
    rows = [json.loads(line) for line in
            open(os.path.join(cfg.general.checkpoints.save_path, "metrics.jsonl"))]
    return state, {r["step"]: {k: v for k, v in r.items() if k.startswith("train/")}
                   for r in rows if "train/gen/total_loss" in r}


def test_resume_is_bit_exact(tmp_path):
    """The GAN recipe (disc on, R1/R2 noise from ``noise_gen``) in f32
    through ``flash_v1``'s plain path: the resumed run's metrics, weights,
    optimizer moments and noise generator equal the straight run's."""
    over = {"tokenizer.losses.disc_weight": 0.4, "training.eval.eval_step_interval": 0,
            "general.checkpoints.save_interval": 0}
    straight, m_straight = _run(_cfg(tmp_path / "a", **over), **{"training.main.max_steps": 4})
    _, m_first = _run(_cfg(tmp_path / "b", **over), **{"training.main.max_steps": 2})
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [2]
    resumed, m_rest = _run(_cfg(tmp_path / "b", **over), **{
        "training.main.max_steps": 4, "general.checkpoints.resume_from_checkpoint": True})
    assert resumed.step == straight.step == 4
    assert {**m_first, **m_rest} == m_straight
    assert len(m_straight) == 4 and m_straight[3]["train/d_lr"] > 0
    assert _same(resumed.model.state_dict(), straight.model.state_dict())
    assert _same(resumed.disc_model.state_dict(), straight.disc_model.state_dict())
    for a, b in ((resumed.gen_opt, straight.gen_opt), (resumed.disc_opt, straight.disc_opt)):
        sa, sb = a.state_dict()["state"], b.state_dict()["state"]
        assert all(_same(sa[i], sb[i]) for i in sb)
    assert torch.equal(resumed.noise_gen.get_state(), straight.noise_gen.get_state())
    _leave_nothing(tmp_path)


def test_sigterm_saves_at_the_step_boundary_and_exits_143(tmp_path):
    """The handler only notes the signal; the loop saves at the next step
    boundary and exits 143. The signal is sent from the loader's thread
    while it packs the third batch."""
    assert threading.current_thread() is threading.main_thread()
    cfg = _cfg(tmp_path / "run", **{"training.main.max_steps": 50,
                                    "training.eval.eval_step_interval": 0,
                                    "general.checkpoints.save_interval": 0})

    def stream(config, eval=False, seed=0):
        for i, batch in enumerate(synthetic_batches(config, eval=eval, seed=seed)):
            if i == 3 and not eval:
                handler = signal.getsignal(signal.SIGTERM)
                if not callable(handler) or handler in (signal.SIG_DFL, signal.SIG_IGN):
                    raise RuntimeError("the trainer installed no SIGTERM handler")
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exc:
        Trainer(cfg, batches_fn=stream, device="cpu").fit()
    assert exc.value.code == 143
    assert signal.getsignal(signal.SIGTERM) is before  # handlers restored
    ckpt = CheckpointManager(str(tmp_path / "run"))
    step = ckpt.latest_step()
    assert step is not None and 1 <= step < 50
    # the save holds every step taken (the loop stops right after the step
    # that saw the flag, before logging it)
    rows = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    assert all(r["step"] < step for r in rows)
    assert ckpt.restore(_state(cfg)).step == step


def test_prefetch_loader_surfaces_errors_and_stops():
    """The loader's thread: an error in the stream reaches the consumer
    after the batches before it; ``stop`` ends the thread of an endless
    stream; ``group=K`` (``steps_per_call``) stacks K batches and their
    extras on a leading axis in one transfer a group, and yields a finite
    stream's last partial group as it is."""
    from titok_tpu_torch.data.prefetch import PrefetchLoader

    cfg = _cfg()

    def failing():
        yield from itertools.islice(synthetic_batches(cfg, seed=0), 2)
        raise ValueError("reader failed")

    got = []
    with pytest.raises(ValueError, match="reader failed"):
        for dev, batch, extras in PrefetchLoader(failing, device="cpu"):
            got.append(batch)
    assert len(got) == 2 and set(dev) >= {"patches", "segment_ids"} and extras == {}

    loader = PrefetchLoader(lambda: synthetic_batches(cfg, seed=0), device="cpu",
                            build_extras=lambda b: {"disc": b})
    dev, batch, extras = next(iter(loader))
    assert torch.equal(dev["patches"], torch.from_numpy(batch.patches))
    loader.stop()
    assert not loader._thread.is_alive()
    seven = list(itertools.islice(synthetic_batches(cfg, seed=0), 7))
    grouped = PrefetchLoader(lambda: iter(seven), device="cpu", group=3,
                             build_extras=lambda b: {"disc": build_disc_batch(b, 4)})
    groups = list(grouped)
    assert [len(b) for _, b, _ in groups] == [3, 3, 1] and grouped.transfers == 3
    for g, (dev, batches, extras) in enumerate(groups):
        assert dev["patches"].shape == (len(batches), *seven[0].patches.shape)
        for j, b in enumerate(batches):
            assert b is seven[3 * g + j]
            assert torch.equal(dev["patches"][j], torch.from_numpy(b.patches))
            want = build_disc_batch(b, 4).device_arrays()
            assert all(torch.equal(extras["disc"][k][j], torch.from_numpy(np.asarray(v)))
                       for k, v in want.items())
