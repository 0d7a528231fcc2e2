"""The port's trainer, eval metrics and CLI against the JAX package on the
CPU.

``Trainer.fit`` of both packages on a ``tests/util.py`` config (f32, patch
(2, 4, 4), seq 128, synthetic data, 4 steps, eval at 2 and 4): the JAX one
with dense attention, the port's with ``flash_v1`` (its plain path on the
CPU), both from the params of JAX's ``_init_state``, which the port loads
through ``init_from_checkpoint``. The discriminator is off (tiny_config's
``disc_weight: 0``): both packages build it in bf16, where the two
frameworks' roundings already differ by up to 4.5e-3 in one step
(``tests/test_torch_train_step.py``), and its R1/R2 noise is drawn by each
framework's own generator. Every shared key of the two ``metrics.jsonl``
but the timings (``perf/*``) agrees within 1e-4 relative."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_metric_fixtures import SEEDS, i3d_weights  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from tests.util import tiny_config  # noqa: E402
from titok_tpu.metrics.psnr_device import packed_psnr_stats as j_psnr_stats  # noqa: E402
from titok_tpu.metrics.ssim_device import ssim_frames_stats as j_ssim_stats  # noqa: E402
from titok_tpu.ops.frames import build_eval_frame_plan as j_build_eval_frame_plan  # noqa: E402
from titok_tpu.ops.frames import gather_frames as j_gather_frames  # noqa: E402
from titok_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from titok_tpu.training.trainer import synthetic_batches as j_synthetic_batches  # noqa: E402
from titok_tpu_torch import train as cli  # noqa: E402
from titok_tpu_torch.config import Config  # noqa: E402
from titok_tpu_torch.data.packing import to_device  # noqa: E402
from titok_tpu_torch.metrics.psnr_device import packed_psnr_stats  # noqa: E402
from titok_tpu_torch.metrics.ssim_device import ssim_frames_stats  # noqa: E402
from titok_tpu_torch.ops.frames import build_eval_frame_plan, gather_frames  # noqa: E402
from titok_tpu_torch.train_utils.checkpoints import CheckpointManager  # noqa: E402
from titok_tpu_torch.training.train_step import TrainStepBuilder  # noqa: E402
from titok_tpu_torch.training.trainer import Trainer, synthetic_batches  # noqa: E402
from titok_tpu_torch.weights import from_flax_train_state  # noqa: E402


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


def _jcfg(path, **over):
    cfg = tiny_config(**{
        "dataset.train_dataset": "synthetic", "dataset.eval_dataset": "synthetic",
        "general.checkpoints.save_path": str(path), "training.main.max_steps": 4,
        "training.eval.eval_step_interval": 2, **over})
    return cfg


def _rows(path):
    return [json.loads(line) for line in open(os.path.join(path, "metrics.jsonl"))]


def test_fit_matches_jax(tmp_path):
    jcfg = _jcfg(tmp_path / "jax")
    jtrainer = JTrainer(jcfg)
    gen, disc = from_flax_train_state(jtrainer._init_state(0))
    assert disc == {}  # disc off

    # the JAX init as a port checkpoint, for init_from_checkpoint
    pcfg = Config(_jcfg(tmp_path / "port").to_dict())
    pcfg.set_dotted("training.main.attn_impl", "flash_v1")
    trainer = Trainer(pcfg, device="cpu")
    builder = TrainStepBuilder(trainer.model, trainer.loss_system, pcfg)
    init_dir = tmp_path / "init"
    CheckpointManager(str(init_dir)).save(0, builder.init_state(gen_params=gen, device="cpu"))
    pcfg.set_dotted("general.checkpoints.init_from_checkpoint", str(init_dir / "0"))

    jtrainer.fit()
    state = trainer.fit()
    assert state.step == 4
    want, got = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert [r["step"] for r in got] == [r["step"] for r in want]
    keys = 0
    for g, w in zip(got, want):
        shared = {k for k in w if k not in ("step", "time") and not k.startswith("perf/")}
        assert shared == {k for k in g if k not in ("step", "time")
                          and not k.startswith("perf/")}
        for k in shared:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {g['step']}: {k}")
        keys += len(shared)
    evals = [r for r in got if "eval/psnr" in r]
    assert [r["step"] for r in evals] == [2, 4] and all("eval/ssim" in r for r in evals)
    assert keys > 4 * 5
    assert os.path.exists(tmp_path / "port" / "config.yaml")
    assert CheckpointManager(str(tmp_path / "port")).latest_step() == 4
    _leave_nothing(tmp_path)


def test_eval_stream_matches_jax():
    """The eval stream: ``eval_samples`` clips, the partial last batch
    emitted, rows and layout equal to JAX's (bf16 rows at bf16-mixed)."""
    cfg = tiny_config(**{"training.eval.eval_samples": 13, "training.main.precision": "bf16-mixed"})
    want = list(j_synthetic_batches(cfg, eval=True, seed=0))
    got = list(synthetic_batches(Config(cfg.to_dict()), eval=True, seed=0))
    assert len(got) == len(want) > 1
    assert sum(b.num_samples for b in got) == 13
    for a, b in zip(got, want):
        assert a.wire == torch.bfloat16
        np.testing.assert_array_equal(a.patches, np.asarray(b.patches, np.float32))
        for name in ("segment_ids", "token_mask", "token_counts", "grid_sizes", "grids",
                     "sample_valid"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        np.testing.assert_allclose(a.rope_cos, b.rope_cos, atol=0, rtol=0)
    assert to_device(got[0], "cpu")["patches"].dtype == torch.bfloat16


def test_device_metrics_match_jax(rng):
    """``packed_psnr_stats`` and the SSIM path (eval-frame plan, frame
    gather, ``ssim_frames_stats``) on the same packed batch and recon rows
    as JAX's, at 16x24 frames (above the 11x11 window)."""
    cfg = tiny_config(**{"training.sampling.min_grid": [2, 16, 16],
                         "training.sampling.max_grid": [4, 24, 24],
                         "training.sampling.eval_seq_len": 256,
                         "training.eval.eval_samples": 6})
    batch = next(iter(synthetic_batches(Config(cfg.to_dict()), eval=True, seed=1)))
    recon = (np.asarray(batch.patches) + rng.normal(0, 0.3, batch.patches.shape)).astype(np.float32)
    kw = dict(num_frames=24, patch_size=(2, 4, 4), max_grid_hw=(24, 24))
    plan, jplan = build_eval_frame_plan(batch, **kw), j_build_eval_frame_plan(batch, **kw)
    for k, v in jplan.device_arrays().items():
        np.testing.assert_array_equal(getattr(plan, k), v)

    tb = to_device(batch, "cpu")
    jb = {k: jnp.asarray(v) for k, v in batch.device_arrays().items()}
    sse, cnt = packed_psnr_stats(torch.from_numpy(recon), tb)
    jsse, jcnt = j_psnr_stats(jnp.asarray(recon), jb)
    assert float(cnt) == float(jcnt)
    np.testing.assert_allclose(float(sse), float(jsse), rtol=1e-5)

    tplan = to_device(plan, "cpu")
    jp = {k: jnp.asarray(v) for k, v in jplan.device_arrays().items()}
    rec = gather_frames(torch.from_numpy(recon).clamp(-1, 1), tplan, (2, 4, 4))
    tgt = gather_frames(tb["patches"], tplan, (2, 4, 4))
    jrec = j_gather_frames(jnp.clip(jnp.asarray(recon), -1, 1), jp, (2, 4, 4))
    jtgt = j_gather_frames(jb["patches"], jp, (2, 4, 4))
    np.testing.assert_array_equal(rec.numpy(), np.asarray(jrec))
    s_sum, s_cnt = ssim_frames_stats(rec, tgt, tplan["scale"], tplan["weight"])
    j_sum, j_cnt = j_ssim_stats(jrec, jtgt, jp["scale"], jp["weight"])
    assert float(s_cnt) == float(j_cnt) == plan.weight.sum()
    np.testing.assert_allclose(float(s_sum), float(j_sum), rtol=1e-5)


def _write_cfg(tmp_path, **over):
    cfg = Config(_jcfg(tmp_path / "run", **over).to_dict())
    cfg.set_dotted("training.main.attn_impl", "flash_v1")
    path = tmp_path / "cfg.yaml"
    path.write_text(cfg.to_yaml())
    return str(path)


def test_cli_trains_and_resumes_on_cpu(tmp_path, capsys):
    path = _write_cfg(tmp_path, **{"training.main.max_steps": 2,
                                   "training.eval.eval_step_interval": 0})
    state = cli.main([f"config={path}", "general.checkpoints.save_interval=1"], device="cpu")
    assert state.step == 2
    state = cli.main([f"config={path}", "training.main.max_steps=3",
                      "general.checkpoints.resume_from_checkpoint=true"], device="cpu")
    assert state.step == 3 and "resumed from step 2" in capsys.readouterr().out
    rows = _rows(tmp_path / "run")
    assert [r["step"] for r in rows if "train/gen/total_loss" in r] == [0, 1, 2]
    assert CheckpointManager(str(tmp_path / "run")).all_steps() == [2, 3]
    _leave_nothing(tmp_path)


@pytest.mark.parametrize("over", ["training.main.train_devices=2", "training.main.cp_devices=2",
                                  "training.main.tp_devices=4", "training.main.fsdp=true",
                                  "training.main.multihost=true"])
def test_cli_parallel_keys_raise(tmp_path, over):
    with pytest.raises(NotImplementedError, match="ROADMAP.md, 'Parallel modes'"):
        cli.main([f"config={_write_cfg(tmp_path)}", over], device="cpu")


@pytest.mark.parametrize("over,match", [
    # ported: the CLI trains at K = 2, two calls of two steps
    pytest.param("training.main.steps_per_call=2", None,
                 id="training.main.steps_per_call=2-steps_per_call"),
    # ported: FVD raises JAX's RuntimeError without I3D weights, and scores
    # with a seeded converter .npz
    pytest.param("training.eval.log_metrics=[psnr,fvd]", "FVD needs local I3D weights",
                 id="training.eval.log_metrics=[psnr,fvd]-item 11"),
])
def test_unported_trainer_options_raise(tmp_path, over, match):
    if match is None:
        state = cli.main([f"config={_write_cfg(tmp_path)}", over], device="cpu")
        rows = _rows(tmp_path / "run")
        assert state.step == 4
        assert [r["step"] for r in rows if "train/gen/total_loss" in r] == [0, 1, 2, 3]
        assert [r["step"] for r in rows if "eval/psnr" in r] == [2, 4]  # eval every 2
        assert CheckpointManager(str(tmp_path / "run")).all_steps() == [4]
        _leave_nothing(tmp_path)
        return
    with pytest.raises(RuntimeError, match=match):
        cli.main([f"config={_write_cfg(tmp_path)}", over], device="cpu")
    shutil.rmtree(tmp_path / "run")
    npz = tmp_path / "i3d.npz"
    np.savez(npz, **i3d_weights(SEEDS["i3d"]))
    cli.main([f"config={_write_cfg(tmp_path)}", over, f"training.eval.i3d_path={npz}",
              "training.eval.eval_samples=2"], device="cpu")
    fvd = [(r["step"], r["eval/fvd"]) for r in _rows(tmp_path / "run") if "eval/fvd" in r]
    assert [step for step, _ in fvd] == [2, 4] and all(np.isfinite(v) and v >= 0 for _, v in fvd)
    _leave_nothing(tmp_path)
