"""The port on the repo's trained checkpoint against the JAX package, on the
CPU.

``docs/artifacts/r4_tiny_lpips_5000`` (step 5000 of
``docs/runs/r4_tiny_lpips/config.yaml``: FSQ [7, 5, 5, 5, 5], tiny width,
``attn_impl: auto``) scored at ``precision: 32`` on the committed eval clips
(``tests/torch_parity_fixtures.py`` says what is committed and how it is
made): JAX's tiny model takes XLA's dense attention on the CPU, the port
the plain version of its attention kernel. Held, at token counts 1, 16 and
128 on the first packed batch (four clips of ``eval_seq_len`` 4096):

- FSQ indices: exact. A miss prints the clip, the token and the distance of
  JAX's value from its rounding boundary;
- reconstructions: within 1e-4 on [-1, 1];
- PSNR within 1e-3 dB and SSIM within 1e-4 of JAX's ``Trainer.validate``;
- the evaluate CLI's ``token_sweep.jsonl`` rows against JAX's
  ``Trainer.validate`` on the same config.

The committed files are held to a fresh computation: the weights to a new
converter run, tensor for tensor; the clips to the port's eval stream; JAX's
results on the first batch to a fresh JAX run. The ``slow`` tests hold
every committed clip (three batches a count) and the 160-clip token sweep
at 1, 4, 16, 64 and 128."""

import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from tests import torch_parity_fixtures as fx  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from titok_tpu_torch.data.chunking import pack_chunks  # noqa: E402
from titok_tpu_torch.metrics.psnr_device import psnr_from_stats  # noqa: E402
from titok_tpu_torch.tools import evaluate  # noqa: E402
from titok_tpu_torch.train_utils.checkpoints import (  # noqa: E402
    CheckpointManager,
    restore_weights_only,
)
from titok_tpu_torch.training.trainer import Trainer  # noqa: E402

BATCH0 = 4  # the clips of the first packed batch, at every count
RECON_ATOL = 1e-4
PSNR_DB = 1e-3
SSIM_ATOL = 1e-4


def port_clip_batches(clips):
    """The port's ``batches_fn`` over committed clips: its eval stream's
    packer, fed from the list."""
    def batches_fn(config, eval: bool = False, seed: int = 0):
        return pack_chunks(config, iter(clips), np.random.default_rng(seed), eval)

    return batches_fn


def port_results(clips, counts, n_clips, save_path) -> dict:
    """The port's f32 results on the first ``n_clips`` of ``clips``, as
    :func:`fx.jax_results` gives JAX's (no ``prebound_<c>``)."""
    config = fx.port_config(save_path, n_clips)
    trainer = Trainer(config, batches_fn=port_clip_batches(clips), device="cpu")
    report = {}
    state = restore_weights_only(fx.WEIGHTS, trainer.builder.init_state(device="cpu"),
                                 report=report)
    assert report["loaded"] == 76 and not report["missing"] and not report["mismatched"]
    step, seen = trainer.builder.make_eval_metrics_step(trainer.device_im), []

    def eval_step(batch, plan=None):
        out = step(batch, plan)
        seen.append(out)
        return out

    trainer._eval_step = eval_step
    res = {}
    for c in counts:
        config.set_dotted("training.sampling.token_range", [c, c])
        trainer._eval_cache = None
        seen.clear()
        scores = trainer.validate(state, fx.STEP)
        idx, rec = [], []
        for batch, (recon, indices, stats) in zip(trainer._eval_cache, seen):
            k, tc, gs = batch.num_samples, batch.token_counts, batch.grid_sizes
            idx += fx.per_clip(indices.numpy(), tc, gs, k)
            offs = np.concatenate([[0], np.cumsum(tc + gs)])
            rec += [recon.numpy()[offs[b]: offs[b + 1]] for b in range(k)]
            for name, v in stats.items():
                res.setdefault(f"{name}_{c}", []).append(float(v))
        res[f"indices_{c}"] = np.stack(idx)
        res[f"recon_{c}"] = rec
        res[f"psnr_{c}"], res[f"ssim_{c}"] = scores["eval/psnr"], scores["eval/ssim"]
    return res


def boundary_distance(prebound: np.ndarray) -> np.ndarray:
    """How far each value FSQ rounds lies from its rounding boundary (the
    nearest half-integer), per token: the smallest over its 5 levels."""
    return np.abs(np.abs(prebound - np.floor(prebound)) - 0.5).min(axis=-1)


def assert_same_indices(got: np.ndarray, want: np.ndarray, prebound: np.ndarray, what: str):
    miss = np.argwhere(got != want)
    if len(miss):
        dist = boundary_distance(prebound)
        lines = [f"clip {i} token {t}: port {got[i, t]}, JAX {want[i, t]}, JAX's value "
                 f"{prebound[i, t].tolist()} lies {dist[i, t]:.3e} from a rounding boundary"
                 for i, t in miss[:20]]
        pytest.fail(f"{what}: {len(miss)} of {got.size} indices differ\n" + "\n".join(lines))


@pytest.fixture(scope="module")
def clips():
    return fx.load_clips()


@pytest.fixture(scope="module")
def committed():
    with np.load(fx.JAX_RESULTS) as f:
        return dict(f)


@pytest.fixture(scope="module")
def jax_batch0(clips):
    return fx.jax_results(clips, fx.COUNTS, n_clips=BATCH0)


@pytest.fixture(scope="module")
def port_batch0(clips, tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as one_torch_thread, which a module fixture runs before
    try:
        return port_results(clips, fx.COUNTS, BATCH0, str(tmp_path_factory.mktemp("port")))
    finally:
        torch.set_num_threads(n)


def test_committed_weights_equal_a_fresh_conversion(tmp_path):
    """``5000/state.pt`` is what the converter writes now, tensor for
    tensor; it holds weights only, so resuming from it raises, naming the
    modes that load it."""
    fresh = torch.load(fx.convert(str(tmp_path)), weights_only=False)
    got = torch.load(fx.WEIGHTS, weights_only=False)
    assert sorted(got) == sorted(fresh) == ["disc", "gen", "step"]
    assert got["step"] == fresh["step"] == fx.STEP and got["disc"] == fresh["disc"] == {}
    assert sorted(got["gen"]) == sorted(fresh["gen"]) and len(got["gen"]) == 76
    for name, t in fresh["gen"].items():
        assert t.dtype == torch.float32 and torch.equal(got["gen"][name], t), name
    with pytest.raises(ValueError, match="weights only.*init_from_checkpoint"):
        CheckpointManager(os.path.dirname(os.path.dirname(fx.WEIGHTS))).restore(None)


def test_chip_smoke_pins_the_committed_fixtures():
    """``chip_smoke.py`` checks the three files by their sha256 first (the
    card machine cannot remake them): its pins are the committed files'."""
    from chip_smoke import PARITY_DIR, PARITY_SHA256, _sha256

    assert PARITY_DIR == fx.FIXTURES
    assert {os.path.join(PARITY_DIR, rel) for rel in PARITY_SHA256} == \
        {fx.WEIGHTS, fx.CLIPS, fx.JAX_RESULTS}
    for rel, want in PARITY_SHA256.items():
        assert _sha256(os.path.join(PARITY_DIR, rel)) == want, rel


def test_converter_takes_the_layouts_jax_restores(tmp_path):
    """The converter resolves what JAX's ``restore_weights_only`` accepts
    (a step dir holding ``default/``, ``<step>/default``, a bare artifact)
    and a run dir (its newest step, or ``--step``)."""
    resolve = fx.converter().resolve
    run = tmp_path / "run"
    for s in (1000, 2000):
        (run / str(s) / "default").mkdir(parents=True)
        (run / str(s) / "default" / "_CHECKPOINT_METADATA").write_text("{}")
    assert resolve(str(run)) == (str(run / "2000" / "default"), 2000)
    assert resolve(str(run), 1000) == (str(run / "1000" / "default"), 1000)
    assert resolve(str(run / "1000")) == (str(run / "1000" / "default"), 1000)
    assert resolve(str(run / "1000" / "default")) == (str(run / "1000" / "default"), 1000)
    assert resolve(fx.ARTIFACT) == (fx.ARTIFACT, 5000)
    with pytest.raises(FileNotFoundError, match="step 3000"):
        resolve(str(run), 3000)


def test_committed_clips_are_the_port_eval_stream(tmp_path, clips):
    """``eval_clips.npz`` holds the first chunks of the port's eval stream of
    the r4 config over ``00000.tar``, byte for byte."""
    fresh = fx.eval_chunks(fx.port_config(str(tmp_path)), fx.N_CLIPS)
    assert len(clips) == len(fresh) == fx.N_CLIPS
    for i, (a, b) in enumerate(zip(clips, fresh)):
        assert a["fps"] == b["fps"] and a["video"].dtype == np.uint8, i
        np.testing.assert_array_equal(a["video"], b["video"], err_msg=f"clip {i}")


def test_committed_jax_results_equal_a_fresh_run(committed, jax_batch0):
    """JAX's results on the first batch now equal the committed ones: the
    indices and values FSQ rounds of its clips, its device sums, and
    ``Trainer.validate``'s scores from them."""
    for c in fx.COUNTS:
        np.testing.assert_array_equal(jax_batch0[f"indices_{c}"],
                                      committed[f"indices_{c}"][:BATCH0])
        np.testing.assert_allclose(jax_batch0[f"prebound_{c}"],
                                   committed[f"prebound_{c}"][:BATCH0], rtol=0, atol=1e-6)
        for name in ("psnr_sse", "psnr_cnt", "ssim_sum", "ssim_cnt"):
            np.testing.assert_allclose(jax_batch0[f"{name}_{c}"], committed[f"{name}_{c}"][:1],
                                       rtol=1e-6, err_msg=f"{name} at {c} tokens")
        assert jax_batch0[f"psnr_{c}"] == pytest.approx(psnr_from_stats(
            committed[f"psnr_sse_{c}"][0], committed[f"psnr_cnt_{c}"][0]), abs=1e-5)
    assert boundary_distance(committed["prebound_128"]).min() > 1e-4  # no near tie committed


@pytest.mark.parametrize("count", fx.COUNTS)
def test_port_matches_jax_on_the_trained_weights(count, committed, jax_batch0, port_batch0):
    """Exact indices, reconstructions within 1e-4, PSNR within 1e-3 dB and
    SSIM within 1e-4, on the first batch at ``count`` tokens."""
    got, want = port_batch0, jax_batch0
    assert_same_indices(got[f"indices_{count}"], want[f"indices_{count}"],
                        committed[f"prebound_{count}"][:BATCH0], f"{count} tokens")
    assert len(got[f"recon_{count}"]) == BATCH0
    for i, (a, b) in enumerate(zip(got[f"recon_{count}"], want[f"recon_{count}"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=RECON_ATOL, err_msg=f"clip {i}")
    assert got[f"psnr_{count}"] == pytest.approx(want[f"psnr_{count}"], abs=PSNR_DB)
    assert got[f"ssim_{count}"] == pytest.approx(want[f"ssim_{count}"], abs=SSIM_ATOL)


def test_evaluate_cli_matches_jax_validate(tmp_path, jax_batch0):
    """``python -m titok_tpu_torch.tools.evaluate --device cpu --ckpt
    <converted> --token-sweep 1,128`` on the r4 config over the first batch
    of the eval tar: its rows carry JAX's keys and JAX's scores. An orbax
    directory is refused with a pointer to the converter; ``--quant`` is
    not ported."""
    out = tmp_path / "eval"
    args = [f"config={fx.R4_CONFIG}", *fx.score_overrides(str(tmp_path / "unused"), BATCH0),
            "--device", "cpu", "--ckpt", os.path.dirname(fx.WEIGHTS), "--token-sweep", "1,128",
            "--out", str(out)]
    evaluate.main(args)
    rows = [json.loads(line) for line in open(out / "token_sweep.jsonl")]
    assert [r["token_count"] for r in rows] == [1, 128]
    for r in rows:
        c = r["token_count"]
        assert set(r) == {"step", "token_count", "quant", "eval/psnr", "eval/ssim"}
        assert r["step"] == fx.STEP and r["quant"] is None
        assert r["eval/psnr"] == pytest.approx(jax_batch0[f"psnr_{c}"], abs=PSNR_DB)
        assert r["eval/ssim"] == pytest.approx(jax_batch0[f"ssim_{c}"], abs=SSIM_ATOL)
    with pytest.raises(ValueError, match="convert_orbax_to_torch"):
        evaluate.main([*args[:-4], "--ckpt", fx.ARTIFACT])
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        evaluate.main([*args, "--quant", "w8a8"])


@pytest.mark.slow
def test_port_matches_jax_on_every_committed_clip(tmp_path, clips, committed):
    """Every committed clip (three batches a count): the port's indices equal
    the committed JAX ones, its scores JAX's; and a fresh JAX run equals the
    whole committed file."""
    fresh = fx.jax_results(clips)
    got = port_results(clips, fx.COUNTS, fx.N_CLIPS, str(tmp_path))
    for c in fx.COUNTS:
        np.testing.assert_array_equal(fresh[f"indices_{c}"], committed[f"indices_{c}"])
        np.testing.assert_allclose(fresh[f"prebound_{c}"], committed[f"prebound_{c}"], atol=1e-6)
        assert_same_indices(got[f"indices_{c}"], committed[f"indices_{c}"],
                            committed[f"prebound_{c}"], f"{c} tokens")
        for a, b in zip(got[f"recon_{c}"], fresh[f"recon_{c}"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=RECON_ATOL)
        assert got[f"psnr_{c}"] == pytest.approx(float(committed[f"psnr_{c}"]), abs=PSNR_DB)
        assert got[f"ssim_{c}"] == pytest.approx(float(committed[f"ssim_{c}"]), abs=SSIM_ATOL)


SWEEP = (1, 4, 16, 64, 128)


@pytest.mark.slow
def test_token_sweep_of_the_eval_set_matches_jax(tmp_path):
    """The rate-distortion sweep of ``docs/runs/r5_rate_distortion`` at
    precision 32 on the CPU: both packages' evaluate CLIs over the 160 clips
    of ``docs/eval_set`` (the r4 config's ``eval_samples`` 1024: every eval
    chunk) at 1, 4, 16, 64 and 128 tokens. Each row within 1e-3 dB and 1e-4
    SSIM of JAX's; the table is printed (run with ``-s``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_evaluate", os.path.join(fx.REPO, "tools", "evaluate.py"))
    jax_evaluate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_evaluate)
    over = [f"config={fx.R4_CONFIG}", "training.main.precision=32",
            f"dataset.eval_dataset={os.path.join(fx.REPO, 'docs', 'eval_set')}"
            "/{00000..00002}.tar", "training.eval.train_probe_dataset=null",
            "--token-sweep", ",".join(map(str, SWEEP))]
    jax_evaluate.main([*over, "--ckpt", fx.ARTIFACT, "--out", str(tmp_path / "jax")])
    evaluate.main([*over, "--device", "cpu", "--ckpt", os.path.dirname(fx.WEIGHTS),
                   "--out", str(tmp_path / "port")])
    want, got = ([json.loads(line) for line in open(tmp_path / d / "token_sweep.jsonl")]
                 for d in ("jax", "port"))
    print("\n| tokens | port PSNR (dB) | JAX PSNR (dB) | port SSIM | JAX SSIM |")
    for g, w in zip(got, want):
        print(f"| {g['token_count']} | {g['eval/psnr']:.6f} | {w['eval/psnr']:.6f} | "
              f"{g['eval/ssim']:.6f} | {w['eval/ssim']:.6f} |")
    assert [r["token_count"] for r in got] == [r["token_count"] for r in want] == list(SWEEP)
    for g, w in zip(got, want):
        assert g["eval/psnr"] == pytest.approx(w["eval/psnr"], abs=PSNR_DB)
        assert g["eval/ssim"] == pytest.approx(w["eval/ssim"], abs=SSIM_ATOL)
