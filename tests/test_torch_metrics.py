"""The eval metrics slice as a whole on the CPU: the port's ``EvalMetrics``
hub against the JAX package's, the port's ``Trainer.validate`` and the
evaluate CLI's ``token_sweep`` with FVD and JEDi, and the port's host math
on JAX's committed full-width features.

The hubs get the same seeded clips of differing shapes and the same
weights: I3D at full width (seeded, ``tests/torch_metric_fixtures.py``)
with its resize target lowered to 64, as ``tests/test_i3d.py`` does, and
V-JEPA at ``test_tiny``. ``compute()`` agrees: PSNR and SSIM exactly (the
same numpy code), FVD and JEDi within 1e-4 relative. On JAX's committed
features (``jax_metrics.npz``) the port's host math gives JAX's committed
FVD, JEDi, FID, MMD and IS within 1e-6 relative."""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from tests.torch_metric_fixtures import (SEEDS, i3d_weights, metric_scores,  # noqa: E402
                                         vjepa_weights)
from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from tests.util import tiny_config  # noqa: E402
from titok_tpu.metrics.eval_metrics import EvalMetrics as JEvalMetrics  # noqa: E402
from titok_tpu_torch.config import Config  # noqa: E402
from titok_tpu_torch.metrics import image_metrics  # noqa: E402
from titok_tpu_torch.metrics.eval_metrics import EvalMetrics  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "docs", "artifacts", "r4_tiny_lpips_5000_torch", "jax_metrics.npz")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("metric_weights")
    paths = {"i3d": str(d / "i3d.npz"), "vjepa": str(d / "vjepa.npz")}
    np.savez(paths["i3d"], **i3d_weights(SEEDS["i3d"]))
    np.savez(paths["vjepa"], **vjepa_weights(SEEDS["vjepa"], "test_tiny"))
    return paths


def _metric_overrides(weights, metrics) -> dict:
    return {"training.eval.log_metrics": metrics, "training.eval.i3d_path": weights["i3d"],
            "training.eval.jedi_vjepa_params": weights["vjepa"],
            "training.eval.jedi_jepa_model": "test_tiny"}


def _lower_i3d_target(hub_metrics, target: int = 64) -> None:
    fvd = hub_metrics["fvd"][0]
    fvd._get_extractor().target = target


def test_hubs_match_jax(weights):
    cfg = tiny_config(**_metric_overrides(weights, ["psnr", "ssim", "fvd", "jedi"]))
    ours, theirs = EvalMetrics(Config(cfg.to_dict()), device="cpu"), JEvalMetrics(cfg)
    _lower_i3d_target(ours.metrics)
    _lower_i3d_target(theirs.metrics)
    rng = np.random.default_rng(5)
    targets = [rng.uniform(-1, 1, size=(3, *thw)).astype(np.float32)
               for thw in ((4, 40, 48), (6, 48, 40), (8, 32, 56), (5, 36, 36))]
    recons = [(t + rng.normal(0, 0.3, t.shape)).astype(np.float32) for t in targets]
    ours.update(recons[:2], targets[:2])
    ours.update(recons[2:], targets[2:])
    theirs.update(recons, targets)
    got, want = ours.compute(), theirs.compute()
    assert set(got) == set(want) == {"eval/psnr", "eval/ssim", "eval/fvd", "eval/jedi"}
    assert got["eval/psnr"] == want["eval/psnr"] and got["eval/ssim"] == want["eval/ssim"]
    for k in ("eval/fvd", "eval/jedi"):
        assert got[k] > 0, got
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    ours.reset()
    assert not ours.metrics["fvd"][0].real_feats and not ours.metrics["jedi"][0].real


def test_validate_and_token_sweep_land_fvd_and_jedi(weights, tmp_path):
    """``Trainer.validate`` hands the hub every eval batch's clips; the
    scores reach ``metrics.jsonl`` and each ``token_sweep`` row."""
    from titok_tpu_torch.tools.evaluate import token_sweep
    from titok_tpu_torch.training.trainer import Trainer

    cfg = tiny_config(**{"dataset.train_dataset": "synthetic", "dataset.eval_dataset": "synthetic",
                         "training.eval.eval_samples": 3, "training.eval.log_recon_num": 0,
                         "general.checkpoints.save_path": str(tmp_path / "run"),
                         **_metric_overrides(weights, ["psnr", "fvd", "jedi"])})
    trainer = Trainer(Config(cfg.to_dict()), device="cpu")
    _lower_i3d_target(trainer.eval_metrics.metrics)
    state = trainer.builder.init_state(seed=0, device="cpu")
    trainer.validate(state, 0)
    merged = {}
    for line in open(tmp_path / "run" / "metrics.jsonl"):
        merged.update(json.loads(line))
    rows = token_sweep(trainer, state, 0, [1, 8], str(tmp_path / "sweep.jsonl"))
    for scores in (merged, *rows):
        for k in ("eval/fvd", "eval/jedi"):
            assert np.isfinite(scores[k]) and scores[k] >= 0, (k, scores)
    assert [r["token_count"] for r in rows] == [1, 8]
    assert rows[0]["eval/fvd"] != rows[1]["eval/fvd"]


def test_host_math_on_committed_features():
    """The port's ``calculate_fid``, ``mmd_poly`` and ``inception_score``
    on JAX's committed full-width features (11 clips, 124 frames; FVD over
    400-d I3D logits of 5 and 6 clips, FID over 2048-d activations)."""
    with np.load(FIXTURE) as f:
        feats = dict(f)
    got = metric_scores(feats, image_metrics)
    for k, v in got.items():
        np.testing.assert_allclose(v, float(feats[k]), rtol=1e-6, err_msg=k)
