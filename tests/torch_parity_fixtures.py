"""The committed fixtures of the trained-checkpoint parity checks, and the
code that makes them.

The repo's one trained checkpoint, ``docs/artifacts/r4_tiny_lpips_5000``
(orbax, weights only, step 5000 of ``docs/runs/r4_tiny_lpips/config.yaml``),
is scored by both packages on the first eval clips of
``docs/eval_set/00000.tar``. The card machine has neither orbax nor libav,
so what its half of the check reads is committed under
``docs/artifacts/r4_tiny_lpips_5000_torch/``:

- ``5000/state.pt``: the generator in the port's checkpoint format, written
  by ``tools/convert_orbax_to_torch.py --no-disc`` (f32, as trained);
- ``eval_clips.npz``: the first :data:`N_CLIPS` chunks of the port's eval
  stream of the r4 config over that tar (eval transforms, seed 0), as
  uint8 THWC arrays ``clip_<i>`` with their ``fps``, before packing, so any
  token count can be packed from them without a decoder;
- ``jax_f32.npz``: JAX's results on those clips at ``precision: 32`` for
  each count of :data:`COUNTS`: per-clip FSQ indices ``indices_<c>``
  ``[N, c]``, the values FSQ rounds, ``bound(z)`` ``[N, c, 5]``
  (``prebound_<c>``; a value within a hair of a half-integer is a near
  tie), and JAX ``Trainer.validate``'s device sums of each packed batch
  (``psnr_sse_<c>``, ``psnr_cnt_<c>``, ``ssim_sum_<c>``, ``ssim_cnt_<c>``,
  one entry a batch) and its scores over all the clips (``psnr_<c>``,
  ``ssim_<c>``);
- ``jax_w8a16.npz`` and ``jax_w8a8.npz``: the same of JAX's int8 serving
  path (``titok_tpu/serving/quant.py``: the generator's kernels quantized,
  the eval epoch run under its interceptor, as JAX's ``tools/evaluate.py
  --quant`` scores it);
- ``jax_metrics.npz``: the eval metrics' networks of the JAX package at
  full width (I3D, V-JEPA ``vit_large``, InceptionV3) on seeded weights
  (``tests/torch_metric_fixtures.py``) over the committed clips and one
  seeded 16x256x320 clip: I3D logits ``i3d``, V-JEPA pooled features
  ``vjepa``, InceptionV3 ``inception_acts`` and ``inception_logits`` per
  frame, each clip's ``frames``, and JAX's host math on them (``fvd``,
  ``jedi``, ``fid``, ``mmd``, ``is``; see ``metric_scores``).

``tests/test_torch_parity.py`` recomputes them and holds the committed
files to them. Rewrite them with (from the repo root, on a machine with
JAX, orbax and libav)::

    JAX_PLATFORMS=cpu python tests/torch_parity_fixtures.py

and only ``jax_metrics.npz`` (JAX, no orbax or libav; about 5 minutes on
8 cores, V-JEPA-L is about 1.6 TFLOP a clip) with ``... metrics``; it also
prints how far the port on the CPU lies from JAX on the same inputs.
"""

from __future__ import annotations

import itertools
import os
import sys
import tempfile
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4_CONFIG = os.path.join(REPO, "docs", "runs", "r4_tiny_lpips", "config.yaml")
ARTIFACT = os.path.join(REPO, "docs", "artifacts", "r4_tiny_lpips_5000")
FIXTURES = os.path.join(REPO, "docs", "artifacts", "r4_tiny_lpips_5000_torch")
WEIGHTS = os.path.join(FIXTURES, "5000", "state.pt")
CLIPS = os.path.join(FIXTURES, "eval_clips.npz")
JAX_RESULTS = os.path.join(FIXTURES, "jax_f32.npz")
QUANT_MODES = ("w8a16", "w8a8")
JAX_QUANT_RESULTS = {mode: os.path.join(FIXTURES, f"jax_{mode}.npz") for mode in QUANT_MODES}
JAX_METRICS = os.path.join(FIXTURES, "jax_metrics.npz")
EVAL_TAR = os.path.join(REPO, "docs", "eval_set", "00000.tar")
STEP = 5000
COUNTS = (1, 16, 128)
N_CLIPS = 10


def score_overrides(save_path: str, n_clips: int = N_CLIPS) -> list[str]:
    """The r4 config as both packages score it here: f32, the first
    ``n_clips`` eval chunks of ``00000.tar``, the losses off (as the
    evaluate tools switch them off), no recon videos, no train probe."""
    return [f"dataset.eval_dataset={EVAL_TAR}", f"dataset.train_dataset={EVAL_TAR}",
            "training.main.precision=32", f"training.eval.eval_samples={n_clips}",
            "tokenizer.losses.disc_weight=0.0", "tokenizer.losses.perceptual_weight=0.0",
            "tokenizer.losses.gram_weight=0.0", "training.eval.log_recon_num=0",
            "training.eval.train_probe_dataset=null",
            f"general.checkpoints.save_path={save_path}"]


def port_config(save_path: str, n_clips: int = N_CLIPS):
    from titok_tpu_torch.config import load_config

    return load_config(R4_CONFIG, score_overrides(save_path, n_clips))


def eval_chunks(config, n: int) -> list[dict]:
    """The first ``n`` chunks ``{'video': uint8 THWC, 'fps'}`` of the
    port's eval stream of ``config`` (``wds_batches(eval=True, seed=0)``
    up to its packer)."""
    from titok_tpu_torch.data import wds_dataset

    with mock.patch.object(wds_dataset, "pack_chunks", lambda c, chunks, rng, ev: chunks):
        stream = wds_dataset.wds_batches(config, eval=True, seed=0)
    chunks = [{"video": np.ascontiguousarray(c["video"]), "fps": int(c["fps"])}
              for c in itertools.islice(stream, n)]
    stream.close()
    return chunks


def save_clips(path: str, chunks: list[dict]) -> None:
    np.savez_compressed(path, fps=np.asarray([c["fps"] for c in chunks], np.int32),
                        **{f"clip_{i}": c["video"] for i, c in enumerate(chunks)})


def load_clips(path: str = CLIPS) -> list[dict]:
    with np.load(path) as f:
        return [{"video": f[f"clip_{i}"], "fps": int(fps)} for i, fps in enumerate(f["fps"])]


def jax_clip_batches(clips: list[dict]):
    """A JAX ``batches_fn`` over ``clips``: the eval stream's packer
    (``eval_samples`` clips, the partial last batch emitted) fed from the
    list instead of a decoder."""
    from titok_tpu.data.packing import Packer, wire_dtype

    def batches_fn(config, eval: bool = False, seed: int = 0):
        cs = config.training.sampling
        chunks = itertools.islice(iter(clips), int(config.training.eval.eval_samples))
        return Packer(seq_len=int(cs.eval_seq_len if eval else cs.train_seq_len),
                      token_range=cs.token_range, patch_size=list(config.tokenizer.model.patch_size),
                      min_grid=cs.min_grid, dtype=wire_dtype(config),
                      rng=np.random.default_rng(seed), flush_final=eval)(chunks)

    return batches_fn


def per_clip(rows: np.ndarray, token_counts, grid_sizes, n: int) -> list[np.ndarray]:
    """The token rows of each of the first ``n`` samples of a packed
    buffer (``[S, ...]``)."""
    offs = np.concatenate([[0], np.cumsum(np.asarray(token_counts) + np.asarray(grid_sizes))])
    return [rows[offs[b]: offs[b] + int(token_counts[b])] for b in range(n)]


def jax_results(clips: list[dict], counts=COUNTS, n_clips: int = N_CLIPS,
                quant: str | None = None) -> dict:
    """JAX's f32 results on the first ``n_clips`` of ``clips`` at each
    count: ``Trainer.validate`` over them at ``token_range [c, c]`` (its
    scores, and its eval step's device sums per batch), with that step
    wrapped to keep each batch's indices, reconstruction and the values FSQ
    rounds (caught where the model calls FSQ, so nothing runs twice). With
    ``quant`` ('w8a16' or 'w8a8') those of JAX's int8 serving path: the
    quantized kernels, the epochs run under its interceptor. Returns the
    arrays of ``jax_f32.npz`` (or ``jax_<quant>.npz``) plus ``recon_<c>``:
    per clip, the ``[c + grid, P]`` rows of its sample (not committed)."""
    import contextlib

    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    from titok_tpu.config import load_config
    from titok_tpu.models.quantizer import FSQ
    from titok_tpu.serving.quant import make_interceptor, quantize_params
    from titok_tpu.train_utils.checkpoints import restore_raw
    from titok_tpu.training.trainer import Trainer

    fsq_call, bounds = FSQ.__call__, []

    def caught(self, z):
        bounds.append(self.bound(z.astype(jnp.float32)))
        return fsq_call(self, z)

    int8 = nn.intercept_methods(make_interceptor(quant)) if quant else contextlib.nullcontext()
    with tempfile.TemporaryDirectory() as tmp, mock.patch.object(FSQ, "__call__", caught), int8:
        config = load_config(R4_CONFIG, score_overrides(tmp, n_clips))
        trainer = Trainer(config, batches_fn=jax_clip_batches(clips))
        raw = restore_raw(ocp.StandardCheckpointer(), os.path.abspath(ARTIFACT))
        gen = quantize_params(raw["gen_params"]) if quant else raw["gen_params"]
        state = type("State", (), {"gen_params": gen, "vq_state": None})()
        step = trainer.builder.make_eval_metrics_step(trainer.device_im)

        def traced(p, batch, plan, vq):
            bounds.clear()
            return step(p, batch, plan, vq), bounds[0]

        jitted, seen = jax.jit(traced), []

        def eval_step(p, batch, plan, vq=None):
            out, bound = jitted(p, batch, plan, vq)
            seen.append((*out, bound))
            return out

        trainer._eval_step = eval_step
        res = {}
        for c in counts:
            config.set_dotted("training.sampling.token_range", [c, c])
            trainer._eval_cache = None
            seen.clear()
            scores = trainer.validate(state, STEP)
            idx, bnd, rec, sums = [], [], [], {}
            for batch, (recon, indices, stats, bound) in zip(trainer._eval_cache, seen):
                k, tc, gs = batch.num_samples, batch.token_counts, batch.grid_sizes
                idx += per_clip(np.asarray(indices), tc, gs, k)
                bnd += per_clip(np.asarray(bound), tc, gs, k)
                offs = np.concatenate([[0], np.cumsum(tc + gs)])
                rec += [np.asarray(recon)[offs[b]: offs[b + 1]] for b in range(k)]
                for name, v in stats.items():
                    sums.setdefault(name, []).append(float(v))
            res[f"indices_{c}"] = np.stack(idx).astype(np.int32)
            res[f"prebound_{c}"] = np.stack(bnd).astype(np.float32)
            res[f"recon_{c}"] = rec
            res.update({f"{name}_{c}": np.asarray(v, np.float64) for name, v in sums.items()})
            res[f"psnr_{c}"] = np.float64(scores["eval/psnr"])
            res[f"ssim_{c}"] = np.float64(scores["eval/ssim"])
    return res


def converter():
    """``tools/convert_orbax_to_torch.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "convert_orbax_to_torch", os.path.join(REPO, "tools", "convert_orbax_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def convert(out_dir: str) -> str:
    """``tools/convert_orbax_to_torch.py ARTIFACT out_dir --no-disc``;
    returns the ``state.pt`` it wrote."""
    return converter().convert(ARTIFACT, out_dir, disc=False)


def metric_weights(out_dir: str) -> dict[str, str]:
    """The seeded full-width weights of the three networks as converter
    ``.npz`` files under ``out_dir``; returns their paths by network."""
    from tests.torch_metric_fixtures import SEEDS, i3d_weights, inception_weights, vjepa_weights

    paths = {}
    for name, draw in (("i3d", i3d_weights), ("vjepa", vjepa_weights),
                       ("inception", inception_weights)):
        paths[name] = os.path.join(out_dir, f"{name}.npz")
        np.savez(paths[name], **draw(SEEDS[name]))
    return paths


def jax_metrics(weights: dict[str, str], clips: list[np.ndarray]) -> dict:
    """The JAX package's features and scores of ``jax_metrics.npz``."""
    import titok_tpu.metrics.image_metrics as jim
    from tests.torch_metric_fixtures import clip_frames, metric_scores
    from titok_tpu.metrics.i3d import JaxI3DExtractor, load_i3d_params
    from titok_tpu.metrics.inception_v3 import load_inception_extractor
    from titok_tpu.metrics.vjepa import JaxVJEPAExtractor, load_vjepa_params

    i3d = JaxI3DExtractor(load_i3d_params(weights["i3d"]))
    vjepa = JaxVJEPAExtractor(load_vjepa_params(weights["vjepa"]), "vit_large")
    inception = load_inception_extractor(weights["inception"])
    res = {"i3d": [], "vjepa": [], "inception_acts": [], "inception_logits": []}
    for clip in clips:
        res["i3d"].append(i3d(clip))
        res["vjepa"].append(vjepa(clip))
        acts, logits = inception(clip_frames(clip))
        res["inception_acts"].append(acts)
        res["inception_logits"].append(logits)
    res = {k: np.concatenate(v).astype(np.float32) for k, v in res.items()}
    res["frames"] = np.asarray([c.shape[2] for c in clips], np.int32)
    res.update({k: np.float64(v) for k, v in metric_scores(res, jim).items()})
    return res


def port_metric_gaps(weights: dict[str, str], clips: list[np.ndarray], want: dict) -> None:
    """Print, per network, the largest difference of the port's features
    on the CPU from JAX's (``want``), absolute and over JAX's largest."""
    from tests.torch_metric_fixtures import clip_frames
    from titok_tpu_torch.metrics.i3d import I3DExtractor, load_i3d_params
    from titok_tpu_torch.metrics.inception_v3 import load_inception_extractor
    from titok_tpu_torch.metrics.vjepa import VJEPAExtractor, load_vjepa_params

    i3d = I3DExtractor(load_i3d_params(weights["i3d"]), device="cpu")
    vjepa = VJEPAExtractor(load_vjepa_params(weights["vjepa"]), "vit_large", device="cpu")
    inception = load_inception_extractor(weights["inception"], device="cpu")
    got = {"i3d": np.concatenate([i3d(c) for c in clips]),
           "vjepa": np.concatenate([vjepa(c) for c in clips])}
    acts, logits = zip(*(inception(clip_frames(c)) for c in clips))
    got["inception_acts"], got["inception_logits"] = np.concatenate(acts), np.concatenate(logits)
    for k, v in got.items():
        err = np.abs(v - want[k]).max(axis=1)
        rel = err.max() / np.abs(want[k]).max()
        print(f"port on the CPU against JAX, {k}: largest |d| {err.max():.3e} (clip or frame "
              f"{int(err.argmax())}), over JAX's largest |x| {rel:.3e}")


def main_metrics() -> None:
    """Write ``jax_metrics.npz`` alone."""
    import time

    from tests.torch_metric_fixtures import metric_clips

    clips = metric_clips([c["video"] for c in load_clips(CLIPS)])
    with tempfile.TemporaryDirectory() as tmp:
        weights = metric_weights(tmp)
        t0 = time.perf_counter()
        res = jax_metrics(weights, clips)
        print(f"JAX's features of {len(clips)} clips in {time.perf_counter() - t0:.1f} s")
        np.savez(JAX_METRICS, **res)
        port_metric_gaps(weights, clips, res)
    print("JAX's scores: " + ", ".join(f"{k} {float(res[k]):.9g}"
                                       for k in ("fvd", "jedi", "fid", "mmd", "is")))
    print(f"{os.path.relpath(JAX_METRICS, REPO)}: {os.path.getsize(JAX_METRICS)} bytes")


def main() -> None:
    import shutil

    os.makedirs(FIXTURES, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copyfile(convert(tmp), _mkdir(WEIGHTS))
        chunks = eval_chunks(port_config(tmp), N_CLIPS)
    save_clips(CLIPS, chunks)
    for quant, path in ((None, JAX_RESULTS), *JAX_QUANT_RESULTS.items()):
        res = jax_results(load_clips(CLIPS), quant=quant)
        np.savez(path, **{k: v for k, v in res.items() if not k.startswith("recon_")})
        for c in COUNTS:
            print(f"{quant or 'f32'}, tokens {c}: psnr {res[f'psnr_{c}']:.6f} dB, ssim "
                  f"{res[f'ssim_{c}']:.6f}")
    for p in (WEIGHTS, CLIPS, JAX_RESULTS, *JAX_QUANT_RESULTS.values()):
        print(f"{os.path.relpath(p, REPO)}: {os.path.getsize(p)} bytes")
    main_metrics()


def _mkdir(path: str) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if sys.argv[1:] == ["metrics"]:
        main_metrics()
    else:
        main()
