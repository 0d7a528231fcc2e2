"""Offline scoring of a checkpoint of the port (the JAX package's
``tools/evaluate.py``): the eval epoch of a config on any saved step.

    python -m titok_tpu_torch.tools.evaluate config=configs/tiny.yaml \\
        dataset.eval_dataset=docs/eval_set/{00000..00002}.tar \\
        --ckpt out_ckpt                 # a run dir: its newest step (or a step dir)
    python -m titok_tpu_torch.tools.evaluate config=... --ckpt out_ckpt --steps all
    python -m titok_tpu_torch.tools.evaluate config=... --ckpt <step dir> \\
        --token-sweep 1,4,16,64,128     # <out>/token_sweep.jsonl

It loads the generator's weights (and EMA-VQ's codebook, a buffer of the
generator) with ``restore_weights_only``, runs ``Trainer.validate`` over
the config's eval set and writes the ``eval/*`` scores (device PSNR/SSIM)
to ``<out>/metrics.jsonl``. ``--token-sweep`` scores the eval set once per
fixed token count instead of the training protocol's random draw: the
rate-distortion curve over the 1-128 token axis. The losses are switched
off, so scoring needs no LPIPS weights and builds no discriminator; an
empty ``dataset.train_dataset`` falls back to the eval set.

A checkpoint of the JAX package (orbax) is converted first with
``python tools/convert_orbax_to_torch.py <orbax dir> <out dir>`` (on a
machine with JAX and orbax). ``--quant`` (the int8 serving path) is not
ported. It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np

from titok_tpu_torch.train_utils.checkpoints import STATE_FILE

FLAGS = ("--ckpt", "--out", "--steps", "--quant", "--token-sweep", "--device")


def _list_steps(run_dir: str) -> list[int]:
    return sorted(int(n) for n in os.listdir(run_dir)
                  if n.isdigit() and os.path.exists(os.path.join(run_dir, n, STATE_FILE)))


def _resolve_ckpts(path: str, steps: str) -> list[tuple[int, str]]:
    """(step, checkpoint dir) pairs for a step dir or a run dir."""
    path = os.path.abspath(path)
    base = os.path.basename(path.rstrip("/"))
    if any(os.path.exists(os.path.join(path, m)) for m in ("_CHECKPOINT_METADATA", "default")):
        raise ValueError(
            f"{path} is an orbax checkpoint of the JAX package; convert it first: python "
            f"tools/convert_orbax_to_torch.py {path} <out dir>, then pass --ckpt <out dir>/<step>")
    if os.path.exists(os.path.join(path, STATE_FILE)):  # a single step dir
        m = re.search(r"(\d+)$", base)
        return [(int(m.group(1)) if m else 0, path)]
    all_steps = _list_steps(path)
    if not all_steps:
        raise FileNotFoundError(f"no checkpoint step dirs under {path}")
    if steps == "all":
        return [(s, os.path.join(path, str(s))) for s in all_steps]
    if steps == "latest":
        return [(all_steps[-1], os.path.join(path, str(all_steps[-1])))]
    want = int(steps)
    if want not in all_steps:
        raise FileNotFoundError(f"step {want} not in {all_steps}")
    return [(want, os.path.join(path, str(want)))]


def token_sweep(trainer, state, step: int, counts, path: str) -> list[dict]:
    """Score the eval set once per token count of ``counts``: for each,
    ``training.sampling.token_range = [c, c]``, the packed eval cache
    dropped (the batches repack at the new count) and one
    ``trainer.validate``; each row (``step``, ``token_count``, ``quant``
    and the ``eval/*`` scores) is appended to ``path`` as a JSON line.
    Returns the rows."""
    trainer.config.set_dotted("training.eval.train_probe_dataset", None)
    trainer.config.set_dotted("training.eval.log_recon_num", 0)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    rows = []
    with open(path, "a") as f:
        for c in counts:
            trainer.config.set_dotted("training.sampling.token_range", [int(c), int(c)])
            trainer._eval_cache = None
            scores = trainer.validate(state, step) or {}
            row = {"step": int(step), "token_count": int(c), "quant": None,
                   **{k: float(v) for k, v in scores.items()}}
            f.write(json.dumps(row) + "\n")
            f.flush()
            print(f"tokens={int(c):4d}  " + "  ".join(
                f"{k}={v:.4g}" for k, v in row.items() if k.startswith("eval/")))
            rows.append(row)
    return rows


def main(argv: list[str], device=None):
    flags, cfg_args = [], []
    it = iter(argv)
    for a in it:
        if a in FLAGS:
            flags += [a, next(it)]
        else:
            cfg_args.append(a)
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help="checkpoint step dir, or a run dir (see --steps)")
    ap.add_argument("--out", default=None, help="metrics output dir (default <ckpt>/eval)")
    ap.add_argument("--steps", default="latest",
                    help="'latest' (default), 'all', or a step number, for a run-dir --ckpt")
    ap.add_argument("--token-sweep", default=None,
                    help="comma-separated token counts (e.g. '1,4,16,64,128'): score the eval "
                         "set once per fixed count; writes <out>/token_sweep.jsonl")
    ap.add_argument("--quant", choices=("w8a16", "w8a8"), default=None,
                    help="the int8 serving path (not ported)")
    ap.add_argument("--device", default=device, help="'cpu' for the plain path (default: cuda)")
    args = ap.parse_args(flags)
    if args.quant:
        raise NotImplementedError(
            f"--quant {args.quant}: the int8 serving path is not ported yet (ROADMAP queue 1 "
            "item 9)")

    from titok_tpu_torch.config import config_from_cli

    config = config_from_cli(cfg_args)
    # scoring needs no loss system: no LPIPS weights, no discriminator
    for key in ("disc_weight", "perceptual_weight", "gram_weight"):
        config.set_dotted(f"tokenizer.losses.{key}", 0.0)
    if not str(config.dataset.train_dataset):
        config.set_dotted("dataset.train_dataset", str(config.dataset.eval_dataset))

    ckpts = _resolve_ckpts(args.ckpt, args.steps)
    out = args.out or os.path.join(os.path.abspath(args.ckpt), "eval")
    config.set_dotted("general.checkpoints.save_path", out)
    config.set_dotted("general.checkpoints.resume_from_checkpoint", None)
    config.set_dotted("general.checkpoints.init_from_checkpoint", None)

    from titok_tpu_torch.data.packing import to_device
    from titok_tpu_torch.train_utils.checkpoints import restore_weights_only
    from titok_tpu_torch.training.trainer import Trainer

    np.random.seed(int(config.training.main.get("seed", 0)))
    trainer = Trainer(config, device=args.device)
    probe = None  # EMA-VQ's codebook init wants a batch; the checkpoint's replaces it
    if trainer.model.quantizer == "vq":
        probe = to_device(next(iter(trainer.batches_fn(config, eval=True, seed=0))),
                          trainer.device)
    state = trainer.builder.init_state(device=trainer.device, batch=probe)
    results = []
    for step, ckpt_dir in ckpts:
        state = restore_weights_only(ckpt_dir, state)
        if args.token_sweep:
            counts = [int(x) for x in args.token_sweep.split(",")]
            results += token_sweep(trainer, state, step, counts,
                                   os.path.join(out, "token_sweep.jsonl"))
        else:
            results.append(trainer.validate(state, step))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
