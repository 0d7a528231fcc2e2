"""Train a TiTok-Video tokenizer with the PyTorch/CUDA port, on one card.

Reference-compatible CLI (reference ``train.py:223-286``; the JAX
package's ``train.py``):

    python -m titok_tpu_torch.train config=configs/tiny_fsq16k.yaml [dotted.overrides=...]

e.g. a data-free run on the synthetic stream:

    python -m titok_tpu_torch.train config=configs/tiny_fsq16k.yaml \\
        dataset.train_dataset=synthetic dataset.eval_dataset=synthetic \\
        tokenizer.losses.allow_random_lpips=true training.main.max_steps=100

It runs on the card, with no fallback when none is present; ``--device
cpu`` (anywhere in the arguments; ``main(argv, device="cpu")`` from
Python) runs the plain path on the CPU. The supervisor
``titok_tpu_torch/tools/train_supervised.py`` restarts it after a crash or
a preemption. The parallel modes (``train_devices``, ``cp_devices`` or
``tp_devices`` > 1, ``fsdp``, ``multihost``) are not ported. There is no
compilation cache to set up: the only cache is the kernel build under
``build/torch_kernels/``.
"""

from __future__ import annotations

import sys

import numpy as np

from titok_tpu_torch.config import config_from_cli

PARALLEL_KEYS = ("train_devices", "cp_devices", "tp_devices")


def validate_parallel_config(config) -> None:
    """Raise for the parallel modes, which are not ported yet."""
    cm = config.training.main
    for key in PARALLEL_KEYS:
        if int(cm.get(key, 1)) > 1:
            raise NotImplementedError(
                f"training.main.{key}={cm.get(key)}: the parallel trainers are not ported "
                "yet (ROADMAP.md, 'Parallel modes')")
    for key in ("fsdp", "multihost"):
        if bool(cm.get(key, False)):
            raise NotImplementedError(
                f"training.main.{key}: the parallel trainers are not ported yet (ROADMAP.md, "
                "'Parallel modes')")


def split_device_flag(argv, device=None):
    """``(argv without --device X, X)``; ``device`` when no flag is given."""
    rest = []
    it = iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
            if device is None:
                raise ValueError("--device needs a value, such as cpu or cuda")
        else:
            rest.append(a)
    return rest, device


def main(argv, device=None):
    argv, device = split_device_flag(argv, device)
    config = config_from_cli(argv)
    np.random.seed(int(config.training.main.get("seed", 0)))
    validate_parallel_config(config)
    from titok_tpu_torch.training.trainer import Trainer

    return Trainer(config, device=device).fit()


if __name__ == "__main__":
    main(sys.argv[1:])
