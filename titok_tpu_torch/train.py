"""Train a TiTok-Video tokenizer with the PyTorch/CUDA port, on one card.

Reference-compatible CLI (reference ``train.py:223-286``; the JAX
package's ``train.py``):

    python -m titok_tpu_torch.train config=configs/tiny_fsq16k.yaml [dotted.overrides=...]

e.g. a data-free run on the synthetic stream:

    python -m titok_tpu_torch.train config=configs/tiny_fsq16k.yaml \\
        dataset.train_dataset=synthetic dataset.eval_dataset=synthetic \\
        tokenizer.losses.allow_random_lpips=true training.main.max_steps=100

It runs on the card; ``main(argv, device="cpu")`` runs the plain path on
the CPU. The parallel modes (``train_devices``, ``cp_devices`` or
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
                "yet (ROADMAP queue 1 item 13)")
    for key in ("fsdp", "multihost"):
        if bool(cm.get(key, False)):
            raise NotImplementedError(
                f"training.main.{key}: the parallel trainers are not ported yet (ROADMAP "
                "queue 1 item 13)")


def main(argv, device=None):
    config = config_from_cli(argv)
    np.random.seed(int(config.training.main.get("seed", 0)))
    validate_parallel_config(config)
    from titok_tpu_torch.training.trainer import Trainer

    return Trainer(config, device=device).fit()


if __name__ == "__main__":
    main(sys.argv[1:])
