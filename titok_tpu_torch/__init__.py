"""PyTorch/CUDA port of ``titok_tpu`` for NVIDIA Hopper (H100).

Same module layout and names as the JAX package, which stays the
reference. The port imports ``torch``, numpy and yaml only: nothing of JAX,
flax or ``titok_tpu``. Every TPU (Pallas) kernel on a ported path becomes a
hand-written CUDA kernel under ``csrc/``; its plain PyTorch version sits
beside it and is used only for tensors that lie on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` when none is given.

    Raises when no device is given and no card is present, so a run never
    carries on silently on the CPU; pass ``device="cpu"`` for that."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
