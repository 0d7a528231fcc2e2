"""The eval metrics' networks run in fp32, as the JAX package's do."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def strict_fp32():
    """No grad, no autocast, and TF32 off for cuDNN and cuBLAS, the
    process's flags restored after: a ``bf16-mixed`` run still scores its
    metrics in fp32."""
    was = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad(), torch.autocast("cuda", enabled=False), \
                torch.autocast("cpu", enabled=False):
            yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was
