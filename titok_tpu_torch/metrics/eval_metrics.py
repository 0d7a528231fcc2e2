"""Config-selected eval metric hub on the host (the JAX package's
``titok_tpu/metrics/eval_metrics.py``).

``update(recon, target)`` consumes *lists of CTHW numpy clips* unpacked
on the host from the eval step's packed reconstruction; reconstructions
are clamped to [-1, 1] first. Image metrics (PSNR, SSIM) see T as the
batch dim; video metrics (FVD, JEDi) get one BCTHW clip with B = 1 and run
their networks on ``device``. The trainer keeps PSNR and SSIM on the
device where it can and passes them as ``skip``; this hub takes what is
left. Config keys: ``training.eval.i3d_path`` (FVD), and
``jedi_jepa_model``, ``jedi_vjepa_params``, ``jedi_extractor_path``
(JEDi); or the ``TITOK_I3D_PATH``, ``TITOK_VJEPA_PARAMS`` and
``TITOK_JEDI_PATH`` environment variables.
"""

from __future__ import annotations

import numpy as np

from titok_tpu_torch.metrics.fvd import FVDCalculator
from titok_tpu_torch.metrics.jedi import JEDiMetric
from titok_tpu_torch.metrics.psnr_ssim import PSNRMetric, SSIMMetric


class EvalMetrics:
    def __init__(self, config, eval_prefix: str = "eval", skip=(), device=None):
        """``skip``: metric names handled elsewhere (on the device, inside
        the eval step) and left out of this hub. ``device``: where the
        video metrics' networks run (``cuda`` when None)."""
        self.eval_prefix = eval_prefix
        self.metrics: dict[str, tuple[object, str]] = {}
        ce = config.training.eval
        for m in ce.log_metrics:
            if m in skip:
                continue
            if m == "psnr":
                self.metrics[m] = (PSNRMetric(data_range=2.0), "image")
            elif m == "ssim":
                self.metrics[m] = (SSIMMetric(data_range=2.0), "image")
            elif m == "fvd":
                self.metrics[m] = (FVDCalculator(i3d_path=ce.get("i3d_path", None),
                                                 device=device), "video")
            elif m == "jedi":
                self.metrics[m] = (JEDiMetric(
                    model_name=ce.get("jedi_jepa_model", "vit_large"),
                    extractor_path=ce.get("jedi_extractor_path", None),
                    vjepa_params_path=ce.get("jedi_vjepa_params", None),
                    device=device), "video")
            else:
                raise ValueError(f"unknown eval metric {m!r}")

    def update(self, recon: list, target: list) -> None:
        for x, y in zip(recon, target):
            x = np.clip(np.asarray(x, np.float32), -1, 1)
            y = np.asarray(y, np.float32)
            for metric, kind in self.metrics.values():
                if kind == "image":  # CTHW -> TCHW (T becomes batch)
                    metric.update(x.transpose(1, 0, 2, 3), y.transpose(1, 0, 2, 3))
                else:
                    metric.update(x[None], y[None])

    def compute(self) -> dict:
        return {
            f"{self.eval_prefix}/{name}": metric.compute()
            for name, (metric, _) in self.metrics.items()
        }

    def reset(self) -> None:
        for metric, _ in self.metrics.values():
            metric.reset()
