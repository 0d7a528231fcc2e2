"""Config-selected eval metric hub on the host (the JAX package's
``titok_tpu/metrics/eval_metrics.py``).

``update(recon, target)`` consumes *lists of CTHW numpy clips* unpacked
on the host from the eval step's packed reconstruction. Image metrics see
T as the batch dim; reconstructions are clamped to [-1, 1] first. The
trainer keeps PSNR and SSIM on the device where it can and passes them as
``skip``; this hub takes what is left. The video metrics FVD and JEDi are
not ported yet (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import numpy as np

from titok_tpu_torch.metrics.psnr_ssim import PSNRMetric, SSIMMetric


class EvalMetrics:
    def __init__(self, config, eval_prefix: str = "eval", skip=()):
        """``skip``: metric names handled elsewhere (on the device, inside
        the eval step) and left out of this hub."""
        self.eval_prefix = eval_prefix
        self.metrics: dict[str, object] = {}
        for m in config.training.eval.log_metrics:
            if m in skip:
                continue
            if m == "psnr":
                self.metrics[m] = PSNRMetric(data_range=2.0)
            elif m == "ssim":
                self.metrics[m] = SSIMMetric(data_range=2.0)
            elif m in ("fvd", "jedi"):
                raise NotImplementedError(
                    f"eval metric {m!r} is not ported yet (ROADMAP queue 1 item 11, "
                    "metrics: I3D/FVD and V-JEPA/JEDi)")
            else:
                raise ValueError(f"unknown eval metric {m!r}")

    def update(self, recon: list, target: list) -> None:
        for x, y in zip(recon, target):
            x = np.clip(np.asarray(x, np.float32), -1, 1)
            y = np.asarray(y, np.float32)
            for metric in self.metrics.values():  # CTHW -> TCHW (T becomes batch)
                metric.update(x.transpose(1, 0, 2, 3), y.transpose(1, 0, 2, 3))

    def compute(self) -> dict:
        return {
            f"{self.eval_prefix}/{name}": metric.compute()
            for name, metric in self.metrics.items()
        }

    def reset(self) -> None:
        for metric in self.metrics.values():
            metric.reset()
