"""Experiment logging: a JSONL metrics file and console lines, optional
WandB (the JAX package's ``titok_tpu/train_utils/logging.py``, same keys and
records).

The default sink is ``<out_dir>/metrics.jsonl`` plus one console line per
call; WandB is attached when the package is importable and its ``init``
succeeds, as in the JAX package. Reconstruction videos are written as
``.gif`` through imageio, or, where imageio is not installed, as the uint8
THWC array in a ``.npy`` file.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Mapping

import numpy as np


class MetricsLogger:
    def __init__(self, out_dir: str, project: str = "", run_name: str = "",
                 use_wandb: bool | None = None):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._fh = open(self.path, "a", buffering=1)
        self._t0 = time.time()

        self.wandb = None
        if use_wandb is not False:
            try:
                import wandb  # type: ignore

                self.wandb = wandb
                wandb.init(project=project or None, name=run_name or None)
            except Exception:
                self.wandb = None

    def log_metrics(self, metrics: Mapping[str, Any], step: int) -> None:
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._fh.write(json.dumps(rec) + "\n")
        if self.wandb is not None:
            self.wandb.log(dict(metrics), step=step)

    def log_console(self, metrics: Mapping[str, Any], step: int) -> None:
        parts = [f"step {step}"]
        for k, v in metrics.items():
            try:
                parts.append(f"{k}={float(v):.4g}")
            except (TypeError, ValueError):
                pass
        print(" | ".join(parts), file=sys.stderr, flush=True)

    def log_video(self, key: str, video_thwc_uint8: np.ndarray, step: int,
                  fps: float = 4, caption: str = "") -> str | None:
        """Write a THWC uint8 video; returns the written path."""
        vid_dir = os.path.join(self.out_dir, "videos")
        os.makedirs(vid_dir, exist_ok=True)
        safe = key.replace(" ", "_").replace("/", "_")
        try:
            import imageio
        except ImportError:
            imageio = None
        try:
            if imageio is None:
                path = os.path.join(vid_dir, f"{safe}_step{step}.npy")
                np.save(path, np.asarray(video_thwc_uint8, np.uint8))
            else:
                path = os.path.join(vid_dir, f"{safe}_step{step}.gif")
                imageio.mimwrite(path, list(video_thwc_uint8),
                                 duration=1000.0 / max(fps, 1), loop=0)
        except Exception as e:  # pragma: no cover
            print(f"video log failed: {e}", file=sys.stderr)
            return None
        if caption:
            with open(path + ".txt", "w") as f:
                f.write(caption)
        if self.wandb is not None:
            self.wandb.log(
                {key: self.wandb.Video(np.transpose(video_thwc_uint8, (0, 3, 1, 2)),
                                       fps=int(fps), caption=caption or None)},
                step=step,
            )
        return path

    def close(self):
        self._fh.close()
