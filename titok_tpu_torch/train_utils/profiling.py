"""Profiling and step timing (the JAX package's
``titok_tpu/train_utils/profiling.py``).

- :func:`trace` — a ``torch.profiler`` scope over the CPU and, where there
  is one, the card, writing a Chrome trace to ``<log_dir>/trace.json``
  (config: ``training.main.profile_dir`` + ``profile_steps``);
  :func:`start_trace` / :func:`stop_trace` are the same for a window of
  steps inside a loop;
- :class:`StepTimer` — rolling wall-clock stats per step with percentiles,
  logged beside the training metrics.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import numpy as np


def start_trace(log_dir: str):
    """Start a ``torch.profiler`` trace; returns the handle for
    :func:`stop_trace`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=acts)
    prof.__enter__()
    prof.log_dir = log_dir
    return prof


def stop_trace(prof) -> str:
    """Stop a trace and write it to ``<log_dir>/trace.json``; returns the
    path."""
    prof.__exit__(None, None, None)
    os.makedirs(prof.log_dir, exist_ok=True)
    path = os.path.join(prof.log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``torch.profiler`` trace scope; no-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    prof = start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace(prof)


class StepTimer:
    def __init__(self, window: int = 100, steps_per_tick: int = 1):
        self.times: deque = deque(maxlen=window)
        self._last: float | None = None
        # steps_per_call ticks once a K-step call; the stats stay per step
        self.steps_per_tick = max(1, int(steps_per_tick))

    def tick(self) -> float | None:
        """Call once per step (or per K-step call); returns the last
        per-step duration."""
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = (now - self._last) / self.steps_per_tick
            self.times.append(dt)
        self._last = now
        return dt

    def stats(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "perf/step_time_mean_s": float(arr.mean()),
            "perf/step_time_p50_s": float(np.percentile(arr, 50)),
            "perf/step_time_p95_s": float(np.percentile(arr, 95)),
        }
