"""Frame gathering from packed patch buffers (the JAX package's
``titok_tpu/ops/frames.py``, the parts the eval metrics use).

The reconstruction only exists as packed patch rows ``[S, P]`` on the
device, so frames for SSIM are a static-shape gather:

1. The host builds a :class:`PerceptualPlan` of gather indices
   (edge-clamped to each sample's patch grid), the temporal sub-offset and
   the frame's real (H, W) (:func:`build_eval_frame_plan`, numpy).
2. On the device, :func:`gather_frames` gathers the K frames' patch rows
   ``[K, GH, GW, P]``, picks the sub-offset and reassembles ``[K, Hmax,
   Wmax, C]`` images.

``build_perceptual_plan`` and ``extract_perceptual_frames`` (random crops
and the bicubic resize of the LPIPS input) come with LPIPS (ROADMAP queue
1 item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from titok_tpu_torch.data.packing import sample_offsets


@dataclasses.dataclass
class PerceptualPlan:
    """Host-built per-batch plan for K frames."""

    gather_idx: np.ndarray   # int32 [K, GH, GW] slot ids into [S] (edge-clamped)
    r0: np.ndarray           # int32 [K] temporal offset within the patch
    scale: np.ndarray        # f32 [K, 2] (y, x) resize scale; the eval plan's (H, W)
    translation: np.ndarray  # f32 [K, 2] (y, x) output-space translation
    weight: np.ndarray       # f32 [K] frame weight (0 disables a slot)

    def device_arrays(self) -> dict:
        return dataclasses.asdict(self)


def build_eval_frame_plan(
    batch,
    *,
    num_frames: int,
    patch_size: Sequence[int],
    max_grid_hw: Sequence[int],
) -> PerceptualPlan:
    """Deterministic plan gathering ALL frames of every valid sample
    (identity scale, no crop) for device-side eval metrics. ``num_frames``
    is the static buffer size (use :func:`max_eval_frames`); unused slots
    have weight 0. Frame pixel sizes ride in ``scale`` as (H, W) so the
    device SSIM can mask padding."""
    p0, p1, p2 = patch_size
    GH = max_grid_hw[0] // p1
    GW = max_grid_hw[1] // p2
    K = num_frames

    gather_idx = np.zeros((K, GH, GW), np.int32)
    r0 = np.zeros((K,), np.int32)
    hw = np.ones((K, 2), np.float32)
    translation = np.zeros((K, 2), np.float32)
    weight = np.zeros((K,), np.float32)

    offs = sample_offsets(batch.token_counts, batch.grid_sizes)
    ki = 0
    for b in range(batch.num_samples):
        gt, gh, gw = (int(x) for x in batch.grids[b])
        patch_start = int(offs[b]) + int(batch.token_counts[b])
        hh = np.minimum(np.arange(GH), gh - 1)
        ww = np.minimum(np.arange(GW), gw - 1)
        base = patch_start + hh[:, None] * gw + ww[None, :]
        for t in range(gt * p0):
            if ki >= K:
                raise ValueError(f"eval frame buffer too small: {ki + 1} frames > {K}; "
                                 "raise num_frames (see max_eval_frames)")
            gather_idx[ki] = base + (t // p0) * (gh * gw)
            r0[ki] = t % p0
            hw[ki] = (gh * p1, gw * p2)
            weight[ki] = 1.0
            ki += 1
    return PerceptualPlan(gather_idx, r0, hw, translation, weight)


def max_eval_frames(seq_len: int, min_grid: Sequence[int],
                    patch_size: Sequence[int]) -> int:
    """Static bound on pixel frames in one packed batch: the budget filled
    with minimal-HW samples maximizes frames per slot."""
    p0, p1, p2 = patch_size
    min_hw_slots = (min_grid[1] // p1) * (min_grid[2] // p2)
    return max(p0, (seq_len // min_hw_slots + 1) * p0)


def gather_frames(
    patch_rows: torch.Tensor,  # [S, P] with P = p0*p1*p2*C (channel fastest)
    plan: dict,
    patch_size: Sequence[int],
    channels: int = 3,
) -> torch.Tensor:
    """Gather K frames into ``[K, GH*p1, GW*p2, C]`` images."""
    p0, p1, p2 = patch_size
    gi = plan["gather_idx"].long()  # [K, GH, GW]
    K, GH, GW = gi.shape
    g = patch_rows[gi.reshape(-1)].reshape(K, GH, GW, p0, p1, p2, channels)
    r0 = plan["r0"].long().view(K, 1, 1, 1, 1, 1, 1).expand(K, GH, GW, 1, p1, p2, channels)
    g = torch.gather(g, 3, r0)[:, :, :, 0]  # [K, GH, GW, p1, p2, C]
    g = g.permute(0, 1, 3, 2, 4, 5)  # [K, GH, p1, GW, p2, C]
    return g.reshape(K, GH * p1, GW * p2, channels)
