"""Frame gathering, crop and resize from packed patch buffers (the JAX
package's ``titok_tpu/ops/frames.py``).

The reconstruction only exists as packed patch rows ``[S, P]`` on the
device, so the frames of the perceptual loss and of SSIM are a
static-shape, differentiable gather:

1. The host builds a :class:`PerceptualPlan` (numpy): gather indices
   (edge-clamped to each sample's patch grid), the temporal sub-offset and
   per frame a scale and translation (:func:`build_perceptual_plan`: K
   random frames with random crops and resizes, reference
   ``model/losses/loss_module.py:59-93``), or the frame's real (H, W)
   (:func:`build_eval_frame_plan`).
2. On the device, :func:`gather_frames` gathers the K frames' patch rows
   ``[K, GH, GW, P]``, picks the sub-offset and reassembles ``[K, Hmax,
   Wmax, C]`` images.
3. :func:`crop_resize` computes ``jax.image.scale_and_translate(...,
   method="cubic", antialias=False)``: Keys' cubic (a = -0.5, not torch's
   bicubic a = -0.75) as two separable weight matrices a frame, contracted
   by two batched matmuls, so the gradient reaches the patch rows.
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


def build_perceptual_plan(
    batch,
    *,
    num_frames: int,
    sample_size: int,
    patch_size: Sequence[int],
    max_grid_hw: Sequence[int],
    resize_prob: float = 0.25,
    rng: np.random.Generator | None = None,
) -> PerceptualPlan:
    """Pick K random frames with crop and resize parameters (reference
    ``loss_module.py:59-93``): frames in the order of one permutation of the
    batch's frames (cycled when it holds fewer than K); a frame below
    ``sample_size`` on a side, or with probability ``resize_prob``, is
    resized so its short side is ``sample_size``; then a random
    ``sample_size²`` crop. Draws from ``rng`` in the JAX package's order,
    so one seed gives the same plan in both."""
    rng = rng or np.random.default_rng()
    p0, p1, p2 = patch_size
    GH = max_grid_hw[0] // p1
    GW = max_grid_hw[1] // p2
    K = num_frames

    frames = [(b, t) for b in range(batch.num_samples)
              for t in range(int(batch.grids[b][0]) * p0)]
    offs = sample_offsets(batch.token_counts, batch.grid_sizes)

    gather_idx = np.zeros((K, GH, GW), np.int32)
    r0 = np.zeros((K,), np.int32)
    scale = np.ones((K, 2), np.float32)
    translation = np.zeros((K, 2), np.float32)
    weight = np.zeros((K,), np.float32)
    if not frames:
        return PerceptualPlan(gather_idx, r0, scale, translation, weight)

    order = rng.permutation(len(frames))
    for ki in range(K):
        b, t = frames[order[ki % len(order)]]
        gt, gh, gw = (int(x) for x in batch.grids[b])
        H, W = gh * p1, gw * p2
        patch_start = int(offs[b]) + int(batch.token_counts[b])
        hh = np.minimum(np.arange(GH), gh - 1)
        ww = np.minimum(np.arange(GW), gw - 1)
        gather_idx[ki] = patch_start + (t // p0) * (gh * gw) + hh[:, None] * gw + ww[None, :]
        r0[ki] = t % p0
        # the draw of rng.random() is skipped for a frame below sample_size
        if H < sample_size or W < sample_size or rng.random() < resize_prob:
            s = sample_size / min(H, W)  # torch Resize(size=s): short side -> s
            Hr, Wr = round(H * s), round(W * s)
        else:
            s, Hr, Wr = 1.0, H, W
        oy = rng.integers(0, Hr - sample_size + 1)
        ox = rng.integers(0, Wr - sample_size + 1)
        scale[ki] = (s, s)
        translation[ki] = (-float(oy), -float(ox))
        weight[ki] = 1.0
    return PerceptualPlan(gather_idx, r0, scale, translation, weight)


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


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel, a = -0.5, of ``x >= 0`` (``jax/_src/image/
    scale.py:_fill_keys_cubic_kernel``)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(in_size: int, out_size: int, scale: torch.Tensor,
                    translation: torch.Tensor) -> torch.Tensor:
    """Per frame the ``[in, out]`` weights of a cubic scale-and-translate
    along one axis (``jax/_src/image/scale.py:compute_weight_mat``, no
    antialias): ``scale``/``translation`` ``[K]`` -> ``[K, in, out]``.
    Columns are normalised by their sum where it exceeds ``1000·eps32``,
    and zeroed where the sample point lies outside ``[-0.5, in - 0.5]``."""
    inv_scale = 1.0 / scale
    out = torch.arange(out_size, dtype=torch.float32, device=scale.device)
    sample_f = ((out[None, :] + 0.5) * inv_scale[:, None]
                - (translation * inv_scale)[:, None] - 0.5)  # [K, out]
    pos = torch.arange(in_size, dtype=torch.float32, device=scale.device)
    w = _keys_cubic(torch.abs(sample_f[:, None, :] - pos[None, :, None]))
    total = w.sum(dim=1, keepdim=True)
    zero = torch.zeros_like(w)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), zero)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, zero)


def _linear_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """The ``[in, out]`` weights of ``jax.image.resize(..., "linear")``
    along one axis (``jax/_src/image/scale.py:compute_weight_mat``,
    antialias on): the triangle kernel widened by ``1/scale`` when the axis
    shrinks, columns normalised by their sum, zero where the sample point
    lies outside ``[-0.5, in - 0.5]``."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    pos = torch.arange(in_size, dtype=torch.float32, device=device)
    w = torch.clamp(1.0 - (sample_f[None, :] - pos[:, None]).abs() / kernel_scale, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    zero = torch.zeros_like(w)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), zero)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, zero)


def linear_resize(x: torch.Tensor, out_shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, out_shape, "trilinear")`` (any rank; antialiased
    on a downscale): each axis whose size changes is contracted with its
    weight matrix by one matmul on ``x``'s device, in f32."""
    if len(out_shape) != x.ndim:
        raise ValueError(f"out_shape {tuple(out_shape)} has not the rank of {tuple(x.shape)}")
    x = x.to(torch.float32)
    for d, n in enumerate(out_shape):
        if x.shape[d] != n:
            w = _linear_weights(x.shape[d], int(n), x.device)
            x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x


def crop_resize(frames: torch.Tensor, plan: dict, sample_size: int) -> torch.Tensor:
    """Per-frame cubic scale and translate of ``[K, H, W, C]`` frames to
    ``[K, s, s, C]`` f32, as ``jax.image.scale_and_translate(...,
    method="cubic", antialias=False)`` with the plan's (y, x) ``scale`` and
    ``translation``. ``H, W`` are the frames' padded size."""
    K, H, W, C = frames.shape
    scale, translation = plan["scale"], plan["translation"]
    wy = _resize_weights(H, sample_size, scale[:, 0], translation[:, 0])  # [K, H, s]
    wx = _resize_weights(W, sample_size, scale[:, 1], translation[:, 1])  # [K, W, s]
    rows = torch.matmul(wy.transpose(1, 2), frames.to(torch.float32).reshape(K, H, W * C))
    rows = rows.reshape(K, sample_size, W, C)  # [K, s, W, C]
    return torch.matmul(wx.transpose(1, 2)[:, None], rows)  # [K, s, s, C]


def extract_perceptual_frames(
    patch_rows: torch.Tensor,
    plan: dict,
    patch_size: Sequence[int],
    sample_size: int,
    channels: int = 3,
) -> torch.Tensor:
    """Packed rows -> the plan's ``[K, s, s, C]`` f32 frames."""
    return crop_resize(gather_frames(patch_rows, plan, patch_size, channels), plan, sample_size)
