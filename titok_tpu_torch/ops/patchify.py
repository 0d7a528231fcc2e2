"""N-D patchify/unpatchify (reference ``model/base/utils.py:26-51``).

Reference layout: ``c (d0 p0) (d1 p1) (d2 p2) -> (d0 d1 d2) (p0 p1 p2 c)``
— patch-grid coordinates row-major (axis 0 slowest) along the sequence dim,
and within a patch the channel axis is **fastest** (innermost).

``patchify``/``unpatchify`` run on the host (numpy) in the packer and on
the reconstructions; ``decode_rows`` runs on numpy rows and on torch
tensors alike (the model calls it on the device).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def patchify_thwc_u8(video: np.ndarray, patch_size: Sequence[int]) -> np.ndarray:
    """Patchify a uint8 ``[T, H, W, C]`` clip WITHOUT normalizing:
    ``[prod(dims/p), prod(p)*C]`` rows in the exact layout of
    :func:`patchify` (grid row-major, channel fastest). Raw pixel bytes are
    the uint8 wire format; :func:`decode_rows` normalizes them."""
    if video.dtype != np.uint8 or video.ndim != 4:
        raise ValueError(f"expected uint8 THWC, got {video.dtype} {video.shape}")
    t, h, w, c = video.shape
    pt, ph, pw = patch_size
    gt, gh, gw = t // pt, h // ph, w // pw
    x = video.reshape(gt, pt, gh, ph, gw, pw, c)
    x = x.transpose(0, 2, 4, 1, 3, 5, 6)  # [gt, gh, gw, pt, ph, pw, c]
    return np.ascontiguousarray(x).reshape(gt * gh * gw, pt * ph * pw * c)


# the uint8 wire's [-1,1] mapping: `x * (2/255) - 1` in f32, bit for bit
# what the JAX package's native packer computes
_U8_SCALE = np.float32(2.0 / 255.0)


def decode_rows(rows, dtype=None):
    """Decode wire-format patch rows to [-1,1] float. uint8 rows are
    normalized in f32, then cast; float rows are already normalized and
    only cast. ``rows`` is a numpy array (``dtype`` a numpy dtype) or a
    torch tensor (``dtype`` a torch dtype)."""
    if isinstance(rows, torch.Tensor):
        if rows.dtype == torch.uint8:
            out = rows.to(torch.float32) * float(_U8_SCALE) - 1.0
            return out if dtype in (None, torch.float32) else out.to(dtype)
        return rows if dtype is None else rows.to(dtype)
    if rows.dtype == np.uint8:
        out = rows.astype(np.float32) * _U8_SCALE - np.float32(1.0)
        return out if dtype in (None, np.float32) else out.astype(dtype)
    return rows if dtype is None else rows.astype(dtype)


def patchify(video: np.ndarray, patch_size: Sequence[int]) -> np.ndarray:
    """``[C, *dims] -> [prod(dims/p), prod(p)*C]`` per the reference pattern."""
    c = video.shape[0]
    dims = video.shape[1:]
    n = len(patch_size)
    if len(dims) != n:
        raise ValueError(f"dims {dims} do not match patch size {patch_size}")
    grid = [d // p for d, p in zip(dims, patch_size)]
    shape = [c]
    for g, p in zip(grid, patch_size):
        shape += [g, p]
    x = video.reshape(shape)
    # axes: [c, g0, p0, g1, p1, ...] -> [g0, g1, ..., p0, p1, ..., c]
    g_axes = [1 + 2 * i for i in range(n)]
    p_axes = [2 + 2 * i for i in range(n)]
    x = np.transpose(x, g_axes + p_axes + [0])
    return x.reshape(int(np.prod(grid)), int(np.prod(patch_size)) * c)


def unpatchify(patches: np.ndarray, grid: Sequence[int],
               patch_size: Sequence[int], channels: int = 3) -> np.ndarray:
    """Inverse of :func:`patchify`: ``[prod(grid), prod(p)*C] -> [C, *dims]``."""
    n = len(patch_size)
    grid = [int(g) for g in grid]
    x = patches.reshape(grid + list(patch_size) + [channels])
    # axes: [g0.., p0.., c] -> [c, g0, p0, g1, p1, ...]
    perm = [2 * n]
    for i in range(n):
        perm += [i, n + i]
    x = np.transpose(x, perm)
    dims = [g * p for g, p in zip(grid, patch_size)]
    return x.reshape([channels] + dims)
