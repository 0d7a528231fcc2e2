"""Multi-axis rotary position embedding over packed mixed sequences.

Reference semantics (reference ``model/base/rope.py``):

- Frequencies are ``theta ** linspace(0, 1, grid_dim) * pi/2`` in float64
  (``rope.py:42-45``). ``grid_dim = head_dim // (grid_dims * 2)``, e.g.
  64 // 6 = 10 frequencies per axis; 60 of 64 head dims are rotated, the
  remainder passes through unrotated (``rope.py:24``).
- Per sample, latent token *i* gets position id ``(i, i, i)`` and the patch
  at grid coordinate ``(t, h, w)`` gets ``(t, h, w) + token_count``
  (``rope.py:57-67``).
- Interleaved layout (``rope.py:49-53``): the rotated pair *k* of a head is
  driven by frequency ``inv_freqs[k // grid_dims]`` on axis ``k % grid_dims``.
- Application is complex multiplication on (even, odd) dim pairs in fp32
  (``rope.py:20-27``).

The cos/sin tables are computed once per batch on the host in float64 and
shipped as fp32 ``[S, rot_dim/2]``; on the device the rotation is a few
elementwise torch ops (``ops/rotary.py``).
"""

from __future__ import annotations

import numpy as np

# the rotation itself lives with the ops, which the attention kernels' plain
# versions and the exported programs reach without importing the models
from titok_tpu_torch.ops.rotary import apply_rotary_emb  # noqa: F401


def rope_inv_freqs(head_dim: int, grid_dims: int, theta: float = 10000.0) -> np.ndarray:
    """float64 frequencies, one set shared by all axes (ref ``rope.py:40-45``)."""
    grid_dim = head_dim // (grid_dims * 2)
    return np.power(theta, np.linspace(0.0, 1.0, grid_dim, dtype=np.float64)) * np.pi / 2.0


def rope_angles(
    ids: np.ndarray, head_dim: int, grid_dims: int, theta: float = 10000.0,
    interleave: bool = True,
) -> np.ndarray:
    """Angles ``[L, grid_dim * grid_dims]`` in float64 (ref ``rope.py:49-54``).

    Interleaved: ``angles[l, f*grid_dims + a] = inv_freqs[f] * ids[l, a]``.
    """
    inv = rope_inv_freqs(head_dim, grid_dims, theta)  # [F]
    ids = np.asarray(ids, dtype=np.float64)
    if interleave:
        freqs = inv[None, :, None] * ids[:, None, :]  # [L, F, A]
    else:
        freqs = inv[None, None, :] * ids[:, :, None]  # [L, A, F]
    return freqs.reshape(ids.shape[0], -1)


def rope_cos_sin(
    ids: np.ndarray, head_dim: int, grid_dims: int, theta: float = 10000.0,
    interleave: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """fp32 cos/sin tables ``[L, rot_pairs]`` from float64 angles."""
    ang = rope_angles(ids, head_dim, grid_dims, theta, interleave)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def positions_for_sample(grid: np.ndarray, token_count: int) -> np.ndarray:
    """Per-sample position ids ``[token_count + prod(grid), grid_dims]``
    (ref ``rope.py:57-67``): latent token *i* at ``(i, ..., i)``; patch at
    cartesian coord ``c`` (row-major, axis 0 slowest) at ``c + token_count``.
    """
    grid = np.asarray(grid, dtype=np.int64)
    gd = len(grid)
    token_ids = np.repeat(
        np.arange(token_count, dtype=np.float32)[:, None], gd, axis=1
    )
    coords = np.stack(
        np.meshgrid(*[np.arange(g, dtype=np.float32) for g in grid], indexing="ij"),
        axis=-1,
    ).reshape(-1, gd)
    return np.concatenate([token_ids, coords + float(token_count)], axis=0)
