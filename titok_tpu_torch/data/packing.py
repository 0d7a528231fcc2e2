"""PackedBatch and the host-side packer (numpy), plus the copy to the device.

The reference attends over *lists* of differently-shaped clips with varlen
flash attention (reference ``model/base/blocks.py:80-97``). Here a batch is
one fixed ``[S, ...]`` buffer:

    slot layout per sample b (contiguous):  [latent tokens (tc_b) | patches (gs_b)]
    samples concatenated in order, padding (segment 0) at the end.

- ``segment_ids``  int32 [S]: 1-based sample id, 0 = padding; attention
  masks ``seg[i] != seg[j]`` (the block-diagonal varlen mask as data).
- ``token_mask``   bool [S]: True at latent-token slots.
- ``patches``      [S, P]: patchified pixels at patch slots (zeros at token
  and pad slots); P = prod(patch_size) * in_channels.
- ``rope_cos/sin`` f32 [S, R]: per-slot rotary tables, host-computed in
  float64 (see ``models/rope.py``); pad slots rotate by the identity.

The batch's ``wire`` (:func:`wire_dtype`) is the dtype its rows cross to
the device in. On a float wire (f32, or bf16 at 'bf16-mixed', as the JAX
package ships them) the rows are kept on the host in f32 (numpy has no
bf16) with the values of that dtype. On the uint8 wire
(``dataset.uint8_wire``) they are the raw pixel bytes, uint8 on the host
and on the device, where every consumer normalizes them through
``decode_rows``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from titok_tpu_torch.data.video_reader import patchify_normalize
from titok_tpu_torch.models.rope import positions_for_sample, rope_cos_sin
from titok_tpu_torch.ops.patchify import decode_rows, patchify, patchify_thwc_u8, unpatchify


@dataclasses.dataclass
class PackedBatch:
    """Host-side packed batch. All arrays are numpy with static shapes."""

    patches: np.ndarray       # [S, P] f32 (values of the wire dtype), or uint8 (uint8 wire)
    segment_ids: np.ndarray   # int32 [S]
    token_mask: np.ndarray    # bool  [S]
    rope_cos: np.ndarray      # f32   [S, R]
    rope_sin: np.ndarray      # f32   [S, R]
    token_counts: np.ndarray  # int32 [Bmax]   (0 at unused sample rows)
    grid_sizes: np.ndarray    # int32 [Bmax]   patches per sample
    grids: np.ndarray         # int32 [Bmax, G] patch-grid shape per sample
    sample_valid: np.ndarray  # bool  [Bmax]
    fps: np.ndarray           # f32   [Bmax]   source fps (for logging/eval)
    wire: torch.dtype = torch.float32  # dtype of ``patches`` on the device

    @property
    def seq_len(self) -> int:
        return int(self.patches.shape[0])

    @property
    def num_samples(self) -> int:
        return int(self.sample_valid.sum())

    def device_arrays(self) -> dict:
        """The buffers the model consumes, as numpy arrays."""
        return {
            "patches": self.patches,
            "segment_ids": self.segment_ids,
            "token_mask": self.token_mask,
            "rope_cos": self.rope_cos,
            "rope_sin": self.rope_sin,
            "token_counts": self.token_counts,
            "grid_sizes": self.grid_sizes,
            "sample_valid": self.sample_valid,
        }


def wire_dtype(config) -> torch.dtype:
    """The dtype packed pixel rows cross to the device in.
    ``dataset.uint8_wire: true`` ships the raw pixel bytes, normalized on
    the device (``decode_rows``): a pixel is 1 byte, against bf16's 2 and
    f32's 4, and no bf16 rounding of the normalized value. Otherwise the
    compute dtype of ``training.main.precision`` (bf16 at 'bf16-mixed'),
    the reference-shaped float wire."""
    if bool(config.dataset.get("uint8_wire", False)):
        return torch.uint8
    from titok_tpu_torch.models.titok import compute_dtype

    return compute_dtype(config)


def host_tensors(batch: "PackedBatch | DiscBatch") -> dict:
    """``device_arrays()`` as CPU tensors, a PackedBatch's patch rows in its
    ``wire`` dtype: float rows cast, uint8 rows as they are."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in batch.device_arrays().items()}
    wire = getattr(batch, "wire", torch.float32)
    if "patches" in out and out["patches"].dtype != wire:
        if wire == torch.uint8 or not out["patches"].is_floating_point():
            raise ValueError(f"{out['patches'].dtype} patch rows on a {wire} wire")
        out["patches"] = out["patches"].to(wire)
    return out


def to_device(batch: "PackedBatch | DiscBatch", device) -> dict:
    """``device_arrays()`` of a PackedBatch or a DiscBatch as a dict of
    tensors on ``device`` (:func:`host_tensors`, copied)."""
    return {k: v.to(device) for k, v in host_tensors(batch).items()}


def max_samples_for(seq_len: int, min_grid: Sequence[int], patch_size: Sequence[int],
                    min_tokens: int = 1) -> int:
    """Static upper bound on samples per batch under the budget."""
    min_cost = math.prod(g // p for g, p in zip(min_grid, patch_size)) + max(1, min_tokens)
    return max(1, seq_len // min_cost)


def sample_offsets(token_counts: np.ndarray, grid_sizes: np.ndarray) -> np.ndarray:
    """Start slot of each sample: cumsum of (tc + gs) (ref ``blocks.py:82-83``)."""
    seq_lens = np.asarray(token_counts) + np.asarray(grid_sizes)
    return np.concatenate([[0], np.cumsum(seq_lens)]).astype(np.int64)


class GridOnly:
    """Grid-shaped placeholder accepted wherever ``pack_samples`` takes a
    video: reserves the sample's budget slots (token + patch rows) but
    writes no pixel rows (they stay zero). Decoding from indices packs
    these: the decoder replaces patch slots with the mask token, so their
    values are irrelevant."""

    def __init__(self, dims: Sequence[int], channels: int = 3):
        self.dims = tuple(int(d) for d in dims)
        self.channels = int(channels)


def _is_thwc_u8(vid) -> bool:
    return vid.dtype == np.uint8 and vid.ndim == 4 and vid.shape[-1] in (1, 3)


def video_dims(vid) -> tuple[int, ...]:
    """Pixel dims (T, H, W) of a clip in either accepted layout:
    float CTHW (the reference's layout) or uint8 THWC."""
    if isinstance(vid, GridOnly):
        return vid.dims
    if _is_thwc_u8(vid):
        return tuple(vid.shape[:3])
    return tuple(vid.shape[1:])


def patchify_normalize_reference(vid: np.ndarray, patch_size: Sequence[int]) -> np.ndarray:
    """The plain version of the fused packer (``video_reader.patchify_normalize``):
    byte shuffle, then f32 ``x*(2/255)-1`` (``decode_rows``); equal bit for bit."""
    return decode_rows(patchify_thwc_u8(vid, patch_size))


def _video_rows(vid: np.ndarray, patch_size: Sequence[int], dtype=None) -> np.ndarray:
    """Patch rows for a clip.

    Float wire (``dtype`` None or a float dtype): [-1,1] f32 rows; a uint8
    THWC clip goes through the fused packer (``pk_patchify_normalize``), a
    float CTHW clip through ``patchify``.

    uint8 wire (``dtype=torch.uint8``): raw pixel-byte rows; a uint8 THWC
    clip is a byte shuffle (``patchify_thwc_u8``), a float source (the
    synthetic stream) is quantized back to pixel bytes, as the JAX package
    quantizes it, so that a run keeps one wire dtype."""
    if dtype == torch.uint8:
        if _is_thwc_u8(vid):
            return patchify_thwc_u8(vid, patch_size)
        rows = patchify(np.asarray(vid, np.float32), patch_size)
        return np.clip(np.rint((rows + 1.0) * 127.5), 0, 255).astype(np.uint8)
    if _is_thwc_u8(vid):
        return patchify_normalize(vid, patch_size)
    return patchify(np.asarray(vid), patch_size)


def pack_samples(
    videos: Sequence[np.ndarray],
    token_counts: Sequence[int],
    *,
    seq_len: int,
    max_samples: int,
    patch_size: Sequence[int],
    head_dim: int = 64,
    fps: Sequence[float] | None = None,
    dtype: torch.dtype = torch.float32,
) -> PackedBatch:
    """Pack a list of CTHW (or uint8 THWC, or ``GridOnly``) clips into one
    PackedBatch. On a float ``dtype`` the patch rows are rounded to it, as
    the JAX package's packer stores them in its host dtype (bf16 at
    'bf16-mixed'), kept in f32 on the host (numpy has no bf16) and shipped
    in ``dtype``. On ``torch.uint8`` they are pixel bytes (zero bytes at
    token and pad slots, as the JAX package packs them)."""
    n_dims = len(patch_size)
    B = len(videos)
    if B != len(token_counts) or B > max_samples:
        raise ValueError(f"{B} clips, {len(token_counts)} token counts, "
                         f"max_samples {max_samples}")
    v0 = videos[0]
    if isinstance(v0, GridOnly):
        c = v0.channels
    elif _is_thwc_u8(v0):
        c = v0.shape[-1]
    else:
        c = v0.shape[0]
    p_elems = int(math.prod(patch_size)) * c

    grids = np.zeros((max_samples, n_dims), dtype=np.int32)
    tcs = np.zeros((max_samples,), dtype=np.int32)
    gss = np.zeros((max_samples,), dtype=np.int32)
    valid = np.zeros((max_samples,), dtype=bool)
    fps_arr = np.zeros((max_samples,), dtype=np.float32)

    u8 = dtype == torch.uint8
    patches = np.zeros((seq_len, p_elems), dtype=np.uint8 if u8 else np.float32)
    segment_ids = np.zeros((seq_len,), dtype=np.int32)
    token_mask = np.zeros((seq_len,), dtype=bool)
    positions = np.zeros((seq_len, n_dims), dtype=np.float64)

    offset = 0
    for b, (vid, tc) in enumerate(zip(videos, token_counts)):
        tc = int(tc)
        grid = [d // p for d, p in zip(video_dims(vid), patch_size)]
        gs = int(math.prod(grid))
        end = offset + tc + gs
        if end > seq_len:
            raise ValueError(f"packed length {end} exceeds budget {seq_len}")

        grids[b] = grid
        tcs[b] = tc
        gss[b] = gs
        valid[b] = True
        if fps is not None:
            fps_arr[b] = fps[b]

        segment_ids[offset:end] = b + 1
        token_mask[offset : offset + tc] = True
        if not isinstance(vid, GridOnly):
            patches[offset + tc : end] = _video_rows(vid, patch_size, dtype)
        positions[offset:end] = positions_for_sample(grid, tc)
        offset = end

    if not u8 and dtype != torch.float32:
        patches = torch.from_numpy(patches).to(dtype).to(torch.float32).numpy()
    cos, sin = rope_cos_sin(positions, head_dim, n_dims)
    # pad slots rotate by the identity: no position signal
    pad = segment_ids == 0
    cos[pad] = 1.0
    sin[pad] = 0.0

    return PackedBatch(
        patches=patches,
        segment_ids=segment_ids,
        token_mask=token_mask,
        rope_cos=cos,
        rope_sin=sin,
        token_counts=tcs,
        grid_sizes=gss,
        grids=grids,
        sample_valid=valid,
        fps=fps_arr,
        wire=dtype,
    )


def unpack_videos(
    recon_patches: np.ndarray, batch: PackedBatch, patch_size: Sequence[int],
    channels: int = 3,
) -> list[np.ndarray]:
    """Slice per-sample patch rows out of ``[S, P]`` and unpatchify to videos
    (the host-side analog of reference ``blocks.py:171-177``)."""
    offs = sample_offsets(batch.token_counts, batch.grid_sizes)
    out = []
    for b in range(batch.num_samples):
        start = offs[b] + int(batch.token_counts[b])
        gs = int(batch.grid_sizes[b])
        rows = np.asarray(recon_patches[start : start + gs], dtype=np.float32)
        out.append(unpatchify(rows, batch.grids[b], patch_size, channels))
    return out


def unpack_indices(indices: np.ndarray, batch: PackedBatch) -> list[np.ndarray]:
    """Per-sample latent token indices from a full-buffer [S] index array
    (reference ``titok.py:47-52`` ``split_indices=True``)."""
    offs = sample_offsets(batch.token_counts, batch.grid_sizes)
    out = []
    for b in range(batch.num_samples):
        start = offs[b]
        tc = int(batch.token_counts[b])
        out.append(np.asarray(indices[start : start + tc], dtype=np.int32))
    return out


@dataclasses.dataclass
class DiscBatch:
    """Packed layout for the discriminator pass (reference
    ``loss_module.py:42-48,96-101``): the same clips, but every sample gets
    ``disc_tokens`` register tokens instead of its latent count. Patch
    pixels are not shipped again: ``patch_gather`` maps disc patch slots
    back to tokenizer slots, so the target buffer and the reconstruction
    on the device are both regathered for the discriminator forwards."""

    patch_gather: np.ndarray  # int32 [Sd] -> slot in [S] (0 at token/pad slots)
    is_patch: np.ndarray      # bool [Sd]
    segment_ids: np.ndarray   # int32 [Sd]
    token_mask: np.ndarray    # bool [Sd]
    rope_cos: np.ndarray      # f32 [Sd, R]
    rope_sin: np.ndarray      # f32 [Sd, R]
    sample_valid: np.ndarray  # bool [Bmax]

    def device_arrays(self) -> dict:
        return dataclasses.asdict(self)


def build_disc_batch(batch: PackedBatch, disc_tokens: int = 4,
                     head_dim: int = 64) -> DiscBatch:
    """The discriminator's packing plan for a tokenizer PackedBatch."""
    Bmax = batch.sample_valid.shape[0]
    Sd = batch.seq_len + disc_tokens * Bmax
    n_dims = batch.grids.shape[1]

    patch_gather = np.zeros((Sd,), np.int32)
    is_patch = np.zeros((Sd,), bool)
    segment_ids = np.zeros((Sd,), np.int32)
    token_mask = np.zeros((Sd,), bool)
    positions = np.zeros((Sd, n_dims), np.float64)

    offs = sample_offsets(batch.token_counts, batch.grid_sizes)
    d_off = 0
    for b in range(batch.num_samples):
        gs = int(batch.grid_sizes[b])
        tc = int(batch.token_counts[b])
        end = d_off + disc_tokens + gs
        segment_ids[d_off:end] = b + 1
        token_mask[d_off : d_off + disc_tokens] = True
        src_start = int(offs[b]) + tc
        patch_gather[d_off + disc_tokens : end] = np.arange(src_start, src_start + gs)
        is_patch[d_off + disc_tokens : end] = True
        positions[d_off:end] = positions_for_sample(batch.grids[b], disc_tokens)
        d_off = end

    cos, sin = rope_cos_sin(positions, head_dim, n_dims)
    pad = segment_ids == 0
    cos[pad] = 1.0
    sin[pad] = 0.0

    return DiscBatch(
        patch_gather=patch_gather,
        is_patch=is_patch,
        segment_ids=segment_ids,
        token_mask=token_mask,
        rope_cos=cos,
        rope_sin=sin,
        sample_valid=batch.sample_valid.copy(),
    )


class Packer:
    """Streaming dynamic packer (reference ``_dynamic_batching``,
    ``video_dataset.py:130-172``).

    Pulls ``{'video', 'fps'}`` samples from an iterator, gives each a
    random token count from ``token_range``, packs until the budget would
    be exceeded, then emits a PackedBatch. The overflowing sample starts
    the next batch; a partial final batch is dropped unless ``flush_final``
    (the eval stream emits it). Rows are rounded to ``dtype`` (see
    :func:`pack_samples`).
    """

    def __init__(
        self,
        *,
        seq_len: int,
        token_range: Sequence[int],
        patch_size: Sequence[int],
        min_grid: Sequence[int],
        head_dim: int = 64,
        max_samples: int | None = None,
        rng: np.random.Generator | None = None,
        dtype: torch.dtype = torch.float32,
        flush_final: bool = False,
    ):
        self.seq_len = int(seq_len)
        self.token_range = (int(token_range[0]), int(token_range[1]))
        self.patch_size = list(patch_size)
        self.head_dim = head_dim
        self.max_samples = max_samples or max_samples_for(
            seq_len, min_grid, patch_size, self.token_range[0]
        )
        self.rng = rng or np.random.default_rng()
        self.dtype = dtype
        self.flush_final = flush_final

    def _pack(self, videos, tcs, fps) -> PackedBatch:
        return pack_samples(videos, tcs, seq_len=self.seq_len,
                            max_samples=self.max_samples, patch_size=self.patch_size,
                            head_dim=self.head_dim, fps=fps, dtype=self.dtype)

    def __call__(self, stream: Iterable[dict]) -> Iterator[PackedBatch]:
        videos: list[np.ndarray] = []
        tcs: list[int] = []
        fps: list[float] = []
        cur = 0
        for sample in stream:
            vid = sample["video"]
            gs = math.prod(d // p for d, p in zip(video_dims(vid), self.patch_size))
            tc = int(self.rng.integers(self.token_range[0], self.token_range[1] + 1))
            if gs + tc > self.seq_len:  # can never fit; drop with a warning
                print(f"packer: dropping oversized clip ({gs} grid + {tc} "
                      f"tokens > budget {self.seq_len})")
                continue
            if cur + gs + tc > self.seq_len or len(videos) >= self.max_samples:
                if videos:
                    yield self._pack(videos, tcs, fps)
                videos, tcs, fps, cur = [], [], [], 0
            cur += gs + tc
            videos.append(vid)
            tcs.append(tc)
            fps.append(float(sample.get("fps", 0.0)))
        if self.flush_final and videos:
            yield self._pack(videos, tcs, fps)
