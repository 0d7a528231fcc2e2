"""Clip chunk sampling: native-resolution / native-length / variable-fps
training chunks (reference ``dataset/video_dataset.py:38-127``; the JAX
package's ``titok_tpu/data/chunking.py``, the same draws in the same order).

Walks a source video front to back emitting chunks with a random frame
count (multiples of the temporal patch), a random fps by index striding, a
random H/W (multiples of the spatial patch, aspect-ratio-capped), then
RandomResizedCrop + horizontal flip (train) or Resize + CenterCrop (eval),
as the reference does. Chunks are **uint8 THWC**: the packer normalizes
while it patchifies (or ships the bytes, on the uint8 wire).

The crop and bicubic resize are libswscale's (``video_reader.resize_frames``)
or nothing: where the ``av`` library cannot be built this raises, with no
other resize to fall back on.
"""

from __future__ import annotations

import itertools
import math
from typing import Iterator, Sequence

import numpy as np

from titok_tpu_torch.data.packing import PackedBatch, Packer, wire_dtype
from titok_tpu_torch.data.video_reader import VideoReader, resize_frames


def random_resized_crop(frames: np.ndarray, out_hw: tuple[int, int], min_scale: float,
                        rng: np.random.Generator) -> np.ndarray:
    """torchvision RandomResizedCrop with a fixed aspect ratio = the output's
    (reference ``video_dataset.py:100-107``): crop a random-area window of
    the target aspect, resize to the target, one crop for the whole clip."""
    T, H, W, _ = frames.shape
    oh, ow = out_hw
    ratio = ow / oh
    area = H * W
    for _ in range(10):
        target_area = area * rng.uniform(min_scale, 1.0)
        cw = int(round(math.sqrt(target_area * ratio)))
        ch = int(round(math.sqrt(target_area / ratio)))
        if 0 < cw <= W and 0 < ch <= H:
            y = int(rng.integers(0, H - ch + 1))
            x = int(rng.integers(0, W - cw + 1))
            return resize_frames(frames, out_hw, crop=(y, x, ch, cw))
    # fallback: center crop of the largest window with the right ratio
    if W / H > ratio:
        ch, cw = H, int(round(H * ratio))
    else:
        cw, ch = W, int(round(W / ratio))
    y, x = (H - ch) // 2, (W - cw) // 2
    return resize_frames(frames, out_hw, crop=(y, x, ch, cw))


def resize_center_crop(frames: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Eval path: short side -> max(out), center crop (reference ``:95-98``)."""
    T, H, W, _ = frames.shape
    oh, ow = out_hw
    target = max(oh, ow)
    scale = target / min(H, W)
    nh, nw = max(oh, int(round(H * scale))), max(ow, int(round(W * scale)))
    frames = resize_frames(frames, (nh, nw))
    y, x = (nh - oh) // 2, (nw - ow) // 2
    return frames[:, y: y + oh, x: x + ow]


def iter_video_chunks(
    reader,
    *,
    patch_size: Sequence[int],
    min_grid: Sequence[int],
    max_grid: Sequence[int],
    fps_range: Sequence[int],
    max_aspect_ratio: float,
    min_scale: float,
    rng: np.random.Generator,
    eval: bool = False,
) -> Iterator[dict]:
    """Yield ``{'video': uint8 THWC, 'fps': int}`` chunks from one video
    (reference ``_video_process`` inner loop, ``video_dataset.py:56-127``)."""
    p0, p1, p2 = patch_size
    in_fps = int(reader.get_avg_fps())
    in_grid = [len(reader), reader.height, reader.width]
    min_fps, max_fps = int(fps_range[0]), int(fps_range[1])

    if not all(x >= y for x, y in zip(in_grid, min_grid)) or in_fps < min_fps:
        return

    start_idx = 0
    while True:
        chunk_num_frames = int(rng.choice(np.arange(min_grid[0], max_grid[0] + 1, p0)))
        chunk_fps = int(rng.integers(min_fps, min(max_fps, in_fps) + 1))
        end_idx = start_idx + int(chunk_num_frames * (in_fps / chunk_fps))
        if in_grid[0] < end_idx:
            break

        chunk_height = int(rng.choice(
            np.arange(min_grid[1], min(max_grid[1], in_grid[1]) + 1, p1)))
        width_error = int(chunk_height / max_aspect_ratio) % p2
        min_width = max(min_grid[2], int(chunk_height / max_aspect_ratio) - width_error)
        max_width = min(max_grid[2], in_grid[2], int(chunk_height * max_aspect_ratio))
        if max_width < min_width:
            start_idx = end_idx + 1
            continue
        chunk_width = int(rng.choice(np.arange(min_width, max_width + 1, p2)))

        chunk_indices = np.linspace(start_idx, end_idx - 1, chunk_num_frames, dtype=int).tolist()
        frames = reader.get_batch(chunk_indices)  # uint8 THWC

        if eval:
            frames = resize_center_crop(frames, (chunk_height, chunk_width))
        else:
            frames = random_resized_crop(frames, (chunk_height, chunk_width), min_scale, rng)
            if rng.random() < 0.5:  # horizontal flip
                frames = frames[:, :, ::-1]

        yield {"video": np.ascontiguousarray(frames), "fps": chunk_fps}
        start_idx = end_idx + 1


def chunk_shuffle_buffer(stream, buffer_size: int, rng: np.random.Generator):
    """Reservoir-style shuffle (reference ``video_dataset_csv.py:122-131``):
    once the buffer is full, each new item replaces a random one, which is
    emitted. What is left in the buffer when the stream ends is dropped, as
    the JAX package's buffer drops it."""
    buffer: list = []
    for sample in stream:
        if len(buffer) < buffer_size:
            buffer.append(sample)
        else:
            idx = int(rng.integers(buffer_size))
            out = buffer[idx]
            buffer[idx] = sample
            yield out


def clip_chunks(source, sampling, patch_size: Sequence[int], rng: np.random.Generator,
                eval: bool) -> Iterator[dict]:
    """:func:`iter_video_chunks` of one clip (a path or mp4 bytes) with the
    config's ``training.sampling``. A clip that fails to open or decode is
    skipped with a printed line, as the reference's ``warn_and_continue``
    skips it; the library itself is loaded before any clip, so a missing
    one raises instead (``wds_batches``, ``csv_batches``)."""
    try:
        with VideoReader(source) as reader:
            yield from iter_video_chunks(
                reader, patch_size=patch_size, min_grid=sampling.min_grid,
                max_grid=sampling.max_grid, fps_range=sampling.fps_range,
                max_aspect_ratio=sampling.max_aspect_ratio,
                min_scale=float(sampling.get("min_scale", 0.25)), rng=rng, eval=eval)
    except (OSError, ValueError) as error:
        print(f"Decode fail: {error}")


def pack_chunks(config, chunks: Iterator[dict], rng: np.random.Generator, eval: bool,
                buffer_size: int = 64) -> Iterator[PackedBatch]:
    """The readers' common tail: the first ``eval_samples`` chunks (eval) or
    a shuffle buffer of ``buffer_size`` (train), then the dynamic packer at
    ``eval_seq_len`` / ``train_seq_len`` in the config's wire dtype, the
    partial last batch emitted in eval."""
    cs = config.training.sampling
    if eval:
        chunks = itertools.islice(chunks, int(config.training.eval.eval_samples))
    else:
        chunks = chunk_shuffle_buffer(chunks, buffer_size, rng)
    packer = Packer(seq_len=int(cs.eval_seq_len if eval else cs.train_seq_len),
                    token_range=cs.token_range, patch_size=list(config.tokenizer.model.patch_size),
                    min_grid=cs.min_grid, dtype=wire_dtype(config), rng=rng, flush_final=eval)
    return packer(chunks)
