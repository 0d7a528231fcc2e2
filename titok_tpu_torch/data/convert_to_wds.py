"""Pack a tree of videos into WebDataset-style tar shards (reference
``dataset/convert_to_wds.py``; the JAX package's
``titok_tpu/data/convert_to_wds.py``).

The reference re-encodes through the ffmpeg CLI (h264 crf 23) and writes
512-sample shards with uuid keys through ``wds.ShardWriter``. This one
copies ``.mp4`` inputs byte for byte (no quality loss, no CLI) and
re-encodes other containers, or every input with ``--reencode``, through
the port's libav encoder (``video_reader.encode_video``; mpeg4, or any
encoder libavcodec has, by ``--codec``). Shards are
``OUT_DIR/00000.tar``, ``00001.tar``, ... and read back through
``wds_batches`` as ``OUT_DIR/{00000..0000N}.tar``.

Usage:
    python -m titok_tpu_torch.data.convert_to_wds IN_DIR OUT_DIR \\
        [--shard-size 512] [--codec mpeg4] [--reencode]
"""

from __future__ import annotations

import argparse
import glob
import io
import os
import tarfile
import tempfile
import uuid

import numpy as np

from titok_tpu_torch.data.video_reader import VideoReader, encode_video

VIDEO_EXTS = ("mp4", "avi", "mkv", "mov", "webm")


def _iter_videos(in_dir: str):
    for ext in VIDEO_EXTS:
        yield from glob.iglob(os.path.join(in_dir, "**", f"*.{ext}"), recursive=True)


def _transcode(path: str, codec: str) -> bytes:
    """Decode every frame and encode them again to mp4 bytes."""
    with VideoReader(path) as vr:
        frames = vr.get_batch(np.arange(len(vr)))
        fps = max(vr.fps, 1.0)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "clip.mp4")
        encode_video(out, frames, fps=fps, codec=codec)
        with open(out, "rb") as f:
            return f.read()


class ShardWriter:
    """A minimal ``wds.ShardWriter``: tar shards of ``maxcount`` samples,
    named by ``pattern % shard`` (``%05d``)."""

    def __init__(self, pattern: str, maxcount: int = 512):
        self.pattern = pattern
        self.maxcount = maxcount
        self.shard = -1
        self.count = 0
        self.tar = None
        self._next_shard()

    def _next_shard(self):
        if self.tar:
            self.tar.close()
        self.shard += 1
        self.count = 0
        path = self.pattern % self.shard
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.tar = tarfile.open(path, "w")

    def write(self, sample: dict):
        if self.count >= self.maxcount:
            self._next_shard()
        key = sample["__key__"]
        for ext, data in sample.items():
            if ext == "__key__":
                continue
            info = tarfile.TarInfo(f"{key}.{ext}")
            info.size = len(data)
            self.tar.addfile(info, io.BytesIO(data))
        self.count += 1

    def close(self):
        if self.tar:
            self.tar.close()
            self.tar = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def convert(in_dir: str, out_dir: str, shard_size: int = 512, codec: str = "mpeg4",
            reencode: bool = False) -> int:
    """Write every video under ``in_dir`` into shards under ``out_dir``;
    returns the number written. A video that cannot be read or encoded is
    skipped with a printed line."""
    n = 0
    with ShardWriter(os.path.join(out_dir, "%05d.tar"), shard_size) as writer:
        for path in _iter_videos(in_dir):
            try:
                if path.endswith(".mp4") and not reencode:
                    with open(path, "rb") as f:
                        data = f.read()
                else:
                    data = _transcode(path, codec)
            except (OSError, ValueError) as e:
                print(f"skip {path}: {e}")
                continue
            writer.write({"__key__": uuid.uuid4().hex, "mp4": data})
            n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("in_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--shard-size", type=int, default=512)
    ap.add_argument("--codec", default="mpeg4")
    ap.add_argument("--reencode", action="store_true")
    args = ap.parse_args(argv)
    n = convert(args.in_dir, args.out_dir, args.shard_size, args.codec, args.reencode)
    print(f"wrote {n} samples")
    return n


if __name__ == "__main__":
    main()
