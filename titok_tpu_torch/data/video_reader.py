"""ctypes wrappers over the port's host libraries (``data/_native.py``):
the libav decoder and encoder, the swscale crop and resize (the ``av``
library) and the fused packer (the ``pack`` library).

Decord-shaped API (reference ``dataset/video_dataset.py:66-68``):
``VideoReader(path_or_bytes)`` with ``len()``, ``.fps``, ``.get_batch(idx)``
returning a ``[n, H, W, 3]`` uint8 array. Each call drops the interpreter
lock while the native code runs, so decode threads overlap.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

from titok_tpu_torch.data import _native

_ERRLEN = 512


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _thwc_u8(frames: np.ndarray, channels=(3,)) -> np.ndarray:
    frames = np.ascontiguousarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] not in channels:
        raise ValueError(f"expected uint8 [T, H, W, C] with C in {channels}, got "
                         f"{frames.dtype} {frames.shape}")
    return frames


class VideoReader:
    """Random-access video decoder over a file path or mp4 bytes."""

    def __init__(self, source: str | bytes):
        lib = _native.load("av")
        err = ctypes.create_string_buffer(_ERRLEN)
        if isinstance(source, (bytes, bytearray, memoryview)):
            buf = bytes(source)
            self._ctx = lib.vd_open_bytes(buf, len(buf), err, _ERRLEN)
        else:
            self._ctx = lib.vd_open_file(os.fspath(source).encode(), err, _ERRLEN)
        if not self._ctx:
            raise IOError(f"video open failed: {err.value.decode()}")
        self._lib = lib
        self.width = lib.vd_width(self._ctx)
        self.height = lib.vd_height(self._ctx)
        self.fps = lib.vd_fps(self._ctx)
        self._len = lib.vd_num_frames(self._ctx)

    def __len__(self) -> int:
        return int(self._len)

    def get_avg_fps(self) -> float:
        return float(self.fps)

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        """Decode frames -> uint8 [n, H, W, 3]."""
        if not self._ctx:
            raise ValueError("VideoReader is closed")
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.empty((len(idx), self.height, self.width, 3), np.uint8)
        err = ctypes.create_string_buffer(_ERRLEN)
        ret = self._lib.vd_get_batch(
            self._ctx, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
            _u8(out), err, _ERRLEN)
        if ret != 0:
            raise IOError(f"decode failed: {err.value.decode()}")
        return out

    def close(self):
        if self._ctx:
            self._lib.vd_close(self._ctx)
            self._ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_ctx", None):
            self.close()


def encode_video(path: str, frames_thwc_uint8: np.ndarray, fps: float = 8.0,
                 codec: str = "mpeg4") -> None:
    """Encode an RGB uint8 [T, H, W, 3] clip to ``path`` (``convert_to_wds``
    and tests; in place of the reference's ffmpeg CLI)."""
    lib = _native.load("av")
    frames = _thwc_u8(frames_thwc_uint8)
    t, h, w, _ = frames.shape
    err = ctypes.create_string_buffer(_ERRLEN)
    ret = lib.vd_encode_video(os.fspath(path).encode(), _u8(frames), t, h, w, float(fps),
                              codec.encode(), err, _ERRLEN)
    if ret != 0:
        raise IOError(f"encode failed: {err.value.decode()}")


def patchify_normalize(frames_thwc_uint8: np.ndarray,
                       patch_size: Sequence[int]) -> np.ndarray:
    """Fused uint8 THWC -> [-1, 1] float32 packed patch rows (``pk_patchify_normalize``).

    Equal bit for bit to its plain version ``decode_rows(patchify_thwc_u8(x))``."""
    lib = _native.load("pack")
    frames = _thwc_u8(frames_thwc_uint8, channels=(1, 3))
    T, H, W, C = frames.shape
    p0, p1, p2 = (int(p) for p in patch_size)
    out = np.empty(((T // p0) * (H // p1) * (W // p2), p0 * p1 * p2 * C), np.float32)
    lib.pk_patchify_normalize(_u8(frames), T, H, W, C, p0, p1, p2,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def resize_frames(frames_thwc_uint8: np.ndarray, out_hw: Sequence[int],
                  crop: Sequence[int] | None = None) -> np.ndarray:
    """Fused crop + bicubic resize of a uint8 THWC frame stack via libswscale
    (``native/frame_resize.cpp``), the chunk sampler's augmentation
    (reference ``dataset/video_dataset.py:95-107``).

    ``crop``: optional (y, x, h, w) window applied before the resize with
    zero copies (a pointer offset into the source stack)."""
    lib = _native.load("av")
    frames = _thwc_u8(frames_thwc_uint8)
    T, H, W, _ = frames.shape
    cy, cx, ch, cw = (int(c) for c in crop) if crop is not None else (0, 0, H, W)
    oh, ow = int(out_hw[0]), int(out_hw[1])
    out = np.empty((T, oh, ow, 3), np.uint8)
    ret = lib.fr_resize_frames(_u8(frames), T, H, W, cy, cx, ch, cw, _u8(out), oh, ow)
    if ret != 0:
        raise ValueError(f"fr_resize_frames failed (code {ret}) for "
                         f"crop=({cy},{cx},{ch},{cw}) of {H}x{W} -> {oh}x{ow}")
    return out
