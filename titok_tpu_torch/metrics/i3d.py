"""InceptionI3d (Kinetics-400), the FVD feature extractor, on the card (the
JAX package's ``titok_tpu/metrics/i3d.py``).

The standard Kinetics InceptionI3d (Carreira & Zisserman 2017;
piergiaj/pytorch-i3d layout): ``Unit3D`` = Conv3d without bias + folded
BatchNorm ``x * bn_scale + bn_offset`` + ReLU, nine Inception blocks, an
average-pool head and a 1x1x1 logits conv to 400 classes. FVD uses the
logits as features. Inference only, fp32, NCTHW.

What JAX's semantics fix, and this module keeps:

- TF-SAME padding, which is asymmetric: ``pad = max((ceil(n/s) - 1) * s +
  k - n, 0)``, ``pad // 2`` in front and the rest behind (a stride-2 7x7x7
  conv on an even size pads 2 and 3). Padding is explicit, the conv
  unpadded.
- TF-SAME max pools pad with ``-inf``, then pool unpadded.
- The head averages over a window of ``(min(2, T'), min(7, H'), min(7,
  W'))``, VALID at stride 1, then the logits conv (with bias) and a mean
  over T, H and W.
- :func:`preprocess_bcthw` resizes as ``jax.image.resize(...,
  "trilinear")``, which antialiases on a downscale
  (:func:`titok_tpu_torch.ops.frames.linear_resize`), and repeats the last
  frame up to 10 frames.

Weights: the flat ``.npz`` of ``tools/convert_i3d.py`` (the file the JAX
package reads), through :func:`load_i3d_params`.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from titok_tpu_torch import resolve_device
from titok_tpu_torch.metrics.fp32 import strict_fp32
from titok_tpu_torch.ops.frames import linear_resize
from titok_tpu_torch.weights import load_flat_npz

# (b0, (b1a, b1b), (b2a, b2b), b3) output channels of each Mixed block
# (piergiaj/pytorch-i3d InceptionI3d.__init__)
MIXED_CHANNELS = {
    "Mixed_3b": (64, (96, 128), (16, 32), 32),
    "Mixed_3c": (128, (128, 192), (32, 96), 64),
    "Mixed_4b": (192, (96, 208), (16, 48), 64),
    "Mixed_4c": (160, (112, 224), (24, 64), 64),
    "Mixed_4d": (128, (128, 256), (24, 64), 64),
    "Mixed_4e": (112, (144, 288), (32, 64), 64),
    "Mixed_4f": (256, (160, 320), (32, 128), 128),
    "Mixed_5b": (256, (160, 320), (32, 128), 128),
    "Mixed_5c": (384, (192, 384), (48, 128), 128),
}


def same_pads(sizes: Sequence[int], kernel: Sequence[int], strides: Sequence[int]) -> list[int]:
    """TF-SAME padding of the last ``len(sizes)`` axes, in ``F.pad``'s
    order (last axis first, front then back)."""
    pads = []
    for n, k, s in reversed(list(zip(sizes, kernel, strides))):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


class Unit3D(nn.Module):
    """Conv3d (bias only on the logits) + folded BatchNorm + optional ReLU."""

    def __init__(self, cin: int, features: int, kernel=(1, 1, 1), strides=(1, 1, 1),
                 relu: bool = True, bn: bool = True, bias: bool = False):
        super().__init__()
        self.kernel, self.strides, self.relu = tuple(kernel), tuple(strides), relu
        self.conv = nn.Conv3d(cin, features, self.kernel, self.strides, bias=bias)
        if bn:
            self.bn_scale = nn.Parameter(torch.ones(features))
            self.bn_offset = nn.Parameter(torch.zeros(features))
        else:
            self.bn_scale = self.bn_offset = None

    def forward(self, x):
        pads = same_pads(x.shape[2:], self.kernel, self.strides)
        x = self.conv(F.pad(x, pads) if any(pads) else x)
        if self.bn_scale is not None:
            x = x * self.bn_scale.view(1, -1, 1, 1, 1) + self.bn_offset.view(1, -1, 1, 1, 1)
        return F.relu(x) if self.relu else x


def max_pool_same(x, window, strides):
    """TF-SAME 3-D max pool of NCTHW: ``-inf`` padding, then unpadded."""
    x = F.pad(x, same_pads(x.shape[2:], window, strides), value=float("-inf"))
    return F.max_pool3d(x, window, strides)


class InceptionBlock(nn.Module):
    def __init__(self, cin: int, ch: tuple):
        super().__init__()
        b0, (b1a, b1b), (b2a, b2b), b3 = ch
        self.b0 = Unit3D(cin, b0)
        self.b1a = Unit3D(cin, b1a)
        self.b1b = Unit3D(b1a, b1b, kernel=(3, 3, 3))
        self.b2a = Unit3D(cin, b2a)
        self.b2b = Unit3D(b2a, b2b, kernel=(3, 3, 3))
        self.b3 = Unit3D(cin, b3)
        self.out_channels = b0 + b1b + b2b + b3

    def forward(self, x):
        y3 = self.b3(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), y3], dim=1)


class InceptionI3d(nn.Module):
    """NCTHW in [-1, 1] -> ``[N, num_classes]`` logits."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, kernel=(7, 7, 7), strides=(2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, kernel=(3, 3, 3))
        cin = 192
        for name, ch in MIXED_CHANNELS.items():
            block = InceptionBlock(cin, ch)
            self.add_module(name, block)
            cin = block.out_channels
        self.logits = Unit3D(cin, num_classes, relu=False, bn=False, bias=True)

    def forward(self, x):
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        window = (min(2, x.shape[2]), min(7, x.shape[3]), min(7, x.shape[4]))
        x = F.avg_pool3d(x, window, stride=1)  # VALID: a sum over the window / its size
        return self.logits(x).mean(dim=(2, 3, 4))


def preprocess_bcthw(video: torch.Tensor, target: int = 224, min_frames: int = 10) -> torch.Tensor:
    """FVD preprocessing of BCTHW in [-1, 1] on ``video``'s device: the
    JAX package's trilinear resize of H and W to ``target`` (antialiased
    on a downscale), then the last frame repeated up to ``min_frames``.
    Returns NCTHW f32."""
    b, c, t, h, w = video.shape
    x = video.to(torch.float32)
    if h != target or w != target:
        x = linear_resize(x, (b, c, t, target, target))
    if t < min_frames:
        x = torch.cat([x, x[:, :, -1:].expand(b, c, min_frames - t, *x.shape[3:])], dim=2)
    return x


class I3DExtractor:
    """FVD features on ``device``: ``video_bcthw`` (numpy) in [-1, 1] ->
    ``[B, num_classes]`` numpy logits."""

    def __init__(self, params: dict, num_classes: int = 400, target: int = 224,
                 device=None):
        self.device = resolve_device(device)
        self.target = target
        self.model = InceptionI3d(num_classes).to(self.device).eval()
        self.model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})

    def __call__(self, video_bcthw: np.ndarray) -> np.ndarray:
        with strict_fp32():
            x = torch.from_numpy(np.ascontiguousarray(video_bcthw, np.float32)).to(self.device)
            return self.model(preprocess_bcthw(x, self.target)).cpu().numpy()


def load_i3d_params(path: str) -> dict[str, np.ndarray]:
    """The converted ``.npz`` (``tools/convert_i3d.py``) as the state dict
    of :class:`InceptionI3d`."""
    return load_flat_npz(path)
