"""InceptionV3 (torchvision layout), the FID / IS / MMD image feature
extractor, on the card (the JAX package's
``titok_tpu/metrics/inception_v3.py``).

The reference's sliced forward: a bilinear upsample to 299² with
``align_corners=True`` (source coordinates ``linspace(0, n-1)``, not
half-pixel centres), the stem and every Mixed block, an 8x8 average pool
to ``[N, 2048]`` activations, and the 1000-way ``fc`` for the Inception
Score. ``BasicConv2d`` is a Conv2d without bias + folded BatchNorm
(``bn_scale``, ``bn_offset``) + ReLU with torch's explicit paddings; max
pools are VALID; the 3x3 average pools count their padding. Inference
only, fp32, NCHW.

Weights: the flat ``.npz`` of ``tools/convert_inception.py`` through
:func:`load_inception_extractor`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from titok_tpu_torch import resolve_device
from titok_tpu_torch.metrics.fp32 import strict_fp32
from titok_tpu_torch.weights import load_flat_npz

# per-block 1x1-pool-branch widths / 7x7 bottleneck widths (torchvision
# Inception3.__init__)
POOL_FEATURES = {"Mixed_5b": 32, "Mixed_5c": 64, "Mixed_5d": 64}
C7 = {"Mixed_6b": 128, "Mixed_6c": 160, "Mixed_6d": 160, "Mixed_6e": 192}


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, features: int, kernel, stride=(1, 1), padding=(0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, stride, padding, bias=False)
        self.bn_scale = nn.Parameter(torch.ones(features))
        self.bn_offset = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        x = self.conv(x)
        return F.relu(x * self.bn_scale.view(1, -1, 1, 1) + self.bn_offset.view(1, -1, 1, 1))


def _avg_pool_3x3_same(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool_3x3_s2(x):
    return F.max_pool2d(x, 3, stride=2)  # VALID


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, (1, 1))
        self.branch5x5_1 = BasicConv2d(cin, 48, (1, 1))
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = BasicConv2d(cin, pool_features, (1, 1))
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, (3, 3), stride=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), stride=(2, 2))
        self.out_channels = 384 + 96 + cin

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool_3x3_s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, (1, 1))
        self.branch7x7_1 = BasicConv2d(cin, c7, (1, 1))
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, (1, 1))
        self.out_channels = 4 * 192

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, (1, 1))
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), stride=(2, 2))
        self.branch7x7x3_1 = BasicConv2d(cin, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), stride=(2, 2))
        self.out_channels = 320 + 192 + cin

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool_3x3_s2(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, (1, 1))
        self.branch3x3_1 = BasicConv2d(cin, 384, (1, 1))
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, (1, 1))
        self.out_channels = 320 + 768 + 768 + 192

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([self.branch1x1(x), b3, bd, bp], dim=1)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``nn.Upsample(mode='bilinear', align_corners=True)`` of NCHW: source
    coordinates ``linspace(0, n-1, n_out)``; a separable gather and lerp,
    as the JAX package computes it."""

    def axis_interp(arr, n_out, axis):
        n_in = arr.shape[axis]
        if n_in == n_out:
            return arr
        if n_out == 1:
            coords = torch.zeros(1, dtype=torch.float32, device=arr.device)
        else:
            coords = torch.linspace(0.0, n_in - 1.0, n_out, dtype=torch.float32,
                                    device=arr.device)
        lo = torch.clamp(torch.floor(coords).long(), 0, n_in - 1)
        hi = torch.clamp(lo + 1, max=n_in - 1)
        shape = [1] * arr.ndim
        shape[axis] = n_out
        w = (coords - lo).to(arr.dtype).reshape(shape)
        return (torch.index_select(arr, axis, lo) * (1 - w)
                + torch.index_select(arr, axis, hi) * w)

    return axis_interp(axis_interp(x, out_h, 2), out_w, 3)


class InceptionV3(nn.Module):
    """NCHW images in [-1, 1] -> ``(activations [N, 2048], logits [N,
    num_classes])``."""

    def __init__(self, num_classes: int = 1000, resize_to: int = 299):
        super().__init__()
        self.resize_to = resize_to
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=(2, 2))
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        blocks = [(name, InceptionA, (POOL_FEATURES[name],)) for name in POOL_FEATURES]
        blocks.append(("Mixed_6a", InceptionB, ()))
        blocks += [(name, InceptionC, (C7[name],)) for name in C7]
        blocks += [("Mixed_7a", InceptionD, ()), ("Mixed_7b", InceptionE, ()),
                   ("Mixed_7c", InceptionE, ())]
        self.blocks = [name for name, _, _ in blocks]
        cin = 192
        for name, block_cls, args in blocks:
            block = block_cls(cin, *args)
            self.add_module(name, block)
            cin = block.out_channels
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x):
        if self.resize_to:
            x = resize_bilinear_align_corners(x, self.resize_to, self.resize_to)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool_3x3_s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool_3x3_s2(x)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = F.avg_pool2d(x, 8, stride=8)
        acts = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flattened as NHWC
        return acts, self.fc(acts)


class InceptionExtractor:
    """``images_nchw`` (numpy) in [-1, 1] -> ``(features, logits)`` numpy,
    on ``device`` (a ``feature_fn`` for
    :class:`titok_tpu_torch.metrics.image_metrics.MetricCalculator`)."""

    def __init__(self, params: dict, resize_to: int = 299, device=None):
        self.device = resolve_device(device)
        self.model = InceptionV3(resize_to=resize_to).to(self.device).eval()
        self.model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})

    def __call__(self, images_nchw: np.ndarray):
        with strict_fp32():
            x = torch.from_numpy(np.ascontiguousarray(images_nchw, np.float32)).to(self.device)
            acts, logits = self.model(x)
            return acts.cpu().numpy(), logits.cpu().numpy()


def load_inception_extractor(npz_path: str, resize_to: int = 299, device=None):
    """The converted ``.npz`` (``tools/convert_inception.py``) as a ready
    :class:`InceptionExtractor`."""
    return InceptionExtractor(load_flat_npz(npz_path), resize_to=resize_to, device=device)
