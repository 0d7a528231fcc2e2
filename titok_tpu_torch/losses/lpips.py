"""LPIPS perceptual metric and Gram-matrix loss (the JAX package's
``titok_tpu/losses/lpips.py``; reference ``model/metrics/lpips_gram.py``).

- five VGG16 feature slices, after relu1_2, 2_2, 3_3, 4_3 and 5_3;
- the input scaling layer's fixed shift and scale;
- channel-L2 normalisation of each slice, squared differences, a learned
  bias-free 1x1 conv per slice, the spatial mean, the sum over slices;
- the Gram-matrix MSE of each slice, meaned over slices.

The module takes NHWC frames at its boundary, as the JAX one does, and
works in NCHW inside for cuDNN's convolutions. It computes in fp32 whatever
the caller's precision: its convolutions run with cuDNN's TF32 off, in the
forward and in the backward, whatever ``torch.backends.cudnn.allow_tf32``
says (PyTorch's default is on); the Gram's matmuls follow PyTorch's fp32
matmul precision, which is full fp32 unless the caller lowers it. Its
weights are frozen constants of the loss: no gradient, no optimizer, no
checkpoint.

Weights come from a ``.npz`` in the flax layout that
``tools/convert_lpips.py`` writes (``net/conv{i}/kernel`` HWIO,
``net/conv{i}/bias``, ``lin{k}/kernel`` ``[1, 1, C, 1]``), so one converted
file serves both packages; :func:`weights.from_flax_params` maps it. Without
the file, :func:`load_lpips_params` draws a seeded random VGG (the JAX
fallback's distributions, not its bits: tests hand both packages the same
weights instead), and :func:`lpips_params_for` refuses that unless the
config sets ``tokenizer.losses.allow_random_lpips``.
"""

from __future__ import annotations

import contextlib
import math
import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from titok_tpu_torch.weights import from_flax_params, unflatten

# VGG16 'features': conv channel sizes, 'M' a 2x2 max pool of stride 2
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512]
# convs (counted without the pools) after which a slice ends:
# relu1_2=conv1, relu2_2=conv3, relu3_3=conv6, relu4_3=conv9, relu5_3=conv12
SLICE_AFTER_CONV = [1, 3, 6, 9, 12]
LPIPS_CHANNELS = [64, 128, 256, 512, 512]

# reference ScalingLayer constants (lpips_gram.py:53-58)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), "weights", "lpips_vgg.npz")


class VGG16Features(nn.Module):
    """The VGG16 conv tower (13 3x3 convs with padding 1 and ReLU, 2x2 max
    pools of stride 2) returning the five LPIPS slices, NCHW."""

    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for v in VGG16_CFG:
            if v != "M":
                self.add_module(f"conv{i}", nn.Conv2d(cin, v, 3, padding=1))
                cin, i = v, i + 1

    def forward(self, x):
        outs, i = [], 0
        for v in VGG16_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                conv = getattr(self, f"conv{i}")
                x = F.relu(_Conv32.apply(x, conv.weight, conv.bias, 1))
                if i in SLICE_AFTER_CONV:
                    outs.append(x)
                i += 1
        return outs


class LPIPS(nn.Module):
    """LPIPS and Gram loss of two ``[K, H, W, 3]`` batches in [-1, 1]:
    ``(lpips [K], gram [K])``. One tower runs over ``cat([x, y])``."""

    def __init__(self):
        super().__init__()
        self.net = VGG16Features()
        for k, c in enumerate(LPIPS_CHANNELS):
            self.add_module(f"lin{k}", nn.Conv2d(c, 1, 1, bias=False))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, x, y):
        K = x.shape[0]
        z = torch.cat([x, y]).to(torch.float32).permute(0, 3, 1, 2)
        feats = self.net(((z - self.shift) / self.scale).contiguous())
        lpips = 0.0
        grams = []
        for k, f in enumerate(feats):
            fx, fy = f[:K], f[K:]
            diff = (_normalize(fx) - _normalize(fy)) ** 2
            lin = _Conv32.apply(diff, getattr(self, f"lin{k}").weight, None, 0)
            lpips = lpips + lin.mean(dim=(1, 2, 3))  # spatial mean -> [K]
            grams.append(((_gram(fx) - _gram(fy)) ** 2).mean(dim=(1, 2)))
        return lpips, torch.stack(grams, dim=-1).mean(-1)


@contextlib.contextmanager
def _no_tf32():
    """cuDNN's TF32 off, the process's flag restored after."""
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


class _Conv32(torch.autograd.Function):
    """``F.conv2d`` (stride 1) with TF32 off in its forward and its
    backward: autograd's own backward reads the flag when it runs, outside
    any context the forward ran in."""

    @staticmethod
    def forward(ctx, x, w, b, padding):
        ctx.save_for_backward(x, w)
        ctx.padding, ctx.bias = padding, b is not None
        with _no_tf32():
            return F.conv2d(x, w, b, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        p = [ctx.padding] * 2
        with _no_tf32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g, x, w, [w.shape[0]] if ctx.bias else None, [1, 1], p, [1, 1], False,
                [0, 0], 1, list(ctx.needs_input_grad[:3]))
        return gx, gw, gb, None


def _normalize(f, eps: float = 1e-10):
    # reference normalize_tensor: x / (sqrt(sum(x^2) + eps) + eps), channels
    norm = torch.sqrt(torch.sum(f * f, dim=1, keepdim=True) + eps)
    return f / (norm + eps)


def _gram(f):
    """``fᵀf / (H·W)`` per frame, fp32: ``[K, C, C]``."""
    K, C, H, W = f.shape
    fm = f.reshape(K, C, H * W)
    return torch.matmul(fm, fm.transpose(1, 2)) / (H * W)


def load_lpips_params(path: str | None = None, seed: int = 0) -> dict[str, np.ndarray]:
    """The LPIPS state dict (numpy, f32) from a converted ``.npz``
    (``DEFAULT_WEIGHTS`` when ``path`` is None), or, when the file does not
    exist, a seeded random VGG with a warning.

    The fallback draws from a ``torch.Generator`` seeded by ``seed``, in the
    JAX fallback's distributions: every kernel as flax's ``lecun_normal``
    (truncated normal in ±2 std, std ``fan_in**-0.5 / 0.8796``), biases
    zero, and each lin kernel then ``|w|`` scaled to mean 1. Random lin
    kernels are sign-indefinite, so their "distance" has arbitrary sign;
    real LPIPS lins are non-negative and the non-learned baseline is all
    ones: ``|w|`` at mean 1 gives a positive semi-metric on that scale."""
    path = path or DEFAULT_WEIGHTS
    if os.path.exists(path):
        with np.load(path) as data:
            return from_flax_params(unflatten(dict(data)))
    warnings.warn(f"LPIPS weights not found at {path} — using seeded random VGG features. "
                  "Run tools/convert_lpips.py to convert the torch weights.")
    g = torch.Generator().manual_seed(seed)

    def lecun(shape):  # HWIO
        std = (math.prod(shape[:-1]) ** -0.5) / 0.87962566103423978
        return nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0,
                                     generator=g).mul_(std).numpy()

    net, cin, i = {}, 3, 0
    for v in VGG16_CFG:
        if v != "M":
            net[f"conv{i}"] = {"kernel": lecun((3, 3, cin, v)), "bias": np.zeros(v, np.float32)}
            cin, i = v, i + 1
    tree = {"net": net}
    for k, c in enumerate(LPIPS_CHANNELS):
        lin = np.abs(lecun((1, 1, c, 1)))
        tree[f"lin{k}"] = {"kernel": lin * np.float32(lin.size / lin.sum())}
    return from_flax_params(tree)


def lpips_params_for(config) -> dict[str, np.ndarray]:
    """The LPIPS weights a config trains with (the JAX trainer's
    ``_load_lpips``): ``tokenizer.losses.lpips_weights``, else
    ``DEFAULT_WEIGHTS``. Without the file it raises: seeded-random VGG
    features are not the reference's perceptual loss (reference
    ``model/metrics/lpips_gram.py:82-101``), and
    ``tokenizer.losses.allow_random_lpips: true`` opts into them."""
    lc = config.tokenizer.losses
    path = lc.get("lpips_weights", None) or DEFAULT_WEIGHTS
    if not os.path.exists(path) and not bool(lc.get("allow_random_lpips", False)):
        raise RuntimeError(
            f"perceptual loss is enabled but no LPIPS weights exist at {path}. Stage "
            "torchvision VGG16 + vgg.pth and run tools/convert_lpips.py, or set "
            "tokenizer.losses.allow_random_lpips: true to train with seeded-random VGG "
            "features (NOT the reference loss).")
    return load_lpips_params(path)
