"""V-JEPA video ViT + the SSv2 attentive probe, the JEDi feature extractor,
on the card (the JAX package's ``titok_tpu/metrics/vjepa.py``).

- 3-D patch embed: Conv3d(3 -> D, kernel (tubelet, 16, 16), stride the
  same, with bias), tokens t-outer, then h, then w.
- Fixed 3-D sin-cos positions (``uniform_power``: every axis ``ceil(D/6)*2``
  channels, trimmed to D). On an input grid other than the pretrain grid
  the pretrain-grid table is *interpolated* (``jax.image.resize``
  trilinear, :func:`titok_tpu_torch.ops.frames.linear_resize`), not
  recomputed.
- Pre-LN blocks (qkv and proj with bias, exact GELU, LayerNorm eps 1e-6),
  final LayerNorm.
- Attentive pooler: one learned query cross-attends the LayerNormed
  tokens (the query is not normed); residual, then a residual MLP.
- Attention is dense ``matmul`` -> softmax -> ``matmul`` in fp32, as the
  JAX package's ``einsum``.
- Host preprocessing (numpy, bit for bit the JAX package's): [-1, 1] ->
  [0, 1], bicubic short-side resize to ``crop_size`` without antialias
  (a = -0.75, half-pixel), ImageNet normalisation, the last frame repeated
  up to ``frames_per_clip``.

Weights: the flat ``.npz`` of ``tools/convert_vjepa.py`` through
:func:`load_vjepa_params`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from titok_tpu_torch import resolve_device
from titok_tpu_torch.metrics.fp32 import strict_fp32
from titok_tpu_torch.ops.frames import linear_resize
from titok_tpu_torch.weights import load_flat_npz

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclass(frozen=True)
class VJEPASpec:
    embed_dim: int
    depth: int
    num_heads: int
    patch_size: int = 16
    tubelet_size: int = 2
    frames_per_clip: int = 16
    crop_size: int = 224
    mlp_ratio: float = 4.0
    uniform_power: bool = True  # jepa video configs set this

    @property
    def grid(self) -> tuple[int, int, int]:
        return (self.frames_per_clip // self.tubelet_size,
                self.crop_size // self.patch_size,
                self.crop_size // self.patch_size)


# jepa model family (src/models/vision_transformer.py vit_large/vit_huge)
SPECS = {
    "vit_large": VJEPASpec(embed_dim=1024, depth=24, num_heads=16),
    "vit_huge": VJEPASpec(embed_dim=1280, depth=32, num_heads=16),
    # small spec for tests (not a jepa release size)
    "test_tiny": VJEPASpec(embed_dim=48, depth=2, num_heads=4, patch_size=8,
                           tubelet_size=2, frames_per_clip=4, crop_size=32),
}


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """MAE-style 1-D sin-cos table ``[len(pos), embed_dim]``: the sin block,
    then the cos block."""
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_3d_sincos_pos_embed(embed_dim: int, grid_d: int, grid_h: int, grid_w: int,
                            uniform_power: bool = True) -> np.ndarray:
    """``[T*H*W, embed_dim]`` fixed positions, t-outer. Without
    ``uniform_power`` depth gets D/2 channels and each spatial axis D/4;
    with it every axis gets ``ceil(D/6)*2``, trimmed to D."""
    if uniform_power:
        d_dim = h_dim = w_dim = int(np.ceil(embed_dim / 6) * 2)
    else:
        d_dim, h_dim, w_dim = embed_dim // 2, embed_dim // 4, embed_dim // 4
    emb_d = _sincos_1d(d_dim, np.arange(grid_d))
    emb_h = _sincos_1d(h_dim, np.arange(grid_h))
    emb_w = _sincos_1d(w_dim, np.arange(grid_w))
    out = np.concatenate(
        [
            np.broadcast_to(emb_d[:, None, None, :], (grid_d, grid_h, grid_w, d_dim)),
            np.broadcast_to(emb_h[None, :, None, :], (grid_d, grid_h, grid_w, h_dim)),
            np.broadcast_to(emb_w[None, None, :, :], (grid_d, grid_h, grid_w, w_dim)),
        ],
        axis=-1,
    ).reshape(grid_d * grid_h * grid_w, -1)
    return out[:, :embed_dim].astype(np.float32)


def interpolate_pos_embed(table: torch.Tensor, src_grid, dst_grid) -> torch.Tensor:
    """The pretrain-grid table ``[T*H*W, D]`` resampled trilinearly onto
    ``dst_grid`` (as ``jax.image.resize``); unchanged when the grids
    match."""
    if tuple(src_grid) == tuple(dst_grid):
        return table
    d = table.shape[-1]
    return linear_resize(table.reshape(*src_grid, d), (*dst_grid, d)).reshape(-1, d)


def _attention(q, k, v):
    """Dense softmax attention over ``[..., Lq, hd]`` / ``[..., Lk, hd]``."""
    attn = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(attn, dim=-1), v)


class Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(d, hidden), nn.Linear(hidden, d)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))  # exact GELU


class SelfAttention(nn.Module):
    def __init__(self, d: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv, self.proj = nn.Linear(d, 3 * d), nn.Linear(d, d)

    def forward(self, x):
        b, n, d = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, d // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each [b, h, n, hd]
        return self.proj(_attention(q, k, v).transpose(1, 2).reshape(b, n, d))


class Block(nn.Module):
    def __init__(self, d: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = SelfAttention(d, num_heads)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = Mlp(d, int(d * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VJEPAEncoder(nn.Module):
    """Normalised NTHWC video -> ``[B, N, D]`` tokens."""

    def __init__(self, spec: VJEPASpec):
        super().__init__()
        s = self.spec = spec
        kernel = (s.tubelet_size, s.patch_size, s.patch_size)
        self.patch_embed = nn.Conv3d(3, s.embed_dim, kernel, stride=kernel)
        for i in range(s.depth):
            self.add_module(f"blocks_{i}", Block(s.embed_dim, s.num_heads, s.mlp_ratio))
        self.norm = nn.LayerNorm(s.embed_dim, eps=1e-6)
        self.register_buffer("pos_table", torch.from_numpy(get_3d_sincos_pos_embed(
            s.embed_dim, *s.grid, uniform_power=s.uniform_power)), persistent=False)

    def forward(self, x):
        x = self.patch_embed(x.permute(0, 4, 1, 2, 3))  # [B, D, T', H', W']
        grid = tuple(x.shape[2:])
        x = x.flatten(2).transpose(1, 2)
        x = x + interpolate_pos_embed(self.pos_table, self.spec.grid, grid)[None]
        for i in range(self.spec.depth):
            x = getattr(self, f"blocks_{i}")(x)
        return self.norm(x)


class CrossAttention(nn.Module):
    """q projects the query tokens, kv the sequence."""

    def __init__(self, d: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q, self.kv, self.proj = nn.Linear(d, d), nn.Linear(d, 2 * d), nn.Linear(d, d)

    def forward(self, q, x):
        b, nq, d = q.shape
        h, hd = self.num_heads, d // self.num_heads
        qh = self.q(q).reshape(b, nq, h, hd).transpose(1, 2)
        k, v = self.kv(x).reshape(b, x.shape[1], 2, h, hd).permute(2, 0, 3, 1, 4)
        return self.proj(_attention(qh, k, v).transpose(1, 2).reshape(b, nq, d))


class AttentivePooler(nn.Module):
    """One learned query cross-attends the tokens; residual + MLP. The
    tokens are LayerNormed (``norm1``), the query is not."""

    def __init__(self, spec: VJEPASpec):
        super().__init__()
        d = spec.embed_dim
        self.query_tokens = nn.Parameter(torch.zeros(1, 1, d))
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.xattn = CrossAttention(d, spec.num_heads)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = Mlp(d, int(d * spec.mlp_ratio))

    def forward(self, tokens):
        q = self.query_tokens.expand(tokens.shape[0], 1, -1)
        q = q + self.xattn(q, self.norm1(tokens))
        q = q + self.mlp(self.norm2(q))
        return q[:, 0]


class VJEPAFeatures(nn.Module):
    """Encoder + attentive pooler: normalised NTHWC video -> ``[B, D]``."""

    def __init__(self, spec: VJEPASpec):
        super().__init__()
        self.encoder = VJEPAEncoder(spec)
        self.pooler = AttentivePooler(spec)

    def forward(self, x):
        return self.pooler(self.encoder(x))


# ---- preprocessing (host, numpy) ------------------------------------------


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution weights, a=-0.75 (torch bicubic)."""
    t = np.abs(t)
    t2, t3 = t * t, t * t * t
    w = np.where(
        t <= 1, (a + 2) * t3 - (a + 3) * t2 + 1,
        np.where(t < 2, a * t3 - 5 * a * t2 + 8 * a * t - 4 * a, 0.0),
    )
    return w


def _resize_axis_cubic(x: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """Separable bicubic resize along one axis, half-pixel centers, no
    antialias (``F.interpolate(mode='bicubic', align_corners=False,
    antialias=False)``)."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    scale = in_size / out_size
    centers = (np.arange(out_size) + 0.5) * scale - 0.5
    base = np.floor(centers).astype(np.int64)
    offs = np.arange(-1, 3)
    idx = np.clip(base[:, None] + offs[None, :], 0, in_size - 1)  # [O, 4]
    w = _cubic_kernel(centers[:, None] - (base[:, None] + offs[None, :]))
    w = (w / w.sum(axis=1, keepdims=True)).astype(x.dtype)
    moved = np.moveaxis(x, axis, 0)  # [I, ...]
    gathered = moved[idx]  # [O, 4, ...]
    out = np.einsum("of,of...->o...", w, gathered)
    return np.moveaxis(out, 0, axis)


def resize_short_side_bicubic(video_tchw: np.ndarray, target: int) -> np.ndarray:
    """Scale so the short side equals ``target``, keeping the aspect ratio
    (torchvision ``v2.Resize(size=int)``)."""
    t, c, h, w = video_tchw.shape
    if h <= w:
        nh, nw = target, max(1, int(round(w * target / h)))
    else:
        nh, nw = max(1, int(round(h * target / w))), target
    out = _resize_axis_cubic(video_tchw, 2, nh)
    return _resize_axis_cubic(out, 3, nw)


def preprocess_bcthw(video_bcthw: np.ndarray, spec: VJEPASpec) -> np.ndarray:
    """[-1, 1] -> [0, 1], bicubic short-side resize to ``crop_size``,
    ImageNet normalisation, the last frame repeated up to
    ``frames_per_clip``. Returns NTHWC float32."""
    v = np.clip(np.asarray(video_bcthw, np.float32), -1, 1)
    v = (v + 1.0) / 2.0
    out = []
    for clip in v:  # CTHW
        x = clip.transpose(1, 0, 2, 3)  # TCHW
        x = resize_short_side_bicubic(x, spec.crop_size)
        x = (x - IMAGENET_MEAN[None, :, None, None]) / IMAGENET_STD[None, :, None, None]
        if x.shape[0] < spec.frames_per_clip:
            pad = np.repeat(x[-1:], spec.frames_per_clip - x.shape[0], axis=0)
            x = np.concatenate([x, pad], axis=0)
        out.append(x.transpose(0, 2, 3, 1))  # THWC
    return np.stack(out).astype(np.float32)


class VJEPAExtractor:
    """JEDi features on ``device``: ``video_bcthw`` (numpy) in [-1, 1] ->
    ``[B, D]`` numpy (a ``feature_fn`` for
    :class:`titok_tpu_torch.metrics.jedi.JEDiMetric`)."""

    def __init__(self, params: dict, model_name: str = "vit_large", device=None):
        self.spec = SPECS[model_name]
        self.device = resolve_device(device)
        self.model = VJEPAFeatures(self.spec).to(self.device).eval()
        self.model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})

    def __call__(self, video_bcthw: np.ndarray) -> np.ndarray:
        x = preprocess_bcthw(video_bcthw, self.spec)
        with strict_fp32():
            return self.model(torch.from_numpy(x).to(self.device)).cpu().numpy()


def load_vjepa_params(path: str) -> dict[str, np.ndarray]:
    """The converted ``.npz`` (``tools/convert_vjepa.py``) as the state
    dict of :class:`VJEPAFeatures`."""
    return load_flat_npz(path)
