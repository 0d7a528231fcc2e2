"""TiTok: ViT encoder → quantizer → ViT decoder over packed video batches.

Mirrors the reference model wiring (reference ``model/titok.py``):
``token_size = len(fsq_levels)`` (``titok.py:29``) for FSQ; the EMA-VQ
family (``quantizer: vq``, ``models/vq.py``) has ``token_size = vq.dim``
and carries its codebook as buffers of ``TiTok.quantize``.

Two API layers, as in the JAX package:

- :class:`TiTok` (``nn.Module``) — functions of packed device buffers
  (``data/packing.py:to_device``).
- :class:`TiTokModel` — the tokenizer surface: owns the module on its
  device and takes *lists of videos* and per-sample token counts
  (``encode(x, token_counts, split_indices=True)`` ``titok.py:47-52``,
  ``decode_indices(indices, grids)`` ``titok.py:54-62``).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from titok_tpu_torch import resolve_device
from titok_tpu_torch.data.packing import (
    GridOnly,
    PackedBatch,
    max_samples_for,
    pack_samples,
    sample_offsets,
    to_device,
    unpack_indices,
    unpack_videos,
    video_dims,
)
from titok_tpu_torch.models.blocks import HEAD_DIM, PackedDecoder, PackedEncoder, _PackedViT
from titok_tpu_torch.models.quantizer import FSQ
from titok_tpu_torch.models.vq import EMAVQ, STATE_NAMES, init_vq_state
from titok_tpu_torch.models.transformer import Dense
from titok_tpu_torch.ops.rmsnorm import RMSNorm

_DTYPES = {"bf16": torch.bfloat16, "16": torch.float16, "32": torch.float32}


def compute_dtype(config) -> torch.dtype:
    """The compute dtype ``training.main.precision`` names ('bf16-mixed',
    '32', ...)."""
    return _DTYPES[str(config.training.main.get("precision", "bf16-mixed")).split("-")[0]]


class TiTok(nn.Module):
    """Functional TiTok over packed buffers. ``quantizer``: 'fsq' (the
    reference's) or 'vq' (EMA-VQ, whose state lives in ``quantize``'s
    buffers)."""

    def __init__(self, patch_size: Sequence[int] = (4, 8, 8),
                 fsq_levels: Sequence[int] = (7, 5, 5, 5, 5),
                 encoder_size: str = "tiny", decoder_size: str = "tiny",
                 in_channels: int = 3, dtype=torch.bfloat16,
                 attn_impl: str = "auto", quantizer: str = "fsq",
                 vq_codebook_size: int = 16384, vq_dim: int = 8,
                 vq_commitment_weight: float = 0.25, vq_decay: float = 0.99,
                 vq_dead_steps: int = 256, vq_entropy_weight: float = 0.0,
                 vq_entropy_tau: float = 0.2, remat: bool = False):
        super().__init__()
        if quantizer not in ("fsq", "vq"):
            raise ValueError(f"quantizer {quantizer!r}: expected 'fsq' or 'vq'")
        self.patch_size = tuple(patch_size)
        self.fsq_levels = tuple(fsq_levels)
        self.in_channels = in_channels
        self.dtype = dtype
        self.quantizer = quantizer
        self.vq_codebook_size = int(vq_codebook_size)
        self.vq_dim = int(vq_dim)
        if quantizer == "fsq":
            self.quantize = FSQ(self.fsq_levels)
        else:
            self.quantize = EMAVQ(
                self.vq_codebook_size, self.vq_dim, commitment_weight=vq_commitment_weight,
                decay=vq_decay, dead_steps=vq_dead_steps, entropy_weight=vq_entropy_weight,
                entropy_tau=vq_entropy_tau)
        self.encoder = PackedEncoder(
            model_size=encoder_size, patch_size=self.patch_size,
            in_channels=in_channels, out_channels=self.token_size, dtype=dtype,
            attn_impl=attn_impl, remat=remat)
        self.decoder = PackedDecoder(
            model_size=decoder_size, patch_size=self.patch_size,
            in_channels=self.token_size, out_channels=in_channels, dtype=dtype,
            attn_impl=attn_impl, remat=remat)

    @property
    def token_size(self) -> int:
        return len(self.fsq_levels) if self.quantizer == "fsq" else self.vq_dim

    @property
    def codebook_size(self) -> int:
        return (int(np.prod(self.fsq_levels)) if self.quantizer == "fsq"
                else self.vq_codebook_size)

    def encode_packed(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """[S,P] patches -> ([S, token_size] codes, {'indices': [S]}), valid
        at token slots (ref ``titok.py:47-52``). For EMA-VQ, aux also
        carries ``commit_loss``, the batch statistics, ``perplexity`` and
        ``z``, the detached f32 latents the EMA update reseeds from."""
        z = self.encoder(batch["patches"], batch["token_mask"], batch["segment_ids"],
                         batch["rope_cos"], batch["rope_sin"])
        if self.quantizer == "fsq":
            return self.quantize(z)
        codes, aux = self.quantize(z, weights=batch["token_mask"])
        aux["z"] = z.detach().to(torch.float32)
        return codes, aux

    def decode_packed(self, codes: torch.Tensor, batch: dict) -> torch.Tensor:
        """[S, token_size] codes -> [S, C*prod(patch)] patch pixels."""
        return self.decoder(codes, batch["token_mask"], batch["segment_ids"],
                            batch["rope_cos"], batch["rope_sin"])

    def decode_indices_packed(self, indices: torch.Tensor, batch: dict) -> torch.Tensor:
        """int32 [S] codebook ids -> [S, C*prod(patch)] (ref ``titok.py:54-62``)."""
        codes = self.quantize.indices_to_codes(indices).to(self.dtype)
        return self.decode_packed(codes, batch)

    def forward(self, batch: dict) -> tuple[torch.Tensor, dict]:
        codes, aux = self.encode_packed(batch)
        return self.decode_packed(codes, batch), aux


def make_titok(config, cp_mesh=None, tp_mesh=None) -> TiTok:
    """Build a TiTok module from a Config (ref ``titok.py:24-45``)."""
    if cp_mesh is not None or tp_mesh is not None:
        raise NotImplementedError(
            "context and tensor parallelism are not ported yet (ROADMAP.md, "
            "'Parallel modes')")
    tm = config.tokenizer.model
    vq = tm.get("vq", {}) or {}
    return TiTok(
        patch_size=tuple(tm.patch_size),
        fsq_levels=tuple(tm.fsq_levels),
        encoder_size=tm.encoder_size,
        decoder_size=tm.decoder_size,
        dtype=compute_dtype(config),
        attn_impl=str(config.training.main.get("attn_impl", "auto")),
        quantizer=str(tm.get("quantizer", "fsq")),
        vq_codebook_size=int(vq.get("codebook_size", 16384)),
        vq_dim=int(vq.get("dim", 8)),
        vq_commitment_weight=float(vq.get("commitment_weight", 0.25)),
        vq_decay=float(vq.get("decay", 0.99)),
        vq_dead_steps=int(vq.get("dead_steps", 256)),
        vq_entropy_weight=float(vq.get("entropy_weight", 0.0)),
        vq_entropy_tau=float(vq.get("entropy_tau", 0.2)),
        remat=bool(config.training.main.get("remat", False)),
    )


def state_tensors(params) -> dict[str, torch.Tensor]:
    """A state dict of tensors from ``params``: tensors as they are (on any
    device, so weights drawn on the card load without a host round trip),
    anything else through a numpy copy."""
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.array(v))
            for k, v in params.items()}


def init_params(module: TiTok, seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded numpy weights for every parameter, as the reference inits
    them: dense kernels N(0, 0.02), biases 0, norms 1, mask token
    N(0, width^-1/2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, mod in module.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, Dense):
            out[pre + "weight"] = rng.normal(0.0, 0.02, tuple(mod.weight.shape)).astype(np.float32)
            if mod.bias is not None:
                out[pre + "bias"] = np.zeros(tuple(mod.bias.shape), np.float32)
        elif isinstance(mod, RMSNorm):
            out[pre + "weight"] = np.ones(tuple(mod.weight.shape), np.float32)
        elif isinstance(mod, _PackedViT):
            out[pre + "mask_token"] = (
                rng.normal(0.0, 1.0, (1, 1)) * mod.width ** -0.5).astype(np.float32)
    return out


class TiTokModel:
    """Stateful wrapper with the reference's list-of-videos public API.

    ``params``: a state dict (numpy arrays, or tensors on any device) such
    as ``weights.from_flax_params`` returns; seeded random weights when
    None.
    ``vq_state`` (EMA-VQ only): the codebook and EMA statistics under the
    buffer names (``init_vq_state``, ``weights.from_vq_state(s, "")``);
    taken from ``params``' ``quantize.*`` entries when it has them, else a
    random normal codebook seeded from ``seed + 1``, as the JAX package
    does. ``device``: where the model runs; ``cuda`` when None (raises if
    no card is present; pass ``device="cpu"`` for the plain path on the
    CPU).
    """

    def __init__(self, module: TiTok, params=None, seed: int = 0,
                 seq_len: int = 4096, min_grid: Sequence[int] = (8, 128, 128),
                 device=None, vq_state=None):
        self.device = resolve_device(device)
        self.module = module
        self.seq_len = seq_len
        self.max_samples = max_samples_for(seq_len, min_grid, module.patch_size)
        if params is None:
            params = init_params(module, seed)
        state = state_tensors(params)
        if module.quantizer == "vq":
            if vq_state is None and "quantize.codebook" not in state:
                vq_state = init_vq_state(torch.Generator().manual_seed(seed + 1),
                                         module.vq_codebook_size, module.vq_dim)
            if vq_state is not None:
                state.update({f"quantize.{n}": torch.as_tensor(np.array(vq_state[n]))
                              for n in STATE_NAMES})
        self.module.load_state_dict(state)
        self.module.to(self.device).eval()

    def _dummy_batch(self) -> dict:
        """A packed batch of the model's shape (one zero clip of twice the
        patch size, one token), as numpy arrays: the example an exported
        program is traced on (JAX ``TiTokModel._dummy_batch``)."""
        ps = list(self.module.patch_size)
        vid = np.zeros([self.module.in_channels] + [p * 2 for p in ps], np.float32)
        return pack_samples([vid], [1], seq_len=self.seq_len, max_samples=self.max_samples,
                            patch_size=ps, head_dim=HEAD_DIM).device_arrays()

    def _pack(self, videos, token_counts) -> PackedBatch:
        # uint8 THWC clips go through the packer's normalize+patchify;
        # everything else is the reference's float CTHW wire
        return pack_samples(
            [v if isinstance(v, GridOnly) or getattr(v, "dtype", None) == np.uint8
             else np.asarray(v, np.float32) for v in videos],
            [int(t) for t in token_counts],
            seq_len=self.seq_len, max_samples=self.max_samples,
            patch_size=list(self.module.patch_size), head_dim=HEAD_DIM,
        )

    def _groups(self, videos, token_counts):
        """Split a request into budget-fitting groups."""
        ps = list(self.module.patch_size)
        groups, cur, cur_len = [], [], 0
        for i, (v, tc) in enumerate(zip(videos, token_counts)):
            dims = video_dims(v if isinstance(v, GridOnly) else np.asarray(v))
            cost = math.prod(d // p for d, p in zip(dims, ps)) + int(tc)
            if cost > self.seq_len:
                raise ValueError(f"clip {i} needs {cost} slots > budget {self.seq_len}")
            if cur and (cur_len + cost > self.seq_len or len(cur) >= self.max_samples):
                groups.append(cur)
                cur, cur_len = [], 0
            cur.append(i)
            cur_len += cost
        if cur:
            groups.append(cur)
        return groups

    # -- reference-parity public API --------------------------------------
    @torch.inference_mode()
    def encode(self, videos, token_counts, split_indices: bool = True):
        """Videos -> per-sample int32 codebook indices (ref ``titok.py:47-52``)."""
        per_sample: list = [None] * len(videos)
        for group in self._groups(videos, token_counts):
            batch = self._pack([videos[i] for i in group],
                               [token_counts[i] for i in group])
            _, aux = self.module.encode_packed(to_device(batch, self.device))
            idxs = unpack_indices(aux["indices"].cpu().numpy(), batch)
            for j, i in enumerate(group):
                per_sample[i] = idxs[j]
        if split_indices:
            return per_sample
        return np.concatenate(per_sample)

    @torch.inference_mode()
    def decode_indices(self, indices, grids, token_counts=None):
        """Indices + pixel-space grids -> list of CTHW videos
        (ref ``titok.py:54-62``). ``indices`` is either a list of per-sample
        index arrays, or one flat array with ``token_counts`` given."""
        if token_counts is not None:
            flat_in = np.asarray(indices, np.int32)
            indices = np.split(flat_in, np.cumsum(token_counts)[:-1])
        token_counts = [len(i) for i in indices]
        ps = list(self.module.patch_size)
        placeholders = [GridOnly(grid, self.module.in_channels) for grid in grids]
        out: list = [None] * len(placeholders)
        for group in self._groups(placeholders, token_counts):
            batch = self._pack([placeholders[i] for i in group],
                               [token_counts[i] for i in group])
            # the indices go to their token slots; patch slots stay 0
            offs = sample_offsets(batch.token_counts, batch.grid_sizes)
            flat = np.zeros((batch.seq_len,), np.int32)
            for j, i in enumerate(group):
                flat[offs[j]: offs[j] + len(indices[i])] = np.asarray(indices[i], np.int32)
            recon = self.module.decode_indices_packed(
                torch.from_numpy(flat).to(self.device), to_device(batch, self.device))
            vids = unpack_videos(recon.to(torch.float32).cpu().numpy(), batch, ps)
            for j, i in enumerate(group):
                out[i] = vids[j]
        return out

    @torch.inference_mode()
    def forward(self, videos, token_counts):
        """Videos -> (reconstructions, {'indices': per-sample list})
        (ref ``titok.py:68-74``)."""
        out: list = [None] * len(videos)
        idx_out: list = [None] * len(videos)
        for group in self._groups(videos, token_counts):
            batch = self._pack([videos[i] for i in group],
                               [token_counts[i] for i in group])
            recon, aux = self.module(to_device(batch, self.device))
            vids = unpack_videos(recon.to(torch.float32).cpu().numpy(), batch,
                                 list(self.module.patch_size))
            idxs = unpack_indices(aux["indices"].cpu().numpy(), batch)
            for j, i in enumerate(group):
                out[i] = vids[j]
                idx_out[i] = idxs[j]
        return out, {"indices": idx_out}

    __call__ = forward
