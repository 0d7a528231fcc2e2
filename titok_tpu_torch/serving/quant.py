"""Post-training int8 quantization for the serving path (the JAX package's
``titok_tpu/serving/quant.py``).

Per-output-channel symmetric int8 weights for every ``Dense`` of a TiTok
generator; norms, attention, RoPE and the quantizer stay in their trained
precisions. JAX reroutes ``nn.Dense.__call__`` with a flax method
interceptor; here :func:`quantize_module` returns a copy of the module in
which every ``Dense`` whose weight is quantized is replaced by an
:class:`Int8Dense` that holds ``q`` (int8) and ``s`` (f32, one scale an
output channel) as buffers. The original module is left untouched, and a
``Dense`` left in float runs as before.

Layout: a flax kernel is ``[in, out]`` and its scale the column amax; a
torch weight is ``[out, in]``, so the amax is taken over dim 1, and ``q``
is JAX's transposed, bit for bit on the same f32 weights.

Two modes, as JAX computes them:

- ``w8a16`` (weight-only): ``y = (x_bf16 @ q_bf16) * s`` with the
  accumulator in f32 until the per-channel rescale. On CUDA ``torch.mm``
  with ``out_dtype=torch.float32`` keeps it in f32 (``F.linear`` on bf16
  would round it to bf16 first: another result, not a faster one); a CPU
  build lacks that overload, so the CPU computes the f32 product of the
  same bf16-exact values.
- ``w8a8`` (dynamic): per-row activation scales ``a = amax|x| / 127``,
  ``round(x / a)`` (half to even, as ``jnp.round``) to int8, ``int8 x
  int8 -> int32`` by ``torch._int_mm``, rescale by ``a * s`` in f32.

``torch._int_mm`` on CUDA takes only K and N that are multiples of 8 (and
more than 16 rows); the FSQ encoder's ``proj_out`` (width -> 5) and the
decoder's ``proj_in`` (5 -> width) are not. :class:`Int8Dense` pads its
``q`` with zero rows and columns to multiples of 8 (zero padding is exact
in integer arithmetic), :func:`_int8_dense` pads the activations to match
and slices the output to ``s``'s channels. Both matmuls are library calls:
JAX computes them outside any Pallas kernel (``lax.dot_general``).
"""

from __future__ import annotations

import copy
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from titok_tpu_torch.models.transformer import Dense

MODES = ("w8a16", "w8a8")
# K and N of an int8 product on CUDA must be multiples of this
PAD = 8


def quantize_kernel(w) -> dict:
    """Symmetric per-output-channel int8 of a ``[out, in]`` weight: ``w ~=
    q * s[:, None]`` with ``s = amax|w_row| / 127``. Returns ``{'q': int8
    [out, in], 's': f32 [out]}``."""
    w = torch.as_tensor(w).to(torch.float32)
    s = torch.clamp(w.abs().amax(dim=1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / s[:, None]), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def _is_kernel(name: str, value) -> bool:
    """A Dense weight: a 2-D float ``*.weight`` (the mask token and the
    EMA-VQ buffers are 2-D too, under other names)."""
    return (name.rsplit(".", 1)[-1] == "weight" and isinstance(value, torch.Tensor)
            and value.dim() == 2 and value.is_floating_point())


def quantize_params(params: Mapping) -> dict:
    """A state dict with every 2-D float weight replaced by its quantized
    form ``{'q', 's'}``; every other entry (biases, norm weights, the mask
    tokens, the EMA-VQ buffers) passes through untouched."""
    return {k: quantize_kernel(v.detach()) if _is_kernel(k, v) else v for k, v in params.items()}


def _is_quantized(entry) -> bool:
    return (isinstance(entry, Mapping) and set(entry) == {"q", "s"}
            and getattr(entry["q"], "dtype", None) == torch.int8)


def dequantize_params(qparams: Mapping) -> dict:
    """Inverse of :func:`quantize_params` (up to rounding): f32 weights
    ``q * s``."""
    return {k: v["q"].to(torch.float32) * v["s"][:, None] if _is_quantized(v) else v
            for k, v in qparams.items()}


def _int8_dense(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, bias: torch.Tensor | None,
                mode: str, out_dtype: torch.dtype) -> torch.Tensor:
    """``x [..., K]`` through an int8 weight ``q [N', K']`` (``N' >= N``,
    ``K' >= K``: zero rows and columns past ``N = len(s)`` and ``K``) with
    per-channel scales ``s [N]``: ``[..., N]`` in ``out_dtype``."""
    lead, K = x.shape[:-1], x.shape[-1]
    N = s.shape[0]
    x2 = x.reshape(-1, K)
    if mode == "w8a16":
        xb = F.pad(x2.to(torch.bfloat16), (0, q.shape[1] - K))
        if x.device.type == "cuda":
            acc = torch.mm(xb, q.t().to(torch.bfloat16), out_dtype=torch.float32)
        else:  # no aten::mm.dtype on the CPU: the f32 product of the same bf16 values
            acc = xb.to(torch.float32) @ q.t().to(torch.float32)
        y = acc[:, :N] * s
    elif mode == "w8a8":
        xf = x2.to(torch.float32)
        a = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-12) / 127.0
        xq = torch.clamp(torch.round(xf / a), -127, 127).to(torch.int8)
        acc = torch._int_mm(F.pad(xq, (0, q.shape[1] - K)), q.t())
        y = acc[:, :N].to(torch.float32) * (a * s)
    else:
        raise ValueError(f"unknown quant mode {mode!r}; want one of {MODES}")
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(out_dtype).reshape(*lead, N)


def _pad_rows_cols(q: torch.Tensor) -> torch.Tensor:
    """``q`` with zero rows and columns up to multiples of :data:`PAD`."""
    n, k = q.shape
    return F.pad(q, (0, -k % PAD, 0, -n % PAD))


class Int8Dense(nn.Module):
    """A ``Dense`` with an int8 weight: ``q`` (int8 ``[out, in]``, zero
    padded to multiples of 8) and ``s`` (f32 ``[out]``) as buffers, the
    bias (f32) as a buffer, and the layer's compute dtype as the output
    dtype (``mod.dtype`` in JAX)."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, bias: torch.Tensor | None,
                 compute_dtype: torch.dtype, mode: str):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown quant mode {mode!r}; want one of {MODES}")
        self.in_features, self.out_features = q.shape[1], q.shape[0]
        self.compute_dtype = compute_dtype
        self.mode = mode
        self.register_buffer("q", _pad_rows_cols(q))
        self.register_buffer("s", s.to(torch.float32))
        self.register_buffer("bias", None if bias is None else bias.detach().to(torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _int8_dense(x, self.q, self.s, self.bias, self.mode, self.compute_dtype)

    def extra_repr(self) -> str:
        return f"in={self.in_features}, out={self.out_features}, mode={self.mode}"


def quantize_module(module: nn.Module, mode: str = "w8a8", qparams: Mapping | None = None):
    """A serving copy of ``module`` (a TiTok) in which every ``Dense`` whose
    entry in ``qparams`` (default :func:`quantize_params` of its state dict)
    is quantized becomes an :class:`Int8Dense`; a ``Dense`` whose entry is a
    float weight keeps it, and runs as before. ``module`` is untouched."""
    if mode not in MODES:
        raise ValueError(f"unknown quant mode {mode!r}; want one of {MODES}")
    if qparams is None:
        qparams = quantize_params(module.state_dict())
    out = copy.deepcopy(module)
    for name, mod in list(out.named_modules()):
        if not isinstance(mod, Dense):
            continue
        entry = qparams[f"{name}.weight"]
        if _is_quantized(entry):
            parent, _, leaf = name.rpartition(".")
            int8 = Int8Dense(entry["q"], entry["s"], mod.bias, mod.compute_dtype, mode)
            setattr(out.get_submodule(parent), leaf, int8.to(mod.weight.device))
        else:
            with torch.no_grad():
                mod.weight.copy_(torch.as_tensor(entry))
    return out


def quantize_model(model, mode: str = "w8a8"):
    """A serving copy of a ``TiTokModel`` whose module runs int8 Dense
    layers (:func:`quantize_module`). The original model is untouched;
    everything else (the packer's settings, the device, the list-of-videos
    API) is the same."""
    m = copy.copy(model)
    m.module = quantize_module(model.module, mode).eval()
    return m
