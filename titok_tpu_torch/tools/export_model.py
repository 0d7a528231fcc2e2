"""Export the tokenizer as self-contained programs (``torch.export``): the
port of the JAX package's ``tools/export_model.py``.

Two programs are traced with the weights (and, for EMA-VQ, the codebook)
baked in, and saved with ``torch.export.save``:

    forward.pt2   batch dict -> (recon_rows [S, P], indices [S])
    decode.pt2    (indices [S], batch dict) -> recon_rows [S, P]
    meta.json     seq_len, max_samples, head_dim, patch_size, in_channels,
                  quantizer, device, quant

The attention and VQ kernels are ``torch.library`` custom ops
(``ops/custom_ops.py``), so each call is one node of the program: it runs
the kernel on the card (counted in its ``launches``) and the plain version
on the CPU. A program runs on the device it was exported on (``device`` in
``meta.json``). A serving host loads the programs with :func:`load_exported`,
which needs torch and the custom ops, and nothing of the models: no config,
no checkpoint. It packs its batches with ``data/packing.py`` at the shape
``meta.json`` records.

Usage::

    python -m titok_tpu_torch.tools.export_model --config configs/tiny.yaml \\
        --ckpt out_ckpt/12000 --out exported/ [--quant w8a8] [--check]

    # serving side
    from titok_tpu_torch.tools.export_model import load_exported
    fwd, dec, meta = load_exported("exported/")
    with torch.no_grad():
        recon_rows, indices = fwd(to_device(batch, meta["device"]))

Trace and call under ``torch.no_grad()`` (not ``inference_mode``): the
kernels' no-grad forwards are the custom ops.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
from torch import nn

PROGRAMS = ("forward.pt2", "decode.pt2")


class _Forward(nn.Module):
    """batch -> (recon_rows, indices) of a TiTok."""

    def __init__(self, titok: nn.Module):
        super().__init__()
        self.titok = titok

    def forward(self, batch: dict):
        recon, aux = self.titok(batch)
        return recon, aux["indices"]


class _Decode(nn.Module):
    """(indices, batch) -> recon_rows: a TiTok's quantizer and decoder only,
    so the program holds no encoder weights."""

    def __init__(self, titok: nn.Module):
        super().__init__()
        self.quantize, self.decoder, self.dtype = titok.quantize, titok.decoder, titok.dtype

    def forward(self, indices: torch.Tensor, batch: dict):
        codes = self.quantize.indices_to_codes(indices).to(self.dtype)
        return self.decoder(codes, batch["token_mask"], batch["segment_ids"],
                            batch["rope_cos"], batch["rope_sin"])


def _tensors(arrays: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v)))
            .to(device) for k, v in arrays.items()}


def export_model(module: nn.Module, example_batch: dict, out_dir: str,
                 quant: str | None = None) -> dict:
    """Trace and save the forward and decode programs of ``module`` (a TiTok
    with its weights and buffers, on the device the programs will run on)
    for batches shaped like ``example_batch`` (``PackedBatch.device_arrays()``
    or tensors). With ``quant`` ('w8a16' or 'w8a8') the programs bake the
    int8 buffers of :func:`titok_tpu_torch.serving.quant.quantize_module`.
    Returns the ``meta.json`` it writes."""
    from titok_tpu_torch.models.blocks import HEAD_DIM

    if quant:
        from titok_tpu_torch.serving.quant import quantize_module

        module = quantize_module(module, quant)
    module = module.eval()
    device = next(module.parameters()).device
    batch = _tensors(example_batch, device)
    S = batch["segment_ids"].shape[0]
    indices = torch.zeros((S,), dtype=torch.int32, device=device)
    os.makedirs(out_dir, exist_ok=True)
    with torch.no_grad():
        programs = (torch.export.export(_Forward(module), (batch,)),
                    torch.export.export(_Decode(module), (indices, batch)))
    for name, program in zip(PROGRAMS, programs):
        torch.export.save(program, os.path.join(out_dir, name))
    meta = {
        "seq_len": int(S),
        # the programs have these shapes baked in; a serving host packs with
        # exactly this max_samples and head_dim (tools/serve.py)
        "max_samples": int(batch["token_counts"].shape[0]),
        "head_dim": int(HEAD_DIM),
        "patch_size": [int(p) for p in module.patch_size],
        "in_channels": int(module.in_channels),
        "quantizer": str(module.quantizer),
        "device": device.type,
        "quant": quant,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def load_exported(out_dir: str):
    """``(forward, decode, meta)`` of an export: the two programs as
    callable modules and ``meta.json``. Needs torch and the custom ops
    only; call the programs under ``torch.no_grad()`` with tensors on
    ``meta['device']``."""
    from titok_tpu_torch.ops import custom_ops  # noqa: F401  (registers torch.ops.titok.*)

    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    fwd, dec = (torch.export.load(os.path.join(out_dir, n)).module() for n in PROGRAMS)
    return fwd, dec, meta


def check_exported(model, out_dir: str, example_batch: dict) -> None:
    """The loaded programs against the live ``model`` (a ``TiTokModel``,
    quantized as the export was) on ``example_batch``: indices equal,
    reconstructions within 1e-5, decode of the indices within 1e-5 of the
    live ``decode_indices_packed``. Raises ``AssertionError`` otherwise."""
    fwd, dec, meta = load_exported(out_dir)
    batch = _tensors(example_batch, meta["device"])
    with torch.no_grad():
        recon, idx = fwd(batch)
        ref_recon, ref_aux = model.module(batch)
        rec2 = dec(idx, batch)
        ref_rec2 = model.module.decode_indices_packed(idx, batch)
    if not torch.equal(idx, ref_aux["indices"]):
        raise AssertionError(f"exported indices differ from the live module's at "
                             f"{int((idx != ref_aux['indices']).sum())} slots")
    for name, got, want in (("forward", recon, ref_recon), ("decode", rec2, ref_rec2)):
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"exported {name}: {m}")


def main(argv: list[str] | None = None) -> None:
    from titok_tpu_torch.tools.tokenize import load_model, maybe_quantize

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--check", action="store_true",
                    help="load the programs and compare them with the live module on the "
                         "example batch")
    ap.add_argument("--quant", choices=("w8a16", "w8a8"), default=None,
                    help="bake per-channel int8 weights (weight-only or dynamic-activation "
                         "int8 matmuls)")
    ap.add_argument("--set", action="append", default=[], dest="overrides", metavar="KEY=VAL",
                    help="dotted config override, e.g. tokenizer.model.encoder_size=large")
    ap.add_argument("--device", default=None, help="'cpu' for the plain path (default: cuda)")
    args = ap.parse_args(argv)

    _, model = load_model(args.config, args.ckpt, args.overrides, args.device)
    example = model._dummy_batch()
    export_model(model.module, example, args.out, quant=args.quant)
    sizes = {n: os.path.getsize(os.path.join(args.out, n)) for n in PROGRAMS}
    print(f"exported to {args.out}: " + ", ".join(
        f"{n} ({s / 1e6:.1f} MB)" for n, s in sizes.items()))
    if args.check:
        check_exported(maybe_quantize(model, args.quant), args.out, example)
        print("check ok: exported programs match the live module")


if __name__ == "__main__":
    main()
