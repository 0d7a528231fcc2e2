"""Tokenizer CLI of the port (the JAX package's ``tools/tokenize.py``):
encode videos to token files, decode token files back to video.

    # videos -> per-clip token files (.npz with indices, grid, fps)
    python -m titok_tpu_torch.tools.tokenize encode --config configs/tiny.yaml \\
        --ckpt out_ckpt/5000 video1.mp4 video2.mp4 --out tokens/ [--tokens 64]

    # token files -> reconstructed videos (<name>_recon.mp4)
    python -m titok_tpu_torch.tools.tokenize decode --config configs/tiny.yaml \\
        --ckpt out_ckpt/5000 tokens/video1.npz --out recon/

``--ckpt`` is a checkpoint of the port (``<run>/<step>`` or its
``state.pt``; an orbax one is converted first with
``tools/convert_orbax_to_torch.py``); without it the weights are seeded
random. ``--quant w8a16|w8a8`` serves int8 Dense layers
(``serving/quant.py``), ``--set KEY=VAL`` overrides the config, and it runs
on the card unless ``--device cpu`` is given. A clip is cut to the
config's ``max_grid`` and to multiples of the patch, and encoded alone;
the file I/O (``read_clip``, ``encode_video``) stays apart from the model
calls (:func:`encode_clip`, :func:`decode_tokens`), which take and return
arrays.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def load_model(config_path: str, ckpt: str | None, overrides: list[str] | None = None,
               device=None):
    """``(config, TiTokModel)`` of a config, with a checkpoint's generator
    (and EMA-VQ's codebook) when ``ckpt`` is given, at the config's
    ``eval_seq_len`` and ``min_grid``. A ``quantizer: vq`` checkpoint
    without a codebook raises: it cannot decode indices."""
    from titok_tpu_torch.config import load_config
    from titok_tpu_torch.models.titok import TiTokModel, make_titok
    from titok_tpu_torch.train_utils.checkpoints import read_generator

    cfg = load_config(config_path, overrides)
    module = make_titok(cfg)
    params = None
    if ckpt:
        params = read_generator(ckpt)
        if module.quantizer == "vq" and "quantize.codebook" not in params:
            raise RuntimeError(f"checkpoint {os.path.abspath(ckpt)} has no vq_state but the "
                               "config selects quantizer: vq")
    model = TiTokModel(module, params=params, seq_len=int(cfg.training.sampling.eval_seq_len),
                       min_grid=cfg.training.sampling.min_grid, device=device)
    return cfg, model


def maybe_quantize(model, quant: str | None):
    """The model with int8 Dense layers when ``quant`` is 'w8a16' or 'w8a8'."""
    if quant:
        from titok_tpu_torch.serving.quant import quantize_model

        return quantize_model(model, mode=quant)
    return model


def read_clip(path: str, cfg) -> tuple[np.ndarray, float]:
    """``(f32 CTHW clip in [-1, 1], fps)`` of a video file: its first
    frames and top-left pixels, cut to multiples of the patch and to the
    config's ``max_grid``."""
    from titok_tpu_torch.data.video_reader import VideoReader

    with VideoReader(path) as vr:
        ps = cfg.tokenizer.model.patch_size
        max_grid = cfg.training.sampling.max_grid
        t = min((len(vr) // ps[0]) * ps[0], max_grid[0])
        h = min((vr.height // ps[1]) * ps[1], max_grid[1])
        w = min((vr.width // ps[2]) * ps[2], max_grid[2])
        if t == 0 or h == 0 or w == 0:
            raise ValueError(f"{path}: too small for patch size {ps}")
        frames = vr.get_batch(list(range(t)))[:, :h, :w]  # uint8 THWC
        fps = vr.fps
    return frames.astype(np.float32).transpose(3, 0, 1, 2) / 255 * 2 - 1, fps


def encode_clip(model, video: np.ndarray, tokens: int) -> tuple[np.ndarray, np.ndarray]:
    """``(int32 indices [tokens], grid [3])`` of one CTHW clip."""
    return model.encode([video], [tokens])[0], np.asarray(video.shape[1:])


def decode_tokens(model, indices: np.ndarray, grid) -> np.ndarray:
    """uint8 THWC frames decoded from a clip's indices at its pixel grid."""
    recon = model.decode_indices([indices], grids=[tuple(int(g) for g in grid)])[0]
    return ((np.clip(recon, -1, 1) + 1) / 2 * 255).astype(np.uint8).transpose(1, 2, 3, 0)


def encode_cmd(args) -> None:
    cfg, model = load_model(args.config, args.ckpt, args.overrides, args.device)
    model = maybe_quantize(model, args.quant)
    os.makedirs(args.out, exist_ok=True)
    for path in args.inputs:
        vid, fps = read_clip(path, cfg)
        idx, grid = encode_clip(model, vid, args.tokens)
        name = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.out, name + ".npz")
        np.savez(out, indices=idx, grid=grid, fps=fps)
        print(f"{path} -> {out}  ({len(idx)} tokens, grid {vid.shape[1:]})")


def decode_cmd(args) -> None:
    from titok_tpu_torch.data.video_reader import encode_video

    _, model = load_model(args.config, args.ckpt, args.overrides, args.device)
    model = maybe_quantize(model, args.quant)
    os.makedirs(args.out, exist_ok=True)
    for path in args.inputs:
        with np.load(path) as data:
            frames = decode_tokens(model, data["indices"], data["grid"])
            fps = float(data["fps"]) or 8.0
        name = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.out, name + "_recon.mp4")
        encode_video(out, frames, fps=fps)
        print(f"{path} -> {out}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in [("encode", encode_cmd), ("decode", decode_cmd)]:
        p = sub.add_parser(name)
        p.add_argument("inputs", nargs="+")
        p.add_argument("--config", required=True)
        p.add_argument("--ckpt", default=None)
        p.add_argument("--out", required=True)
        p.add_argument("--quant", choices=("w8a16", "w8a8"), default=None,
                       help="int8-quantize the Dense layers for serving")
        p.add_argument("--set", action="append", default=[], dest="overrides",
                       metavar="KEY=VAL",
                       help="dotted config override, e.g. tokenizer.model.encoder_size=large")
        p.add_argument("--device", default=None, help="'cpu' for the plain path (default: cuda)")
        if name == "encode":
            p.add_argument("--tokens", type=int, default=64, help="latent tokens per clip")
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
