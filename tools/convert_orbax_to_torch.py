"""Convert an orbax checkpoint of the JAX package into a checkpoint of the
PyTorch port (``titok_tpu_torch``), weights only.

    python tools/convert_orbax_to_torch.py <orbax dir> <out dir> [--step N] [--no-disc]

``<orbax dir>`` is what ``titok_tpu``'s ``restore_weights_only`` accepts: a
step directory of a run (``<run>/<step>``, holding ``default/``), its
``<step>/default``, or a bare weights-only artifact
(``tools/save_weights.py``, e.g. ``docs/artifacts/r4_tiny_lpips_5000``); or a
run directory, whose newest step (or ``--step N``) is taken. It is read
template-free through ``restore_raw``, so a checkpoint written on a TPU
reads on a CPU.

Writes ``<out dir>/<step>/state.pt`` in the port's checkpoint format
(``titok_tpu_torch/train_utils/checkpoints.py``): ``step``, ``gen`` (the
generator's state dict through ``weights.from_flax_params``, plus the
EMA-VQ codebook and statistics through ``weights.from_vq_state`` when the
checkpoint has a ``vq_state``) and ``disc`` (the discriminator's, empty with
``--no-disc``), f32 as stored, and no optimizer state. ``<step>`` is
``--step``, else the checkpoint's own ``step``, else the trailing digits of
the directory's name, else 0. The port loads it with
``general.checkpoints.init_from_checkpoint=<out dir>/<step>`` or the
evaluate CLI's ``--ckpt`` (``python -m titok_tpu_torch.tools.evaluate``);
it cannot resume a run.

Needs JAX and orbax: run it where the JAX package runs. Nothing in the port
imports this file.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import types

# allow running as `python tools/<name>.py` from the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def resolve(path: str, step: int | None = None) -> tuple[str, int | None]:
    """The orbax item directory of ``path`` and the step its name gives
    (None when it gives none)."""
    path = os.path.abspath(path)
    steps = sorted(int(n) for n in os.listdir(path)
                   if n.isdigit() and os.path.isdir(os.path.join(path, n)))
    if not os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA")) \
            and not os.path.isdir(os.path.join(path, "default")) and steps:
        # a run directory: the newest step, or --step
        pick = steps[-1] if step is None else int(step)
        if pick not in steps:
            raise FileNotFoundError(f"step {pick} not in {steps} under {path}")
        path = os.path.join(path, str(pick))
    if os.path.isdir(os.path.join(path, "default")):  # CheckpointManager's layout
        path = os.path.join(path, "default")
    name = os.path.basename(os.path.dirname(path) if path.endswith("/default") else path)
    m = re.search(r"(\d+)$", name)
    return path, int(m.group(1)) if m else None


def payload(raw: dict, step: int, disc: bool = True) -> dict:
    """The port's weights-only checkpoint of a restored orbax tree."""
    import torch

    from titok_tpu_torch.weights import from_flax_params, from_vq_state

    def tensors(sd):
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}

    gen = from_flax_params(raw["gen_params"])
    vq = raw.get("vq_state")
    if isinstance(vq, dict) and "codebook" in vq:
        cb = np.asarray(vq["codebook"], np.float32)
        gen.update(from_vq_state(types.SimpleNamespace(
            codebook=cb, ema_counts=vq["ema_counts"], ema_sums=vq["ema_sums"],
            # checkpoints from before age tracking have no ages
            ages=vq.get("ages", np.zeros(cb.shape[0], np.float32)))))
    out = {"step": int(step), "gen": tensors(gen), "disc": {}}
    if disc and raw.get("disc_params"):
        out["disc"] = tensors(from_flax_params(raw["disc_params"]))
    return out


def convert(src: str, out_dir: str, step: int | None = None, disc: bool = True) -> str:
    """Convert ``src`` into ``out_dir/<step>/state.pt``; returns that path."""
    import orbax.checkpoint as ocp
    import torch

    from titok_tpu.train_utils.checkpoints import restore_raw

    path, named = resolve(src, step)
    ckptr = ocp.StandardCheckpointer()
    raw = restore_raw(ckptr, path)  # orbax wants an absolute path
    ckptr.close()
    if step is None:
        step = int(np.asarray(raw["step"])) if "step" in raw else (named or 0)
    state = payload(raw, step, disc)
    dst = os.path.join(os.path.abspath(out_dir), str(int(step)))
    os.makedirs(dst, exist_ok=True)
    torch.save(state, os.path.join(dst, "state.pt"))
    n = sum(v.numel() for part in ("gen", "disc") for v in state[part].values())
    print(f"{path} -> {dst}/state.pt: step {step}, {len(state['gen'])} generator and "
          f"{len(state['disc'])} discriminator tensors, {n} values")
    return os.path.join(dst, "state.pt")


def main(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="orbax step dir, <step>/default, weights-only artifact or run dir")
    ap.add_argument("out", help="output directory; <out>/<step>/state.pt is written")
    ap.add_argument("--step", type=int, default=None,
                    help="the step to take from a run dir, and the step written")
    ap.add_argument("--no-disc", action="store_true", help="leave the discriminator out")
    args = ap.parse_args(argv)
    convert(args.src, args.out, args.step, disc=not args.no_disc)


if __name__ == "__main__":
    main(sys.argv[1:])
