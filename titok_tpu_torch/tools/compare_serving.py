"""Serving request time of two checkouts of the port on the card, in turns
OLD, NEW, NEW, OLD: how a change to the serving path moves it.

    python -m titok_tpu_torch.tools.compare_serving OLD_ROOT NEW_ROOT [--reps 20]

Each turn is a fresh process that imports ``titok_tpu_torch`` from its root
(``PYTHONPATH``; a root's kernels build into its own ``build/``), builds
``configs/tiny.yaml``'s model on the card with seeded weights (dense kernels
at 4x the reference init, as ``chip_smoke.py``'s serving phase), and times
``TiTokModel.encode`` of the serving request (a) (six 8x128x128 clips at
1, 16, 32, 64, 96 and 128 tokens), bf16-mixed and f32: the host clock over
``--reps`` requests ending in ``torch.cuda.synchronize()``, after 3
warm-up requests. It prints one JSON line a turn, then the medians of each
side and NEW/OLD. To compare with a commit, unpack it into a git-ignored
directory first (``git archive <rev> | tar -x -C .scratch/old``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

# what each turn runs, in its root's package
TURN = """
import json, os, sys, time
import numpy as np
import torch
from titok_tpu_torch.config import load_config
from titok_tpu_torch.models.titok import TiTokModel, init_params, make_titok

reps = int(sys.argv[1])
rng = np.random.default_rng(0)
clips = [rng.uniform(-1, 1, (3, 8, 128, 128)).astype(np.float32) for _ in range(6)]
tcs = [1, 16, 32, 64, 96, 128]
out = {"root": os.getcwd()}
for precision in ("bf16-mixed", "32"):
    cfg = load_config("configs/tiny.yaml", [f"training.main.precision={precision}"])
    module = make_titok(cfg)
    params = init_params(module, seed=0)
    for name, w in params.items():
        if w.ndim == 2 and not name.endswith("mask_token"):
            params[name] = w * np.float32(4.0)
    model = TiTokModel(module, params=params, seq_len=int(cfg.training.sampling.eval_seq_len),
                       min_grid=cfg.training.sampling.min_grid, device="cuda")
    for _ in range(3):
        model.encode(clips, tcs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        model.encode(clips, tcs)
    torch.cuda.synchronize()
    out[precision] = (time.perf_counter() - t0) / reps * 1e3
print(json.dumps(out))
"""


def run_turn(root: str, reps: int) -> dict:
    """One timed turn in a fresh process importing ``root``'s package."""
    env = {**os.environ, "PYTHONPATH": os.path.abspath(root)}
    res = subprocess.run([sys.executable, "-c", TURN, str(reps)], cwd=os.path.abspath(root),
                         env=env, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"turn in {root} failed:\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    turns = []
    for side in ("old", "new", "new", "old"):
        turn = {"side": side, **run_turn(getattr(args, side), args.reps)}
        turns.append(turn)
        print(json.dumps({**turn, "card": card}), flush=True)
    for precision in ("bf16-mixed", "32"):
        old, new = (float(np.median([t[precision] for t in turns if t["side"] == s]))
                    for s in ("old", "new"))
        print(f"encode (a) {precision} [{card}]: OLD {old:.3f} ms, NEW {new:.3f} ms a request "
              f"(medians of 2 turns x {args.reps} requests), NEW/OLD {new / old:.4f}")


if __name__ == "__main__":
    main()
