"""Time two builds of the attention forward kernel against each other.

    python -m titok_tpu_torch.tools.compare_fwd OLD.cu NEW.cu [--rounds 3]

Builds each source (a ``flash_segment_attn_fwd.cu`` with the same C entry)
with the flags of ``ops/_build.py`` and times its C entry point on fixed
buffers at the bench shape (S = 6144, ten 576-row segments, heads 4/2,
D 64), bf16 and f32, in the order OLD, NEW, NEW, OLD for each round, with
CUDA events over 200 launches. Prints each time, the means, and the largest
difference between the two builds' outputs. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch

from titok_tpu_torch.ops import _build


def _entry(name: str, src: str):
    info = _build._build_one(name, src)
    fn = ctypes.CDLL(info["path"]).flash_segment_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, info


def _ms(fn, args, reps: int = 200) -> float:
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=3)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    fns = {}
    for label, src in (("old", a.old), ("new", a.new)):
        fns[label], info = _entry(f"cmp_fwd_{label}", src)
        regs = [ln.strip() for ln in info["ptxas"].splitlines() if "registers" in ln]
        print(f"{label}: {src}\n  " + "\n  ".join(regs))
    dev = torch.device("cuda")
    S, hq, hkv, D = 6144, 4, 2, 64
    seg_np = np.zeros(S, np.int32)
    for i in range(10):
        seg_np[i * 576:(i + 1) * 576] = i + 1
    seg = torch.from_numpy(seg_np).to(dev)
    stream = torch.cuda.current_stream().cuda_stream
    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        g = torch.Generator(device=dev).manual_seed(1)
        q = torch.randn(S, hq, D, generator=g, device=dev).to(dtype)
        k = torch.randn(S, hkv, D, generator=g, device=dev).to(dtype)
        v = torch.randn(S, hkv, D, generator=g, device=dev).to(dtype)
        outs = {}
        for label in fns:
            out, lse = torch.empty_like(q), torch.empty(S, hq, device=dev)
            outs[label] = (out, lse, (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      seg.data_ptr(), seg.data_ptr(), out.data_ptr(),
                                      lse.data_ptr(), S, S, hq, hkv, float(D ** -0.5),
                                      int(dname == "bf16"), stream))
        times = {"old": [], "new": []}
        for _ in range(a.rounds):
            for label in ("old", "new", "new", "old"):
                times[label].append(_ms(fns[label], outs[label][2]))
        d_out = (outs["old"][0].float() - outs["new"][0].float()).abs().max().item()
        d_lse = (outs["old"][1] - outs["new"][1]).abs().max().item()
        for label, ts in times.items():
            print(f"{dname} {label}: mean {np.mean(ts):.5f} ms, min {min(ts):.5f} ms "
                  f"({', '.join(f'{t:.5f}' for t in ts)})")
        print(f"{dname} new/old (means): {np.mean(times['new']) / np.mean(times['old']):.4f}; "
              f"outputs max|new-old| out {d_out:.3e} lse {d_lse:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
