"""A/B of two builds of the segment-attention kernels at their C entries.

    python -m titok_tpu_torch.tools.compare_attn OLD_CSRC NEW_CSRC [--rounds 2] [--reps 100]

OLD_CSRC and NEW_CSRC are directories that each hold
``flash_segment_attn_fwd.cu``, ``flash_segment_attn_bwd.cu`` and the
``segment_attn_common.cuh`` they include, for example an older commit's
``titok_tpu_torch/csrc`` unpacked into the git-ignored ``.scratch/``::

    git archive <rev> titok_tpu_torch/csrc | tar -x -C .scratch/old

Each is built with the flags of ``ops/_build.py``. At three shapes (the
bench shape: S 6144, ten 576-row segments, heads 4/2; the base_vq serving
layout, S 4096 with segments 513, 1040, 416, 832, 608, at heads 12/4; the
large serving layout, the same ids at heads 16/4) it times the bf16 entries
``flash_segment_attn_fwd``, ``flash_segment_attn_rope_fwd``,
``flash_segment_attn_bwd_dkv`` and ``flash_segment_attn_rope_bwd_dkv``, and
the two dq entries as a control, on fixed buffers (RoPE tables of random
angles, P 30), in the order OLD, NEW, NEW, OLD each round, with CUDA events
over ``--reps`` launches. Prints each build's ``-Xptxas -v`` lines, each
time, the means, NEW/OLD, the bound and the share of bound, and the largest
difference between the two builds' outputs. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess

import numpy as np
import torch

from titok_tpu_torch.ops import _build
from titok_tpu_torch.ops.flash_attention_mh import bind_bwd, bind_fwd

# H100 SXM, dense (NVIDIA data sheet): bf16 tensor cores, fp32 FMA, HBM
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
D, P = 64, 30
KINDS = ("fwd", "rope_fwd", "dkv", "rope_dkv", "dq", "rope_dq")


def _segments(lengths, S):
    seg = np.zeros(S, np.int32)
    off = 0
    for i, n in enumerate(lengths):
        seg[off:off + n] = i + 1
        off += n
    return seg


BASE = [513, 1040, 416, 832, 608]
SHAPES = {"bench 4/2": (_segments([576] * 10, 6144), 4, 2),
          "base_vq 12/4": (_segments(BASE, 4096), 12, 4),
          "large 16/4": (_segments(BASE, 4096), 16, 4)}


def bound_ms(kind: str, seg: np.ndarray, hq: int, hkv: int) -> tuple[float, str]:
    """The least time of one launch: the products (forward 2, dq 3, dk/dv 4
    of S x Sk x D over live segments) at the bf16 peak, plus for rope the
    rotations (6 fp32 FLOP a pair: q and k once each, and the inverse of dq
    or dk) at the fp32 peak; or the bytes each input read once and each
    output written once; the larger, as ``chip_smoke.py`` counts them."""
    S = len(seg)
    _, counts = np.unique(seg[seg != 0], return_counts=True)
    live = float((counts.astype(np.float64) ** 2).sum())
    rope = kind.startswith("rope_")
    base = kind.removeprefix("rope_")
    flops = 2.0 * {"fwd": 2, "dq": 3, "dkv": 4}[base] * D * hq * live
    rot = 6.0 * P * (S * hq + S * hkv + {"fwd": 0, "dq": S * hq, "dkv": S * hkv}[base])
    qb, kb = S * hq * D * 2, S * hkv * D * 2
    nbytes = qb + 2 * kb + 2 * S * 4 + (S * P * 8 if rope else 0)
    if base == "fwd":
        nbytes += qb + S * hq * 4
    else:
        nbytes += qb + 2 * S * hq * 4 + (qb if base == "dq" else 2 * kb)
    t_ops = (flops / PEAK_BF16 + (rot / PEAK_F32 if rope else 0.0)) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _build_pair(label: str, csrc: str):
    """Build a directory's two sources; ``(entries by kind, ptxas lines)``."""
    libs, lines = {}, []
    for name in ("flash_segment_attn_fwd", "flash_segment_attn_bwd"):
        info = _build._build_one(f"cmp_{label}_{name}", os.path.join(csrc, f"{name}.cu"))
        libs[name] = ctypes.CDLL(info["path"])
        lines += [ln.strip() for ln in info["ptxas"].splitlines()
                  if "entry function" in ln or "spill" in ln or "Used" in ln]
    fwd, rope_fwd = bind_fwd(libs["flash_segment_attn_fwd"])
    dq, dkv, rope_dq, rope_dkv = bind_bwd(libs["flash_segment_attn_bwd"])
    fns = {"fwd": fwd, "rope_fwd": rope_fwd, "dkv": dkv, "rope_dkv": rope_dkv, "dq": dq,
           "rope_dq": rope_dq}
    return fns, lines


def _demangle(lines):
    if shutil.which("c++filt") is None:
        return lines
    res = subprocess.run(["c++filt"], input="\n".join(lines), capture_output=True, text=True)
    return res.stdout.splitlines() if res.returncode == 0 else lines


def _ms(fn, args, reps: int) -> float:
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        err = fn(*args)
    end.record()
    end.synchronize()
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return start.elapsed_time(end) / reps


class Case:
    """Fixed bf16 inputs of one shape and, per build, the output buffers of
    every kind; ``args(kind, label)`` is the C entry's argument tuple."""

    def __init__(self, seg_np, hq, hkv, fns_new, seed=1):
        dev = torch.device("cuda")
        S = len(seg_np)
        g = torch.Generator(device=dev).manual_seed(seed)
        bf = torch.bfloat16
        self.S, self.hq, self.hkv = S, hq, hkv
        self.q = torch.randn(S, hq, D, generator=g, device=dev).to(bf)
        self.k = torch.randn(S, hkv, D, generator=g, device=dev).to(bf)
        self.v = torch.randn(S, hkv, D, generator=g, device=dev).to(bf)
        self.do = torch.randn(S, hq, D, generator=g, device=dev).to(bf)
        ang = torch.rand(S, P, generator=g, device=dev) * (2 * np.pi)
        self.cos, self.sin = ang.cos().contiguous(), ang.sin().contiguous()
        self.seg = torch.from_numpy(seg_np).to(dev)
        self.stream = torch.cuda.current_stream().cuda_stream
        self.outs = {}
        # lse and delta of each forward (NEW build's), inputs of the backward
        self.fwd_state = {}
        for rope in (False, True):
            out, lse = torch.empty_like(self.q), torch.empty(S, hq, device=dev)
            kind = "rope_fwd" if rope else "fwd"
            err = fns_new[kind](*self._fwd_args(rope, out, lse))
            if err != 0:
                raise RuntimeError(f"{kind} launch failed: CUDA error {err}")
            delta = (self.do.float() * out.float()).sum(-1).contiguous()
            self.fwd_state[rope] = (lse, delta)
        torch.cuda.synchronize()

    def _ptrs(self, rope):
        head = [self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(), self.seg.data_ptr(),
                self.seg.data_ptr()]
        if rope:
            head += [self.cos.data_ptr(), self.sin.data_ptr(), self.cos.data_ptr(),
                     self.sin.data_ptr(), P]
        return head

    def _tail(self):
        return [self.S, self.S, self.hq, self.hkv, float(D ** -0.5), 1, self.stream]

    def _fwd_args(self, rope, out, lse):
        return tuple(self._ptrs(rope) + [out.data_ptr(), lse.data_ptr()] + self._tail())

    def args(self, kind: str, label: str):
        rope = kind.startswith("rope_")
        base = kind.removeprefix("rope_")
        key = (kind, label)
        if key not in self.outs:
            if base == "fwd":
                self.outs[key] = (torch.empty_like(self.q),
                                  torch.empty(self.S, self.hq, device=self.q.device))
            elif base == "dq":
                self.outs[key] = (torch.empty_like(self.q),)
            else:
                self.outs[key] = (torch.empty_like(self.k), torch.empty_like(self.v))
        outs = self.outs[key]
        if base == "fwd":
            return self._fwd_args(rope, *outs)
        lse, delta = self.fwd_state[rope]
        return tuple(self._ptrs(rope) + [self.do.data_ptr(), lse.data_ptr(), delta.data_ptr()]
                     + [t.data_ptr() for t in outs] + self._tail())

    def max_diff(self, kind: str) -> float:
        return max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(self.outs[(kind, "old")], self.outs[(kind, "new")]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", help="csrc directory of the OLD build")
    ap.add_argument("new", help="csrc directory of the NEW build")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=100)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    fns = {}
    for label, csrc in (("old", a.old), ("new", a.new)):
        fns[label], lines = _build_pair(label, csrc)
        print(f"{label}: {csrc}\n  " + "\n  ".join(_demangle(lines)))
    for sname, (seg_np, hq, hkv) in SHAPES.items():
        case = Case(seg_np, hq, hkv, fns["new"])
        for kind in KINDS:
            times = {"old": [], "new": []}
            for _ in range(a.rounds):
                for label in ("old", "new", "new", "old"):
                    times[label].append(_ms(fns[label][kind], case.args(kind, label), a.reps))
            bound, by = bound_ms(kind, seg_np, hq, hkv)
            mo, mn = float(np.mean(times["old"])), float(np.mean(times["new"]))
            print(f"{sname} {kind}: old {mo:.5f} ms ({', '.join(f'{t:.5f}' for t in times['old'])})"
                  f"; new {mn:.5f} ms ({', '.join(f'{t:.5f}' for t in times['new'])}); "
                  f"new/old {mn / mo:.4f}; bound {bound:.5f} ms ({by}), share old "
                  f"{100 * bound / mo:.2f} % new {100 * bound / mn:.2f} %; outputs "
                  f"max|new-old| {case.max_diff(kind):.3e}")
        del case
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
