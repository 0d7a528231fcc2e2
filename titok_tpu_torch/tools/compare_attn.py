"""A/B of two builds of the segment-attention and VQ kernels at their C entries.

    python -m titok_tpu_torch.tools.compare_attn OLD_CSRC NEW_CSRC [VARIANT_CSRC ...] \
        [--rounds 2] [--reps 100] [--kinds fwd dq ... vq] [--dtype bf16 f32]

OLD_CSRC, NEW_CSRC and any variants (copies of a ``csrc`` with one knob
changed, named by their directory) are directories that each hold
``flash_segment_attn_fwd.cu``, ``flash_segment_attn_bwd.cu``,
``flash_segment_attn_v1.cu``, ``vq_nearest.cu`` and the headers they
include, for example an older commit's ``titok_tpu_torch/csrc`` unpacked
into the git-ignored ``.scratch/``::

    git archive <rev> titok_tpu_torch/csrc | tar -x -C .scratch/old

Each is built with the flags of ``ops/_build.py``. At three shapes (the
bench shape: S 6144, ten 576-row segments, heads 4/2; the base_vq serving
layout, S 4096 with segments 513, 1040, 416, 832, 608, at heads 12/4; the
large serving layout, the same ids at heads 16/4) it times the entries of
every kind in ``KINDS`` in each dtype of ``--dtype`` (default both): the
forward, dk/dv and dq entries, plain and RoPE, in bf16 and f32 (``f32``
counts 4-byte elements and the fp32 FMA peak in the bound, as
``chip_smoke.py`` does), and the v1 forward, dq and dk/dv entries, in both
dtypes (``F32_KINDS`` lists what f32 times), on fixed buffers (RoPE tables
of random angles, P 30), in the order OLD, NEW, (variants, variants
reversed,) NEW, OLD each round, with CUDA events over ``--reps`` launches.
Each v1 entry is timed as its build's wrapper runs it, and alone. A build
without ``flash_segment_attn_v1_f32_searches`` has v1 entries that take
tile intervals after the ids (``bind_v1_intervals``); each is given the
intervals of its tiles (``tile_minmax``, the wrapper's copy kept here), and
where it reads them it is timed with the ``tile_minmax`` its wrapper ran
before each launch: the bf16 forward and dq where the build lacks
``flash_segment_attn_v1_bf16_searches`` (tiles of 64 rows), the f32 dq
where it lacks ``flash_segment_attn_v1_f32_dq_searches`` (32 and 32), the
f32 forward (64 q and 32 kv rows) and dk/dv (32 and 32) always. A dk/dv
that writes each q head's grads, bf16 where the build lacks
``flash_segment_attn_v1_dkv_summed`` and f32 in such a build, is timed with
the two ``group_sum`` ops its wrapper ran after it. Prints each build's
``-Xptxas -v`` lines, each time, the means and medians (one late sample of
a few µs of host or clock noise moves a mean), each build's time over
OLD's, the bound and the share of bound, and the largest difference between
each build's outputs and OLD's (dk/dv summed over each group); for the f32
v1 forward and dk/dv, whose fp32 sum order changed when they became the
row 1 and row 2 kernels, also whether each build's outputs are within
the f32 gate of ``chip_smoke.py`` (``f32_gate``) of OLD's.

The ``vq`` kind times the VQ search at S 4096, 3409 and 1152 (N 16384, D 8:
S 4096 is the one shape base_vq runs, a training step or a serving group
padded to 4096 rows; 3409 and 1152 are its request (a)'s groups unpadded,
fewer row blocks for the same codebook) in the same order,
each entry alone and as its build's wrapper runs it: a build with the
one-launch kernel (it has ``vq_nearest_one_launch``) at the plan of
``ops/vq_distance.plan_for`` with its two outputs allocated, an older one
(two launches, scratch [P, S] and the code norms as inputs) with the norms
computed and its two scratch tensors and two outputs allocated before each
launch, P as that build's wrapper chose it. It prints the bound and the
share of bound (``vq_bound_ms``, as ``chip_smoke.py`` counts it) and each
build's indices and distances against OLD's (indices identical, largest
distance difference). ``--kinds`` picks kinds (default: all). Needs a CUDA
card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from titok_tpu_torch.ops import _build
from titok_tpu_torch.ops import vq_distance as vd
from titok_tpu_torch.ops.flash_attention import bind_v1, group_sum
from titok_tpu_torch.ops.flash_attention_mh import PAD_ID, _remap_pad, bind_bwd, bind_fwd

# H100 SXM, dense (NVIDIA data sheet): bf16 tensor cores, fp32 FMA, HBM
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
D, P = 64, 30
KINDS = ("fwd", "rope_fwd", "dkv", "rope_dkv", "dq", "rope_dq", "v1_fwd", "v1_dq",
         "v1_dkv")
# the kinds timed in f32: every one
F32_KINDS = KINDS
# the q and kv tile rows of the tile intervals a v1 entry of a build without
# flash_segment_attn_v1_f32_searches takes, by dtype and kind
V1_TILES = {"bf16": {"fwd": (64, 64), "dq": (64, 64), "dkv": (64, 64)},
            "f32": {"fwd": (64, 32), "dq": (32, 32), "dkv": (32, 32)}}
# ids of the rows that complete the last tile of such intervals (JAX pads S
# with 2^30 + 1)
TAIL_ID = PAD_ID + 1
# the f32 gates of chip_smoke.py (PERF.md §2): the forward's out and lse
# atol; the backward's (atol_frac of the largest |entry|, rtol, rms ratio)
F32_FWD_ATOL, F32_BWD_GATE = 1e-5, (1e-6, 1e-4, 3e-6)
DTYPES = ("bf16", "f32")
# the VQ search: base_vq's shape (S 4096), two smaller S, codebook, dim
VQ_SHAPES = (4096, 3409, 1152)
VQ_N, VQ_D = 16384, 8


def tile_minmax(segment_ids: torch.Tensor, tile: int) -> torch.Tensor:
    """int32 ``[ceil(S / tile), 2]``: (min, max) of the remapped ids of each
    tile of ``tile`` rows, the last tile completed with ``TAIL_ID`` (JAX's
    ``_block_minmax`` of the padded ids): the tile intervals an older
    build's v1 wrapper computed before each launch that read them."""
    seg = _remap_pad(segment_ids)
    S = seg.shape[0]
    n = -(-S // tile)
    if n * tile != S:
        seg = torch.cat([seg, seg.new_full((n * tile - S,), TAIL_ID)])
    s = seg.view(n, tile)
    return torch.stack([s.amin(1), s.amax(1)], dim=1).contiguous()


def bind_v1_intervals(lib: ctypes.CDLL):
    """The three v1 entries (fwd, dq, dkv) of a build without
    ``flash_segment_attn_v1_f32_searches``: after q, k, v and the ids they
    take the q and kv tile intervals and their tile rows."""
    fns = (lib.flash_segment_attn_v1_fwd, lib.flash_segment_attn_v1_bwd_dq,
           lib.flash_segment_attn_v1_bwd_dkv)
    for fn, n_ptr in zip(fns, (2, 4, 5)):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * n_ptr + [
            ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


def f32_gate(kind: str, got, want) -> tuple[bool, str]:
    """Whether the f32 outputs ``got`` are within ``chip_smoke.py``'s f32
    gate of ``want``: forward (out, lse), every entry within the atol and
    rms(d) <= nrel * rms(want's out); dk/dv (dk, dv), every entry within
    atol_frac * M + rtol * |b| and rms(d) <= nrel * R (M, R: the largest
    |entry| and the rms of ``want``)."""
    atol_frac, rtol, nrel = F32_BWD_GATE
    ws = [b.float() for b in want]
    ds = [(a.float() - b).abs() for a, b in zip(got, ws)]
    if kind.endswith("fwd"):
        e, e_lse = ds[0].max().item(), ds[1].max().item()
        rel = ds[0].square().mean().sqrt().item() / max(
            ws[0].square().mean().sqrt().item(), 1e-30)
        return e <= F32_FWD_ATOL and e_lse <= F32_FWD_ATOL and rel <= nrel, (
            f"out max|d| {e:.3e}, lse max|d| {e_lse:.3e} (atol {F32_FWD_ATOL}), rms ratio "
            f"{rel:.2e} (limit {nrel})")
    M = max(max(b.abs().max().item() for b in ws), 1e-30)
    R = max(torch.cat([b.flatten() for b in ws]).square().mean().sqrt().item(), 1e-30)
    need = max((d - rtol * b.abs()).clamp(min=0).max().item() for d, b in zip(ds, ws)) / M
    rel = max(d.square().mean().sqrt().item() for d in ds) / R
    return need <= atol_frac and rel <= nrel, (f"needs atol_frac {need:.2e} (limit {atol_frac}), "
                                               f"rms ratio {rel:.2e} (limit {nrel})")


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


def bound_ms(kind: str, seg: np.ndarray, hq: int, hkv: int,
             dtype: str = "bf16") -> tuple[float, str]:
    """The least time of one launch: the products (forward 2, dq 3, dk/dv 4
    of S x Sk x D over live segments) at the peak of ``dtype`` (bf16 tensor
    cores, f32 FMA), plus for rope the rotations (6 fp32 FLOP a pair: q and
    k once each, and the inverse of dq or dk) at the fp32 peak; or the bytes
    each input read once and each output written once (elements of 2 or 4
    bytes; dk/dv summed over each group, v1's too); the larger, as
    ``chip_smoke.py`` counts them."""
    S = len(seg)
    _, counts = np.unique(seg[seg != 0], return_counts=True)
    live = float((counts.astype(np.float64) ** 2).sum())
    rope = kind.startswith("rope_")
    base = kind.removeprefix("rope_").removeprefix("v1_")
    flops = 2.0 * {"fwd": 2, "dq": 3, "dkv": 4}[base] * D * hq * live
    rot = 6.0 * P * (S * hq + S * hkv + {"fwd": 0, "dq": S * hq, "dkv": S * hkv}[base])
    e = 2 if dtype == "bf16" else 4
    qb, kb = S * hq * D * e, S * hkv * D * e
    nbytes = qb + 2 * kb + 2 * S * 4 + (S * P * 8 if rope else 0)
    if base == "fwd":
        nbytes += qb + S * hq * 4
    else:
        nbytes += qb + 2 * S * hq * 4 + (qb if base == "dq" else 2 * kb)
    peak = PEAK_BF16 if dtype == "bf16" else PEAK_F32
    t_ops = (flops / peak + (rot / PEAK_F32 if rope else 0.0)) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def vq_bound_ms(S: int, N: int = VQ_N, D: int = VQ_D) -> tuple[float, str]:
    """The least time of one VQ search: 2 S N D fp32 FLOP at the FMA peak,
    or z and the codebook read once and idx, dist written once; the larger,
    as ``chip_smoke.py`` counts it."""
    t_ops = 2.0 * S * N * D / PEAK_F32 * 1e3
    t_bytes = (S * D * 4 + N * D * 4 + S * 8) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _old_vq_splits(S: int, N: int) -> int:
    """The code ranges P a two-launch build's wrapper chose (512 rows a CTA,
    4 CTAs an SM of 132, at least 512 codes a range)."""
    want = -(-4 * 132 // max(-(-S // 512), 1))
    return max(1, min(want, N // 512))


def _build_pair(label: str, csrc: str):
    """Build a directory's four sources; ``(entries by kind, what its v1
    entries do: {"summed": its bf16 dk/dv sums each group, "searches": its
    bf16 forward and dq read no tile intervals, "f32_dq_searches": its f32
    dq reads none, "f32_searches": no entry takes tile intervals and the f32
    dk/dv sums each group}, and whether its VQ search is one launch
    ("vq_one"), ptxas lines)``."""
    libs, lines = {}, []
    for name in ("flash_segment_attn_fwd", "flash_segment_attn_bwd", "flash_segment_attn_v1",
                 "vq_nearest"):
        info = _build._build_one(f"cmp_{label}_{name}", os.path.join(csrc, f"{name}.cu"))
        libs[name] = ctypes.CDLL(info["path"])
        lines += [ln.strip() for ln in info["ptxas"].splitlines()
                  if "entry function" in ln or "spill" in ln or "Used" in ln]
    fwd, rope_fwd = bind_fwd(libs["flash_segment_attn_fwd"])
    dq, dkv, rope_dq, rope_dkv = bind_bwd(libs["flash_segment_attn_bwd"])
    v1 = libs["flash_segment_attn_v1"]
    f32_searches = hasattr(v1, "flash_segment_attn_v1_f32_searches")
    v1_fwd, v1_dq, v1_dkv = (bind_v1 if f32_searches else bind_v1_intervals)(v1)
    vq = libs["vq_nearest"]
    vq_one = hasattr(vq, "vq_nearest_one_launch")
    vq_fn = vq.vq_nearest
    n_ptr, n_int = (4, 6) if vq_one else (7, 4)
    vq_fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    vq_fn.restype = ctypes.c_int
    fns = {"fwd": fwd, "rope_fwd": rope_fwd, "dkv": dkv, "rope_dkv": rope_dkv, "dq": dq,
           "rope_dq": rope_dq, "v1_fwd": v1_fwd, "v1_dq": v1_dq, "v1_dkv": v1_dkv, "vq": vq_fn}
    flags = {"summed": hasattr(v1, "flash_segment_attn_v1_dkv_summed"),
             "searches": hasattr(v1, "flash_segment_attn_v1_bf16_searches"),
             "f32_dq_searches": hasattr(v1, "flash_segment_attn_v1_f32_dq_searches"),
             "f32_searches": f32_searches,
             "vq_one": vq_one}
    return fns, flags, lines


class VqCase:
    """Fixed z [S, D] and codebook [N, D] (f32, seeded) and, per build, its
    output buffers; ``entry(label)`` is ``(fn, args)`` of the C entry on
    fixed buffers, ``wrapper(label)`` what the build's wrapper runs."""

    def __init__(self, S: int, fns: dict, flags: dict, seed: int = 1):
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(seed)
        self.S, self.fns, self.flags = S, fns, flags
        self.z = torch.randn(S, VQ_D, generator=g, device=dev)
        self.cb = torch.randn(VQ_N, VQ_D, generator=g, device=dev)
        self.stream = torch.cuda.current_stream().cuda_stream
        self.outs = {label: (torch.empty(S, dtype=torch.int32, device=dev),
                             torch.empty(S, device=dev)) for label in fns}
        self.cn = vd.code_norms(self.cb)  # an older build's input
        P = _old_vq_splits(S, VQ_N)
        self.scratch = (torch.empty((P, S), device=dev),
                        torch.empty((P, S), dtype=torch.int32, device=dev))

    def _call(self, label, idx, dist, cn=None, scratch=None):
        z, cb, S = self.z, self.cb, self.S
        if self.flags[label]["vq_one"]:
            p = vd.plan_for(S, VQ_N)
            return self.fns[label]["vq"](z.data_ptr(), cb.data_ptr(), idx.data_ptr(),
                                         dist.data_ptr(), S, VQ_N, VQ_D, p.warps, p.cluster,
                                         p.per_range, self.stream)
        P = scratch[0].shape[0]
        return self.fns[label]["vq"](z.data_ptr(), cb.data_ptr(), cn.data_ptr(),
                                     scratch[0].data_ptr(), scratch[1].data_ptr(),
                                     idx.data_ptr(), dist.data_ptr(), S, VQ_N, VQ_D, P,
                                     self.stream)

    def entry(self, label: str):
        idx, dist = self.outs[label]
        return (lambda: self._call(label, idx, dist, self.cn, self.scratch)), ()

    def wrapper(self, label: str):
        S, dev = self.S, self.z.device

        def run():
            idx = torch.empty(S, dtype=torch.int32, device=dev)
            dist = torch.empty(S, device=dev)
            if self.flags[label]["vq_one"]:
                return self._call(label, idx, dist)
            P = _old_vq_splits(S, VQ_N)
            cn = vd.code_norms(self.cb)
            scratch = (torch.empty((P, S), device=dev),
                       torch.empty((P, S), dtype=torch.int32, device=dev))
            return self._call(label, idx, dist, cn, scratch)

        return run, ()

    def compare(self, label: str) -> str:
        """This build's outputs on the fixed buffers against OLD's."""
        (ia, da), (ib, db) = self.outs["old"], self.outs[label]
        return (f"indices identical {bool(torch.equal(ia, ib))}, max|dist-old| "
                f"{(da - db).abs().max().item():.3e}")


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
    """Fixed inputs of one shape in ``dtype`` and, per build, the output buffers of
    every kind; ``args(kind, label)`` is the C entry's argument tuple,
    ``runner(kind, label)`` what a caller of that build runs: the entry,
    for a v1 entry that reads tile intervals the ``tile_minmax`` before it,
    for a per-head v1 dk/dv the wrapper's two group sums after it. ``flags``
    tells, per build label, what its v1 entries do (``_build_pair``)."""

    def __init__(self, seg_np, hq, hkv, fns_new, flags, seed=1, dtype="bf16"):
        dev = torch.device("cuda")
        S = len(seg_np)
        g = torch.Generator(device=dev).manual_seed(seed)
        bf = torch.bfloat16 if dtype == "bf16" else torch.float32
        self.S, self.hq, self.hkv, self.flags = S, hq, hkv, flags
        self.is_bf16 = int(dtype == "bf16")
        self.tiles = V1_TILES[dtype]
        self.q = torch.randn(S, hq, D, generator=g, device=dev).to(bf)
        self.k = torch.randn(S, hkv, D, generator=g, device=dev).to(bf)
        self.v = torch.randn(S, hkv, D, generator=g, device=dev).to(bf)
        self.do = torch.randn(S, hq, D, generator=g, device=dev).to(bf)
        ang = torch.rand(S, P, generator=g, device=dev) * (2 * np.pi)
        self.cos, self.sin = ang.cos().contiguous(), ang.sin().contiguous()
        self.seg = torch.from_numpy(seg_np).to(dev)
        # the tile intervals, by tile rows, of the builds whose v1 entries
        # take them
        self.mm = {t: tile_minmax(self.seg, t) for t in (32, 64)}
        self.stream = torch.cuda.current_stream().cuda_stream
        self.outs = {}
        self.sums = {}  # per label: a per-head v1 dk/dv after the group sums
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
        return [self.S, self.S, self.hq, self.hkv, float(D ** -0.5), self.is_bf16, self.stream]

    def _fwd_args(self, rope, out, lse):
        return tuple(self._ptrs(rope) + [out.data_ptr(), lse.data_ptr()] + self._tail())

    def _per_head(self, label: str) -> bool:
        """Whether build ``label``'s v1 dk/dv writes each q head's grads."""
        f = self.flags[label]
        return not (f["summed"] if self.is_bf16 else f["f32_searches"])

    def _reads_intervals(self, kind: str, label: str) -> bool:
        """Whether build ``label``'s v1 entry of ``kind`` reads its tile
        intervals, which its wrapper computed before each launch."""
        f = self.flags[label]
        if f["f32_searches"] or not kind.startswith("v1_"):
            return False
        if self.is_bf16:
            return kind != "v1_dkv" and not f["searches"]
        return kind != "v1_dq" or not f["f32_dq_searches"]

    def args(self, kind: str, label: str):
        rope = kind.startswith("rope_")
        base = kind.removeprefix("rope_").removeprefix("v1_")
        key = (kind, label)
        if key not in self.outs:
            if base == "fwd":
                self.outs[key] = (torch.empty_like(self.q),
                                  torch.empty(self.S, self.hq, device=self.q.device))
            elif base == "dq":
                self.outs[key] = (torch.empty_like(self.q),)
            elif kind == "v1_dkv" and self._per_head(label):
                self.outs[key] = (torch.empty_like(self.q), torch.empty_like(self.q))
            else:
                self.outs[key] = (torch.empty_like(self.k), torch.empty_like(self.v))
        outs = [t.data_ptr() for t in self.outs[key]]
        lse, delta = self.fwd_state[rope]
        bwd_in = [] if base == "fwd" else [self.do.data_ptr(), lse.data_ptr(), delta.data_ptr()]
        if kind.startswith("v1_"):  # one id vector (and its tile intervals), one length
            head = [self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(), self.seg.data_ptr()]
            if not self.flags[label]["f32_searches"]:
                tq, tk = self.tiles[base]
                head += [self.mm[tq].data_ptr(), self.mm[tk].data_ptr(), tq, tk]
            return (*head, *bwd_in, *outs, self.S, self.hq, self.hkv, float(D ** -0.5),
                    self.is_bf16, self.stream)
        return tuple(self._ptrs(rope) + bwd_in + outs + self._tail())

    def runner(self, fns: dict, kind: str, label: str):
        """``(fn, args)`` of what the wrapper of build ``label`` runs."""
        fn, args = fns[kind], self.args(kind, label)
        run = fn
        if self._reads_intervals(kind, label):
            seg, (tq, tk) = self.seg, self.tiles[kind.removeprefix("v1_")]

            def intervals_and_entry(*a):
                qmm = tile_minmax(seg, tq)  # the wrapper's, before each launch
                kmm = qmm if tk == tq else tile_minmax(seg, tk)
                return fn(*a[:4], qmm.data_ptr(), kmm.data_ptr(), *a[6:])

            run = intervals_and_entry

        if kind != "v1_dkv" or not self._per_head(label):
            return run, args
        dk_h, dv_h = self.outs[(kind, label)]

        def entry_and_group_sums(*a):
            err = run(*a)
            self.sums[label] = (group_sum(dk_h, self.hkv), group_sum(dv_h, self.hkv))
            return err

        return entry_and_group_sums, args

    def outputs(self, kind: str, label: str):
        """Build ``label``'s outputs of ``kind`` (a per-head v1 dk/dv's group
        sums)."""
        return (self.sums.get(label, self.outs[(kind, label)]) if kind == "v1_dkv"
                else self.outs[(kind, label)])

    def max_diff(self, kind: str, label: str) -> float:
        """Largest |difference| between build ``label``'s outputs and OLD's."""
        return max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(self.outputs(kind, "old"), self.outputs(kind, label)))

    def max_old(self, kind: str) -> float:
        """Largest |entry| of OLD's outputs, the scale of ``max_diff``."""
        return max(t.float().abs().max().item() for t in self.outputs(kind, "old"))


def _label(csrc: str) -> str:
    """A variant's label: its directory's name, as an identifier."""
    return re.sub(r"\W", "_", os.path.basename(os.path.normpath(csrc)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", help="csrc directory of the OLD build")
    ap.add_argument("new", nargs="+", help="csrc directory of the NEW build, then of any variants")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--kinds", nargs="+", choices=KINDS + ("vq",), default=KINDS + ("vq",))
    ap.add_argument("--dtype", nargs="+", choices=DTYPES, default=list(DTYPES),
                    help="the dtypes of the attention kinds (f32: those of F32_KINDS)")
    a = ap.parse_args(argv)
    names = ["old", "new"] + [_label(d) for d in a.new[1:]]
    if len(set(names)) != len(names):
        ap.error(f"variant directories need distinct names other than old and new: {names}")
    builds = dict(zip(names, [a.old, *a.new]))
    if not torch.cuda.is_available():
        print("needs a CUDA card")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    fns, flags = {}, {}
    with ThreadPoolExecutor(len(builds)) as ex:  # one thread a build, its nvcc runs
        built = list(ex.map(_build_pair, builds, builds.values()))
    for (label, csrc), (fns_b, flags_b, lines) in zip(builds.items(), built):
        fns[label], flags[label] = fns_b, flags_b
        print(f"{label}: {csrc} (v1 bf16 forward and dq "
              f"{'search the ids' if flags_b['searches'] else 'read tile intervals'}, dk/dv "
              f"{'summed' if flags_b['summed'] else 'per head'}; v1 f32 dq "
              f"{'searches the ids' if flags_b['f32_dq_searches'] else 'reads tile intervals'}, "
              f"forward and dk/dv "
              f"{'row 1 and row 2, summed' if flags_b['f32_searches'] else 'on tile intervals, per head'}; VQ "
              f"{'one launch' if flags_b['vq_one'] else 'two launches'})\n  "
              + "\n  ".join(_demangle(lines)))
    print("v1_*: each build as its wrapper runs it (tile intervals before an entry that reads "
          "them, group sums after a per-head dk/dv), then each entry alone")
    order = list(builds) + list(builds)[::-1]
    runs = [(sname, dname) for dname in a.dtype for sname in SHAPES]
    for sname, dname in runs:
        seg_np, hq, hkv = SHAPES[sname]
        attn_kinds = [k for k in (KINDS if dname == "bf16" else F32_KINDS) if k in a.kinds]
        if not attn_kinds:
            continue
        case = Case(seg_np, hq, hkv, fns["new"], flags, dtype=dname)
        for kind in attn_kinds:
            times = {label: [] for label in builds}
            alone = {label: [] for label in builds}  # the v1 entries alone
            for _ in range(a.rounds):
                for label in order:
                    times[label].append(_ms(*case.runner(fns[label], kind, label), a.reps))
                    if kind.startswith("v1_"):
                        alone[label].append(_ms(fns[label][kind], case.args(kind, label), a.reps))
            bound, by = bound_ms(kind, seg_np, hq, hkv, dname)
            mo, medo = float(np.mean(times["old"])), float(np.median(times["old"]))
            medo_alone = float(np.median(alone["old"])) if kind.startswith("v1_") else None
            parts = []
            for label, ts in times.items():
                m, med = float(np.mean(ts)), float(np.median(ts))
                part = (f"{label} {m:.5f} ms, median {med:.5f} "
                        f"({', '.join(f'{t:.5f}' for t in ts)})")
                if kind.startswith("v1_"):
                    med_alone = float(np.median(alone[label]))
                    part += (f", entry alone {float(np.mean(alone[label])):.5f} ms, median "
                             f"{med_alone:.5f}")
                    if label != "old":
                        part += f" ({label}/old of the medians alone {med_alone / medo_alone:.4f})"
                if label != "old":
                    part += (f", {label}/old {m / mo:.4f} (of the medians {med / medo:.4f}), share "
                             f"{100 * bound / m:.2f} %, outputs max|{label}-old| "
                             f"{case.max_diff(kind, label):.3e}")
                    if dname == "f32" and kind in ("v1_fwd", "v1_dkv"):
                        ok, line = f32_gate(kind, case.outputs(kind, label),
                                            case.outputs(kind, "old"))
                        part += f", within the f32 gate of old's {ok} ({line})"
                parts.append(part)
            print(f"{sname} {dname} {kind}: bound {bound:.5f} ms ({by}), share old "
                  f"{100 * bound / mo:.2f} %, max|old| {case.max_old(kind):.3e}; "
                  + "; ".join(parts))
        del case
        torch.cuda.empty_cache()
    if "vq" in a.kinds:
        print("vq: each build as its wrapper runs it (a two-launch build: the code norms, two "
              "scratch tensors and the outputs before each launch), then each entry alone")
    for S in (VQ_SHAPES if "vq" in a.kinds else ()):
        case = VqCase(S, fns, flags)
        times = {label: [] for label in builds}
        alone = {label: [] for label in builds}
        for _ in range(a.rounds):
            for label in order:
                times[label].append(_ms(*case.wrapper(label), a.reps))
                alone[label].append(_ms(*case.entry(label), a.reps))
        bound, by = vq_bound_ms(S)
        med = {lb: float(np.median(ts)) for lb, ts in times.items()}
        med_alone = {lb: float(np.median(ts)) for lb, ts in alone.items()}
        parts = []
        for label in builds:
            part = (f"{label} as its wrapper runs it, median {med[label]:.5f} ms "
                    f"({', '.join(f'{t:.5f}' for t in times[label])}), entry alone median "
                    f"{med_alone[label]:.5f} ms ({', '.join(f'{t:.5f}' for t in alone[label])}), "
                    f"share of bound alone {100 * bound / med_alone[label]:.2f} %")
            if label != "old":
                part += (f", {label}/old of the medians {med[label] / med['old']:.4f}, alone "
                         f"{med_alone[label] / med_alone['old']:.4f}; {case.compare(label)}")
            parts.append(part)
        print(f"vq S={S} N={VQ_N} D={VQ_D}: bound {bound:.5f} ms ({by}); " + "; ".join(parts))
        del case
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
