#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``titok_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit. Phases, in order; any failure exits non-zero:

1. device and build: the card, its power limit, and the ``nvcc`` build of
   every ``titok_tpu_torch/csrc/*.cu`` with its ``-Xptxas -v`` lines;
2. every kernel against its plain PyTorch version on the card, at the
   serving shape and beside it, in bf16 and f32, with times (CUDA events)
   of the kernel, the plain version, one library call and the bound;
3. the serving path, tiny TiTok at full width (``configs/tiny.yaml``),
   seeded random weights: encode, forward, decode_indices and a uint8
   encode through ``TiTokModel``, with launch counts, range checks, the
   kernel path against the plain path (f32 and bf16), and request times;
4. one JSON line listing every kernel with its numbers;
5. last line: ``{"ok": true, "device": {...}}``.

Without a card, or outside a checkout, it exits non-zero and prints no
result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SRC = "titok_tpu_torch/csrc/flash_segment_attn_fwd.cu"
KERNEL_REPLACES = "titok_tpu/ops/flash_attention_mh.py:58"  # _fwd_kernel, via _mh_fwd
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 FMA, HBM
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
# kernel vs plain version: (out atol, out rtol, lse atol)
#   f32: fp32 FMA order only; bf16: two bf16 roundings (p and out) and
#   another summation order
TOL = {"f32": (1e-5, 0.0, 1e-5), "bf16": (3e-2, 1e-2, 1e-3)}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def segments(lengths, S):
    seg = np.zeros((S,), np.int32)
    off = 0
    for i, n in enumerate(lengths):
        seg[off:off + n] = i + 1
        off += n
    check(off <= S, f"segments {off} exceed S={S}")
    return seg


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attn_bound_ms(seg: np.ndarray, S: int, hq: int, hkv: int, d: int, dtype: str):
    """Least time for the attention forward on these inputs: useful FLOPs
    (live segments only) over the peak of the type, and bytes (q, k, v,
    out, lse, ids, each once) over HBM; the larger one."""
    ids, counts = np.unique(seg[seg != 0], return_counts=True)
    del ids
    flops = 4.0 * d * hq * float((counts.astype(np.float64) ** 2).sum())
    esize = 2 if dtype == "bf16" else 4
    nbytes = S * hq * d * esize * 2 + S * hkv * d * esize * 2 + S * hq * 4 + S * 4
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def phase_build():
    import torch

    from titok_tpu_torch.ops import _build

    print(f"device: {torch.cuda.get_device_name(0)}  count: {torch.cuda.device_count()}  "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    info = _build.build_all()
    print(f"build: {len(info)} kernel sources in {time.perf_counter() - t0:.2f} s")
    for name, rec in info.items():
        print(f"  {name}: nvcc {rec['seconds']:.2f} s")
        for line in rec["ptxas"].splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling entry")):
                print(f"    {line.strip()}")
    check("flash_segment_attn_fwd" in info, "no flash_segment_attn_fwd build")
    return card


def phase_kernels(card: str) -> dict:
    """Kernel vs plain version at the serving shapes; times at the bench shape."""
    import torch
    import torch.nn.functional as F

    from titok_tpu_torch.ops import flash_attention_mh as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    D = 64
    bench = ("bench 10x576 4/2", segments([576] * 10, 6144), 6144, 4, 2)
    cases = [
        bench,
        ("large heads 10x576 16/4", segments([576] * 10, 6144), 6144, 16, 4),
        ("ragged 1..1892 4/2", segments([1, 2, 63, 64, 65, 127, 1892, 700, 5, 333], 3299),
         3299, 4, 2),
    ]
    results = {"f32": {"max_abs_err": 0.0}, "bf16": {"max_abs_err": 0.0}}
    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        atol, rtol, lse_atol = TOL[dname]
        for label, seg_np, S, hq, hkv in cases:
            gen.manual_seed(S * 100 + hq)
            q = torch.randn(S, hq, D, generator=gen, device=dev).to(dtype)
            k = torch.randn(S, hkv, D, generator=gen, device=dev).to(dtype)
            v = torch.randn(S, hkv, D, generator=gen, device=dev).to(dtype)
            seg = torch.from_numpy(seg_np).to(dev)
            out, lse = fa._fwd(q, k, v, seg)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa.flash_segment_attention_mh_reference(q, k, v, seg)
            o32, r32 = out.float(), ref_out.float()
            err_out = (o32 - r32).abs().max().item()
            err_lse = (lse - ref_lse).abs().max().item()
            ok = bool(((o32 - r32).abs() <= atol + rtol * r32.abs()).all()) and \
                err_lse <= lse_atol and bool(torch.isfinite(o32).all())
            print(f"kernel {dname} {label} S={S}: max|out-plain| {err_out:.3e} "
                  f"max|lse-plain| {err_lse:.3e} (atol {atol}, rtol {rtol}, lse atol "
                  f"{lse_atol}) {'ok' if ok else 'FAIL'}")
            check(ok, f"kernel disagrees with its plain version: {dname} {label}")
            results[dname]["max_abs_err"] = max(results[dname]["max_abs_err"], err_out)
            del ref_out, ref_lse, o32, r32

        # times at the bench shape
        label, seg_np, S, hq, hkv = bench
        q = torch.randn(S, hq, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(S, hkv, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(S, hkv, D, generator=gen, device=dev).to(dtype)
        seg = torch.from_numpy(seg_np).to(dev)
        kernel_ms = cuda_ms(lambda: fa._fwd(q, k, v, seg), reps=200)
        plain_ms = cuda_ms(lambda: fa.flash_segment_attention_mh_reference(q, k, v, seg),
                           reps=10, warmup=2)
        # yardstick only, never called by the port: one SDPA call with the
        # block-diagonal boolean mask (kv heads expanded beforehand)
        qb = q.permute(1, 0, 2)[None]
        kb = k.repeat_interleave(hq // hkv, dim=1).permute(1, 0, 2)[None]
        vb = v.repeat_interleave(hq // hkv, dim=1).permute(1, 0, 2)[None]
        rs = fa._remap_pad(seg)
        mask = (rs[:, None] == rs[None, :])[None, None]
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask), reps=20)
        bound_ms, bound_by, flops, nbytes = attn_bound_ms(seg_np, S, hq, hkv, D, dname)
        print(f"timing {dname} {label} S={S} [{card}]: kernel {kernel_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library (SDPA, bool mask) {library_ms:.4f} ms, "
              f"bound {bound_ms * 1e3:.2f} us ({bound_by}; {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB), share of bound {bound_ms / kernel_ms:.4f}")
        results[dname].update(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, qb, kb, vb, mask
    torch.cuda.empty_cache()
    return results


def _clips(rng):
    a = [rng.uniform(-1, 1, (3, 8, 128, 128)).astype(np.float32) for _ in range(6)]
    a_tc = [1, 16, 32, 64, 96, 128]
    b = [rng.uniform(-1, 1, (3, 16, 168, 168)).astype(np.float32),
         rng.uniform(-1, 1, (3, 8, 128, 168)).astype(np.float32),
         rng.uniform(-1, 1, (3, 8, 168, 128)).astype(np.float32)]
    b_tc = [128, 64, 1]
    d = rng.integers(0, 256, (8, 128, 128, 3), dtype=np.uint8)
    return a, a_tc, b, b_tc, d


def _serve(model, a, a_tc, b, b_tc, d, launches, dname, check_counts=True):
    """Requests (a)-(d) through the tokenizer API; checks launch counts
    (4 per encode/decode group, 8 per forward group), finiteness and index
    range. Returns the outputs."""
    cb = model.module.codebook_size
    grids = [c.shape[1:] for c in a]

    def run(name, fn, per_group, n_groups):
        before = launches[dname]
        res = fn()
        delta = launches[dname] - before
        if check_counts:
            check(delta == per_group * n_groups,
                  f"{name}: {delta} kernel launches, want {per_group} x {n_groups} groups")
        return res, delta

    idx_a, da = run("encode (a)", lambda: model.encode(a, a_tc), 4,
                    len(model._groups(a, a_tc)))
    (rec_b, aux_b), db = run("forward (b)", lambda: model.forward(b, b_tc), 8,
                             len(model._groups(b, b_tc)))
    rec_c, dc = run("decode_indices (c)", lambda: model.decode_indices(idx_a, grids), 4,
                    len(model._groups(a, a_tc)))
    idx_d, dd = run("encode uint8 (d)", lambda: model.encode([d], [32]), 4, 1)
    for i, tc in enumerate(a_tc):
        check(idx_a[i].shape == (tc,), f"encode (a) clip {i}: {idx_a[i].shape}")
    for ix in list(idx_a) + list(aux_b["indices"]) + list(idx_d):
        check(bool(((ix >= 0) & (ix < cb)).all()), f"index out of [0, {cb})")
    for clip, rec in zip(b, rec_b):
        check(rec.shape == clip.shape and np.isfinite(rec).all(), "forward (b) recon")
    for rec in rec_c:
        check(rec.shape == (3, 8, 128, 128) and np.isfinite(rec).all(), "decode (c) recon")
    check(idx_d[0].shape == (32,), "encode (d)")
    return {"idx_a": idx_a, "rec_b": rec_b, "idx_b": aux_b["indices"], "rec_c": rec_c,
            "idx_d": idx_d, "launches": (da, db, dc, dd)}


def _agreement(x: dict, y: dict) -> tuple[float, float]:
    ia = np.concatenate(list(x["idx_a"]) + list(x["idx_b"]))
    ib = np.concatenate(list(y["idx_a"]) + list(y["idx_b"]))
    share = float((ia == ib).mean())
    diff = max(float(np.abs(p - q).max()) for p, q in
               zip(list(x["rec_b"]) + list(x["rec_c"]), list(y["rec_b"]) + list(y["rec_c"])))
    return share, diff


def phase_serving(card: str) -> dict:
    import torch

    from titok_tpu_torch.config import load_config
    from titok_tpu_torch.models.titok import TiTokModel, init_params, make_titok
    from titok_tpu_torch.ops.flash_attention_mh import launches, reset_launches

    cfg = load_config(os.path.join(REPO, "configs", "tiny.yaml"))
    seq_len = int(cfg.training.sampling.eval_seq_len)
    min_grid = cfg.training.sampling.min_grid

    def build(**over):
        c = load_config(os.path.join(REPO, "configs", "tiny.yaml"),
                        [f"{k}={v}" for k, v in over.items()])
        module = make_titok(c)
        # seeded numpy weights with dense kernels at std 0.08 instead of the
        # reference init's 0.02: at 0.02 every latent token of a
        # random-weight model lands on one code, and the index checks below
        # would compare nothing
        params = init_params(module, seed=0)
        for name, w in params.items():
            if w.ndim == 2 and not name.endswith("mask_token"):
                params[name] = w * np.float32(4.0)
        return TiTokModel(module, params=params, seq_len=seq_len, min_grid=min_grid,
                          device="cuda")

    rng = np.random.default_rng(0)
    a, a_tc, b, b_tc, d = _clips(rng)

    # the main path: bf16 (bf16-mixed), attention through the kernel
    model = build()
    reset_launches()
    main = _serve(model, a, a_tc, b, b_tc, d, launches, "bf16")
    torch.cuda.synchronize()
    main_launches = launches["bf16"]
    print(f"serving bf16 (kernel): launches encode/forward/decode/encode-u8 = "
          f"{main['launches']}, total {main_launches}; indices in [0, "
          f"{model.module.codebook_size}); outputs finite")
    check(main_launches > 0, "the serving path launched no kernel")

    # f32 kernel path vs f32 plain path, same weights
    k32 = build(**{"training.main.precision": "32"})
    reset_launches()
    out_k32 = _serve(k32, a, a_tc, b, b_tc, d, launches, "f32")
    f32_launches = launches["f32"]
    p32 = build(**{"training.main.precision": "32", "training.main.attn_impl": "reference"})
    out_p32 = _serve(p32, a, a_tc, b, b_tc, d, launches, "f32", check_counts=False)
    check(launches["f32"] == f32_launches, "the plain path launched the kernel")
    share32, diff32 = _agreement(out_k32, out_p32)
    # bf16 plain path against the main run
    pbf = build(**{"training.main.attn_impl": "reference"})
    out_pbf = _serve(pbf, a, a_tc, b, b_tc, d, launches, "bf16", check_counts=False)
    share16, diff16 = _agreement(main, out_pbf)
    print(f"kernel path vs plain path:  f32 indices identical {share32 * 100:.3f} %, "
          f"recon max|diff| {diff32:.3e}  |  bf16 indices identical {share16 * 100:.3f} %, "
          f"recon max|diff| {diff16:.3e}")
    check(share32 >= 0.999 and diff32 <= 1e-4, "f32 kernel path disagrees with plain path")
    check(share16 >= 0.90, "bf16 kernel path disagrees with plain path")

    # request time of (a) on the main path
    for _ in range(3):
        model.encode(a, a_tc)
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        model.encode(a, a_tc)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"encode (a), 6 clips 8x128x128, bf16 [{card}]: {ms:.3f} ms/request, "
          f"{len(a) / ms * 1e3:.1f} clips/s (host clock, {reps} requests)")
    _breakdown(model, a, a_tc)
    return {"bf16": main_launches, "f32": f32_launches}


def _breakdown(model, a, a_tc) -> None:
    """Where one encode (a) request spends its time: host packing (host
    clock) and device time by kernel (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    model._pack(a, a_tc)
    pack_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.encode(a, a_tc)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy == 0:
        print("breakdown: the profiler recorded no device time (not measured)")
        return
    print(f"breakdown of one encode (a) request (profiled, wall {wall_ms:.3f} ms): host "
          f"packing {pack_ms:.3f} ms (unprofiled); device busy {busy:.3f} ms "
          f"({busy / wall_ms * 100:.1f} % of wall); top device kernels:")
    for key, dev_ms, count in rows[:8]:
        print(f"    {dev_ms:8.4f} ms  x{count:<4d} {key[:90]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; this script measures the port on the card",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "titok_tpu_torch")) or not os.path.exists(
            os.path.join(REPO, "configs", "tiny.yaml")):
        print("FAIL: run chip_smoke.py from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        card = phase_build()
        kres = phase_kernels(card)
        served = phase_serving(card)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    kernels = []
    for dname in ("bf16", "f32"):
        r = kres[dname]
        kernels.append({
            "name": f"flash_segment_attn_fwd_{dname}", "route": "cuda",
            "source": KERNEL_SRC, "replaces": KERNEL_REPLACES,
            "launches": served[dname], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
