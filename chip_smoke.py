#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``titok_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit. Phases, in order; any failure exits non-zero:

1. device and build: the card, its power limit, and the ``nvcc`` build of
   every ``titok_tpu_torch/csrc/*.cu`` with its ``-Xptxas -v`` lines and
   the entries that spill registers;
2. the attention forward kernel against its plain PyTorch version on the
   card, at the serving shape and beside it, in bf16 and f32, with times
   (CUDA events) of the kernel, the plain version, one library call and
   the bound;
3. the two attention backward kernels (dq, dk/dv) against the plain
   backward, in bf16 and f32, at the bench shape, large heads, a ragged
   packing, the stacked discriminator buffer of a train batch (24,752
   rows) and separate k ids, with the same four times at the bench shape,
   and planted faults (a wrong scale, dv of one q head, a skipped kv tile,
   bf16 roundings dropped) that the comparison must reject;
4. the serving path, tiny TiTok at full width (``configs/tiny.yaml``),
   seeded random weights: encode, forward, decode_indices and a uint8
   encode through ``TiTokModel``, with launch counts, range checks, the
   kernel path against the plain path (f32 and bf16), and request times;
5. the perceptual loss, then the training path. LPIPS and Gram of the
   tiny path's 25 frames at 128² on the card against the same module and
   weights on the CPU (fp32, TF32 off), ``crop_resize`` of its plan and
   the gradient to the frames likewise, the tower's forward and backward
   time, and the module's convolutions held to fp32 with the process's
   cuDNN TF32 flag on. Then the tiny GAN
   recipe of ``configs/tiny.yaml`` at full width with its own loss (L1,
   LPIPS over 25 random 128² crops, GAN; seeded random VGG weights, as
   ``allow_random_lpips`` allows; ``train_seq_len`` 6144, bf16-mixed),
   seeded random weights and synthetic clips, 2 warm-up and 4 timed steps
   through ``TrainStepBuilder`` with launch counts per step, finite metrics
   and a positive ``gen/perceptual_loss``, moved params, unchanged LPIPS
   weights, index ranges, ms/step, the generator's grads against an
   LPIPS-off pass on the same batch, steps with LPIPS on and off in turn,
   and a profile of one step (the tower's convolutions' device time); then
   3 steps of the f32 kernel path against the f32 plain path at
   ``train_seq_len`` 2048 (warm-up 2 steps) from the same weights,
   batches, plans and noise;
6. the VQ nearest-neighbour kernel against its plain version: base_vq's
   shape (S 4096, N 16384, D 8: a training step, or a serving group padded
   to 4096 rows), the unpadded S 3409 and 1152 of its request (a), a ragged
   S with small N, a separated codebook, duplicated codes in a later lane
   group, warp and cluster rank of the plan, exact ties, two launches bit
   for bit, a row of NaNs; three planted faults (the last step of codes
   skipped, ties sent to the highest index, the later cluster rank's copy
   taken over the earlier's) that the gate must reject; the four times at
   S 4096;
7. the EMA-VQ serving path, base_vq at full width (``configs/base_vq.yaml``,
   width 768, 12+12 layers, heads 12/4, codebook 16384 x 8), seeded random
   weights and codebook: encode, forward and decode_indices of 8- and
   16-frame clips at 256x256 and 256x192 through ``TiTokModel``, with launch
   counts, decode against forward, the kernel path against the plain path
   in f32, and request times;
8. the EMA-VQ training path: the base_vq GAN recipe at full width
   (LPIPS off, ``perceptual_weight=0``, ``train_seq_len`` 4096, bf16-mixed, the
   codebook drawn from the first batch, the config's lr warm-up), seeded
   random weights and synthetic clips, 2 warm-up and 3 timed steps with
   launch counts per step (the VQ kernel once, each attention kernel 48
   times), finite metrics, a moving codebook, perplexity, ms/step and a
   profile of one step;
9. the three RoPE-fused attention kernels (``attn_impl: flash_rope``)
   against their plain versions, bf16 and f32: the large serving layout
   (heads 16/4) with the packer's tables (P 30) and with random angles at
   P 16, the bench shape, a ragged packing, the stacked discriminator
   buffer of a large train batch (33,008 rows) with its concatenated
   tables, and separate k ids and k tables; the fused forward against
   ``apply_rotary_emb`` + the unfused kernel bit for bit; planted faults
   (k left unrotated, the forward rotation applied to dq, all 32 pairs
   rotated, q's tables used for k) that the gate must reject; the four
   times at the large serving layout and the bench shape;
10. the large serving path (``configs/large.yaml``, ``flash_rope``, width
   1024, 24+24 layers, heads 16/4, FSQ [8, 8, 8, 6, 5]), seeded weights
   drawn on the card: encode, forward and decode_indices of the base_vq
   request, with launch counts (the rope forward only), decode against
   forward, the f32 kernel path against the plain path, request times;
11. the large training path at full width and depth (remat on, as the
   config has it; LPIPS off, ``train_seq_len`` 8192,
   bf16-mixed): 2 warm-up and 3 timed steps with launch counts per step
   derived from the layer counts (remat replays each attention forward in
   the backward), finite metrics, moved params, peak device memory,
   ms/step and a profile of one step; then the same model in f32 at
   ``train_seq_len`` 2048 with remat on and off from the same weights,
   batches and noise: losses and grads must agree bit for bit (the loss
   values that differ are printed), and the time of the steps after the
   first (host clock, ending in a synchronize);
12. the three v1 attention kernels (``attn_impl: flash_v1``) against their
   plain versions, bf16 and f32: the bench shape, the base_vq serving
   layout at heads 12/4, 16/4 and 8/1, a ragged packing, the tiny stacked
   discriminator buffer (24,752 rows), the bench shape and the ragged
   packing at 4/4 (one head a group); group-summed dk/dv (the kernel sums
   each group; bf16: each q head rounded first); the forward against the
   row 1 kernel (f32: bit for bit on every case; bf16: where every segment
   starts at a multiple of 64), the dq against the row 2 dq, bit for bit
   in either dtype, and in f32 the dk/dv against the row 2 dk/dv, bit for
   bit; planted faults (the last
   overlapping kv tile skipped, dk/dv of one q head of each group, p not
   rounded before p.v, lse with the wrong scale) that the gates must
   reject; the four times at the bench shape and the base_vq layout at
   12/4;
13. the trainer: ``Trainer(cfg).fit()`` of ``configs/tiny_fsq16k.yaml`` at
   full width through the v1 kernels (synthetic data, LPIPS on with random
   VGG weights), 8 steps
   with eval at 4 and 8 and checkpoints every 4: launches per step and in
   all, zero launches of the other attention kernels, finite metrics,
   device PSNR/SSIM, codebook scores, checkpoints, ``config.yaml``, the
   trainer's rate against the bare step; then the CLI ``python -m
   titok_tpu_torch.train`` resuming that run to step 12, and a fresh run
   stopped by SIGTERM (exit 143, a checkpoint at the step reached) and
   resumed; then f32 at ``train_seq_len`` 2048 (LPIPS off: a resumed run
   draws its plans anew from ``seed + 1``), 4 steps straight against
   2 + save + resume + 2 (losses, params, the R1/R2 noise generator), under
   AdamW and then under adafactor, bit for bit (losses, params, both
   optimizers' state, the noise generator);
14. the data layer: one probe of libav (``pkg-config``) decides what runs.
   Everywhere: the ``pack`` library (``native/packer.cpp``, built with
   ``g++``) against its plain version on 4 seeded uint8 clips, bit for bit;
   packing ms a 6144-row tiny batch on the f32, bf16 and uint8 wires, fused
   and plain; H2D bytes and ms a batch on each wire; ``decode_rows`` of the
   uint8 rows on the card against the host's f32 rows, bit for bit; at
   precision 32 the uint8 and f32 wires' steps on the same 3 batches,
   identical grads and losses; ``tarfile_to_samples`` over the eval-set
   tars against ``MANIFEST.json``; ``Trainer(cfg).fit()`` of
   ``configs/tiny.yaml`` as shipped (LPIPS on, random VGG weights) for 6
   steps and an eval on synthetic clips, then on the bf16 and the uint8
   wire, with launch counts per step (rows 1-2, 16 each) and tokens/s.
   With libav, those two fits read the eval-set tars
   (``docs/eval_set/{00000..00002}.tar``), and the phase adds decode and
   chunk ms a clip at 0 and 3 threads, the decode hashes against the CPU
   pins (printed, not gated), ``configs/tiny_csv.yaml`` on a CSV of clips,
   the converter and the CLI on the tars; without it, they read seeded
   uint8 clips, and a ``VideoReader`` must raise;
15. the trained tiny checkpoint (``docs/runs/r4_tiny_lpips/config.yaml``,
   step 5000): the sha256 of its three committed fixtures
   (``docs/artifacts/r4_tiny_lpips_5000_torch/``: the converted generator,
   the first eval clips of ``docs/eval_set/00000.tar`` as uint8 chunks,
   JAX's f32 results), then the evaluate CLI's ``token_sweep`` over those
   clips at 1, 16 and 128 tokens through the f32 kernel (8 row 1 launches
   a batch): indices against JAX's on >= 99.9 % of tokens with every miss a
   near tie (JAX's value within 1e-4 of its rounding boundary), PSNR
   within 0.01 dB and SSIM within 1e-3 of JAX's, the ``token_sweep.jsonl``
   rows; the plain path (dense attention) likewise; bf16-mixed through
   the bf16 kernel against f32; ms an eval batch in f32 and bf16;
16. the eval metrics at full width on seeded weights (no real weights in
   the repo), loaded from converter ``.npz`` files by the port's loaders:
   I3D (400 classes, 224²), V-JEPA ``vit_large`` and InceptionV3 (299²)
   over the committed clips and one seeded 16x256x320 clip, against the
   sha256-pinned features and scores of the JAX package
   (``jax_metrics.npz``): features within 1e-5 of JAX's largest, FVD and
   FID within 1e-3 relative, JEDi, MMD and IS 1e-4, the port's host math
   on JAX's features 1e-6; ms a clip of each network; planted faults
   (symmetric padding in I3D's stride-2 stem, the resize without
   antialias, V-JEPA's position table recomputed) that must be rejected;
   then r4 with ``log_metrics: [ssim, psnr, fvd, jedi]`` through
   ``Trainer.validate`` (finite ``eval/fvd`` and ``eval/jedi`` in
   ``metrics.jsonl``; the eval pass with and without them) and
   ``token_sweep`` at 1, 16 and 128 tokens;
17. the serving tools on the trained tiny checkpoint and base_vq: r4's
   int8 serving path (``serving/quant.py``, w8a16 and w8a8) scored on the
   committed clips at 1, 16 and 128 tokens through the evaluate CLI's
   ``quantize_eval`` and ``token_sweep`` (through the f32 attention kernel):
   the mean over the 30 encoded clips of each clip's share of f32's
   indices >= 0.98, the int8 decoder's PSNR against f32's on the f32
   indices > 40 dB, >= 99 % of JAX's committed int8 indices at each count,
   PSNR within 0.01 dB and SSIM within 1e-3 of JAX's int8 scores; ms an
   eval batch in f32, bf16, w8a16 and w8a8; then r4 in f32 and w8a8 and
   base_vq in f32 (seeded) exported with ``torch.export`` on the card
   (``tools/export_model.py``; the kernels are custom ops) and loaded with
   ``load_exported`` in one fresh process that must import no
   ``titok_tpu_torch.models`` module: indices bit for bit the live
   module's, reconstructions within 1e-5, every kernel launched as often
   as in the live call (the VQ kernel's counter too), the artifacts'
   sizes; then r4's f32 artifact behind ``tools/serve.py``'s server on
   127.0.0.1 at batch windows 0 and 20 ms: served indices equal to
   ``TiTokModel.encode``'s, ``/forward`` and ``/decode``, 4 concurrent
   requests in fewer device calls with the single-request indices, and
   ``tools/serve_bench.py`` (forward, 8 clients, 64 requests of 8x128x128
   uint8 clips at 64 tokens) at each window, more than one clip a call at
   20 ms; three planted faults that must be rejected: every int8 scale 1 %
   off (the int8 gates), the attention op's CUDA implementation replaced
   by its plain version in the loading process (the launch gate), and
   ``proj_out``'s int8 weight left unpadded (``torch._int_mm`` must raise);
18. ``training.main.steps_per_call`` on seeded uint8 clips: at precision
   32 with LPIPS off, K = 3 with a tail of 1 against K = 1 (losses, grad
   norms and params bit for bit); then the r4 config as shipped (K = 8,
   bf16-mixed, LPIPS on with random VGG weights, the uint8 wire) for 16
   steps with an eval and a checkpoint at 16, against K = 1: launches a
   call (16 of each of rows 1-2 a step), one H2D transfer a call, finite
   losses, tokens/s and peak device memory;
19. the repo's all-large adafactor recipe (``docs/runs/r3f_alllarge_adafactor``:
   ``configs/tiny.yaml`` with large encoder, decoder and discriminator,
   ``optimizer.name=adafactor``, remat, the uint8 wire, synthetic data,
   LPIPS off) at full width: in this process 3 steps under AdamW and under
   adafactor (launches a step: rows 1-2 in bf16, the forwards twice for
   remat), each optimizer's state bytes, peak device memory, ms a step and
   its update alone; then through ``python -m
   titok_tpu_torch.tools.train_supervised`` for 8 steps with a checkpoint
   every 2: the child SIGKILLed once checkpoint 4 exists (the supervisor
   relaunches, the child resumes from step 5), the supervisor SIGTERMed
   once the resumed child logs a step (the child saves and exits 143, the
   supervisor exits 143 without a relaunch), and a new supervisor over
   the same directory (it resumes on its first launch and ends rc 0 at
   step 8, every logged value finite);
20. the f32 rows of the kernel table: each f32 entry of rows 1-4 and the
   v1 f32 dq, its time, bound and share of bound at the shapes timed
   above, with the launch shape the library reports (threads, registers,
   dynamic shared memory, CTAs an SM) for the pipelined forward, dq and
   dk/dv;
21. one JSON line listing every kernel with its numbers; ``launches`` is
   the kernel's count on the training path of its dtype (the VQ kernel's:
   the base_vq training path; the rope kernels': the large training path,
   f32 its remat run; the v1 kernels': the trainer's fit, f32 the straight
   f32 run), and ``launches_by_path`` its count on each path, each read
   from counters set to 0 just before that path (the data phase's fits
   too: ``train_data_bf16``, ``train_data_uint8``; the parity sweeps,
   ``eval_r4_f32``, ``eval_r4_bf16``; the sweep with the video metrics,
   ``eval_r4_metrics``; the int8 sweeps, ``eval_r4_w8a16``,
   ``eval_r4_w8a8``; the exported programs in the loading process,
   ``exported_r4_f32``, ``exported_r4_w8a8``, ``exported_base_vq_f32``;
   the two bench runs, ``http_bench_r4``; the K = 8 fit, ``train_r4_k8``;
   the all-large adafactor steps, ``train_alllarge``);
22. last line: ``{"ok": true, "device": {...}}``.

Each phase prints its seconds and the script's so far.

Without a card, or outside a checkout, it exits non-zero and prints no
result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SRC = "titok_tpu_torch/csrc/flash_segment_attn_fwd.cu"
KERNEL_REPLACES = "titok_tpu/ops/flash_attention_mh.py:58"  # _fwd_kernel, via _mh_fwd
BWD_SRC = "titok_tpu_torch/csrc/flash_segment_attn_bwd.cu"
BWD_REPLACES = {"dq": "titok_tpu/ops/flash_attention_mh.py:404",   # _bwd_dq_kernel
                "dkv": "titok_tpu/ops/flash_attention_mh.py:450"}  # _bwd_dkv_kernel
# the rope instantiations of the same sources (attn_impl: flash_rope)
ROPE_REPLACES = {"fwd": "titok_tpu/ops/flash_attention_mh.py:165",   # _fwd_kernel_rope
                 "dq": "titok_tpu/ops/flash_attention_mh.py:229",    # _bwd_dq_kernel_rope
                 "dkv": "titok_tpu/ops/flash_attention_mh.py:289"}   # _bwd_dkv_kernel_rope
# the v1 kernels (attn_impl: flash_v1)
V1_SRC = "titok_tpu_torch/csrc/flash_segment_attn_v1.cu"
V1_REPLACES = {"fwd": "titok_tpu/ops/flash_attention.py:63",    # _fwd_kernel, via _flash_fwd
               "dq": "titok_tpu/ops/flash_attention.py:166",    # _bwd_dq_kernel, via _flash_bwd
               "dkv": "titok_tpu/ops/flash_attention.py:210"}   # _bwd_dkv_kernel, via _flash_bwd
LARGE = os.path.join(REPO, "configs", "large.yaml")
VQ_SRC = "titok_tpu_torch/csrc/vq_nearest.cu"
VQ_REPLACES = "titok_tpu/ops/vq_distance.py:25"  # _vq_kernel, via vq_nearest_pallas
# VQ kernel vs plain version (vq_distance.gate): every row's code within
# VQ_EPS * (1 + |d*|) of the plain minimum d*, its partial distance as
# close. The kernel's FMA-contracted dot product of 8 terms and the plain
# version's rounded products differ by a few ulp: 3.7e-7 at the base_vq
# shape on an H100 (PERF.md, Findings, PR 3)
VQ_EPS = 1e-6
# attention kernel launches per train step, per kernel: one per attention
# layer of the generator's encoder and decoder, of the stacked disc pass in
# the generator loss and of the one in the discriminator step
TRAIN_LAUNCHES = {"tiny": 4 + 4 + 4 + 4, "base": 12 + 12 + 12 + 12, "large": 24 + 24 + 24 + 24}
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 FMA, HBM
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
# kernel vs plain version: (out atol, out rtol, lse atol)
#   f32: fp32 FMA order only; bf16: two bf16 roundings (p and out) and
#   another summation order
TOL = {"f32": (1e-5, 0.0, 1e-5), "bf16": (3e-2, 1e-2, 1e-3)}
# backward kernels vs plain backward, each of dq, dk, dv against the plain
# version's b: (atol_frac, rtol, nrel) for
#   |kernel - b| <= atol_frac * M + rtol * |b|   every entry,
#   rms(kernel - b) <= nrel * R                  over each output,
# with M the largest |entry| and R the rms of the plain dq, dk and dv
# together: the size of the whole gradient. The grads are small (about 0.07
# at the bench shape, max|b| 0.7-4.8 over the cases), so the absolute part
# scales with them; taken over all three outputs, it also covers an output
# that is only round-off (a one-row segment has dq = dk = 0). bf16: both
# sides round p, ds and the outputs to bf16 at the same places; they differ
# by the f32 sum order, so an output lands on the neighbouring bf16 value at
# times: one bf16 ulp is under 2**-7 (0.8 %) of |b|, which rtol admits.
# f32: FMA order only. The limits are about 3x the worst the kernels needed
# over the five cases on an H100 (PERF.md, Findings); the planted faults of
# phase_bwd_kernels show what they reject.
BWD_TOL = {"f32": (1e-6, 1e-4, 3e-6), "bf16": (1.5e-3, 1e-2, 5e-4)}
EVAL_SET = os.path.join(REPO, "docs", "eval_set")
# SHA-256 of the decoded uint8 frames (every frame) of the first three clips
# of docs/eval_set/00000.tar, and of their resize_center_crop to 128x128, as
# the JAX package's reader and resize give them on a CPU host with libavformat
# 59.27.100, libavcodec 59.37.100, libavutil 57.28.100 and libswscale 6.7.100;
# tests/test_torch_data.py holds the port's reader to them. Decode and
# swscale bits may differ across libav builds: the data phase prints whether
# a machine's libav gives them, and does not gate on it
EVAL_SET_SHA256 = {
    "bdec1c95231840d5a4f8e6fc8ec7b795": (
        "1cb323413f67642a8ac86072db2474a412ed15db09302ac259e36b093efba12a",
        "c666d50d510e485e80a61c75b6434522c9544073fbfdf1f4fa456dafa318c219"),
    "b6ef2518f4614a8a8635898ebb90dac3": (
        "e990867168a07c41dc02de18923adefa7f4bbd9372846c4be2d2bc3294705554",
        "0661fc4e385b7e2fed85feddf1e984e39b9cbb8219f97f01dedbf60473e37777"),
    "35674a8ce72144fdb3755e0bafb52144": (
        "0da489e69d500545575bc4f92255bf0207c6cd0251395cd11f8ae7690cefc890",
        "0135b5fba91fda38d1ed70e680baba8f1b7d370aaf1a54ed500c9faedf2bde52"),
}


def eval_set_sha256(tarfile_to_samples, reader, resize_center_crop) -> dict:
    """``{key: (frames sha256, 128x128 center crop sha256)}`` of the first
    three clips of ``00000.tar`` through the given reader functions."""
    import hashlib
    import itertools

    out = {}
    for s in itertools.islice(tarfile_to_samples(os.path.join(EVAL_SET, "00000.tar")), 3):
        r = reader(s["mp4"])
        frames = r.get_batch(np.arange(len(r)))
        crop = np.ascontiguousarray(resize_center_crop(frames, (128, 128)))
        out[s["__key__"]] = tuple(hashlib.sha256(a.tobytes()).hexdigest() for a in (frames, crop))
    return out


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


# the packed layout of base_vq serving request (a) below, first group:
# 8x256x256 @1, 16x256x256 @16, 8x256x192 @32, 16x256x192 @64, 8x256x256 @96
# (patch (4,16,16): 512, 1024, 384, 768, 512 patch rows plus the tokens)
BASE_SEG = segments([513, 1040, 416, 832, 608], 4096)


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
    spills = []  # entries with spill stores, from each entry's "Function properties"
    for name, rec in info.items():
        print(f"  {name}: nvcc {rec['seconds']:.2f} s")
        entry = ""
        for line in rec["ptxas"].splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            # the VQ source's 16 instantiations: the D 8 one (base_vq) printed
            shown = name != "vq_nearest" or "ILi8E" in entry
            if shown and any(w in line for w in ("registers", "spill", "smem", "Compiling entry")):
                print(f"    {line.strip()}")
            stores = re.search(r"(\d+) bytes spill stores", line)
            if stores and int(stores.group(1)) > 0:
                spills.append(f"{name}: {entry}")
    print(f"entries that spill: {', '.join(spills) if spills else 'none'}")
    for name in ("flash_segment_attn_fwd", "flash_segment_attn_bwd", "flash_segment_attn_v1",
                 "vq_nearest"):
        check(name in info, f"no {name} build")
    return card


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    from titok_tpu_torch.ops import flash_attention_mh as fa
    from titok_tpu_torch.ops import vq_distance as vd

    fa.reset_launches()
    vd.reset_launches()


def read_counts() -> dict:
    """Every kernel's launch count: the attention kernels under their
    ``flash_attention_mh.launches`` keys, the VQ kernel as ``vq_f32``."""
    from titok_tpu_torch.ops import flash_attention_mh as fa
    from titok_tpu_torch.ops import vq_distance as vd

    return {**fa.launches, "vq_f32": vd.launches["f32"]}


def _vq_inputs(kind, S, N, D, seed, shift=None):
    """z [S, D] and a codebook [N, D] on the card: "normal" (random normal
    both), "separated" (codes 10x apart, z near a random code),
    "duplicated" (the same with codes [shift, 2 shift) repeating codes
    [0, shift); shift N // 2 by default) or "ties" (integer codes, z on the
    midpoint of two: exactly equal distances)."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "normal":
        return (torch.randn(S, D, generator=g, device=dev),
                torch.randn(N, D, generator=g, device=dev))
    if kind == "ties":
        cb = torch.randint(-3, 4, (N, D), generator=g, device=dev).float()
        a = torch.randint(0, N, (S,), generator=g, device=dev)
        b = torch.randint(0, N, (S,), generator=g, device=dev)
        return (cb[a] + cb[b]) / 2, cb
    cb = torch.randn(N, D, generator=g, device=dev) * 10.0
    if kind == "duplicated":
        shift = N // 2 if shift is None else shift
        cb[shift:2 * shift] = cb[:shift].clone()
    pick = torch.randint(0, N, (S,), generator=g, device=dev)
    return cb[pick] + 0.05 * torch.randn(S, D, generator=g, device=dev), cb


def _vq_line(g) -> str:
    return (f"slack {g['slack']:.2e}, dist_err {g['dist_err']:.2e}, identical "
            f"{g['same'] * 100:.3f} % (eps {g['eps']})")


def vq_bound_ms(S: int, N: int, D: int):
    """Least time of one VQ search: 2 S N D fp32 FLOP at the FMA peak, or
    the bytes of z and the codebook read once and idx, dist written once;
    the larger, with which bounds it, the FLOP and the bytes."""
    flops = 2.0 * S * N * D
    nbytes = S * D * 4 + N * D * 4 + S * 8
    t_ops, t_bytes = flops / PEAK_FLOPS["f32"] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def phase_vq_kernel(card: str) -> dict:
    """The VQ kernel vs its plain version (base_vq's shape and two unpadded
    S, ragged, separated, duplicates in a later lane group, warp and cluster
    rank, exact ties, a row of NaNs, two launches); planted faults; times at
    base_vq's shape."""
    import torch

    from titok_tpu_torch.ops import vq_distance as vd

    S, N, D = 4096, 16384, 8
    p = vd.plan_for(S, N)
    # where a code's duplicate lands at the base_vq plan: the next lane
    # group's range, the next warp's, the next cluster rank's
    group_shift = p.per_range
    warp_shift = p.per_range * vd.GROUPS
    rank_shift = p.per_range * vd.GROUPS * p.warps
    cases = [  # (label, kind, S, N, D, exact, shift)
        ("base_vq 4096x16384x8, normal", "normal", 4096, 16384, 8, False, None),
        ("unpadded S 3409x16384x8", "normal", 3409, 16384, 8, False, None),
        ("unpadded S 1152x16384x8", "normal", 1152, 16384, 8, False, None),
        ("ragged S 3299, N 1000", "normal", 3299, 1000, 8, False, None),
        ("ragged S 777, N 37 (under one step), D 4", "normal", 777, 37, 4, False, None),
        ("separated, 4096x16384x8", "separated", 4096, 16384, 8, True, None),
        (f"duplicates in the next lane group (+{group_shift})", "duplicated", 4096, 16384, 8,
         True, group_shift),
        (f"duplicates in the next warp (+{warp_shift})", "duplicated", 4096, 16384, 8, True,
         warp_shift),
        (f"duplicates in the next cluster rank (+{rank_shift})", "duplicated", 4096, 16384, 8,
         True, rank_shift),
        ("exact ties, 2000x500x8", "ties", 2000, 500, 8, True, None),
    ]
    err = 0.0
    for label, kind, S_, N_, D_, exact, shift in cases:
        z, cb = _vq_inputs(kind, S_, N_, D_, seed=S_ + N_, shift=shift)
        idx, dist = vd.vq_nearest(z, cb)
        torch.cuda.synchronize()
        g = vd.gate(z, cb, idx, dist, eps=VQ_EPS, exact=exact)
        ok = g["ok"] and g["same"] >= 0.999
        if kind == "duplicated":  # no index in the repeating copy
            ok = ok and not bool(((idx >= shift) & (idx < 2 * shift)).any())
        print(f"vq kernel {label} (plan {tuple(vd.plan_for(S_, N_))}): {_vq_line(g)} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"the VQ kernel disagrees with its plain version: {label}")
        err = max(err, g["abs_err"])
    # two launches, the same bits; a row of NaNs gives (0, +inf)
    z, cb = _vq_inputs("normal", S, N, D, seed=S + N)
    a_i, a_d = vd.vq_nearest(z, cb)
    b_i, b_d = vd.vq_nearest(z, cb)
    same_bits = torch.equal(a_i, b_i) and torch.equal(a_d.view(torch.int32), b_d.view(torch.int32))
    zn = z.clone()
    zn[5] = float("nan")
    n_i, n_d = vd.vq_nearest(zn, cb)
    torch.cuda.synchronize()
    nan_ok = int(n_i[5]) == 0 and float(n_d[5]) == float("inf")
    rest_ok = torch.equal(torch.cat([n_i[:5], n_i[6:]]), torch.cat([a_i[:5], a_i[6:]]))
    print(f"vq kernel: two launches bit for bit {same_bits}; a row of NaNs -> "
          f"({int(n_i[5])}, {float(n_d[5])}), the other rows unchanged {rest_ok}")
    check(same_bits, "two launches of the VQ kernel differ")
    check(nan_ok and rest_ok, "a row of NaNs does not give (0, +inf)")

    # planted faults: each made by the kernel itself on altered inputs
    zd, cbd = _vq_inputs("duplicated", S, N, D, seed=1)
    zr, cbr = _vq_inputs("duplicated", S, N, D, seed=2, shift=rank_shift)
    skip = vd.vq_nearest(z, cb[: -vd.TILE].contiguous())
    hi_i, hi_d = vd.vq_nearest(zd, cbd.flip(0).contiguous())
    # the later cluster rank's copy taken: the kernel on the codebook with
    # the first rank's copies out of reach, so its cross-rank reduction
    # takes the second rank's, gated against the tied codebook
    far = cbr.clone()
    far[:rank_shift] += 1e4
    rk_i, rk_d = vd.vq_nearest(zr, far)
    later = bool(((rk_i >= rank_shift) & (rk_i < 2 * rank_shift)).any())
    check(later, "the planted cross-rank fault did not take the later rank's copies")
    faults = {
        f"the last step of {vd.TILE} codes skipped": vd.gate(z, cb, *skip, eps=VQ_EPS),
        "ties sent to the highest index": vd.gate(
            zd, cbd, (cbd.shape[0] - 1 - hi_i).to(torch.int32), hi_d, eps=VQ_EPS, exact=True),
        "the later cluster rank's copy taken": vd.gate(zr, cbr, rk_i, rk_d, eps=VQ_EPS,
                                                       exact=True),
    }
    for name, g in faults.items():
        print(f"  planted fault, {name}: {'PASSED' if g['ok'] else 'REJECTED'} ({_vq_line(g)})")
        check(not g["ok"], f"the VQ gate passes a planted fault: {name}")

    # times at base_vq's shape: the kernel at its C entry on fixed buffers,
    # through the wrapper, the plain version and one library call
    idx = torch.empty(S, dtype=torch.int32, device=z.device)
    dist = torch.empty(S, device=z.device)
    args = (z.data_ptr(), cb.data_ptr(), idx.data_ptr(), dist.data_ptr(), S, N, D, p.warps,
            p.cluster, p.per_range, torch.cuda.current_stream().cuda_stream)
    kernel_ms = cuda_ms(lambda: vd._kernel()(*args), reps=200)
    wrapper_ms = cuda_ms(lambda: vd.vq_nearest(z, cb), reps=200)
    plain_ms = cuda_ms(lambda: vd.vq_nearest_reference(z, cb), reps=5, warmup=1)
    # yardstick only, never called by the port: the dense distance matrix
    # and argmin in fp32 (TF32 is off), one [S, N] matrix in device memory
    cn = vd.code_norms(cb)
    library_ms = cuda_ms(lambda: (cn[None, :] - 2.0 * (z @ cb.T)).argmin(1), reps=20)
    bound_ms, bound_by, flops, nbytes = vq_bound_ms(S, N, D)
    print(f"timing vq kernel base_vq S={S} N={N} D={D} plan {tuple(p)} ({p.ctas} CTAs) [{card}]: "
          f"kernel {kernel_ms:.5f} ms (through the wrapper {wrapper_ms:.5f} ms), plain "
          f"{plain_ms:.4f} ms, library (dense fp32 matmul + argmin) {library_ms:.4f} ms, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}; {flops / 1e9:.3f} GFLOP fp32, "
          f"{nbytes / 1e6:.3f} MB), share of bound {bound_ms / kernel_ms:.4f}")
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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
        ("base heads 12/4, base_vq serving layout", BASE_SEG, 4096, 12, 4),
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

        # times at the bench shape (the numbers of the JSON line) and at the
        # base_vq serving layout with base heads 12/4
        for label, seg_np, S, hq, hkv in (bench, cases[2]):
            q = torch.randn(S, hq, D, generator=gen, device=dev).to(dtype)
            k = torch.randn(S, hkv, D, generator=gen, device=dev).to(dtype)
            v = torch.randn(S, hkv, D, generator=gen, device=dev).to(dtype)
            seg = torch.from_numpy(seg_np).to(dev)
            # the kernel alone: its C entry on fixed buffers, so the wrapper's
            # Python (checks, allocation) cannot starve the card; then the
            # wrapper as the model calls it
            out, lse = torch.empty_like(q), torch.empty(S, hq, device=dev)
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), seg.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), S, S, hq, hkv, float(D ** -0.5),
                    int(dname == "bf16"), torch.cuda.current_stream().cuda_stream)
            kernel_ms = cuda_ms(lambda: fa._kernel()(*args), reps=200)
            wrapper_ms = cuda_ms(lambda: fa._fwd(q, k, v, seg), reps=200)
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
            print(f"timing {dname} {label} S={S} [{card}]: kernel {kernel_ms:.4f} ms "
                  f"(through the wrapper {wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                  f"library (SDPA, bool mask) {library_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by}; {flops / 1e9:.3f} GFLOP, "
                  f"{nbytes / 1e6:.2f} MB), share of bound {bound_ms / kernel_ms:.4f}")
            timing = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
            if (label, S) == (bench[0], bench[2]):
                results[dname].update(timing)
            else:
                results[dname]["at_base_12_4"] = timing
            del q, k, v, qb, kb, vb, mask, out, lse
    torch.cuda.empty_cache()
    return results


def live_pairs(seg_q: np.ndarray, seg_k: np.ndarray) -> float:
    """sum over real segments (id != 0) of q rows x kv rows: the score
    entries the attention must compute."""
    ids, cq = np.unique(seg_q[seg_q != 0], return_counts=True)
    kid, ck = np.unique(seg_k[seg_k != 0], return_counts=True)
    kc = dict(zip(kid.tolist(), ck.tolist()))
    return float(sum(float(c) * kc.get(i, 0) for i, c in zip(ids.tolist(), cq.tolist())))


def bwd_bound_ms(seg_np, S, Sk, hq, hkv, d, dtype, products, outputs):
    """Least time for ``products`` [S x Sk x D] products (2 FLOP per
    multiply-add, live segments only) at the type's peak, or for the bytes
    (q, k, v, dO, lse, delta, ids read once; ``outputs``: "dq" and/or
    "dkv" written once) over HBM; the larger one."""
    flops = 2.0 * products * d * hq * live_pairs(seg_np, seg_np)
    esize = 2 if dtype == "bf16" else 4
    nbytes = (S * hq * d * esize * 2 + Sk * hkv * d * esize * 2 + S * hq * 4 * 2
              + (S + Sk) * 4)
    if "dq" in outputs:
        nbytes += S * hq * d * esize
    if "dkv" in outputs:
        nbytes += Sk * hkv * d * esize * 2
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def bwd_gate(got, want, dname):
    """dq, dk, dv against the plain version under BWD_TOL: returns (ok,
    rows) with per output (name, max|d|, max|b|, the atol_frac its entries
    need at the stated rtol, rms(d) / R)."""
    import torch

    atol_frac, rtol, nrel = BWD_TOL[dname]
    bs = [b.float() for b in want]
    M = max(max(b.abs().max().item() for b in bs), 1e-30)
    R = max(torch.cat([b.flatten() for b in bs]).square().mean().sqrt().item(), 1e-30)
    ok, rows = True, []
    for name, a, b32 in zip(("dq", "dk", "dv"), got, bs):
        a32 = a.float()
        d = (a32 - b32).abs()
        need = (d - rtol * b32.abs()).clamp(min=0).max().item() / M
        rel = d.square().mean().sqrt().item() / R
        ok = ok and bool(torch.isfinite(a32).all()) and need <= atol_frac and rel <= nrel
        rows.append((name, d.max().item(), b32.abs().max().item(), need, rel))
    return ok, rows


def _gate_line(rows) -> str:
    return "; ".join(f"{n} max|d| {e:.3e} max|b| {m:.3e} needs atol_frac {need:.2e} "
                     f"rms ratio {rel:.2e}" for n, e, m, need, rel in rows)


def _last_kv_tile_skipped(seg):
    """(q ids, k ids) on seg's device with which a kernel skips the last 64
    kv rows of every segment: those rows get ids of their own (2i+2 after
    2i+1), which no q row carries."""
    import torch

    s_np = seg.cpu().numpy()
    q_ids = np.where(s_np > 0, 2 * s_np - 1, 0).astype(np.int32)
    k_ids = q_ids.copy()
    for sid in np.unique(s_np[s_np > 0]):
        rows = np.nonzero(s_np == sid)[0]
        k_ids[rows[-64:]] = 2 * sid
    return torch.from_numpy(q_ids).to(seg.device), torch.from_numpy(k_ids).to(seg.device)


def _planted_faults(q, k, v, seg, out, lse, do, want, dname, hq, hkv):
    """The gate against kernels with a planted fault, at the bench shape:
    each fault is made by the kernel itself on altered inputs, by scaling
    its outputs, or (bf16 roundings dropped) by the plain version in f32,
    so it looks as a faulty kernel's output would. The gate must reject
    each."""
    import torch

    from titok_tpu_torch.ops import flash_attention_mh as fa

    D = q.shape[-1]
    good = fa._bwd(q, k, v, seg, out, lse, do)
    faults = {}
    faults["scale 5 % high in the kernel"] = fa._bwd(q, k, v, seg, out, lse, do,
                                                    scale=1.05 * D ** -0.5)
    faults["ds 2 % high (dq, dk)"] = (
        (good[0].float() * 1.02).to(q.dtype), (good[1].float() * 1.02).to(q.dtype), good[2])
    rep = hq // hkv
    keep = (torch.arange(hq, device=q.device) % rep == 0).to(do.dtype)
    one = fa._bwd(q, k, v, seg, out, lse, (do * keep[None, :, None]).contiguous())
    faults["dv summed over one q head of each group"] = (good[0], good[1], one[2])
    q_ids, k_ids = _last_kv_tile_skipped(seg)
    faults["last kv tile of every segment skipped"] = fa._bwd(
        q, k, v, q_ids, out, lse, do, k_segment_ids=k_ids)
    if dname == "bf16":
        # p and ds left in f32 (not rounded to bf16 before their products)
        f = fa.flash_segment_attention_mh_bwd_reference(
            q.float(), k.float(), v.float(), seg, out.float(), lse, do.float())
        faults["bf16 roundings of p and ds dropped"] = [t.to(q.dtype) for t in f]
    for name, got in faults.items():
        ok, rows = bwd_gate(got, want, dname)
        print(f"  planted fault {dname}, {name}: {'REJECTED' if not ok else 'PASSED'} "
              f"({_gate_line(rows)})")
        check(not ok, f"the {dname} backward gate passes a planted fault: {name}")


def _stacked_disc_ids(train_cfg):
    """The discriminator's stacked ids for the first batch of the training
    stream: build_disc_batch of a 6144-row tokenizer batch, 4 copies."""
    import torch

    from titok_tpu_torch.data.packing import build_disc_batch
    from titok_tpu_torch.losses.loss_module import DISC_TOKENS, stacked_segment_ids
    from titok_tpu_torch.training.trainer import synthetic_batches

    batch = next(iter(synthetic_batches(train_cfg, seed=0)))
    disc = build_disc_batch(batch, DISC_TOKENS)
    B1 = disc.sample_valid.shape[0] + 1
    seg = stacked_segment_ids(torch.from_numpy(disc.segment_ids), 4, B1).numpy()
    return seg, disc.sample_valid.shape[0], disc.segment_ids.shape[0]


def phase_bwd_kernels(card: str, train_cfg) -> dict:
    """Backward kernels vs the plain backward; times at the bench shape."""
    import torch
    import torch.nn.functional as F

    from titok_tpu_torch.ops import flash_attention_mh as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    D = 64
    disc_seg, bmax, sd = _stacked_disc_ids(train_cfg)
    print(f"stacked disc layout: Bmax {bmax}, Sd {sd}, 4 copies = {disc_seg.shape[0]} rows, "
          f"ids {int(disc_seg.min())}..{int(disc_seg.max())} non-decreasing "
          f"{bool((np.diff(disc_seg) >= 0).all())}")
    check(bool((np.diff(disc_seg) >= 0).all()) and int(disc_seg.min()) > 0,
          "stacked disc ids must be non-decreasing with no id 0")
    bench_seg = segments([576] * 10, 6144)
    # (label, q ids, k ids or None, hq, hkv)
    cases = [
        ("bench 10x576 4/2", bench_seg, None, 4, 2),
        ("large heads 10x576 16/4", bench_seg, None, 16, 4),
        ("base heads 12/4, base_vq serving layout", BASE_SEG, None, 12, 4),
        ("ragged 1..1892 4/2", segments([1, 2, 63, 64, 65, 127, 1892, 700, 5, 333], 3299),
         None, 4, 2),
        (f"stacked disc 4x{sd} 4/2", disc_seg, None, 4, 2),
        ("Sk != S 7x576 vs 10x576 4/2", segments([576] * 7, 4096), bench_seg, 4, 2),
    ]
    res = {f"{k}_{d}": {"max_abs_err": 0.0} for k in ("dq", "dkv") for d in ("bf16", "f32")}

    def inputs(S, Sk, hq, hkv, dtype):
        q = torch.randn(S, hq, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(Sk, hkv, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(Sk, hkv, D, generator=gen, device=dev).to(dtype)
        do = torch.randn(S, hq, D, generator=gen, device=dev).to(dtype)
        return q, k, v, do

    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        atol_frac, rtol, nrel = BWD_TOL[dname]
        for label, seg_np, kseg_np, hq, hkv in cases:
            S = seg_np.shape[0]
            Sk = S if kseg_np is None else kseg_np.shape[0]
            gen.manual_seed(S * 100 + hq + 7)
            q, k, v, do = inputs(S, Sk, hq, hkv, dtype)
            seg = torch.from_numpy(seg_np).to(dev)
            kseg = None if kseg_np is None else torch.from_numpy(kseg_np).to(dev)
            out, lse = fa._fwd(q, k, v, seg, k_segment_ids=kseg)
            got = fa._bwd(q, k, v, seg, out, lse, do, k_segment_ids=kseg)
            torch.cuda.synchronize()
            want = fa.flash_segment_attention_mh_bwd_reference(q, k, v, seg, out, lse, do,
                                                               k_segment_ids=kseg)
            ok, rows = bwd_gate(got, want, dname)
            errs = [r[1] for r in rows]
            print(f"bwd kernels {dname} {label} S={S} Sk={Sk} (atol_frac {atol_frac}, rtol "
                  f"{rtol}, nrel {nrel}): {_gate_line(rows)} {'ok' if ok else 'FAIL'}")
            check(ok, f"backward kernels disagree with the plain backward: {dname} {label}")
            res[f"dq_{dname}"]["max_abs_err"] = max(res[f"dq_{dname}"]["max_abs_err"], errs[0])
            res[f"dkv_{dname}"]["max_abs_err"] = max(res[f"dkv_{dname}"]["max_abs_err"],
                                                     errs[1], errs[2])
            del q, k, v, do, out, lse, got, want
            torch.cuda.empty_cache()

        # planted faults at the bench shape
        S, hq, hkv = 6144, 4, 2
        gen.manual_seed(1)
        q, k, v, do = inputs(S, S, hq, hkv, dtype)
        seg = torch.from_numpy(bench_seg).to(dev)
        out, lse = fa._fwd(q, k, v, seg)
        _planted_faults(q, k, v, seg, out, lse, do,
                        fa.flash_segment_attention_mh_bwd_reference(q, k, v, seg, out, lse, do),
                        dname, hq, hkv)
        # times at the bench shape (the numbers of the JSON line) and at the
        # base_vq serving layout with base heads 12/4
        for label, seg_np, hq, hkv in (("bench", bench_seg, 4, 2),
                                       ("base heads 12/4", BASE_SEG, 12, 4)):
            S = seg_np.shape[0]
            if label != "bench":
                q, k, v, do = inputs(S, S, hq, hkv, dtype)
                seg = torch.from_numpy(seg_np).to(dev)
                out, lse = fa._fwd(q, k, v, seg)
            delta = fa._delta(out, do)
            dq_fn, dkv_fn = fa._bwd_kernels()
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            stream = torch.cuda.current_stream().cuda_stream
            common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), seg.data_ptr(),
                      do.data_ptr(), lse.data_ptr(), delta.data_ptr())
            tail = (S, S, hq, hkv, float(D ** -0.5), int(dname == "bf16"), stream)
            dq_ms = cuda_ms(lambda: dq_fn(*common, dq.data_ptr(), *tail), reps=100)
            dkv_ms = cuda_ms(lambda: dkv_fn(*common, dk.data_ptr(), dv.data_ptr(), *tail), reps=100)
            both_ms = cuda_ms(lambda: fa._bwd(q, k, v, seg, out, lse, do), reps=100)
            plain_ms = cuda_ms(lambda: fa.flash_segment_attention_mh_bwd_reference(
                q, k, v, seg, out, lse, do), reps=10, warmup=2)
            # yardstick only, never called by the port: the backward of one SDPA
            # call with the block-diagonal boolean mask, on a retained graph
            qb = q.permute(1, 0, 2)[None].detach().requires_grad_()
            kb = k.repeat_interleave(hq // hkv, dim=1).permute(1, 0, 2)[None].detach().requires_grad_()
            vb = v.repeat_interleave(hq // hkv, dim=1).permute(1, 0, 2)[None].detach().requires_grad_()
            rs = fa._remap_pad(seg)
            mask = (rs[:, None] == rs[None, :])[None, None]
            ob = F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask)
            dob = do.permute(1, 0, 2)[None]
            library_ms = cuda_ms(lambda: torch.autograd.grad(ob, (qb, kb, vb), dob,
                                                             retain_graph=True), reps=20)
            # 10 = the five products of the backward (S, dP, dV, dQ, dK) done once;
            # each kernel alone: dq 3 products (S, dP, dQ), dk/dv 4 (S, dP, dV, dK)
            tot_bound, tot_by, flops, nbytes = bwd_bound_ms(seg_np, S, S, hq, hkv, D, dname,
                                                            5, ("dq", "dkv"))
            print(f"timing bwd {dname} {label} S={S} [{card}]: dq kernel {dq_ms:.4f} ms, dk/dv kernel "
                  f"{dkv_ms:.4f} ms, sum {dq_ms + dkv_ms:.4f} ms, both through the wrapper (with "
                  f"delta) {both_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library (SDPA backward, bool mask) {library_ms:.4f} ms, "
                  f"bound {tot_bound * 1e3:.2f} us ({tot_by}; {flops / 1e9:.3f} GFLOP, "
                  f"{nbytes / 1e6:.2f} MB), share of bound {tot_bound / (dq_ms + dkv_ms):.4f}")
            for kname, ms, products, outs in (("dq", dq_ms, 3, ("dq",)), ("dkv", dkv_ms, 4, ("dkv",))):
                bound, by, _, _ = bwd_bound_ms(seg_np, S, S, hq, hkv, D, dname, products, outs)
                timing = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound, bound_by=by)
                if label == "bench":
                    res[f"{kname}_{dname}"].update(timing)
                else:
                    res[f"{kname}_{dname}"]["at_base_12_4"] = timing
            del dq, dk, dv, qb, kb, vb, ob, mask
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return res


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
    from titok_tpu_torch.ops.flash_attention_mh import launches

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
    reset_counts()
    main = _serve(model, a, a_tc, b, b_tc, d, launches, "bf16")
    torch.cuda.synchronize()
    paths = {"serving_bf16": read_counts()}
    main_launches = launches["bf16"]
    print(f"serving bf16 (kernel): launches encode/forward/decode/encode-u8 = "
          f"{main['launches']}, total {main_launches}; indices in [0, "
          f"{model.module.codebook_size}); outputs finite")
    check(main_launches > 0, "the serving path launched no kernel")

    # f32 kernel path vs f32 plain path, same weights
    k32 = build(**{"training.main.precision": "32"})
    reset_counts()
    out_k32 = _serve(k32, a, a_tc, b, b_tc, d, launches, "f32")
    paths["serving_f32"] = read_counts()
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
    return paths


def _breakdown(model, a, a_tc) -> None:
    """Where one encode (a) request spends its time: host packing (host
    clock) and device time by kernel (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for group in model._groups(a, a_tc):
        model._pack([a[i] for i in group], [a_tc[i] for i in group])
    pack_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.encode(a, a_tc)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print_breakdown(prof, f"one encode (a) request (profiled, wall {wall_ms:.3f} ms): host "
                    f"packing {pack_ms:.3f} ms (unprofiled);", wall_ms, 8)


def print_breakdown(prof, title: str, wall_ms: float, top: int) -> None:
    """Device busy time and the top device events of a profile. Only the
    device's own events count (kernels, copies): a CPU op's self device
    time is the time of the kernels it launched, which are rows of their
    own, and a ``record_function`` range (``Optimizer.step``) is mirrored on
    the device timeline over its kernels; summing those too counts the
    same time twice."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    cpu_keys = {e.key for e in events if e.device_type == DeviceType.CPU}
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in events
                   if e.device_type == DeviceType.CUDA and e.key not in cpu_keys
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy == 0:
        print(f"breakdown of {title} the profiler recorded no device time (not measured)")
        return
    print(f"breakdown of {title} device busy {busy:.3f} ms ({busy / wall_ms * 100:.1f} % of "
          f"wall); top device events, then the port's own kernels below them:")
    own = ("fwd_bf16_pipe", "fwd_f32_pipe", "bwd_dq_", "bwd_dkv_", "vq_nearest_kernel",
           "v1_fwd_", "v1_bwd_")
    for i, (key, dev_ms, count) in enumerate(rows):
        if i < top or any(k in key for k in own):
            print(f"    {dev_ms:8.4f} ms  x{count:<4d} {key[:90]}")


def train_config(**over):
    """configs/tiny.yaml as the training phase runs it: as shipped, its
    loss too (L1, LPIPS over 25 random 128² crops, GAN), with one override:
    ``allow_random_lpips``, since no converted VGG weights are in the repo."""
    from titok_tpu_torch.config import load_config

    over = {"tokenizer.losses.allow_random_lpips": "true", **over}
    return load_config(os.path.join(REPO, "configs", "tiny.yaml"),
                       [f"{k}={v}" for k, v in over.items()])


def _trainer(cfg, f32_disc=False, batch=None, card_seed=None):
    """Builder, state and step for ``cfg``. ``f32_disc``: the discriminator
    rebuilt to compute in f32 (the package builds it in bf16, as the JAX
    package does), so that an f32 run is f32 throughout. ``batch``: the
    first batch on the card, from which EMA-VQ draws its codebook.
    ``card_seed``: build the modules on the card and draw their weights
    there (:func:`card_params`, the reference init's std) instead of the
    package's numpy init, which takes tens of seconds at large width."""
    import contextlib

    import torch

    from titok_tpu_torch.losses.loss_module import LossSystem
    from titok_tpu_torch.models.blocks import PackedEncoder
    from titok_tpu_torch.models.titok import make_titok
    from titok_tpu_torch.training.train_step import TrainStepBuilder

    with torch.device("cuda") if card_seed is not None else contextlib.nullcontext():
        ls = LossSystem(cfg)
        if f32_disc:
            ls.disc_model = PackedEncoder(
                model_size=cfg.discriminator.model.model_size, patch_size=ls.patch_size,
                in_channels=3, out_channels=1, dtype=torch.float32,
                attn_impl=str(cfg.training.main.get("attn_impl", "auto")),
                remat=bool(cfg.training.main.get("remat", False)))
        builder = TrainStepBuilder(make_titok(cfg), ls, cfg)
    params = {}
    if card_seed is not None:
        params = {"gen_params": card_params(builder.model, card_seed),
                  "disc_params": card_params(ls.disc_model, card_seed + 1)}
    state = builder.init_state(device="cuda", batch=batch, **params)
    return builder, state, builder.make_train_step()


def card_params(module, seed: int, dense_std: float = 0.02) -> dict:
    """Seeded weights for every parameter of ``module``, drawn on the card
    from an explicit generator, as the reference inits them (dense kernels
    N(0, ``dense_std``), biases 0, norms 1, mask token N(0, width^-1/2))."""
    import torch

    from titok_tpu_torch.models.blocks import _PackedViT
    from titok_tpu_torch.models.transformer import Dense
    from titok_tpu_torch.ops.rmsnorm import RMSNorm

    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, mod in module.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, Dense):
            out[pre + "weight"] = torch.randn(mod.weight.shape, generator=g,
                                              device="cuda") * dense_std
            if mod.bias is not None:
                out[pre + "bias"] = torch.zeros(mod.bias.shape, device="cuda")
        elif isinstance(mod, RMSNorm):
            out[pre + "weight"] = torch.ones(mod.weight.shape, device="cuda")
        elif isinstance(mod, _PackedViT):
            out[pre + "mask_token"] = torch.randn((1, 1), generator=g,
                                                  device="cuda") * mod.width ** -0.5
    return out


def _host_batches(cfg, n, seed=0):
    """n packed batches, their disc layouts and perceptual plans (None with
    the perceptual loss off; drawn from ``default_rng(seed + 1)``, as the
    trainer draws them): ``(batch, disc, plan)`` triples, host work before
    timing, and the host ms a batch."""
    import itertools

    from titok_tpu_torch.data.packing import build_disc_batch
    from titok_tpu_torch.losses.loss_module import DISC_TOKENS, num_perceptual_frames
    from titok_tpu_torch.ops.frames import build_perceptual_plan
    from titok_tpu_torch.training.trainer import synthetic_batches

    lc = cfg.tokenizer.losses
    perc = float(lc.perceptual_weight) > 0 or float(lc.gram_weight) > 0
    kw = dict(num_frames=num_perceptual_frames(cfg), sample_size=int(lc.perceptual_sampling_size),
              patch_size=list(cfg.tokenizer.model.patch_size),
              max_grid_hw=list(cfg.training.sampling.max_grid)[1:],
              rng=np.random.default_rng(seed + 1))
    t0 = time.perf_counter()
    out = [(b, build_disc_batch(b, DISC_TOKENS), build_perceptual_plan(b, **kw) if perc else None)
           for b in itertools.islice(synthetic_batches(cfg, seed=seed), n)]
    return out, (time.perf_counter() - t0) * 1e3 / n


def _on_card(triple):
    """A ``(batch, disc, plan)`` triple of :func:`_host_batches` as device
    dicts (the plan None where it is)."""
    from titok_tpu_torch.data.packing import to_device

    return tuple(None if x is None else to_device(x, "cuda") for x in triple)


# LPIPS on the card against the CPU: per-frame LPIPS and Gram within
# LPIPS_RTOL relative, crop_resize within CROP_ATOL. Both sides compute in
# fp32 (TF32 off, phase_build), in another order of sums (cuDNN's and
# oneDNN's convolutions, cuBLAS's and MKL's matmuls)
LPIPS_RTOL = 1e-4
CROP_ATOL = 1e-5


def phase_lpips(card: str) -> None:
    """The perceptual loss's modules on the card against the same modules
    and weights on the CPU, at the tiny training path's shape: the first
    batch's 25 frames (``crop_resize`` of its plan from the padded 168²
    frames to 128²), and LPIPS and Gram of them against a perturbed copy;
    then the time of the tower's forward, and of its forward and backward
    (the gradient with respect to the reconstructed frames), CUDA events;
    that gradient against the CPU's, and whether it gives the same bits
    twice."""
    import warnings

    import torch

    from titok_tpu_torch.data.packing import to_device
    from titok_tpu_torch.losses.lpips import LPIPS, lpips_params_for
    from titok_tpu_torch.ops.frames import crop_resize, gather_frames
    from titok_tpu_torch.ops.patchify import decode_rows

    cfg = train_config()
    s = int(cfg.tokenizer.losses.perceptual_sampling_size)
    patch = list(cfg.tokenizer.model.patch_size)
    [(b, _, plan)], _ = _host_batches(cfg, 1)
    K = plan.weight.shape[0]
    p_cpu, p_gpu = to_device(plan, "cpu"), to_device(plan, "cuda")
    frames = gather_frames(torch.from_numpy(decode_rows(b.patches, np.float32)), p_cpu, patch)
    tgt = crop_resize(frames, p_cpu, s)
    tgt_g = crop_resize(frames.cuda(), p_gpu, s)
    crop_err = (tgt_g.cpu() - tgt).abs().max().item()
    g = torch.Generator().manual_seed(5)
    rec = torch.clamp(tgt + 0.2 * torch.randn(tgt.shape, generator=g), -1, 1)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the random-VGG warning
        sd = {k: torch.from_numpy(v) for k, v in lpips_params_for(cfg).items()}
    m_cpu, m_gpu = LPIPS(), LPIPS().cuda()
    m_cpu.load_state_dict(sd)
    m_gpu.load_state_dict(sd)
    m_cpu.requires_grad_(False)
    m_gpu.requires_grad_(False)
    t0 = time.perf_counter()
    with torch.no_grad():
        lp, gr = m_cpu(rec, tgt)
    cpu_s = time.perf_counter() - t0
    rec_g = rec.cuda()
    with torch.no_grad():
        lp_g, gr_g = m_gpu(rec_g, tgt_g)
    lp_err = ((lp_g.cpu() - lp).abs() / lp.abs()).max().item()
    gr_err = ((gr_g.cpu() - gr).abs() / gr.abs()).max().item()
    print(f"perceptual loss, tiny path's first plan ({K} frames, padded {frames.shape[1]}x"
          f"{frames.shape[2]} -> {s}x{s}, scales {sorted(set(np.round(plan.scale[:, 0], 4)))}), "
          f"card vs CPU (CPU forward {cpu_s:.1f} s): crop_resize max|diff| {crop_err:.3e} (gate "
          f"{CROP_ATOL:g}); LPIPS max rel diff {lp_err:.3e} (values {lp.min().item():.4f}-"
          f"{lp.max().item():.4f}), Gram {gr_err:.3e} (values {gr.min().item():.4e}-"
          f"{gr.max().item():.4e}) (gate {LPIPS_RTOL:g} relative)")
    check(crop_err <= CROP_ATOL, "crop_resize on the card disagrees with the CPU")
    check(lp_err <= LPIPS_RTOL and gr_err <= LPIPS_RTOL, "LPIPS on the card disagrees with the CPU")
    check(bool((lp > 0).all()) and bool(torch.isfinite(lp_g).all()), "LPIPS not positive")

    def fwd():
        with torch.no_grad():
            m_gpu(rec_g, tgt_g)

    x = rec_g.clone().requires_grad_()

    def fwd_bwd():
        lp, gr = m_gpu(x, tgt_g)
        return torch.autograd.grad(lp.sum() + gr.sum(), x)[0]

    # the gradient to the frames against the CPU's, by its norm: LPIPS's
    # backward through ReLU and max pool is discontinuous (ties of a clamped
    # patch's equal features break each library's own way), so entries may
    # move where a unit routes its gradient otherwise; a wrong backward is
    # off by the order of the gradient itself
    xc = rec.clone().requires_grad_()
    lp_c, gr_c = m_cpu(xc, tgt)
    g_cpu = torch.autograd.grad(lp_c.sum() + gr_c.sum(), xc)[0]
    g_card = fwd_bwd().cpu()
    g_norm = ((g_card - g_cpu).norm() / g_cpu.norm()).item()
    g_max = ((g_card - g_cpu).abs().max() / g_cpu.abs().max()).item()
    print(f"LPIPS gradient to the frames, card vs CPU: |diff| {g_norm:.3e} of |g| (gate 1e-2), "
          f"max|diff| {g_max:.3e} of max|g|")
    check(g_norm <= 1e-2, "the LPIPS gradient on the card disagrees with the CPU's")
    # not gated: whether cuDNN's backward gives the same bits twice (the
    # large f32 remat gate, bit for bit, runs with LPIPS off)
    same = torch.equal(fwd_bwd(), fwd_bwd())
    print(f"LPIPS tower, {K} + {K} frames at {s}x{s}, fp32 (TF32 off) [{card}]: forward "
          f"{cuda_ms(fwd, 10):.3f} ms, forward + backward to the frames "
          f"{cuda_ms(fwd_bwd, 10):.3f} ms (CUDA events, mean of 10 after 3); the backward "
          f"twice on the same inputs gives the same bits: {same}")

    # the module pins its convolutions to fp32: the same forward and backward
    # with the process's cuDNN TF32 flag on (PyTorch's default) against it
    # off (phase_build); and, printed only, what the tower gives with its
    # convolutions unpinned under that flag
    import titok_tpu_torch.losses.lpips as lpips_mod

    pinned = lpips_mod._Conv32

    class Unpinned:
        apply = staticmethod(lambda x, w, b, p: torch.nn.functional.conv2d(x, w, b, padding=p))

    g_off = fwd_bwd()
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            lp_on, gr_on = m_gpu(rec_g, tgt_g)
        g_on = fwd_bwd()
        lpips_mod._Conv32 = Unpinned
        with torch.no_grad():
            lp_un, _ = m_gpu(rec_g, tgt_g)
        g_un = fwd_bwd()
    finally:
        lpips_mod._Conv32 = pinned
        torch.backends.cudnn.allow_tf32 = False

    def rel(a, b):
        return ((a - b).abs() / b.abs()).max().item()

    pin_fwd = max(rel(lp_on, lp_g), rel(gr_on, gr_g))
    pin_g = ((g_on - g_off).norm() / g_off.norm()).item()
    un_g = ((g_un - g_off).norm() / g_off.norm()).item()
    print(f"LPIPS with cuDNN's TF32 flag on vs off: LPIPS and Gram max rel diff {pin_fwd:.3e} "
          f"(gate 1e-6), gradient to the frames |diff| {pin_g:.3e} of |g| (gate 1e-5); the "
          f"convolutions unpinned under the flag: LPIPS {rel(lp_un, lp_g):.3e}, gradient "
          f"{un_g:.3e} (not gated)")
    check(pin_fwd <= 1e-6 and pin_g <= 1e-5, "LPIPS follows the process's TF32 flag")
    del m_gpu, rec_g, tgt_g, x
    torch.cuda.empty_cache()


def phase_training(card: str) -> dict:
    """The tiny GAN train step at full width through the kernels, with the
    shipped loss (LPIPS on)."""
    import torch

    from titok_tpu_torch.ops.flash_attention_mh import launches

    dev = torch.device("cuda")
    cfg = train_config()
    cb = 4375
    builder, state, step = _trainer(cfg)
    ls = builder.loss_system
    check(ls.use_perceptual and ls.num_frames == 25 and ls.sample_size == 128,
          f"tiny's loss: perceptual {ls.use_perceptual}, K {ls.num_frames}, {ls.sample_size}")
    batches, pack_ms = _host_batches(cfg, 6)
    seq_len = int(cfg.training.sampling.train_seq_len)
    print(f"training: tiny GAN, width 256, enc/dec 4+4 layers, disc {cfg.discriminator.model.model_size}"
          f", train_seq_len {seq_len}, {cfg.training.main.precision}, loss L1 + LPIPS "
          f"({ls.perceptual_weight:g} x, {ls.num_frames} frames at {ls.sample_size}², random VGG) + "
          f"Gram ({ls.gram_weight:g} x) + GAN ({ls.disc_weight:g} x), samples per batch "
          f"{[int(b.sample_valid.sum()) for b, _, _ in batches]}, host packing and plans "
          f"{pack_ms:.1f} ms/batch")
    gen0 = [p.detach().clone() for p in state.model.parameters()]
    disc0 = [p.detach().clone() for p in state.disc_model.parameters()]
    lpips0 = {k: v.clone() for k, v in ls.lpips.state_dict().items()}

    reset_counts()  # the main path: the 6 steps below, read right after them
    per_step, metrics_all, times = [], [], []
    for i, (b, d, p) in enumerate(batches):
        before = dict(launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics, idx = step(state, *_on_card((b, d, p)))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: launches[k] - before[k] for k in launches})
        metrics_all.append(metrics)
        tok = torch.from_numpy(b.token_mask).to(dev)
        check(bool(((idx[tok] >= 0) & (idx[tok] < cb)).all()), f"step {i}: index out of range")
    paths = {"train_bf16": read_counts()}
    n = TRAIN_LAUNCHES["tiny"]
    want = {**{k: 0 for k in launches}, "bf16": n, "bwd_dq_bf16": n, "bwd_dkv_bf16": n}
    for i, got in enumerate(per_step):
        check(got == want, f"step {i}: launches {got}, want {want}")
    print(f"training launches per step (every one of 6): {per_step[0]} -- per attention layer "
          f"one forward and one of each backward kernel: generator pass encoder 4 + decoder 4 + "
          f"stacked disc 4, discriminator pass 4")
    for i, m in enumerate(metrics_all):
        vals = {k: float(v) for k, v in m.items()}
        check(all(np.isfinite(v) for v in vals.values()), f"step {i}: non-finite metric {vals}")
        check(vals["nonfinite_grad/generator"] == 0 and vals["nonfinite_grad/discriminator"] == 0,
              f"step {i}: a non-finite grad was zeroed")
        check(vals.get("gen/perceptual_loss", 0) > 0, f"step {i}: no positive perceptual loss")
        print(f"  step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in vals.items()))
    moved_g = max((p.detach() - p0).abs().max().item()
                  for p, p0 in zip(state.model.parameters(), gen0))
    moved_d = max((p.detach() - p0).abs().max().item()
                  for p, p0 in zip(state.disc_model.parameters(), disc0))
    lpips_same = all(torch.equal(v, lpips0[k]) for k, v in ls.lpips.state_dict().items())
    print(f"params moved: generator max|dp| {moved_g:.3e}, discriminator {moved_d:.3e}; LPIPS "
          f"weights unchanged: {lpips_same}, none requires grad: "
          f"{not any(p.requires_grad for p in ls.lpips.parameters())}")
    check(moved_g > 0 and moved_d > 0, "the params did not move")
    check(lpips_same and not any(p.requires_grad for p in ls.lpips.parameters()),
          "the LPIPS weights changed or take gradients")
    timed = times[2:]
    print(f"train step, tiny GAN + LPIPS bf16 S={seq_len} [{card}]: {np.mean(timed):.3f} ms/step "
          f"(host clock, mean of 4 after 2 warm-up; steps {', '.join(f'{t:.2f}' for t in times)} "
          f"ms), {seq_len / np.mean(timed) * 1e3:.0f} tokens/s")

    # the perceptual terms reach the generator: its grads on one batch with
    # the plan against the same loss without it
    bt, dt_, pt = _on_card(batches[0])
    params = list(state.model.parameters())
    recon, _ = state.model(bt)
    g_on = torch.autograd.grad(ls.generator_loss(recon, bt, dt_, pt)[0], params,
                               retain_graph=True)
    g_off = torch.autograd.grad(ls.generator_loss(recon, bt, dt_, None)[0], params)
    n_off = torch.sqrt(sum((g.double() ** 2).sum() for g in g_off)).item()
    n_diff = torch.sqrt(sum(((a - b).double() ** 2).sum() for a, b in zip(g_on, g_off))).item()
    print(f"generator grads with LPIPS vs without, same batch and weights: |g_on - g_off| "
          f"{n_diff:.4e} of |g_off| {n_off:.4e} (global norms; gate > 1e-3 x |g_off|)")
    check(np.isfinite(n_diff) and n_diff > 1e-3 * n_off, "LPIPS does not reach the generator")
    del recon, g_on, g_off

    # step time with LPIPS on and off in turn, the same batches
    on_off = {True: [], False: []}
    for b, d, p in batches[2:]:
        for use in (True, False):
            bt, dt_, pt = _on_card((b, d, p))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _, _ = step(state, bt, dt_, pt if use else None)
            torch.cuda.synchronize()
            on_off[use].append((time.perf_counter() - t0) * 1e3)
    on, off = float(np.mean(on_off[True])), float(np.mean(on_off[False]))
    print(f"train step tiny GAN bf16 S={seq_len} [{card}], LPIPS on vs off in turn on the same 4 "
          f"batches: on {on:.3f} ms, off {off:.3f} ms (host clock, means of 4; on "
          f"{', '.join(f'{t:.2f}' for t in on_off[True])}; off "
          f"{', '.join(f'{t:.2f}' for t in on_off[False])}); LPIPS adds {on - off:.3f} ms")
    _train_breakdown(step, state, batches[0])

    # f32 kernel path vs f32 plain path (dense attention), same weights,
    # batches, plans and noise; the discriminator in f32 too; LPIPS on in
    # both (the same convolutions)
    # warm-up 2 steps, so that steps 2-3 run at lr 5e-5 and 1e-4 and their
    # losses hold the first steps' updates to account
    f32_over = {"training.main.precision": "32", "training.sampling.train_seq_len": 2048,
                "optimizer.warmup_steps": 2}
    cfg32 = train_config(**f32_over)
    batches32, _ = _host_batches(cfg32, 3, seed=1)
    noise_gen = torch.Generator(device=dev).manual_seed(3)
    noises = [torch.randn(d.segment_ids.shape[0], b.patches.shape[1], generator=noise_gen,
                          device=dev) for b, d, _ in batches32]
    runs = {}
    for name, over in (("kernel", {}), ("plain", {"training.main.attn_impl": "reference"})):
        c = train_config(**f32_over, **over)
        builder, st, stp = _trainer(c, f32_disc=True)
        reset_counts()
        bt, dt_, pt = _on_card(batches32[0])
        recon, _ = st.model(bt)
        params = list(st.model.parameters())
        ls32 = builder.loss_system
        # the first step's grads of the loss without LPIPS and with it
        grads = torch.autograd.grad(ls32.generator_loss(recon, bt, dt_)[0], params,
                                    retain_graph=True)
        grads_lpips = torch.autograd.grad(ls32.generator_loss(recon, bt, dt_, pt)[0], params)
        losses = []
        for triple, noise in zip(batches32, noises):
            st, m, _ = stp(st, *_on_card(triple), noise=noise)
            losses.append({k: float(v) for k, v in m.items() if "loss" in k or "penalty" in k})
        torch.cuda.synchronize()
        runs[name] = (grads, grads_lpips, losses, read_counts())
        del builder, st, stp, recon, ls32
        torch.cuda.empty_cache()
    k_grads, k_grads_lpips, k_losses, k_launch = runs["kernel"]
    p_grads, p_grads_lpips, p_losses, p_launch = runs["plain"]
    check(all(v == 0 for v in p_launch.values()), f"the plain path launched kernels: {p_launch}")
    check(k_launch["f32"] > 0 and k_launch["bwd_dq_f32"] > 0 and k_launch["bwd_dkv_f32"] > 0,
          f"the f32 kernel path launched no kernel: {k_launch}")
    gmax = max(g.abs().max().item() for g in p_grads)
    gerr = max((a - b).abs().max().item() for a, b in zip(k_grads, p_grads))
    # with LPIPS, by the ratio of global norms, as phase_lpips gates the
    # gradient to the frames: LPIPS's backward through its ReLUs and max
    # pools is a discontinuous function of the frames, so frames that differ
    # in their last bits (kernel vs plain) route a few units' gradients
    # otherwise, which moves single entries by more than the attention
    # kernels do; a wrong backward is off by the order of the gradient
    lp_gmax = max(g.abs().max().item() for g in p_grads_lpips)
    lp_gerr = max((a - b).abs().max().item() for a, b in zip(k_grads_lpips, p_grads_lpips))
    lp_ratio = (torch.sqrt(sum(((a - b).double() ** 2).sum()
                               for a, b in zip(k_grads_lpips, p_grads_lpips)))
                / torch.sqrt(sum((g.double() ** 2).sum() for g in p_grads_lpips))).item()
    pairs = [(k_losses[i][key], p_losses[i][key]) for i in range(3) for key in p_losses[i]]
    labs = max(abs(a - b) for a, b in pairs)
    lrel = max(abs(a - b) / abs(b) for a, b in pairs if b != 0)
    lok = all(abs(a - b) <= 1e-6 + 1e-4 * abs(b) for a, b in pairs)
    print(f"f32 train path S=2048 (LPIPS on), kernel vs plain (dense attention), 3 steps: losses "
          f"max|diff| {labs:.3e}, max rel diff {lrel:.3e} over {len(pairs)} values (gate atol "
          f"1e-6 + rtol 1e-4); first step's generator grads of the loss without LPIPS max|diff| "
          f"{gerr:.3e} of max|g| {gmax:.3e} (gate 1e-4 x max|g|), with LPIPS max|diff| "
          f"{lp_gerr:.3e} of max|g| {lp_gmax:.3e}, |g_k - g_p| / |g_p| {lp_ratio:.3e} (gate "
          f"1e-2); kernel-path launches {k_launch}")
    for i in range(3):
        print(f"  step {i}: kernel {k_losses[i]}")
        print(f"          plain  {p_losses[i]}")
    check(lok, "f32 kernel path losses disagree with the plain path")
    check(gerr <= 1e-4 * gmax, "f32 kernel path grads disagree with the plain path")
    check(lp_ratio <= 1e-2, "f32 kernel path grads with LPIPS disagree with the plain path")
    paths["train_f32"] = k_launch
    return paths


def _base_vq_clips(rng):
    """Request (a): 8- and 16-frame clips at 256x256 and 256x192 with token
    counts 1..128 (two packed groups at ``eval_seq_len`` 4096; the first
    is ``BASE_SEG``)."""
    dims = [(8, 256, 256), (16, 256, 256), (8, 256, 192), (16, 256, 192), (8, 256, 256),
            (16, 256, 256)]
    clips = [rng.uniform(-1, 1, (3, *d)).astype(np.float32) for d in dims]
    return clips, [1, 16, 32, 64, 96, 128]


def phase_serving_vq(card: str) -> dict:
    """base_vq served at full width through the VQ and attention kernels."""
    import torch

    from titok_tpu_torch.config import load_config
    from titok_tpu_torch.models.titok import TiTokModel, init_params, make_titok
    from titok_tpu_torch.ops import flash_attention_mh as fa
    from titok_tpu_torch.ops import vq_distance as vd

    path = os.path.join(REPO, "configs", "base_vq.yaml")
    cfg = load_config(path)
    seq_len = int(cfg.training.sampling.eval_seq_len)
    min_grid = cfg.training.sampling.min_grid
    # seeded numpy weights with dense kernels at 4x the reference init (as
    # the tiny serving phase: at 1x a random model's latent tokens all sit
    # near one point) and the seeded random normal codebook TiTokModel draws
    params = init_params(make_titok(cfg), seed=0)
    for name, w in params.items():
        if w.ndim == 2 and not name.endswith("mask_token"):
            params[name] = w * np.float32(4.0)

    def build(**over):
        c = load_config(path, [f"{k}={v}" for k, v in over.items()])
        return TiTokModel(make_titok(c), params=params, seq_len=seq_len, min_grid=min_grid,
                          device="cuda", seed=0)

    clips, tcs = _base_vq_clips(np.random.default_rng(0))
    grids = [c.shape[1:] for c in clips]
    model = build()
    n_groups = len(model._groups(clips, tcs))
    cb = model.module.codebook_size

    def serve(m):
        counts = []
        before = read_counts()
        idx = m.encode(clips, tcs)
        counts.append({k: v - before[k] for k, v in read_counts().items()})
        before = read_counts()
        rec, aux = m.forward(clips, tcs)
        counts.append({k: v - before[k] for k, v in read_counts().items()})
        before = read_counts()
        dec = m.decode_indices(idx, grids)
        counts.append({k: v - before[k] for k, v in read_counts().items()})
        return idx, rec, aux["indices"], dec, counts

    # the main path: bf16 (bf16-mixed), through the kernels
    reset_counts()
    idx, rec, fidx, dec, counts = serve(model)
    torch.cuda.synchronize()
    paths = {"serving_base_vq": read_counts()}
    dt = "bf16"
    want = [{"vq_f32": n_groups, dt: 12 * n_groups}, {"vq_f32": n_groups, dt: 24 * n_groups},
            {"vq_f32": 0, dt: 12 * n_groups}]
    for name, got, w in zip(("encode", "forward", "decode_indices"), counts, want):
        check(all(got[k] == v for k, v in w.items()),
              f"base_vq {name}: launches {got}, want {w} ({n_groups} groups)")
    for i, tc in enumerate(tcs):
        check(idx[i].shape == (tc,), f"encode clip {i}: {idx[i].shape}")
        check(np.array_equal(idx[i], fidx[i]), f"encode and forward disagree on clip {i}")
    flat = np.concatenate(idx)
    check(bool(((flat >= 0) & (flat < cb)).all()), f"index out of [0, {cb})")
    for c, r, d in zip(clips, rec, dec):
        check(r.shape == c.shape and np.isfinite(r).all(), "forward recon")
        check(d.shape == c.shape and np.isfinite(d).all(), "decode_indices recon")
    dec_diff = max(float(np.abs(r - d).max()) for r, d in zip(rec, dec))
    print(f"serving base_vq bf16 (kernels), {len(clips)} clips in {n_groups} groups: launches "
          f"per call encode/forward/decode {[(c['vq_f32'], c[dt]) for c in counts]} (vq, "
          f"attention fwd); {len(np.unique(flat))} distinct of {flat.size} indices in [0, {cb}); "
          f"decode_indices vs forward recon max|diff| {dec_diff:.3e}")
    check(dec_diff <= 1e-5, "decode_indices does not reproduce forward's reconstruction")
    check(len(np.unique(flat)) > 1, "every token landed on one code: nothing to compare")

    # f32: kernel path vs plain path (dense attention, plain VQ search)
    k32 = build(**{"training.main.precision": "32"})
    reset_counts()
    i32, r32, _, _, _ = serve(k32)
    paths["serving_base_vq_f32"] = read_counts()
    del k32
    p32 = build(**{"training.main.precision": "32", "training.main.attn_impl": "reference"})
    p32.module.quantize.impl = "reference"
    reset_counts()
    ip, rp, _, _, _ = serve(p32)
    check(all(v == 0 for v in read_counts().values()), "the plain path launched a kernel")
    del p32
    torch.cuda.empty_cache()
    same = float((np.concatenate(i32) == np.concatenate(ip)).mean())
    rdiff = max(float(np.abs(a - b).max()) for a, b in zip(r32, rp))
    print(f"base_vq f32 kernel path vs plain path: indices identical {same * 100:.3f} %, "
          f"recon max|diff| {rdiff:.3e}")
    check(same >= 0.999, "the f32 kernel path disagrees with the plain path on the indices")

    # request time of (a) on the main path
    for _ in range(2):
        model.encode(clips, tcs)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        model.encode(clips, tcs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"encode (a) base_vq, {len(clips)} clips, bf16 [{card}]: {ms:.3f} ms/request, "
          f"{len(clips) / ms * 1e3:.1f} clips/s (host clock, {reps} requests)")
    _breakdown(model, clips, tcs)
    del model
    torch.cuda.empty_cache()
    return paths


def phase_training_vq(card: str) -> dict:
    """The base_vq GAN train step at full width through the kernels."""
    import torch

    from titok_tpu_torch.data.packing import to_device
    from titok_tpu_torch.config import load_config

    dev = torch.device("cuda")
    # LPIPS off: this phase holds the VQ kernel and the base-width step (the
    # tiny path trains the full loss); the config's own 1000-step warm-up: lr
    # rises from 0 by 1e-7 a step (a 2-step warm-up jumps to 1e-4 at once,
    # and a random model's latents, all near one point, then leave the
    # codebook drawn from them for one edge code)
    cfg = load_config(os.path.join(REPO, "configs", "base_vq.yaml"), [
        "tokenizer.losses.perceptual_weight=0", "tokenizer.losses.gram_weight=0"])
    batches, pack_ms = _host_batches(cfg, 5)
    seq_len = int(cfg.training.sampling.train_seq_len)
    builder, state, step = _trainer(cfg, batch=to_device(batches[0][0], dev))
    vq = state.model.quantize
    cb0 = vq.codebook.clone()
    print(f"training: base_vq GAN, width 768, enc/dec 12+12 layers, heads 12/4, disc "
          f"{cfg.discriminator.model.model_size}, codebook {vq.codebook_size} x {vq.codebook_dim}, "
          f"train_seq_len {seq_len}, {cfg.training.main.precision}, samples per batch "
          f"{[int(b.sample_valid.sum()) for b, _, _ in batches]}, host packing {pack_ms:.1f} "
          f"ms/batch")
    n = TRAIN_LAUNCHES["base"]
    want = {**{k: 0 for k in read_counts()}, "bf16": n, "bwd_dq_bf16": n, "bwd_dkv_bf16": n,
            "vq_f32": 1}
    reset_counts()  # the main path: the 5 steps below, read right after them
    per_step, metrics_all, times = [], [], []
    for i, (b, d, p) in enumerate(batches):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics, idx = step(state, *_on_card((b, d, p)))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: v - before[k] for k, v in read_counts().items()})
        metrics_all.append(metrics)
        tok = torch.from_numpy(b.token_mask).to(dev)
        check(bool(((idx[tok] >= 0) & (idx[tok] < vq.codebook_size)).all()),
              f"step {i}: index out of range")
    paths = {"train_base_vq": read_counts()}
    for i, got in enumerate(per_step):
        check(got == want, f"base_vq step {i}: launches {got}, want {want}")
    print(f"base_vq training launches per step (every one of {len(batches)}): {per_step[0]} -- "
          f"the VQ kernel once (the generator's forward); per attention layer one forward and one "
          f"of each backward kernel: generator pass encoder 12 + decoder 12 + stacked disc 12, "
          f"discriminator pass 12 = {n}")
    for i, m in enumerate(metrics_all):
        vals = {k: float(v) for k, v in m.items()}
        check(all(np.isfinite(v) for v in vals.values()), f"step {i}: non-finite metric {vals}")
        check(vals["nonfinite_grad/generator"] == 0 and vals["nonfinite_grad/discriminator"] == 0,
              f"step {i}: a non-finite grad was zeroed")
        check(vals["gen/vq_perplexity"] > 1.0, f"step {i}: perplexity {vals['gen/vq_perplexity']}")
        print(f"  step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in vals.items()))
    moved = (vq.codebook - cb0).abs().max().item()
    print(f"codebook moved: max|dc| {moved:.3e}")
    check(moved > 0, "the codebook did not move")
    timed = times[2:]
    print(f"train step, base_vq GAN bf16 S={seq_len} [{card}]: {np.mean(timed):.3f} ms/step "
          f"(host clock, mean of {len(timed)} after 2 warm-up; steps "
          f"{', '.join(f'{t:.2f}' for t in times)} ms), {seq_len / np.mean(timed) * 1e3:.0f} "
          f"tokens/s")
    _train_breakdown(step, state, batches[0])
    del builder, state, step
    torch.cuda.empty_cache()
    return paths


# the ops of the LPIPS tower in a train step's profile (nothing else of a
# step convolves or pools): forward convs (the 1x1 lins too), their
# backward to the inputs, the pools and their backward
LPIPS_OPS = ("aten::conv2d", "aten::convolution_backward", "aten::max_pool2d",
             "aten::max_pool2d_with_indices_backward")


def _train_breakdown(step, state, triple) -> None:
    """Device time by kernel over one train step (torch.profiler), and the
    device time of the LPIPS tower's ops where the step runs them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, *_on_card(triple))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print_breakdown(prof, f"one train step (profiled, wall {wall_ms:.3f} ms):", wall_ms, 12)
    if triple[2] is None:
        return
    by_op = {e.key: (e.device_time_total / 1e3, e.count) for e in prof.key_averages()
             if e.key in LPIPS_OPS}
    total = sum(ms for ms, _ in by_op.values())
    print(f"  LPIPS tower in that step: {total:.3f} ms of device time ("
          + ", ".join(f"{k} {by_op[k][0]:.3f} ms x{by_op[k][1]}" if k in by_op else
                      f"{k} not recorded" for k in LPIPS_OPS) + ")")


# ---------------------------------------------------------------------------
# RoPE fused into the attention kernels (attn_impl: flash_rope) and the
# large tokenizer (configs/large.yaml) that runs on them
# ---------------------------------------------------------------------------


def _large_serving_request():
    """The large serving request: base_vq request (a)'s clips (large has
    base_vq's patch size (4, 16, 16), so the same layout)."""
    return _base_vq_clips(np.random.default_rng(0))


def _large_serving_layout():
    """ids and the packer's RoPE tables (P = 30) of the large serving
    request's first group (``BASE_SEG``)."""
    from titok_tpu_torch.data.packing import GridOnly, max_samples_for, pack_samples

    clips, tcs = _large_serving_request()
    grids = [c.shape[1:] for c in clips[:5]]
    batch = pack_samples([GridOnly(g, 3) for g in grids], tcs[:5], seq_len=4096,
                         max_samples=max_samples_for(4096, (8, 256, 256), (4, 16, 16)),
                         patch_size=[4, 16, 16], head_dim=64)
    check(np.array_equal(batch.segment_ids, BASE_SEG), "the large serving layout moved")
    return batch.segment_ids, batch.rope_cos, batch.rope_sin


def _stacked_large_disc(cfg):
    """The discriminator's stacked buffer of the large training path's
    first batch: ids of 4 copies and the per-copy tables concatenated in
    the same order, as ``LossSystem.disc_logits_stacked`` lays them out."""
    import torch

    from titok_tpu_torch.data.packing import build_disc_batch
    from titok_tpu_torch.losses.loss_module import DISC_TOKENS, stacked_segment_ids
    from titok_tpu_torch.training.trainer import synthetic_batches

    batch = next(iter(synthetic_batches(cfg, seed=0)))
    disc = build_disc_batch(batch, DISC_TOKENS)
    B1 = disc.sample_valid.shape[0] + 1
    seg = stacked_segment_ids(torch.from_numpy(disc.segment_ids), 4, B1).numpy()
    return seg, np.tile(disc.rope_cos, (4, 1)), np.tile(disc.rope_sin, (4, 1))


def _rand_tables(S, P, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    ang = torch.rand(S, P, generator=g, device="cuda") * (2 * np.pi)
    return ang.cos(), ang.sin()


def rope_bound_ms(seg_np, kseg_np, hq, hkv, d, dtype, kind, P, own_k_tables):
    """Least time for one rope kernel on these inputs: the products
    (forward 2, dq 3, dk/dv 4 of S x Sk x D, live segments only) at the
    type's peak plus the rotations (6 fp32 FLOP a pair: q and k once each,
    and the inverse of dq or dk) at the fp32 peak; or the bytes (q, k, v,
    ids and the tables read once, the outputs written once; the backward
    also reads dO, lse and delta) over HBM; the larger one."""
    S, Sk = len(seg_np), len(kseg_np)
    e = 2 if dtype == "bf16" else 4
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    flops = 2.0 * products * d * hq * live_pairs(seg_np, kseg_np)
    rot_flops = 6.0 * P * (S * hq + Sk * hkv + {"fwd": 0, "dq": S * hq, "dkv": Sk * hkv}[kind])
    qb, kb = S * hq * d * e, Sk * hkv * d * e
    nbytes = qb + 2 * kb + (S + Sk) * 4 + S * P * 8 + (Sk * P * 8 if own_k_tables else 0)
    if kind == "fwd":
        nbytes += qb + S * hq * 4
    else:
        nbytes += qb + 2 * S * hq * 4 + (qb if kind == "dq" else 2 * kb)
    t_ops = (flops / PEAK_FLOPS[dtype] + rot_flops / PEAK_FLOPS["f32"]) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), \
        flops + rot_flops, nbytes


def rope_gate(got, want, dname):
    """A rope run ``(out, lse, (dq, dk, dv))`` against the plain versions
    ``(out, lse, grads)``: the forward under TOL, the grads under BWD_TOL
    (the limits of the unfused kernels). Returns (ok, line)."""
    import torch

    out, lse, grads = got
    r_out, r_lse, r_grads = want
    atol, rtol, lse_atol = TOL[dname]
    o32, r32 = out.float(), r_out.float()
    err_out = (o32 - r32).abs().max().item()
    err_lse = (lse - r_lse).abs().max().item()
    ok_f = bool(((o32 - r32).abs() <= atol + rtol * r32.abs()).all()) and \
        err_lse <= lse_atol and bool(torch.isfinite(o32).all())
    ok_b, rows = bwd_gate(grads, r_grads, dname)
    return ok_f and ok_b, (f"out max|d| {err_out:.3e}, lse {err_lse:.3e} "
                           f"{'ok' if ok_f else 'FAIL'}; {_gate_line(rows)} "
                           f"{'ok' if ok_b else 'FAIL'}")


def phase_rope_kernels(card: str, large_train_cfg) -> dict:
    """The three rope kernels against their plain versions, bf16 and f32,
    at the large shapes and beside them; the fused forward against the
    unfused path bit for bit; planted faults; times."""
    import torch
    import torch.nn.functional as F

    from titok_tpu_torch.models.rope import apply_rotary_emb
    from titok_tpu_torch.ops import flash_attention_mh as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    D = 64
    serve_seg, serve_cos, serve_sin = _large_serving_layout()
    disc_seg, disc_cos, disc_sin = _stacked_large_disc(large_train_cfg)
    print(f"stacked large disc layout: {disc_seg.shape[0]} rows (4 copies), ids non-decreasing "
          f"{bool((np.diff(disc_seg) >= 0).all())}, tables [{disc_cos.shape[0]}, "
          f"{disc_cos.shape[1]}]")
    check(bool((np.diff(disc_seg) >= 0).all()), "stacked disc ids must be non-decreasing")
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    bench_seg = segments([576] * 10, 6144)
    ragged = segments([1, 2, 63, 64, 65, 127, 1892, 700, 5, 333], 3299)
    sep_q, sep_k = segments([500, 1, 450], 1100), segments([300, 250, 100], 700)
    # (label, q ids, k ids or None, hq, hkv, tables () -> (cos, sin, k_cos, k_sin))
    cases = [
        ("large serving layout 16/4, packer tables P30", serve_seg, None, 16, 4,
         lambda: (on(serve_cos), on(serve_sin), None, None)),
        ("large serving layout 16/4, random angles P16", serve_seg, None, 16, 4,
         lambda: _rand_tables(4096, 16, 1) + (None, None)),
        ("bench 10x576 4/2, random angles P30", bench_seg, None, 4, 2,
         lambda: _rand_tables(6144, 30, 2) + (None, None)),
        ("ragged 1..1892 4/2, random angles P30", ragged, None, 4, 2,
         lambda: _rand_tables(3299, 30, 3) + (None, None)),
        (f"stacked large disc 4x{disc_seg.shape[0] // 4} 16/4, concatenated packer tables P30",
         disc_seg, None, 16, 4, lambda: (on(disc_cos), on(disc_sin), None, None)),
        ("separate k ids and k tables 16/4, S 1100 vs Sk 700, P30", sep_q, sep_k, 16, 4,
         lambda: _rand_tables(1100, 30, 4) + _rand_tables(700, 30, 5)),
    ]
    res = {f"{k}_{d}": {"max_abs_err": 0.0} for k in ("fwd", "dq", "dkv") for d in ("bf16", "f32")}

    def inputs(S, Sk, hq, hkv, dtype):
        q = torch.randn(S, hq, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(Sk, hkv, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(Sk, hkv, D, generator=gen, device=dev).to(dtype)
        do = torch.randn(S, hq, D, generator=gen, device=dev).to(dtype)
        return q, k, v, do

    def kernels(q, k, v, seg, cos, sin, do, kseg=None, kc=None, ks=None):
        out, lse = fa._rope_fwd(q, k, v, seg, cos, sin, None, kseg, kc, ks)
        return out, lse, fa._rope_bwd(q, k, v, seg, cos, sin, out, lse, do, None, kseg, kc, ks)

    def plain(q, k, v, seg, cos, sin, do, out, lse, kseg=None, kc=None, ks=None):
        r_out, r_lse = fa.flash_segment_attention_mh_rope_reference(
            q, k, v, seg, cos, sin, None, kseg, kc, ks)
        grads = fa.flash_segment_attention_mh_rope_bwd_reference(
            q, k, v, seg, cos, sin, out, lse, do, None, kseg, kc, ks)
        return r_out, r_lse, grads

    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for label, seg_np, kseg_np, hq, hkv, tables in cases:
            S = seg_np.shape[0]
            Sk = S if kseg_np is None else kseg_np.shape[0]
            gen.manual_seed(S * 100 + hq + 11)
            q, k, v, do = inputs(S, Sk, hq, hkv, dtype)
            seg = on(seg_np)
            kseg = None if kseg_np is None else on(kseg_np)
            cos, sin, kc, ks = tables()
            got = kernels(q, k, v, seg, cos, sin, do, kseg, kc, ks)
            torch.cuda.synchronize()
            want = plain(q, k, v, seg, cos, sin, do, got[0], got[1], kseg, kc, ks)
            ok, line = rope_gate(got, want, dname)
            # the stricter check: apply_rotary_emb + the unfused forward kernel
            kr = apply_rotary_emb(k, cos if kc is None else kc, sin if ks is None else ks)
            u_out, u_lse = fa._fwd(apply_rotary_emb(q, cos, sin), kr, v, seg,
                                   k_segment_ids=kseg)
            bit = torch.equal(got[0], u_out) and torch.equal(got[1], u_lse)
            print(f"rope kernels {dname} {label} S={S} Sk={Sk}: {line}; fused forward == "
                  f"apply_rotary_emb + unfused kernel bit for bit: {bit} "
                  f"{'ok' if ok and bit else 'FAIL'}")
            check(ok, f"rope kernels disagree with their plain versions: {dname} {label}")
            check(bit, f"the fused forward is not the unfused path bit for bit: {dname} {label}")
            errs = [(got[0].float() - want[0].float()).abs().max().item()] + [
                (a.float() - b.float()).abs().max().item() for a, b in zip(got[2], want[2])]
            for key, e in (("fwd", errs[0]), ("dq", errs[1]), ("dkv", max(errs[2:]))):
                res[f"{key}_{dname}"]["max_abs_err"] = max(res[f"{key}_{dname}"]["max_abs_err"], e)
            del q, k, v, do, got, want, u_out, u_lse, kr
            torch.cuda.empty_cache()

        # planted faults: each made by the kernel itself on altered inputs, or
        # on its outputs, so it looks as a faulty kernel's output would
        gen.manual_seed(17)
        q, k, v, do = inputs(4096, 4096, 16, 4, dtype)
        seg, cos, sin = on(serve_seg), on(serve_cos), on(serve_sin)
        good = kernels(q, k, v, seg, cos, sin, do)
        want = plain(q, k, v, seg, cos, sin, do, good[0], good[1])
        P = cos.shape[1]
        faults = {"k left unrotated": kernels(q, k, v, seg, cos, sin, do, None,
                                              torch.ones_like(cos), torch.zeros_like(sin))}
        # R R dq_raw = R dq_rot: the forward rotation where the inverse belongs
        twice = apply_rotary_emb(apply_rotary_emb(good[2][0].float(), cos, sin), cos, sin)
        faults["forward rotation applied to dq instead of the inverse"] = (
            good[0], good[1], (twice.to(dtype), good[2][1], good[2][2]))
        # a kernel that loops over all 32 pairs reads row r's tables at
        # r * P + p for p < 32: the next row's first pairs
        rows = torch.arange(4096, device=dev)[:, None] * P + torch.arange(32, device=dev)
        rows = rows.clamp(max=cos.numel() - 1)
        ec, es = cos.flatten()[rows].contiguous(), sin.flatten()[rows].contiguous()
        faults["all 32 pairs rotated instead of P"] = kernels(q, k, v, seg, ec, es, do)
        for name, got in faults.items():
            ok, line = rope_gate(got, want, dname)
            print(f"  planted fault {dname}, {name}: {'PASSED' if ok else 'REJECTED'} ({line})")
            check(not ok, f"the {dname} rope gate passes a planted fault: {name}")
        gen.manual_seed(19)
        q, k, v, do = inputs(1100, 700, 16, 4, dtype)
        seg, kseg = on(sep_q), on(sep_k)
        cos, sin = _rand_tables(1100, 30, 4)
        kc, ks = _rand_tables(700, 30, 5)
        good = kernels(q, k, v, seg, cos, sin, do, kseg, kc, ks)
        want = plain(q, k, v, seg, cos, sin, do, good[0], good[1], kseg, kc, ks)
        got = kernels(q, k, v, seg, cos, sin, do, kseg, cos[:700].contiguous(),
                      sin[:700].contiguous())
        ok, line = rope_gate(got, want, dname)
        print(f"  planted fault {dname}, q's tables used for k (separate k tables given): "
              f"{'PASSED' if ok else 'REJECTED'} ({line})")
        check(not ok, f"the {dname} rope gate passes a planted fault: q's tables for k")
        del q, k, v, do, good, want, faults, got

        # times at the large serving layout (the numbers of the JSON line) and
        # at the bench shape with P 30 tables: each kernel at its C entry on
        # fixed buffers, the plain versions, the library chain, the bound
        fwd_fn, dq_fn, dkv_fn = fa._rope_kernels()
        for label, seg_np, hq, hkv, key in (
                ("large serving layout 16/4", serve_seg, 16, 4, None),
                ("bench 10x576 4/2", bench_seg, 4, 2, "at_bench_4_2")):
            S = seg_np.shape[0]
            q, k, v, do = inputs(S, S, hq, hkv, dtype)
            seg = on(seg_np)
            cos, sin = (on(serve_cos), on(serve_sin)) if key is None else _rand_tables(S, 30, 6)
            P = cos.shape[1]
            out, lse = fa._rope_fwd(q, k, v, seg, cos, sin)
            delta = fa._delta(out, do)
            o2, l2 = torch.empty_like(q), torch.empty_like(lse)
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            stream = torch.cuda.current_stream().cuda_stream
            head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), seg.data_ptr(),
                    cos.data_ptr(), sin.data_ptr(), cos.data_ptr(), sin.data_ptr(), P)
            tail = (S, S, hq, hkv, float(D ** -0.5), int(dname == "bf16"), stream)
            bwd_in = (do.data_ptr(), lse.data_ptr(), delta.data_ptr())
            ms = {"fwd": cuda_ms(lambda: fwd_fn(*head, o2.data_ptr(), l2.data_ptr(), *tail),
                                 reps=100),
                  "dq": cuda_ms(lambda: dq_fn(*head, *bwd_in, dq.data_ptr(), *tail), reps=100),
                  "dkv": cuda_ms(lambda: dkv_fn(*head, *bwd_in, dk.data_ptr(), dv.data_ptr(),
                                                *tail), reps=100)}
            plain_fwd = cuda_ms(lambda: fa.flash_segment_attention_mh_rope_reference(
                q, k, v, seg, cos, sin), reps=5, warmup=1)
            plain_bwd = cuda_ms(lambda: fa.flash_segment_attention_mh_rope_bwd_reference(
                q, k, v, seg, cos, sin, out, lse, do), reps=5, warmup=1)
            # yardstick only, never called by the port: apply_rotary_emb and one
            # SDPA call with the block-diagonal bool mask; and that chain's backward
            rs = fa._remap_pad(seg)
            mask = (rs[:, None] == rs[None, :])[None, None]
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]

            def chain():
                qr = apply_rotary_emb(leaves[0], cos, sin).permute(1, 0, 2)[None]
                kr = apply_rotary_emb(leaves[1], cos, sin).repeat_interleave(hq // hkv, dim=1)
                vr = leaves[2].repeat_interleave(hq // hkv, dim=1)
                return F.scaled_dot_product_attention(
                    qr, kr.permute(1, 0, 2)[None], vr.permute(1, 0, 2)[None], attn_mask=mask)

            with torch.no_grad():
                lib_fwd = cuda_ms(chain, reps=20)
            ob = chain()
            dob = do.permute(1, 0, 2)[None]
            lib_bwd = cuda_ms(lambda: torch.autograd.grad(ob, leaves, dob, retain_graph=True),
                              reps=20)
            # the path the model took unfused: apply_rotary_emb, then the
            # row 1-2 kernels through their autograd.Function; forward alone,
            # and the backward of that chain
            def unfused():
                return fa.flash_segment_attention_mh(
                    apply_rotary_emb(leaves[0], cos, sin), apply_rotary_emb(leaves[1], cos, sin),
                    leaves[2], seg)

            with torch.no_grad():
                unf_fwd = cuda_ms(unfused, reps=20)
            ou = unfused()
            unf_bwd = cuda_ms(lambda: torch.autograd.grad(ou, leaves, do, retain_graph=True),
                              reps=20)
            with torch.no_grad():
                fused_fwd = cuda_ms(lambda: fa.flash_segment_attention_mh(
                    q, k, v, seg, rope_cos=cos, rope_sin=sin), reps=20)
            of = fa.flash_segment_attention_mh(*leaves, seg, rope_cos=cos, rope_sin=sin)
            fused_bwd = cuda_ms(lambda: torch.autograd.grad(of, leaves, do, retain_graph=True),
                                reps=20)
            parts = []
            for kind in ("fwd", "dq", "dkv"):
                bound, by, flops, nbytes = rope_bound_ms(seg_np, seg_np, hq, hkv, D, dname, kind,
                                                         P, False)
                timing = dict(ms=ms[kind], plain_ms=plain_fwd if kind == "fwd" else plain_bwd,
                              library_ms=lib_fwd if kind == "fwd" else lib_bwd,
                              bound_ms=bound, bound_by=by)
                parts.append(f"{kind} {ms[kind]:.4f} ms (bound {bound * 1e3:.2f} us, {by}; "
                             f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; share "
                             f"{bound / ms[kind]:.4f})")
                if key is None:
                    res[f"{kind}_{dname}"].update(timing)
                else:
                    res[f"{kind}_{dname}"][key] = timing
            print(f"timing rope {dname} {label} S={S} P={P} [{card}]: " + ", ".join(parts) +
                  f"; plain forward {plain_fwd:.4f} ms, plain backward {plain_bwd:.4f} ms; library "
                  f"(apply_rotary_emb + SDPA, bool mask) forward {lib_fwd:.4f} ms, backward "
                  f"{lib_bwd:.4f} ms; through the wrappers, fused forward {fused_fwd:.4f} ms, "
                  f"backward {fused_bwd:.4f} ms, against the unfused path (apply_rotary_emb + the "
                  f"unfused kernels) forward {unf_fwd:.4f} ms, backward {unf_bwd:.4f} ms")
            for kind in ("fwd", "dq", "dkv"):
                entry = res[f"{kind}_{dname}"] if key is None else res[f"{kind}_{dname}"][key]
                entry["wrapper_vs_unfused_ms"] = {
                    "fused": fused_fwd if kind == "fwd" else fused_bwd,
                    "unfused": unf_fwd if kind == "fwd" else unf_bwd}
            del q, k, v, do, out, lse, delta, o2, l2, dq, dk, dv, mask, leaves, ob, ou, of
        torch.cuda.empty_cache()
    return res


def large_config(*over):
    """configs/large.yaml with RoPE fused into the attention kernels."""
    from titok_tpu_torch.config import load_config

    return load_config(LARGE, ["training.main.attn_impl=flash_rope", *over])


def phase_serving_large(card: str) -> dict:
    """configs/large.yaml (flash_rope) served at full width through the rope
    forward kernel."""
    import torch

    from titok_tpu_torch.models.titok import TiTokModel, make_titok

    cfg = large_config()
    seq_len = int(cfg.training.sampling.eval_seq_len)
    min_grid = cfg.training.sampling.min_grid
    with torch.device("cuda"):
        module = make_titok(cfg)
    # seeded weights drawn on the card, dense kernels at std 0.08 as the
    # base_vq phase (at 0.02 a random model's latent tokens sit near one code)
    params = card_params(module, seed=0, dense_std=0.08)
    n_params = sum(p.numel() for p in module.parameters())

    def build(**over):
        c = large_config(*[f"{k}={v}" for k, v in over.items()])
        with torch.device("cuda"):
            m = make_titok(c)
        return TiTokModel(m, params=params, seq_len=seq_len, min_grid=min_grid, device="cuda")

    clips, tcs = _large_serving_request()
    grids = [c.shape[1:] for c in clips]
    model = TiTokModel(module, params=params, seq_len=seq_len, min_grid=min_grid, device="cuda")
    n_groups = len(model._groups(clips, tcs))
    cb = model.module.codebook_size
    layers = model.module.encoder.model_layers.num_layer

    def serve(m):
        counts = []
        before = read_counts()
        idx = m.encode(clips, tcs)
        counts.append({k: v - before[k] for k, v in read_counts().items()})
        before = read_counts()
        rec, aux = m.forward(clips, tcs)
        counts.append({k: v - before[k] for k, v in read_counts().items()})
        before = read_counts()
        dec = m.decode_indices(idx, grids)
        counts.append({k: v - before[k] for k, v in read_counts().items()})
        return idx, rec, aux["indices"], dec, counts

    reset_counts()  # the main path: bf16 (bf16-mixed), through the rope kernel
    idx, rec, fidx, dec, counts = serve(model)
    torch.cuda.synchronize()
    paths = {"serving_large": read_counts()}
    for name, got, per in zip(("encode", "forward", "decode_indices"), counts,
                              (layers, 2 * layers, layers)):
        want = {**{k: 0 for k in got}, "rope_bf16": per * n_groups}
        check(got == want, f"large {name}: launches {got}, want {want} ({n_groups} groups)")
    for i, tc in enumerate(tcs):
        check(idx[i].shape == (tc,), f"encode clip {i}: {idx[i].shape}")
        check(np.array_equal(idx[i], fidx[i]), f"encode and forward disagree on clip {i}")
    flat = np.concatenate(idx)
    check(bool(((flat >= 0) & (flat < cb)).all()), f"index out of [0, {cb})")
    for c, r, d in zip(clips, rec, dec):
        check(r.shape == c.shape and np.isfinite(r).all(), "forward recon")
        check(d.shape == c.shape and np.isfinite(d).all(), "decode_indices recon")
    dec_diff = max(float(np.abs(r - d).max()) for r, d in zip(rec, dec))
    print(f"serving large (flash_rope) bf16, width {model.module.encoder.width}, "
          f"{layers}+{layers} layers, {n_params / 1e6:.1f} M params, {len(clips)} clips in "
          f"{n_groups} groups: rope forward launches per call encode/forward/decode "
          f"{[c['rope_bf16'] for c in counts]} (unfused forward: "
          f"{[c['bf16'] for c in counts]}); {len(np.unique(flat))} distinct of {flat.size} indices "
          f"in [0, {cb}); decode_indices vs forward recon max|diff| {dec_diff:.3e}")
    check(dec_diff == 0.0, "decode_indices does not reproduce forward's reconstruction")
    check(len(np.unique(flat)) > 1, "every token landed on one code: nothing to compare")

    # f32: the rope kernel path against the plain path (dense attention on
    # rotated q, k), same weights
    k32 = build(**{"training.main.precision": "32"})
    reset_counts()
    i32, r32, _, _, _ = serve(k32)
    paths["serving_large_f32"] = read_counts()
    check(paths["serving_large_f32"]["rope_f32"] > 0, "the f32 path launched no rope kernel")
    del k32
    torch.cuda.empty_cache()
    p32 = build(**{"training.main.precision": "32", "training.main.attn_impl": "reference"})
    reset_counts()
    ip, rp, _, _, _ = serve(p32)
    check(all(v == 0 for v in read_counts().values()), "the plain path launched a kernel")
    del p32
    torch.cuda.empty_cache()
    same = float((np.concatenate(i32) == np.concatenate(ip)).mean())
    rdiff = max(float(np.abs(a - b).max()) for a, b in zip(r32, rp))
    print(f"large f32 rope kernel path vs plain path: indices identical {same * 100:.3f} %, "
          f"recon max|diff| {rdiff:.3e}")
    check(same >= 0.999, "the f32 kernel path disagrees with the plain path on the indices")

    for _ in range(2):
        model.encode(clips, tcs)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        model.encode(clips, tcs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"encode (a) large, {len(clips)} clips, bf16 [{card}]: {ms:.3f} ms/request, "
          f"{len(clips) / ms * 1e3:.1f} clips/s (host clock, {reps} requests)")
    _breakdown(model, clips, tcs)
    del model, module, params
    torch.cuda.empty_cache()
    return paths


def phase_training_large(card: str) -> dict:
    """configs/large.yaml (flash_rope, remat on) trained at full width and
    depth through the rope kernels."""
    import torch

    dev = torch.device("cuda")
    # LPIPS off: this phase holds the rope kernels and the large step's
    # memory (the tiny path trains the full loss); a 2-step warm-up so the
    # timed steps move the params
    cfg = large_config("tokenizer.losses.perceptual_weight=0", "tokenizer.losses.gram_weight=0",
                       "optimizer.warmup_steps=2")
    check(bool(cfg.training.main.remat), "configs/large.yaml sets remat")
    batches, pack_ms = _host_batches(cfg, 5)
    seq_len = int(cfg.training.sampling.train_seq_len)
    t0 = time.perf_counter()
    builder, state, step = _trainer(cfg, card_seed=0)
    init_s = time.perf_counter() - t0
    n_gen = sum(p.numel() for p in state.model.parameters())
    n_disc = sum(p.numel() for p in state.disc_model.parameters())
    print(f"training: large GAN (flash_rope, remat on), width {state.model.encoder.width}, enc/dec "
          f"24+24 layers, heads 16/4, disc {cfg.discriminator.model.model_size}, FSQ "
          f"{list(cfg.tokenizer.model.fsq_levels)}, {n_gen / 1e6:.1f} M + {n_disc / 1e6:.1f} M "
          f"params, train_seq_len {seq_len}, {cfg.training.main.precision}, samples per batch "
          f"{[int(b.sample_valid.sum()) for b, _, _ in batches]}, host packing {pack_ms:.1f} "
          f"ms/batch, init on the card {init_s:.2f} s")
    # a sample of the params (the first and last of each module) to see them move
    watch = [p for m in (state.model, state.disc_model)
             for p in (list(m.parameters())[:4] + list(m.parameters())[-4:])]
    before_p = [p.detach().clone() for p in watch]
    n = TRAIN_LAUNCHES["large"]
    # remat replays each checkpointed Attn forward once in the backward: two
    # rope forwards per attention layer and step, one of each backward kernel
    want = {**{k: 0 for k in read_counts()}, "rope_bf16": 2 * n, "rope_bwd_dq_bf16": n,
            "rope_bwd_dkv_bf16": n}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the main path: the 5 steps below, read right after them
    per_step, metrics_all, times = [], [], []
    for i, (b, d, p) in enumerate(batches):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics, idx = step(state, *_on_card((b, d, p)))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: v - before[k] for k, v in read_counts().items()})
        metrics_all.append(metrics)
        tok = torch.from_numpy(b.token_mask).to(dev)
        check(bool(((idx[tok] >= 0) & (idx[tok] < 15360)).all()), f"step {i}: index out of range")
    paths = {"train_large": read_counts()}
    peak = torch.cuda.max_memory_allocated()
    for i, got in enumerate(per_step):
        check(got == want, f"large step {i}: launches {got}, want {want}")
    print(f"large training launches per step (every one of {len(batches)}): "
          f"{ {k: v for k, v in per_step[0].items() if v} } -- per attention layer (encoder 24 + "
          f"decoder 24 + stacked disc 24 in the generator pass, disc 24 in the discriminator "
          f"pass = {n}) one of each rope backward kernel and two rope forwards (the forward and "
          f"its remat replay in the backward); unfused kernels 0")
    for i, m in enumerate(metrics_all):
        vals = {k: float(v) for k, v in m.items()}
        check(all(np.isfinite(v) for v in vals.values()), f"step {i}: non-finite metric {vals}")
        check(vals["nonfinite_grad/generator"] == 0 and vals["nonfinite_grad/discriminator"] == 0,
              f"step {i}: a non-finite grad was zeroed")
        print(f"  step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in vals.items()))
    moved = max((p.detach() - p0).abs().max().item() for p, p0 in zip(watch, before_p))
    print(f"params moved (the first and last 4 tensors of each module): max|dp| {moved:.3e}")
    check(moved > 0, "the params did not move")
    timed = times[2:]
    print(f"train step, large GAN bf16 S={seq_len}, remat [{card}]: {np.mean(timed):.3f} ms/step "
          f"(host clock, mean of {len(timed)} after 2 warm-up; steps "
          f"{', '.join(f'{t:.2f}' for t in times)} ms), {seq_len / np.mean(timed) * 1e3:.0f} "
          f"tokens/s; peak device memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated over the 5 steps)")
    _train_breakdown(step, state, batches[0])
    del builder, state, step, watch, before_p
    torch.cuda.empty_cache()
    return paths


def phase_remat_large_f32(card: str) -> dict:
    """configs/large.yaml at full width and depth in f32 (discriminator in
    f32 too) at train_seq_len 2048: the same weights, batches and noise
    through the rope kernels with remat on and off. Losses and the first
    generator grads must agree bit for bit: every kernel and every sum of
    the step adds in a fixed order (the loss's per-sample means too, which
    summed by atomics once moved the losses in their last bits). Prints
    the loss values that differ, and the time of the steps after the
    first."""
    import torch

    dev = torch.device("cuda")
    # LPIPS off: this gate is bit for bit, and cuDNN's convolutions are not
    # shown to give the same bits twice
    over = ["tokenizer.losses.perceptual_weight=0", "tokenizer.losses.gram_weight=0",
            "optimizer.warmup_steps=1", "training.main.precision=32",
            "training.sampling.train_seq_len=2048"]
    batches, _ = _host_batches(large_config(*over), 2, seed=1)
    noise_gen = torch.Generator(device=dev).manual_seed(3)
    noises = [torch.randn(d.segment_ids.shape[0], b.patches.shape[1], generator=noise_gen,
                          device=dev) for b, d, _ in batches]
    runs, paths, times = {}, {}, {}
    for remat in (True, False):
        cfg = large_config(*over, f"training.main.remat={remat}")
        builder, st, stp = _trainer(cfg, f32_disc=True, card_seed=10)
        reset_counts()
        bt, dt_, _ = _on_card(batches[0])
        recon, _ = st.model(bt)
        loss, _ = builder.loss_system.generator_loss(recon, bt, dt_)
        grads = [g.detach().clone() for g in torch.autograd.grad(loss, list(st.model.parameters()))]
        del recon, loss
        losses, step_ms = [], []
        for i, (triple, noise) in enumerate(zip(batches, noises)):
            t0 = time.perf_counter()
            st, m, _ = stp(st, *_on_card(triple), noise=noise)
            torch.cuda.synchronize()
            if i > 0:  # the steps after the first
                step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append({k: float(v) for k, v in m.items() if "loss" in k or "penalty" in k})
        counts = read_counts()
        runs[remat] = (grads, losses)
        times[remat] = float(np.mean(step_ms))
        paths["train_large_f32" if remat else "train_large_f32_no_remat"] = counts
        del builder, st, stp
        torch.cuda.empty_cache()
    # launches: one generator grad pass (encoder 24 + decoder 24 + stacked
    # disc 24) and 2 steps of 96 attention layers; remat doubles the forwards
    n_attn = 72 + 2 * TRAIN_LAUNCHES["large"]
    for remat, fwd in ((True, 2 * n_attn), (False, n_attn)):
        got = paths["train_large_f32" if remat else "train_large_f32_no_remat"]
        want = {**{k: 0 for k in got}, "rope_f32": fwd, "rope_bwd_dq_f32": n_attn,
                "rope_bwd_dkv_f32": n_attn}
        check(got == want, f"large f32 remat={remat}: launches {got}, want {want}")
    (g1, l1), (g0, l0) = runs[True], runs[False]
    gmax = max(g.abs().max().item() for g in g0)
    gerr = max((a - b).abs().max().item() for a, b in zip(g1, g0))
    pairs = [(l1[i][key], l0[i][key]) for i in range(len(l0)) for key in l0[i]]
    labs = max(abs(a - b) for a, b in pairs)
    lok = all(abs(a - b) <= 1e-6 + 1e-4 * abs(b) for a, b in pairs)
    same = labs == 0 and gerr == 0
    print(f"large f32 S=2048 (flash_rope), remat on vs off, same weights, batches and noise: "
          f"first generator grads max|diff| {gerr:.3e} of max|g| {gmax:.3e} (gate 1e-4 x max|g|), "
          f"losses over 2 steps max|diff| {labs:.3e} (gate 1e-6 + 1e-4 relative); "
          f"bit-identical: {same}; rope launches with remat "
          f"{ {k: v for k, v in paths['train_large_f32'].items() if v} }, without "
          f"{ {k: v for k, v in paths['train_large_f32_no_remat'].items() if v} }")
    for i in range(len(l0)):
        print(f"  step {i}: remat {l1[i]}")
        print(f"          no remat {l0[i]}")
    differ = [f"step {i} {key} |d| {abs(l1[i][key] - l0[i][key]):.3e} (of {abs(l0[i][key]):.3e})"
              for i in range(len(l0)) for key in l0[i] if l1[i][key] != l0[i][key]]
    print(f"  loss values that differ, remat vs no remat: {'; '.join(differ) or 'none'}")
    print(f"large f32 S=2048 step time after the first step [{card}]: remat "
          f"{times[True]:.3f} ms, no remat {times[False]:.3f} ms (host clock, ending in "
          f"torch.cuda.synchronize())")
    check(lok, "remat and non-remat losses disagree")
    check(gerr <= 1e-4 * gmax, "remat and non-remat grads disagree")
    check(same, "remat and non-remat losses or grads are not bit-identical")
    return paths


# ---------------------------------------------------------------------------
# The v1 attention kernels (attn_impl: flash_v1) and the trainer, its
# checkpoints and eval metrics, run on configs/tiny_fsq16k.yaml
# ---------------------------------------------------------------------------


def v1_fwd_gate(out, lse, r_out, r_lse, dname):
    """A v1 forward ``(out, lse)`` against its plain version: the row 1 gate
    (every entry within atol + rtol * |b|, lse within lse atol) and, as row
    2's gate has it, rms(out - b) <= nrel * rms(b) at BWD_TOL's nrel. The
    plain version rounds p where the kernel does (against the running max
    of each 64-row kv tile), so in bf16 the two differ only where the f32
    sum order moves an output to its neighbouring bf16 value; p left
    unrounded moves a fifth of them. Returns (ok, line)."""
    import torch

    atol, rtol, lse_atol = TOL[dname]
    nrel = BWD_TOL[dname][2]
    o32, r32 = out.float(), r_out.float()
    d = (o32 - r32).abs()
    rel = d.square().mean().sqrt().item() / max(r32.square().mean().sqrt().item(), 1e-30)
    err_lse = (lse - r_lse).abs().max().item()
    ok = bool((d <= atol + rtol * r32.abs()).all()) and err_lse <= lse_atol and \
        rel <= nrel and bool(torch.isfinite(o32).all())
    return ok, (f"out max|d| {d.max().item():.3e}, rms ratio {rel:.2e} (nrel {nrel}), lse "
                f"max|d| {err_lse:.3e}")


def _starts_aligned(seg_np, tile=64) -> bool:
    """Whether every run of equal ids (pad included) starts at a multiple
    of ``tile``: then the v1 forward's kv tiles, aligned to row 0, are the
    row 1 forward's, which start where each q tile's interval starts."""
    starts = np.flatnonzero(np.diff(seg_np, prepend=seg_np[:1] - 1))
    return bool((starts % tile == 0).all())


def phase_v1_kernels(card: str, train_cfg) -> dict:
    """The three v1 kernels against their plain versions, bf16 and f32;
    the forward against the row 1 kernel, the dq against the row 2 dq (bit
    for bit, in either dtype) and in f32 the forward and dk/dv against rows
    1-2 bit for bit; planted faults; times."""
    import torch
    import torch.nn.functional as F

    from titok_tpu_torch.ops import flash_attention as f1
    from titok_tpu_torch.ops import flash_attention_mh as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    D = 64
    disc_seg, _, sd = _stacked_disc_ids(train_cfg)
    bench_seg = segments([576] * 10, 6144)
    cases = [  # (label, ids, hq, hkv)
        ("bench 10x576 4/2", bench_seg, 4, 2),
        ("base_vq serving layout 12/4", BASE_SEG, 12, 4),
        ("base_vq serving layout 16/4", BASE_SEG, 16, 4),
        # 8 q heads a kv head: the bf16 dk/dv's 4 warp groups take them in
        # two chunks of 4, each head rounded when its chunk is folded
        ("base_vq serving layout 8/1", BASE_SEG, 8, 1),
        ("ragged 1..1892 4/2", segments([1, 2, 63, 64, 65, 127, 1892, 700, 5, 333], 3299), 4, 2),
        (f"tiny stacked disc 4x{sd} 4/2", disc_seg, 4, 2),
        # one head a group: the bf16 forward takes 128 q rows a CTA, the dq
        # one head; aligned (row 1's bits), and ragged (segments from 1 row,
        # starting mid-tile, the last tile of S part pad)
        ("bench 10x576 4/4", bench_seg, 4, 4),
        ("ragged 1..1892 4/4", segments([1, 2, 63, 64, 65, 127, 1892, 700, 5, 333], 3299), 4, 4),
    ]
    res = {f"{k}_{d}": {"max_abs_err": 0.0} for k in ("fwd", "dq", "dkv") for d in ("bf16", "f32")}

    def inputs(S, hq, hkv, dtype):
        q = torch.randn(S, hq, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(S, hkv, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(S, hkv, D, generator=gen, device=dev).to(dtype)
        do = torch.randn(S, hq, D, generator=gen, device=dev).to(dtype)
        return q, k, v, do

    def kernels(q, k, v, seg, do, lse_scale=1.0):
        """The three kernels through their C entries' wrappers: (out, lse,
        (dq, dk, dv)), dk/dv summed over each group by the kernel;
        ``lse_scale`` scales the lse the forward hands on."""
        scale = D ** -0.5
        out, lse = f1.launch_fwd(q, k, v, seg, scale)
        lse = lse * lse_scale
        delta = fa._delta(out, do)
        dq = f1.launch_bwd_dq(q, k, v, seg, do, lse, delta, scale)
        dk, dv = f1.launch_bwd_dkv(q, k, v, seg, do, lse, delta, scale)
        return out, lse, (dq, dk, dv)

    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for label, seg_np, hq, hkv in cases:
            S = seg_np.shape[0]
            gen.manual_seed(S * 100 + hq + 23)
            q, k, v, do = inputs(S, hq, hkv, dtype)
            seg = torch.from_numpy(seg_np).to(dev)
            out, lse, grads = kernels(q, k, v, seg, do)
            torch.cuda.synchronize()
            r_out, r_lse = f1.flash_segment_attention_reference(q, k, v, seg)
            ok_f, line_f = v1_fwd_gate(out, lse, r_out, r_lse, dname)
            # the kernel's group sums (bf16: each head rounded first, as the
            # plain version's)
            want = f1.flash_segment_attention_bwd_reference(q, k, v, seg, out, lse, do)
            ok_b, rows_b = bwd_gate(grads, want, dname)
            # the row 1 kernel computes the same function. In f32 the v1
            # forward is it on one id vector: its bits on every layout. In
            # bf16 its kv tiles start where each q tile's interval starts, so
            # p rounds elsewhere, but where every segment starts at a
            # multiple of 64 the tiles are v1's and so are the bits (the same
            # template)
            m_out, m_lse = fa._fwd(q, k, v, seg)
            m32 = m_out.float()
            atol, rtol, lse_atol = TOL[dname]
            ok_m = bool(((out.float() - m32).abs() <= atol + rtol * m32.abs()).all()) and \
                (lse - m_lse).abs().max().item() <= lse_atol
            vs_row1 = f"out max|d| {(out.float() - m32).abs().max().item():.3e}"
            if dname == "f32" or _starts_aligned(seg_np):
                ok_m = ok_m and torch.equal(out, m_out) and torch.equal(lse, m_lse)
                vs_row1 += (", bit for bit" if dname == "f32" else
                            ", bit for bit (segments 64-aligned)")
            # the v1 dq is the row 2 dq on one id vector, in either dtype, and
            # in f32 the v1 dk/dv is the row 2 dk/dv: their bits
            row2 = fa._bwd(q, k, v, seg, out, lse, do)
            same_dq = torch.equal(grads[0], row2[0])
            vs_row2 = f"; dq vs the row 2 dq {'identical' if same_dq else 'DIFFERENT'}"
            check(same_dq, f"the v1 {dname} dq differs from the row 2 dq: {label}")
            if dname == "f32":
                same_dkv = torch.equal(grads[1], row2[1]) and torch.equal(grads[2], row2[2])
                vs_row2 += f", dk/dv vs the row 2 dk/dv {'identical' if same_dkv else 'DIFFERENT'}"
                check(same_dkv, f"the v1 f32 dk/dv differs from the row 2 dk/dv: {label}")
            print(f"v1 kernels {dname} {label} S={S}: forward {line_f} {'ok' if ok_f else 'FAIL'}; "
                  f"group-summed {'ok' if ok_b else 'FAIL'} ({_gate_line(rows_b)}); vs "
                  f"the row 1 kernel {vs_row1} {'ok' if ok_m else 'FAIL'}{vs_row2}")
            check(ok_f and ok_b, f"v1 kernels disagree with their plain versions: "
                  f"{dname} {label}")
            check(ok_m, f"the v1 forward disagrees with the row 1 kernel: {dname} {label}")
            errs = [(out.float() - r_out.float()).abs().max().item()] + [
                (a.float() - b.float()).abs().max().item() for a, b in zip(grads, want)]
            for key, e in (("fwd", errs[0]), ("dq", errs[1]), ("dkv", max(errs[2:]))):
                res[f"{key}_{dname}"]["max_abs_err"] = max(res[f"{key}_{dname}"]["max_abs_err"], e)
            del q, k, v, do, out, lse, grads, r_out, r_lse, want, m_out, m_lse, row2
            torch.cuda.empty_cache()

        # planted faults at the bench shape, each made by the kernels on
        # altered inputs or outputs, or by the plain version, so it looks as
        # a faulty kernel's output would
        S, hq, hkv = 6144, 4, 2
        gen.manual_seed(5)
        q, k, v, do = inputs(S, hq, hkv, dtype)
        seg = torch.from_numpy(bench_seg).to(dev)
        out, lse, grads = kernels(q, k, v, seg, do)
        r_out, r_lse = f1.flash_segment_attention_reference(q, k, v, seg)
        want = f1.flash_segment_attention_bwd_reference(q, k, v, seg, out, lse, do)
        fwd_faults, bwd_faults = {}, {}
        # no v1 kernel reads tile intervals: the fault is made through the
        # ids, as rows 1-2's is, by the row 1 forward and the row 2
        # backward, whose bits the v1 forward and dq (and in f32 the dk/dv)
        # give at this layout (gated above); the last kv tile a q tile
        # overlaps is its segment's last 64 rows. The bf16 dk/dv is v1's own
        # (its heads rounded before the group sum): its fault is the dq's
        q_ids, k_ids = _last_kv_tile_skipped(seg)
        fwd_faults["the last overlapping kv tile skipped"] = fa._fwd(
            q, k, v, q_ids, k_segment_ids=k_ids)
        skip = fa._bwd(q, k, v, q_ids, out, lse, do, k_segment_ids=k_ids)
        bwd_faults["the last overlapping kv/q tile skipped"] = (
            skip if dname == "f32" else (skip[0], *grads[1:]))
        # the kernel itself with dO, and so delta, zero on every q head but
        # the first of each group: its dk/dv are then that head's alone
        keep = (torch.arange(hq, device=dev) % (hq // hkv) == 0).to(dtype)
        one = kernels(q, k, v, seg, (do * keep[None, :, None]).contiguous())[2]
        bwd_faults["dk/dv of only one q head of each group"] = (grads[0], one[1], one[2])
        # lse in log2 units: a kernel that folds log2(e) into the scale for
        # exp2 and does not convert its lse back
        wrong = kernels(q, k, v, seg, do, lse_scale=float(np.log2(np.e)))
        fwd_faults["lse with the wrong scale (log2 units)"] = wrong[:2]
        bwd_faults["the backward given lse with the wrong scale"] = wrong[2]
        if dname == "bf16":
            p_out, p_lse = f1.flash_segment_attention_reference(q.float(), k.float(), v.float(), seg)
            fwd_faults["p not rounded before p.v"] = (p_out.to(dtype), p_lse)
        for name, (f_out, f_lse) in fwd_faults.items():
            ok, line = v1_fwd_gate(f_out, f_lse, r_out, r_lse, dname)
            print(f"  planted fault {dname}, {name}: forward gate "
                  f"{'PASSED' if ok else 'REJECTED'} ({line})")
            check(not ok, f"the {dname} v1 forward gate passes a planted fault: {name}")
        for name, got in bwd_faults.items():
            ok, rows = bwd_gate(got, want, dname)
            print(f"  planted fault {dname}, {name}: backward gate "
                  f"{'PASSED' if ok else 'REJECTED'} ({_gate_line(rows)})")
            check(not ok, f"the {dname} v1 backward gate passes a planted fault: {name}")
        del out, lse, grads, want, fwd_faults, bwd_faults, wrong, one, skip

        # times at the bench shape (the numbers of the JSON line) and at the
        # base_vq serving layout, heads 12/4: each kernel at its C entry on
        # fixed buffers, the plain versions, one library call, the bound
        fwd_fn, dq_fn, dkv_fn = f1._kernels()
        for label, seg_np, hq, hkv, key in (("bench 10x576 4/2", bench_seg, 4, 2, None),
                                            ("base heads 12/4", BASE_SEG, 12, 4, "at_base_12_4")):
            S = seg_np.shape[0]
            q, k, v, do = inputs(S, hq, hkv, dtype)
            seg = torch.from_numpy(seg_np).to(dev)
            out, lse = f1._fwd(q, k, v, seg)
            delta = fa._delta(out, do)
            o2, l2 = torch.empty_like(q), torch.empty_like(lse)
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            stream = torch.cuda.current_stream().cuda_stream
            tail = (S, hq, hkv, float(D ** -0.5), int(dname == "bf16"), stream)
            head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr())
            bwd_in = (do.data_ptr(), lse.data_ptr(), delta.data_ptr())
            ms = {"fwd": cuda_ms(lambda: fwd_fn(*head, o2.data_ptr(), l2.data_ptr(), *tail),
                                 reps=100),
                  "dq": cuda_ms(lambda: dq_fn(*head, *bwd_in, dq.data_ptr(), *tail), reps=100),
                  "dkv": cuda_ms(lambda: dkv_fn(*head, *bwd_in, dk.data_ptr(), dv.data_ptr(),
                                                *tail), reps=100)}
            check(torch.equal(o2, out), "the timed forward launches changed their output")
            wrap_fwd = cuda_ms(lambda: f1._fwd(q, k, v, seg), reps=100)
            wrap_bwd = cuda_ms(lambda: f1._bwd(q, k, v, seg, out, lse, do), reps=100)
            plain_fwd = cuda_ms(lambda: f1.flash_segment_attention_reference(q, k, v, seg),
                                reps=5, warmup=1)
            plain_bwd = cuda_ms(lambda: f1.flash_segment_attention_bwd_reference(
                q, k, v, seg, out, lse, do), reps=5, warmup=1)
            # yardstick only, never called by the port: SDPA with the
            # block-diagonal bool mask, and its backward
            qb = q.permute(1, 0, 2)[None].detach().requires_grad_()
            kb = k.repeat_interleave(hq // hkv, dim=1).permute(1, 0, 2)[None].detach().requires_grad_()
            vb = v.repeat_interleave(hq // hkv, dim=1).permute(1, 0, 2)[None].detach().requires_grad_()
            rs = fa._remap_pad(seg)
            mask = (rs[:, None] == rs[None, :])[None, None]
            with torch.no_grad():
                lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask),
                                  reps=20)
            ob = F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask)
            dob = do.permute(1, 0, 2)[None]
            lib_bwd = cuda_ms(lambda: torch.autograd.grad(ob, (qb, kb, vb), dob,
                                                          retain_graph=True), reps=20)
            # the bound of rows 1-2 (the same work): forward 2 products and
            # out + lse; dq 3 products and dq; dk/dv 4 products and dk, dv
            bounds = {"fwd": attn_bound_ms(seg_np, S, hq, hkv, D, dname),
                      "dq": bwd_bound_ms(seg_np, S, S, hq, hkv, D, dname, 3, ("dq",)),
                      "dkv": bwd_bound_ms(seg_np, S, S, hq, hkv, D, dname, 4, ("dkv",))}
            parts = []
            for kind in ("fwd", "dq", "dkv"):
                bound, by, flops, nbytes = bounds[kind]
                timing = dict(ms=ms[kind], plain_ms=plain_fwd if kind == "fwd" else plain_bwd,
                              library_ms=lib_fwd if kind == "fwd" else lib_bwd,
                              bound_ms=bound, bound_by=by)
                parts.append(f"{kind} {ms[kind]:.4f} ms (bound {bound * 1e3:.2f} us, {by}; "
                             f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; share "
                             f"{bound / ms[kind]:.4f})")
                if key is None:
                    res[f"{kind}_{dname}"].update(timing)
                else:
                    res[f"{kind}_{dname}"][key] = timing
            print(f"timing v1 {dname} {label} S={S} [{card}]: " + ", ".join(parts) +
                  f"; through the wrappers forward {wrap_fwd:.4f} ms, backward (delta, both "
                  f"kernels) {wrap_bwd:.4f} ms; plain forward {plain_fwd:.4f} ms, "
                  f"plain backward {plain_bwd:.4f} ms; library (SDPA, bool mask) forward "
                  f"{lib_fwd:.4f} ms, backward {lib_bwd:.4f} ms")
            del q, k, v, do, out, lse, delta, o2, l2, dq, dk, dv, qb, kb, vb, ob, mask
        torch.cuda.empty_cache()
    return res


TINY16K = os.path.join(REPO, "configs", "tiny_fsq16k.yaml")
RUN_DIR = os.path.join(REPO, "build", "chip_smoke")  # git-ignored, emptied per run


def tiny16k_overrides(run: str, **over) -> list[str]:
    """configs/tiny_fsq16k.yaml as the trainer phases run it: synthetic
    data, the v1 kernels, its loss with LPIPS on (seeded random VGG
    weights: ``allow_random_lpips``), 8 steps with eval at 4 and 8 over 16
    clips, checkpoints every 4 steps keeping 2, into ``RUN_DIR/<run>``."""
    base = {"dataset.train_dataset": "synthetic", "dataset.eval_dataset": "synthetic",
            "training.main.attn_impl": "flash_v1", "tokenizer.losses.allow_random_lpips": "true",
            "optimizer.warmup_steps": 2, "training.main.max_steps": 8,
            "general.wandb.log_step_interval": 1, "training.eval.eval_step_interval": 4,
            "training.eval.eval_samples": 16, "general.checkpoints.save_interval": 4,
            "general.checkpoints.keep_prior": 2,
            "general.checkpoints.save_path": os.path.join(RUN_DIR, run), **over}
    return [f"{k}={v}" for k, v in base.items()]


def _jsonl(run: str) -> list[dict]:
    """The records of a run's metrics.jsonl; a line still being written
    is left out."""
    path = os.path.join(RUN_DIR, run, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.endswith("\n")]


def _count_steps(trainer, per_step: list) -> None:
    """Wrap ``trainer``'s train step so that each call appends its kernel
    launches to ``per_step``."""
    make = trainer.builder.make_train_step

    def counted_make():
        step = make()

        def counted(*args, **kw):
            before = read_counts()
            out = step(*args, **kw)
            per_step.append({k: v - before[k] for k, v in read_counts().items()})
            return out

        return counted

    trainer.builder.make_train_step = counted_make


def phase_trainer(card: str) -> dict:
    """``Trainer(cfg).fit()`` of configs/tiny_fsq16k.yaml on the card,
    through the v1 kernels: 8 steps, eval at 4 and 8, checkpoints."""
    import shutil

    import torch

    from titok_tpu_torch.config import load_config
    from titok_tpu_torch.train_utils.codebook_logging import codebook_scores
    from titok_tpu_torch.training.trainer import Trainer

    shutil.rmtree(RUN_DIR, ignore_errors=True)
    cfg = load_config(TINY16K, tiny16k_overrides("fit"))
    trainer = Trainer(cfg)
    per_step, init = [], {}
    _count_steps(trainer, per_step)
    init_state = trainer._init_state

    def snap_init(seed):
        st = init_state(seed)
        init["params"] = [p.detach().clone() for p in st.model.parameters()]
        init["disc"] = [p.detach().clone() for p in st.disc_model.parameters()]
        return st

    trainer._init_state = snap_init
    reset_counts()  # the main path: the whole fit, read right after it
    t0 = time.perf_counter()
    state = trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    paths = {"train_v1_bf16": read_counts()}
    total = paths["train_v1_bf16"]

    n = TRAIN_LAUNCHES["tiny"]
    want = {**{k: 0 for k in total}, "v1_bf16": n, "v1_bwd_dq_bf16": n, "v1_bwd_dkv_bf16": n}
    check(len(per_step) == 8, f"{len(per_step)} train steps, want 8")
    for i, got in enumerate(per_step):
        check(got == want, f"trainer step {i}: launches {got}, want {want}")
    n_eval = len(trainer._eval_cache)
    layers = 4 + 4  # encoder + decoder forwards per eval batch
    want_total = {**{k: 0 for k in total}, "v1_bf16": 8 * n + 2 * n_eval * layers,
                  "v1_bwd_dq_bf16": 8 * n, "v1_bwd_dkv_bf16": 8 * n}
    check(total == want_total, f"fit launches {total}, want {want_total}")
    print(f"trainer (configs/tiny_fsq16k.yaml, flash_v1, bf16-mixed, train_seq_len "
          f"{cfg.training.sampling.train_seq_len}, eval_seq_len {cfg.training.sampling.eval_seq_len},"
          f" FSQ {list(cfg.tokenizer.model.fsq_levels)}): fit of 8 steps in {fit_s:.2f} s; launches "
          f"per step {per_step[0]['v1_bf16']} forward, {per_step[0]['v1_bwd_dq_bf16']} dq, "
          f"{per_step[0]['v1_bwd_dkv_bf16']} dk/dv (every one of 8); fit total "
          f"{ {k: v for k, v in total.items() if v} } = 8 steps + 2 evals of {n_eval} batches x "
          f"{layers} forwards; rows 1-4 kernels 0")

    rows = _jsonl("fit")
    train_rows = [r for r in rows if "train/gen/total_loss" in r]
    check([r["step"] for r in train_rows] == list(range(8)), "a train step was not logged")
    for r in train_rows:
        vals = {k: v for k, v in r.items() if k.startswith("train/")}
        check(all(np.isfinite(v) for v in vals.values()), f"step {r['step']}: non-finite {vals}")
        check(vals["train/nonfinite_grad/generator"] == 0 and
              vals["train/nonfinite_grad/discriminator"] == 0, f"step {r['step']}: zeroed step")
        check(vals.get("train/gen/perceptual_loss", 0) > 0,
              f"step {r['step']}: no positive gen/perceptual_loss")
    evals = {r["step"]: r for r in rows if "eval/psnr" in r}
    check(sorted(evals) == [4, 8] and all("eval/ssim" in r for r in evals.values()),
          f"eval rows at {sorted(evals)}, want PSNR and SSIM at 4 and 8")
    for s, r in evals.items():
        check(np.isfinite(r["eval/psnr"]) and -1 <= r["eval/ssim"] <= 1, f"eval at {s}: {r}")
    moved_g = max((p.detach() - p0).abs().max().item()
                  for p, p0 in zip(state.model.parameters(), init["params"]))
    moved_d = max((p.detach() - p0).abs().max().item()
                  for p, p0 in zip(state.disc_model.parameters(), init["disc"]))
    check(moved_g > 0 and moved_d > 0, "the params did not move")
    cl = trainer.codebook_logger
    check(len(cl.window) > 0, "the codebook logger saw no sample")
    scores = codebook_scores(cl.window, cl.codebook_size)
    flat = np.concatenate(cl.window)
    check(bool(((flat >= 0) & (flat < cl.codebook_size)).all()), "codebook index out of range")
    check(0 < scores["codebook/usage_percent"] <= 100 and scores["codebook/entropy"] > 0,
          f"codebook scores {scores}")
    ckpts = trainer.ckpt.all_steps()
    check(ckpts == [4, 8], f"checkpoints {ckpts}, want [4, 8] (save_interval 4, keep_prior 2)")
    check(os.path.exists(os.path.join(RUN_DIR, "fit", "config.yaml")), "no config.yaml")
    for s, r in evals.items():
        print(f"  eval at step {s}: psnr {r['eval/psnr']:.4f} dB, ssim {r['eval/ssim']:.5f} "
              f"(device sums, {n_eval} eval batches of {cfg.training.eval.eval_samples} clips)")
    print(f"  codebook window {len(cl.window)} samples of {cl.codebook_size}: usage "
          f"{scores['codebook/usage_percent']:.3f} %, entropy {scores['codebook/entropy']:.4f}; "
          f"checkpoints {ckpts}; params moved: generator {moved_g:.3e}, discriminator "
          f"{moved_d:.3e}")
    for r in train_rows:
        print(f"  step {r['step']}: gen/total_loss {r['train/gen/total_loss']:.6g}, "
              f"gen/perceptual_loss {r['train/gen/perceptual_loss']:.6g}, disc/total_loss {r.get('train/disc/total_loss', float('nan')):.6g}, "
              f"perf/tokens_per_sec {r['perf/tokens_per_sec']:.0f}, step_time_mean "
              f"{r.get('perf/step_time_mean_s', float('nan')):.4f} s")

    # the trainer's rate against the bare step at the same shape: the
    # prefetch thread packs and copies the next batch during the step
    seq_len = int(cfg.training.sampling.train_seq_len)
    tps = [r["perf/tokens_per_sec"] for r in train_rows[3:] if r["step"] not in evals]
    step_mean = train_rows[-1]["perf/step_time_mean_s"]
    step = trainer.builder.make_train_step()
    batches, pack_ms = _host_batches(cfg, 5, seed=3)
    times = []
    for triple in batches:
        on_card = _on_card(triple)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _, _ = step(state, *on_card)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    bare = float(np.mean(times[2:]))
    print(f"train step tiny_fsq16k flash_v1 bf16 S={seq_len} [{card}]: trainer "
          f"perf/tokens_per_sec {np.mean(tps):.0f} (mean over steps "
          f"{[r['step'] for r in train_rows[3:] if r['step'] not in evals]}, host clock between "
          f"loop iterations, packing overlapped), trainer step_time_mean {step_mean * 1e3:.3f} ms "
          f"(all 8 steps, the eval steps' included); bare make_train_step {bare:.3f} ms/step "
          f"({seq_len / bare * 1e3:.0f} tokens/s; H2D of packed batches in the step, host "
          f"packing {pack_ms:.1f} ms/batch outside it; steps {', '.join(f'{t:.2f}' for t in times)})")
    _train_breakdown(step, state, batches[0])
    del trainer, state, step
    torch.cuda.empty_cache()
    return paths


def _cli(args: list[str]):
    """``python -m titok_tpu_torch.train`` in a subprocess from the repo root."""
    return subprocess.Popen([sys.executable, "-m", "titok_tpu_torch.train", *args], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def phase_trainer_cli(card: str) -> None:
    """The CLI on the card: resume the fit phase's run to step 12; then a
    fresh run stopped by SIGTERM after its log shows step 3 (exit 143, a
    checkpoint at the step reached) and resumed from that checkpoint."""
    import signal as _signal

    from titok_tpu_torch.train_utils.checkpoints import CheckpointManager

    cfg_arg = f"config={TINY16K}"
    procs = []
    try:
        # 1. resume the fit phase's run (checkpoints 4 and 8) to 12 steps
        t0 = time.perf_counter()
        p = _cli([cfg_arg, *tiny16k_overrides("fit", **{
            "training.main.max_steps": 12,
            "general.checkpoints.resume_from_checkpoint": True})])
        procs.append(p)
        out, _ = p.communicate(timeout=600)
        took = time.perf_counter() - t0
        check(p.returncode == 0, f"CLI resume exited {p.returncode}:\n{out[-3000:]}")
        check("resumed from step 8" in out, f"CLI resume did not resume from 8:\n{out[-3000:]}")
        steps = CheckpointManager(os.path.join(RUN_DIR, "fit")).all_steps()
        check(steps[-1] == 12, f"checkpoints after the resume {steps}, want the final one at 12")
        logged = sorted({r["step"] for r in _jsonl("fit") if "train/gen/total_loss" in r})
        check(logged == list(range(12)), f"logged train steps {logged}")
        print(f"CLI resume: 'resumed from step 8', steps 8-11 logged, checkpoints {steps} "
              f"({took:.1f} s including start-up)")

        # 2. a fresh run, SIGTERM once its log shows step >= 3
        t0 = time.perf_counter()
        p = _cli([cfg_arg, *tiny16k_overrides("sigterm", **{
            "training.main.max_steps": 200, "general.checkpoints.save_interval": 0,
            "training.eval.eval_step_interval": 0})])
        procs.append(p)
        while p.poll() is None and time.perf_counter() - t0 < 300:
            if any(r.get("step", -1) >= 3 for r in _jsonl("sigterm")):
                break
            time.sleep(0.2)
        print(f"CLI run to stop: its log shows step 3 after {time.perf_counter() - t0:.1f} s; "
              f"sending SIGTERM", flush=True)
        if p.poll() is not None:
            raise SmokeFailure(f"the run ended before its log showed step 3: "
                               f"{p.communicate()[0][-3000:]}")
        p.send_signal(_signal.SIGTERM)
        out, _ = p.communicate(timeout=300)
        check(p.returncode == 143, f"SIGTERM: exit {p.returncode}, want 143:\n{out[-3000:]}")
        reached = CheckpointManager(os.path.join(RUN_DIR, "sigterm")).latest_step()
        logged = max(r["step"] for r in _jsonl("sigterm") if "train/gen/total_loss" in r)
        check(reached is not None and reached >= 4 and logged < reached,
              f"checkpoint after SIGTERM {reached}, last logged step {logged}")
        check(f"preemption save at step {reached}" in out, f"no preemption save line:\n{out[-2000:]}")
        print(f"CLI SIGTERM after step {logged} was logged: exit 143, 'preemption save at step "
              f"{reached}' ({time.perf_counter() - t0:.1f} s)")

        # 3. resume from the preemption checkpoint
        p = _cli([cfg_arg, *tiny16k_overrides("sigterm", **{
            "training.main.max_steps": reached + 2, "general.checkpoints.save_interval": 0,
            "training.eval.eval_step_interval": 0,
            "general.checkpoints.resume_from_checkpoint": True})])
        procs.append(p)
        out, _ = p.communicate(timeout=600)
        check(p.returncode == 0 and f"resumed from step {reached}" in out,
              f"resume after SIGTERM: exit {p.returncode}:\n{out[-3000:]}")
        last = CheckpointManager(os.path.join(RUN_DIR, "sigterm")).latest_step()
        check(last == reached + 2, f"final checkpoint {last}, want {reached + 2}")
        print(f"CLI resume after SIGTERM: 'resumed from step {reached}', final checkpoint {last}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _bitwise_equal(a, b) -> dict:
    """Which parts of two train states hold the same bits: ``params`` (both
    modules), ``opt`` (both optimizers' state: counts and moments) and
    ``noise`` (the R1/R2 noise generator)."""
    import torch

    def same_opt(x, y):
        sx, sy = x.state_dict()["state"], y.state_dict()["state"]
        return sx.keys() == sy.keys() and all(
            sx[i].keys() == sy[i].keys() and all(
                torch.equal(v, sy[i][k]) and v.dtype == sy[i][k].dtype if torch.is_tensor(v)
                else v == sy[i][k] for k, v in sx[i].items()) for i in sx)

    return {"params": all(torch.equal(p, q) for m, n in ((a.model, b.model),
                                                        (a.disc_model, b.disc_model))
                          for p, q in zip(m.parameters(), n.parameters())),
            "opt": same_opt(a.gen_opt, b.gen_opt) and same_opt(a.disc_opt, b.disc_opt),
            "noise": torch.equal(a.noise_gen.get_state(), b.noise_gen.get_state())}


def phase_resume_f32(card: str) -> dict:
    """f32 at train_seq_len 2048 (the discriminator rebuilt in f32 too): 4
    steps straight against 2 steps, a save, a new Trainer that resumes and 2
    more, from the same period-2 stream (a trainer restarts its stream on
    resume, as the JAX package's does). Under AdamW (gated within 1e-5 of
    the params; whether the bits agree is printed), then under adafactor,
    gated bit for bit: losses, both modules' params, both optimizers'
    state (counts, factored moments, bf16 momentum) and the noise
    generator."""
    import itertools

    import torch

    from titok_tpu_torch.config import load_config
    from titok_tpu_torch.models.blocks import PackedEncoder
    from titok_tpu_torch.training.trainer import Trainer, synthetic_batches

    def two(config, eval=False, seed=0):
        if eval:
            return synthetic_batches(config, eval=True, seed=seed)
        return itertools.cycle(list(itertools.islice(synthetic_batches(config, seed=seed), 2)))

    def run(name, **over):
        # LPIPS off: a trainer draws its plans from seed + 1 again on resume
        # (as JAX's does), so the resumed run's plans differ from the
        # straight run's
        cfg = load_config(TINY16K, tiny16k_overrides(name, **{
            "tokenizer.losses.perceptual_weight": 0,
            "training.main.precision": "32", "training.sampling.train_seq_len": 2048,
            "training.eval.eval_step_interval": 0, "general.checkpoints.save_interval": 0,
            **over}))
        trainer = Trainer(cfg, batches_fn=two)
        ls = trainer.loss_system
        ls.disc_model = PackedEncoder(
            model_size=cfg.discriminator.model.model_size, patch_size=ls.patch_size,
            in_channels=3, out_channels=1, dtype=torch.float32, attn_impl="flash_v1")
        gens = []  # the noise generator's state before each step
        make = trainer.builder.make_train_step

        def recording_make():
            step = make()

            def recording(state, *args, **kw):
                gens.append((state.step, state.noise_gen.get_state().clone()))
                return step(state, *args, **kw)

            return recording

        trainer.builder.make_train_step = recording_make
        state = trainer.fit()
        torch.cuda.synchronize()
        rows = {r["step"]: r for r in _jsonl(name) if "train/gen/total_loss" in r}
        return state, rows, dict(gens)

    reset_counts()  # the f32 main path: the straight run, read right after it
    straight, s_rows, s_gens = run("f32_straight", **{"training.main.max_steps": 4})
    paths = {"train_v1_f32": read_counts()}
    _, a_rows, _ = run("f32_resumed", **{"training.main.max_steps": 2})
    resumed, b_rows, b_gens = run("f32_resumed", **{
        "training.main.max_steps": 4, "general.checkpoints.resume_from_checkpoint": True})
    got = {**a_rows, **b_rows}
    check(sorted(got) == sorted(s_rows) == [0, 1, 2, 3], f"logged steps {sorted(got)}")
    pairs = [(got[s][k], s_rows[s][k]) for s in s_rows for k in s_rows[s]
             if k.startswith("train/") and ("loss" in k or "penalty" in k)]
    labs = max(abs(a - b) for a, b in pairs)
    lok = all(abs(a - b) <= 1e-6 + 1e-4 * abs(b) for a, b in pairs)
    pmax = max(p.abs().max().item() for p in straight.model.parameters())
    perr = max((a - b).abs().max().item() for a, b in
               zip(resumed.model.parameters(), straight.model.parameters()))
    dmax = max(p.abs().max().item() for p in straight.disc_model.parameters())
    derr = max((a - b).abs().max().item() for a, b in
               zip(resumed.disc_model.parameters(), straight.disc_model.parameters()))
    noise_ok = all(torch.equal(b_gens[s], s_gens[s]) for s in (2, 3)) and \
        torch.equal(resumed.noise_gen.get_state(), straight.noise_gen.get_state())
    k32 = paths["train_v1_f32"]
    print(f"f32 resume, tiny_fsq16k flash_v1 S=2048 [{card}]: 4 steps straight vs 2 + save + "
          f"resume + 2: losses max|diff| {labs:.3e} over {len(pairs)} values (gate 1e-6 + 1e-4 "
          f"relative); generator params max|diff| {perr:.3e} of max|p| {pmax:.3e}, discriminator "
          f"{derr:.3e} of {dmax:.3e} (gate 1e-5 x max|p|); R1/R2 noise generator state before steps "
          f"2 and 3 and at the end equal: {noise_ok}; straight-run launches "
          f"{ {k: v for k, v in k32.items() if v} }")
    check(lok, "the resumed f32 run's losses disagree with the straight run's")
    check(perr <= 1e-5 * pmax and derr <= 1e-5 * dmax, "the resumed f32 params disagree")
    check(noise_ok, "the R1/R2 noise after resume differs from the straight run's")
    n = TRAIN_LAUNCHES["tiny"]
    want = {**{k: 0 for k in k32}, "v1_f32": 4 * n, "v1_bwd_dq_f32": 4 * n,
            "v1_bwd_dkv_f32": 4 * n}
    check(k32 == want, f"f32 trainer launches {k32}, want {want}")
    bits = _bitwise_equal(resumed, straight)
    print(f"f32 resume under AdamW, bit for bit: losses {all(a == b for a, b in pairs)}, "
          f"{bits} (printed, not gated)")

    af = {"optimizer.name": "adafactor"}
    af_straight, s_rows, _ = run("f32_af_straight", **af, **{"training.main.max_steps": 4})
    _, a_rows, _ = run("f32_af_resumed", **af, **{"training.main.max_steps": 2})
    af_resumed, b_rows, _ = run("f32_af_resumed", **af, **{
        "training.main.max_steps": 4, "general.checkpoints.resume_from_checkpoint": True})
    got = {**a_rows, **b_rows}
    check(sorted(got) == sorted(s_rows) == [0, 1, 2, 3], f"adafactor logged steps {sorted(got)}")
    same_rows = all(got[st][k] == s_rows[st][k] for st in s_rows for k in s_rows[st]
                    if k.startswith("train/"))
    bits = _bitwise_equal(af_resumed, af_straight)
    kinds = {type(o).__name__ for o in (af_straight.gen_opt, af_straight.disc_opt)}
    print(f"f32 resume under adafactor, tiny_fsq16k flash_v1 S=2048 [{card}]: 4 steps straight "
          f"vs 2 + save + resume + 2, bit for bit: logged values {same_rows}, {bits}; "
          f"optimizers {sorted(kinds)}")
    check(kinds == {"Adafactor"}, f"the adafactor runs stepped {kinds}")
    check(same_rows and all(bits.values()),
          "the resumed adafactor run is not bit for bit the straight one")
    return paths


# ---------------------------------------------------------------------------
# The data layer: the host libraries (native/), the packer and the wires,
# and the readers of the shipped configs' data (the eval-set tars, a CSV)
# ---------------------------------------------------------------------------

TINY = os.path.join(REPO, "configs", "tiny.yaml")
TARS = os.path.join(EVAL_SET, "{00000..00002}.tar")
# seeded uint8 clips for the packer gate, THWC: the odd ones leave a
# remainder in each dim that patch (4, 8, 8) cuts off
PACK_GATE_DIMS = [(8, 128, 128), (16, 168, 168), (9, 131, 165), (13, 141, 133)]


def u8_clip_batches(config, eval: bool = False, seed: int = 0):
    """Seeded uint8 THWC clips, each dim drawn between ``min_grid`` and
    ``max_grid`` in patch steps, through the packer in the config's wire
    dtype: the decoder's output layout without a decoder. Endless in
    training; ``eval_samples`` clips and the partial last batch in eval."""
    import itertools

    from titok_tpu_torch.data.packing import Packer, wire_dtype

    cs = config.training.sampling
    rng = np.random.default_rng(seed)
    stream = _u8_stream(config, rng)
    if eval:
        stream = itertools.islice(stream, int(config.training.eval.eval_samples))
    return Packer(seq_len=int(cs.eval_seq_len if eval else cs.train_seq_len),
                  token_range=cs.token_range, patch_size=list(config.tokenizer.model.patch_size),
                  min_grid=cs.min_grid, rng=rng, dtype=wire_dtype(config),
                  flush_final=eval)(stream)


def _u8_stream(config, rng: np.random.Generator):
    """The clips of :func:`u8_clip_batches`, drawn from ``rng``."""
    cs = config.training.sampling
    ps = list(config.tokenizer.model.patch_size)
    while True:
        dims = [int(rng.integers(lo // p, hi // p + 1)) * p
                for lo, hi, p in zip(cs.min_grid, cs.max_grid, ps)]
        yield {"video": rng.integers(0, 256, size=dims + [3], dtype=np.uint8), "fps": 4}


def _data_packer(card: str) -> None:
    """The fused packer against its plain version, bit for bit; packing ms
    a 6144-row tiny batch on each wire, fused and plain; H2D bytes and ms a
    batch on each wire; on the card, ``decode_rows`` of the uint8 rows
    against the host's f32 rows of the same clips, bit for bit."""
    import itertools

    import torch

    from titok_tpu_torch.data import packing
    from titok_tpu_torch.data.video_reader import patchify_normalize
    from titok_tpu_torch.ops.patchify import decode_rows

    rng = np.random.default_rng(11)
    for dims in PACK_GATE_DIMS:
        clip = rng.integers(0, 256, size=dims + (3,), dtype=np.uint8)
        got = patchify_normalize(clip, (4, 8, 8))
        cut = clip[: dims[0] // 4 * 4, : dims[1] // 8 * 8, : dims[2] // 8 * 8]
        want = packing.patchify_normalize_reference(cut, (4, 8, 8))
        check(got.shape == want.shape and np.array_equal(got.view(np.uint32),
                                                         want.view(np.uint32)),
              f"pk_patchify_normalize != its plain version at {dims}")
    print(f"data: pk_patchify_normalize equals its plain version (decode_rows of the byte "
          f"shuffle) bit for bit on {len(PACK_GATE_DIMS)} seeded uint8 clips "
          f"{PACK_GATE_DIMS} at patch (4, 8, 8)")

    wires = {"f32": {"training.main.precision": "32"}, "bf16": {},
             "uint8": {"dataset.uint8_wire": "true"}}
    cfg = train_config()
    clips = [s["video"] for s in itertools.islice(_u8_stream(cfg, np.random.default_rng(12)), 40)]
    ps = list(cfg.tokenizer.model.patch_size)
    batches = {}
    for wire, over in wires.items():
        c = train_config(**over)
        dtype = packing.wire_dtype(c)
        for impl in ("fused", "plain"):
            if wire == "uint8" and impl == "plain":
                continue  # the uint8 wire is a byte shuffle: no packer
            packer = packing.Packer(seq_len=6144, token_range=c.training.sampling.token_range,
                                    patch_size=ps, min_grid=c.training.sampling.min_grid,
                                    rng=np.random.default_rng(13), dtype=dtype)
            fused = packing.patchify_normalize
            if impl == "plain":
                packing.patchify_normalize = packing.patchify_normalize_reference
            try:
                t0 = time.perf_counter()
                out = list(packer({"video": v, "fps": 4} for v in clips))
                ms = (time.perf_counter() - t0) * 1e3 / len(out)
            finally:
                packing.patchify_normalize = fused
            batches.setdefault(wire, out)
            print(f"data: packing [{card}, host clock] {wire} wire, {impl} packer: {ms:.3f} ms "
                  f"a 6144-row batch ({len(out)} batches of {sum(b.num_samples for b in out)} "
                  f"uint8 clips, tiny sampling)")
    for wire, out in batches.items():
        host = packing.host_tensors(out[0])
        pinned = {k: v.pin_memory() for k, v in host.items()}
        nbytes = sum(v.numel() * v.element_size() for v in pinned.values())
        pbytes = pinned["patches"].numel() * pinned["patches"].element_size()

        def copy():
            return [v.to("cuda", non_blocking=True) for v in pinned.values()]

        ms = cuda_ms(copy, reps=20)
        print(f"data: H2D [{card}, CUDA events] {wire} wire: {nbytes} bytes a batch "
              f"({pbytes} of patch rows, {pinned['patches'].dtype}), {ms:.4f} ms from pinned "
              f"memory ({nbytes / ms / 1e6:.2f} GB/s)")

    # the uint8 rows decoded on the card against the host's f32 rows
    b8, b32 = batches["uint8"][0], batches["f32"][0]
    check(np.array_equal(b8.segment_ids, b32.segment_ids), "the wires packed other layouts")
    slots = (~b8.token_mask) & (b8.segment_ids > 0)
    dev = decode_rows(packing.to_device(b8, "cuda")["patches"], torch.float32).cpu().numpy()
    same = np.array_equal(dev[slots].view(np.uint32), b32.patches[slots].view(np.uint32))
    print(f"data: decode_rows of the uint8 rows on the card == the host's f32 rows (fused "
          f"packer), bit for bit at the {int(slots.sum())} patch rows: {same}")
    check(same, "decode_rows on the card differs from the host's f32 rows")



def _data_wire_steps(card: str) -> None:
    """At precision 32 (the discriminator in f32 too, LPIPS off: cuDNN's
    backward is not bit-reproducible), the same 3 batches of uint8 clips on
    the uint8 and the f32 wire, from the same weights and noise: the first
    step's generator grads and the 3 steps' losses must be identical."""
    import itertools

    import torch

    from titok_tpu_torch.data.packing import build_disc_batch
    from titok_tpu_torch.losses.loss_module import DISC_TOKENS

    over = {"training.main.precision": "32", "training.sampling.train_seq_len": 2048,
            "optimizer.warmup_steps": 2, "tokenizer.losses.perceptual_weight": 0,
            "tokenizer.losses.gram_weight": 0}
    runs = {}
    for wire, w_over in (("f32", {}), ("uint8", {"dataset.uint8_wire": "true"})):
        cfg = train_config(**over, **w_over)
        batches = [(b, build_disc_batch(b, DISC_TOKENS), None)
                   for b in itertools.islice(u8_clip_batches(cfg, seed=21), 3)]
        noise_gen = torch.Generator(device="cuda").manual_seed(3)
        noises = [torch.randn(d.segment_ids.shape[0], b.patches.shape[1], generator=noise_gen,
                              device="cuda") for b, d, _ in batches]
        builder, st, stp = _trainer(cfg, f32_disc=True)
        bt, dt_, _ = _on_card(batches[0])
        check(bt["patches"].dtype == (torch.uint8 if wire == "uint8" else torch.float32),
              f"{wire} wire: patch rows in {bt['patches'].dtype}")
        recon, _ = st.model(bt)
        grads = torch.autograd.grad(builder.loss_system.generator_loss(recon, bt, dt_)[0],
                                    list(st.model.parameters()))
        losses = []
        for triple, noise in zip(batches, noises):
            st, m, _ = stp(st, *_on_card(triple), noise=noise)
            losses.append({k: float(v) for k, v in m.items() if "loss" in k or "penalty" in k})
        torch.cuda.synchronize()
        runs[wire] = (batches, grads, losses)
        del builder, st, stp, recon
        torch.cuda.empty_cache()
    (b_f, g_f, l_f), (b_8, g_8, l_8) = runs["f32"], runs["uint8"]
    check(all(np.array_equal(x[0].segment_ids, y[0].segment_ids) for x, y in zip(b_f, b_8)),
          "the wires packed other layouts")
    gdiff = max((a - b).abs().max().item() for a, b in zip(g_8, g_f))
    gsame = all(torch.equal(a, b) for a, b in zip(g_8, g_f))
    pairs = [(l_8[i][k], l_f[i][k]) for i in range(3) for k in l_f[i]]
    ldiff = max(abs(a - b) for a, b in pairs)
    print(f"data: uint8 wire vs f32 wire [{card}], precision 32, S=2048, the same 3 batches of "
          f"uint8 clips, weights and noise: first step's generator grads identical {gsame} "
          f"(max|diff| {gdiff:.3e}); losses of 3 steps max|diff| {ldiff:.3e} over {len(pairs)} "
          f"values (gate: identical)")
    for i in range(3):
        print(f"  step {i}: uint8 {l_8[i]}")
    check(gsame and ldiff == 0, "the uint8 wire's step differs from the f32 wire's")


def _data_fit(card: str, run: str, batches_fn, **over) -> tuple[dict, dict, float]:
    """``Trainer(cfg).fit()`` of configs/tiny.yaml (its loss, random VGG
    weights) for 6 steps with an eval at 6 over 16 clips, into
    ``RUN_DIR/<run>``: launches per step (rows 1-2 bf16, 16 each), finite
    losses, a positive perceptual loss, device PSNR/SSIM written. Returns
    the fit's launch counts, its rows, and its tokens/s (steps 2-5)."""
    import shutil

    import torch

    from titok_tpu_torch.training.trainer import Trainer

    shutil.rmtree(os.path.join(RUN_DIR, run), ignore_errors=True)
    cfg = train_config(**{"training.main.max_steps": 6, "training.eval.eval_step_interval": 6,
                          "training.eval.eval_samples": 16, "general.wandb.log_step_interval": 1,
                          "general.checkpoints.save_path": os.path.join(RUN_DIR, run), **over})
    trainer = Trainer(cfg, batches_fn=batches_fn)
    per_step = []
    _count_steps(trainer, per_step)
    reset_counts()  # this path: the whole fit, read right after it
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    total = read_counts()
    n = TRAIN_LAUNCHES["tiny"]
    want = {**{k: 0 for k in total}, "bf16": n, "bwd_dq_bf16": n, "bwd_dkv_bf16": n}
    check(len(per_step) == 6, f"{run}: {len(per_step)} train steps, want 6")
    for i, got in enumerate(per_step):
        check(got == want, f"{run} step {i}: launches {got}, want {want}")
    rows = _jsonl(run)
    train_rows = [r for r in rows if "train/gen/total_loss" in r]
    check([r["step"] for r in train_rows] == list(range(6)), f"{run}: a step was not logged")
    for r in train_rows:
        vals = {k: v for k, v in r.items() if k.startswith("train/")}
        check(all(np.isfinite(v) for v in vals.values()), f"{run} step {r['step']}: {vals}")
        check(vals.get("train/gen/perceptual_loss", 0) > 0, f"{run}: no perceptual loss")
    evals = [r for r in rows if "eval/psnr" in r]
    check([r["step"] for r in evals] == [6] and "eval/ssim" in evals[0]
          and np.isfinite(evals[0]["eval/psnr"]), f"{run}: eval rows {evals}")
    tps = float(np.mean([r["perf/tokens_per_sec"] for r in train_rows[2:]]))
    print(f"data: fit {run} [{card}] (configs/tiny.yaml, bf16-mixed, S 6144, LPIPS on): 6 steps "
          f"in {fit_s:.2f} s, {tps:.0f} tokens/s (perf/tokens_per_sec, steps 2-5); launches per "
          f"step {per_step[0]['bf16']} forward, {per_step[0]['bwd_dq_bf16']} dq, "
          f"{per_step[0]['bwd_dkv_bf16']} dk/dv; losses "
          + ", ".join(f"{r['train/gen/total_loss']:.5g}" for r in train_rows)
          + f"; eval psnr {evals[0]['eval/psnr']:.4f} dB, ssim {evals[0]['eval/ssim']:.5f}")
    del trainer
    torch.cuda.empty_cache()
    return total, rows, tps


def _data_real_clips(card: str, synth_tps: float) -> dict:
    """With libav: decode and chunk ms a clip over the 160 eval-set clips
    at 0 and 3 decode threads, the decode hashes, ``Trainer.fit`` of
    configs/tiny.yaml on the tars (bf16 and uint8 wire), configs/tiny_csv.yaml
    on a CSV of clips taken from one tar, the converter, and the CLI."""
    import itertools
    import shutil

    from titok_tpu_torch.config import load_config
    from titok_tpu_torch.data.chunking import clip_chunks, resize_center_crop
    from titok_tpu_torch.data.convert_to_wds import convert
    from titok_tpu_torch.data.video_reader import VideoReader
    from titok_tpu_torch.data.wds_dataset import expand_shards, tarfile_to_samples, wds_batches
    from titok_tpu_torch.data.workers import WorkerPool

    got = eval_set_sha256(tarfile_to_samples, VideoReader, resize_center_crop)
    for key, (frames_h, crop_h) in got.items():
        print(f"data: decode hash {key}: frames {frames_h[:16]}.. (the CPU pin's: "
              f"{frames_h == EVAL_SET_SHA256[key][0]}), 128x128 crop {crop_h[:16]}.. ("
              f"{crop_h == EVAL_SET_SHA256[key][1]})")
    print(f"data: this machine's libav decodes the eval set to the CPU pins' bits: "
          f"{got == EVAL_SET_SHA256} (printed, not gated)")

    cs = train_config().training.sampling
    shards = expand_shards(TARS)

    def chunks_of(paths, seed):
        rng = np.random.default_rng(seed)
        for p in paths:
            for s in tarfile_to_samples(p):
                yield sum(1 for _ in clip_chunks(s["mp4"], cs, [4, 8, 8], rng, False))

    for workers in (0, 3):
        t0 = time.perf_counter()
        if workers:
            counts = list(WorkerPool([lambda w=w: chunks_of(shards[w::3], w) for w in range(3)]))
        else:
            counts = list(chunks_of(shards, 0))
        ms = (time.perf_counter() - t0) * 1e3 / len(counts)
        print(f"data: decode + chunk + resize [{card} host, host clock], {workers} threads: "
              f"{ms:.3f} ms a clip over {len(counts)} clips, {sum(counts)} chunks (tiny sampling)")
        check(len(counts) == 160, f"{len(counts)} eval-set clips, want 160")

    paths = {}
    data = {"dataset.train_dataset": TARS, "dataset.eval_dataset": TARS}
    for wire, over in (("bf16", {}), ("uint8", {"dataset.uint8_wire": "true"})):
        paths[f"train_data_{wire}"], _, tps = _data_fit(card, f"data_tars_{wire}", None,
                                                        **data, **over)
        print(f"data: tokens/s on the eval-set tars, {wire} wire: {tps:.0f} against "
              f"{synth_tps:.0f} on synthetic float clips")

    tmp = os.path.join(RUN_DIR, "data_clips")
    for d in (tmp, os.path.join(RUN_DIR, "data_csv"), os.path.join(RUN_DIR, "data_cli")):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(os.path.join(tmp, "mp4"))
    for s in itertools.islice(tarfile_to_samples(os.path.join(EVAL_SET, "00000.tar")), 8):
        with open(os.path.join(tmp, "mp4", f"{s['__key__']}.mp4"), "wb") as f:
            f.write(s["mp4"])
    csv_path = os.path.join(tmp, "clips.csv")
    with open(csv_path, "w") as f:
        f.write("path\n" + "".join(os.path.join(tmp, "mp4", n) + "\n"
                                   for n in sorted(os.listdir(os.path.join(tmp, "mp4")))))
    from titok_tpu_torch.training.trainer import Trainer

    csv_cfg = load_config(os.path.join(REPO, "configs", "tiny_csv.yaml"), [
        f"dataset.train_dataset={csv_path}", f"dataset.eval_dataset={csv_path}",
        "tokenizer.losses.allow_random_lpips=true", "training.main.max_steps=2",
        "training.eval.eval_step_interval=2", "training.eval.eval_samples=4",
        "general.wandb.log_step_interval=1",
        f"general.checkpoints.save_path={os.path.join(RUN_DIR, 'data_csv')}"])
    Trainer(csv_cfg).fit()
    rows = _jsonl("data_csv")
    check([r["step"] for r in rows if "train/gen/total_loss" in r] == [0, 1]
          and all(np.isfinite(r["train/gen/total_loss"]) for r in rows
                  if "train/gen/total_loss" in r)
          and any("eval/psnr" in r for r in rows), f"CSV run rows {rows}")
    print(f"data: configs/tiny_csv.yaml on a CSV of 8 eval-set clips: 2 steps, losses "
          + ", ".join(f"{r['train/gen/total_loss']:.5g}" for r in rows
                      if "train/gen/total_loss" in r))

    n = convert(os.path.join(tmp, "mp4"), os.path.join(tmp, "shards"), shard_size=4)
    check(n == 8, f"converter wrote {n} samples, want 8")
    conv_cfg = train_config(**{"dataset.train_dataset":
                               os.path.join(tmp, "shards", "{00000..00001}.tar")})
    b = next(iter(wds_batches(conv_cfg, seed=0)))
    check(b.num_samples >= 1, "no clip read back from the converter's shards")
    print(f"data: convert_to_wds wrote 8 clips into 2 shards; wds_batches read back a batch of "
          f"{b.num_samples} clips")

    p = _cli([f"config={TINY}", f"dataset.train_dataset={TARS}", f"dataset.eval_dataset={TARS}",
              "tokenizer.losses.allow_random_lpips=true", "training.main.max_steps=3",
              "training.eval.eval_step_interval=0", "general.checkpoints.save_interval=0",
              "general.wandb.log_step_interval=1",
              f"general.checkpoints.save_path={os.path.join(RUN_DIR, 'data_cli')}"])
    try:
        out, _ = p.communicate(timeout=600)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    steps = [r["step"] for r in _jsonl("data_cli") if "train/gen/total_loss" in r]
    check(p.returncode == 0 and steps == [0, 1, 2], f"CLI on the tars: exit {p.returncode}, "
          f"steps {steps}:\n{out[-3000:]}")
    print("data: python -m titok_tpu_torch.train on the eval-set tars: 3 steps, exit 0")
    return paths


def phase_data(card: str) -> dict:
    """The data layer on this machine. One probe of libav (pkg-config)
    decides what runs: everywhere, the ``pack`` library's packer against its
    plain version, packing and H2D on each wire, the uint8 wire decoded on
    the card against the host's f32 rows, the uint8 and f32 wires' steps,
    ``tarfile_to_samples`` over the eval-set tars against their manifest,
    and ``Trainer.fit`` of configs/tiny.yaml on the bf16 and the uint8 wire
    (and on synthetic clips, for the rate). With libav, the fits read the
    eval-set tars and :func:`_data_real_clips` runs; without it, they read
    seeded uint8 clips, and constructing a ``VideoReader`` must raise."""
    import hashlib

    from titok_tpu_torch.data import _native
    from titok_tpu_torch.data.video_reader import VideoReader
    from titok_tpu_torch.data.wds_dataset import tarfile_to_samples
    from titok_tpu_torch.training.trainer import synthetic_batches

    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True)
    print(f"data: {gxx.stdout.splitlines()[0] if gxx.returncode == 0 else 'no g++'}")
    try:
        versions = _native.libav_versions()
    except _native.NativeLibraryError as e:
        versions = None
        print(f"data: libav absent on this machine: {' '.join(str(e).split())}")
    else:
        print(f"data: libav found: {versions}")
    # the pack library may have been built earlier in this run (the serving
    # phase's uint8 encode packs through it)
    names = ("pack",) if versions is None else ("pack", "av")
    for name in names:
        _native.load(name)  # a build failure here fails the run
        print(f"data: the {name} library: g++ took {_native.build_seconds[name]:.2f} s at its "
              f"first load in this run (0: found built under build/native)")

    _data_packer(card)
    _data_wire_steps(card)

    with open(os.path.join(EVAL_SET, "MANIFEST.json")) as f:
        manifest = json.load(f)["clips"]
    t0 = time.perf_counter()
    seen = {}
    for shard in ("00000", "00001", "00002"):
        for s in tarfile_to_samples(os.path.join(EVAL_SET, f"{shard}.tar")):
            seen[f"{shard}.tar::{s['__key__']}.mp4"] = hashlib.sha256(s["mp4"]).hexdigest()
    print(f"data: tarfile_to_samples over the eval-set tars: {len(seen)} clips in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms, bytes equal to MANIFEST.json's hashes: "
          f"{seen == manifest}")
    check(seen == manifest, "the eval-set tars read back other clips than MANIFEST.json lists")

    paths = {}
    _, _, synth_tps = _data_fit(card, "data_synthetic", synthetic_batches)
    if versions is None:
        try:
            VideoReader(os.path.join(EVAL_SET, "00000.tar"))
        except _native.NativeLibraryError as e:
            print(f"data: VideoReader raises without libav: {' '.join(str(e).split())[:160]}")
        else:
            raise SmokeFailure("VideoReader opened without libav")
        print("data: decode and chunk ms a clip, the decode hashes, the fits on the tars, the "
              "CSV run, the converter and the CLI on the tars: not measured (no libav)")
        for wire, over in (("bf16", {}), ("uint8", {"dataset.uint8_wire": "true"})):
            paths[f"train_data_{wire}"], _, tps = _data_fit(
                card, f"data_u8clips_{wire}", u8_clip_batches, **over)
            print(f"data: tokens/s on seeded uint8 clips, {wire} wire: {tps:.0f} against "
                  f"{synth_tps:.0f} on synthetic float clips")
    else:
        paths.update(_data_real_clips(card, synth_tps))
    return paths


# the trained checkpoint's parity fixtures (tests/torch_parity_fixtures.py
# writes them on a machine with JAX, orbax and libav; the card machine has
# none of the three): the converted generator, the first eval clips of
# docs/eval_set/00000.tar as uint8 THWC chunks, and JAX's f32, w8a16 and
# w8a8 results
R4 = os.path.join(REPO, "docs", "runs", "r4_tiny_lpips", "config.yaml")
PARITY_DIR = os.path.join(REPO, "docs", "artifacts", "r4_tiny_lpips_5000_torch")
PARITY_SHA256 = {
    "5000/state.pt": "f10ffa31504c398573974bb1105d29cf3a3095165ec1a84ab37fa55950d30006",
    "eval_clips.npz": "d795b3521b3ee8122d8a90fdca20d6a15f8fd6e18760cd89db700b382b9ea4c9",
    "jax_f32.npz": "d60e63a8203bf9b69dd3bc4562156ca7c1c25381ddca8bc15e91760a0f4f28b3",
    "jax_w8a16.npz": "50b11f7a7a047112345ff6b66039d63c042309efc21d3143b5b160660c4a9924",
    "jax_w8a8.npz": "713af50a4c77ddd1fbb8aa51ef5fa6e491b8eb3d79c4c3baa7a2abb6126be23e",
}
PARITY_STEP = 5000
PARITY_COUNTS = (1, 16, 128)
# f32 kernel path against JAX's committed f32 results: indices identical on
# >= 99.9 % of tokens and every miss a near tie (JAX's value FSQ rounds
# within NEAR_TIE of its rounding boundary); PSNR within 0.01 dB, SSIM 1e-3
PARITY_SHARE = 0.999
NEAR_TIE = 1e-4
PARITY_PSNR_DB = 0.01
PARITY_SSIM = 1e-3
# bf16-mixed scores against f32's on the same clips. bf16 rounds weights
# and activations to 8-bit mantissas and moves about 3 % of the indices at
# 128 tokens; the first card run moved PSNR by at most 0.0192 dB and SSIM
# by 4.0e-4 (1, 16, 128 tokens; the CPU's plain bf16 path 0.0213 dB), so
# the bounds are 5x those: room for the rounding, yet a twentieth of the
# 2 dB between 16 and 128 tokens
BF16_EVAL_PSNR_DB = 0.1
BF16_EVAL_SSIM = 2e-3


def r4_overrides(run: str, **over) -> list[str]:
    """The r4 config as the parity phase scores it: f32, the committed
    clips' count of eval samples, the losses off (as the evaluate CLI
    switches them off), no recon videos, no train probe, into
    ``RUN_DIR/<run>``."""
    base = {"training.main.precision": 32, "training.eval.eval_samples": 10,
            "tokenizer.losses.disc_weight": 0.0, "tokenizer.losses.perceptual_weight": 0.0,
            "tokenizer.losses.gram_weight": 0.0, "training.eval.log_recon_num": 0,
            "training.eval.train_probe_dataset": "null",
            "general.checkpoints.save_path": os.path.join(RUN_DIR, run), **over}
    return [f"{k}={v}" for k, v in base.items()]


def _sha256(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def clip_batches(clips: list):
    """A ``batches_fn`` over decoded clips: the readers' eval packer
    (``pack_chunks``) fed from a list, so the card needs no decoder."""
    from titok_tpu_torch.data.chunking import pack_chunks

    def batches_fn(config, eval: bool = False, seed: int = 0):
        return pack_chunks(config, iter(clips), np.random.default_rng(seed), eval)

    return batches_fn


def _r4_scorer(clips: list, run: str, quant: str | None = None, **over):
    """A ``Trainer`` of the r4 config over ``clips`` with the committed
    weights, its eval step (with ``quant``, the int8 generator's, as the
    evaluate CLI's ``quantize_eval`` sets it) wrapped to keep each batch's
    outputs."""
    from titok_tpu_torch.config import load_config
    from titok_tpu_torch.tools.evaluate import quantize_eval
    from titok_tpu_torch.train_utils.checkpoints import restore_weights_only
    from titok_tpu_torch.training.trainer import Trainer

    cfg = load_config(R4, r4_overrides(run, **over))
    trainer = Trainer(cfg, batches_fn=clip_batches(clips))
    report = {}
    state = restore_weights_only(os.path.join(PARITY_DIR, str(PARITY_STEP)),
                                 trainer.builder.init_state(), verbose=False, report=report)
    check(report["loaded"] == 76 and not report["missing"] and not report["mismatched"],
          f"the committed weights loaded as {report}")
    quantize_eval(trainer, state, quant)
    step = trainer._eval_step or trainer.builder.make_eval_metrics_step(trainer.device_im)
    return trainer, state, _keep_outputs(trainer, step)


def _keep_outputs(trainer, step) -> list:
    """Make ``step`` ``trainer``'s eval step, wrapped to keep each batch's
    ``(token count, batch, outputs)`` in the list it returns."""
    seen = []

    def eval_step(batch, plan=None):
        out = step(batch, plan)
        seen.append((int(trainer.config.training.sampling.token_range[0]), batch, out))
        return out

    trainer._eval_step = eval_step
    return seen


def _indices_of(seen, count: int, n_clips: int) -> np.ndarray:
    """``[clips, count]`` indices of the eval epoch at ``count`` tokens,
    from the eval step's kept batches and outputs."""
    out = []
    for c, batch, (_, indices, _) in seen:
        if c != count:
            continue
        tc, gs = batch["token_counts"].cpu().numpy(), batch["grid_sizes"].cpu().numpy()
        offs = np.concatenate([[0], np.cumsum(tc + gs)])
        ix = indices.cpu().numpy()
        out += [ix[offs[b]: offs[b] + tc[b]] for b in range(int(batch["sample_valid"].sum()))]
    check(len(out) == n_clips and all(len(x) == count for x in out),
          f"{len(out)} clips of indices at {count} tokens")
    return np.stack(out)


def _near_tie_gate(got: np.ndarray, want: np.ndarray, prebound: np.ndarray, what: str) -> str:
    """Indices against JAX's: the share identical and the largest distance
    of a miss from its rounding boundary; fails below ``PARITY_SHARE`` or on
    a miss that is not a near tie."""
    miss = got != want
    dist = np.abs(np.abs(prebound - np.floor(prebound)) - 0.5).min(axis=-1)
    share = 1.0 - float(miss.mean())
    worst = float(dist[miss].max()) if miss.any() else 0.0
    check(share >= PARITY_SHARE, f"{what}: {share * 100:.3f} % of indices equal JAX's")
    check(worst <= NEAR_TIE, f"{what}: a miss lies {worst:.3e} from its rounding boundary, "
          f"more than {NEAR_TIE:g}")
    return (f"{share * 100:.3f} % identical ({int(miss.sum())} of {miss.size} differ; largest "
            f"distance of a miss from its boundary {worst:.3e}; nearest committed value to a "
            f"boundary {float(dist.min()):.3e})")


def phase_parity(card: str) -> dict:
    """The trained tiny checkpoint on the card against JAX's committed f32
    results: the evaluate CLI's sweep (``token_sweep``) over the committed
    clips at 1, 16 and 128 tokens through the f32 kernels, then the plain
    path (dense attention) and bf16-mixed (the config's precision) through
    the bf16 kernel."""
    import torch

    from titok_tpu_torch.tools.evaluate import token_sweep

    for rel, want in PARITY_SHA256.items():
        path = os.path.join(PARITY_DIR, rel)
        check(os.path.exists(path), f"parity fixture {rel} is missing")
        got = _sha256(path)
        check(got == want, f"parity fixture {rel}: sha256 {got}, want {want}")
    print(f"parity: the {len(PARITY_SHA256)} fixtures under {os.path.relpath(PARITY_DIR, REPO)} "
          "match their sha256 pins")
    with np.load(os.path.join(PARITY_DIR, "eval_clips.npz")) as f:
        clips = [{"video": f[f"clip_{i}"], "fps": int(fps)} for i, fps in enumerate(f["fps"])]
    with np.load(os.path.join(PARITY_DIR, "jax_f32.npz")) as f:
        jax = dict(f)

    paths = {}
    kernel, state, seen = _r4_scorer(clips, "parity_f32")
    sweep = os.path.join(RUN_DIR, "parity_f32", "token_sweep.jsonl")
    reset_counts()  # this path: the f32 sweep, read right after it
    rows = token_sweep(kernel, state, PARITY_STEP, PARITY_COUNTS, sweep)
    paths["eval_r4_f32"] = read_counts()
    n_batches = len(seen) // len(PARITY_COUNTS)
    want = {**{k: 0 for k in paths["eval_r4_f32"]}, "f32": 8 * len(seen)}
    check(paths["eval_r4_f32"] == want, f"f32 sweep launches {paths['eval_r4_f32']}, want {want}"
          f" (4 + 4 forwards a batch, {len(seen)} batches)")
    with open(sweep) as f:
        written = [json.loads(line) for line in f]
    check(written == rows and [r["token_count"] for r in rows] == list(PARITY_COUNTS)
          and all(set(r) == {"step", "token_count", "quant", "eval/psnr", "eval/ssim"}
                  for r in rows), f"token_sweep.jsonl rows {written}")
    print(f"parity: docs/runs/r4_tiny_lpips/config.yaml at precision 32 on {len(clips)} committed "
          f"clips, {n_batches} batches of eval_seq_len 4096 a count; the evaluate CLI's "
          f"token_sweep through the f32 kernel: {paths['eval_r4_f32']['f32']} row 1 f32 launches "
          f"(8 a batch); token_sweep.jsonl {len(written)} rows")
    scores = {}
    for r in rows:
        c = r["token_count"]
        kernel_ix = _indices_of(seen, c, len(clips))
        line = _near_tie_gate(kernel_ix, jax[f"indices_{c}"], jax[f"prebound_{c}"], f"f32 at {c}")
        dp, ds = r["eval/psnr"] - float(jax[f"psnr_{c}"]), r["eval/ssim"] - float(jax[f"ssim_{c}"])
        check(abs(dp) <= PARITY_PSNR_DB and abs(ds) <= PARITY_SSIM,
              f"f32 at {c} tokens: psnr {r['eval/psnr']:.6f} / ssim {r['eval/ssim']:.6f} against "
              f"JAX's {float(jax[f'psnr_{c}']):.6f} / {float(jax[f'ssim_{c}']):.6f}")
        scores[c] = {"f32": (r["eval/psnr"], r["eval/ssim"]), "ix": kernel_ix}
        print(f"  {c:3d} tokens, f32 kernel: indices against JAX {line}; psnr {r['eval/psnr']:.6f}"
              f" dB (JAX {float(jax[f'psnr_{c}']):.6f}, {dp:+.2e}), ssim {r['eval/ssim']:.6f} "
              f"(JAX {float(jax[f'ssim_{c}']):.6f}, {ds:+.2e})")

    # the plain path on the card (dense attention), same weights and clips
    plain, pstate, pseen = _r4_scorer(clips, "parity_plain",
                                      **{"training.main.attn_impl": "reference"})
    reset_counts()
    for c in PARITY_COUNTS:
        plain.config.set_dotted("training.sampling.token_range", [c, c])
        plain._eval_cache = None
        s = plain.validate(pstate, PARITY_STEP)
        ix = _indices_of(pseen, c, len(clips))
        line = _near_tie_gate(ix, jax[f"indices_{c}"], jax[f"prebound_{c}"], f"plain at {c}")
        same = float((ix == scores[c]["ix"]).mean())
        check(abs(s["eval/psnr"] - float(jax[f"psnr_{c}"])) <= PARITY_PSNR_DB,
              f"plain path at {c}: psnr {s['eval/psnr']}")
        print(f"  {c:3d} tokens, plain path: indices against JAX {line}; against the f32 kernel "
              f"path {same * 100:.3f} % identical; psnr {s['eval/psnr']:.6f} dB, ssim "
              f"{s['eval/ssim']:.6f}")
    check(all(v == 0 for v in read_counts().values()), "the plain path launched a kernel")

    # bf16-mixed, the config's own precision, through row 1's bf16 kernel
    bf16, bstate, bseen = _r4_scorer(clips, "parity_bf16",
                                     **{"training.main.precision": "bf16-mixed"})
    reset_counts()  # this path: the bf16 sweep
    brows = token_sweep(bf16, bstate, PARITY_STEP, PARITY_COUNTS,
                        os.path.join(RUN_DIR, "parity_bf16", "token_sweep.jsonl"))
    paths["eval_r4_bf16"] = read_counts()
    want = {**{k: 0 for k in paths["eval_r4_bf16"]}, "bf16": 8 * len(bseen)}
    check(paths["eval_r4_bf16"] == want, f"bf16 sweep launches {paths['eval_r4_bf16']}, want {want}")
    for r in brows:
        c = r["token_count"]
        ix = _indices_of(bseen, c, len(clips))
        p32, s32 = scores[c]["f32"]
        dp, ds = r["eval/psnr"] - p32, r["eval/ssim"] - s32
        check(np.isfinite(r["eval/psnr"]) and abs(dp) <= BF16_EVAL_PSNR_DB
              and abs(ds) <= BF16_EVAL_SSIM,
              f"bf16 at {c} tokens: psnr {r['eval/psnr']:.6f}, ssim {r['eval/ssim']:.6f} against f32 "
              f"{p32:.6f}, {s32:.6f} (bounds {BF16_EVAL_PSNR_DB} dB, {BF16_EVAL_SSIM})")
        print(f"  {c:3d} tokens, bf16-mixed (bf16 kernel): psnr {r['eval/psnr']:.6f} dB ({dp:+.4f} "
              f"against f32), ssim {r['eval/ssim']:.6f} ({ds:+.5f}); indices equal to f32's "
              f"{float((ix == scores[c]['ix']).mean()) * 100:.3f} %")

    # ms an eval batch on the card (CUDA events), f32 and bf16, at 128 tokens
    from titok_tpu_torch.data.packing import to_device
    from titok_tpu_torch.ops.frames import build_eval_frame_plan

    for name, tr in (("f32", kernel), ("bf16", bf16)):
        tr.config.set_dotted("training.sampling.token_range", [128, 128])
        batches = list(tr.batches_fn(tr.config, eval=True, seed=0))
        step = tr.builder.make_eval_metrics_step(tr.device_im)
        dev = [(to_device(b, "cuda"), to_device(build_eval_frame_plan(
            b, num_frames=tr._eval_kmax, patch_size=tr.patch_size,
            max_grid_hw=tr.max_grid[1:]), "cuda")) for b in batches]
        ms = cuda_ms(lambda: [step(b, p) for b, p in dev], reps=5) / len(dev)
        print(f"parity: eval step {name} [{card}]: {ms:.3f} ms an eval batch of 4096 rows at 128 "
              f"tokens (CUDA events over 5 passes of {len(dev)} batches: model, PSNR and SSIM sums)")
    del kernel, plain, bf16, state, pstate, bstate
    torch.cuda.empty_cache()
    return paths




# the eval metrics' parity fixture (``python tests/torch_parity_fixtures.py
# metrics`` writes it where JAX runs): the JAX package's I3D, V-JEPA-L and
# InceptionV3 features at full width on the seeded weights of
# tests/torch_metric_fixtures.py, over the committed clips and one seeded
# 16x256x320 clip, and JAX's FVD, JEDi, FID, MMD and IS on them
METRICS_SHA256 = {
    "jax_metrics.npz": "ad4e3a539b5113a510475631163611d79610e2579fb0f1d73bd72ab502e5eae9",
}
# features against JAX's: the largest |d| over JAX's largest |x|, per
# network. The port on the CPU shows 7.1e-7 (I3D), 2.3e-6 (V-JEPA-L),
# 2.1e-6 (InceptionV3 activations) and 1.9e-6 (logits); the bound is about
# 5x the worst of them
METRIC_FEATURE_RTOL = 1e-5
# scores from the card's features against JAX's committed scores. FVD and
# FID take sqrtm of a rank-deficient covariance (5 and 6 clips at 400-d;
# 48 and 76 frames at 2048-d), which amplifies feature noise: noise of
# 1e-5 of the largest feature moved FVD by 1.3e-5 relative on the CPU,
# JEDi, FID, MMD by 1.0e-6 to 1.9e-6, IS by 8e-9. Bounds: 1e-3 for FVD and
# FID, 1e-4 for the rest
METRIC_SCORE_RTOL = {"fvd": 1e-3, "fid": 1e-3, "jedi": 1e-4, "mmd": 1e-4, "is": 1e-4}
# the port's host math on JAX's committed features against JAX's committed
# scores (bit for bit on the CPU that wrote them; this machine's scipy and
# BLAS may differ)
METRIC_HOST_RTOL = 1e-6
METRIC_DIR = os.path.join(RUN_DIR, "metrics")


def _metric_fixtures():
    """``tests/torch_metric_fixtures.py`` loaded by its path: the card
    machine has a ``tests`` package of its own installed, which shadows
    the checkout's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_metric_fixtures", os.path.join(REPO, "tests", "torch_metric_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metric_extractors(weights: dict) -> dict:
    """The port's three networks on the card, loaded from the converter
    ``.npz`` files by the port's loaders."""
    from titok_tpu_torch.metrics.i3d import I3DExtractor, load_i3d_params
    from titok_tpu_torch.metrics.inception_v3 import load_inception_extractor
    from titok_tpu_torch.metrics.vjepa import VJEPAExtractor, load_vjepa_params

    return {"i3d": I3DExtractor(load_i3d_params(weights["i3d"]), device="cuda"),
            "vjepa": VJEPAExtractor(load_vjepa_params(weights["vjepa"]), "vit_large",
                                    device="cuda"),
            "inception": load_inception_extractor(weights["inception"], device="cuda")}


def _metric_features(ex: dict, clips: list, clip_frames, only=None) -> tuple[dict, dict]:
    """Each network's features of every clip (InceptionV3 per frame, as
    ``clip_frames`` splits a clip) and its host ms a clip (host clock; each
    call ends in a copy to the host, so the card is done), by network;
    ``only`` names the networks to run."""
    feats, ms = {}, {}
    for name in only or ("i3d", "vjepa", "inception"):
        out = []
        t0 = time.perf_counter()
        for clip in clips:
            out.append(ex[name](clip_frames(clip) if name == "inception" else clip))
        ms[name] = (time.perf_counter() - t0) * 1e3 / len(clips)
        if name == "inception":
            feats["inception_acts"] = np.concatenate([a for a, _ in out])
            feats["inception_logits"] = np.concatenate([lg for _, lg in out])
        else:
            feats[name] = np.concatenate(out)
    return feats, ms


def _feature_error(got: dict, want: dict) -> dict:
    """Per feature array, the largest |d| over JAX's largest |x|."""
    return {k: float(np.abs(v - want[k]).max() / np.abs(want[k]).max()) for k, v in got.items()}


def _planted_metric_faults(ex: dict, clips: list, clip_frames, want: dict) -> None:
    """Three faults, each planted in the port's module for one run of the
    network it touches, must move its features past the gate: symmetric
    padding in I3D's stride-2 stem unit, the FVD resize without antialias
    (``F.interpolate`` trilinear), V-JEPA's position table recomputed for
    the input grid instead of interpolated."""
    import torch
    import torch.nn.functional as F

    from titok_tpu_torch.metrics import i3d, vjepa

    same_pads, linear_resize = i3d.same_pads, i3d.linear_resize
    interpolate_pos_embed = vjepa.interpolate_pos_embed

    def symmetric(sizes, kernel, strides):
        if tuple(kernel) == (7, 7, 7):  # the stride-2 stem: k // 2 on both sides
            return [k // 2 for k in reversed(kernel) for _ in (0, 1)]
        return same_pads(sizes, kernel, strides)

    def recomputed(table, src_grid, dst_grid):
        d = table.shape[-1]
        return torch.from_numpy(vjepa.get_3d_sincos_pos_embed(d, *dst_grid)).to(table.device)

    faults = [("symmetric padding in I3D's stride-2 Conv3d_1a_7x7", "i3d", i3d, "same_pads",
               symmetric),
              ("the FVD resize without antialias", "i3d", i3d, "linear_resize",
               lambda x, shape: F.interpolate(x, size=tuple(shape[2:]), mode="trilinear",
                                              align_corners=False)),
              ("V-JEPA's position table recomputed for the input grid", "vjepa", vjepa,
               "interpolate_pos_embed", recomputed)]
    for what, net, module, attr, planted in faults:
        orig = getattr(module, attr)
        setattr(module, attr, planted)
        try:
            feats, _ = _metric_features(ex, clips, clip_frames, only=(net,))
        finally:
            setattr(module, attr, orig)
        err = _feature_error(feats, want)[net]
        check(err > METRIC_FEATURE_RTOL, f"planted fault ({what}) passed the gate: {err:.3e}")
        print(f"planted fault ({what}) rejected: {net} features {err:.3e} of JAX's largest "
              f"from JAX's (gate {METRIC_FEATURE_RTOL:g})")
    check(i3d.same_pads is same_pads and i3d.linear_resize is linear_resize
          and vjepa.interpolate_pos_embed is interpolate_pos_embed, "a planted fault stayed")


def _timed_validate(trainer, state) -> float:
    """Host ms of one ``Trainer.validate`` over the eval set, synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.validate(state, PARITY_STEP)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_metrics(card: str) -> dict:
    """The eval metrics on the card. Full-width I3D (400 classes, 224²),
    V-JEPA ``vit_large`` and InceptionV3 (299², 1000 classes) on seeded
    weights, loaded from converter ``.npz`` files by the port's loaders,
    against JAX's committed features and scores (the fixture pinned by its
    sha256); three planted faults; then r4 (f32) with ``log_metrics: [ssim,
    psnr, fvd, jedi]`` through ``Trainer.validate`` and the evaluate CLI's
    ``token_sweep`` at 1, 16 and 128 tokens."""
    import shutil

    import torch

    import titok_tpu_torch.metrics.image_metrics as image_metrics
    from titok_tpu_torch.tools.evaluate import token_sweep

    mf = _metric_fixtures()

    t_phase = time.perf_counter()
    for rel, want in METRICS_SHA256.items():
        got = _sha256(os.path.join(PARITY_DIR, rel))
        check(got == want, f"metrics fixture {rel}: sha256 {got}, want {want}")
    with np.load(os.path.join(PARITY_DIR, "jax_metrics.npz")) as f:
        jax = dict(f)
    with np.load(os.path.join(PARITY_DIR, "eval_clips.npz")) as f:
        uint8 = [f[f"clip_{i}"] for i in range(len(f["fps"]))]
        r4_clips = [{"video": f[f"clip_{i}"], "fps": int(fps)} for i, fps in enumerate(f["fps"])]
    clips = mf.metric_clips(uint8)
    check([c.shape[2] for c in clips] == list(jax["frames"]), "the clips are not the fixture's")

    shutil.rmtree(METRIC_DIR, ignore_errors=True)
    os.makedirs(METRIC_DIR)
    t0 = time.perf_counter()
    weights = {}
    for name, draw in (("i3d", mf.i3d_weights), ("vjepa", mf.vjepa_weights),
                       ("inception", mf.inception_weights)):
        weights[name] = os.path.join(METRIC_DIR, f"{name}.npz")
        np.savez(weights[name], **draw(mf.SEEDS[name]))
    t_draw = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex = _metric_extractors(weights)
    t_load = time.perf_counter() - t0
    try:
        first, first_ms = _metric_features(ex, clips, mf.clip_frames)
        feats, ms = _metric_features(ex, clips, mf.clip_frames)
        feats["frames"] = jax["frames"]
        print(f"metrics: seeded weights drawn and written in {t_draw:.1f} s, loaded to the card "
              f"in {t_load:.1f} s ({sum(os.path.getsize(p) for p in weights.values()) / 2**20:.1f}"
              f" MiB of .npz); {len(clips)} clips, {int(jax['frames'].sum())} frames")
        for name in ms:
            print(f"metrics [{card}]: {name} {ms[name]:.3f} ms a clip (first pass "
                  f"{first_ms[name]:.3f}; host clock, preprocessing and copies included)")
        errs = _feature_error({k: v for k, v in feats.items() if k != "frames"}, jax)
        same = all(np.array_equal(first[k], feats[k]) for k in first)
        for k, e in errs.items():
            check(e <= METRIC_FEATURE_RTOL, f"{k}: {e:.3e} of JAX's largest from JAX's, more than "
                  f"{METRIC_FEATURE_RTOL:g}")
        print("metrics: features against JAX's (largest |d| over JAX's largest |x|): "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
              + f" (gate {METRIC_FEATURE_RTOL:g}); two passes the same bits: {same}")
        t0 = time.perf_counter()
        ours = mf.metric_scores(feats, image_metrics)
        host = mf.metric_scores(jax, image_metrics)
        print(f"metrics: both sets of scores in {time.perf_counter() - t0:.1f} s of host math "
              "(two sqrtm of a 2048-d product for FID)")
        for k, v in ours.items():
            want = float(jax[k])
            check(abs(v / want - 1) <= METRIC_SCORE_RTOL[k],
                  f"{k}: {v!r} on the card's features, JAX's {want!r}")
            check(abs(host[k] / want - 1) <= METRIC_HOST_RTOL,
                  f"{k}: {host[k]!r} by the port's host math on JAX's features, JAX's {want!r}")
            print(f"  {k}: {v:.9g} on the card's features, {host[k]:.9g} by the port's host math "
                  f"on JAX's features, JAX's {want:.9g} (relative {v / want - 1:+.2e} / "
                  f"{host[k] / want - 1:+.2e}; gates {METRIC_SCORE_RTOL[k]:g} / "
                  f"{METRIC_HOST_RTOL:g})")
        _planted_metric_faults(ex, clips, mf.clip_frames, jax)
    finally:
        del ex
        torch.cuda.empty_cache()

    over = {"training.eval.log_metrics": "[ssim,psnr,fvd,jedi]",
            "training.eval.i3d_path": weights["i3d"],
            "training.eval.jedi_vjepa_params": weights["vjepa"],
            "training.eval.jedi_jepa_model": "vit_large"}
    for run in ("metrics_on", "metrics_off"):  # token_sweep appends to its file
        shutil.rmtree(os.path.join(RUN_DIR, run), ignore_errors=True)
    with_metrics, state, _ = _r4_scorer(r4_clips, "metrics_on", **over)
    without, bstate, _ = _r4_scorer(r4_clips, "metrics_off")
    try:
        for tr in (with_metrics, without):
            tr.config.set_dotted("training.sampling.token_range", [128, 128])
        cold = _timed_validate(with_metrics, state)  # builds both networks from the .npz
        rows = _jsonl("metrics_on")
        check(any(np.isfinite(r.get("eval/fvd", np.nan)) and r["eval/fvd"] >= 0
                  and np.isfinite(r.get("eval/jedi", np.nan)) and r["eval/jedi"] >= 0
                  for r in rows), f"metrics.jsonl has no finite eval/fvd and eval/jedi: {rows}")
        _timed_validate(without, bstate)
        on, off = _timed_validate(with_metrics, state), _timed_validate(without, bstate)
        print(f"metrics [{card}]: r4 eval pass over {len(r4_clips)} clips at 128 tokens, host "
              f"clock, synchronised: with fvd and jedi {on:.1f} ms (the first, which builds both "
              f"networks, {cold:.1f}), without {off:.1f} ms; the metric pass {on - off:.1f} ms, "
              f"{(on - off) / len(r4_clips):.1f} ms a clip")
        sweep = os.path.join(RUN_DIR, "metrics_on", "token_sweep.jsonl")
        reset_counts()  # this path: r4's sweep with the video metrics
        srows = token_sweep(with_metrics, state, PARITY_STEP, PARITY_COUNTS, sweep)
        paths = {"eval_r4_metrics": read_counts()}
        check(paths["eval_r4_metrics"]["f32"] > 0, "the sweep launched no row 1 f32 kernel")
        for r in srows:
            check(all(np.isfinite(r[k]) and r[k] >= 0 for k in ("eval/fvd", "eval/jedi")),
                  f"token_sweep row {r}")
            print(f"  {r['token_count']:3d} tokens: eval/fvd {r['eval/fvd']:.6g}, eval/jedi "
                  f"{r['eval/jedi']:.6g}, psnr {r['eval/psnr']:.6f} dB, ssim {r['eval/ssim']:.6f}")
        with open(sweep) as f:
            written = [json.loads(line) for line in f]
        check(written == srows and [r["token_count"] for r in srows] == list(PARITY_COUNTS),
              f"token_sweep.jsonl rows {written}")
    finally:
        del with_metrics, without, state, bstate
        torch.cuda.empty_cache()
        shutil.rmtree(METRIC_DIR, ignore_errors=True)
    print(f"metrics: phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return paths


def _scan_fit(card: str, run: str, batches_fn, K: int, **over) -> dict:
    """``Trainer(cfg).fit()`` of the r4 config (its sampling, loss and wire;
    seeded uint8 clips) at ``steps_per_call`` K, into ``RUN_DIR/<run>``:
    launches a call and a step, the loader's transfers and what each held,
    the rows, the checkpoints, peak device memory and the fit's seconds."""
    import shutil

    import torch

    from titok_tpu_torch.config import load_config
    from titok_tpu_torch.data.prefetch import PrefetchLoader
    from titok_tpu_torch.training.trainer import Trainer

    shutil.rmtree(os.path.join(RUN_DIR, run), ignore_errors=True)
    base = {"training.main.steps_per_call": K, "training.eval.log_recon_num": 0,
            "training.eval.train_probe_dataset": "null", "training.eval.eval_samples": 16,
            "general.wandb.log_step_interval": 1,
            "general.checkpoints.save_path": os.path.join(RUN_DIR, run), **over}
    cfg = load_config(R4, [f"{k}={v}" for k, v in base.items()])
    trainer = Trainer(cfg, batches_fn=batches_fn)
    calls, loaders, held = [], [], []
    make_scan, make_step, make_loader = (trainer.builder.make_train_step_scan,
                                         trainer.builder.make_train_step, trainer._make_loader)

    def counted(fn):
        def run_counted(*args, **kw):
            before = read_counts()
            out = fn(*args, **kw)
            calls.append({k: v - before[k] for k, v in read_counts().items()})
            return out
        return run_counted

    if K > 1:  # the K-step call (its steps run the builder's own single step)
        trainer.builder.make_train_step_scan = lambda k: counted(make_scan(k))
    else:
        trainer.builder.make_train_step = lambda: counted(make_step())

    def kept_loader(seed, group=1):
        loader = make_loader(seed, group)
        put = loader._put

        def put_kept(trees):
            held.append(tuple(trees[0]["patches"].shape))
            return put(trees)

        loader._put = put_kept
        loaders.append(loader)
        return loader

    trainer._make_loader = kept_loader
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # this path: the whole fit, read right after it
    t0 = time.perf_counter()
    state = trainer.fit()
    torch.cuda.synchronize()
    return {"cfg": cfg, "state": state, "trainer": trainer, "calls": calls, "held": held,
            "transfers": loaders[0].transfers, "total": read_counts(), "rows": _jsonl(run),
            "ckpts": trainer.ckpt.all_steps(), "peak": torch.cuda.max_memory_allocated(),
            "seconds": time.perf_counter() - t0}


def phase_scan(card: str) -> dict:
    """``training.main.steps_per_call`` on the card, on seeded uint8 clips
    (no libav here). At precision 32 with LPIPS off (cuDNN's LPIPS backward
    is not bit-reproducible): K = 3 with a tail of 1 against K = 1, losses,
    grad norms and params bit for bit. Then the r4 config as shipped: K = 8,
    bf16-mixed, LPIPS on (random VGG), the uint8 wire, 16 steps with an eval
    and a checkpoint at 16, against the same run at K = 1."""
    import torch

    f32 = {"training.main.precision": 32, "tokenizer.losses.perceptual_weight": 0,
           "optimizer.warmup_steps": 2, "training.main.max_steps": 4,
           "training.sampling.train_seq_len": 2048, "training.eval.eval_step_interval": 0,
           "general.checkpoints.save_interval": 0}
    runs = {K: _scan_fit(card, f"scan_f32_k{K}", u8_clip_batches, K, **f32) for K in (1, 3)}
    rows = {K: [{k: v for k, v in r.items() if k.startswith("train/") or k == "step"}
                for r in runs[K]["rows"] if "train/gen/total_loss" in r] for K in (1, 3)}
    check(rows[1] == rows[3] and len(rows[3]) == 4,
          f"f32 K = 3 rows differ from K = 1: {rows[3]} against {rows[1]}")
    for part in ("model", "disc_model"):
        a, b = (getattr(runs[K]["state"], part).state_dict() for K in (1, 3))
        check(all(torch.equal(a[k], b[k]) for k in a), f"f32 K = 3 {part} differs from K = 1")
    check(len(runs[3]["calls"]) == 2 and all(h[0] == 3 for h in runs[3]["held"]),
          f"f32 K = 3: {len(runs[3]['calls'])} calls, transfers {runs[3]['held']} (a group of 3 "
          "a transfer; the tail is the first slice of one)")
    print(f"scan: f32 (r4 config at precision 32, LPIPS off, seq 2048, uint8 clips), 4 steps at "
          f"K = 3 (a call of 3, a tail of 1) and K = 1: losses and grad norms of every step "
          f"({len(rows[3][0]) - 1} metrics a step) and both modules' params identical, bit for "
          f"bit; losses " + ", ".join(f"{r['train/gen/total_loss']:.8g}" for r in rows[3]))

    paths = {}
    shipped = {"training.main.max_steps": 16, "training.eval.eval_step_interval": 16,
               "general.checkpoints.save_interval": 16}
    res = {}
    for K in (8, 1):
        r = res[K] = _scan_fit(card, f"scan_r4_k{K}", u8_clip_batches, K, **shipped)
        cfg = r["cfg"]
        check(cfg.dataset.uint8_wire and cfg.training.main.precision == "bf16-mixed"
              and r["trainer"].loss_system.use_perceptual, "the r4 config is not as shipped")
        n = TRAIN_LAUNCHES["tiny"]
        steps = [r2 for r2 in r["rows"] if "train/gen/total_loss" in r2]
        check([s["step"] for s in steps] == list(range(16)), f"K {K}: train rows "
              f"{[s['step'] for s in steps]}")
        for s in steps:
            vals = [v for k, v in s.items() if k.startswith("train/")]
            check(all(np.isfinite(v) for v in vals), f"K {K} step {s['step']}: non-finite")
        # checkpoints: K = 8 saves at the crossing of 16; K = 1 as orbax's
        # policy saves, at the first step too
        evals = [r2["step"] for r2 in r["rows"] if "eval/psnr" in r2]
        want_ckpts = [16] if K > 1 else [0, 16]
        check(evals == [16] and r["ckpts"] == want_ckpts, f"K {K}: eval at {evals}, "
              f"checkpoints {r['ckpts']}, want the eval at 16 and checkpoints {want_ckpts}")
        want_call = {**{k: 0 for k in r["calls"][0]}, "bf16": K * n, "bwd_dq_bf16": K * n,
                     "bwd_dkv_bf16": K * n}
        check(len(r["calls"]) == 16 // K and all(c == want_call for c in r["calls"]),
              f"K {K}: {len(r['calls'])} calls, launches {r['calls'][0]}, want {want_call}")
        # one transfer a call: what the loader made beyond the calls is the
        # item the loop took before it saw max_steps, its queue of 2 and the
        # one in hand
        lead = [h[0] for h in r["held"]] if K > 1 else [1] * len(r["held"])
        check(0 <= r["transfers"] - len(r["calls"]) <= 4 and lead == [K] * len(lead)
              and (K > 1 or all(len(h) == 2 for h in r["held"])),
              f"K {K}: {r['transfers']} transfers for {len(r['calls'])} calls, patch shapes "
              f"{r['held'][:3]}")
        tps = [s["perf/tokens_per_sec"] for s in steps if s["step"] >= K]
        r["tps"] = float(np.mean(tps))
        print(f"scan: the r4 config as shipped (bf16-mixed, LPIPS on, uint8 wire, seq 6144, "
              f"seeded uint8 clips) at K = {K} [{card}]: 16 steps in {r['seconds']:.2f} s, "
              f"{len(r['calls'])} calls of {K} steps, {r['transfers']} H2D transfers (each of "
              f"{K} stacked batches; prefetched ones included), launches a step "
              f"{r['calls'][0]['bf16'] // K} forward, {r['calls'][0]['bwd_dq_bf16'] // K} dq, "
              f"{r['calls'][0]['bwd_dkv_bf16'] // K} dk/dv; eval and checkpoint at 16; "
              f"{r['tps']:.0f} tokens/s (perf/tokens_per_sec of the logged steps after the first "
              f"call); peak device memory {r['peak'] / 2**30:.3f} GiB; losses "
              + ", ".join(f"{s['train/gen/total_loss']:.5g}" for s in steps[:4]) + " ...")
    paths["train_r4_k8"] = res[8]["total"]
    print(f"scan: K = 8 against K = 1 [{card}]: tokens/s {res[8]['tps']:.0f} / {res[1]['tps']:.0f}"
          f" ({res[8]['tps'] / res[1]['tps']:.3f}x), peak memory {res[8]['peak'] / 2**30:.3f} / "
          f"{res[1]['peak'] / 2**30:.3f} GiB (one run each: no claim)")
    check(res[8]["peak"] <= 1.25 * res[1]["peak"], "K = 8 holds more than one step's tensors")
    del runs, res
    torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# The repo's all-large adafactor recipe (docs/runs/r3f_alllarge_adafactor)
# under the supervisor
# ---------------------------------------------------------------------------

# r3f's overrides of configs/tiny.yaml (launch_synth.sh): large encoder,
# decoder and discriminator, adafactor, remat, the uint8 wire, synthetic
# data, LPIPS off, no eval; its snapshot and preemption settings
R3F = ("tokenizer.losses.perceptual_weight=0.0",
       "general.checkpoints.host_snapshot_interval=0",
       "general.checkpoints.preemption_save_timeout_s=60",
       "training.eval.eval_step_interval=0",
       "tokenizer.model.encoder_size=large", "tokenizer.model.decoder_size=large",
       "discriminator.model.model_size=large", "optimizer.name=adafactor",
       "training.main.remat=true", "dataset.uint8_wire=true",
       "dataset.train_dataset=synthetic", "dataset.eval_dataset=synthetic")
R3F_STEPS = 8


def r3f_args(run: str) -> list[str]:
    """The supervisor's arguments for r3f's recipe into ``RUN_DIR/<run>``:
    ``R3F_STEPS`` steps, a checkpoint every 2, every step logged."""
    return [f"config={TINY}", *R3F, f"training.main.max_steps={R3F_STEPS}",
            "general.checkpoints.save_interval=2", "general.wandb.log_step_interval=1",
            f"general.checkpoints.save_path={os.path.join(RUN_DIR, run)}", "--poll-sec", "1"]


def _opt_bytes(opt) -> int:
    """Bytes of every tensor of an optimizer's state."""
    return sum(v.numel() * v.element_size() for s in opt.state.values() for v in s.values()
               if hasattr(v, "element_size"))


def _timed_step(opt, into: list):
    """``opt.step`` wrapped to append its ms (synchronized on both sides)
    to ``into``; ``del opt.step`` puts the class's back."""
    import torch

    inner = opt.step

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        into.append((time.perf_counter() - t0) * 1e3)
        return out

    opt.step = timed


def _alllarge_optimizers(card: str) -> dict:
    """r3f's recipe in this process under AdamW and under adafactor, one
    after the other from the same weights (drawn on the card) and batches:
    4 steps each (the first a warm-up), then one more with each optimizer's
    update timed alone; the optimizers' state bytes, peak device memory
    above what was allocated before (nothing is left of the other run) and
    ms a step. Launches: the adafactor run's, rows 1-2 in bf16 with
    remat."""
    import gc

    import torch

    from titok_tpu_torch.config import load_config

    out, paths = {}, {}
    n = TRAIN_LAUNCHES["large"]
    want = {**{k: 0 for k in read_counts()}, "bf16": 2 * n, "bwd_dq_bf16": n, "bwd_dkv_bf16": n}
    for name in ("adamw", "adafactor"):
        cfg = load_config(TINY, [*R3F, f"optimizer.name={name}"])
        batches, pack_ms = _host_batches(cfg, 5)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        builder, state, step = _trainer(cfg, card_seed=0)
        n_params = sum(p.numel() for m in (state.model, state.disc_model) for p in m.parameters())
        n_tensors = sum(1 for m in (state.model, state.disc_model) for _ in m.parameters())
        times, per_step = [], []
        reset_counts()  # this path: the 4 steps below, read right after them
        for triple in batches[:4]:
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics, _ = step(state, *_on_card(triple))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            per_step.append({k: v - before[k] for k, v in read_counts().items()})
            vals = {k: float(v) for k, v in metrics.items()}
            check(all(np.isfinite(v) for v in vals.values()), f"{name}: non-finite {vals}")
        if name == "adafactor":
            paths["train_alllarge"] = read_counts()
        for i, got in enumerate(per_step):
            check(got == want, f"all-large {name} step {i}: launches {got}, want {want}")
        peak = torch.cuda.max_memory_allocated() - base
        opt_ms = {"gen": [], "disc": []}
        _timed_step(state.gen_opt, opt_ms["gen"])
        _timed_step(state.disc_opt, opt_ms["disc"])
        state, metrics, _ = step(state, *_on_card(batches[4]))
        del state.gen_opt.step, state.disc_opt.step
        state_bytes = _opt_bytes(state.gen_opt) + _opt_bytes(state.disc_opt)
        out[name] = {"bytes": state_bytes, "peak": peak, "ms": times,
                     "opt_ms": opt_ms["gen"] + opt_ms["disc"]}
        print(f"all-large {name} (r3f's recipe in this process) [{card}]: {n_params / 1e6:.1f} M "
              f"params in {n_tensors} tensors; optimizer state {state_bytes} B "
              f"({state_bytes / n_params:.4f} B/param, {state_bytes / 2**30:.3f} GiB); peak "
              f"device memory {peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated over 4 "
              f"steps, less the {base / 2**30:.3f} GiB allocated before); steps "
              f"{', '.join(f'{t:.2f}' for t in times)} ms (host clock; mean of the last 3 "
              f"{np.mean(times[1:]):.2f} ms); in a 5th step the generator's and discriminator's "
              f"updates alone {opt_ms['gen'][0]:.2f} / {opt_ms['disc'][0]:.2f} ms; host packing "
              f"{pack_ms:.1f} ms/batch; launches a step "
              f"{ {k: v for k, v in per_step[0].items() if v} }")
        del builder, state, step, batches, metrics
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() - base
        check(left < 2**28, f"all-large {name}: {left} B still allocated after its run")
    af, aw = out["adafactor"], out["adamw"]
    print(f"all-large adafactor against AdamW [{card}]: state {af['bytes'] / 2**30:.3f} / "
          f"{aw['bytes'] / 2**30:.3f} GiB, peak {af['peak'] / 2**30:.3f} / "
          f"{aw['peak'] / 2**30:.3f} GiB (adafactor minus AdamW "
          f"{(af['peak'] - aw['peak']) / 2**30:+.3f} GiB), step {np.mean(af['ms'][1:]):.2f} / "
          f"{np.mean(aw['ms'][1:]):.2f} ms ({np.mean(af['ms'][1:]) / np.mean(aw['ms'][1:]):.3f}x), "
          f"updates {sum(af['opt_ms']):.2f} / {sum(aw['opt_ms']):.2f} ms (one run each: no claim)")
    check(af["bytes"] < 0.3 * aw["bytes"], "adafactor's state is not under 0.3 of AdamW's")
    return paths


def _start_supervisor(args: list[str], log: str):
    """``python -m titok_tpu_torch.tools.train_supervised`` from the repo
    root in a session of its own (so that its children can be stopped
    with it), its output and its children's into ``log``."""
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-m", "titok_tpu_torch.tools.train_supervised",
                                 *args], cwd=REPO, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)


def _text(path: str) -> str:
    with open(path) as f:
        return f.read()


def _launches(log: str) -> list[tuple[int, str]]:
    """``(pid, arguments)`` of each launch line of a supervisor's log."""
    return [(int(pid), rest) for pid, rest in re.findall(
        r"\[supervisor\] launch \(restart \d+, pid (\d+)\): (.*)", _text(log))]


def _wait_for(cond, timeout: float, what: str, sup, log: str) -> float:
    """Seconds until ``cond()``; fails at ``timeout`` or when ``sup`` ends
    first, with the end of ``log``."""
    t0 = time.perf_counter()
    while not cond():
        if sup is not None and sup.poll() is not None:
            raise SmokeFailure(f"{what}: the supervisor exited {sup.returncode} first:\n"
                               f"{_text(log)[-4000:]}")
        if time.perf_counter() - t0 > timeout:
            raise SmokeFailure(f"{what}: not within {timeout:.0f} s:\n{_text(log)[-4000:]}")
        time.sleep(0.1)
    return time.perf_counter() - t0


def phase_supervised_alllarge(card: str) -> dict:
    """r3f's all-large adafactor recipe at full width (24 + 24 layers, width
    1024, a large discriminator, ``train_seq_len`` 6144, bf16-mixed, remat)
    in this process under both optimizers (:func:`_alllarge_optimizers`),
    then as its launch script runs it, through ``python -m
    titok_tpu_torch.tools.train_supervised`` for ``R3F_STEPS`` steps with
    a checkpoint every 2: (a) its child SIGKILLed once checkpoint 4 exists
    (the state after step 4, whose count is 5): the supervisor reports the
    unexpected exit and relaunches with resume, which resumes from step 5;
    (b) the supervisor SIGTERMed once the resumed child logs its first step:
    the child saves and exits 143, the supervisor exits 143 without a
    relaunch; (c) a new supervisor over the same directory resumes on its
    first launch and ends rc 0 with the last checkpoint at ``R3F_STEPS``,
    every step logged but the one that saw the SIGTERM, and every logged
    value finite."""
    import shutil
    import signal as _signal

    from titok_tpu_torch.train_utils.checkpoints import CheckpointManager

    paths = _alllarge_optimizers(card)
    run = "alllarge"
    run_dir = os.path.join(RUN_DIR, run)
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(RUN_DIR, exist_ok=True)
    print(f"supervised all-large: {shutil.disk_usage(RUN_DIR).free / 2**30:.1f} GiB free for its "
          f"checkpoints")
    args = r3f_args(run)
    logs = [os.path.join(RUN_DIR, f"{run}_supervisor_{i}.log") for i in (1, 2)]
    resume_args = "general.checkpoints.resume_from_checkpoint=true"
    sups = []
    t_phase = time.perf_counter()
    try:
        # (a) the child SIGKILLed once checkpoint 4 exists
        sups.append(_start_supervisor(args, logs[0]))
        sup = sups[0]
        saved_at = {}  # seconds from the launch to each checkpoint of the first child
        t_launch = time.perf_counter()
        for k in (0, 2, 4):
            _wait_for(lambda k=k: os.path.exists(os.path.join(run_dir, str(k), "state.pt")), 900,
                      f"checkpoint {k} of the first child", sup, logs[0])
            saved_at[k] = time.perf_counter() - t_launch
        first_pid = _launches(logs[0])[0][0]
        os.kill(first_pid, _signal.SIGKILL)
        rows_at_kill = len(_jsonl(run))
        _wait_for(lambda: "unexpected rc=-9" in _text(logs[0]), 60, "the kill reported", sup,
                  logs[0])
        ckpt = CheckpointManager(run_dir)
        killed_at = ckpt.latest_step()
        check(killed_at is not None and killed_at >= 4, f"checkpoints at the kill {ckpt.all_steps()}")
        print(f"supervised all-large (a): checkpoints 0, 2, 4 of the first child "
              f"{', '.join(f'{t:.1f}' for t in saved_at.values())} s after its launch; SIGKILL "
              f"to the child (pid {first_pid}); newest checkpoint {killed_at}", flush=True)
        _wait_for(lambda: len(_launches(logs[0])) == 2 and "resumed from step" in
                  _text(logs[0]).split("launch (restart 1")[-1], 600, "the relaunch's resume",
                  sup, logs[0])
        relaunch = _launches(logs[0])[1][1]
        after = _text(logs[0]).split("launch (restart 1")[-1]
        check(resume_args in relaunch, f"the relaunch does not resume: {relaunch}")
        check(f"resumed from step {killed_at + 1}" in after,
              f"the relaunch did not resume from step {killed_at + 1}:\n{after[-3000:]}")

        # (b) the supervisor SIGTERMed once the resumed child logs a step
        took = _wait_for(lambda: any("train/gen/total_loss" in r
                                     for r in _jsonl(run)[rows_at_kill:]), 600,
                         "a step of the resumed child", sup, logs[0])
        resumed_step = next(r["step"] for r in _jsonl(run)[rows_at_kill:]
                            if "train/gen/total_loss" in r)
        sup.send_signal(_signal.SIGTERM)
        rc = sup.wait(timeout=300)
        text = _text(logs[0])
        saved = re.findall(r"preemption save at step (\d+)", text)
        check(rc == 143, f"the SIGTERMed supervisor exited {rc}, want 143:\n{text[-3000:]}")
        check("shutdown requested: the child exited rc=143, not relaunching" in text and
              len(_launches(logs[0])) == 2 and len(saved) == 1,
              f"SIGTERM: no preemption save and clean stop, or a relaunch:\n{text[-3000:]}")
        saved = int(saved[0])
        check(ckpt.latest_step() == saved, f"checkpoints {ckpt.all_steps()}, want the newest at "
              f"the preemption save {saved}")
        print(f"supervised all-large (b): the resumed child logged step {resumed_step} after "
              f"{took:.1f} s; SIGTERM to the supervisor: the child saved at step {saved} and "
              f"exited 143, the supervisor exited {rc} without a relaunch", flush=True)

        # (c) a new supervisor over the same directory
        sups.append(_start_supervisor(args, logs[1]))
        t0 = time.perf_counter()
        rc = sups[1].wait(timeout=900)
        took = time.perf_counter() - t0
        text = _text(logs[1])
        launches = _launches(logs[1])
        check(rc == 0 and len(launches) == 1, f"the second supervisor: rc {rc}, "
              f"{len(launches)} launches:\n{text[-3000:]}")
        check(resume_args in launches[0][1] and f"resumed from step {saved}" in text,
              f"the second supervisor's first launch did not resume from {saved}:\n{text[-3000:]}")
        check(ckpt.latest_step() == R3F_STEPS, f"checkpoints {ckpt.all_steps()}, want the "
              f"newest at {R3F_STEPS}")
        rows = [r for r in _jsonl(run) if "train/gen/total_loss" in r]
        logged = sorted({r["step"] for r in rows})
        losses = [v for r in rows for k, v in r.items() if k.startswith("train/")]
        # the step that saw the SIGTERM is saved but not logged (the trainer
        # stops right after it)
        check(sorted(set(logged) | {saved - 1}) == list(range(R3F_STEPS)),
              f"logged steps {logged}")
        check(all(np.isfinite(v) for v in losses), "a non-finite logged value")
        last = {k: rows[-1][k] for k in ("step", "train/gen/total_loss", "train/disc/total_loss")
                if k in rows[-1]}
        print(f"supervised all-large (c): a new supervisor resumed from step {saved} and ended "
              f"rc 0 after {took:.1f} s, checkpoints {ckpt.all_steps()}; steps {logged} logged "
              f"({len(rows)} rows), every value finite; last row {last}; phase "
              f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    finally:
        for sup in sups:
            try:
                os.killpg(sup.pid, _signal.SIGKILL)  # the supervisor and its children
            except ProcessLookupError:
                pass
            sup.wait()
        shutil.rmtree(run_dir, ignore_errors=True)  # about 5 GB a checkpoint
    return paths


# the serving tools (phase_serving_tools): the exported artifacts go here
# (git-ignored, removed at the end of the phase)
SERVE_DIR = os.path.join(RUN_DIR, "serving")
QUANT_MODES = ("w8a16", "w8a8")
# int8 against the port's own f32, at tests/test_quant.py's thresholds: the
# mean over the encoded clips (10 clips at each of 1, 16, 128 tokens) of each
# clip's share of indices equal to f32's, and the PSNR (peak 1 on [-1, 1]) of
# the int8 decoder against the f32 decoder on the f32 indices. At 128 tokens
# alone the share is 97.7-97.8 % on the CPU, as JAX's own int8 against its
# f32 (the committed fixtures); the mean over the sweep is 99.1-99.2 %
QUANT_F32_SHARE = 0.98
QUANT_DECODE_PSNR_DB = 40.0
# int8 against JAX's committed int8 results: indices identical on >= 99 % of
# each count's tokens (measured on the CPU, tests/test_torch_parity.py:
# 99.77 % at 128 tokens in w8a16, 100 % elsewhere); PSNR within
# PARITY_PSNR_DB and SSIM within PARITY_SSIM of JAX's
QUANT_JAX_SHARE = 0.99
# an exported program against the live module: indices bit for bit, recon
# within this (f32)
EXPORT_ATOL = 1e-5
# a fresh process that loads exported programs with load_exported, calls
# them on saved batches, and reports their outputs and launches; it prints
# the titok_tpu_torch.models modules it imported (none is allowed). A case
# with "plain_on_cuda" (the planted fault; it runs last) first registers
# the plain version as the attention op's CUDA implementation.
EXPORTED_CHILD = """
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from titok_tpu_torch.ops import flash_attention_mh as fa
from titok_tpu_torch.ops import vq_distance as vd
from titok_tpu_torch.tools.export_model import load_exported

def counts():
    return {**fa.launches, "vq_f32": vd.launches["f32"]}

def delta(before):
    return {k: v - before[k] for k, v in counts().items()}

with open(sys.argv[2]) as f:
    cases = json.load(f)
for case in cases:
    if case["plain_on_cuda"]:
        @fa.segment_attn_fwd.register_kernel("cuda")
        def _(q, k, v, seg, kseg, scale):
            return fa.flash_segment_attention_mh_reference(q, k, v, seg, scale, kseg)
    t0 = time.perf_counter()
    fwd, dec, meta = load_exported(case["art"])
    load_s = time.perf_counter() - t0
    batch = {k: v.to(meta["device"]) for k, v in torch.load(case["batch"]).items()}
    with torch.no_grad():
        before = counts()
        recon, idx = fwd(batch)
        torch.cuda.synchronize()
        fwd_counts = delta(before)
        before = counts()
        rec2 = dec(idx, batch)
        torch.cuda.synchronize()
        dec_counts = delta(before)
    torch.save({"recon": recon.cpu(), "indices": idx.cpu(), "decoded": rec2.cpu(),
                "load_s": load_s, "forward_launches": fwd_counts,
                "decode_launches": dec_counts}, case["out"])
print(json.dumps(sorted(m for m in sys.modules if m.startswith("titok_tpu_torch.models"))))
"""


def _sweep(trainer, state, seen: list, n_clips: int, run: str, quant: str | None) -> dict:
    """The evaluate CLI's ``token_sweep`` of r4 at 1, 16, 128 tokens through
    the trainer's eval step, whose outputs ``seen`` keeps: ``{"rows":
    {count: row}, "ix": {count: [clips, count]}, "seen"}``."""
    from titok_tpu_torch.tools.evaluate import token_sweep

    seen.clear()
    rows = token_sweep(trainer, state, PARITY_STEP, PARITY_COUNTS,
                       os.path.join(RUN_DIR, run, "token_sweep.jsonl"), quant)
    return {"rows": {r["token_count"]: r for r in rows}, "seen": list(seen),
            "ix": {c: _indices_of(seen, c, n_clips) for c in PARITY_COUNTS}}


def _decode_psnr(f32_module, module, seen: list) -> float:
    """The smallest PSNR (peak 1) over the eval batches of ``module``'s
    decoder against ``f32_module``'s on the f32 sweep's indices, at the
    patch rows (tests/test_quant.py's check)."""
    import torch

    worst = float("inf")
    with torch.no_grad():
        for _, batch, (_, indices, _) in seen:
            rows = (batch["segment_ids"] > 0) & ~batch["token_mask"]
            a = f32_module.decode_indices_packed(indices, batch)[rows].float()
            b = module.decode_indices_packed(indices, batch)[rows].float()
            mse = float(((a - b) ** 2).mean())
            worst = min(worst, 10 * np.log10(1.0 / max(mse, 1e-20)))
    return worst


def _quant_gate(mode: str, f32: dict, q: dict, jax: dict, decode_psnr: float) -> list[str]:
    """The int8 gates of one sweep ``q`` against the f32 sweep and JAX's
    committed int8 results; returns what fails (nothing when it passes)."""
    bad = []
    per_clip = [float(np.mean(a == b)) for c in PARITY_COUNTS
                for a, b in zip(q["ix"][c], f32["ix"][c])]
    if np.mean(per_clip) < QUANT_F32_SHARE:
        bad.append(f"{mode}: indices equal to f32's on {np.mean(per_clip) * 100:.3f} % "
                   f"(mean over the clips), want >= {QUANT_F32_SHARE * 100:g} %")
    if not decode_psnr > QUANT_DECODE_PSNR_DB:
        bad.append(f"{mode}: decoder PSNR against f32 {decode_psnr:.2f} dB, want > "
                   f"{QUANT_DECODE_PSNR_DB:g}")
    for c in PARITY_COUNTS:
        share = float((q["ix"][c] == jax[f"indices_{c}"]).mean())
        if share < QUANT_JAX_SHARE:
            bad.append(f"{mode} at {c} tokens: indices equal to JAX's int8 on {share * 100:.3f} %"
                       f", want >= {QUANT_JAX_SHARE * 100:g} %")
        r = q["rows"][c]
        dp, ds = r["eval/psnr"] - float(jax[f"psnr_{c}"]), r["eval/ssim"] - float(jax[f"ssim_{c}"])
        if not (abs(dp) <= PARITY_PSNR_DB and abs(ds) <= PARITY_SSIM):
            bad.append(f"{mode} at {c} tokens: psnr {dp:+.2e} dB, ssim {ds:+.2e} from JAX's int8")
    return bad


def _eval_batch_ms(trainer, step) -> float:
    """ms an eval batch of r4 at 128 tokens through ``step`` (CUDA events
    over 5 passes; model plus the PSNR/SSIM sums)."""
    from titok_tpu_torch.data.packing import to_device
    from titok_tpu_torch.ops.frames import build_eval_frame_plan

    trainer.config.set_dotted("training.sampling.token_range", [128, 128])
    batches = list(trainer.batches_fn(trainer.config, eval=True, seed=0))
    dev = [(to_device(b, "cuda"), to_device(build_eval_frame_plan(
        b, num_frames=trainer._eval_kmax, patch_size=trainer.patch_size,
        max_grid_hw=trainer.max_grid[1:]), "cuda")) for b in batches]
    return cuda_ms(lambda: [step(b, p) for b, p in dev], reps=5) / len(dev)


def _serving_quant(card: str, clips: list) -> dict:
    """r4's int8 serving path through the evaluate CLI's functions: scores,
    the gates, the planted scale fault, ms an eval batch by mode."""
    import copy

    import torch

    from titok_tpu_torch.serving.quant import Int8Dense, quantize_module
    from titok_tpu_torch.tools.evaluate import quantize_eval

    paths, sweeps, ms = {}, {}, {}
    f32, state, seen = _r4_scorer(clips, "serve_f32")
    sweeps["f32"] = _sweep(f32, state, seen, len(clips), "serve_f32", None)
    for mode in QUANT_MODES:
        tr, st, sn = _r4_scorer(clips, f"serve_{mode}", quant=mode)
        reset_counts()  # this path: the int8 sweep
        sweeps[mode] = _sweep(tr, st, sn, len(clips), f"serve_{mode}", mode)
        paths[f"eval_r4_{mode}"] = read_counts()
        n_batches = len(sweeps[mode]["seen"])
        want = {**{k: 0 for k in paths[f"eval_r4_{mode}"]}, "f32": 8 * n_batches}
        check(paths[f"eval_r4_{mode}"] == want,
              f"{mode} sweep launches {paths[f'eval_r4_{mode}']}, want {want}")
        with np.load(os.path.join(PARITY_DIR, f"jax_{mode}.npz")) as f:
            jax = dict(f)
        psnr = _decode_psnr(state.model, quantize_module(state.model, mode).eval(),
                            sweeps["f32"]["seen"])
        bad = _quant_gate(mode, sweeps["f32"], sweeps[mode], jax, psnr)
        check(not bad, "; ".join(bad))
        for c in PARITY_COUNTS:
            r, ix = sweeps[mode]["rows"][c], sweeps[mode]["ix"][c]
            print(f"serving int8 {mode} at {c:3d} tokens: indices equal to f32's "
                  f"{float((ix == sweeps['f32']['ix'][c]).mean()) * 100:.3f} %, to JAX's int8 "
                  f"{float((ix == jax[f'indices_{c}']).mean()) * 100:.3f} %; "
                  f"psnr {r['eval/psnr']:.6f} dB (JAX int8 {float(jax[f'psnr_{c}']):.6f}, f32 "
                  f"{sweeps['f32']['rows'][c]['eval/psnr']:.6f}), ssim {r['eval/ssim']:.6f} (JAX "
                  f"int8 {float(jax[f'ssim_{c}']):.6f})")
        per_clip = np.mean([np.mean(a == b) for c in PARITY_COUNTS
                            for a, b in zip(sweeps[mode]["ix"][c], sweeps["f32"]["ix"][c])])
        print(f"serving int8 {mode}: {n_batches} eval batches, {paths[f'eval_r4_{mode}']['f32']} "
              f"row 1 f32 launches; indices equal to f32's {per_clip * 100:.3f} % (mean over "
              f"the 30 encoded clips); decoder PSNR against f32 {psnr:.2f} dB (smallest batch)")
        quantize_eval(tr, st, mode)  # the int8 step unwrapped, to time it
        ms[mode] = _eval_batch_ms(tr, tr._eval_step)
        if mode == "w8a8":  # the planted fault: every int8 scale 1 % off
            faulty = quantize_module(state.model, mode).eval()
            for m in faulty.modules():
                if isinstance(m, Int8Dense):
                    m.s.mul_(1.01)
            builder = copy.copy(tr.builder)
            builder.model = faulty
            sn = _keep_outputs(tr, builder.make_eval_metrics_step(tr.device_im))
            sweep = _sweep(tr, st, sn, len(clips), "serve_fault", mode)
            bad = _quant_gate(mode, sweeps["f32"], sweep, jax,
                              _decode_psnr(state.model, faulty, sweeps["f32"]["seen"]))
            check(bool(bad), "planted fault (every int8 scale 1 % off) passed the int8 gates")
            print(f"planted fault (every int8 scale 1 % off) rejected: {bad[0]}")
        del tr, st
    bf16, bstate, _ = _r4_scorer(clips, "serve_bf16", **{"training.main.precision": "bf16-mixed"})
    ms["f32"] = _eval_batch_ms(f32, f32.builder.make_eval_metrics_step(f32.device_im))
    ms["bf16"] = _eval_batch_ms(bf16, bf16.builder.make_eval_metrics_step(bf16.device_im))
    print(f"serving: ms an eval batch of 4096 rows at 128 tokens [{card}]: " + ", ".join(
        f"{k} {ms[k]:.3f}" for k in ("f32", "bf16", "w8a16", "w8a8")) + " (CUDA events over 5 "
        "passes; model, PSNR and SSIM sums; the int8 modes at precision 32)")
    del f32, bf16, state, bstate
    torch.cuda.empty_cache()
    return paths


def _r4_model():
    """The r4 config at precision 32 as a ``TiTokModel`` on the card with the
    committed weights (the tokenize CLI's ``load_model``)."""
    from titok_tpu_torch.tools.tokenize import load_model

    return load_model(R4, os.path.join(PARITY_DIR, str(PARITY_STEP)),
                      ["training.main.precision=32"], device="cuda")[1]


def _base_vq_model():
    """base_vq at precision 32 with seeded weights (dense kernels at 4x the
    reference init, as its serving phase) and codebook, on the card."""
    from titok_tpu_torch.config import load_config
    from titok_tpu_torch.models.titok import TiTokModel, init_params, make_titok

    cfg = load_config(os.path.join(REPO, "configs", "base_vq.yaml"),
                      ["training.main.precision=32"])
    module = make_titok(cfg)
    params = init_params(module, seed=0)
    for name, w in params.items():
        if w.ndim == 2 and not name.endswith("mask_token"):
            params[name] = w * np.float32(4.0)
    return TiTokModel(module, params=params, seq_len=int(cfg.training.sampling.eval_seq_len),
                      min_grid=cfg.training.sampling.min_grid, device="cuda", seed=0)


def _live_call(module, batch: dict) -> tuple[dict, dict, dict]:
    """``module``'s forward and decode of its indices on ``batch`` (CPU
    tensors) on the card (host copies), and each call's launches."""
    import torch

    dev = {k: v.to("cuda") for k, v in batch.items()}
    with torch.no_grad():
        reset_counts()
        recon, aux = module(dev)
        torch.cuda.synchronize()
        fwd = read_counts()
        reset_counts()
        decoded = module.decode_indices_packed(aux["indices"], dev)
        torch.cuda.synchronize()
        dec = read_counts()
    return ({"recon": recon.cpu(), "indices": aux["indices"].cpu(), "decoded": decoded.cpu()},
            fwd, dec)


def _exported_gate(name: str, got: dict, live: dict, fwd: dict, dec: dict) -> list[str]:
    """An exported program's outputs and launches in the loading process
    against the live module's: indices bit for bit, the forward's and the
    decode's reconstructions within ``EXPORT_ATOL``, and every kernel
    launched as often as the live call launches it (``fwd``, ``dec``; the
    attention forward at least once). Returns what fails."""
    bad = []
    if not bool((got["indices"] == live["indices"]).all()):
        bad.append(f"{name}: indices differ from the live module's at "
                   f"{int((got['indices'] != live['indices']).sum())} slots")
    for key in ("recon", "decoded"):
        diff = float((got[key].float() - live[key].float()).abs().max())
        if not diff <= EXPORT_ATOL:
            bad.append(f"{name}: {key} max|diff| {diff:.3e} from the live module's")
    for call, want, have in (("forward", fwd, got["forward_launches"]),
                             ("decode", dec, got["decode_launches"])):
        launched = {k: v for k, v in have.items() if v}
        if launched != {k: v for k, v in want.items() if v} or not have["f32"]:
            bad.append(f"{name}: the exported {call} launched {launched}, the live call "
                       f"{ {k: v for k, v in want.items() if v} }")
    return bad


def _serving_export(card: str, r4, base_vq, clips: list) -> dict:
    """r4 exported in f32 and w8a8 and base_vq in f32 on the card, loaded in
    a fresh process without the models; the planted plain-on-cuda fault.
    Returns the paths' launches."""
    import shutil

    import torch

    from titok_tpu_torch.serving.quant import quantize_module
    from titok_tpu_torch.tools.export_model import PROGRAMS, export_model

    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    os.makedirs(SERVE_DIR)
    r4_batch = r4._pack([c["video"] for c in clips[:3]], [128, 16, 1]).device_arrays()
    base_clips, base_tc = _base_vq_clips(np.random.default_rng(0))
    group = base_vq._groups(base_clips, base_tc)[0]
    base_batch = base_vq._pack([base_clips[i] for i in group],
                               [base_tc[i] for i in group]).device_arrays()
    cases, live = [], {}
    # r4 in f32 and w8a8; base_vq in f32 (its w8a8 export holds the same
    # gates and is left out to keep the phase short)
    for model, name, batch, quant in ((r4, "r4_f32", r4_batch, None),
                                      (r4, "r4_w8a8", r4_batch, "w8a8"),
                                      (base_vq, "base_vq_f32", base_batch, None)):
        art = os.path.join(SERVE_DIR, name)
        t0 = time.perf_counter()
        export_model(model.module, model._dummy_batch(), art, quant=quant)
        took = time.perf_counter() - t0
        sizes = {n: os.path.getsize(os.path.join(art, n)) for n in PROGRAMS}
        module = quantize_module(model.module, quant).eval() if quant else model.module
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        live[name] = _live_call(module, tensors)
        torch.save(tensors, os.path.join(SERVE_DIR, f"{name}_batch.pt"))
        cases.append({"name": name, "art": art, "plain_on_cuda": False,
                      "batch": os.path.join(SERVE_DIR, f"{name}_batch.pt"),
                      "out": os.path.join(SERVE_DIR, f"{name}_out.pt")})
        print(f"export {name}: traced and saved in {took:.1f} s; " + ", ".join(
            f"{n} {s / 2**20:.1f} MiB" for n, s in sizes.items()), flush=True)
    # the planted fault, last: r4's f32 forward with the attention op's CUDA
    # implementation the plain version
    cases.append({**cases[0], "name": "r4_f32 plain_on_cuda",
                  "out": os.path.join(SERVE_DIR, "fault_out.pt"), "plain_on_cuda": True})
    with open(os.path.join(SERVE_DIR, "cases.json"), "w") as f:
        json.dump(cases, f)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", EXPORTED_CHILD, REPO,
                          os.path.join(SERVE_DIR, "cases.json")], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    check(res.returncode == 0, f"the loading process failed:\n{res.stderr[-4000:]}")
    imported = json.loads(res.stdout.strip().splitlines()[-1])
    check(imported == [], f"the loading process imported {imported}")
    print(f"exported programs: {len(cases)} cases loaded with load_exported and called in one "
          f"fresh process ({time.perf_counter() - t0:.1f} s), which imported no "
          "titok_tpu_torch.models module")
    paths = {}
    for case in cases:
        got = torch.load(case["out"])
        name = case["name"].split()[0]
        bad = _exported_gate(case["name"], got, *live[name])
        if case["plain_on_cuda"]:
            check(any("launched" in b for b in bad),
                  f"planted fault (the op's CUDA implementation the plain version) passed the "
                  f"exported gate: {bad}")
            print(f"planted fault (exported forward, plain version on cuda) rejected: "
                  f"{[b for b in bad if 'launched' in b][0]}")
            continue
        check(not bad, "; ".join(bad))
        paths[f"exported_{name}"] = {k: got["forward_launches"][k] + got["decode_launches"][k]
                                     for k in got["forward_launches"]}
        diff = float((got["recon"].float() - live[name][0]["recon"].float()).abs().max())
        print(f"exported {name}: loaded in {got['load_s']:.1f} s; indices equal to the live "
              f"module's bit for bit, recon max|diff| {diff:.3e}; launches forward "
              f"{ {k: v for k, v in got['forward_launches'].items() if v} }, decode "
              f"{ {k: v for k, v in got['decode_launches'].items() if v} }")
    return paths


def _serving_http(card: str, r4, clips: list) -> dict:
    """r4's f32 artifact behind ``make_server`` at windows 0 and 20 ms: the
    served indices against ``TiTokModel.encode``, batched against single,
    ``/forward`` and ``/decode``, and ``serve_bench``."""
    import io
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from titok_tpu_torch.tools.serve import make_server
    from titok_tpu_torch.tools.serve_bench import run_bench

    art = os.path.join(SERVE_DIR, "r4_f32")
    vids, tcs = [c["video"] for c in clips[:4]], [1, 16, 64, 128]

    def post(url, **arrays):
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        with urllib.request.urlopen(url, buf.getvalue(), timeout=300) as r:
            return dict(np.load(io.BytesIO(r.read())))

    servers = []
    try:
        for window in (0.0, 20.0):
            server = make_server(art, port=0, window_ms=window)
            servers.append(server)
            threading.Thread(target=server.serve_forever, daemon=True).start()
        single, batched = (f"http://127.0.0.1:{s.server_address[1]}" for s in servers)
        want = r4.encode(vids, tcs)
        got = [post(single + "/encode", video=v, tokens=t)["indices"] for v, t in zip(vids, tcs)]
        for i, (a, b) in enumerate(zip(got, want)):
            check(np.array_equal(a, b), f"served indices of clip {i} differ from "
                  "TiTokModel.encode's")
        fwd = post(single + "/forward", video=vids[3], tokens=128)
        check(np.array_equal(fwd["indices"], want[3]), "/forward indices differ from encode's")
        dec = post(single + "/decode", indices=want[3], grid=np.asarray(fwd["video"].shape[1:]))
        ref = r4.decode_indices([want[3]], [fwd["video"].shape[1:]])[0]
        diff = float(np.abs(dec["video"] - ref).max())
        check(diff <= EXPORT_ATOL, f"/decode max|diff| {diff:.3e} from decode_indices")
        post(batched + "/encode", video=vids[0], tokens=1)  # first call out of the count
        calls0 = servers[1].service.device_calls
        gate = threading.Barrier(len(vids))

        def one(i):
            gate.wait()
            return post(batched + "/encode", video=vids[i], tokens=tcs[i])["indices"]

        with ThreadPoolExecutor(len(vids)) as ex:
            out = list(ex.map(one, range(len(vids))))
        calls = servers[1].service.device_calls - calls0
        check(all(np.array_equal(a, b) for a, b in zip(out, got)),
              "batched serving differs from single serving")
        check(calls < len(vids), f"no batching at 20 ms: {calls} device calls for {len(vids)} "
              "concurrent requests")
        print(f"http: r4 f32 artifact on 127.0.0.1; /encode of 4 committed clips (1, 16, 64, "
              f"128 tokens) equal to TiTokModel.encode's; /forward's indices equal, /decode "
              f"max|diff| {diff:.3e}; 4 concurrent requests at 20 ms: {calls} device call(s), "
              "the single-request indices")
    finally:
        for server in servers:
            server.shutdown()
            server.server_close()
            server.service.close()
    reset_counts()  # this path: the two bench runs
    for window in (0.0, 20.0):
        res = run_bench(art, op="forward", clients=8, requests=64, thw=(8, 128, 128), tokens=64,
                        window_ms=window, uint8=True)
        check(res["ok"] == res["requests"] and not res["errors"],
              f"serve_bench at {window} ms: {res}")
        print(f"serve_bench [{card}]: {json.dumps(res)}")
        if window > 0:
            check(res["clips_per_call"] > 1, f"serve_bench at {window} ms batched nothing: {res}")
    return {"http_bench_r4": read_counts()}


def _int_mm_unpadded_fault(r4) -> None:
    """The planted fault: the FSQ encoder's ``proj_out`` (width -> 5) with
    its int8 weight left unpadded; ``torch._int_mm`` on the card must
    raise, never fall back."""
    import torch

    from titok_tpu_torch.serving.quant import _int8_dense, quantize_kernel

    layer = r4.module.encoder.proj_out
    k = quantize_kernel(layer.weight.detach())
    x = torch.randn(4096, layer.in_features, device="cuda")
    try:
        _int8_dense(x, k["q"], k["s"], layer.bias, "w8a8", torch.float32)
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"planted fault (proj_out's int8 weight unpadded, N = {k['q'].shape[0]}) "
              f"rejected: torch._int_mm raised: {str(e).splitlines()[0][:160]}")
        return
    raise SmokeFailure("planted fault (proj_out unpadded) ran: torch._int_mm took N = 5")


def phase_serving_tools(card: str) -> dict:
    """The serving tools on the card: r4's int8 scores through the evaluate
    CLI's functions; r4 and base_vq exported and loaded in a fresh process;
    the HTTP server and its load bench over r4's f32 artifact; three
    planted faults."""
    import shutil

    import torch

    t0 = time.perf_counter()
    with np.load(os.path.join(PARITY_DIR, "eval_clips.npz")) as f:
        clips = [{"video": f[f"clip_{i}"], "fps": int(fps)} for i, fps in enumerate(f["fps"])]
    paths = _serving_quant(card, clips)
    r4, base_vq = _r4_model(), _base_vq_model()
    try:
        _int_mm_unpadded_fault(r4)
        paths.update(_serving_export(card, r4, base_vq, clips))
        del base_vq
        torch.cuda.empty_cache()
        paths.update(_serving_http(card, r4, clips))
    finally:
        shutil.rmtree(SERVE_DIR, ignore_errors=True)
    print(f"serving tools: phase {time.perf_counter() - t0:.1f} s [{card}]")
    return paths


def f32_launch_shape(kind: str, hq: int, hkv: int, rope: bool) -> dict:
    """The launch shape the library reports for the pipelined f32 forward
    (``kind`` "fwd"), dq ("dq") or dk/dv ("dkv") at hq / hkv heads:
    threads, dynamic shared memory, registers, CTAs an SM, heads (or warp
    groups) a CTA, rows a thread, kv rows a tile, and the K/V buffers (fwd),
    kv column passes a tile (dq) or ring stages (dkv) as "stages". The v1
    f32 kernels are the plain instantiations, built with the same flags."""
    from titok_tpu_torch.ops import _build

    lib = _build.load("flash_segment_attn_fwd" if kind == "fwd" else "flash_segment_attn_bwd")
    fn = getattr(lib, f"flash_segment_attn_f32_{kind}_config")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 8)()
    err = fn(hq, hkv, int(rope), out)
    check(err == 0, f"flash_segment_attn_f32_{kind}_config failed: CUDA error {err}")
    keys = ("threads", "smem_bytes", "registers", "ctas_per_sm", "heads", "rows_a_thread",
            "kv_rows", "stages")
    return dict(zip(keys, list(out)))


def print_f32_table(card: str, kres: dict, bres: dict, rres: dict, v1res: dict) -> None:
    """The f32 rows of the kernel table (PERF.md §6): each f32 entry of rows
    1-4 and of v1 (the row 1 forward and the row 2 dq and dk/dv on one id
    vector) at the shapes timed above, its time, bound and share of bound,
    and its launch shape as the library reports it."""
    rows = [("flash_segment_attn_fwd_f32", "fwd", False, kres["f32"], "bench 4/2", (4, 2)),
            ("flash_segment_attn_fwd_f32", "fwd", False, kres["f32"]["at_base_12_4"],
             "base_vq 12/4", (12, 4)),
            ("flash_segment_attn_bwd_dq_f32", "dq", False, bres["dq_f32"], "bench 4/2", (4, 2)),
            ("flash_segment_attn_bwd_dq_f32", "dq", False, bres["dq_f32"]["at_base_12_4"],
             "base_vq 12/4", (12, 4)),
            ("flash_segment_attn_bwd_dkv_f32", "dkv", False, bres["dkv_f32"], "bench 4/2", (4, 2)),
            ("flash_segment_attn_bwd_dkv_f32", "dkv", False, bres["dkv_f32"]["at_base_12_4"],
             "base_vq 12/4", (12, 4))]
    for k in ("fwd", "dq", "dkv"):
        name = f"flash_segment_attn_rope_{'fwd' if k == 'fwd' else 'bwd_' + k}_f32"
        rows.append((name, k, True, rres[f"{k}_f32"], "large 16/4", (16, 4)))
        rows.append((name, k, True, rres[f"{k}_f32"]["at_bench_4_2"], "bench 4/2", (4, 2)))
    for k in ("fwd", "dq", "dkv"):
        name = f"flash_segment_attn_v1_{'fwd' if k == 'fwd' else 'bwd_' + k}_f32"
        rows.append((name, k, False, v1res[f"{k}_f32"], "bench 4/2", (4, 2)))
        rows.append((name, k, False, v1res[f"{k}_f32"]["at_base_12_4"], "base_vq 12/4", (12, 4)))
    for name, kind, rope, r, layout, (hq, hkv) in rows:
        sh = f32_launch_shape(kind, hq, hkv, rope)
        unit = {"fwd": "heads", "dq": "heads", "dkv": "warp groups"}[kind]
        last = {"fwd": "K/V buffer(s) each", "dq": "kv column pass(es) a tile",
                "dkv": "ring stage(s)"}[kind]
        shape = (f"{sh['threads']} threads, {sh['registers']} registers, "
                 f"{sh['smem_bytes']} B dynamic shared memory, {sh['ctas_per_sm']} CTAs an SM, "
                 f"{sh['heads']} {unit} a CTA, {sh['rows_a_thread']} rows a thread, "
                 f"{sh['kv_rows']}-row kv tiles, {sh['stages']} {last}")
        print(f"f32 kernel table row {name} {layout} [{card}]: {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share of bound "
              f"{100 * r['bound_ms'] / r['ms']:.1f} %; {shape}")


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
    if not os.path.isdir(os.path.join(REPO, "titok_tpu_torch")) or not all(
            os.path.exists(os.path.join(REPO, "configs", c))
            for c in ("tiny.yaml", "base_vq.yaml", "large.yaml", "tiny_fsq16k.yaml")):
        print("FAIL: run chip_smoke.py from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from titok_tpu_torch.config import load_config

    t_start = time.perf_counter()

    def timed(phase, *args):
        """``phase(*args)``, then its seconds and the script's so far."""
        t0 = time.perf_counter()
        out = phase(*args)
        print(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s (script at "
              f"{time.perf_counter() - t_start:.1f} s)", flush=True)
        return out

    try:
        card = timed(phase_build)
        kres = timed(phase_kernels, card)
        bres = timed(phase_bwd_kernels, card, train_config())
        vres = timed(phase_vq_kernel, card)
        paths = timed(phase_serving, card)
        timed(phase_lpips, card)
        paths.update(timed(phase_training, card))
        paths.update(timed(phase_serving_vq, card))
        paths.update(timed(phase_training_vq, card))
        large_train = large_config("tokenizer.losses.perceptual_weight=0",
                                   "tokenizer.losses.gram_weight=0")
        rres = timed(phase_rope_kernels, card, large_train)
        paths.update(timed(phase_serving_large, card))
        paths.update(timed(phase_training_large, card))
        paths.update(timed(phase_remat_large_f32, card))
        v1res = timed(phase_v1_kernels, card, load_config(TINY16K, tiny16k_overrides("kernels")))
        paths.update(timed(phase_trainer, card))
        timed(phase_trainer_cli, card)
        paths.update(timed(phase_resume_f32, card))
        paths.update(timed(phase_data, card))
        paths.update(timed(phase_parity, card))
        paths.update(timed(phase_metrics, card))
        paths.update(timed(phase_serving_tools, card))
        paths.update(timed(phase_scan, card))
        paths.update(timed(phase_supervised_alllarge, card))
        timed(print_f32_table, card, kres, bres, rres, v1res)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    # launches: each path's counts were set to 0 just before it ran and read
    # just after; a kernel's "launches" is its count on the training path of
    # its dtype (bf16: the tiny main path, 6 steps; f32: the f32 kernel path;
    # the VQ kernel: the base_vq training path, 5 steps; the rope kernels:
    # the large training path, bf16 5 steps, f32 the remat run of the f32
    # check, one grad pass and 2 steps; the v1 kernels: the trainer's fit of
    # tiny_fsq16k, bf16 8 steps and 2 evals, f32 the straight 4-step run)
    entries = [(f"flash_segment_attn_fwd_{d}", KERNEL_SRC, KERNEL_REPLACES, d, kres[d],
                f"train_{d}") for d in ("bf16", "f32")]
    entries += [(f"flash_segment_attn_bwd_{k}_{d}", BWD_SRC, BWD_REPLACES[k], f"bwd_{k}_{d}",
                 bres[f"{k}_{d}"], f"train_{d}") for k in ("dq", "dkv") for d in ("bf16", "f32")]
    entries.append(("vq_nearest_f32", VQ_SRC, VQ_REPLACES, "vq_f32", vres, "train_base_vq"))
    for k, src in (("fwd", KERNEL_SRC), ("dq", BWD_SRC), ("dkv", BWD_SRC)):
        for d, main_path in (("bf16", "train_large"), ("f32", "train_large_f32")):
            key = f"rope_{d}" if k == "fwd" else f"rope_bwd_{k}_{d}"
            name = f"flash_segment_attn_rope_{'fwd' if k == 'fwd' else 'bwd_' + k}_{d}"
            entries.append((name, src, ROPE_REPLACES[k], key, rres[f"{k}_{d}"], main_path))
    for k in ("fwd", "dq", "dkv"):
        for d in ("bf16", "f32"):
            key = f"v1_{d}" if k == "fwd" else f"v1_bwd_{k}_{d}"
            name = f"flash_segment_attn_v1_{'fwd' if k == 'fwd' else 'bwd_' + k}_{d}"
            entries.append((name, V1_SRC, V1_REPLACES[k], key, v1res[f"{k}_{d}"],
                            f"train_v1_{d}"))
    kernels = []
    for name, src, replaces, key, r, main_path in entries:
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": paths[main_path][key],
            "launches_by_path": {p: c[key] for p, c in paths.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            # the attention kernels' times at the base_vq layout, heads 12/4;
            # the rope kernels' (timed at the large layout) at the bench shape
            **{k: r[k] for k in ("at_base_12_4", "at_bench_4_2", "wrapper_vs_unfused_ms")
               if k in r},
        })
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        print(f"FAIL: not launched on their training path: {idle}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
