// Segment-masked GQA flash attention, the v1 kernels, for Hopper (sm_90a):
// forward, dq and dk/dv.
//
// Replaces the TPU kernels of titok_tpu/ops/flash_attention.py
// (attn_impl 'flash_v1'): `_fwd_kernel` reached through `_flash_fwd`, and
// `_bwd_dq_kernel` and `_bwd_dkv_kernel` reached through `_flash_bwd`, the
// custom_vjp backward of `flash_segment_attention`.
//
// The function is that of flash_segment_attn_{fwd,bwd}.cu, for q, k and v
// of one length S (Sq == Sk, one id vector): for q row i, q head h (kv head
// hk = h / (Hq/Hkv)) and kv row j,
//   s_ij  = (q_i . k_j) * scale, masked to -1e30 unless seg[i] == seg[j]
//   forward: online softmax in fp32 over kv tiles in order; p = exp(s - m)
//            with m the running max after the tile, rounded to v's dtype
//            before P V; out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))
//   backward (lse and delta = rowsum(dO * O) given): p_ij = exp(s_ij - lse_i),
//            ds_ij = p_ij * (dO_i . v_j - delta_i) * scale;
//            dq_i = sum_j bf16(ds_ij) k_j;
//            PER Q HEAD h: dk_j^h = sum_i bf16(ds_ij) q_i, dv_j^h = sum_i bf16(p_ij) dO_i,
//            each rounded to the input dtype, then summed over each GQA
//            group (JAX sums its kernel's dk_h, dv_h in XLA). So in bf16 each
//            head's dk/dv is rounded before the group sum; the row 2 kernel
//            instead sums the group in fp32 and rounds once.
// bf16 roundings happen where the JAX kernels `.astype` (p, ds); in f32
// nothing is rounded. Pad slots (id 0) are remapped to 2^30 on load.
//
// Every v1 kernel is an instantiation of the pipelined templates of rows
// 1-2 (the designs are described in flash_segment_attn_{fwd,bwd}.cu and the
// headers); each CTA finds the exact kv (or q) interval of its tile by a
// search over the ids, so no v1 kernel reads tile intervals:
// - bf16 forward: `fwd_bf16_pipe<false, HPC, QR, true>` (segment_attn_fwd.cuh),
//   the row 1 forward whose kv tiles are the 64-row tiles of S aligned to
//   row 0, where v1 rounds p against the running max: the interval's start
//   is rounded down to a multiple of 64, and the rows before it are masked.
//   Where every segment starts at a multiple of 64 it gives row 1's bits.
// - dq: the row 2 dq `bwd_dq_pipe<false, HPC>` (segment_attn_dq.cuh), with
//   the one id vector for q and kv: the same function, the same bits. The
//   f32 dq likewise is the row 2 f32 dq `bwd_dq_f32_pipe<false, ...>`.
// - bf16 dk/dv: `bwd_dkv_pipe<false, NG, true>` (segment_attn_dkv.cuh), the
//   row 2 dk/dv kernel with v1's rounding: one CTA per (64-row kv tile, kv
//   head), NG warp groups share K and V and take one q head each of a (q
//   tile, NG heads) unit from a 2-stage cp.async ring. Its kV1 flag rounds
//   each head's f32 sums to bf16 before the group's heads are added, in
//   head order, and the sum rounded once: it writes the group-summed dk/dv
//   [S, Hkv*64] itself, and the wrapper runs no group sum. Where a group
//   has more heads than warp groups (Hq/Hkv > 4, as 8/1), the heads go in
//   chunks of NG, and each chunk's rounded heads are folded into a running
//   sum in shared memory.
// - f32 forward and dk/dv: in f32 v1 rounds nothing, so its forward is the
//   row 1 f32 forward's function and its group-summed dk/dv the row 2 f32
//   dk/dv's, which differ only in the order of fp32 sums. They are those
//   kernels on one id vector, `fwd_f32_pipe<false, ...>`
//   (segment_attn_fwd.cuh) and `bwd_dkv_f32_pipe<false, ...>`
//   (segment_attn_dkv.cuh), and give their bits: the dk/dv writes dk, dv
//   [S, Hkv*64] summed over each group in the kernel, in a fixed order.
// Rows at or past S are masked (their ids are sentinels that match
// nothing) and never written.
//
// What bounds it on the H100: the same work as rows 1-2 (useful FLOPs on
// the block-diagonal part of S x S: forward 2, dq 3, dk/dv 4 products of
// S x S x 64 per q head; at the bench shape, S 6144 in ten 576-row
// segments, heads 4/2, bf16: 3.4 + 5.1 + 6.8 GFLOP, 3.4 / 5.2 / 6.9 us at
// 989 TFLOP/s) against bytes that take 3-6 us at 3.35 TB/s. Compute-bound
// on paper; f32 on fp32 FMA (TF32 cannot hold the f32 limits).

#include "segment_attn_dkv.cuh"
#include "segment_attn_dq.cuh"
#include "segment_attn_fwd.cuh"

// q [S, hq*64], k/v [S, hkv*64], seg [S] int32 (non-decreasing once 0 is
// remapped to 2^30); out [S, hq*64] in q's dtype, lse [S, hq] f32: the row 1
// forward on one id vector (bf16: with its kv tiles aligned to row 0).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int flash_segment_attn_v1_fwd(const void* q, const void* k, const void* v,
                                         const int* seg, void* out, float* lse, int S, int hq,
                                         int hkv, float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_fwd_bf16<false, true>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg, seg, static_cast<__nv_bfloat16*>(out), lse, S,
        S, hq, hkv, scale, Rope{}, Rope{}, st);
  return launch_fwd_f32<false>(static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), seg, seg, static_cast<float*>(out),
                               lse, S, S, hq, hkv, scale, Rope{}, Rope{}, st);
}

// dq [S, hq*64] from q, dO [S, hq*64], k/v, ids, lse and delta [S, hq] f32:
// the row 2 dq on one id vector, in either dtype.
extern "C" int flash_segment_attn_v1_bwd_dq(const void* q, const void* k, const void* v,
                                            const int* seg, const void* dout, const float* lse,
                                            const float* delta, void* dq, int S, int hq, int hkv,
                                            float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dq_bf16<false>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg, seg, static_cast<const __nv_bfloat16*>(dout),
        lse, delta, static_cast<__nv_bfloat16*>(dq), S, S, hq, hkv, scale, Rope{}, Rope{}, st);
  return launch_dq_f32<false>(static_cast<const float*>(q), static_cast<const float*>(k),
                              static_cast<const float*>(v), seg, seg,
                              static_cast<const float*>(dout), lse, delta,
                              static_cast<float*>(dq), S, S, hq, hkv, scale, Rope{}, Rope{}, st);
}

// dk, dv [S, hkv*64] from q, dO [S, hq*64], k/v, ids, lse and delta [S, hq]
// f32, summed over each kv head's group of q heads in the kernel. bf16:
// each q head's share rounded to bf16, then summed in f32 in head order and
// rounded once; f32: the row 2 f32 dk/dv on one id vector.
extern "C" int flash_segment_attn_v1_bwd_dkv(const void* q, const void* k, const void* v,
                                             const int* seg, const void* dout, const float* lse,
                                             const float* delta, void* dk, void* dv, int S,
                                             int hq, int hkv, float scale, int is_bf16,
                                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dkv_bf16<false, true>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg, seg, static_cast<const __nv_bfloat16*>(dout),
        lse, delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, S, hq,
        hkv, scale, Rope{}, Rope{}, st);
  return launch_dkv_f32<false>(static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), seg, seg,
                               static_cast<const float*>(dout), lse, delta,
                               static_cast<float*>(dk), static_cast<float*>(dv), S, S, hq, hkv,
                               scale, Rope{}, Rope{}, st);
}

// 1: the bf16 dk/dv entry writes dk, dv summed over each group ([S, hkv*64]);
// builds without this symbol wrote each q head's ([S, hq*64]). Read by the
// A/B tool, which times builds of either kind.
extern "C" int flash_segment_attn_v1_dkv_summed() { return 1; }

// 1: the bf16 forward and dq entries search the ids and read no tile
// intervals; builds without this symbol read them, and their wrapper ran
// `tile_minmax` before each launch. Read by the A/B tool.
extern "C" int flash_segment_attn_v1_bf16_searches() { return 1; }

// 1: the f32 dq entry is the row 2 f32 dq on one id vector, searches the ids
// and reads no tile intervals; builds without this symbol read them (tiles
// of 32 q and 32 kv rows), and their wrapper ran `tile_minmax` before each
// launch. Read by the A/B tool.
extern "C" int flash_segment_attn_v1_f32_dq_searches() { return 1; }

// 1: no entry takes tile intervals: the three entries take no qmm, kmm, tq
// and tk arguments, and the f32 forward and dk/dv are the row 1 and row 2
// f32 kernels on one id vector, the dk/dv summed over each group. Builds
// without this symbol took them after the ids (q and kv intervals, int32
// [tiles, 2], then the q and kv tile rows); their f32 forward read tiles of
// 64 q and 32 kv rows, their f32 dk/dv tiles of 32 and 32 and wrote each q
// head's dk/dv ([S, hq*64]), which their wrapper summed over each group.
// Read by the A/B tool.
extern "C" int flash_segment_attn_v1_f32_searches() { return 1; }
