// Segment-masked GQA flash-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` reached
// through `_mh_bwd` (titok_tpu/ops/flash_attention_mh.py), the custom_vjp
// backward of `flash_segment_attention_mh`.
//
// Given the forward's q, k, v, ids and lse, the output gradient dO and
// delta = rowsum(dO * O) per head (computed outside, in f32), for every q
// row i, q head h (kv head hk = h / (Hq/Hkv)) and kv row j:
//   p_ij  = seg_q[i] == seg_k[j] ? exp(s_ij - lse_i) : 0,  s_ij = (q_i . k_j) * scale
//   dp_ij = dO_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i) * scale
//   dq_i  = sum_j bf16(ds_ij) k_j
//   dk_j  = sum_{h in group} sum_i bf16(ds_ij) q_i,   dv_j = sum_{h in group} sum_i bf16(p_ij) dO_i
// The bf16 roundings of p and ds are the JAX kernels' (`.astype` before the
// products); in f32 nothing is rounded. Pad slots (segment 0) are remapped
// to 2^30, as in the forward, so every row attends at least to itself and
// lse is finite; ids need only be non-decreasing (the stacked
// discriminator buffer has no id 0 at all).
//
// Inputs: q, dO [S, Hq*64], k/v [Sk, Hkv*64] row-major (the JAX [S,H,D]
// layout), int32 ids [S]/[Sk], lse and delta [S, Hq] f32. Outputs: dq
// [S, Hq*64], dk/dv [Sk, Hkv*64], in q's dtype.
//
// What bounds it on the H100: at the bench shape (S = 6144, ten 576-row
// segments, Hq/Hkv = 4/2, D = 64, bf16) the five products (S, dP and dQ in
// one kernel, S, dP, dV and dK in the other; S and dP are recomputed)
// are 10 * D * Hq * sum(L_b^2) = 8.5 GFLOP of useful work, 8.6 us at
// 989 TFLOP/s; the bytes (q, k, v, O, dO, lse, delta, dq, dk, dv, each once:
// ~18 MB) take 5.5 us at 3.35 TB/s. Compute-bound, on the block-diagonal
// part of S x Sk only.
//
// What the design does about it:
// - Both kernels search the other side's ids for the exact interval of
//   their tile (two warps, 32 probes a step; the JAX `_overlap_ranges`) and
//   visit nothing else; tiles come through cp.async rings in dynamic shared
//   memory; operands are read by ldmatrix at each use; p = exp(s - lse) is
//   one ex2.approx of s scale log2(e) - lse log2(e); a tile whose first and
//   last ids are the rows' own id skips the compares (ids are
//   non-decreasing).
// - dq (`bwd_dq_pipe<kRope, HPC>`): one CTA per (64-row q tile, HPC q heads
//   of one GQA group), 4 warps a head, 16 q rows a warp:
//   - each staged K/V tile, its ids and (kRope) its table rows and rotation
//     serve HPC heads: the plain kernel takes 2 (two CTAs an SM), RoPE
//     DQ_ROPE_HPC = 4; then 3, 2, else 1 (HPC divides Hq/Hkv);
//   - Q and dO of the CTA's heads are staged once and read by ldmatrix.x4
//     (A of S = Q K^T and dP = dO V^T), K and V by ldmatrix.x4 (B of S, dP)
//     and K again by ldmatrix.x4.trans (B of dQ += bf16(dS) K); dS goes from
//     its accumulator to A fragments in registers;
//   - a ring of DQ_STAGES = 3 K/V tiles with two mbarriers a stage, `ready`
//     and `empty`, as in the forward: tile t + 2 is in flight while t is
//     computed, and a warp may run a tile ahead of the slowest;
//   - each tile in DQ_NPASS = 2 passes of 32 kv columns, so a thread holds
//     the f32 dq accumulator and one pass's S, dP and bf16(dS): no spills at
//     128 registers (256- and 512-thread CTAs; the plain instantiation runs
//     its passes rolled, as unrolled ptxas spilled 8-16 bytes of it);
//   - every CTA takes its q tile's kv tiles in ascending order and rounds
//     each dq element once, so both instantiations and every HPC give a
//     (row, head) the same arithmetic, and two launches the same bits.
// - dk/dv (`bwd_dkv_pipe`, in segment_attn_dkv.cuh, shared with the v1
//   backward): one CTA per (64-row kv tile, kv head). It walks the group's q
//   heads x the q tiles of its interval, so the work of a CTA is a long
//   chain; what the design does about that and the rest:
//   - NG warp groups (NG the largest of 4, 3, 2 that divides Hq/Hkv, else
//     1) share the stationary K and V in shared memory; group g takes q
//     head g of each unit, so the serial chain is Hq/Hkv/NG times shorter;
//   - units are (q tile, NG heads), q tile outer, heads inner: the q ids and,
//     kRope, q's table rows are staged once per q tile for all NG heads;
//   - a ring of DKV_STAGES = 2 units in dynamic shared memory, filled by
//     16-byte (tiles) and 4-byte (lse, delta, ids, tables) cp.async: unit
//     u+1 is in flight while u is computed; each thread prepares its own
//     copies of u+1 at the end of iteration u, so one barrier per unit both
//     publishes it and frees the other stage;
//   - K and V are read by ldmatrix.x4 at each use (A fragments), Q and dO
//     by ldmatrix.x4 (B of S^T, dP^T) and ldmatrix.x4.trans (B of dV, dK);
//   - each unit in 4 passes of 16 q columns, so a thread holds the two f32
//     accumulators and one pass's P^T and dP^T: 127-128 registers (152-156
//     with 3 groups) and no spills, 16 warps an SM at NG 4 or 2;
//   - the group's dk/dv: groups 1..NG-1 leave their f32 partial sums in the
//     idle ring, group 0 adds them in a fixed order and rounds to bf16 once.
//     No atomics: two launches give the same bits.
// - bf16 on mma.sync m16n8k16 (bf16 in, fp32 accumulate). f32 on fp32 FMA
//   (no TF32: the f32 path must hold tight tolerances against the plain
//   version): the dq is `bwd_dq_f32_pipe` (segment_attn_dq.cuh), the dk/dv
//   `bwd_dkv_f32_pipe` (segment_attn_dkv.cuh), each shared with its v1
//   kernel; the f32 dq's design below.
// Not yet: an asynchronous wgmma pipeline and TMA (a synchronous wgmma
// dk/dv was no faster: PERF.md).
//
// RoPE fused (kRope = true; entries `flash_segment_attn_rope_bwd_dq` and
// `..._rope_bwd_dkv`): replaces `_bwd_dq_kernel_rope` and
// `_bwd_dkv_kernel_rope`, reached through `_rope_bwd`, the custom_vjp
// backward `_mh_rope` of attn_impl 'flash_rope'. q and k come in unrotated
// with their tables, as in the forward: the kernels rotate q and k tiles as
// they are staged (dq: q once per CTA for all HPC heads and each k tile
// once per CTA; dk/dv: k once per CTA and each q tile once per CTA for all
// NG heads; in place in shared memory by the thread that copied the chunk
// and its table entries, after its own cp.async wait), so p and ds
// are those of the rotated q and k. The rotation is orthogonal, so the grads of the raw q and k are
// the grads of the rotated ones rotated back: the f32 dq and dk
// accumulators get the inverse rotation (sin negated) before their one
// rounding to the output dtype. dv is unrotated. In the bf16 kernels a
// thread's m16n8 accumulator fragment holds both columns of a pair, as a
// lane's float4s of dQ and dK do in the f32 dq and dk/dv.
//
// f32 dq (`bwd_dq_f32_pipe<kRope, HPC, RT, NP, MINB>`): IEEE fp32 FMA, no
// TF32 and no tensor cores, expf. What bounds it: the three products (S,
// dP, dQ) at the 67 TFLOP/s FMA peak (large 16/4: 15.9 GFLOP of live work,
// 0.237 ms). As in the forward, every FFMA takes an operand from shared
// memory; wavefronts per FFMA of each product loop, warp-wide:
// - S = Q K^T and dP = dO V^T (RT q rows x 64 / NP kv columns a lane), a
//   step of 4 d: RT float4 of Q (or dO) and 8 / NP of K (or V): 1/4 at RT
//   8, 3/8 at RT 4, 1/2 at RT 4 in two passes;
// - dQ += dS K (RT q rows x 8 d columns), a step of 4 kv rows: RT float4 of
//   dS and 8 of K: 1/4 at RT 8, 3/8 at RT 4;
// - the previous kernel: 8 scalar loads per 8 FFMA in S and dP, 6 per 8 in
//   dQ (rows padded to 65 floats): 1, 3/4.
// What the design does:
// - One CTA per (64-row q tile, HPC q heads of one GQA group); Q and dO of
//   its heads staged once by 16-byte cp.async into XOR-swizzled tiles, their
//   lse and delta by 4-byte copies beside them (held in registers, they made
//   the RoPE instantiation at HPC 1 spill). The group's heads share each
//   staged K and V tile; K and V have one buffer each with `full` and
//   `free` mbarriers, as in the forward. A tile takes dP first (V), then S
//   and dQ (K): V(t + 1) goes in once every warp is past dP(t) and lands
//   during dQ(t); K(t + 1) goes in once every warp is past dQ(t) and lands
//   during dP(t + 1). The tile ids are double-buffered, so K(t + 1)'s copy
//   never writes the ids tile t reads.
// - Lane (a, b) holds RT q rows (a + 4 i) x 8 / NP kv columns (b + 8 j) of
//   dP, then S, and the same rows x 8 d columns of dQ. dP, then dS, go
//   through a 4-byte-a-lane buffer of the warp's own rows (dP read back by
//   its writer for dS), so only warp barriers sit between the products.
//   Accumulators: 128 at RT 8 (S or dP 64, dQ 64), not the 192 of S, dP
//   and dQ held at once.
// - Each dq element is one fmaf chain over the q tile's kv rows in
//   ascending order, no atomics: two launches give the same bits, and so
//   does every HPC, RT and NP (the q tile is 64 rows for all).
// - Choices by group size: HPC 4 where 4 divide the group (RT 8, 256
//   threads, one CTA an SM, 232,192 B); 3 where 3 do (RT 4, 384 threads);
//   else 1 (RT 4, 128 threads, each kv tile in NP = 2 passes of 32 columns,
//   unrolled: half the dP / dS buffer, 75,008 B, three CTAs an SM, so at 4/2
//   its 384 CTAs run in one wave).
// - Heaviest q tiles first (`lpt_item`), as the forward.
// - RoPE: Q rotated once per CTA for all HPC heads, each K tile once per CTA
//   after its copy lands; dQ inverse-rotated in the lane, which holds both
//   columns of each pair (4 b.., 32 + 4 b..), before its one write.
//
// f32 dk/dv (`bwd_dkv_f32_pipe<kRope, NG, RT, STAGES, MINB, KV>`): in
// segment_attn_dkv.cuh, shared with the v1 f32 dk/dv; its design is
// described there.

#include "segment_attn_dkv.cuh"
#include "segment_attn_dq.cuh"

namespace {

template <bool kRope>
int launch_dq(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_k,
              const void* dout, const float* lse, const float* delta, void* dq, int S, int Sk,
              int hq, int hkv, float scale, int is_bf16, Rope rq, Rope rk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_dq_bf16<kRope>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg_q, seg_k,
        static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dq), S, Sk, hq, hkv, scale, rq, rk, st);
  }
  return launch_dq_f32<kRope>(static_cast<const float*>(q), static_cast<const float*>(k),
                              static_cast<const float*>(v), seg_q, seg_k,
                              static_cast<const float*>(dout), lse, delta,
                              static_cast<float*>(dq), S, Sk, hq, hkv, scale, rq, rk, st);
}

template <bool kRope>
int launch_dkv(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_k,
               const void* dout, const float* lse, const float* delta, void* dk, void* dv,
               int S, int Sk, int hq, int hkv, float scale, int is_bf16, Rope rq, Rope rk,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_dkv_bf16<kRope>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg_q, seg_k,
        static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, Sk, hq, hkv,
        scale, rq, rk, st);
  }
  return launch_dkv_f32<kRope>(static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), seg_q, seg_k,
                               static_cast<const float*>(dout), lse, delta,
                               static_cast<float*>(dk), static_cast<float*>(dv), S, Sk, hq, hkv,
                               scale, rq, rk, st);
}

}  // namespace

// dq [S, hq*64] from q, dO [S, hq*64], k/v [Sk, hkv*64], ids, lse and delta
// [S, hq] f32. Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_segment_attn_bwd_dq(const void* q, const void* k, const void* v,
                                         const int* seg_q, const int* seg_k, const void* dout,
                                         const float* lse, const float* delta, void* dq, int S,
                                         int Sk, int hq, int hkv, float scale, int is_bf16,
                                         void* stream) {
  return launch_dq<false>(q, k, v, seg_q, seg_k, dout, lse, delta, dq, S, Sk, hq, hkv, scale,
                          is_bf16, Rope{}, Rope{}, stream);
}

// dk, dv [Sk, hkv*64], summed over each kv head's group of q heads.
extern "C" int flash_segment_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                          const int* seg_q, const int* seg_k, const void* dout,
                                          const float* lse, const float* delta, void* dk,
                                          void* dv, int S, int Sk, int hq, int hkv, float scale,
                                          int is_bf16, void* stream) {
  return launch_dkv<false>(q, k, v, seg_q, seg_k, dout, lse, delta, dk, dv, S, Sk, hq, hkv,
                           scale, is_bf16, Rope{}, Rope{}, stream);
}

// RoPE fused: q and k unrotated, cos_q/sin_q [S, P] and cos_k/sin_k [Sk, P]
// f32 (q's again when k has none), 1 <= P <= 32; lse and delta those of the
// rope forward. dq and dk are the grads of the unrotated q and k.
extern "C" int flash_segment_attn_rope_bwd_dq(const void* q, const void* k, const void* v,
                                              const int* seg_q, const int* seg_k,
                                              const float* cos_q, const float* sin_q,
                                              const float* cos_k, const float* sin_k, int P,
                                              const void* dout, const float* lse,
                                              const float* delta, void* dq, int S, int Sk,
                                              int hq, int hkv, float scale, int is_bf16,
                                              void* stream) {
  return launch_dq<true>(q, k, v, seg_q, seg_k, dout, lse, delta, dq, S, Sk, hq, hkv, scale,
                         is_bf16, make_rope(cos_q, sin_q, P), make_rope(cos_k, sin_k, P), stream);
}

extern "C" int flash_segment_attn_rope_bwd_dkv(const void* q, const void* k, const void* v,
                                               const int* seg_q, const int* seg_k,
                                               const float* cos_q, const float* sin_q,
                                               const float* cos_k, const float* sin_k, int P,
                                               const void* dout, const float* lse,
                                               const float* delta, void* dk, void* dv, int S,
                                               int Sk, int hq, int hkv, float scale,
                                               int is_bf16, void* stream) {
  return launch_dkv<true>(q, k, v, seg_q, seg_k, dout, lse, delta, dk, dv, S, Sk, hq, hkv,
                          scale, is_bf16, make_rope(cos_q, sin_q, P), make_rope(cos_k, sin_k, P), stream);
}

// The f32 dk/dv kernel's launch shape at hq / hkv heads (kRope when rope !=
// 0): out[8] = threads a CTA, dynamic shared memory bytes, registers a
// thread, CTAs an SM, warp groups, kv rows a thread, kv rows a tile, ring
// stages. Launches nothing; returns a CUDA error code.
extern "C" int flash_segment_attn_f32_dkv_config(int hq, int hkv, int rope, int* out) {
  return rope ? launch_dkv_f32<true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, nullptr, nullptr, 0, 0, hq, hkv, 0.f,
                                     Rope{}, Rope{}, 0, out)
              : launch_dkv_f32<false>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                      nullptr, nullptr, nullptr, nullptr, 0, 0, hq, hkv, 0.f,
                                      Rope{}, Rope{}, 0, out);
}

// The f32 dq kernel's launch shape at hq / hkv heads (kRope when rope != 0):
// out[8] = threads a CTA, dynamic shared memory bytes, registers a thread,
// CTAs an SM, q heads a CTA, q rows a thread, kv rows a tile, kv column
// passes a tile. Launches nothing; returns a CUDA error code.
extern "C" int flash_segment_attn_f32_dq_config(int hq, int hkv, int rope, int* out) {
  return rope ? launch_dq_f32<true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                    nullptr, nullptr, nullptr, 0, 0, hq, hkv, 0.f, Rope{}, Rope{},
                                    0, out)
              : launch_dq_f32<false>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, nullptr, 0, 0, hq, hkv, 0.f, Rope{},
                                     Rope{}, 0, out);
}
