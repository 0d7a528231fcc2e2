// Segment-masked GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` reached through `_mh_fwd`
// (titok_tpu/ops/flash_attention_mh.py), entry `flash_segment_attention_mh`.
//
// Computes, for every q row i and q head h (kv head hk = h / (Hq/Hkv)):
//   s_ij = (q_i . k_j) * scale           fp32, masked to -1e30 unless seg_q[i] == seg_k[j]
//   online softmax in fp32: m, l; p = mask ? exp(s - m_new) : 0
//   acc += bf16(p) @ v                   p rounded to v's dtype before the PV product
//   out = acc / max(l, 1e-30),  lse = m + log(max(l, 1e-30))
// Pad slots (segment 0) are remapped to 2^30 on load, so ids are
// non-decreasing and pad rows attend among themselves, as in the JAX kernel.
//
// Inputs: q [S, Hq*64], k/v [Sk, Hkv*64] row-major (the JAX [S,H,D] layout),
// int32 segment ids; outputs: out [S, Hq*64] in q's dtype, lse [S, Hq] f32.
//
// What bounds it on the H100: at the serving shape (S = 6144, ten 576-row
// segments, Hq/Hkv = 4/2, D = 64, bf16) the useful work is
// 4*D*Hq*sum(L_b^2) = 3.4 GFLOP, 3.4 us at 989 TFLOP/s, and the bytes
// (q, k, v, out, lse, ids: ~9.6 MB) take 2.9 us at 3.35 TB/s: compute-bound,
// on the tensor cores, and only on the block-diagonal part of S x Sk. Once
// the loads are overlapped and the operands come by ldmatrix, the kernel
// with both products removed still takes two thirds of its time (measured
// on the card, PERF.md): what bounds it is the softmax's per-element ALU
// work and the per-tile overhead, not the tensor cores.
//
// What the design does about it:
// - Block skipping without a pre-pass: segments are contiguous, so each
//   CTA searches seg_k for the exact kv interval
//   [lower_bound(seg_q[first]), upper_bound(seg_q[last])) of its q tile and
//   visits nothing else (the JAX kernel visits whole blocks of a
//   host-computed interval). Two warps search at once, 32 probes a step. No
//   padding of S or Sk: ragged edges are masked.
// - bf16: one CTA per (64-row q tile, HPC q heads of one GQA group), as the
//   JAX kernel takes a q block's heads in one grid step: each staged K/V
//   tile serves HPC * 64 (row, head) pairs, 4 warps per head, 16 rows a
//   warp. HPC is 2 for the plain kernel (two CTAs an SM) and 4 for RoPE
//   (its per-tile copies and rotation are shared by more heads); then 3, 2;
//   a group of one head takes 128 q rows.
// - A ring of NS = 3 K/V tiles in dynamic shared memory, filled by 16-byte
//   cp.async (zero-filled past the interval), with two mbarriers a stage
//   instead of block barriers: `ready` (every thread has finished its copies
//   of the tile) and `empty` (every thread has computed on it). Each
//   iteration prepares tile t + 1, refills the stage of tile t - 1 with tile
//   t + 2 once it is empty, and computes tile t; a warp may run a tile ahead
//   of the slowest, so the CTA's warps are not all in the tensor-core or all
//   in the softmax phase at once.
// - Q K^T and P V on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
//   accumulate); A fragments of Q and B fragments of K by ldmatrix.x4, of V
//   by ldmatrix.x4.trans; the softmax stays in registers (the S accumulator's
//   fragment layout is reused as the A operand of P V).
// - The softmax in log2 units: scale * log2(e) folded into the scores, p by
//   one ex2.approx each; masked scores are -inf, and a row with no live
//   column yet subtracts 0, so no select per element; a tile whose first
//   and last ids are both rows' id (ids are non-decreasing) skips the
//   compares. lse leaves in natural-log units, as the backward reads it.
// - Registers: 128 a thread (153 at HPC 3), no spills; the table helpers
//   read threadIdx.x afresh so their per-thread offsets are not held across
//   the loop.
// - f32: its own template, `fwd_f32_pipe` (segment_attn_fwd.cuh).
// Not yet: wgmma and TMA (B from the ring straight into the tensor cores),
// 32 q rows a warp (B fragments shared by two m-tiles).
//
// RoPE fused (kRope = true; entry `flash_segment_attn_rope_fwd`): replaces
// `_fwd_kernel_rope` reached through `_rope_fwd` (attn_impl 'flash_rope').
// q and k come in unrotated with per-row tables cos/sin [rows, P] f32 (k
// may have its own); each interleaved pair (x[2p], x[2p+1]), p < P, is
// rotated in fp32 and rounded to the input dtype. cp.async brings a tile
// into shared memory without passing through registers, so the rotation is
// a pass over the arrived tile: the thread that copied a 16-byte chunk also
// copied that chunk's table entries (8-byte copies where P is even) into
// the CTA's one table buffer, and after its own cp.async wait it rotates the
// chunk in place before it arrives on the tile's `ready`. Q is rotated once
// per CTA, each K tile once per CTA, for all HPC heads. The rotation rounds each product and sum on its own (no FMA), as
// the port's elementwise apply_rotary_emb does, and both instantiations
// take the same tiles in the same order with the same arithmetic, so the
// fused forward equals apply_rotary_emb + this kernel bit for bit. The
// tables add (S + Sk) * P * 8 bytes of reads; the bound is that of the
// unfused kernel.
//
// f32 (`fwd_f32_pipe<kRope, HPC, RT, MINB>`, both entries with is_bf16 = 0):
// in segment_attn_fwd.cuh, shared with the v1 f32 forward; its design is
// described there.

#include "segment_attn_fwd.cuh"

namespace {

template <bool kRope>
int launch_fwd(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_k,
               void* out, float* lse, int S, int Sk, int hq, int hkv, float scale, int is_bf16,
               Rope rq, Rope rk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_fwd_bf16<kRope>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg_q, seg_k,
        static_cast<__nv_bfloat16*>(out), lse, S, Sk, hq, hkv, scale, rq, rk, st);
  }
  return launch_fwd_f32<kRope>(static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), seg_q, seg_k,
                               static_cast<float*>(out), lse, S, Sk, hq, hkv, scale, rq, rk, st);
}

}  // namespace

// q [S, hq*64], k/v [Sk, hkv*64], seg_q [S], seg_k [Sk] int32 (non-decreasing
// once 0 is remapped to 2^30); out [S, hq*64] in q's dtype, lse [S, hq] f32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_segment_attn_fwd(const void* q, const void* k, const void* v,
                                      const int* seg_q, const int* seg_k, void* out,
                                      float* lse, int S, int Sk, int hq, int hkv,
                                      float scale, int is_bf16, void* stream) {
  return launch_fwd<false>(q, k, v, seg_q, seg_k, out, lse, S, Sk, hq, hkv, scale, is_bf16,
                           Rope{}, Rope{}, stream);
}

// The same with RoPE fused: q and k unrotated, cos_q/sin_q [S, P] and
// cos_k/sin_k [Sk, P] f32 (pass q's for k when k has none), 1 <= P <= 32.
extern "C" int flash_segment_attn_rope_fwd(const void* q, const void* k, const void* v,
                                           const int* seg_q, const int* seg_k,
                                           const float* cos_q, const float* sin_q,
                                           const float* cos_k, const float* sin_k, int P,
                                           void* out, float* lse, int S, int Sk, int hq,
                                           int hkv, float scale, int is_bf16, void* stream) {
  return launch_fwd<true>(q, k, v, seg_q, seg_k, out, lse, S, Sk, hq, hkv, scale, is_bf16,
                          make_rope(cos_q, sin_q, P), make_rope(cos_k, sin_k, P), stream);
}

// The f32 kernel's launch shape at hq / hkv heads (kRope when rope != 0):
// out[8] = threads a CTA, dynamic shared memory bytes, registers a thread,
// CTAs an SM, q heads a CTA, q rows a thread, kv rows a tile, K/V buffers.
// Launches nothing; returns a CUDA error code.
extern "C" int flash_segment_attn_f32_fwd_config(int hq, int hkv, int rope, int* out) {
  return rope ? launch_fwd_f32<true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                     nullptr, 0, 0, hq, hkv, 0.f, Rope{}, Rope{}, 0, out)
              : launch_fwd_f32<false>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                      nullptr, 0, 0, hq, hkv, 0.f, Rope{}, Rope{}, 0, out);
}
