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
//   version), 32-row tiles and 256 threads, K and V in registers.
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
// thread's m16n8 accumulator fragment holds both columns of a pair; in the
// f32 kernels the pair is split over lanes tx and tx ^ 1 and meets by a
// shuffle.

#include "segment_attn_dkv.cuh"
#include "segment_attn_dq.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: fp32 FMA. 32-row tiles, 256 threads: thread (ty, tx) owns tile rows
// ty + 16 i (i < 2), score columns tx + 16 j (j < 2) and output columns
// tx + 16 j (j < 4). Padded strides keep each half-warp's column walks on
// distinct banks; a row's 16 owners read the same address (broadcast).
// ---------------------------------------------------------------------------

constexpr int BF = 32;

__device__ __forceinline__ void load_tile_f32(float (*dst)[D + 1], const float* src, int row0,
                                              int valid, int ld, int col0) {
  for (int e = threadIdx.x; e < BF * D; e += blockDim.x) {
    const int r = e / D, c = e % D;
    dst[r][c] = (row0 + r < valid) ? src[(size_t)(row0 + r) * ld + col0 + c] : 0.f;
  }
}

template <bool kRope>
__global__ void __launch_bounds__(256)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const int* __restrict__ seg_q,
           const int* __restrict__ seg_k, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, int S, int Sk, int hq, int hkv, float scale,
           Rope rq, Rope rk) {
  __shared__ float q_s[BF][D + 1];
  __shared__ float do_s[BF][D + 1];
  __shared__ float k_s[BF][D + 1];
  __shared__ float v_s[BF][D + 1];
  __shared__ float ds_s[BF][BF + 1];
  __shared__ int segq_s[BF];
  __shared__ int segk_s[BF];
  __shared__ int range_s[2];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BF;
  const int q1 = min(q0 + BF, S);
  const int h = blockIdx.y;
  const int hk = h / (hq / hkv);
  const int ldq = hq * D, ldk = hkv * D;

  if (tid == 0) segment_interval(seg_q, seg_k, q0, q1, Sk, &range_s[0], &range_s[1]);
  if constexpr (kRope) {
    load_rot_tile_f32<BF>(q_s, q, q0, S, ldq, h * D, rq);
  } else {
    load_tile_f32(q_s, q, q0, S, ldq, h * D);
  }
  load_tile_f32(do_s, dout, q0, S, ldq, h * D);
  if (tid < BF) segq_s[tid] = (q0 + tid < S) ? remap(seg_q[q0 + tid]) : NO_ROW_Q;
  __syncthreads();

  int sq[2];
  float ls[2], dl[2], acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ty + 16 * i;
    sq[i] = segq_s[ty + 16 * i];
    ls[i] = row < S ? lse[(size_t)row * hq + h] : 0.f;
    dl[i] = row < S ? delta[(size_t)row * hq + h] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  const int lo = range_s[0], hi = range_s[1];

  for (int kv0 = lo; kv0 < hi; kv0 += BF) {
    __syncthreads();
    if constexpr (kRope) {
      load_rot_tile_f32<BF>(k_s, k, kv0, hi, ldk, hk * D, rk);
    } else {
      load_tile_f32(k_s, k, kv0, hi, ldk, hk * D);
    }
    load_tile_f32(v_s, v, kv0, hi, ldk, hk * D);
    if (tid < BF) segk_s[tid] = (kv0 + tid < hi) ? remap(seg_k[kv0 + tid]) : NO_ROW_K;
    __syncthreads();

    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qv[2] = {q_s[ty][d], q_s[ty + 16][d]};
      const float ov[2] = {do_s[ty][d], do_s[ty + 16][d]};
      const float kv[2] = {k_s[tx][d], k_s[tx + 16][d]};
      const float vv[2] = {v_s[tx][d], v_s[tx + 16][d]};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = sq[i] == segk_s[tx + 16 * j] ? expf(s[i][j] * scale - ls[i]) : 0.f;
        ds_s[ty + 16 * i][tx + 16 * j] = p * (dp[i][j] - dl[i]) * scale;
      }
    __syncthreads();

#pragma unroll 8
    for (int r = 0; r < BF; ++r) {
      const float dsv[2] = {ds_s[ty][r], ds_s[ty + 16][r]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kk = k_s[r][tx + 16 * j];
        acc[0][j] = fmaf(dsv[0], kk, acc[0][j]);
        acc[1][j] = fmaf(dsv[1], kk, acc[1][j]);
      }
    }
  }

  if constexpr (kRope) {  // back to the raw q, before any lane leaves
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = inv_rot_split(acc[i][j], tx + 16 * j, rq, row, row < S);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[(size_t)row * ldq + h * D + tx + 16 * j] = acc[i][j];
  }
}

template <bool kRope>
__global__ void __launch_bounds__(256)
bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const int* __restrict__ seg_q,
            const int* __restrict__ seg_k, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int S, int Sk, int hq, int hkv,
            float scale, Rope rq, Rope rk) {
  __shared__ float k_s[BF][D + 1];
  __shared__ float v_s[BF][D + 1];
  __shared__ float q_s[BF][D + 1];
  __shared__ float do_s[BF][D + 1];
  __shared__ float p_s[BF][BF + 1];
  __shared__ float ds_s[BF][BF + 1];
  __shared__ float lse_s[BF];
  __shared__ float delta_s[BF];
  __shared__ int segq_s[BF];
  __shared__ int segk_s[BF];
  __shared__ int range_s[2];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BF;
  const int k1 = min(k0 + BF, Sk);
  const int hk = blockIdx.y;
  const int rep = hq / hkv;
  const int ldq = hq * D, ldk = hkv * D;

  if (tid == 0) segment_interval(seg_k, seg_q, k0, k1, S, &range_s[0], &range_s[1]);
  if constexpr (kRope) {
    load_rot_tile_f32<BF>(k_s, k, k0, Sk, ldk, hk * D, rk);
  } else {
    load_tile_f32(k_s, k, k0, Sk, ldk, hk * D);
  }
  load_tile_f32(v_s, v, k0, Sk, ldk, hk * D);
  if (tid < BF) segk_s[tid] = (k0 + tid < Sk) ? remap(seg_k[k0 + tid]) : NO_ROW_K;
  __syncthreads();

  const int sk[2] = {segk_s[ty], segk_s[ty + 16]};
  const int lo = range_s[0], hi = range_s[1];
  float dka[2][4], dva[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int hr = 0; hr < rep; ++hr) {
    const int h = hk * rep + hr;
    for (int qs0 = lo; qs0 < hi; qs0 += BF) {
      __syncthreads();
      if constexpr (kRope) {
        load_rot_tile_f32<BF>(q_s, q, qs0, hi, ldq, h * D, rq);
      } else {
        load_tile_f32(q_s, q, qs0, hi, ldq, h * D);
      }
      load_tile_f32(do_s, dout, qs0, hi, ldq, h * D);
      if (tid < BF) {
        const bool ok = qs0 + tid < hi;
        segq_s[tid] = ok ? remap(seg_q[qs0 + tid]) : NO_ROW_Q;
        lse_s[tid] = ok ? lse[(size_t)(qs0 + tid) * hq + h] : 0.f;
        delta_s[tid] = ok ? delta[(size_t)(qs0 + tid) * hq + h] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: kv rows ty + 16 i, q columns tx + 16 j
      float st[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dpt[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kv[2] = {k_s[ty][d], k_s[ty + 16][d]};
        const float vv[2] = {v_s[ty][d], v_s[ty + 16][d]};
        const float qv[2] = {q_s[tx][d], q_s[tx + 16][d]};
        const float ov[2] = {do_s[tx][d], do_s[tx + 16][d]};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = tx + 16 * j;
          const float p = sk[i] == segq_s[c] ? expf(st[i][j] * scale - lse_s[c]) : 0.f;
          p_s[ty + 16 * i][c] = p;
          ds_s[ty + 16 * i][c] = p * (dpt[i][j] - delta_s[c]) * scale;
        }
      __syncthreads();

#pragma unroll 8
      for (int c = 0; c < BF; ++c) {
        const float pv[2] = {p_s[ty][c], p_s[ty + 16][c]};
        const float dsv[2] = {ds_s[ty][c], ds_s[ty + 16][c]};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float ov = do_s[c][tx + 16 * j], qv = q_s[c][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            dva[i][j] = fmaf(pv[i], ov, dva[i][j]);
            dka[i][j] = fmaf(dsv[i], qv, dka[i][j]);
          }
        }
      }
    }
  }

  if constexpr (kRope) {  // back to the raw k (dv is unrotated), before any lane leaves
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dka[i][j] = inv_rot_split(dka[i][j], tx + 16 * j, rk, row, row < Sk);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Sk) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dk[(size_t)row * ldk + hk * D + tx + 16 * j] = dka[i][j];
      dv[(size_t)row * ldk + hk * D + tx + 16 * j] = dva[i][j];
    }
  }
}

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
  } else {
    bwd_dq_f32<kRope><<<dim3((S + BF - 1) / BF, hq), 256, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), seg_q, seg_k, static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), S, Sk, hq, hkv, scale, rq, rk);
  }
  return static_cast<int>(cudaGetLastError());
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
  } else {
    bwd_dkv_f32<kRope><<<dim3((Sk + BF - 1) / BF, hkv), 256, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), seg_q, seg_k, static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), S, Sk, hq, hkv, scale, rq,
        rk);
  }
  return static_cast<int>(cudaGetLastError());
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
