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
// The forward and dq, v1's own design:
// - One CTA per (q tile, q head), reading the [S, H*64] row-major buffers
//   by stride (the JAX wrapper transposes to [H, S, D]; nothing is copied).
// - Tile skipping by tile-pair interval overlap: qmm / kmm are int32
//   [n_tiles, 2] (min, max) of the remapped ids per q tile and per kv tile,
//   computed by torch ops before the launch (JAX `_block_minmax` in XLA);
//   a (q tile, kv tile) pair runs only if the intervals overlap. Each CTA
//   walks every tile of the other side and skips the rest.
// - No padding of S to a tile multiple: rows at or past S are masked (their
//   ids are sentinels that match nothing) and never written.
// - Tiles: bf16 64 x 64 (q and kv); f32 forward 64 q x 32 kv rows; f32
//   backward 32 x 32. The wrapper computes qmm / kmm at these sizes and
//   passes them; an entry refuses other sizes.
// - bf16 on mma.sync m16n8k16 (bf16 in, fp32 accumulate), Q (and dO) held
//   as A fragments, K/V tiles staged through registers between barriers.
//
// The bf16 dk/dv is the pipelined kernel of the row 2 backward,
// `bwd_dkv_pipe<false, NG, true>` (segment_attn_dkv.cuh): one CTA per
// (64-row kv tile, kv head) finds the exact q interval of its tile by a
// search (it reads no qmm / kmm), NG warp groups share K and V and take one
// q head each of a (q tile, NG heads) unit from a 2-stage cp.async ring,
// operands by ldmatrix, p by one ex2.approx. Its kV1 flag rounds each
// head's f32 sums to bf16 before the group's heads are added, in head
// order, and the sum rounded once: it writes the group-summed dk/dv
// [S, Hkv*64] itself, half the bytes of per-head outputs, and the wrapper
// runs no group sum. Where a group has more heads than warp groups (Hq/Hkv
// > 4, as 8/1), the heads go in chunks of NG, and each chunk's rounded
// heads are folded into a running sum in shared memory. The f32 dk/dv
// keeps v1's design and writes each q head's dk/dv [S, Hq*64], summed over
// each group by the wrapper.
//
// What bounds it on the H100: the same work as rows 1-2 (useful FLOPs on
// the block-diagonal part of S x S: forward 2, dq 3, dk/dv 4 products of
// S x S x 64 per q head; at the bench shape, S 6144 in ten 576-row
// segments, heads 4/2, bf16: 3.4 + 5.1 + 6.8 GFLOP, 3.4 / 5.2 / 6.9 us at
// 989 TFLOP/s) against bytes that take 3-6 us at 3.35 TB/s. Compute-bound
// on paper; f32 on fp32 FMA (TF32 cannot hold the f32 limits).

#include "segment_attn_dkv.cuh"

namespace {

constexpr int T = 64;    // bf16 tile rows (q and kv)
constexpr int FQ = 64;   // f32 forward: q rows per CTA
constexpr int FK = 32;   // f32 forward: kv rows per tile
constexpr int FB = 32;   // f32 backward: rows per tile (q and kv)

// The pair (tile a of one side, tile b of the other) runs only if their
// [min, max] id intervals overlap.
__device__ __forceinline__ bool overlaps(const int2 a, const int2 b) {
  return b.x <= a.y && b.y >= a.x;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, 4 warps of 16 rows each
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT_BF16)
v1_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
            const int2* __restrict__ qmm, const int2* __restrict__ kmm,
            __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int S, int hq, int hkv,
            float scale) {
  __shared__ __align__(16) __nv_bfloat16 q_s[T * LDS];
  __shared__ __align__(16) __nv_bfloat16 k_s[T * LDS];
  __shared__ __align__(16) __nv_bfloat16 v_s[T * LDS];
  __shared__ int segq_s[T];
  __shared__ int segk_s[T];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int q0 = blockIdx.x * T;
  const int h = blockIdx.y;
  const int hk = h / (hq / hkv);
  const int ldq = hq * D, ldk = hkv * D;
  const int nk = (S + T - 1) / T;
  const int2 qr = qmm[blockIdx.x];

  load_tile_bf16(q_s, q, q0, S, ldq, h * D);
  if (tid < T) segq_s[tid] = (q0 + tid < S) ? remap(seg[q0 + tid]) : NO_ROW_Q;
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows in the tile: r0 and r0 + 8
  uint32_t qa[4][4];
  load_a_frags(qa, q_s, r0, t2);
  const int sq0 = segq_s[r0], sq1 = segq_s[r0 + 8];

  float m0 = NEG_INF, m1 = NEG_INF;
  float l0 = 0.f, l1 = 0.f;
  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  for (int j = 0; j < nk; ++j) {
    if (!overlaps(qr, kmm[j])) continue;  // the same for every thread of the CTA
    const int kv0 = j * T;
    __syncthreads();  // the previous tile is consumed
    load_tiles_bf16(k_s, k, v_s, v, kv0, S, ldk, hk * D);
    if (tid < T) segk_s[tid] = (kv0 + tid < S) ? remap(seg[kv0 + tid]) : NO_ROW_K;
    __syncthreads();

    float s[8][4];
    mma_abt(s, qa, k_s, g, t2);  // S = Q K^T

    float mx0 = NEG_INF, mx1 = NEG_INF;
    bool msk[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int sk0 = segk_s[nt * 8 + t2], sk1 = segk_s[nt * 8 + t2 + 1];
      msk[nt][0] = sq0 == sk0;
      msk[nt][1] = sq0 == sk1;
      msk[nt][2] = sq1 == sk0;
      msk[nt][3] = sq1 == sk1;
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = msk[nt][i] ? s[nt][i] * scale : NEG_INF;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    uint32_t pa[4][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = msk[nt][0] ? expf(s[nt][0] - mn0) : 0.f;
      const float p1 = msk[nt][1] ? expf(s[nt][1] - mn0) : 0.f;
      const float p2 = msk[nt][2] ? expf(s[nt][2] - mn1) : 0.f;
      const float p3 = msk[nt][3] ? expf(s[nt][3] - mn1) : 0.f;
      ps0 += p0 + p1;  // l sums the unrounded p
      ps1 += p2 + p3;
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);  // bf16(p) for P V
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      o[dt][0] *= a0;
      o[dt][1] *= a0;
      o[dt][2] *= a1;
      o[dt][3] *= a1;
    }
    mma_ab(o, pa, v_s, g, t2);  // O += P V
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float L0 = fmaxf(l0, 1e-30f), L1 = fmaxf(l1, 1e-30f);
  const int row0 = q0 + r0, row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = h * D + dt * 8 + t2;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(out + (size_t)row0 * ldq + col) =
          pack_bf16(o[dt][0] / L0, o[dt][1] / L0);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(out + (size_t)row1 * ldq + col) =
          pack_bf16(o[dt][2] / L1, o[dt][3] / L1);
  }
  if ((lane & 3) == 0) {
    if (row0 < S) lse[(size_t)row0 * hq + h] = m0 + logf(L0);
    if (row1 < S) lse[(size_t)row1 * hq + h] = m1 + logf(L1);
  }
}

__global__ void __launch_bounds__(NT_BF16)
v1_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
               const int2* __restrict__ qmm, const int2* __restrict__ kmm,
               const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int S, int hq,
               int hkv, float scale) {
  __shared__ __align__(16) __nv_bfloat16 k_s[T * LDS];  // also stages the Q tile
  __shared__ __align__(16) __nv_bfloat16 v_s[T * LDS];  // also stages the dO tile
  __shared__ int segq_s[T];
  __shared__ int segk_s[T];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int q0 = blockIdx.x * T;
  const int h = blockIdx.y;
  const int hk = h / (hq / hkv);
  const int ldq = hq * D, ldk = hkv * D;
  const int nk = (S + T - 1) / T;
  const int2 qr = qmm[blockIdx.x];
  const int r0 = warp * 16 + g;

  if (tid < T) segq_s[tid] = (q0 + tid < S) ? remap(seg[q0 + tid]) : NO_ROW_Q;
  load_tiles_bf16(k_s, q, v_s, dout, q0, S, ldq, h * D);
  __syncthreads();
  uint32_t qa[4][4], doa[4][4];
  load_a_frags(qa, k_s, r0, t2);
  load_a_frags(doa, v_s, r0, t2);

  const int row0 = q0 + r0, row1 = row0 + 8;
  const int sq0 = segq_s[r0], sq1 = segq_s[r0 + 8];
  const float lse0 = row0 < S ? lse[(size_t)row0 * hq + h] : 0.f;
  const float lse1 = row1 < S ? lse[(size_t)row1 * hq + h] : 0.f;
  const float dl0 = row0 < S ? delta[(size_t)row0 * hq + h] : 0.f;
  const float dl1 = row1 < S ? delta[(size_t)row1 * hq + h] : 0.f;

  float acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int j = 0; j < nk; ++j) {
    if (!overlaps(qr, kmm[j])) continue;
    const int kv0 = j * T;
    __syncthreads();  // the previous tile (or the Q/dO staging) is consumed
    load_tiles_bf16(k_s, k, v_s, v, kv0, S, ldk, hk * D);
    if (tid < T) segk_s[tid] = (kv0 + tid < S) ? remap(seg[kv0 + tid]) : NO_ROW_K;
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_abt(s, qa, k_s, g, t2);    // S = Q K^T
    mma_abt(dp, doa, v_s, g, t2);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int sk0 = segk_s[nt * 8 + t2], sk1 = segk_s[nt * 8 + t2 + 1];
      const float p0 = sq0 == sk0 ? expf(s[nt][0] * scale - lse0) : 0.f;
      const float p1 = sq0 == sk1 ? expf(s[nt][1] * scale - lse0) : 0.f;
      const float p2 = sq1 == sk0 ? expf(s[nt][2] * scale - lse1) : 0.f;
      const float p3 = sq1 == sk1 ? expf(s[nt][3] * scale - lse1) : 0.f;
      s[nt][0] = p0 * (dp[nt][0] - dl0) * scale;  // dS, in place
      s[nt][1] = p1 * (dp[nt][1] - dl0) * scale;
      s[nt][2] = p2 * (dp[nt][2] - dl1) * scale;
      s[nt][3] = p3 * (dp[nt][3] - dl1) * scale;
    }
    uint32_t dsa[4][4];
    c_to_a(dsa, s);                // bf16(dS)
    mma_ab(acc, dsa, k_s, g, t2);  // dQ += dS K
  }

#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = h * D + dt * 8 + t2;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(dq + (size_t)row0 * ldq + col) = pack_bf16(acc[dt][0], acc[dt][1]);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(dq + (size_t)row1 * ldq + col) = pack_bf16(acc[dt][2], acc[dt][3]);
  }
}

// ---------------------------------------------------------------------------
// f32: fp32 FMA, 256 threads. Padded smem strides keep each half-warp's
// column walks on distinct banks; a row's 16 owners read one address.
// ---------------------------------------------------------------------------

template <int ROWS>
__device__ __forceinline__ void load_tile_f32(float (*dst)[D + 1], const float* src, int row0,
                                              int valid, int ld, int col0) {
  for (int e = threadIdx.x; e < ROWS * D; e += blockDim.x) {
    const int r = e / D, c = e % D;
    dst[r][c] = (row0 + r < valid) ? src[(size_t)(row0 + r) * ld + col0 + c] : 0.f;
  }
}

// thread (ty, tx) owns q rows ty + 16 i (i < 4), score columns tx + 16 j
// (j < 2) and output columns tx + 16 j (j < 4); a row's 16 owners are one
// half-warp.
__global__ void __launch_bounds__(256)
v1_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const int* __restrict__ seg,
           const int2* __restrict__ qmm, const int2* __restrict__ kmm,
           float* __restrict__ out, float* __restrict__ lse, int S, int hq, int hkv,
           float scale) {
  __shared__ float q_s[FQ][D + 1];
  __shared__ float k_s[FK][D + 1];
  __shared__ float v_s[FK][D + 1];
  __shared__ float p_s[FQ][FK + 1];
  __shared__ int segq_s[FQ];
  __shared__ int segk_s[FK];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * FQ;
  const int h = blockIdx.y;
  const int hk = h / (hq / hkv);
  const int ldq = hq * D, ldk = hkv * D;
  const int nk = (S + FK - 1) / FK;
  const int2 qr = qmm[blockIdx.x];

  load_tile_f32<FQ>(q_s, q, q0, S, ldq, h * D);
  if (tid < FQ) segq_s[tid] = (q0 + tid < S) ? remap(seg[q0 + tid]) : NO_ROW_Q;
  __syncthreads();

  int sq[4];
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sq[i] = segq_s[ty + 16 * i];
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int jt = 0; jt < nk; ++jt) {
    if (!overlaps(qr, kmm[jt])) continue;
    const int kv0 = jt * FK;
    __syncthreads();
    load_tile_f32<FK>(k_s, k, kv0, S, ldk, hk * D);
    load_tile_f32<FK>(v_s, v, kv0, S, ldk, hk * D);
    if (tid < FK) segk_s[tid] = (kv0 + tid < S) ? remap(seg[kv0 + tid]) : NO_ROW_K;
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[ty + 16 * i][d];
      const float kv0v = k_s[tx][d], kv1v = k_s[tx + 16][d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(qv[i], kv0v, s[i][0]);
        s[i][1] = fmaf(qv[i], kv1v, s[i][1]);
      }
    }

    const int sk0 = segk_s[tx], sk1 = segk_s[tx + 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool mk0 = sq[i] == sk0, mk1 = sq[i] == sk1;
      const float s0 = mk0 ? s[i][0] * scale : NEG_INF;
      const float s1 = mk1 ? s[i][1] * scale : NEG_INF;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      m[i] = mn;
      const float p0 = mk0 ? expf(s0 - mn) : 0.f;
      const float p1 = mk1 ? expf(s1 - mn) : 0.f;
      float ps = p0 + p1;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      p_s[ty + 16 * i][tx] = p0;
      p_s[ty + 16 * i][tx + 16] = p1;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int r = 0; r < FK; ++r) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[ty + 16 * i][r];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = v_s[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float L = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(size_t)row * ldq + h * D + tx + 16 * j] = acc[i][j] / L;
    if (tx == 0) lse[(size_t)row * hq + h] = m[i] + logf(L);
  }
}

// thread (ty, tx) owns tile rows ty + 16 i (i < 2), score columns tx + 16 j
// (j < 2) and output columns tx + 16 j (j < 4)
__global__ void __launch_bounds__(256)
v1_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ seg,
              const int2* __restrict__ qmm, const int2* __restrict__ kmm,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq, int S, int hq, int hkv,
              float scale) {
  __shared__ float q_s[FB][D + 1];
  __shared__ float do_s[FB][D + 1];
  __shared__ float k_s[FB][D + 1];
  __shared__ float v_s[FB][D + 1];
  __shared__ float ds_s[FB][FB + 1];
  __shared__ int segq_s[FB];
  __shared__ int segk_s[FB];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * FB;
  const int h = blockIdx.y;
  const int hk = h / (hq / hkv);
  const int ldq = hq * D, ldk = hkv * D;
  const int nk = (S + FB - 1) / FB;
  const int2 qr = qmm[blockIdx.x];

  load_tile_f32<FB>(q_s, q, q0, S, ldq, h * D);
  load_tile_f32<FB>(do_s, dout, q0, S, ldq, h * D);
  if (tid < FB) segq_s[tid] = (q0 + tid < S) ? remap(seg[q0 + tid]) : NO_ROW_Q;
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

  for (int jt = 0; jt < nk; ++jt) {
    if (!overlaps(qr, kmm[jt])) continue;
    const int kv0 = jt * FB;
    __syncthreads();
    load_tile_f32<FB>(k_s, k, kv0, S, ldk, hk * D);
    load_tile_f32<FB>(v_s, v, kv0, S, ldk, hk * D);
    if (tid < FB) segk_s[tid] = (kv0 + tid < S) ? remap(seg[kv0 + tid]) : NO_ROW_K;
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
    for (int r = 0; r < FB; ++r) {
      const float dsv[2] = {ds_s[ty][r], ds_s[ty + 16][r]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kk = k_s[r][tx + 16 * j];
        acc[0][j] = fmaf(dsv[0], kk, acc[0][j]);
        acc[1][j] = fmaf(dsv[1], kk, acc[1][j]);
      }
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

// dk/dv of one q head for one 32-row kv tile (thread (ty, tx): kv rows
// ty + 16 i, q columns tx + 16 j, output columns tx + 16 j)
__global__ void __launch_bounds__(256)
v1_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ seg,
               const int2* __restrict__ qmm, const int2* __restrict__ kmm,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk_h,
               float* __restrict__ dv_h, int S, int hq, int hkv, float scale) {
  __shared__ float k_s[FB][D + 1];
  __shared__ float v_s[FB][D + 1];
  __shared__ float q_s[FB][D + 1];
  __shared__ float do_s[FB][D + 1];
  __shared__ float p_s[FB][FB + 1];
  __shared__ float ds_s[FB][FB + 1];
  __shared__ float lse_s[FB];
  __shared__ float delta_s[FB];
  __shared__ int segq_s[FB];
  __shared__ int segk_s[FB];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * FB;
  const int h = blockIdx.y;
  const int hk = h / (hq / hkv);
  const int ldq = hq * D, ldk = hkv * D;
  const int nq = (S + FB - 1) / FB;
  const int2 kr = kmm[blockIdx.x];

  load_tile_f32<FB>(k_s, k, k0, S, ldk, hk * D);
  load_tile_f32<FB>(v_s, v, k0, S, ldk, hk * D);
  if (tid < FB) segk_s[tid] = (k0 + tid < S) ? remap(seg[k0 + tid]) : NO_ROW_K;
  __syncthreads();

  const int sk[2] = {segk_s[ty], segk_s[ty + 16]};
  float dka[2][4], dva[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int it = 0; it < nq; ++it) {
    if (!overlaps(kr, qmm[it])) continue;
    const int qs0 = it * FB;
    __syncthreads();
    load_tile_f32<FB>(q_s, q, qs0, S, ldq, h * D);
    load_tile_f32<FB>(do_s, dout, qs0, S, ldq, h * D);
    if (tid < FB) {
      const bool ok = qs0 + tid < S;
      segq_s[tid] = ok ? remap(seg[qs0 + tid]) : NO_ROW_Q;
      lse_s[tid] = ok ? lse[(size_t)(qs0 + tid) * hq + h] : 0.f;
      delta_s[tid] = ok ? delta[(size_t)(qs0 + tid) * hq + h] : 0.f;
    }
    __syncthreads();

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
    for (int c = 0; c < FB; ++c) {
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

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dk_h[(size_t)row * ldq + h * D + tx + 16 * j] = dka[i][j];
      dv_h[(size_t)row * ldq + h * D + tx + 16 * j] = dva[i][j];
    }
  }
}

// the tiles each entry's qmm / kmm were computed for must be its own
bool tiles_ok(int is_bf16, int tq, int tk, int f32_tq, int f32_tk) {
  return is_bf16 ? (tq == T && tk == T) : (tq == f32_tq && tk == f32_tk);
}

}  // namespace

// q [S, hq*64], k/v [S, hkv*64], seg [S] int32 (non-decreasing once 0 is
// remapped to 2^30); qmm / kmm int32 [tiles, 2] (min, max) of the remapped
// ids per q tile of tq rows and per kv tile of tk rows (bf16 64/64, f32
// 64/32); out [S, hq*64] in q's dtype, lse [S, hq] f32. Launches on
// `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for
// other tile sizes.
extern "C" int flash_segment_attn_v1_fwd(const void* q, const void* k, const void* v,
                                         const int* seg, const int* qmm, const int* kmm, int tq,
                                         int tk, void* out, float* lse, int S, int hq, int hkv,
                                         float scale, int is_bf16, void* stream) {
  if (!tiles_ok(is_bf16, tq, tk, FQ, FK)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int2* qm = reinterpret_cast<const int2*>(qmm);
  const int2* km = reinterpret_cast<const int2*>(kmm);
  if (is_bf16) {
    v1_fwd_bf16<<<dim3((S + T - 1) / T, hq), NT_BF16, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg, qm, km, static_cast<__nv_bfloat16*>(out),
        lse, S, hq, hkv, scale);
  } else {
    v1_fwd_f32<<<dim3((S + FQ - 1) / FQ, hq), 256, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), seg, qm, km, static_cast<float*>(out), lse, S, hq, hkv,
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// dq [S, hq*64] from q, dO [S, hq*64], k/v, ids, the tile intervals (bf16
// 64/64, f32 32/32), lse and delta [S, hq] f32.
extern "C" int flash_segment_attn_v1_bwd_dq(const void* q, const void* k, const void* v,
                                            const int* seg, const int* qmm, const int* kmm,
                                            int tq, int tk, const void* dout, const float* lse,
                                            const float* delta, void* dq, int S, int hq, int hkv,
                                            float scale, int is_bf16, void* stream) {
  if (!tiles_ok(is_bf16, tq, tk, FB, FB)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int2* qm = reinterpret_cast<const int2*>(qmm);
  const int2* km = reinterpret_cast<const int2*>(kmm);
  if (is_bf16) {
    v1_bwd_dq_bf16<<<dim3((S + T - 1) / T, hq), NT_BF16, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg, qm, km,
        static_cast<const __nv_bfloat16*>(dout), lse, delta, static_cast<__nv_bfloat16*>(dq), S,
        hq, hkv, scale);
  } else {
    v1_bwd_dq_f32<<<dim3((S + FB - 1) / FB, hq), 256, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), seg, qm, km, static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dq), S, hq, hkv, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// dk/dv from q, dO [S, hq*64], k/v, ids, the tile intervals (bf16 64/64,
// f32 32/32), lse and delta [S, hq] f32. bf16: dk, dv [S, hkv*64], each q
// head's share rounded to bf16, then summed over its group in f32 in head
// order and rounded once (the tile intervals are not read: the kernel
// searches the ids). f32: dk_h, dv_h [S, hq*64], each q head's share, which
// the caller sums over each group.
extern "C" int flash_segment_attn_v1_bwd_dkv(const void* q, const void* k, const void* v,
                                             const int* seg, const int* qmm, const int* kmm,
                                             int tq, int tk, const void* dout, const float* lse,
                                             const float* delta, void* dk, void* dv, int S,
                                             int hq, int hkv, float scale, int is_bf16,
                                             void* stream) {
  if (!tiles_ok(is_bf16, tq, tk, FB, FB)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dkv_bf16<false, true>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg, seg, static_cast<const __nv_bfloat16*>(dout),
        lse, delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, S, hq,
        hkv, scale, Rope{}, Rope{}, st);
  v1_bwd_dkv_f32<<<dim3((S + FB - 1) / FB, hq), 256, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      seg, reinterpret_cast<const int2*>(qmm), reinterpret_cast<const int2*>(kmm),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), S, hq, hkv, scale);
  return static_cast<int>(cudaGetLastError());
}

// 1: the bf16 dk/dv entry writes dk, dv summed over each group ([S, hkv*64]);
// builds without this symbol wrote each q head's ([S, hq*64]). Read by the
// A/B tool, which times builds of either kind.
extern "C" int flash_segment_attn_v1_dkv_summed() { return 1; }
