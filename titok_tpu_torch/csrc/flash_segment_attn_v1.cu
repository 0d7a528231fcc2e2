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
// The bf16 kernels are instantiations of the pipelined templates of rows 1-2
// (the design is described in flash_segment_attn_{fwd,bwd}.cu); each CTA
// finds the exact kv (or q) interval of its tile by a search over the ids,
// so they read no tile intervals:
// - forward: `fwd_bf16_pipe<false, HPC, QR, true>` (segment_attn_fwd.cuh),
//   the row 1 forward whose kv tiles are the 64-row tiles of S aligned to
//   row 0, where v1 rounds p against the running max: the interval's start
//   is rounded down to a multiple of 64, and the rows before it are masked.
//   Where every segment starts at a multiple of 64 it gives row 1's bits.
// - dq: the row 2 dq `bwd_dq_pipe<false, HPC>` (segment_attn_dq.cuh), with
//   the one id vector for q and kv: the same function, the same bits. The
//   f32 dq likewise is the row 2 f32 dq `bwd_dq_f32_pipe<false, ...>`.
// - dk/dv: `bwd_dkv_pipe<false, NG, true>` (segment_attn_dkv.cuh), the row 2
//   dk/dv kernel with v1's rounding: one CTA per (64-row kv tile, kv head),
//   NG warp groups share K and V and take one q head each of a (q tile, NG
//   heads) unit from a 2-stage cp.async ring. Its kV1 flag rounds each
//   head's f32 sums to bf16 before the group's heads are added, in head
//   order, and the sum rounded once: it writes the group-summed dk/dv
//   [S, Hkv*64] itself, and the wrapper runs no group sum. Where a group has
//   more heads than warp groups (Hq/Hkv > 4, as 8/1), the heads go in chunks
//   of NG, and each chunk's rounded heads are folded into a running sum in
//   shared memory.
//
// The f32 forward and dk/dv keep v1's own design: one CTA per (q tile, q
// head) (dk/dv: per (kv tile, q head), writing each q head's dk/dv [S,
// Hq*64], summed over each group by the wrapper), reading the [S, H*64]
// row-major buffers by stride; tile skipping by tile-pair interval overlap:
// qmm / kmm are int32 [n_tiles, 2] (min, max) of the remapped ids per q tile
// and per kv tile, computed by torch ops before the launch (JAX
// `_block_minmax` in XLA); a (q tile, kv tile) pair runs only if the
// intervals overlap. Tiles: forward 64 q x 32 kv rows, dk/dv 32 x 32; the
// wrapper computes qmm / kmm at these sizes and passes them, and an entry
// refuses other sizes. Rows at or past S are masked (their ids are
// sentinels that match nothing) and never written.
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

namespace {

constexpr int FQ = 64;   // f32 forward: q rows per CTA
constexpr int FK = 32;   // f32 forward: kv rows per tile
constexpr int FB = 32;   // f32 dk/dv: rows per tile (q and kv)

// The pair (tile a of one side, tile b of the other) runs only if their
// [min, max] id intervals overlap.
__device__ __forceinline__ bool overlaps(const int2 a, const int2 b) {
  return b.x <= a.y && b.y >= a.x;
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

}  // namespace

// q [S, hq*64], k/v [S, hkv*64], seg [S] int32 (non-decreasing once 0 is
// remapped to 2^30); out [S, hq*64] in q's dtype, lse [S, hq] f32. f32: qmm /
// kmm int32 [tiles, 2] (min, max) of the remapped ids per q tile of tq = 64
// rows and per kv tile of tk = 32 rows; bf16 reads neither (the kernel
// searches the ids; pass null and any tile sizes). Launches on `stream`;
// returns cudaGetLastError(), or cudaErrorInvalidValue for other f32 tile
// sizes.
extern "C" int flash_segment_attn_v1_fwd(const void* q, const void* k, const void* v,
                                         const int* seg, const int* qmm, const int* kmm, int tq,
                                         int tk, void* out, float* lse, int S, int hq, int hkv,
                                         float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_fwd_bf16<false, true>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg, seg, static_cast<__nv_bfloat16*>(out), lse, S,
        S, hq, hkv, scale, Rope{}, Rope{}, st);
  if (tq != FQ || tk != FK) return static_cast<int>(cudaErrorInvalidValue);
  v1_fwd_f32<<<dim3((S + FQ - 1) / FQ, hq), 256, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      seg, reinterpret_cast<const int2*>(qmm), reinterpret_cast<const int2*>(kmm),
      static_cast<float*>(out), lse, S, hq, hkv, scale);
  return static_cast<int>(cudaGetLastError());
}

// dq [S, hq*64] from q, dO [S, hq*64], k/v, ids, lse and delta [S, hq] f32:
// the row 2 dq on one id vector, in either dtype; reads no tile intervals
// (pass null and any tile sizes).
extern "C" int flash_segment_attn_v1_bwd_dq(const void* q, const void* k, const void* v,
                                            const int* seg, const int* qmm, const int* kmm,
                                            int tq, int tk, const void* dout, const float* lse,
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

// dk/dv from q, dO [S, hq*64], k/v, ids, lse and delta [S, hq] f32. bf16: dk,
// dv [S, hkv*64], each q head's share rounded to bf16, then summed over its
// group in f32 in head order and rounded once (no tile intervals read). f32:
// on the tile intervals (32/32), dk_h, dv_h [S, hq*64], each q head's share,
// which the caller sums over each group.
extern "C" int flash_segment_attn_v1_bwd_dkv(const void* q, const void* k, const void* v,
                                             const int* seg, const int* qmm, const int* kmm,
                                             int tq, int tk, const void* dout, const float* lse,
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
  if (tq != FB || tk != FB) return static_cast<int>(cudaErrorInvalidValue);
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

// 1: the bf16 forward and dq entries search the ids and read no tile
// intervals; builds without this symbol read them, and their wrapper ran
// `tile_minmax` before each launch. Read by the A/B tool.
extern "C" int flash_segment_attn_v1_bf16_searches() { return 1; }

// 1: the f32 dq entry is the row 2 f32 dq on one id vector, searches the ids
// and reads no tile intervals; builds without this symbol read them (tiles
// of 32 q and 32 kv rows), and their wrapper ran `tile_minmax` before each
// launch. Read by the A/B tool.
extern "C" int flash_segment_attn_v1_f32_dq_searches() { return 1; }
