// What the segment-attention kernels share: the pad remap, the interval
// search over non-decreasing segment ids, the bf16 mma.sync helpers and the
// RoPE rotation of the kernels' `kRope` instantiations.
//
// Included by flash_segment_attn_fwd.cu and flash_segment_attn_bwd.cu; each
// builds into its own library, so everything here has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;         // head dim
constexpr float NEG_INF = -1e30f;
constexpr int PAD_ID = 1 << 30;
constexpr int NO_ROW_Q = -2;  // segment of q rows outside the tile's range: matches nothing
constexpr int NO_ROW_K = -1;  // segment of kv rows outside the tile's range
constexpr int LDS = D + 8;    // smem row stride (bf16): 144 B, conflict-free fragment loads

__device__ __forceinline__ int remap(int s) { return s == 0 ? PAD_ID : s; }

// [lo, hi): the rows j of `seg_b` whose (remapped) segment lies in
// [seg_a[a0], seg_a[a1 - 1]]. Both id vectors are non-decreasing once 0 is
// remapped, so that is one interval, found by two binary searches.
__device__ void segment_interval(const int* __restrict__ seg_a, const int* __restrict__ seg_b,
                                 int a0, int a1, int nb, int* lo_out, int* hi_out) {
  const int first = remap(seg_a[a0]);
  const int last = remap(seg_a[a1 - 1]);
  int lo = 0, hi = nb;
  while (lo < hi) {  // first j with seg_b[j] >= first
    const int mid = (lo + hi) >> 1;
    if (remap(seg_b[mid]) < first) lo = mid + 1; else hi = mid;
  }
  *lo_out = lo;
  hi = nb;
  while (lo < hi) {  // first j with seg_b[j] > last
    const int mid = (lo + hi) >> 1;
    if (remap(seg_b[mid]) <= last) lo = mid + 1; else hi = mid;
  }
  *hi_out = lo;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// RoPE tables of one side (q or k): pair p < P of row r rotates by
// (cos[r * P + p], sin[r * P + p]), both f32 [rows, P]; pairs p >= P pass
// through. The kRope = false instantiations never read it.
struct Rope {
  const float* cos;
  const float* sin;
  int P;
};

// One interleaved pair (x[2p], x[2p+1]) rotated in fp32, every product and
// sum rounded on its own (no FMA contraction), as the port's elementwise
// apply_rotary_emb computes it: (x0 c - x1 s, x0 s + x1 c).
__device__ __forceinline__ void rot_pair(float& x0, float& x1, float c, float s) {
  const float r0 = __fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s));
  const float r1 = __fadd_rn(__fmul_rn(x0, s), __fmul_rn(x1, c));
  x0 = r0;
  x1 = r1;
}

// The inverse rotation (R^T, sin negated), for the f32 dq and dk
// accumulators: (x0 c + x1 s, x1 c - x0 s).
__device__ __forceinline__ void rot_pair_inv(float& x0, float& x1, float c, float s) {
  const float r0 = __fadd_rn(__fmul_rn(x0, c), __fmul_rn(x1, s));
  const float r1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x0, s));
  x0 = r0;
  x1 = r1;
}

// Inverse-rotate the pair (x0, x1) = (acc[c], acc[c + 1]) of row `row` in
// place, pair index `pair` = c / 2.
__device__ __forceinline__ void inv_rot_acc(float& x0, float& x1, const Rope& rp, int row,
                                            int pair) {
  if (pair < rp.P) {
    const size_t t = (size_t)row * rp.P + pair;
    rot_pair_inv(x0, x1, rp.cos[t], rp.sin[t]);
  }
}

// 8 bf16 values of row `row` (4 pairs, the first pair `pair0`) rotated in
// fp32 and rounded back to bf16, as the tile is staged.
__device__ __forceinline__ uint4 rot8_bf16(uint4 v, const Rope& rp, int row, int pair0) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (pair0 + i < rp.P) {
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      float x0 = __low2float(b), x1 = __high2float(b);
      const size_t t = (size_t)row * rp.P + pair0 + i;
      rot_pair(x0, x1, rp.cos[t], rp.sin[t]);
      w[i] = pack_bf16(x0, x1);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Copy ROWS rows of one head (64 f32 each) into a padded smem tile, one
// float2 (one pair) at a time, rotating each pair by `rp`; rows at or past
// `valid` are zero.
template <int ROWS, int LDT>
__device__ __forceinline__ void load_rot_tile_f32(float (*dst)[LDT], const float* src, int row0,
                                                  int valid, int ld, int col0, const Rope& rp) {
  for (int e = threadIdx.x; e < ROWS * D / 2; e += blockDim.x) {
    const int r = e / (D / 2), p = e % (D / 2);
    float x0 = 0.f, x1 = 0.f;
    if (row0 + r < valid) {
      const float2 x =
          *reinterpret_cast<const float2*>(src + (size_t)(row0 + r) * ld + col0 + 2 * p);
      x0 = x.x;
      x1 = x.y;
      if (p < rp.P) {
        const size_t t = (size_t)(row0 + r) * rp.P + p;
        rot_pair(x0, x1, rp.cos[t], rp.sin[t]);
      }
    }
    dst[r][2 * p] = x0;
    dst[r][2 * p + 1] = x1;
  }
}

// Inverse-rotate an f32 accumulator whose column pairs are split over two
// lanes (tx and tx ^ 1 of a half-warp hold columns c and c ^ 1): `mine` is
// this lane's column `col`, the partner's comes by a shuffle. Every lane of
// the warp must call it.
__device__ __forceinline__ float inv_rot_split(float mine, int col, const Rope& rp, int row,
                                               bool row_ok) {
  const float other = __shfl_xor_sync(0xffffffffu, mine, 1);
  const int pair = col >> 1;
  if (!row_ok || pair >= rp.P) return mine;
  const bool odd = col & 1;
  float x0 = odd ? other : mine, x1 = odd ? mine : other;
  const size_t t = (size_t)row * rp.P + pair;
  rot_pair_inv(x0, x1, rp.cos[t], rp.sin[t]);
  return odd ? x1 : x0;
}

// c[16x8] += a[16x16] (row) * b[16x8] (col), bf16 in, fp32 accumulate.
// Fragments (g = lane / 4, t2 = 2 * (lane % 4)):
//   a[0] = A[g][t2..t2+1]   a[1] = A[g+8][t2..]   a[2] = A[g][t2+8..]   a[3] = A[g+8][t2+8..]
//   b[0] = B[t2..t2+1][g]   b[1] = B[t2+8..t2+9][g]
//   c[0..1] = C[g][t2..t2+1]   c[2..3] = C[g+8][t2..t2+1]
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int NT_BF16 = 128;  // threads of every bf16 kernel (4 warps)

// Copy 64 rows of one head (64 bf16 each) from a [*, ld] buffer into a
// [64][LDS] smem tile with 16-byte loads; rows at or past `valid` are zero.
// The trip count is fixed, so the loop unrolls and all loads are in flight.
// kRope: each pair is rotated by `rp` (row row0 + r) as it is staged.
template <bool kRope = false>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int row0, int valid, int ld, int col0,
                                               const Rope& rp = Rope{}) {
#pragma unroll
  for (int e = threadIdx.x; e < 64 * D / 8; e += NT_BF16) {
    const int r = e >> 3, c = (e & 7) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < valid) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + col0 + c);
      if constexpr (kRope) val = rot8_bf16(val, rp, row0 + r, c >> 1);
    }
    *reinterpret_cast<uint4*>(&dst[r * LDS + c]) = val;
  }
}

// The same for two buffers of one layout (K and V, Q and dO) in one loop,
// so the loads of both tiles are issued together. kRope rotates `a` only.
template <bool kRope = false>
__device__ __forceinline__ void load_tiles_bf16(__nv_bfloat16* dst_a, const __nv_bfloat16* src_a,
                                                __nv_bfloat16* dst_b, const __nv_bfloat16* src_b,
                                                int row0, int valid, int ld, int col0,
                                                const Rope& rp = Rope{}) {
#pragma unroll
  for (int e = threadIdx.x; e < 64 * D / 8; e += NT_BF16) {
    const int r = e >> 3, c = (e & 7) * 8;
    uint4 a = make_uint4(0, 0, 0, 0), b = make_uint4(0, 0, 0, 0);
    if (row0 + r < valid) {
      const size_t off = (size_t)(row0 + r) * ld + col0 + c;
      a = *reinterpret_cast<const uint4*>(src_a + off);
      b = *reinterpret_cast<const uint4*>(src_b + off);
      if constexpr (kRope) a = rot8_bf16(a, rp, row0 + r, c >> 1);
    }
    *reinterpret_cast<uint4*>(&dst_a[r * LDS + c]) = a;
    *reinterpret_cast<uint4*>(&dst_b[r * LDS + c]) = b;
  }
}

// A fragments of a warp's 16 rows (r0 = warp * 16 + g) of a [64][LDS] tile,
// one per 16-wide k step over D.
__device__ __forceinline__ void load_a_frags(uint32_t (*a)[4], const __nv_bfloat16* s, int r0,
                                             int t2) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = ld32(&s[r0 * LDS + kk * 16 + t2]);
    a[kk][1] = ld32(&s[(r0 + 8) * LDS + kk * 16 + t2]);
    a[kk][2] = ld32(&s[r0 * LDS + kk * 16 + t2 + 8]);
    a[kk][3] = ld32(&s[(r0 + 8) * LDS + kk * 16 + t2 + 8]);
  }
}

// c[nt] (16 rows x 64 columns as 8 n-tiles) = A (the warp's fragments, k = D)
// times the transpose of the [64][LDS] tile `s` (row n of the tile is column n).
__device__ __forceinline__ void mma_abt(float (*c)[4], uint32_t (*a)[4],
                                        const __nv_bfloat16* s, int g, int t2) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t b[2];
      b[0] = ld32(&s[(nt * 8 + g) * LDS + kk * 16 + t2]);
      b[1] = ld32(&s[(nt * 8 + g) * LDS + kk * 16 + t2 + 8]);
      mma_bf16(c[nt], a[kk], b);
    }
  }
}

// acc[dt] (16 rows x D as 8 n-tiles) += P (A fragments, k = 64 tile rows)
// times the [64][LDS] tile `s` (k = tile row, n = d).
__device__ __forceinline__ void mma_ab(float (*acc)[4], uint32_t (*pa)[4],
                                       const __nv_bfloat16* s, int g, int t2) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kr = j * 16 + t2;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const int n = dt * 8 + g;
      uint32_t b[2];
      b[0] = pack_raw(s[kr * LDS + n], s[(kr + 1) * LDS + n]);
      b[1] = pack_raw(s[(kr + 8) * LDS + n], s[(kr + 9) * LDS + n]);
      mma_bf16(acc[dt], pa[j], b);
    }
  }
}

// C fragments (16 x 64, 8 n-tiles) rounded to bf16 as A fragments
// (n-tiles 2j and 2j+1 become k step j).
__device__ __forceinline__ void c_to_a(uint32_t (*pa)[4], float (*c)[4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(c[nt][0], c[nt][1]);
    pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(c[nt][2], c[nt][3]);
  }
}

}  // namespace
