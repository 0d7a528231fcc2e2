// What the segment-attention kernels share: the pad remap, the interval
// search over non-decreasing segment ids, and the bf16 mma.sync helpers.
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
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int row0, int valid, int ld, int col0) {
#pragma unroll
  for (int e = threadIdx.x; e < 64 * D / 8; e += NT_BF16) {
    const int r = e >> 3, c = (e & 7) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < valid)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + col0 + c);
    *reinterpret_cast<uint4*>(&dst[r * LDS + c]) = val;
  }
}

// The same for two buffers of one layout (K and V, Q and dO) in one loop,
// so the loads of both tiles are issued together.
__device__ __forceinline__ void load_tiles_bf16(__nv_bfloat16* dst_a, const __nv_bfloat16* src_a,
                                                __nv_bfloat16* dst_b, const __nv_bfloat16* src_b,
                                                int row0, int valid, int ld, int col0) {
#pragma unroll
  for (int e = threadIdx.x; e < 64 * D / 8; e += NT_BF16) {
    const int r = e >> 3, c = (e & 7) * 8;
    uint4 a = make_uint4(0, 0, 0, 0), b = make_uint4(0, 0, 0, 0);
    if (row0 + r < valid) {
      const size_t off = (size_t)(row0 + r) * ld + col0 + c;
      a = *reinterpret_cast<const uint4*>(src_a + off);
      b = *reinterpret_cast<const uint4*>(src_b + off);
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
