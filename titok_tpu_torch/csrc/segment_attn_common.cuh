// What the segment-attention kernels share: the pad remap, the interval
// search over non-decreasing segment ids, the bf16 mma.sync helpers, the f32
// kernels' swizzled staging and heaviest-first work order, and the RoPE
// rotation of the kernels' `kRope` instantiations.
//
// Included through segment_attn_{fwd,dq,dkv}.cuh by
// flash_segment_attn_{fwd,bwd,v1}.cu; each builds into its own library, so
// everything here has internal linkage.

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
constexpr int BT = 64;        // rows per tile of the bf16 backward kernels (q and kv)

__device__ __forceinline__ int remap(int s) { return s == 0 ? PAD_ID : s; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// RoPE tables of one side (q or k): pair p < P of row r rotates by
// (cos[r * P + p], sin[r * P + p]), both f32 [rows, P]; pairs p >= P pass
// through. The kRope = false instantiations never read it.
struct Rope {
  const float* cos;
  const float* sin;
  int P;
  bool pairs8;  // P even and both tables 8-byte aligned: staged two pairs a copy
};

inline Rope make_rope(const float* cos, const float* sin, int P) {
  return Rope{cos, sin, P,
              P % 2 == 0 && reinterpret_cast<uintptr_t>(cos) % 8 == 0 &&
                  reinterpret_cast<uintptr_t>(sin) % 8 == 0};
}

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

// ---------------------------------------------------------------------------
// The pipelined kernels' pieces (the forward, dq and dk/dv kernels): a ring
// of tiles filled by cp.async, fragments by ldmatrix, the interval found by
// a 32-way warp search.
// ---------------------------------------------------------------------------

constexpr int PMAX = 32;  // table columns staged per row (P <= 32)

// threadIdx.x read afresh where it is used: what a helper derives from it is
// then recomputed there, not held in registers across a kernel's main loop
// (the forward passes it to its table helpers to stay within 128 registers)
__device__ __forceinline__ int tid_fresh() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// The first j in [0, n) with remap(seg[j]) >= x (upper: > x), n when none,
// by the 32 lanes of a warp: 32 probes a step, so about log32(n) dependent
// loads, not log2(n). Every lane of the warp must call it.
__device__ __forceinline__ int warp_search(const int* __restrict__ seg, int n, int x, bool upper,
                                           int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + lane * step;
    bool below = false;
    if (p < hi) {
      const int s = remap(seg[p]);
      below = upper ? s <= x : s < x;
    }
    const int c = __popc(__ballot_sync(0xffffffffu, below));  // lanes 0..c-1 are below
    if (c == 0) return lo;
    const int nlo = lo + (c - 1) * step + 1;
    hi = min(lo + c * step, hi);
    lo = nlo;
  }
  return lo;
}

// [lo, hi) into range_s: the rows j of `seg_b` whose (remapped) segment lies
// in [seg_a[a0], seg_a[a1 - 1]]. Both id vectors are non-decreasing once 0
// is remapped, so that is one interval, found by warps 0 and 1 (one search
// each, at once). Every thread of the block must call it; it ends with a
// barrier.
__device__ __forceinline__ void segment_interval_warps(const int* __restrict__ seg_a,
                                                       const int* __restrict__ seg_b, int a0,
                                                       int a1, int nb, int* range_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const int x = remap(seg_a[warp == 0 ? a0 : a1 - 1]);
    const int r = warp_search(seg_b, nb, x, warp == 1, lane);
    if (lane == 0) range_s[warp] = r;
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; zeros when
// !ok (src is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// All but the newest N groups of this thread's copies have landed, and are
// visible to this thread (to the others after a barrier or an mbarrier).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x by the special function unit alone (ex2.approx.ftz: relative error
// about 2^-22, results below 2^-126 flushed to 0; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// mbarriers in shared memory (sm_90): `count` arrivals complete a phase;
// arrive has release and the wait acquire semantics at CTA scope.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Four 8x8 bf16 matrices: lanes 8i..8i+7 give the row addresses of matrix i;
// r[i] gets matrix i's fragment, (row lane / 4, columns 2 (lane % 4) + 0..1),
// or with .trans its transpose (rows 2 (lane % 4) + 0..1, column lane / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c[nt] (16 rows x 64 columns, 8 n-tiles) = A times the transpose of the
// [64][LDS] tile `s` (k = D): A's fragments by ldmatrix.x4 from rows
// r0..r0+15 of the [*][LDS] tile `a_s`, two k steps at a time (8 of its
// registers live); one ldmatrix.x4 gives the B fragments of one n-tile for
// two k steps.
__device__ __forceinline__ void mma_abt_ldsm(float (*c)[4], const __nv_bfloat16* a_s, int r0,
                                             const __nv_bfloat16* s, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
  for (int kk2 = 0; kk2 < 2; ++kk2) {
    uint32_t a[2][4];
    ldsm_x4(a[0], &a_s[(r0 + (lane & 15)) * LDS + kk2 * 32 + (lane >> 4) * 8]);
    ldsm_x4(a[1], &a_s[(r0 + (lane & 15)) * LDS + kk2 * 32 + 16 + (lane >> 4) * 8]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t b[4];
      ldsm_x4(b, &s[(nt * 8 + (lane & 7)) * LDS + kk2 * 32 + (lane >> 3) * 8]);
      mma_bf16(c[nt], a[0], b);
      mma_bf16(c[nt], a[1], b + 2);
    }
  }
}

// acc[dt] (16 rows x D, 8 n-tiles) += A (k = the tile's 64 rows) times the
// [64][LDS] tile `s` (k = tile row, n = d). One ldmatrix.x4.trans gives the
// B fragments of two n-tiles for one k step.
__device__ __forceinline__ void mma_ab_ldsm(float (*acc)[4], uint32_t (*pa)[4],
                                            const __nv_bfloat16* s, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int dt2 = 0; dt2 < 4; ++dt2) {
      uint32_t b[4];
      ldsm_x4_t(b, &s[(j * 16 + (lane & 15)) * LDS + dt2 * 16 + (lane >> 4) * 8]);
      mma_bf16(acc[2 * dt2], pa[j], b);
      mma_bf16(acc[2 * dt2 + 1], pa[j], b + 2);
    }
  }
}

// Issue the copies of ROWS rows of NH consecutive heads (columns col0 + h *
// D) into NH [ROWS][LDS] tiles at dst + h * ROWS * LDS; rows at or past
// `valid` are zero-filled. Thread `tid` takes the 16-byte chunks e = tid,
// tid + NT, ... (row e / 8, pairs 4 (e % 8) .. + 3), as `issue_tables` and
// `rotate_own` do.
template <int NT, int ROWS, int NH>
__device__ __forceinline__ void issue_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                           int valid, int ld, int col0, int tid) {
#pragma unroll
  for (int e = tid; e < ROWS * 8; e += NT) {
    const int r = e >> 3, c = (e & 7) * 8;
    const bool ok = row0 + r < valid;
    const size_t off = ok ? (size_t)(row0 + r) * ld + col0 + c : 0;
#pragma unroll
    for (int h = 0; h < NH; ++h) cp_async16(&dst[(h * ROWS + r) * LDS + c], src + off + h * D, ok);
  }
}

// The table entries of the same chunks (rows below `valid`, pairs < P) into
// [ROWS][PMAX] cos_s/sin_s: the thread that copies a chunk copies its
// entries, so it alone rotates the chunk (`rotate_own`) after its own
// cp_async_wait, with no barrier in between.
template <int NT, int ROWS>
__device__ __forceinline__ void issue_tables(float* cos_s, float* sin_s, int row0, int valid,
                                             const Rope& rp, int tid) {
#pragma unroll
  for (int e = tid; e < ROWS * 8; e += NT) {
    const int r = e >> 3, p0 = (e & 7) * 4;
    if (row0 + r >= valid) continue;
    const size_t t = (size_t)(row0 + r) * rp.P;
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int p = p0 + i;
      if (rp.pairs8 && p + 1 < rp.P) {
        cp_async8(&cos_s[r * PMAX + p], rp.cos + t + p);
        cp_async8(&sin_s[r * PMAX + p], rp.sin + t + p);
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (p + j < rp.P) {
            cp_async4(&cos_s[r * PMAX + p + j], rp.cos + t + p + j, true);
            cp_async4(&sin_s[r * PMAX + p + j], rp.sin + t + p + j, true);
          }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The f32 kernels' staging: [rows][64] f32 tiles (and [rows][32] score
// buffers) whose 16-byte chunks are XOR-swizzled by the row's low 3 bits,
// filled by cp.async. Eight rows that differ in their low 3 bits give the
// same logical chunk from 8 distinct 16-byte bank groups, and one row's
// chunks 0..7 (or 8..15) are a permutation of the 8 groups: both ways of
// reading a tile by float4 are free of bank conflicts. The kernels address
// the tiles by 32-bit shared addresses: with each row's base a multiple of
// 128 bytes whose bits 4-6 are clear, the swizzle is an XOR into bits 4-6.
// ---------------------------------------------------------------------------

// Offset in floats of logical chunk c (floats 4c..4c+3) of row r of a
// [rows][D] tile.
__device__ __forceinline__ int swz(int r, int c) { return r * D + ((c ^ (r & 7)) << 2); }

// The launch shape of a kernel, for the tools that report it: out[0..3] =
// threads a CTA, dynamic shared memory bytes, registers a thread (from the
// runtime), CTAs an SM (the occupancy calculator's). Call after the
// kernel's shared-memory attributes are set.
template <typename Kernel>
int describe_kernel(Kernel kern, int threads, int smem, int* out) {
  cudaFuncAttributes fa{};
  cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  int ctas = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern, threads, smem);
  out[0] = threads;
  out[1] = smem;
  out[2] = fa.numRegs;
  out[3] = ctas;
  return static_cast<int>(e);
}

// Grids of at most this many CTAs start their heaviest tiles first
constexpr int LPT_MAX_CTAS = 1024;

// The (tile, group) this CTA takes, heaviest tiles first. A tile's cost is
// the number of tiles whose ids its interval spans, from the first and last
// id of every tile (one load each, then two searches in shared memory);
// tiles are ranked by descending cost, ties by index, and CTA k of the grid
// (x fastest) takes the tile of rank k / gridDim.y and group k %
// gridDim.y. The block scheduler starts CTAs in that order, so the longest
// chains start in the first wave and the last wave holds short ones. Grids
// that fit in one wave (`ctas_per_sm` CTAs on each SM) and grids above
// LPT_MAX_CTAS keep (blockIdx.x, blockIdx.y): every CTA of the one starts
// at once, and the other's tiles are many and short against a wave.
// `scratch` holds 3 * gridDim.x + 1 ints of shared memory. Every thread
// must call it; it ends with a barrier. The order moves no result: a tile
// is computed alike wherever it runs.
__device__ __forceinline__ int2 lpt_item(const int* __restrict__ seg, int n, int rows,
                                         int ctas_per_sm, int* scratch) {
  const int nt = gridDim.x, k = blockIdx.y * gridDim.x + blockIdx.x;
  unsigned nsm;
  asm("mov.u32 %0, %%nsmid;\n" : "=r"(nsm));
  const int ctas = nt * gridDim.y;
  if (ctas > LPT_MAX_CTAS || ctas <= ctas_per_sm * (int)nsm) return make_int2(blockIdx.x, blockIdx.y);
  int* first = scratch;
  int* last = scratch + nt;
  int* cost = scratch + 2 * nt;
  for (int t = threadIdx.x; t < nt; t += blockDim.x) {
    first[t] = remap(seg[t * rows]);
    last[t] = remap(seg[min(t * rows + rows, n) - 1]);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nt; t += blockDim.x) {
    // the tiles that hold tile t's segments: from the first whose last id
    // reaches first[t] to the last whose first id is at most last[t]
    int lo = 0, hi = t;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (last[mid] < first[t]) lo = mid + 1; else hi = mid;
    }
    const int t0 = lo;
    lo = t, hi = nt - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (first[mid] <= last[t]) lo = mid; else hi = mid - 1;
    }
    cost[t] = lo - t0;
  }
  __syncthreads();
  const int want = k / gridDim.y;
  for (int t = threadIdx.x; t < nt; t += blockDim.x) {
    const int c = cost[t];
    int rank = 0;
    for (int j = 0; j < nt; ++j) rank += cost[j] > c || (cost[j] == c && j < t);
    if (rank == want) cost[nt] = t;  // the last int of the scratch, read after the barrier
  }
  __syncthreads();
  return make_int2(cost[nt], k % gridDim.y);
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float lds32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ int lds32i(uint32_t addr) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1,%2,%3,%4};\n" ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z),
               "f"(v.w));
}

__device__ __forceinline__ void sts32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v));
}

// Issue the copies of ROWS rows of NH consecutive heads (64 f32 each,
// columns col0 + h * D) into NH swizzled [ROWS][D] tiles at dst + h * ROWS *
// D; rows at or past `valid` are zero-filled. Thread `tid` takes the chunks
// e = tid, tid + NT, ... (row e / 16, chunk e % 16), the chunks
// `rotate_own_f32` rotates.
template <int NT, int ROWS, int NH>
__device__ __forceinline__ void issue_rows_f32(float* dst, const float* src, int row0, int valid,
                                               int ld, int col0, int tid) {
#pragma unroll
  for (int e = tid; e < ROWS * 16; e += NT) {
    const int r = e >> 4, c = e & 15;
    const bool ok = row0 + r < valid;
    const size_t off = ok ? (size_t)(row0 + r) * ld + col0 + c * 4 : col0;
#pragma unroll
    for (int h = 0; h < NH; ++h) cp_async16(dst + h * ROWS * D + swz(r, c), src + off + h * D, ok);
  }
}

// Rotate in place the chunks this thread copied with `issue_rows_f32` (same
// loop), each pair by `rot_pair` in fp32: apply_rotary_emb's values bit for
// bit. In that loop a thread's chunks are column chunk c = tid % 16 (pairs
// 2c, 2c + 1) of rows tid / 16 + n NT / 16, rows whose low 3 bits, and so
// the swizzle, are the same. The table entries (rows below `valid`, pairs
// < P) are read into registers first; `landed()` then waits for the
// thread's copies, so the two latencies overlap.
template <int NT, int ROWS, int NH, typename Landed>
__device__ __forceinline__ void rotate_own_f32(float* dst, int row0, int valid, const Rope& rp,
                                               int tid, Landed landed) {
  static_assert(NT % 128 == 0, "a thread's rows must share their low 3 bits");
  constexpr int RSTEP = NT / 16;                   // rows between a thread's chunks
  constexpr int CH = (ROWS + RSTEP - 1) / RSTEP;  // chunks a thread, at most
  const int c = tid & 15, r0 = tid >> 4, p = 2 * c;
  const bool live = p < rp.P, two = p + 1 < rp.P;
  float4 tab[CH];  // cos 2c, cos 2c + 1, sin 2c, sin 2c + 1 of row r0 + n RSTEP
#pragma unroll
  for (int n = 0; n < CH; ++n) {
    const int r = r0 + n * RSTEP;
    tab[n] = make_float4(1.f, 1.f, 0.f, 0.f);
    if (!live || r >= ROWS || row0 + r >= valid) continue;
    const int t = (row0 + r) * rp.P + p;
    if (rp.pairs8 && two) {
      const float2 cv = *reinterpret_cast<const float2*>(rp.cos + t);
      const float2 sv = *reinterpret_cast<const float2*>(rp.sin + t);
      tab[n] = make_float4(cv.x, cv.y, sv.x, sv.y);
    } else {
      tab[n].x = rp.cos[t];
      tab[n].z = rp.sin[t];
      if (two) {
        tab[n].y = rp.cos[t + 1];
        tab[n].w = rp.sin[t + 1];
      }
    }
  }
  landed();
  const uint32_t x0 = smem_u32(dst) + r0 * D * 4 + ((c ^ (r0 & 7)) << 4);
#pragma unroll
  for (int n = 0; n < CH; ++n) {
    const int r = r0 + n * RSTEP;
    if (!live || r >= ROWS || row0 + r >= valid) continue;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const uint32_t xa = x0 + (h * ROWS + n * RSTEP) * D * 4;
      float4 val = lds128(xa);
      rot_pair(val.x, val.y, tab[n].x, tab[n].z);
      if (two) rot_pair(val.z, val.w, tab[n].y, tab[n].w);
      sts128(xa, val);
    }
  }
}

// Rotate in place, in shared memory, the chunks this thread copied with
// `issue_rows` (same loop), by the table entries it copied with
// `issue_tables`: each pair rotated in fp32 by `rot_pair` and rounded back
// to bf16, so the result is apply_rotary_emb's bit for bit.
template <int NT, int ROWS, int NH>
__device__ __forceinline__ void rotate_own(__nv_bfloat16* dst, int row0, int valid,
                                           const float* cos_s, const float* sin_s, int P, int tid) {
#pragma unroll
  for (int e = tid; e < ROWS * 8; e += NT) {
    const int r = e >> 3, c = (e & 7) * 8;
    if (row0 + r >= valid) continue;
    // the chunk's 4 entries of each table in one 16-byte load (entries past
    // P were not copied and are not used)
    const float4 cs = *reinterpret_cast<const float4*>(&cos_s[r * PMAX + (c >> 1)]);
    const float4 sn = *reinterpret_cast<const float4*>(&sin_s[r * PMAX + (c >> 1)]);
    const float cv[4] = {cs.x, cs.y, cs.z, cs.w}, sv[4] = {sn.x, sn.y, sn.z, sn.w};
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      uint4* x = reinterpret_cast<uint4*>(&dst[(h * ROWS + r) * LDS + c]);
      uint4 v = *x;
      uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if ((c >> 1) + i < P) {
          const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
          float x0 = __low2float(b), x1 = __high2float(b);
          rot_pair(x0, x1, cv[i], sv[i]);
          w[i] = pack_bf16(x0, x1);
        }
      }
      *x = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

}  // namespace
