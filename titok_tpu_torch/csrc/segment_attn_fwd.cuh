// The pipelined bf16 forward kernel of the segment attention, shared by the
// row 1 forward (flash_segment_attn_fwd.cu: plain and kRope instantiations)
// and the v1 forward (flash_segment_attn_v1.cu: the kV1 instantiation, whose
// kv tiles are the 64-row tiles of S aligned to row 0, as v1 computes it).
// The design is described in flash_segment_attn_fwd.cu; what kV1 changes is
// described at `fwd_bf16_pipe`.
//
// Each source builds into its own library, so everything here has internal
// linkage.

#pragma once

#include "segment_attn_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, a cp.async ring of K/V tiles, one CTA per (q tile,
// HPC q heads of one GQA group)
// ---------------------------------------------------------------------------

constexpr int BK = 64;  // kv rows per tile
// Tiles in the ring: t computed, t + 1 prepared, t + 2 in flight. The
// prologue fills tiles 0 and 1, and the one table buffer holds one tile's
// rows, so a deeper ring needs both to change.
constexpr int NS = 3;

// Bytes of one ring stage: the K and V tiles and the tile's ids.
__host__ __device__ constexpr int fwd_stage_bytes() { return 2 * BK * LDS * 2 + BK * 4; }

// Dynamic shared memory: Q of the CTA's heads, the ring, and (kRope) one
// buffer of table rows (q's QR rows, then each K tile's 64).
template <bool kRope, int HPC, int QR>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return HPC * QR * LDS * 2 + NS * fwd_stage_bytes() +
         (kRope ? 2 * QR * PMAX * 4 : 0);
}

struct FwdStage {
  __nv_bfloat16* k;
  __nv_bfloat16* v;
  int* ids;
};

__device__ __forceinline__ FwdStage fwd_stage(unsigned char* base) {
  FwdStage st;
  st.k = reinterpret_cast<__nv_bfloat16*>(base);
  st.v = st.k + BK * LDS;
  st.ids = reinterpret_cast<int*>(st.v + BK * LDS);
  return st;
}

// QR q rows of HPC consecutive q heads per CTA; QR / 16 warps per head, each
// warp 16 rows of one head. Every staged K/V tile serves HPC * QR (row, head)
// pairs.
//
// kV1: v1's online softmax takes the kv tiles of 64 rows aligned to row 0 of
// S (the plain version `flash_segment_attention_reference` rounds p against
// the running max after each of them), not tiles that start where the q
// tile's interval starts. So the interval's start is rounded down to a
// multiple of BK; rows of [lo & ~(BK - 1), lo) belong to other segments and
// are masked as any foreign row is, and a tile with no live column for a row
// leaves that row's max, sum and accumulator as they were. Nothing else
// changes: where every segment starts at a multiple of 64, the kV1 and plain
// instantiations take the same tiles and give the same bits.
template <bool kRope, int HPC, int QR, bool kV1 = false>
__global__ void __launch_bounds__(HPC * QR * 2, 512 / (HPC * QR * 2))
fwd_bf16_pipe(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q,
              const int* __restrict__ seg_k, __nv_bfloat16* __restrict__ out,
              float* __restrict__ lse, int S, int Sk, int hq, int hkv, float scale,
              Rope rq, Rope rk) {
  static_assert(!(kRope && kV1), "v1 has no RoPE");
  constexpr int NT = HPC * QR * 2;
  constexpr int SB = fwd_stage_bytes();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int range_s[2];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [HPC][QR][LDS]
  unsigned char* ring = smem + HPC * QR * LDS * 2;
  float* tcos = reinterpret_cast<float*>(ring + NS * SB);  // kRope: [QR][PMAX]
  float* tsin = tcos + QR * PMAX;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;        // fragment row group
  const int t2 = (lane & 3) * 2;  // fragment column pair
  const int rep = hq / hkv, splits = rep / HPC;
  const int hk = blockIdx.y / splits;
  const int h0 = hk * rep + (blockIdx.y % splits) * HPC;  // the CTA's first q head
  const int hw = warp / (QR / 16);                        // this warp's head, h0 + hw
  const int r0 = (warp % (QR / 16)) * 16;                 // its rows r0 + g, r0 + g + 8
  const int q0 = blockIdx.x * QR;
  const int q1 = min(q0 + QR, S);
  const int ldq = hq * D, ldk = hkv * D;

  // per stage: `ready` completes when every thread has finished its copies
  // of the stage's tile (NT arrivals), `empty` when every thread is done
  // computing on it; so a warp may run a tile ahead of the slowest one
  __shared__ uint64_t ready[NS], empty[NS];
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      mbar_init(&ready[i], NT);
      mbar_init(&empty[i], NT);
    }
  }
  issue_rows<NT, QR, HPC>(q_s, q, q0, S, ldq, h0 * D, tid);
  if constexpr (kRope) issue_tables<NT, QR>(tcos, tsin, q0, S, rq, tid);
  cp_async_commit();
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
  const int sq0 = row0 < S ? remap(seg_q[row0]) : NO_ROW_Q;
  const int sq1 = row1 < S ? remap(seg_q[row1]) : NO_ROW_Q;
  segment_interval_warps(seg_q, seg_k, q0, q1, Sk, range_s);  // its barrier also
  if constexpr (kV1) {                                         // publishes the inits
    // the start rounded down in shared memory, behind a barrier: rounded in
    // registers, it made ptxas spill 4 bytes at 128 registers
    if (tid == 0) range_s[0] &= ~(BK - 1);
    __syncthreads();
  }
  const int lo = range_s[0], hi = range_s[1];
  const int ntiles = (hi - lo + BK - 1) / BK;

  // tile t's K, V, ids (and kRope: table rows, into the one table buffer)
  // into stage t % NS; no commit
  auto issue = [&](int t) {
    if (t < ntiles) {
      const FwdStage st = fwd_stage(ring + (t % NS) * SB);
      const int kv0 = lo + t * BK;
      issue_rows<NT, BK, 1>(st.k, k, kv0, hi, ldk, hk * D, tid);
      issue_rows<NT, BK, 1>(st.v, v, kv0, hi, ldk, hk * D, tid);
      if (tid < BK && kv0 + tid < hi) cp_async4(&st.ids[tid], seg_k + kv0 + tid, true);
      if constexpr (kRope) issue_tables<NT, BK>(tcos, tsin, kv0, hi, rk, tid_fresh());
    }
  };
  // this thread's copies of tile t have landed: finish them (rotate its K
  // chunks, remap its id) and say so
  auto prep = [&](int t) {
    if (t < ntiles) {
      const FwdStage st = fwd_stage(ring + (t % NS) * SB);
      const int kv0 = lo + t * BK;
      if constexpr (kRope) rotate_own<NT, BK, 1>(st.k, kv0, hi, tcos, tsin, rk.P, tid_fresh());
      if (tid < BK) st.ids[tid] = kv0 + tid < hi ? remap(st.ids[tid]) : NO_ROW_K;
      mbar_arrive(&ready[t % NS]);
    }
  };

  // Q (rotated once), then tiles 0 and 1; a tile's table rows go in only
  // after the previous user of this thread's table entries is done
  if constexpr (kRope) {
    cp_async_wait<0>();
    rotate_own<NT, QR, HPC>(q_s, q0, S, tcos, tsin, rq.P, tid);
    issue(0);
    cp_async_commit();
    cp_async_wait<0>();
    prep(0);
    issue(1);
    cp_async_commit();
  } else {
    issue(0);
    issue(1);
    cp_async_commit();
    cp_async_wait<0>();
    prep(0);
  }
  __syncthreads();  // Q, rotated, is whole
  const __nv_bfloat16* qs = q_s + hw * QR * LDS;

  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units: ex2, not exp
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0 + g, r0 + g + 8 (log2 units)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the running sums
  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    // tile t + 1 was issued before tile t - 1 was computed: finish it; then
    // put tile t + NS - 1 in flight into the stage of tile t - 1, once every
    // thread is done with that
    cp_async_wait<0>();
    prep(t + 1);
    if (t + NS - 1 < ntiles) {
      if (t >= 1) mbar_wait(&empty[(t - 1) % NS], ((t - 1) / NS) & 1);
      issue(t + NS - 1);
    }
    cp_async_commit();
    mbar_wait(&ready[t % NS], (t / NS) & 1);
    const FwdStage st = fwd_stage(ring + (t % NS) * SB);

    // S = Q K^T: 16 rows x 64 kv columns per warp, as 8 n-tiles of 8
    float s[8][4];
    mma_abt_ldsm(s, qs, r0, st.k, lane);

    // scale, mask to -inf, row max (a row's 4 lanes form a quad). The ids
    // are non-decreasing, so a row whose id is the tile's first and last
    // row's has no masked column here: the usual case, and no compares.
    const int id_a = st.ids[0], id_b = st.ids[BK - 1];
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (id_a == id_b && id_a == sq0 && id_a == sq1) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] *= sl2;
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int sk0 = st.ids[nt * 8 + t2], sk1 = st.ids[nt * 8 + t2 + 1];
        s[nt][0] = sq0 == sk0 ? s[nt][0] * sl2 : -INFINITY;
        s[nt][1] = sq0 == sk1 ? s[nt][1] * sl2 : -INFINITY;
        s[nt][2] = sq1 == sk0 ? s[nt][2] * sl2 : -INFINITY;
        s[nt][3] = sq1 == sk1 ? s[nt][3] * sl2 : -INFINITY;
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with no live column yet subtracts 0, so every exponent of a
    // masked score is -inf and its p exactly 0, with no select
    const float z0 = mn0 == -INFINITY ? 0.f : mn0, z1 = mn1 == -INFINITY ? 0.f : mn1;
    const float a0 = fast_exp2(m0 - z0), a1 = fast_exp2(m1 - z1);
    m0 = mn0;
    m1 = mn1;

    // p, the row sums, and P as A fragments (n-tiles 2j, 2j+1 -> k step j)
    uint32_t pa[4][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = fast_exp2(s[nt][0] - z0);
      const float p1 = fast_exp2(s[nt][1] - z0);
      const float p2 = fast_exp2(s[nt][2] - z1);
      const float p3 = fast_exp2(s[nt][3] - z1);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;

    // O = O * alpha + P V: 16 rows x 64 d per warp, 8 n-tiles of d
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      o[dt][0] *= a0;
      o[dt][1] *= a0;
      o[dt][2] *= a1;
      o[dt][3] *= a1;
    }
    mma_ab_ldsm(o, pa, st.v, lane);
    mbar_arrive(&empty[t % NS]);

  }
  cp_async_wait<0>();  // only empty groups can be left

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float L0 = fmaxf(l0, 1e-30f), L1 = fmaxf(l1, 1e-30f);
  const int h = h0 + hw;
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
    // lse in natural-log units, as the backward kernels read it; a row that
    // matched no kv row gets -1e30 + log(1e-30), as the plain version does
    constexpr float LN2 = 0.6931471805599453f;
    if (row0 < S) lse[(size_t)row0 * hq + h] = (m0 == -INFINITY ? NEG_INF : m0 * LN2) + logf(L0);
    if (row1 < S) lse[(size_t)row1 * hq + h] = (m1 == -INFINITY ? NEG_INF : m1 * LN2) + logf(L1);
  }
}

template <bool kRope, int HPC, int QR, bool kV1>
int launch_fwd_pipe(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                    const int* seg_q, const int* seg_k, __nv_bfloat16* out, float* lse, int S,
                    int Sk, int hq, int hkv, float scale, Rope rq, Rope rk, cudaStream_t st) {
  constexpr int smem = fwd_smem_bytes<kRope, HPC, QR>();
  auto kern = fwd_bf16_pipe<kRope, HPC, QR, kV1>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + QR - 1) / QR, hkv * (hq / hkv / HPC));
  kern<<<grid, HPC * QR * 2, smem, st>>>(q, k, v, seg_q, seg_k, out, lse, S, Sk, hq, hkv, scale,
                                         rq, rk);
  return static_cast<int>(cudaGetLastError());
}

// q heads a CTA takes, from the group's Hq/Hkv: the plain kernel prefers 2
// (two CTAs an SM, each with its own ring, keep each other's tensor cores
// busy), the rope kernel 4 (each K tile's table rows are copied and the
// tile rotated once per CTA); then 3, 2; else one head of 128 q rows. Both
// take 64-row q tiles wherever the group has 2, 3 or 4 heads, so their tiles,
// and so their arithmetic, are the same. kV1 (plain) takes the plain choice.
template <bool kRope, bool kV1 = false>
int launch_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                    const int* seg_q, const int* seg_k, __nv_bfloat16* out, float* lse, int S,
                    int Sk, int hq, int hkv, float scale, Rope rq, Rope rk, cudaStream_t st) {
  const int rep = hq / hkv;
  if (kRope && rep % 4 == 0)
    return launch_fwd_pipe<kRope, 4, 64, kV1>(q, k, v, seg_q, seg_k, out, lse, S, Sk, hq, hkv,
                                              scale, rq, rk, st);
  if (!kRope && rep % 2 == 0)
    return launch_fwd_pipe<kRope, 2, 64, kV1>(q, k, v, seg_q, seg_k, out, lse, S, Sk, hq, hkv,
                                              scale, rq, rk, st);
  if (rep % 3 == 0)
    return launch_fwd_pipe<kRope, 3, 64, kV1>(q, k, v, seg_q, seg_k, out, lse, S, Sk, hq, hkv,
                                              scale, rq, rk, st);
  if (rep % 2 == 0)
    return launch_fwd_pipe<kRope, 2, 64, kV1>(q, k, v, seg_q, seg_k, out, lse, S, Sk, hq, hkv,
                                              scale, rq, rk, st);
  return launch_fwd_pipe<kRope, 1, 128, kV1>(q, k, v, seg_q, seg_k, out, lse, S, Sk, hq, hkv,
                                             scale, rq, rk, st);
}

}  // namespace
