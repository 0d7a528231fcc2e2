// The pipelined dq kernels of the segment attention, bf16 (`bwd_dq_pipe`)
// and f32 (`bwd_dq_f32_pipe`), shared by the row 2 backward
// (flash_segment_attn_bwd.cu: plain and kRope instantiations) and the v1
// backward (flash_segment_attn_v1.cu: the plain instantiations, with one id
// vector for q and kv; dq is the same function in both). The designs are
// described in flash_segment_attn_bwd.cu.
//
// Each source builds into its own library, so everything here has internal
// linkage.

#pragma once

#include "segment_attn_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 dq: one CTA per (64-row q tile, HPC q heads of one GQA group), a
// cp.async ring of K/V tiles, operands by ldmatrix (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

// Tiles in the ring: t computed, t + 1 prepared, t + 2 in flight. The
// prologue fills tiles 0 and 1, and the one table buffer holds one tile's
// rows, so a deeper ring needs both to change (as in the forward).
constexpr int DQ_STAGES = 3;
// Each K/V tile in passes of 64 / DQ_NPASS kv columns: a thread holds the f32
// dq accumulator and one pass's S, dP and bf16(dS). One pass (S and dP of
// 64 columns live at once) spills; four re-read Q and dO more often.
constexpr int DQ_NPASS = 2;
// q heads a RoPE CTA takes where the group allows it (the plain kernel 2)
constexpr int DQ_ROPE_HPC = 4;

// Bytes of one ring stage: the K and V tiles and the tile's ids.
__host__ __device__ constexpr int dq_stage_bytes() { return 2 * BT * LDS * 2 + BT * 4; }

// Dynamic shared memory: Q and dO of the CTA's heads, the ring, and (kRope)
// one buffer of table rows (q's 64 rows, then each K tile's 64).
template <bool kRope, int HPC>
__host__ __device__ constexpr int dq_smem_bytes() {
  return 2 * HPC * BT * LDS * 2 + DQ_STAGES * dq_stage_bytes() + (kRope ? 2 * BT * PMAX * 4 : 0);
}

struct DqStage {
  __nv_bfloat16* k;
  __nv_bfloat16* v;
  int* ids;
};

__device__ __forceinline__ DqStage dq_stage(unsigned char* base) {
  DqStage st;
  st.k = reinterpret_cast<__nv_bfloat16*>(base);
  st.v = st.k + BT * LDS;
  st.ids = reinterpret_cast<int*>(st.v + BT * LDS);
  return st;
}

// HPC q heads of one group per CTA, 4 warps a head, each warp 16 q rows of
// one head. Every staged K/V tile (and kRope its rotation) serves HPC * 64
// (row, head) pairs; the kv interval is the q tile's, shared by its heads.
template <bool kRope, int HPC>
__global__ void __launch_bounds__(HPC * 128, HPC == 3 ? 1 : 4 / HPC)
bwd_dq_pipe(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q,
            const int* __restrict__ seg_k, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dq, int S, int Sk, int hq, int hkv, float scale,
            Rope rq, Rope rk) {
  constexpr int NT = HPC * 128;
  constexpr int NS = DQ_STAGES;
  constexpr int SB = dq_stage_bytes();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int range_s[2];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [HPC][BT][LDS]
  __nv_bfloat16* do_s = q_s + HPC * BT * LDS;                   // [HPC][BT][LDS]
  unsigned char* ring = smem + 2 * HPC * BT * LDS * 2;
  float* tcos = reinterpret_cast<float*>(ring + NS * SB);  // kRope: [BT][PMAX]
  float* tsin = tcos + BT * PMAX;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int rep = hq / hkv, splits = rep / HPC;
  const int hk = blockIdx.y / splits;
  const int h0 = hk * rep + (blockIdx.y % splits) * HPC;  // the CTA's first q head
  const int hw = warp >> 2;                               // this warp's head, h0 + hw
  const int r0 = (warp & 3) * 16;                         // its rows r0 + g, r0 + g + 8
  const int q0 = blockIdx.x * BT;
  const int q1 = min(q0 + BT, S);
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
  issue_rows<NT, BT, HPC>(q_s, q, q0, S, ldq, h0 * D, tid);
  issue_rows<NT, BT, HPC>(do_s, dout, q0, S, ldq, h0 * D, tid);
  if constexpr (kRope) issue_tables<NT, BT>(tcos, tsin, q0, S, rq, tid);
  cp_async_commit();
  // this thread's rows r0 + g, r0 + g + 8 of head h0 + hw: ids, lse in log2
  // units (p = 2^(s scale log2e - lse log2e), one ex2.approx) and delta
  constexpr float L2E = 1.4426950408889634f;
  int sq0, sq1;
  float ls0, ls1, dl0, dl1;
  {
    const int row0 = q0 + r0 + g, row1 = row0 + 8, h = h0 + hw;
    sq0 = row0 < S ? remap(seg_q[row0]) : NO_ROW_Q;
    sq1 = row1 < S ? remap(seg_q[row1]) : NO_ROW_Q;
    ls0 = row0 < S ? lse[(size_t)row0 * hq + h] * L2E : 0.f;
    ls1 = row1 < S ? lse[(size_t)row1 * hq + h] * L2E : 0.f;
    dl0 = row0 < S ? delta[(size_t)row0 * hq + h] : 0.f;
    dl1 = row1 < S ? delta[(size_t)row1 * hq + h] : 0.f;
  }
  segment_interval_warps(seg_q, seg_k, q0, q1, Sk, range_s);  // its barrier also
  const int lo = range_s[0], hi = range_s[1];                  // publishes the inits
  const int ntiles = (hi - lo + BT - 1) / BT;

  // tile t's K, V, ids (and kRope: table rows, into the one table buffer)
  // into stage t % NS; no commit
  auto issue = [&](int t) {
    if (t < ntiles) {
      const DqStage st = dq_stage(ring + (t % NS) * SB);
      const int kv0 = lo + t * BT;
      issue_rows<NT, BT, 1>(st.k, k, kv0, hi, ldk, hk * D, tid);
      issue_rows<NT, BT, 1>(st.v, v, kv0, hi, ldk, hk * D, tid);
      if (tid < BT && kv0 + tid < hi) cp_async4(&st.ids[tid], seg_k + kv0 + tid, true);
      if constexpr (kRope) issue_tables<NT, BT>(tcos, tsin, kv0, hi, rk, tid_fresh());
    }
  };
  // this thread's copies of tile t have landed: finish them (rotate its K
  // chunks, remap its id) and say so
  auto prep = [&](int t) {
    if (t < ntiles) {
      const DqStage st = dq_stage(ring + (t % NS) * SB);
      const int kv0 = lo + t * BT;
      if constexpr (kRope) rotate_own<NT, BT, 1>(st.k, kv0, hi, tcos, tsin, rk.P, tid_fresh());
      if (tid < BT) st.ids[tid] = kv0 + tid < hi ? remap(st.ids[tid]) : NO_ROW_K;
      mbar_arrive(&ready[t % NS]);
    }
  };

  // Q (rotated once, for all HPC heads) and dO, then tiles 0 and 1; a
  // tile's table rows go in only after the previous user of this thread's
  // table entries is done
  if constexpr (kRope) {
    cp_async_wait<0>();
    rotate_own<NT, BT, HPC>(q_s, q0, S, tcos, tsin, rq.P, tid);
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
  __syncthreads();  // Q (rotated) and dO are whole
  const __nv_bfloat16* qs = q_s + hw * BT * LDS;
  const __nv_bfloat16* dos = do_s + hw * BT * LDS;

  float acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  constexpr int CP = 64 / DQ_NPASS, NTP = CP / 8, KSP = CP / 16;
  const float sl2 = scale * L2E;
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
    const DqStage st = dq_stage(ring + (t % NS) * SB);
    // the ids are non-decreasing, so rows whose id is the tile's first and
    // last row's see no masked column here: no compares
    const bool all = st.ids[0] == st.ids[BT - 1] && st.ids[0] == sq0 && sq0 == sq1;

    // unrolled, the plain instantiation spills a few bytes at 128 registers
    // (ptxas's choice; the RoPE one does not): it runs its passes rolled
#pragma unroll(kRope ? DQ_NPASS : 1)
    for (int c = 0; c < DQ_NPASS; ++c) {  // kv columns c * CP .. + CP - 1
      float s[NTP][4], dp[NTP][4];
#pragma unroll
      for (int n = 0; n < NTP; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int kk2 = 0; kk2 < 2; ++kk2) {  // S = Q K^T, dP = dO V^T
        uint32_t a[2][4];
        ldsm_x4(a[0], &qs[(r0 + (lane & 15)) * LDS + kk2 * 32 + (lane >> 4) * 8]);
        ldsm_x4(a[1], &qs[(r0 + (lane & 15)) * LDS + kk2 * 32 + 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int n = 0; n < NTP; ++n) {
          uint32_t b[4];
          ldsm_x4(b, &st.k[((c * NTP + n) * 8 + (lane & 7)) * LDS + kk2 * 32 + (lane >> 3) * 8]);
          mma_bf16(s[n], a[0], b);
          mma_bf16(s[n], a[1], b + 2);
        }
        ldsm_x4(a[0], &dos[(r0 + (lane & 15)) * LDS + kk2 * 32 + (lane >> 4) * 8]);
        ldsm_x4(a[1], &dos[(r0 + (lane & 15)) * LDS + kk2 * 32 + 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int n = 0; n < NTP; ++n) {
          uint32_t b[4];
          ldsm_x4(b, &st.v[((c * NTP + n) * 8 + (lane & 7)) * LDS + kk2 * 32 + (lane >> 3) * 8]);
          mma_bf16(dp[n], a[0], b);
          mma_bf16(dp[n], a[1], b + 2);
        }
      }
      // p = 2^(s scale log2e - lse log2e), masked; dS = p (dP - delta) scale,
      // rounded to bf16 as A fragments (n-tiles 2j, 2j+1 -> k step j)
      uint32_t dsa[KSP][4];
#pragma unroll
      for (int n = 0; n < NTP; ++n) {
        float p0 = fast_exp2(fmaf(s[n][0], sl2, -ls0));
        float p1 = fast_exp2(fmaf(s[n][1], sl2, -ls0));
        float p2 = fast_exp2(fmaf(s[n][2], sl2, -ls1));
        float p3 = fast_exp2(fmaf(s[n][3], sl2, -ls1));
        if (!all) {
          const int c0 = (c * NTP + n) * 8 + t2;
          const int sk0 = st.ids[c0], sk1 = st.ids[c0 + 1];
          if (sq0 != sk0) p0 = 0.f;
          if (sq0 != sk1) p1 = 0.f;
          if (sq1 != sk0) p2 = 0.f;
          if (sq1 != sk1) p3 = 0.f;
        }
        dsa[n >> 1][(n & 1) * 2 + 0] =
            pack_bf16(p0 * (dp[n][0] - dl0) * scale, p1 * (dp[n][1] - dl0) * scale);
        dsa[n >> 1][(n & 1) * 2 + 1] =
            pack_bf16(p2 * (dp[n][2] - dl1) * scale, p3 * (dp[n][3] - dl1) * scale);
      }
#pragma unroll
      for (int j = 0; j < KSP; ++j) {  // dQ += bf16(dS) K: K rows are the k dim
#pragma unroll
        for (int dt2 = 0; dt2 < 4; ++dt2) {
          uint32_t b[4];
          ldsm_x4_t(b, &st.k[((c * KSP + j) * 16 + (lane & 15)) * LDS + dt2 * 16 + (lane >> 4) * 8]);
          mma_bf16(acc[2 * dt2], dsa[j], b);
          mma_bf16(acc[2 * dt2 + 1], dsa[j], b + 2);
        }
      }
    }
    mbar_arrive(&empty[t % NS]);
  }
  cp_async_wait<0>();  // only empty groups can be left

  // this thread's rows and head, afresh (not held across the loop)
  const int tf = tid_fresh();
  const int t2f = (tf & 3) * 2, h = h0 + (tf >> 7);
  const int row0 = q0 + ((tf >> 5) & 3) * 16 + ((tf & 31) >> 2), row1 = row0 + 8;
  if constexpr (kRope) {  // back to the raw q: pair dt * 4 + t2 / 2 of each row
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      if (row0 < S) inv_rot_acc(acc[dt][0], acc[dt][1], rq, row0, dt * 4 + (t2f >> 1));
      if (row1 < S) inv_rot_acc(acc[dt][2], acc[dt][3], rq, row1, dt * 4 + (t2f >> 1));
    }
  }
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = h * D + dt * 8 + t2f;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(dq + (size_t)row0 * ldq + col) = pack_bf16(acc[dt][0], acc[dt][1]);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(dq + (size_t)row1 * ldq + col) = pack_bf16(acc[dt][2], acc[dt][3]);
  }
}

template <bool kRope, int HPC>
int launch_dq_pipe(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   const int* seg_q, const int* seg_k, const __nv_bfloat16* dout,
                   const float* lse, const float* delta, __nv_bfloat16* dq, int S, int Sk,
                   int hq, int hkv, float scale, Rope rq, Rope rk, cudaStream_t st) {
  constexpr int smem = dq_smem_bytes<kRope, HPC>();
  auto kern = bwd_dq_pipe<kRope, HPC>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + BT - 1) / BT, hkv * (hq / hkv / HPC));
  kern<<<grid, HPC * 128, smem, st>>>(q, k, v, seg_q, seg_k, dout, lse, delta, dq, S, Sk, hq,
                                      hkv, scale, rq, rk);
  return static_cast<int>(cudaGetLastError());
}

// q heads a CTA takes, from the group's Hq/Hkv: RoPE prefers DQ_ROPE_HPC
// (each K tile's table rows are copied and the tile rotated once per CTA),
// the plain kernel 2 (two CTAs an SM); then 3, 2, else 1. HPC does not change
// a (row, head)'s arithmetic: every CTA takes its 64-row q tile's kv tiles
// in ascending order.
template <bool kRope>
int launch_dq_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   const int* seg_q, const int* seg_k, const __nv_bfloat16* dout,
                   const float* lse, const float* delta, __nv_bfloat16* dq, int S, int Sk,
                   int hq, int hkv, float scale, Rope rq, Rope rk, cudaStream_t st) {
  const int rep = hq / hkv;
  if (kRope && rep % DQ_ROPE_HPC == 0)
    return launch_dq_pipe<kRope, DQ_ROPE_HPC>(q, k, v, seg_q, seg_k, dout, lse, delta, dq, S,
                                              Sk, hq, hkv, scale, rq, rk, st);
  if (!kRope && rep % 2 == 0)
    return launch_dq_pipe<kRope, 2>(q, k, v, seg_q, seg_k, dout, lse, delta, dq, S, Sk, hq, hkv,
                                    scale, rq, rk, st);
  if (rep % 3 == 0)
    return launch_dq_pipe<kRope, 3>(q, k, v, seg_q, seg_k, dout, lse, delta, dq, S, Sk, hq, hkv,
                                    scale, rq, rk, st);
  if (rep % 2 == 0)
    return launch_dq_pipe<kRope, 2>(q, k, v, seg_q, seg_k, dout, lse, delta, dq, S, Sk, hq, hkv,
                                    scale, rq, rk, st);
  return launch_dq_pipe<kRope, 1>(q, k, v, seg_q, seg_k, dout, lse, delta, dq, S, Sk, hq, hkv,
                                  scale, rq, rk, st);
}

// ---------------------------------------------------------------------------
// f32 dq: fp32 FMA, register-blocked, one K and one V buffer, one CTA per
// (64-row q tile, HPC q heads of one GQA group)
// ---------------------------------------------------------------------------

constexpr int FDQ = 64;  // q rows a CTA, kv rows a tile

// Dynamic shared memory: Q and dO of the CTA's heads, each warp's dP / dS
// rows (one pass of 64 / NP kv columns), one K tile, one V tile, two tiles'
// ids, lse and delta of the CTA's (row, head)s, and 256 bytes to align the
// base (HPC 4: 232,192 B of the 232,400 a CTA with 48 B of static shared
// memory may have).
template <int HPC, int NP>
__host__ __device__ constexpr int dq_f32_smem_bytes() {
  return 2 * HPC * FDQ * D * 4 + HPC * FDQ * (FDQ / NP) * 4 + 2 * FDQ * D * 4 + 2 * FDQ * 4 +
         2 * HPC * FDQ * 4 + 256;
}

// RT q rows a thread: 16 / RT warps a head, 4 RT rows a warp. Lane (a, b) =
// (lane / 8, lane % 8) of a head's warp w owns q rows 4 RT w + a + 4 i
// (i < RT) of the tile, score columns b + 8 j (j < 8 / NP) of each pass of
// 64 / NP kv columns, and dq columns 4 b .. 4 b + 3, 32 + 4 b .. 32 + 4 b + 3.
// MINB CTAs an SM.
template <bool kRope, int HPC, int RT, int NP, int MINB>
__global__ void __launch_bounds__(HPC * 16 / RT * 32, MINB)
bwd_dq_f32_pipe(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ seg_q,
                const int* __restrict__ seg_k, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int S, int Sk, int hq, int hkv, float scale, Rope rq,
                Rope rk) {
  constexpr int WPH = 16 / RT;  // warps a head
  constexpr int NT = HPC * WPH * 32;
  constexpr int WR = 4 * RT;    // q rows a warp
  constexpr int CW = FDQ / NP;  // kv columns a pass
  constexpr int NJ = CW / 8;    // score columns a lane in a pass
  constexpr int RB = CW * 4;    // bytes of a dP / dS row
  extern __shared__ unsigned char smem_raw[];
  __shared__ int range_s[2];
  // K and V each have `full` (every thread has finished its copies of the
  // tile) and `free` (every thread is done computing on it)
  __shared__ uint64_t kfull, kfree, vfull, vfree;
  unsigned char* smem = smem_raw + ((256 - (smem_u32(smem_raw) & 255)) & 255);
  float* q_s = reinterpret_cast<float*>(smem);  // [HPC][FDQ][D], swizzled
  float* do_s = q_s + HPC * FDQ * D;            // [HPC][FDQ][D], swizzled
  float* b_s = do_s + HPC * FDQ * D;            // [HPC * WPH warps][WR][CW], swizzled
  float* k_s = b_s + HPC * FDQ * CW;            // [FDQ][D], swizzled
  float* v_s = k_s + FDQ * D;
  int* ids2 = reinterpret_cast<int*>(v_s + FDQ * D);  // [2][FDQ]: tile t's at t & 1
  float* lse_s = reinterpret_cast<float*>(ids2 + 2 * FDQ);  // [HPC][FDQ], then delta's

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int a = lane >> 3, b = lane & 7;
  const int2 item = lpt_item(seg_q, S, FDQ, MINB, reinterpret_cast<int*>(k_s));
  const int rep = hq / hkv, splits = rep / HPC;
  const int hk = item.y / splits;
  const int h0 = hk * rep + (item.y % splits) * HPC;  // the CTA's first q head
  const int hw = warp / WPH;                          // this warp's head, h0 + hw
  const int r0 = (warp % WPH) * WR + a;               // its rows r0 + 4 i
  const int q0 = item.x * FDQ;
  const int q1 = min(q0 + FDQ, S);
  const int ldq = hq * D, ldk = hkv * D;

  if (tid == 0) {
    mbar_init(&kfull, NT);
    mbar_init(&kfree, NT);
    mbar_init(&vfull, NT);
    mbar_init(&vfree, NT);
  }
  issue_rows_f32<NT, FDQ, HPC>(q_s, q, q0, S, ldq, h0 * D, tid);
  issue_rows_f32<NT, FDQ, HPC>(do_s, dout, q0, S, ldq, h0 * D, tid);
  // lse (as the forward wrote it, l clamped) and delta
  for (int e = tid; e < HPC * FDQ; e += NT) {
    const int r = e % FDQ;
    const bool ok = q0 + r < S;
    const size_t off = ok ? (size_t)(q0 + r) * hq + h0 + e / FDQ : 0;
    cp_async4(&lse_s[e], lse + off, ok);
    cp_async4(&lse_s[HPC * FDQ + e], delta + off, ok);
  }
  cp_async_commit();
  int sq[RT];  // the ids of this thread's rows
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + r0 + 4 * i;
    sq[i] = row < S ? remap(seg_q[row]) : NO_ROW_Q;
  }
  segment_interval_warps(seg_q, seg_k, q0, q1, Sk, range_s);  // its barrier also
  const int lo = range_s[0], hi = range_s[1];                  // publishes the inits
  const int ntiles = (hi - lo + FDQ - 1) / FDQ;

  // tile t's K and ids, or its V; each one commit, empty past the last tile
  auto issue_k = [&](int t) {
    if (t < ntiles) {
      const int kv0 = lo + t * FDQ;
      issue_rows_f32<NT, FDQ, 1>(k_s, k, kv0, hi, ldk, hk * D, tid);
      if (tid < FDQ && kv0 + tid < hi) cp_async4(&ids2[(t & 1) * FDQ + tid], seg_k + kv0 + tid, true);
    }
    cp_async_commit();
  };
  auto issue_v = [&](int t) {
    if (t < ntiles) issue_rows_f32<NT, FDQ, 1>(v_s, v, lo + t * FDQ, hi, ldk, hk * D, tid);
    cp_async_commit();
  };

  // Q (rotated once, for all HPC heads) and dO while tile 0's V and K are in
  // flight
  issue_v(0);
  issue_k(0);
  auto qd_landed = [] { cp_async_wait<2>(); };
  if constexpr (kRope) rotate_own_f32<NT, FDQ, HPC>(q_s, q0, S, rq, tid, qd_landed);
  else qd_landed();
  __syncthreads();  // Q, rotated, and dO are whole

  // Shared addresses (bytes). Q (dO) row r0 + 4 i, chunk c: row r0 + 4 i has
  // low bits a + 4 (i & 1), so the chunk sits at (qa[i & 1] ^ (c << 4)) +
  // 1024 i (+ DOFF). The warp's dP / dS rows a + 4 i (RB bytes each) likewise
  // at (pa[i & 1] ^ (c << 4)) + 4 RB i; this lane's column b + 8 j of row
  // a + 4 i at (pst[i & 1] ^ (j << 5)) + 4 RB i. K (V) row b + 8 j of pass
  // c (low bits b), chunk c': (kb ^ (c' << 4)) + 256 CW c + 2048 j (+ VOFF);
  // K row 4 cc + x, chunks b and 8 + b: ((kc + 1024 cc) ^ ((4 (cc & 1) + x)
  // << 4)) + 256 x, + 128.
  const uint32_t qrow = smem_u32(q_s) + hw * FDQ * D * 4 + r0 * 256 + (a << 4);
  const uint32_t qa[2] = {qrow, qrow ^ 64};
  constexpr uint32_t DOFF = HPC * FDQ * D * 4;
  const uint32_t prow = smem_u32(b_s) + warp * WR * RB + a * RB + (a << 4);
  const uint32_t pa[2] = {prow, prow ^ 64};
  const uint32_t pst[2] = {(pa[0] ^ ((b >> 2) << 4)) + ((b & 3) << 2),
                           (pa[1] ^ ((b >> 2) << 4)) + ((b & 3) << 2)};
  const uint32_t kb = smem_u32(k_s) + b * 256 + (b << 4);
  const uint32_t kc = smem_u32(k_s) + (b << 4);
  constexpr uint32_t VOFF = FDQ * D * 4;

  // t = (Q or dO rows r0 + 4 i, at xo) . (K or V rows b + 8 j of the pass,
  // at yb): d ascending, one fmaf chain an entry. Each step of 4 d: RT float4
  // of Q (or dO), NJ of K (or V), 4 RT NJ FFMA
  auto rows_dot = [&](float (*t)[NJ], uint32_t xo, uint32_t yb) {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) t[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < 16; ++c) {
      const uint32_t c4 = c << 4;
      float4 xv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) xv[i] = lds128(((qa[i & 1] ^ c4) + xo) + 1024 * i);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 yv = lds128((yb ^ c4) + 2048 * j);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          t[i][j] = fmaf(xv[i].x, yv.x, t[i][j]);
          t[i][j] = fmaf(xv[i].y, yv.y, t[i][j]);
          t[i][j] = fmaf(xv[i].z, yv.z, t[i][j]);
          t[i][j] = fmaf(xv[i].w, yv.w, t[i][j]);
        }
      }
    }
  };

  float acc[RT][8];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    // this thread's copies of V(t) have landed (K(t) may be in flight); then
    // wait for all
    cp_async_wait<1>();
    mbar_arrive(&vfull);
    mbar_wait(&vfull, t & 1);
    // this lane's column ids of the tile, read where they are compared; K(t +
    // 1) writes the other half
    const uint32_t ids_b = smem_u32(ids2) + (t & 1) * FDQ * 4 + 4 * b;
#pragma unroll
    for (int c = 0; c < NP; ++c) {  // kv columns c CW .. c CW + CW - 1
      // dP = dO V^T into this lane's entries of the warp's rows
      float s[RT][NJ];
      rows_dot(s, DOFF, kb + VOFF + 256 * CW * c);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) sts32((pst[i & 1] ^ (j << 5)) + 4 * RB * i, s[i][j]);
      if (c == NP - 1) mbar_arrive(&vfree);
      if (c == 0) {
        // this thread's copies of K(t) have landed: finish them (kRope:
        // rotate its chunks; remap its id), then wait for all
        auto k_landed = [] { cp_async_wait<0>(); };
        if constexpr (kRope) rotate_own_f32<NT, FDQ, 1>(k_s, lo + t * FDQ, hi, rk, tid, k_landed);
        else k_landed();
        int* ids = ids2 + (t & 1) * FDQ;
        if (tid < FDQ) ids[tid] = lo + t * FDQ + tid < hi ? remap(ids[tid]) : NO_ROW_K;
        mbar_arrive(&kfull);
        mbar_wait(&kfull, t & 1);
      }

      // S = Q K^T, then dS = p (dP - delta) scale with p = exp(s scale -
      // lse) on live pairs; dP read back from this lane's own entries
      rows_dot(s, 0, kb + 256 * CW * c);
      const uint32_t lsb = smem_u32(lse_s) + (hw * FDQ + r0) * 4;  // row r0 + 4 i: + 16 i
      float ls[RT], dl[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        ls[i] = lds32(lsb + 16 * i);
        dl[i] = lds32(lsb + HPC * FDQ * 4 + 16 * i);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int sk = lds32i(ids_b + 4 * CW * c + 32 * j);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const uint32_t e = (pst[i & 1] ^ (j << 5)) + 4 * RB * i;
          const float p = sq[i] == sk ? expf(s[i][j] * scale - ls[i]) : 0.f;
          sts32(e, p * (lds32(e) - dl[i]) * scale);
        }
      }
      if (c == NP - 1) {
        // V(t + 1) goes in once every thread is done with V(t) (the warps
        // are past their dP by now); it lands during dQ += dS K
        mbar_wait(&vfree, t & 1);
        issue_v(t + 1);
      }
      __syncwarp();

      // dQ += dS K: kv rows ascending. Each step of 4 rows: RT float4 of dS,
      // 8 of K, 32 RT FFMA
#pragma unroll 1
      for (int c2 = 0; c2 < CW / 4; c2 += 2) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int cc = c2 + hh;
          float4 pv[RT];
#pragma unroll
          for (int i = 0; i < RT; ++i) pv[i] = lds128((pa[i & 1] ^ (cc << 4)) + 4 * RB * i);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const uint32_t ka = ((kc + 256 * CW * c + 1024 * cc) ^ ((4 * hh + x) << 4)) + 256 * x;
            const float4 k0 = lds128(ka), k1 = lds128(ka + 128);
#pragma unroll
            for (int i = 0; i < RT; ++i) {
              const float p = x == 0 ? pv[i].x : x == 1 ? pv[i].y : x == 2 ? pv[i].z : pv[i].w;
              acc[i][0] = fmaf(p, k0.x, acc[i][0]);
              acc[i][1] = fmaf(p, k0.y, acc[i][1]);
              acc[i][2] = fmaf(p, k0.z, acc[i][2]);
              acc[i][3] = fmaf(p, k0.w, acc[i][3]);
              acc[i][4] = fmaf(p, k1.x, acc[i][4]);
              acc[i][5] = fmaf(p, k1.y, acc[i][5]);
              acc[i][6] = fmaf(p, k1.z, acc[i][6]);
              acc[i][7] = fmaf(p, k1.w, acc[i][7]);
            }
          }
        }
      }
      __syncwarp();  // the warp's dP / dS rows are free for the next pass
    }
    // K(t + 1) goes in once every thread is done with K(t); it lands during
    // dP(t + 1)
    mbar_arrive(&kfree);
    mbar_wait(&kfree, t & 1);
    issue_k(t + 1);
  }
  cp_async_wait<0>();  // only empty groups can be left

  const int h = h0 + hw;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + r0 + 4 * i;
    if (row >= S) continue;
    if constexpr (kRope) {  // back to the raw q: this lane holds both columns of each pair
#pragma unroll
      for (int j = 0; j < 8; j += 2)
        inv_rot_acc(acc[i][j], acc[i][j + 1], rq, row, (j < 4 ? 2 * b : 16 + 2 * b) + (j & 3) / 2);
    }
    float* dst = dq + (size_t)row * ldq + h * D + 4 * b;
    *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dst + 32) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// Launches, or with `describe` fills describe[0..7] (`describe_kernel`, then
// q heads a CTA, q rows a thread, kv rows a tile, kv column passes a tile)
// and launches nothing.
template <bool kRope, int HPC, int RT, int NP, int MINB>
int launch_dq_f32_pipe(const float* q, const float* k, const float* v, const int* seg_q,
                       const int* seg_k, const float* dout, const float* lse, const float* delta,
                       float* dq, int S, int Sk, int hq, int hkv, float scale, Rope rq, Rope rk,
                       cudaStream_t st, int* describe) {
  constexpr int smem = dq_f32_smem_bytes<HPC, NP>();
  constexpr int threads = HPC * 16 / RT * 32;
  auto kern = bwd_dq_f32_pipe<kRope, HPC, RT, NP, MINB>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && MINB > 1)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (describe) {
    describe[4] = HPC;
    describe[5] = RT;
    describe[6] = FDQ;
    describe[7] = NP;
    return describe_kernel(kern, threads, smem, describe);
  }
  const dim3 grid((S + FDQ - 1) / FDQ, hkv * (hq / hkv / HPC));
  kern<<<grid, threads, smem, st>>>(q, k, v, seg_q, seg_k, dout, lse, delta, dq, S, Sk, hq, hkv,
                                    scale, rq, rk);
  return static_cast<int>(cudaGetLastError());
}

// q heads a CTA: 4 where 4 divide the group (8 q rows a thread, 8 x 8
// blocks, 256 threads, one CTA an SM); 3 where 3 do (4 rows, 384 threads,
// one CTA an SM); else 1 (4 rows, 128 threads, each kv tile in two passes of
// 32 columns, whose dP / dS rows take half the shared memory of one pass of
// 64, so three CTAs fit an SM: at the bench shape, 4/2, its 384 CTAs fill
// the 396 slots in one wave). Every choice gives a (row, head) the same
// tiles and the same arithmetic: the row 2 and v1 instantiations, and any
// group size, agree bit for bit.
template <bool kRope>
int launch_dq_f32(const float* q, const float* k, const float* v, const int* seg_q,
                  const int* seg_k, const float* dout, const float* lse, const float* delta,
                  float* dq, int S, int Sk, int hq, int hkv, float scale, Rope rq, Rope rk,
                  cudaStream_t st, int* describe = nullptr) {
  const int rep = hq / hkv;
  if (rep % 4 == 0)
    return launch_dq_f32_pipe<kRope, 4, 8, 1, 1>(q, k, v, seg_q, seg_k, dout, lse, delta, dq, S,
                                                 Sk, hq, hkv, scale, rq, rk, st, describe);
  if (rep % 3 == 0)
    return launch_dq_f32_pipe<kRope, 3, 4, 1, 1>(q, k, v, seg_q, seg_k, dout, lse, delta, dq, S,
                                                 Sk, hq, hkv, scale, rq, rk, st, describe);
  return launch_dq_f32_pipe<kRope, 1, 4, 2, 3>(q, k, v, seg_q, seg_k, dout, lse, delta, dq, S, Sk,
                                               hq, hkv, scale, rq, rk, st, describe);
}

}  // namespace
