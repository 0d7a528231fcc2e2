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
// - dq (`bwd_dq_bf16`): one CTA per (64-row q tile, q head), 4 warps of 16
//   q rows. The CTA binary-searches seg_k for the exact kv interval of its
//   tile and visits nothing else. Q and dO stay in registers as mma A
//   fragments; K and V tiles are staged in shared memory through registers,
//   between two barriers. It is the next kernel to redesign as dk/dv was.
// - dk/dv (`bwd_dkv_pipe`): one CTA per (64-row kv tile, kv head). Two warps
//   search seg_q for the q interval of its tile (the JAX
//   `_overlap_ranges(kmm, qmm)`), 32 probes a step. It walks the group's q
//   heads x the q tiles of the interval, so the work of a CTA is a long
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
//   - p = exp(s - lse) as one ex2.approx of s scale log2(e) - lse log2(e);
//     a kv row whose id is the unit's first and last q row's skips the
//     compares (q ids are non-decreasing);
//   - the group's dk/dv: groups 1..NG-1 leave their f32 partial sums in the
//     idle ring, group 0 adds them in a fixed order and rounds to bf16 once.
//     No atomics: two launches give the same bits.
// - bf16 on mma.sync m16n8k16 (bf16 in, fp32 accumulate). f32 on fp32 FMA
//   (no TF32: the f32 path must hold tight tolerances against the plain
//   version), 32-row tiles and 256 threads, K and V in registers.
// Not yet: an asynchronous wgmma pipeline and TMA for dk/dv (a synchronous
// wgmma version was no faster: PERF.md); the dq kernel's redesign.
//
// RoPE fused (kRope = true; entries `flash_segment_attn_rope_bwd_dq` and
// `..._rope_bwd_dkv`): replaces `_bwd_dq_kernel_rope` and
// `_bwd_dkv_kernel_rope`, reached through `_rope_bwd`, the custom_vjp
// backward `_mh_rope` of attn_impl 'flash_rope'. q and k come in unrotated
// with their tables, as in the forward: the kernels rotate q and k tiles as
// they are staged (dq: q once per CTA, each visited k tile, as each
// thread stages it; dk/dv: k once per CTA and each q tile once per CTA for
// all NG heads, in place in shared memory by the thread that copied the
// chunk and its table entries, after its own cp.async wait), so p and ds
// are those of the rotated q and k. The rotation is orthogonal, so the grads of the raw q and k are
// the grads of the rotated ones rotated back: the f32 dq and dk
// accumulators get the inverse rotation (sin negated) before their one
// rounding to the output dtype. dv is unrotated. In the bf16 kernels a
// thread's m16n8 accumulator fragment holds both columns of a pair; in the
// f32 kernels the pair is split over lanes tx and tx ^ 1 and meets by a
// shuffle.

#include "segment_attn_common.cuh"

namespace {

constexpr int BT = 64;  // rows per tile of the bf16 kernels (q and kv)

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

template <bool kRope>
__global__ void __launch_bounds__(NT_BF16)
bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q,
            const int* __restrict__ seg_k, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dq, int S, int Sk, int hq, int hkv, float scale,
            Rope rq, Rope rk) {
  __shared__ __align__(16) __nv_bfloat16 k_s[BT * LDS];  // also stages the Q tile
  __shared__ __align__(16) __nv_bfloat16 v_s[BT * LDS];  // also stages the dO tile
  __shared__ int segq_s[BT];
  __shared__ int segk_s[BT];
  __shared__ int range_s[2];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int q0 = blockIdx.x * BT;
  const int q1 = min(q0 + BT, S);
  const int h = blockIdx.y;
  const int hk = h / (hq / hkv);
  const int ldq = hq * D, ldk = hkv * D;
  const int r0 = warp * 16 + g;  // this thread's rows in the tile: r0 and r0 + 8

  if (tid == 0) segment_interval(seg_q, seg_k, q0, q1, Sk, &range_s[0], &range_s[1]);
  if (tid < BT) segq_s[tid] = (q0 + tid < S) ? remap(seg_q[q0 + tid]) : NO_ROW_Q;
  load_tiles_bf16<kRope>(k_s, q, v_s, dout, q0, S, ldq, h * D, rq);
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
  const int lo = range_s[0], hi = range_s[1];

  float acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int kv0 = lo; kv0 < hi; kv0 += BT) {
    __syncthreads();  // the previous tile is consumed
    load_tiles_bf16<kRope>(k_s, k, v_s, v, kv0, hi, ldk, hk * D, rk);
    if (tid < BT) segk_s[tid] = (kv0 + tid < hi) ? remap(seg_k[kv0 + tid]) : NO_ROW_K;
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

  if constexpr (kRope) {  // back to the raw q: pair dt * 4 + t2 / 2 of each row
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      if (row0 < S) inv_rot_acc(acc[dt][0], acc[dt][1], rq, row0, dt * 4 + (t2 >> 1));
      if (row1 < S) inv_rot_acc(acc[dt][2], acc[dt][3], rq, row1, dt * 4 + (t2 >> 1));
    }
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
// bf16 dk/dv: one CTA per (64-row kv tile, kv head), NG warp groups over the
// group's q heads, a cp.async ring of (q tile, NG heads) units
// ---------------------------------------------------------------------------

constexpr int DKV_STAGES = 2;  // units in the ring: u computed, u+1 in flight

// Bytes of one ring stage: the Q and dO tiles of NG heads, their lse and
// delta, and the q ids.
template <int NG>
__host__ __device__ constexpr int dkv_stage_bytes() {
  return NG * 2 * BT * LDS * 2 + NG * 2 * BT * 4 + BT * 4;
}

// Dynamic shared memory: K and V, the ring, and (kRope) one buffer of table
// rows (k's 64 rows, then each unit's q rows).
template <bool kRope, int NG>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return 2 * BT * LDS * 2 + DKV_STAGES * dkv_stage_bytes<NG>() + (kRope ? 2 * BT * PMAX * 4 : 0);
}

struct DkvStage {
  __nv_bfloat16* q;   // [NG][BT][LDS]
  __nv_bfloat16* dO;  // [NG][BT][LDS]
  float* lse;         // [NG][BT]
  float* delta;       // [NG][BT]
  int* ids;           // [BT]
};

template <int NG>
__device__ __forceinline__ DkvStage dkv_stage(unsigned char* base) {
  DkvStage st;
  st.q = reinterpret_cast<__nv_bfloat16*>(base);
  st.dO = st.q + NG * BT * LDS;
  st.lse = reinterpret_cast<float*>(st.dO + NG * BT * LDS);
  st.delta = st.lse + NG * BT;
  st.ids = reinterpret_cast<int*>(st.delta + NG * BT);
  return st;
}

template <bool kRope, int NG>
__global__ void __launch_bounds__(NG * 128, NG == 3 ? 1 : 4 / NG)
bwd_dkv_pipe(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q,
             const int* __restrict__ seg_k, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int Sk,
             int hq, int hkv, float scale, Rope rq, Rope rk) {
  constexpr int NT = NG * 128;
  constexpr int SB = dkv_stage_bytes<NG>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int range_s[2];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [BT][LDS]
  __nv_bfloat16* v_s = k_s + BT * LDS;
  unsigned char* ring = smem + 2 * BT * LDS * 2;
  float* tcos = reinterpret_cast<float*>(ring + DKV_STAGES * SB);  // kRope: [BT][PMAX]
  float* tsin = tcos + BT * PMAX;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int grp = warp >> 2;       // warp group: head grp of each unit's NG heads
  const int r0 = (warp & 3) * 16;  // this warp's kv rows in the tile: r0 + g, r0 + g + 8
  const int k0 = blockIdx.x * BT;
  const int k1 = min(k0 + BT, Sk);
  const int hk = blockIdx.y;
  const int rep = hq / hkv, chunks = rep / NG;
  const int ldq = hq * D, ldk = hkv * D;

  issue_rows<NT, BT, 1>(k_s, k, k0, Sk, ldk, hk * D, tid);
  issue_rows<NT, BT, 1>(v_s, v, k0, Sk, ldk, hk * D, tid);
  if constexpr (kRope) issue_tables<NT, BT>(tcos, tsin, k0, Sk, rk, tid);
  cp_async_commit();
  const int row0 = k0 + r0 + g, row1 = row0 + 8;
  const int sk0 = row0 < Sk ? remap(seg_k[row0]) : NO_ROW_K;
  const int sk1 = row1 < Sk ? remap(seg_k[row1]) : NO_ROW_K;
  segment_interval_warps(seg_k, seg_q, k0, k1, S, range_s);
  const int lo = range_s[0], hi = range_s[1];
  // units: q tile outer, chunk of NG heads inner (one chunk unless Hq/Hkv > 4)
  const int nunits = (hi - lo + BT - 1) / BT * chunks;

  // unit u into stage u % DKV_STAGES; always one commit
  auto issue_unit = [&](int u) {
    if (u < nunits) {
      const DkvStage st = dkv_stage<NG>(ring + (u % DKV_STAGES) * SB);
      const int qs0 = lo + (u / chunks) * BT;
      const int h0 = hk * rep + (u % chunks) * NG;
      issue_rows<NT, BT, NG>(st.q, q, qs0, hi, ldq, h0 * D, tid);
      issue_rows<NT, BT, NG>(st.dO, dout, qs0, hi, ldq, h0 * D, tid);
      if (tid < NG * BT) {
        const int hh = tid / BT, r = tid % BT;
        const bool ok = qs0 + r < hi;
        const size_t off = ok ? (size_t)(qs0 + r) * hq + h0 + hh : 0;
        cp_async4(&st.lse[tid], lse + off, ok);
        cp_async4(&st.delta[tid], delta + off, ok);
      }
      if (tid < BT && qs0 + tid < hi) cp_async4(&st.ids[tid], seg_q + qs0 + tid, true);
    }
    cp_async_commit();
  };
  // kRope: unit u's q table rows into the one table buffer; one commit
  auto issue_tab = [&](int u) {
    if constexpr (kRope) {
      if (u < nunits) issue_tables<NT, BT>(tcos, tsin, lo + (u / chunks) * BT, hi, rq, tid);
      cp_async_commit();
    }
  };
  // finish this thread's copies of unit u, once they have landed: rotate its
  // Q chunks, remap its id; a barrier then publishes the whole unit
  auto prep = [&](int u) {
    if (u < nunits) {
      const DkvStage st = dkv_stage<NG>(ring + (u % DKV_STAGES) * SB);
      const int qs0 = lo + (u / chunks) * BT;
      if constexpr (kRope) rotate_own<NT, BT, NG>(st.q, qs0, hi, tcos, tsin, rq.P, tid);
      if (tid < BT) st.ids[tid] = qs0 + tid < hi ? remap(st.ids[tid]) : NO_ROW_Q;
    }
  };

  issue_unit(0);
  if constexpr (kRope) {
    cp_async_wait<1>();  // K, V and k's table rows
    rotate_own<NT, BT, 1>(k_s, k0, Sk, tcos, tsin, rk.P, tid);
    issue_tab(0);
  }
  cp_async_wait<0>();
  prep(0);

  float dka[8][4], dva[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
    dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;
  }

  // passes of CP q columns: n-tiles NTP * hp .. + NTP - 1, k steps KSP * hp ..
  // + KSP - 1 of the products over q; a thread holds the two f32
  // accumulators and one pass's P^T and dP^T
  constexpr int NPASS = 4, CP = 64 / NPASS, NTP = CP / 8, KSP = CP / 16;
  constexpr float L2E = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  const float sl2 = scale * L2E;
  for (int u = 0; u < nunits; ++u) {
    // unit u is whole and prepared; the other stage and this thread's table
    // entries are free
    __syncthreads();
    issue_tab(u + 1);
    issue_unit(u + 1);
    const DkvStage st = dkv_stage<NG>(ring + (u % DKV_STAGES) * SB);
    const __nv_bfloat16* qs = st.q + grp * BT * LDS;
    const __nv_bfloat16* dos = st.dO + grp * BT * LDS;
    const float* lse_s = st.lse + grp * BT;
    const float* delta_s = st.delta + grp * BT;

#pragma unroll 1
    for (int hp = 0; hp < NPASS; ++hp) {
      float p[NTP][4], dp[NTP][4];
      uint32_t fa[KSP][4];
#pragma unroll
      for (int n = 0; n < NTP; ++n) {
        p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int kk2 = 0; kk2 < 2; ++kk2) {  // S^T = K Q^T: kv rows x q columns
        uint32_t ka[2][4];
        ldsm_x4(ka[0], &k_s[(r0 + (lane & 15)) * LDS + kk2 * 32 + (lane >> 4) * 8]);
        ldsm_x4(ka[1], &k_s[(r0 + (lane & 15)) * LDS + kk2 * 32 + 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int n = 0; n < NTP; ++n) {
          uint32_t b[4];
          ldsm_x4(b, &qs[((hp * NTP + n) * 8 + (lane & 7)) * LDS + kk2 * 32 + (lane >> 3) * 8]);
          mma_bf16(p[n], ka[0], b);
          mma_bf16(p[n], ka[1], b + 2);
        }
      }
      // p = exp(s - lse) as 2^(s log2e - lse log2e); the q ids are
      // non-decreasing, so a kv row whose id is the tile's first and last
      // q row's sees no masked column here, and needs no compares
      const bool all = st.ids[0] == st.ids[BT - 1] && st.ids[0] == sk0 && sk0 == sk1;
#pragma unroll
      for (int n = 0; n < NTP; ++n) {
        const int c0 = (hp * NTP + n) * 8 + t2, c1 = c0 + 1;
        const float la = lse_s[c0] * L2E, lb = lse_s[c1] * L2E;
        p[n][0] = fast_exp2(fmaf(p[n][0], sl2, -la));
        p[n][1] = fast_exp2(fmaf(p[n][1], sl2, -lb));
        p[n][2] = fast_exp2(fmaf(p[n][2], sl2, -la));
        p[n][3] = fast_exp2(fmaf(p[n][3], sl2, -lb));
        if (!all) {
          const int sqa = st.ids[c0], sqb = st.ids[c1];
          if (sk0 != sqa) p[n][0] = 0.f;
          if (sk0 != sqb) p[n][1] = 0.f;
          if (sk1 != sqa) p[n][2] = 0.f;
          if (sk1 != sqb) p[n][3] = 0.f;
        }
        fa[n >> 1][(n & 1) * 2 + 0] = pack_bf16(p[n][0], p[n][1]);  // bf16(P^T)
        fa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[n][2], p[n][3]);
      }
#pragma unroll
      for (int j = 0; j < KSP; ++j) {  // dV += P^T dO
#pragma unroll
        for (int dt2 = 0; dt2 < 4; ++dt2) {
          uint32_t b[4];
          ldsm_x4_t(b, &dos[((hp * KSP + j) * 16 + (lane & 15)) * LDS + dt2 * 16 + (lane >> 4) * 8]);
          mma_bf16(dva[2 * dt2], fa[j], b);
          mma_bf16(dva[2 * dt2 + 1], fa[j], b + 2);
        }
      }
#pragma unroll
      for (int kk2 = 0; kk2 < 2; ++kk2) {  // dP^T = V dO^T
        uint32_t va[2][4];
        ldsm_x4(va[0], &v_s[(r0 + (lane & 15)) * LDS + kk2 * 32 + (lane >> 4) * 8]);
        ldsm_x4(va[1], &v_s[(r0 + (lane & 15)) * LDS + kk2 * 32 + 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int n = 0; n < NTP; ++n) {
          uint32_t b[4];
          ldsm_x4(b, &dos[((hp * NTP + n) * 8 + (lane & 7)) * LDS + kk2 * 32 + (lane >> 3) * 8]);
          mma_bf16(dp[n], va[0], b);
          mma_bf16(dp[n], va[1], b + 2);
        }
      }
#pragma unroll
      for (int n = 0; n < NTP; ++n) {  // dS^T, then bf16(dS^T)
        const int c0 = (hp * NTP + n) * 8 + t2;
        const float da = delta_s[c0], db = delta_s[c0 + 1];
        const float d0 = p[n][0] * (dp[n][0] - da) * scale;
        const float d1 = p[n][1] * (dp[n][1] - db) * scale;
        const float d2 = p[n][2] * (dp[n][2] - da) * scale;
        const float d3 = p[n][3] * (dp[n][3] - db) * scale;
        fa[n >> 1][(n & 1) * 2 + 0] = pack_bf16(d0, d1);
        fa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(d2, d3);
      }
#pragma unroll
      for (int j = 0; j < KSP; ++j) {  // dK += dS^T Q
#pragma unroll
        for (int dt2 = 0; dt2 < 4; ++dt2) {
          uint32_t b[4];
          ldsm_x4_t(b, &qs[((hp * KSP + j) * 16 + (lane & 15)) * LDS + dt2 * 16 + (lane >> 4) * 8]);
          mma_bf16(dka[2 * dt2], fa[j], b);
          mma_bf16(dka[2 * dt2 + 1], fa[j], b + 2);
        }
      }
    }

    cp_async_wait<0>();  // unit u + 1 and its table rows (issued this iteration)
    prep(u + 1);
  }

  // the group's sum, in a fixed order: groups 1..NG-1 leave their partial
  // f32 sums in the (now idle) ring, group 0 adds them in turn, then rounds
  // once; no atomics, so two launches give the same bits
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [NG - 1][4 warps][64 values][32 lanes]
  if (grp > 0) {
    float* mine = red + ((grp - 1) * 4 + (warp & 3)) * 64 * 32 + lane;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mine[(dt * 4 + i) * 32] = dka[dt][i];
        mine[(32 + dt * 4 + i) * 32] = dva[dt][i];
      }
  }
  __syncthreads();
  if (grp > 0) return;
  for (int gg = 1; gg < NG; ++gg) {
    const float* part = red + ((gg - 1) * 4 + warp) * 64 * 32 + lane;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dka[dt][i] += part[(dt * 4 + i) * 32];
        dva[dt][i] += part[(32 + dt * 4 + i) * 32];
      }
  }

  if constexpr (kRope) {  // back to the raw k; dv is unrotated
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      if (row0 < Sk) inv_rot_acc(dka[dt][0], dka[dt][1], rk, row0, dt * 4 + (t2 >> 1));
      if (row1 < Sk) inv_rot_acc(dka[dt][2], dka[dt][3], rk, row1, dt * 4 + (t2 >> 1));
    }
  }
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = hk * D + dt * 8 + t2;
    if (row0 < Sk) {
      *reinterpret_cast<uint32_t*>(dk + (size_t)row0 * ldk + col) = pack_bf16(dka[dt][0], dka[dt][1]);
      *reinterpret_cast<uint32_t*>(dv + (size_t)row0 * ldk + col) = pack_bf16(dva[dt][0], dva[dt][1]);
    }
    if (row1 < Sk) {
      *reinterpret_cast<uint32_t*>(dk + (size_t)row1 * ldk + col) = pack_bf16(dka[dt][2], dka[dt][3]);
      *reinterpret_cast<uint32_t*>(dv + (size_t)row1 * ldk + col) = pack_bf16(dva[dt][2], dva[dt][3]);
    }
  }
}

template <bool kRope, int NG>
int launch_dkv_pipe(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                    const int* seg_q, const int* seg_k, const __nv_bfloat16* dout,
                    const float* lse, const float* delta, __nv_bfloat16* dk, __nv_bfloat16* dv,
                    int S, int Sk, int hq, int hkv, float scale, Rope rq, Rope rk,
                    cudaStream_t st) {
  constexpr int smem = dkv_smem_bytes<kRope, NG>();
  static_assert((NG - 1) * 4 * 64 * 32 * 4 <= DKV_STAGES * dkv_stage_bytes<NG>(),
                "the partial sums must fit in the ring");
  auto kern = bwd_dkv_pipe<kRope, NG>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3((Sk + BT - 1) / BT, hkv), NG * 128, smem, st>>>(
      q, k, v, seg_q, seg_k, dout, lse, delta, dk, dv, S, Sk, hq, hkv, scale, rq, rk);
  return static_cast<int>(cudaGetLastError());
}

// warp groups a CTA runs: the largest of 4, 3, 2 that divides the group, else 1
template <bool kRope>
int launch_dkv_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                    const int* seg_q, const int* seg_k, const __nv_bfloat16* dout,
                    const float* lse, const float* delta, __nv_bfloat16* dk, __nv_bfloat16* dv,
                    int S, int Sk, int hq, int hkv, float scale, Rope rq, Rope rk,
                    cudaStream_t st) {
  const int rep = hq / hkv;
  if (rep % 4 == 0)
    return launch_dkv_pipe<kRope, 4>(q, k, v, seg_q, seg_k, dout, lse, delta, dk, dv, S, Sk, hq,
                                     hkv, scale, rq, rk, st);
  if (rep % 3 == 0)
    return launch_dkv_pipe<kRope, 3>(q, k, v, seg_q, seg_k, dout, lse, delta, dk, dv, S, Sk, hq,
                                     hkv, scale, rq, rk, st);
  if (rep % 2 == 0)
    return launch_dkv_pipe<kRope, 2>(q, k, v, seg_q, seg_k, dout, lse, delta, dk, dv, S, Sk, hq,
                                     hkv, scale, rq, rk, st);
  return launch_dkv_pipe<kRope, 1>(q, k, v, seg_q, seg_k, dout, lse, delta, dk, dv, S, Sk, hq,
                                   hkv, scale, rq, rk, st);
}

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
    bwd_dq_bf16<kRope><<<dim3((S + BT - 1) / BT, hq), NT_BF16, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg_q, seg_k,
        static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dq), S, Sk, hq, hkv, scale, rq, rk);
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
