// The pipelined bf16 dk/dv kernel of the segment attention, shared by the
// row 2 backward (flash_segment_attn_bwd.cu: plain and kRope
// instantiations, dk/dv summed over each GQA group in f32) and the v1
// backward (flash_segment_attn_v1.cu: kV1, each q head's dk/dv rounded to
// bf16 before the group sum, as v1 computes it). The design is described
// in flash_segment_attn_bwd.cu; what kV1 changes is described at
// `bwd_dkv_pipe`.
//
// Each source builds into its own library, so everything here has internal
// linkage.

#pragma once

#include "segment_attn_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 dk/dv: one CTA per (64-row kv tile, kv head), NG warp groups over the
// group's q heads, a cp.async ring of (q tile, NG heads) units
// ---------------------------------------------------------------------------

constexpr int DKV_STAGES = 2;  // units in the ring: u computed, u+1 in flight
// kV1 with Hq/Hkv > NG: the running f32 sum of the rounded heads,
// [4 warps][64 values][32 lanes]
constexpr int DKV_RUN_BYTES = 4 * 64 * 32 * 4;

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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// kV1: each q head's dk and dv are summed over q in f32 and rounded to bf16,
// then the group's rounded heads are added in f32 in head order and rounded
// once (v1's function: JAX's v1 sums its per-head outputs outside the
// kernel). A warp group then must not sum two heads in one accumulator, so
// kV1 walks the units heads outer: chunk of NG heads, then q tile. With one
// chunk (Hq/Hkv == NG) each group's sums are one head's, rounded before the
// group sum at the end. With more (Hq/Hkv > 4), the last unit of each chunk
// ends with a fold: the groups in turn round their sums and add them to a
// running f32 sum in shared memory (`run`, in head order), then start the
// next chunk from zero; group 0 writes the running sum at the end.
template <bool kRope, int NG, bool kV1 = false>
__global__ void __launch_bounds__(NG * 128, NG == 3 ? 1 : 4 / NG)
bwd_dkv_pipe(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q,
             const int* __restrict__ seg_k, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int Sk,
             int hq, int hkv, float scale, Rope rq, Rope rk) {
  static_assert(!(kRope && kV1), "v1 has no RoPE");
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
  const int ntq = (hi - lo + BT - 1) / BT;
  // units: q tile outer, chunk of NG heads inner (one chunk unless Hq/Hkv >
  // 4); kV1: chunk outer, q tile inner (no division with one chunk)
  const int nunits = ntq * chunks;
  auto unit_q0 = [&](int u) {
    return lo + (kV1 ? (chunks == 1 ? u : u % ntq) : u / chunks) * BT;
  };
  auto unit_h0 = [&](int u) {
    return hk * rep + (kV1 ? (chunks == 1 ? 0 : u / ntq) : u % chunks) * NG;
  };

  // unit u into stage u % DKV_STAGES; always one commit
  auto issue_unit = [&](int u) {
    if (u < nunits) {
      const DkvStage st = dkv_stage<NG>(ring + (u % DKV_STAGES) * SB);
      const int qs0 = unit_q0(u);
      const int h0 = unit_h0(u);
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
      if (u < nunits) issue_tables<NT, BT>(tcos, tsin, unit_q0(u), hi, rq, tid);
      cp_async_commit();
    }
  };
  // finish this thread's copies of unit u, once they have landed: rotate its
  // Q chunks, remap its id; a barrier then publishes the whole unit
  auto prep = [&](int u) {
    if (u < nunits) {
      const DkvStage st = dkv_stage<NG>(ring + (u % DKV_STAGES) * SB);
      const int qs0 = unit_q0(u);
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

    if constexpr (kV1) {
      if (chunks > 1 && (u + 1) % ntq == 0) {  // the chunk's heads are whole: fold them
        // the groups in turn (head order) round their sums and add them to
        // the running sum; the first chunk's first group starts it
        float* run = reinterpret_cast<float*>(ring + DKV_STAGES * SB) + (warp & 3) * 64 * 32 + lane;
        const bool first = u + 1 == ntq;
        for (int gg = 0; gg < NG; ++gg) {
          if (grp == gg) {
#pragma unroll
            for (int dt = 0; dt < 8; ++dt)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                float& sum_k = run[(dt * 4 + i) * 32];
                float& sum_v = run[(32 + dt * 4 + i) * 32];
                const float xk = round_bf16(dka[dt][i]), xv = round_bf16(dva[dt][i]);
                sum_k = first && gg == 0 ? xk : sum_k + xk;
                sum_v = first && gg == 0 ? xv : sum_v + xv;
                dka[dt][i] = dva[dt][i] = 0.f;
              }
          }
          __syncthreads();
        }
      }
    }

    cp_async_wait<0>();  // unit u + 1 and its table rows (issued this iteration)
    prep(u + 1);
  }

  // the group's sum, in a fixed order: groups 1..NG-1 leave their partial
  // f32 sums in the (now idle) ring, group 0 adds them in turn, then rounds
  // once; no atomics, so two launches give the same bits. kV1 with one
  // chunk: each group's sums (one head's) are rounded to bf16 first; with
  // more, group 0 takes the running sum that the folds left
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (kV1) {
    if (chunks > 1) {
      if (grp > 0) return;
      const float* run =
          reinterpret_cast<const float*>(ring + DKV_STAGES * SB) + warp * 64 * 32 + lane;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dka[dt][i] = nunits > 0 ? run[(dt * 4 + i) * 32] : 0.f;
          dva[dt][i] = nunits > 0 ? run[(32 + dt * 4 + i) * 32] : 0.f;
        }
    } else {
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dka[dt][i] = round_bf16(dka[dt][i]);
          dva[dt][i] = round_bf16(dva[dt][i]);
        }
    }
  }
  float* red = reinterpret_cast<float*>(ring);  // [NG - 1][4 warps][64 values][32 lanes]
  if (!kV1 || chunks == 1) {
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

template <bool kRope, int NG, bool kV1>
int launch_dkv_pipe(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                    const int* seg_q, const int* seg_k, const __nv_bfloat16* dout,
                    const float* lse, const float* delta, __nv_bfloat16* dk, __nv_bfloat16* dv,
                    int S, int Sk, int hq, int hkv, float scale, Rope rq, Rope rk,
                    cudaStream_t st) {
  static_assert((NG - 1) * 4 * 64 * 32 * 4 <= DKV_STAGES * dkv_stage_bytes<NG>(),
                "the partial sums must fit in the ring");
  const int smem = dkv_smem_bytes<kRope, NG>() + (kV1 && hq / hkv > NG ? DKV_RUN_BYTES : 0);
  auto kern = bwd_dkv_pipe<kRope, NG, kV1>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3((Sk + BT - 1) / BT, hkv), NG * 128, smem, st>>>(
      q, k, v, seg_q, seg_k, dout, lse, delta, dk, dv, S, Sk, hq, hkv, scale, rq, rk);
  return static_cast<int>(cudaGetLastError());
}

// warp groups a CTA runs: the largest of 4, 3, 2 that divides the group, else 1
template <bool kRope, bool kV1 = false>
int launch_dkv_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                    const int* seg_q, const int* seg_k, const __nv_bfloat16* dout,
                    const float* lse, const float* delta, __nv_bfloat16* dk, __nv_bfloat16* dv,
                    int S, int Sk, int hq, int hkv, float scale, Rope rq, Rope rk,
                    cudaStream_t st) {
  const int rep = hq / hkv;
  if (rep % 4 == 0)
    return launch_dkv_pipe<kRope, 4, kV1>(q, k, v, seg_q, seg_k, dout, lse, delta, dk, dv, S,
                                          Sk, hq, hkv, scale, rq, rk, st);
  if (rep % 3 == 0)
    return launch_dkv_pipe<kRope, 3, kV1>(q, k, v, seg_q, seg_k, dout, lse, delta, dk, dv, S,
                                          Sk, hq, hkv, scale, rq, rk, st);
  if (rep % 2 == 0)
    return launch_dkv_pipe<kRope, 2, kV1>(q, k, v, seg_q, seg_k, dout, lse, delta, dk, dv, S,
                                          Sk, hq, hkv, scale, rq, rk, st);
  return launch_dkv_pipe<kRope, 1, kV1>(q, k, v, seg_q, seg_k, dout, lse, delta, dk, dv, S, Sk,
                                        hq, hkv, scale, rq, rk, st);
}

}  // namespace
