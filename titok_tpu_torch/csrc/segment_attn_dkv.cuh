// The pipelined dk/dv kernels of the segment attention, bf16
// (`bwd_dkv_pipe`) and f32 (`bwd_dkv_f32_pipe`), shared by the row 2
// backward (flash_segment_attn_bwd.cu: plain and kRope instantiations,
// dk/dv summed over each GQA group in f32) and the v1 backward
// (flash_segment_attn_v1.cu). In bf16 v1 is the kV1 instantiation, each q
// head's dk/dv rounded to bf16 before the group sum, as v1 computes it; in
// f32 it is the plain instantiation on one id vector. The bf16 design is
// described in flash_segment_attn_bwd.cu, what kV1 changes at
// `bwd_dkv_pipe`, and the f32 design at `bwd_dkv_f32_pipe` below.
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

// ---------------------------------------------------------------------------
// f32 dk/dv: fp32 FMA, register-blocked; one CTA per (KV-row kv tile, kv
// head), NG warp groups over the group's q heads, a cp.async ring of
// (32-row q tile, NG heads) units
// ---------------------------------------------------------------------------
//
// `bwd_dkv_f32_pipe<kRope, NG, RT, STAGES, MINB, KV>`: the f32 dk/dv of rows
// 2 and 4 (flash_segment_attn_bwd.cu, both entries with is_bf16 = 0) and of
// v1 (flash_segment_attn_v1.cu, the plain instantiation on one id vector).
// In f32 v1 rounds no head before the group sum, so its dk/dv is row 2's
// group-summed function and gets row 2's bits. IEEE fp32
// FMA, no TF32 and no tensor cores, expf. What bounds it: the four products
// (S^T, dP^T, dV, dK) at the 67 TFLOP/s FMA peak (large 16/4: 21.1 GFLOP of
// live work, 0.315 ms). As in the f32 forward (segment_attn_fwd.cuh),
// the FFMAs take their operands from shared memory at 128 bytes a clock and
// a warp's float4 load is 4 wavefronts. Wavefronts per FFMA of each product
// loop, warp-wide:
// - S^T = K Q^T and dP^T = V dO^T (RT kv rows x 4 q columns a lane), a step
//   of 4 d: 4 float4 of Q (or dO) and RT of K (or V): 48 for 128 FFMA at
//   RT 8, 3/8; 32 for 64 at RT 4, 1/2;
// - dV += P^T dO and dK += dS^T Q (RT kv rows x 8 d columns), a step of 4 q:
//   RT float4 of P^T (or dS^T) and 8 of dO (or Q): 64 for 256 FFMA at RT 8,
//   1/4; 48 for 128 at RT 4, 3/8;
// - the previous kernel: 8 scalar loads per 8 FFMA in S^T and dP^T, 12 per
//   16 in dV and dK: 1, 3/4.
// What the design does:
// - NG warp groups, one head of the GQA group each, share the stationary K
//   and V of the CTA's kv tile; units of (32 q rows, NG heads) come through a
//   ring of STAGES units by 16-byte cp.async (lse, delta, ids by 4-byte
//   copies), tiles XOR-swizzled as in the forward; one barrier a unit.
// - Lane (a, b) holds RT kv rows (a + 4 i) x 4 q columns (b + 8 j) of S^T
//   and dP^T, and the same rows x 8 d columns of dK and dV; P^T, then dS^T,
//   go through a 4-byte-a-lane buffer of the warp's own rows (P^T read back
//   by its writer for dS^T), so only warp barriers sit between the
//   products.
// - The group's dK and dV: groups 1..NG-1 leave their sums in the idle
//   ring, group 0 adds them in a fixed order and writes each once; no
//   atomics, so two launches give the same bits. Where the group has more
//   heads than NG (8/1: 4 groups), units walk the heads in chunks of NG
//   (q tile outer), and group g adds heads g, g + NG, ... into its sums.
// - Choices by group size: 4 groups at 16/4 (RT 8, 8 x 8 blocks of dK and
//   dV, 256 threads, 64-row kv tiles, 2 stages, 255 registers); 3 at 12/4
//   (RT 4, 384 threads); 2 at 4/2 (RT 4, 32-row kv tiles, 1 stage, 128
//   threads, three CTAs an SM: 384 CTAs in one wave); 1 (RT 4, 64 rows, 2
//   stages, two CTAs an SM).
// - Heaviest kv tiles first (`lpt_item`), as the forward.
// - RoPE: K rotated once per CTA, each unit's Q once for all NG heads, in
//   shared memory after the copy lands (table entries read into registers
//   first); dK gets the inverse rotation in the lane that holds both
//   columns of each pair, before its one write.
// Not reached: 1/4 in S^T and dP^T (8 q columns a lane needs 64-row units:
// 128 KB a stage at 4 groups) and at RT 4.

constexpr int FDKV_QU = 32;  // q rows per unit

// Bytes of one ring stage: the Q and dO tiles of NG heads, their lse and
// delta, and the q ids; a multiple of 1 KB, so every stage keeps the base's
// 256-byte alignment.
template <int NG>
__host__ __device__ constexpr int dkv_f32_stage_bytes() {
  return (NG * 2 * FDKV_QU * D * 4 + NG * 2 * FDKV_QU * 4 + FDKV_QU * 4 + 1023) / 1024 * 1024;
}

// Dynamic shared memory: K and V, each warp's P^T / dS^T rows, a ring of
// STAGES units, and 256 bytes to align the base.
template <int NG, int STAGES, int KV>
__host__ __device__ constexpr int dkv_f32_smem_bytes() {
  return 2 * KV * D * 4 + NG * KV * FDKV_QU * 4 + STAGES * dkv_f32_stage_bytes<NG>() + 256;
}

// Warp group g (KV / 4 RT warps) takes q head g of each unit's NG heads.
// Lane (a, b) = (lane / 8, lane % 8) of the group's warp w owns kv rows
// 4 RT w + a + 4 i (i < RT) of the tile, q columns b + 8 j (j < 4) of S^T
// and dP^T, and d columns 4 b .. 4 b + 3, 32 + 4 b .. 32 + 4 b + 3 of dK and
// dV. The ring holds STAGES units: with 2, unit u + 1 is in flight while u is
// computed; with 1, it goes in after u (the other CTAs of the SM cover the
// copy). MINB CTAs an SM.
template <bool kRope, int NG, int RT, int STAGES, int MINB, int KV>
__global__ void __launch_bounds__(NG * KV / 4 / RT * 32, MINB)
bwd_dkv_f32_pipe(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_k, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int S, int Sk, int hq, int hkv,
                 float scale, Rope rq, Rope rk) {
  constexpr int WPG = KV / 4 / RT;  // warps a group
  constexpr int NT = NG * WPG * 32;
  constexpr int WR = 4 * RT;        // kv rows a warp
  constexpr int SB = dkv_f32_stage_bytes<NG>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ int range_s[2];
  unsigned char* smem = smem_raw + ((256 - (smem_u32(smem_raw) & 255)) & 255);
  float* k_s = reinterpret_cast<float*>(smem);  // [KV][D], swizzled
  float* v_s = k_s + KV * D;
  float* buf = v_s + KV * D;                   // [NG * WPG warps][WR][FDKV_QU], swizzled
  unsigned char* ring = reinterpret_cast<unsigned char*>(buf + NG * KV * FDKV_QU);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int a = lane >> 3, b = lane & 7;
  const int grp = warp / WPG;              // head grp of each unit's NG heads
  const int r0 = (warp % WPG) * WR + a;    // this lane's kv rows r0 + 4 i of the tile
  const int2 item = lpt_item(seg_k, Sk, KV, MINB, reinterpret_cast<int*>(ring));
  const int k0 = item.x * KV;
  const int k1 = min(k0 + KV, Sk);
  const int hk = item.y;
  const int rep = hq / hkv, chunks = rep / NG;
  const int ldq = hq * D, ldk = hkv * D;

  issue_rows_f32<NT, KV, 1>(k_s, k, k0, Sk, ldk, hk * D, tid);
  issue_rows_f32<NT, KV, 1>(v_s, v, k0, Sk, ldk, hk * D, tid);
  cp_async_commit();
  int sk[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = k0 + r0 + 4 * i;
    sk[i] = row < Sk ? remap(seg_k[row]) : NO_ROW_K;
  }
  segment_interval_warps(seg_k, seg_q, k0, k1, S, range_s);
  const int lo = range_s[0], hi = range_s[1];
  const int nunits = (hi - lo + FDKV_QU - 1) / FDKV_QU * chunks;  // q tile outer, NG heads inner
  auto unit_q0 = [&](int u) { return lo + u / chunks * FDKV_QU; };
  auto unit_h0 = [&](int u) { return hk * rep + u % chunks * NG; };
  auto stage_q = [&](int u) { return reinterpret_cast<float*>(ring + (u % STAGES) * SB); };

  // unit u into stage u % STAGES: Q, dO [NG][FDKV_QU][D], lse, delta
  // [NG][FDKV_QU], ids [FDKV_QU]; always one commit
  auto issue_unit = [&](int u) {
    if (u < nunits) {
      float* qs = stage_q(u);
      const int qs0 = unit_q0(u), h0 = unit_h0(u);
      issue_rows_f32<NT, FDKV_QU, NG>(qs, q, qs0, hi, ldq, h0 * D, tid);
      issue_rows_f32<NT, FDKV_QU, NG>(qs + NG * FDKV_QU * D, dout, qs0, hi, ldq, h0 * D, tid);
      float* ls = qs + 2 * NG * FDKV_QU * D;
      if (tid < NG * FDKV_QU) {
        const int hh = tid / FDKV_QU, r = tid % FDKV_QU;
        const bool ok = qs0 + r < hi;
        const size_t off = ok ? (size_t)(qs0 + r) * hq + h0 + hh : 0;
        cp_async4(&ls[tid], lse + off, ok);
        cp_async4(&ls[NG * FDKV_QU + tid], delta + off, ok);
      }
      int* ids = reinterpret_cast<int*>(ls + 2 * NG * FDKV_QU);
      if (tid < FDKV_QU && qs0 + tid < hi) cp_async4(&ids[tid], seg_q + qs0 + tid, true);
    }
    cp_async_commit();
  };
  // wait for this thread's copies of unit u (all it has issued), then finish
  // them: rotate its Q chunks, remap its id; a barrier then publishes the
  // whole unit
  auto prep = [&](int u) {
    auto landed = [] { cp_async_wait<0>(); };
    if (u < nunits) {
      float* qs = stage_q(u);
      const int qs0 = unit_q0(u);
      if constexpr (kRope) rotate_own_f32<NT, FDKV_QU, NG>(qs, qs0, hi, rq, tid, landed);
      else landed();
      int* ids = reinterpret_cast<int*>(qs + 2 * NG * FDKV_QU * D + 2 * NG * FDKV_QU);
      if (tid < FDKV_QU) ids[tid] = qs0 + tid < hi ? remap(ids[tid]) : NO_ROW_Q;
    } else {
      landed();
    }
  };

  issue_unit(0);
  if constexpr (kRope) rotate_own_f32<NT, KV, 1>(k_s, k0, Sk, rk, tid, [] { cp_async_wait<1>(); });
  prep(0);

  // Shared addresses (bytes). K (and V) row r0 + 4 i, chunk c: row r0 + 4 i
  // has low bits a + 4 (i & 1), so the chunk sits at (ka[i & 1] ^ (c << 4)) +
  // 1024 i. The warp's P^T rows a + 4 i (128 bytes each) at (pa[i & 1] ^
  // (qc << 4)) + 512 i; this lane's column b + 8 j of row a + 4 i at
  // (pst[i & 1] ^ (j << 5)) + 512 i.
  const uint32_t krow = smem_u32(k_s) + r0 * 256 + (a << 4);
  const uint32_t ka[2] = {krow, krow ^ 64};
  constexpr uint32_t VOFF = KV * D * 4;
  const uint32_t prow = smem_u32(buf) + warp * WR * FDKV_QU * 4 + a * 128 + (a << 4);
  const uint32_t pa[2] = {prow, prow ^ 64};
  const uint32_t pst[2] = {(pa[0] ^ ((b >> 2) << 4)) + ((b & 3) << 2),
                           (pa[1] ^ ((b >> 2) << 4)) + ((b & 3) << 2)};

  float dka[RT][8], dva[RT][8];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dka[i][j] = dva[i][j] = 0.f;

  // A B^T over d: rows r0 + 4 i of the stationary tile at offset `off` (K
  // or V) against q rows b + 8 j of the unit's tile at qb; d ascending. Each
  // step of 4 d: 4 float4 of the unit (held), RT of the tile, 16 RT FFMA
  auto rows_dot = [&](float (*t)[4], uint32_t off, uint32_t qb) {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) t[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < 16; ++c) {
      const uint32_t c4 = c << 4;
      float4 qv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) qv[j] = lds128((qb ^ c4) + 2048 * j);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float4 kv = lds128(((ka[i & 1] ^ c4) + off) + 1024 * i);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          t[i][j] = fmaf(kv.x, qv[j].x, t[i][j]);
          t[i][j] = fmaf(kv.y, qv[j].y, t[i][j]);
          t[i][j] = fmaf(kv.z, qv[j].z, t[i][j]);
          t[i][j] = fmaf(kv.w, qv[j].w, t[i][j]);
        }
      }
    }
  };
  // acc += (the warp's P^T or dS^T rows) times the unit's rows at xb (dO or
  // Q, chunks b and 8 + b): q ascending. Each step of 4 q: RT float4 of the
  // buffer, 8 of the unit, 32 RT FFMA
  auto rows_update = [&](float (*acc)[8], uint32_t xb) {
#pragma unroll 1
    for (int q2 = 0; q2 < FDKV_QU / 4; q2 += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qc = q2 + h;
        float4 pv[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) pv[i] = lds128((pa[i & 1] ^ (qc << 4)) + 512 * i);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const uint32_t xa = ((xb + 1024 * qc) ^ ((4 * h + x) << 4)) + 256 * x;
          const float4 x0 = lds128(xa), x1 = lds128(xa + 128);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const float p = x == 0 ? pv[i].x : x == 1 ? pv[i].y : x == 2 ? pv[i].z : pv[i].w;
            acc[i][0] = fmaf(p, x0.x, acc[i][0]);
            acc[i][1] = fmaf(p, x0.y, acc[i][1]);
            acc[i][2] = fmaf(p, x0.z, acc[i][2]);
            acc[i][3] = fmaf(p, x0.w, acc[i][3]);
            acc[i][4] = fmaf(p, x1.x, acc[i][4]);
            acc[i][5] = fmaf(p, x1.y, acc[i][5]);
            acc[i][6] = fmaf(p, x1.z, acc[i][6]);
            acc[i][7] = fmaf(p, x1.w, acc[i][7]);
          }
        }
      }
    }
  };

  for (int u = 0; u < nunits; ++u) {
    // unit u is whole and prepared; the other stage, this thread's table
    // entries and the warps' P^T rows are free
    __syncthreads();
    if constexpr (STAGES == 2) issue_unit(u + 1);
    const float* st = stage_q(u);
    const float* lse_s = st + 2 * NG * FDKV_QU * D + grp * FDKV_QU;
    const float* delta_s = lse_s + NG * FDKV_QU;
    const int* ids = reinterpret_cast<const int*>(st + 2 * NG * FDKV_QU * D + 2 * NG * FDKV_QU);
    // the group's Q and dO rows b + 8 j, chunk c: (qb ^ (c << 4)) + 2048 j;
    // row r, chunks b and 8 + b: (qx ^ ((r & 7) << 4)) + 256 r, + 128
    const uint32_t qx = smem_u32(st) + grp * FDKV_QU * D * 4 + (b << 4);
    const uint32_t dx = qx + NG * FDKV_QU * D * 4;
    const uint32_t qb = qx + b * 256, db = dx + b * 256;
    int sq[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) sq[j] = ids[b + 8 * j];

    // S^T = K Q^T, then P^T = exp(s scale - lse), masked
    float t[RT][4];
    rows_dot(t, 0, qb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float lj = lse_s[b + 8 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float p = sk[i] == sq[j] ? expf(t[i][j] * scale - lj) : 0.f;
        sts32((pst[i & 1] ^ (j << 5)) + 512 * i, p);
      }
    }
    __syncwarp();
    rows_update(dva, dx);  // dV += P^T dO

    // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) scale, P^T read back
    // from this lane's own entries
    rows_dot(t, VOFF, db);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float dj = delta_s[b + 8 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float p = lds32((pst[i & 1] ^ (j << 5)) + 512 * i);
        t[i][j] = p * (t[i][j] - dj) * scale;
      }
    }
    __syncwarp();  // every lane is done reading P^T
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < RT; ++i) sts32((pst[i & 1] ^ (j << 5)) + 512 * i, t[i][j]);
    __syncwarp();
    rows_update(dka, qx);  // dK += dS^T Q

    if constexpr (STAGES == 1) {  // every thread is done with unit u
      __syncthreads();
      issue_unit(u + 1);
    }
    prep(u + 1);  // unit u + 1 was issued this iteration
  }

  // the group's sum, in a fixed order: groups 1..NG-1 leave their partial
  // sums in the (now idle) ring, group 0 adds them in turn; no atomics, so
  // two launches give the same bits
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [NG - 1][WPG warps][16 RT values][32 lanes]
  if (grp > 0) {
    float* mine = red + ((grp - 1) * WPG + warp % WPG) * 16 * RT * 32 + lane;
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mine[(i * 8 + j) * 32] = dka[i][j];
        mine[(8 * RT + i * 8 + j) * 32] = dva[i][j];
      }
  }
  __syncthreads();
  if (grp > 0) return;
  for (int gg = 1; gg < NG; ++gg) {
    const float* part = red + ((gg - 1) * WPG + warp) * 16 * RT * 32 + lane;
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dka[i][j] += part[(i * 8 + j) * 32];
        dva[i][j] += part[(8 * RT + i * 8 + j) * 32];
      }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = k0 + r0 + 4 * i;
    if (row >= Sk) continue;
    if constexpr (kRope) {  // back to the raw k: this lane holds both columns of each pair
#pragma unroll
      for (int j = 0; j < 8; j += 2)
        inv_rot_acc(dka[i][j], dka[i][j + 1], rk, row, (j < 4 ? 2 * b : 16 + 2 * b) + (j & 3) / 2);
    }
    float* kd = dk + (size_t)row * ldk + hk * D + 4 * b;
    float* vd = dv + (size_t)row * ldk + hk * D + 4 * b;
    *reinterpret_cast<float4*>(kd) = make_float4(dka[i][0], dka[i][1], dka[i][2], dka[i][3]);
    *reinterpret_cast<float4*>(kd + 32) = make_float4(dka[i][4], dka[i][5], dka[i][6], dka[i][7]);
    *reinterpret_cast<float4*>(vd) = make_float4(dva[i][0], dva[i][1], dva[i][2], dva[i][3]);
    *reinterpret_cast<float4*>(vd + 32) = make_float4(dva[i][4], dva[i][5], dva[i][6], dva[i][7]);
  }
}

// Launches, or with `describe` fills describe[0..7] (`describe_kernel`, then
// warp groups, kv rows a thread, kv rows a tile, ring stages) and launches
// nothing.
template <bool kRope, int NG, int RT, int STAGES, int MINB, int KV>
int launch_dkv_f32_pipe(const float* q, const float* k, const float* v, const int* seg_q,
                        const int* seg_k, const float* dout, const float* lse,
                        const float* delta, float* dk, float* dv, int S, int Sk, int hq, int hkv,
                        float scale, Rope rq, Rope rk, cudaStream_t st, int* describe) {
  static_assert((NG - 1) * 2 * KV * D * 4 <= STAGES * dkv_f32_stage_bytes<NG>(),
                "the partial sums must fit in the ring");
  constexpr int smem = dkv_f32_smem_bytes<NG, STAGES, KV>();
  constexpr int threads = NG * KV / 4 / RT * 32;
  auto kern = bwd_dkv_f32_pipe<kRope, NG, RT, STAGES, MINB, KV>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && MINB > 1)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (describe) {
    describe[4] = NG;
    describe[5] = RT;
    describe[6] = KV;
    describe[7] = STAGES;
    return describe_kernel(kern, threads, smem, describe);
  }
  kern<<<dim3((Sk + KV - 1) / KV, hkv), threads, smem, st>>>(
      q, k, v, seg_q, seg_k, dout, lse, delta, dk, dv, S, Sk, hq, hkv, scale, rq, rk);
  return static_cast<int>(cudaGetLastError());
}

// Warp groups a CTA: 4 where 4 divide the group (8 kv rows a thread, 8 x 8
// blocks of dK and dV, 64-row kv tiles, 256 threads, 2 stages, one CTA an
// SM); 3 where 3 do (4 rows, 64-row tiles, 384 threads, 2 stages); 2 where
// 2 do (4 rows, 32-row kv tiles, 128 threads, 1 stage, three CTAs an SM: at
// the bench shape, 4/2, its 384 CTAs fill the 396 slots in one wave, where
// 192 CTAs of 64 rows left a second wave); else 1 (4 rows, 64-row tiles,
// 2 stages, two CTAs an SM).
template <bool kRope>
int launch_dkv_f32(const float* q, const float* k, const float* v, const int* seg_q,
                   const int* seg_k, const float* dout, const float* lse, const float* delta,
                   float* dk, float* dv, int S, int Sk, int hq, int hkv, float scale, Rope rq,
                   Rope rk, cudaStream_t st, int* describe = nullptr) {
  const int rep = hq / hkv;
  if (rep % 4 == 0)
    return launch_dkv_f32_pipe<kRope, 4, 8, 2, 1, 64>(q, k, v, seg_q, seg_k, dout, lse, delta,
                                                      dk, dv, S, Sk, hq, hkv, scale, rq, rk, st,
                                                      describe);
  if (rep % 3 == 0)
    return launch_dkv_f32_pipe<kRope, 3, 4, 2, 1, 64>(q, k, v, seg_q, seg_k, dout, lse, delta,
                                                      dk, dv, S, Sk, hq, hkv, scale, rq, rk, st,
                                                      describe);
  if (rep % 2 == 0)
    return launch_dkv_f32_pipe<kRope, 2, 4, 1, 3, 32>(q, k, v, seg_q, seg_k, dout, lse, delta,
                                                      dk, dv, S, Sk, hq, hkv, scale, rq, rk, st,
                                                      describe);
  return launch_dkv_f32_pipe<kRope, 1, 4, 2, 2, 64>(q, k, v, seg_q, seg_k, dout, lse, delta, dk,
                                                    dv, S, Sk, hq, hkv, scale, rq, rk, st,
                                                    describe);
}

}  // namespace
