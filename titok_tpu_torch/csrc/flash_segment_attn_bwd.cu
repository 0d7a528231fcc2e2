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
// - Both kernels search the other side's ids for the exact interval of
//   their tile (two warps, 32 probes a step; the JAX `_overlap_ranges`) and
//   visit nothing else; tiles come through cp.async rings in dynamic shared
//   memory; operands are read by ldmatrix at each use; p = exp(s - lse) is
//   one ex2.approx of s scale log2(e) - lse log2(e); a tile whose first and
//   last ids are the rows' own id skips the compares (ids are
//   non-decreasing).
// - dq (`bwd_dq_pipe<kRope, HPC>`): one CTA per (64-row q tile, HPC q heads
//   of one GQA group), 4 warps a head, 16 q rows a warp:
//   - each staged K/V tile, its ids and (kRope) its table rows and rotation
//     serve HPC heads: the plain kernel takes 2 (two CTAs an SM), RoPE
//     DQ_ROPE_HPC = 4; then 3, 2, else 1 (HPC divides Hq/Hkv);
//   - Q and dO of the CTA's heads are staged once and read by ldmatrix.x4
//     (A of S = Q K^T and dP = dO V^T), K and V by ldmatrix.x4 (B of S, dP)
//     and K again by ldmatrix.x4.trans (B of dQ += bf16(dS) K); dS goes from
//     its accumulator to A fragments in registers;
//   - a ring of DQ_STAGES = 3 K/V tiles with two mbarriers a stage, `ready`
//     and `empty`, as in the forward: tile t + 2 is in flight while t is
//     computed, and a warp may run a tile ahead of the slowest;
//   - each tile in DQ_NPASS = 2 passes of 32 kv columns, so a thread holds
//     the f32 dq accumulator and one pass's S, dP and bf16(dS): no spills at
//     128 registers (256- and 512-thread CTAs; the plain instantiation runs
//     its passes rolled, as unrolled ptxas spilled 8-16 bytes of it);
//   - every CTA takes its q tile's kv tiles in ascending order and rounds
//     each dq element once, so both instantiations and every HPC give a
//     (row, head) the same arithmetic, and two launches the same bits.
// - dk/dv (`bwd_dkv_pipe`, in segment_attn_dkv.cuh, shared with the v1
//   backward): one CTA per (64-row kv tile, kv head). It walks the group's q
//   heads x the q tiles of its interval, so the work of a CTA is a long
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
//   - the group's dk/dv: groups 1..NG-1 leave their f32 partial sums in the
//     idle ring, group 0 adds them in a fixed order and rounds to bf16 once.
//     No atomics: two launches give the same bits.
// - bf16 on mma.sync m16n8k16 (bf16 in, fp32 accumulate). f32 on fp32 FMA
//   (no TF32: the f32 path must hold tight tolerances against the plain
//   version), 32-row tiles and 256 threads, K and V in registers.
// Not yet: an asynchronous wgmma pipeline and TMA (a synchronous wgmma
// dk/dv was no faster: PERF.md).
//
// RoPE fused (kRope = true; entries `flash_segment_attn_rope_bwd_dq` and
// `..._rope_bwd_dkv`): replaces `_bwd_dq_kernel_rope` and
// `_bwd_dkv_kernel_rope`, reached through `_rope_bwd`, the custom_vjp
// backward `_mh_rope` of attn_impl 'flash_rope'. q and k come in unrotated
// with their tables, as in the forward: the kernels rotate q and k tiles as
// they are staged (dq: q once per CTA for all HPC heads and each k tile
// once per CTA; dk/dv: k once per CTA and each q tile once per CTA for all
// NG heads; in place in shared memory by the thread that copied the chunk
// and its table entries, after its own cp.async wait), so p and ds
// are those of the rotated q and k. The rotation is orthogonal, so the grads of the raw q and k are
// the grads of the rotated ones rotated back: the f32 dq and dk
// accumulators get the inverse rotation (sin negated) before their one
// rounding to the output dtype. dv is unrotated. In the bf16 kernels a
// thread's m16n8 accumulator fragment holds both columns of a pair; in the
// f32 kernels the pair is split over lanes tx and tx ^ 1 and meets by a
// shuffle.

#include "segment_attn_dkv.cuh"

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
    return launch_dq_bf16<kRope>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg_q, seg_k,
        static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dq), S, Sk, hq, hkv, scale, rq, rk, st);
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
