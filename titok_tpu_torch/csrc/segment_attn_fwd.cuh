// The pipelined forward kernels of the segment attention, bf16
// (`fwd_bf16_pipe`) and f32 (`fwd_f32_pipe`), shared by the row 1 forward
// (flash_segment_attn_fwd.cu: plain and kRope instantiations) and the v1
// forward (flash_segment_attn_v1.cu). In bf16 v1 is the kV1 instantiation,
// whose kv tiles are the 64-row tiles of S aligned to row 0, as v1 computes
// it; in f32 it is the plain instantiation on one id vector. The bf16
// design is described in flash_segment_attn_fwd.cu, what kV1 changes at
// `fwd_bf16_pipe`, and the f32 design at `fwd_f32_pipe` below.
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

// ---------------------------------------------------------------------------
// f32: fp32 FMA, register-blocked, one K and one V buffer, one CTA per
// (64-row q tile, HPC q heads of one GQA group)
// ---------------------------------------------------------------------------
//
// `fwd_f32_pipe<kRope, HPC, RT, MINB>`: the f32 forward of rows 1 and 3
// (flash_segment_attn_fwd.cu, both entries with is_bf16 = 0) and of v1
// (flash_segment_attn_v1.cu, the plain instantiation on one id vector). In
// f32 v1 rounds nothing, so its forward is row 1's function and gets row
// 1's bits. IEEE fp32 FMA, one fmaf chain an entry, no TF32 and no tensor cores (the
// f32 gates allow 1e-5 on out and lse against the plain version); expf, not
// ex2.approx; p unrounded.
// What bounds it: the products at the 67 TFLOP/s FMA peak (large serving
// layout 16/4: 10.6 GFLOP of live work, 0.158 ms). An FFMA takes both its
// operands from shared memory, whose pipe hands the SM 128 bytes a clock
// (one wavefront) while its four FMA pipes take 128 FFMA a clock: a warp's
// float4 load is 4 wavefronts whether its lanes share addresses or not, so
// each loaded float must feed a thread's FFMAs several times. Counted
// warp-wide, shared-memory wavefronts per FFMA of each product loop:
// - 8 q rows a thread (RT 8, 8 x 8 blocks): S = Q K^T, a step of 4 d, 8
//   float4 of Q and 8 of K for 256 FFMA: 1/4; O += P V, a step of 4 kv
//   rows, 8 float4 of P and 8 of V for 256 FFMA: 1/4;
// - 4 q rows (RT 4, 4 x 8 blocks): 4 + 8 float4 for 128 FFMA: 3/8, both;
// - the previous kernel: one scalar load per FFMA or close (6 LDS per 8
//   FFMA in Q K^T, 8 per 16 in P V, on rows padded to 65 floats): 3/4, 1/2.
// What the design does:
// - Register blocks: lane (a, b) = (lane / 8, lane % 8) holds RT q rows
//   (a + 4 i) x 8 score columns (b + 8 j) and the same rows x 8 output
//   columns (4 b.., 32 + 4 b..), and reads float4s from tiles whose 16-byte
//   chunks are XOR-swizzled by the row's low bits (no `+1` padding): Q and
//   P rows a + 4 i, K rows b + 8 j and V rows by chunks b, 8 + b are each
//   free of bank conflicts. Addresses are 32-bit shared addresses, the
//   swizzle one XOR a load or group of loads.
// - K and V in one buffer each, filled by 16-byte cp.async, with two
//   mbarriers each, `full` and `free`: K(t + 1) goes in once every warp is
//   done with K(t) and lands during softmax(t) and P V(t); V(t + 1) once
//   every warp is done with V(t), landing during Q K^T(t + 1). One buffer
//   each, not a ring of both: the saved 32 KB is what lets three CTAs
//   share an SM below.
// - A GQA group's heads share each staged K/V tile and (kRope) its
//   rotation: HPC 4 at 16/4 (RT 8, 256 threads, one CTA an SM, 254
//   registers), HPC 3 at 12/4 (RT 4, 384 threads, 168 registers); at 4/2
//   and 1/1 one head a CTA (RT 4, 128 threads, three CTAs an SM). The q
//   tile is 64 rows whatever the choice, so every choice gives a (row, head)
//   the same bits.
// - kv tiles of 64 columns; a row's max over the lane's 8 columns, then 3
//   shuffles; the row sum kept per lane and reduced once at the end; the
//   column ids read from shared memory where they are compared.
// - Heaviest q tiles first (`lpt_item`): a q tile's kv interval is its
//   segments' length, 7 to 17 tiles at the base_vq layout; launched in
//   index order, CTAs of 17 tiles started in the second wave and set the
//   kernel's time.
// - RoPE: Q once per CTA and each K tile once per CTA rotated in shared
//   memory, by the thread that copied each chunk, after its copy lands: Q
//   and K(0) before the loop, K(t + 1) halfway through P V(t), where a warp
//   waiting for its table entries leaves the FMA pipes to the other warps
//   (at the top of the next tile every warp would wait at `kfull`). The
//   entries are read into registers, not staged (a 16 KB table buffer would
//   cost the third CTA an SM).
// Not reached: the 1/4 at RT 4 (8 x 8 blocks need 128 accumulators, 254
// registers: one CTA of 256 threads an SM; at 4/2 and 12/4 that left the
// card emptier than RT 4 does).

constexpr int FFQ = 64;  // q rows per CTA
constexpr int FFK = 64;  // kv rows per tile

// Dynamic shared memory: Q of the CTA's heads, each warp's P rows, one K
// tile, one V tile, two tiles' ids, and 256 bytes to align the base.
template <int HPC>
__host__ __device__ constexpr int fwd_f32_smem_bytes() {
  return HPC * FFQ * D * 4 + HPC * FFQ * FFK * 4 + 2 * FFK * D * 4 + 2 * FFK * 4 + 256;
}

// RT q rows a thread: 16 / RT warps a head, 4 RT rows a warp. Lane (a, b) =
// (lane / 8, lane % 8) of a head's warp w owns q rows 4 RT w + a + 4 i
// (i < RT) of the tile, score columns b + 8 j (j < 8) and output columns
// 4 b .. 4 b + 3, 32 + 4 b .. 32 + 4 b + 3. MINB CTAs an SM.
template <bool kRope, int HPC, int RT, int MINB>
__global__ void __launch_bounds__(HPC * 16 / RT * 32, MINB)
fwd_f32_pipe(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ seg_q,
             const int* __restrict__ seg_k, float* __restrict__ out, float* __restrict__ lse,
             int S, int Sk, int hq, int hkv, float scale, Rope rq, Rope rk) {
  constexpr int WPH = 16 / RT;  // warps a head
  constexpr int NT = HPC * WPH * 32;
  constexpr int WR = 4 * RT;    // q rows a warp
  extern __shared__ unsigned char smem_raw[];
  __shared__ int range_s[2];
  // K and V each have `full` (every thread has finished its copies of the
  // tile) and `free` (every thread is done computing on it)
  __shared__ uint64_t kfull, kfree, vfull, vfree;
  unsigned char* smem = smem_raw + ((256 - (smem_u32(smem_raw) & 255)) & 255);
  float* q_s = reinterpret_cast<float*>(smem);  // [HPC][FFQ][D], swizzled
  float* p_s = q_s + HPC * FFQ * D;             // [HPC * WPH warps][WR][FFK], swizzled
  float* k_s = p_s + HPC * FFQ * FFK;           // [FFK][D], swizzled
  float* v_s = k_s + FFK * D;
  int* ids2 = reinterpret_cast<int*>(v_s + FFK * D);  // [2][FFK]: tile t's at t & 1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int a = lane >> 3, b = lane & 7;
  const int2 item = lpt_item(seg_q, S, FFQ, MINB, reinterpret_cast<int*>(k_s));
  const int rep = hq / hkv, splits = rep / HPC;
  const int hk = item.y / splits;
  const int h0 = hk * rep + (item.y % splits) * HPC;  // the CTA's first q head
  const int hw = warp / WPH;                          // this warp's head, h0 + hw
  const int r0 = (warp % WPH) * WR + a;               // its rows r0 + 4 i
  const int q0 = item.x * FFQ;
  const int q1 = min(q0 + FFQ, S);
  const int ldq = hq * D, ldk = hkv * D;

  if (tid == 0) {
    mbar_init(&kfull, NT);
    mbar_init(&kfree, NT);
    mbar_init(&vfull, NT);
    mbar_init(&vfree, NT);
  }
  issue_rows_f32<NT, FFQ, HPC>(q_s, q, q0, S, ldq, h0 * D, tid);
  cp_async_commit();
  int sq[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + r0 + 4 * i;
    sq[i] = row < S ? remap(seg_q[row]) : NO_ROW_Q;
  }
  segment_interval_warps(seg_q, seg_k, q0, q1, Sk, range_s);  // its barrier also
  const int lo = range_s[0], hi = range_s[1];                  // publishes the inits
  const int ntiles = (hi - lo + FFK - 1) / FFK;

  // tile t's K and ids, or its V; each one commit, empty past the last tile
  auto issue_k = [&](int t) {
    if (t < ntiles) {
      const int kv0 = lo + t * FFK;
      issue_rows_f32<NT, FFK, 1>(k_s, k, kv0, hi, ldk, hk * D, tid);
      if (tid < FFK && kv0 + tid < hi) cp_async4(&ids2[(t & 1) * FFK + tid], seg_k + kv0 + tid, true);
    }
    cp_async_commit();
  };
  auto issue_v = [&](int t) {
    if (t < ntiles) issue_rows_f32<NT, FFK, 1>(v_s, v, lo + t * FFK, hi, ldk, hk * D, tid);
    cp_async_commit();
  };

  // Q (rotated once, for all HPC heads) while tile 0's K and V are in flight
  issue_k(0);
  issue_v(0);
  auto q_landed = [] { cp_async_wait<2>(); };
  if constexpr (kRope) rotate_own_f32<NT, FFQ, HPC>(q_s, q0, S, rq, tid, q_landed);
  else q_landed();
  __syncthreads();  // Q, rotated, is whole

  // Shared addresses (bytes). Q row r0 + 4 i, chunk c: row r0 + 4 i has low
  // bits a + 4 (i & 1), so the chunk sits at (qa[i & 1] ^ (c << 4)) + 1024 i.
  // The warp's P rows a + 4 i likewise; this lane's P column b + 8 j of row
  // a + 4 i at (pst[i & 1] ^ (j << 5)) + 1024 i.
  const uint32_t qrow = smem_u32(q_s) + hw * FFQ * D * 4 + r0 * 256 + (a << 4);
  const uint32_t qa[2] = {qrow, qrow ^ 64};
  const uint32_t prow = smem_u32(p_s) + warp * WR * FFK * 4 + a * 256 + (a << 4);
  const uint32_t pa[2] = {prow, prow ^ 64};
  const uint32_t pst[2] = {(pa[0] ^ ((b >> 2) << 4)) + ((b & 3) << 2),
                           (pa[1] ^ ((b >> 2) << 4)) + ((b & 3) << 2)};
  float m[RT], l[RT], o[RT][8];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;  // this lane's share of the row sum (its 8 columns of each tile)
#pragma unroll
    for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
  }

  // K row b + 8 j (low bits b), chunk c: (kb ^ (c << 4)) + 2048 j; V row c,
  // chunks b and 8 + b: (vb ^ ((c & 7) << 4)) + 256 c, + 128
  const uint32_t kb = smem_u32(k_s) + b * 256 + (b << 4);
  const uint32_t vb = smem_u32(v_s) + (b << 4);
  for (int t = 0; t < ntiles; ++t) {
    // this thread's copies of K(t) have landed (V(t) may be in flight):
    // finish them (kRope: tile 0's rotation, the later ones' happened
    // during P V(t - 1); remap its id), then wait for all
    auto k_landed = [t] {
      if (t == 0) cp_async_wait<1>(); else cp_async_wait<0>();
    };
    if (kRope && t == 0) rotate_own_f32<NT, FFK, 1>(k_s, lo, hi, rk, tid, k_landed);
    else k_landed();
    int* ids = ids2 + (t & 1) * FFK;  // tile t + 1's copies go to the other half
    if (tid < FFK) ids[tid] = lo + t * FFK + tid < hi ? remap(ids[tid]) : NO_ROW_K;
    mbar_arrive(&kfull);
    mbar_wait(&kfull, t & 1);

    // S = Q K^T: d ascending, one fmaf chain an entry. Each step of 4 d:
    // RT float4 of Q (one row each), 8 of K, 32 RT FFMA
    float s[RT][8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < 16; ++c) {
      const uint32_t c4 = c << 4;
      float4 qv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) qv[i] = lds128((qa[i & 1] ^ c4) + 1024 * i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = lds128((kb ^ c4) + 2048 * j);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }
    // this lane's column ids, read where they are used (not held across the
    // rows: registers are short); K(t + 1) writes the other half
    const uint32_t ids_b = smem_u32(ids) + 4 * b;
    mbar_arrive(&kfree);
    // V(t) goes in once every thread is done with V(t - 1) (the warps are
    // past their P V of tile t - 1 by now); it lands during the softmax
    if (t > 0) {
      mbar_wait(&vfree, (t - 1) & 1);
      issue_v(t);
    }

    // online softmax over the tile's 64 columns: a row's max over this
    // lane's 8 columns, then over its 8 lanes (3 shuffles); the sum stays
    // per lane until the end
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = sq[i] == lds32i(ids_b + 32 * j) ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      m[i] = mn;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = s[i][j] == NEG_INF ? 0.f : expf(s[i][j] - mn);
        ps += p;
        sts32((pst[i & 1] ^ (j << 5)) + 1024 * i, p);
      }
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] *= alpha;
    }
    // K(t + 1) goes in once every thread is done with K(t); it lands during
    // P V(t)
    mbar_wait(&kfree, t & 1);
    issue_k(t + 1);
    __syncwarp();
    // V(t) has landed once all but the newest group (K(t + 1)) have
    cp_async_wait<1>();
    mbar_arrive(&vfull);
    mbar_wait(&vfull, t & 1);

    // O += P V: kv rows ascending. Each step of 4 rows: RT float4 of P, 8 of
    // V, 32 RT FFMA
    auto pv_rows = [&](int c_begin, int c_end) {
#pragma unroll 1
      for (int c2 = c_begin; c2 < c_end; c2 += 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cc = c2 + h;
          float4 pv[RT];
#pragma unroll
          for (int i = 0; i < RT; ++i) pv[i] = lds128((pa[i & 1] ^ (cc << 4)) + 1024 * i);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const uint32_t va = ((vb + 1024 * cc) ^ ((4 * h + x) << 4)) + 256 * x;
            const float4 v0 = lds128(va), v1 = lds128(va + 128);
#pragma unroll
            for (int i = 0; i < RT; ++i) {
              const float p = x == 0 ? pv[i].x : x == 1 ? pv[i].y : x == 2 ? pv[i].z : pv[i].w;
              o[i][0] = fmaf(p, v0.x, o[i][0]);
              o[i][1] = fmaf(p, v0.y, o[i][1]);
              o[i][2] = fmaf(p, v0.z, o[i][2]);
              o[i][3] = fmaf(p, v0.w, o[i][3]);
              o[i][4] = fmaf(p, v1.x, o[i][4]);
              o[i][5] = fmaf(p, v1.y, o[i][5]);
              o[i][6] = fmaf(p, v1.z, o[i][6]);
              o[i][7] = fmaf(p, v1.w, o[i][7]);
            }
          }
        }
      }
    };
    pv_rows(0, 8);
    // kRope: this thread's chunks of K(t + 1) have landed by now (the only
    // group in flight); rotate them here, where a warp that waits for its
    // table entries leaves the FMA pipes to the others' P V, not at the
    // top of the next tile, where every warp waits at `kfull`
    if constexpr (kRope) {
      if (t + 1 < ntiles)
        rotate_own_f32<NT, FFK, 1>(k_s, lo + (t + 1) * FFK, hi, rk, tid, [] { cp_async_wait<0>(); });
    }
    pv_rows(8, 16);
    __syncwarp();  // the warp's P rows are free for the next tile
    mbar_arrive(&vfree);
  }
  cp_async_wait<0>();  // only empty groups can be left

  const int h = h0 + hw;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const int row = q0 + r0 + 4 * i;
    if (row >= S) continue;
    const float L = fmaxf(li, 1e-30f);
    float* dst = out + (size_t)row * ldq + h * D + 4 * b;
    *reinterpret_cast<float4*>(dst) =
        make_float4(o[i][0] / L, o[i][1] / L, o[i][2] / L, o[i][3] / L);
    *reinterpret_cast<float4*>(dst + 32) =
        make_float4(o[i][4] / L, o[i][5] / L, o[i][6] / L, o[i][7] / L);
    if (b == 0) lse[(size_t)row * hq + h] = m[i] + logf(L);
  }
}

// Launches, or with `describe` fills describe[0..7] (`describe_kernel`, then
// q heads a CTA, q rows a thread, kv rows a tile, 1 buffer each of K and V)
// and launches nothing.
template <bool kRope, int HPC, int RT, int MINB>
int launch_fwd_f32_pipe(const float* q, const float* k, const float* v, const int* seg_q,
                        const int* seg_k, float* out, float* lse, int S, int Sk, int hq, int hkv,
                        float scale, Rope rq, Rope rk, cudaStream_t st, int* describe) {
  constexpr int smem = fwd_f32_smem_bytes<HPC>();
  constexpr int threads = HPC * 16 / RT * 32;
  auto kern = fwd_f32_pipe<kRope, HPC, RT, MINB>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && MINB > 1)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (describe) {
    describe[4] = HPC;
    describe[5] = RT;
    describe[6] = FFK;
    describe[7] = 1;
    return describe_kernel(kern, threads, smem, describe);
  }
  const dim3 grid((S + FFQ - 1) / FFQ, hkv * (hq / hkv / HPC));
  kern<<<grid, threads, smem, st>>>(q, k, v, seg_q, seg_k, out, lse, S, Sk, hq, hkv, scale, rq,
                                    rk);
  return static_cast<int>(cudaGetLastError());
}

// q heads a CTA: 4 where 4 divide the group (8 q rows a thread, 8 x 8
// blocks, 256 threads, one CTA an SM); 3 where 3 do (4 rows, 384 threads);
// else 1 (4 rows, 128 threads, three CTAs an SM: at the bench shape, 4/2,
// its 384 CTAs fill the 396 slots in one wave, where 192 CTAs of 2 heads
// left a second wave). Every choice gives a (row, head) the same tiles and
// the same arithmetic, so the two instantiations, and any group size,
// agree bit for bit.
template <bool kRope>
int launch_fwd_f32(const float* q, const float* k, const float* v, const int* seg_q,
                   const int* seg_k, float* out, float* lse, int S, int Sk, int hq, int hkv,
                   float scale, Rope rq, Rope rk, cudaStream_t st, int* describe = nullptr) {
  const int rep = hq / hkv;
  if (rep % 4 == 0)
    return launch_fwd_f32_pipe<kRope, 4, 8, 1>(q, k, v, seg_q, seg_k, out, lse, S, Sk, hq, hkv,
                                               scale, rq, rk, st, describe);
  if (rep % 3 == 0)
    return launch_fwd_f32_pipe<kRope, 3, 4, 1>(q, k, v, seg_q, seg_k, out, lse, S, Sk, hq, hkv,
                                               scale, rq, rk, st, describe);
  return launch_fwd_f32_pipe<kRope, 1, 4, 3>(q, k, v, seg_q, seg_k, out, lse, S, Sk, hq, hkv,
                                             scale, rq, rk, st, describe);
}

}  // namespace
