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
//   version): the dq is `bwd_dq_f32_pipe` (segment_attn_dq.cuh, shared with
//   the v1 f32 dq), the dk/dv `bwd_dkv_f32_pipe`; both below.
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
// thread's m16n8 accumulator fragment holds both columns of a pair, as a
// lane's float4s of dQ and dK do in the f32 dq and dk/dv.
//
// f32 dq (`bwd_dq_f32_pipe<kRope, HPC, RT, NP, MINB>`): IEEE fp32 FMA, no
// TF32 and no tensor cores, expf. What bounds it: the three products (S,
// dP, dQ) at the 67 TFLOP/s FMA peak (large 16/4: 15.9 GFLOP of live work,
// 0.237 ms). As in the forward, every FFMA takes an operand from shared
// memory; wavefronts per FFMA of each product loop, warp-wide:
// - S = Q K^T and dP = dO V^T (RT q rows x 64 / NP kv columns a lane), a
//   step of 4 d: RT float4 of Q (or dO) and 8 / NP of K (or V): 1/4 at RT
//   8, 3/8 at RT 4, 1/2 at RT 4 in two passes;
// - dQ += dS K (RT q rows x 8 d columns), a step of 4 kv rows: RT float4 of
//   dS and 8 of K: 1/4 at RT 8, 3/8 at RT 4;
// - the previous kernel: 8 scalar loads per 8 FFMA in S and dP, 6 per 8 in
//   dQ (rows padded to 65 floats): 1, 3/4.
// What the design does:
// - One CTA per (64-row q tile, HPC q heads of one GQA group); Q and dO of
//   its heads staged once by 16-byte cp.async into XOR-swizzled tiles, their
//   lse and delta by 4-byte copies beside them (held in registers, they made
//   the RoPE instantiation at HPC 1 spill). The group's heads share each
//   staged K and V tile; K and V have one buffer each with `full` and
//   `free` mbarriers, as in the forward. A tile takes dP first (V), then S
//   and dQ (K): V(t + 1) goes in once every warp is past dP(t) and lands
//   during dQ(t); K(t + 1) goes in once every warp is past dQ(t) and lands
//   during dP(t + 1). The tile ids are double-buffered, so K(t + 1)'s copy
//   never writes the ids tile t reads.
// - Lane (a, b) holds RT q rows (a + 4 i) x 8 / NP kv columns (b + 8 j) of
//   dP, then S, and the same rows x 8 d columns of dQ. dP, then dS, go
//   through a 4-byte-a-lane buffer of the warp's own rows (dP read back by
//   its writer for dS), so only warp barriers sit between the products.
//   Accumulators: 128 at RT 8 (S or dP 64, dQ 64), not the 192 of S, dP
//   and dQ held at once.
// - Each dq element is one fmaf chain over the q tile's kv rows in
//   ascending order, no atomics: two launches give the same bits, and so
//   does every HPC, RT and NP (the q tile is 64 rows for all).
// - Choices by group size: HPC 4 where 4 divide the group (RT 8, 256
//   threads, one CTA an SM, 232,192 B); 3 where 3 do (RT 4, 384 threads);
//   else 1 (RT 4, 128 threads, each kv tile in NP = 2 passes of 32 columns,
//   unrolled: half the dP / dS buffer, 75,008 B, three CTAs an SM, so at 4/2
//   its 384 CTAs run in one wave).
// - Heaviest q tiles first (`lpt_item`), as the forward.
// - RoPE: Q rotated once per CTA for all HPC heads, each K tile once per CTA
//   after its copy lands; dQ inverse-rotated in the lane, which holds both
//   columns of each pair (4 b.., 32 + 4 b..), before its one write.
//
// f32 dk/dv (`bwd_dkv_f32_pipe<kRope, NG, RT, STAGES, MINB, KV>`): IEEE fp32
// FMA, no TF32 and no tensor cores, expf. What bounds it: the four products
// (S^T, dP^T, dV, dK) at the 67 TFLOP/s FMA peak (large 16/4: 21.1 GFLOP of
// live work, 0.315 ms). As in the f32 forward (flash_segment_attn_fwd.cu),
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
//   atomics, so two launches give the same bits.
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

#include "segment_attn_dkv.cuh"
#include "segment_attn_dq.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 dk/dv: fp32 FMA, register-blocked; one CTA per (KV-row kv tile, kv
// head), NG warp groups over the group's q heads, a cp.async ring of
// (32-row q tile, NG heads) units
// ---------------------------------------------------------------------------

constexpr int FQU = 32;  // q rows per unit

// Bytes of one ring stage: the Q and dO tiles of NG heads, their lse and
// delta, and the q ids; a multiple of 1 KB, so every stage keeps the base's
// 256-byte alignment.
template <int NG>
__host__ __device__ constexpr int dkv_f32_stage_bytes() {
  return (NG * 2 * FQU * D * 4 + NG * 2 * FQU * 4 + FQU * 4 + 1023) / 1024 * 1024;
}

// Dynamic shared memory: K and V, each warp's P^T / dS^T rows, a ring of
// STAGES units, and 256 bytes to align the base.
template <int NG, int STAGES, int KV>
__host__ __device__ constexpr int dkv_f32_smem_bytes() {
  return 2 * KV * D * 4 + NG * KV * FQU * 4 + STAGES * dkv_f32_stage_bytes<NG>() + 256;
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
  float* buf = v_s + KV * D;                   // [NG * WPG warps][WR][FQU], swizzled
  unsigned char* ring = reinterpret_cast<unsigned char*>(buf + NG * KV * FQU);

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
  const int nunits = (hi - lo + FQU - 1) / FQU * chunks;  // q tile outer, NG heads inner
  auto unit_q0 = [&](int u) { return lo + u / chunks * FQU; };
  auto unit_h0 = [&](int u) { return hk * rep + u % chunks * NG; };
  auto stage_q = [&](int u) { return reinterpret_cast<float*>(ring + (u % STAGES) * SB); };

  // unit u into stage u % STAGES: Q, dO [NG][FQU][D], lse, delta
  // [NG][FQU], ids [FQU]; always one commit
  auto issue_unit = [&](int u) {
    if (u < nunits) {
      float* qs = stage_q(u);
      const int qs0 = unit_q0(u), h0 = unit_h0(u);
      issue_rows_f32<NT, FQU, NG>(qs, q, qs0, hi, ldq, h0 * D, tid);
      issue_rows_f32<NT, FQU, NG>(qs + NG * FQU * D, dout, qs0, hi, ldq, h0 * D, tid);
      float* ls = qs + 2 * NG * FQU * D;
      if (tid < NG * FQU) {
        const int hh = tid / FQU, r = tid % FQU;
        const bool ok = qs0 + r < hi;
        const size_t off = ok ? (size_t)(qs0 + r) * hq + h0 + hh : 0;
        cp_async4(&ls[tid], lse + off, ok);
        cp_async4(&ls[NG * FQU + tid], delta + off, ok);
      }
      int* ids = reinterpret_cast<int*>(ls + 2 * NG * FQU);
      if (tid < FQU && qs0 + tid < hi) cp_async4(&ids[tid], seg_q + qs0 + tid, true);
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
      if constexpr (kRope) rotate_own_f32<NT, FQU, NG>(qs, qs0, hi, rq, tid, landed);
      else landed();
      int* ids = reinterpret_cast<int*>(qs + 2 * NG * FQU * D + 2 * NG * FQU);
      if (tid < FQU) ids[tid] = qs0 + tid < hi ? remap(ids[tid]) : NO_ROW_Q;
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
  const uint32_t prow = smem_u32(buf) + warp * WR * FQU * 4 + a * 128 + (a << 4);
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
    for (int q2 = 0; q2 < FQU / 4; q2 += 2) {
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
    const float* lse_s = st + 2 * NG * FQU * D + grp * FQU;
    const float* delta_s = lse_s + NG * FQU;
    const int* ids = reinterpret_cast<const int*>(st + 2 * NG * FQU * D + 2 * NG * FQU);
    // the group's Q and dO rows b + 8 j, chunk c: (qb ^ (c << 4)) + 2048 j;
    // row r, chunks b and 8 + b: (qx ^ ((r & 7) << 4)) + 256 r, + 128
    const uint32_t qx = smem_u32(st) + grp * FQU * D * 4 + (b << 4);
    const uint32_t dx = qx + NG * FQU * D * 4;
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
  }
  return launch_dq_f32<kRope>(static_cast<const float*>(q), static_cast<const float*>(k),
                              static_cast<const float*>(v), seg_q, seg_k,
                              static_cast<const float*>(dout), lse, delta,
                              static_cast<float*>(dq), S, Sk, hq, hkv, scale, rq, rk, st);
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
  }
  return launch_dkv_f32<kRope>(static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), seg_q, seg_k,
                               static_cast<const float*>(dout), lse, delta,
                               static_cast<float*>(dk), static_cast<float*>(dv), S, Sk, hq, hkv,
                               scale, rq, rk, st);
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

// The f32 dk/dv kernel's launch shape at hq / hkv heads (kRope when rope !=
// 0): out[8] = threads a CTA, dynamic shared memory bytes, registers a
// thread, CTAs an SM, warp groups, kv rows a thread, kv rows a tile, ring
// stages. Launches nothing; returns a CUDA error code.
extern "C" int flash_segment_attn_f32_dkv_config(int hq, int hkv, int rope, int* out) {
  return rope ? launch_dkv_f32<true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, nullptr, nullptr, 0, 0, hq, hkv, 0.f,
                                     Rope{}, Rope{}, 0, out)
              : launch_dkv_f32<false>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                      nullptr, nullptr, nullptr, nullptr, 0, 0, hq, hkv, 0.f,
                                      Rope{}, Rope{}, 0, out);
}

// The f32 dq kernel's launch shape at hq / hkv heads (kRope when rope != 0):
// out[8] = threads a CTA, dynamic shared memory bytes, registers a thread,
// CTAs an SM, q heads a CTA, q rows a thread, kv rows a tile, kv column
// passes a tile. Launches nothing; returns a CUDA error code.
extern "C" int flash_segment_attn_f32_dq_config(int hq, int hkv, int rope, int* out) {
  return rope ? launch_dq_f32<true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                    nullptr, nullptr, nullptr, 0, 0, hq, hkv, 0.f, Rope{}, Rope{},
                                    0, out)
              : launch_dq_f32<false>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, nullptr, 0, 0, hq, hkv, 0.f, Rope{},
                                     Rope{}, 0, out);
}
