// Segment-masked GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` reached through `_mh_fwd`
// (titok_tpu/ops/flash_attention_mh.py), entry `flash_segment_attention_mh`.
//
// Computes, for every q row i and q head h (kv head hk = h / (Hq/Hkv)):
//   s_ij = (q_i . k_j) * scale           fp32, masked to -1e30 unless seg_q[i] == seg_k[j]
//   online softmax in fp32: m, l; p = mask ? exp(s - m_new) : 0
//   acc += bf16(p) @ v                   p rounded to v's dtype before the PV product
//   out = acc / max(l, 1e-30),  lse = m + log(max(l, 1e-30))
// Pad slots (segment 0) are remapped to 2^30 on load, so ids are
// non-decreasing and pad rows attend among themselves, as in the JAX kernel.
//
// Inputs: q [S, Hq*64], k/v [Sk, Hkv*64] row-major (the JAX [S,H,D] layout),
// int32 segment ids; outputs: out [S, Hq*64] in q's dtype, lse [S, Hq] f32.
//
// What bounds it on the H100: at the serving shape (S = 6144, ten 576-row
// segments, Hq/Hkv = 4/2, D = 64, bf16) the useful work is
// 4*D*Hq*sum(L_b^2) = 3.4 GFLOP, 3.4 us at 989 TFLOP/s, and the bytes
// (q, k, v, out, lse, ids: ~9.6 MB) take 2.9 us at 3.35 TB/s: compute-bound,
// on the tensor cores, and only on the block-diagonal part of S x Sk. Once
// the loads are overlapped and the operands come by ldmatrix, the kernel
// with both products removed still takes two thirds of its time (measured
// on the card, PERF.md): what bounds it is the softmax's per-element ALU
// work and the per-tile overhead, not the tensor cores.
//
// What the design does about it:
// - Block skipping without a pre-pass: segments are contiguous, so each
//   CTA searches seg_k for the exact kv interval
//   [lower_bound(seg_q[first]), upper_bound(seg_q[last])) of its q tile and
//   visits nothing else (the JAX kernel visits whole blocks of a
//   host-computed interval). Two warps search at once, 32 probes a step. No
//   padding of S or Sk: ragged edges are masked.
// - bf16: one CTA per (64-row q tile, HPC q heads of one GQA group), as the
//   JAX kernel takes a q block's heads in one grid step: each staged K/V
//   tile serves HPC * 64 (row, head) pairs, 4 warps per head, 16 rows a
//   warp. HPC is 2 for the plain kernel (two CTAs an SM) and 4 for RoPE
//   (its per-tile copies and rotation are shared by more heads); then 3, 2;
//   a group of one head takes 128 q rows.
// - A ring of NS = 3 K/V tiles in dynamic shared memory, filled by 16-byte
//   cp.async (zero-filled past the interval), with two mbarriers a stage
//   instead of block barriers: `ready` (every thread has finished its copies
//   of the tile) and `empty` (every thread has computed on it). Each
//   iteration prepares tile t + 1, refills the stage of tile t - 1 with tile
//   t + 2 once it is empty, and computes tile t; a warp may run a tile ahead
//   of the slowest, so the CTA's warps are not all in the tensor-core or all
//   in the softmax phase at once.
// - Q K^T and P V on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
//   accumulate); A fragments of Q and B fragments of K by ldmatrix.x4, of V
//   by ldmatrix.x4.trans; the softmax stays in registers (the S accumulator's
//   fragment layout is reused as the A operand of P V).
// - The softmax in log2 units: scale * log2(e) folded into the scores, p by
//   one ex2.approx each; masked scores are -inf, and a row with no live
//   column yet subtracts 0, so no select per element; a tile whose first
//   and last ids are both rows' id (ids are non-decreasing) skips the
//   compares. lse leaves in natural-log units, as the backward reads it.
// - Registers: 128 a thread (153 at HPC 3), no spills; the table helpers
//   read threadIdx.x afresh so their per-thread offsets are not held across
//   the loop.
// - f32: its own template, `fwd_f32_pipe` (below).
// Not yet: wgmma and TMA (B from the ring straight into the tensor cores),
// 32 q rows a warp (B fragments shared by two m-tiles).
//
// RoPE fused (kRope = true; entry `flash_segment_attn_rope_fwd`): replaces
// `_fwd_kernel_rope` reached through `_rope_fwd` (attn_impl 'flash_rope').
// q and k come in unrotated with per-row tables cos/sin [rows, P] f32 (k
// may have its own); each interleaved pair (x[2p], x[2p+1]), p < P, is
// rotated in fp32 and rounded to the input dtype. cp.async brings a tile
// into shared memory without passing through registers, so the rotation is
// a pass over the arrived tile: the thread that copied a 16-byte chunk also
// copied that chunk's table entries (8-byte copies where P is even) into
// the CTA's one table buffer, and after its own cp.async wait it rotates the
// chunk in place before it arrives on the tile's `ready`. Q is rotated once
// per CTA, each K tile once per CTA, for all HPC heads. The rotation rounds each product and sum on its own (no FMA), as
// the port's elementwise apply_rotary_emb does, and both instantiations
// take the same tiles in the same order with the same arithmetic, so the
// fused forward equals apply_rotary_emb + this kernel bit for bit. The
// tables add (S + Sk) * P * 8 bytes of reads; the bound is that of the
// unfused kernel.
//
// f32 (`fwd_f32_pipe<kRope, HPC, RT, MINB>`, both entries with is_bf16 = 0):
// IEEE fp32 FMA, one fmaf chain an entry, no TF32 and no tensor cores (the
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

#include "segment_attn_fwd.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: fp32 FMA, register-blocked, a cp.async ring of K/V tiles, one CTA per
// (64-row q tile, HPC q heads of one GQA group)
// ---------------------------------------------------------------------------

constexpr int FQ = 64;   // q rows per CTA
constexpr int FK = 64;   // kv rows per tile

// Dynamic shared memory: Q of the CTA's heads, each warp's P rows, one K
// tile, one V tile, two tiles' ids, and 256 bytes to align the base.
template <int HPC>
__host__ __device__ constexpr int fwd_f32_smem_bytes() {
  return HPC * FQ * D * 4 + HPC * FQ * FK * 4 + 2 * FK * D * 4 + 2 * FK * 4 + 256;
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
  float* q_s = reinterpret_cast<float*>(smem);  // [HPC][FQ][D], swizzled
  float* p_s = q_s + HPC * FQ * D;              // [HPC * WPH warps][WR][FK], swizzled
  float* k_s = p_s + HPC * FQ * FK;             // [FK][D], swizzled
  float* v_s = k_s + FK * D;
  int* ids2 = reinterpret_cast<int*>(v_s + FK * D);  // [2][FK]: tile t's at t & 1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int a = lane >> 3, b = lane & 7;
  const int2 item = lpt_item(seg_q, S, FQ, MINB, reinterpret_cast<int*>(k_s));
  const int rep = hq / hkv, splits = rep / HPC;
  const int hk = item.y / splits;
  const int h0 = hk * rep + (item.y % splits) * HPC;  // the CTA's first q head
  const int hw = warp / WPH;                          // this warp's head, h0 + hw
  const int r0 = (warp % WPH) * WR + a;               // its rows r0 + 4 i
  const int q0 = item.x * FQ;
  const int q1 = min(q0 + FQ, S);
  const int ldq = hq * D, ldk = hkv * D;

  if (tid == 0) {
    mbar_init(&kfull, NT);
    mbar_init(&kfree, NT);
    mbar_init(&vfull, NT);
    mbar_init(&vfree, NT);
  }
  issue_rows_f32<NT, FQ, HPC>(q_s, q, q0, S, ldq, h0 * D, tid);
  cp_async_commit();
  int sq[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + r0 + 4 * i;
    sq[i] = row < S ? remap(seg_q[row]) : NO_ROW_Q;
  }
  segment_interval_warps(seg_q, seg_k, q0, q1, Sk, range_s);  // its barrier also
  const int lo = range_s[0], hi = range_s[1];                  // publishes the inits
  const int ntiles = (hi - lo + FK - 1) / FK;

  // tile t's K and ids, or its V; each one commit, empty past the last tile
  auto issue_k = [&](int t) {
    if (t < ntiles) {
      const int kv0 = lo + t * FK;
      issue_rows_f32<NT, FK, 1>(k_s, k, kv0, hi, ldk, hk * D, tid);
      if (tid < FK && kv0 + tid < hi) cp_async4(&ids2[(t & 1) * FK + tid], seg_k + kv0 + tid, true);
    }
    cp_async_commit();
  };
  auto issue_v = [&](int t) {
    if (t < ntiles) issue_rows_f32<NT, FK, 1>(v_s, v, lo + t * FK, hi, ldk, hk * D, tid);
    cp_async_commit();
  };

  // Q (rotated once, for all HPC heads) while tile 0's K and V are in flight
  issue_k(0);
  issue_v(0);
  auto q_landed = [] { cp_async_wait<2>(); };
  if constexpr (kRope) rotate_own_f32<NT, FQ, HPC>(q_s, q0, S, rq, tid, q_landed);
  else q_landed();
  __syncthreads();  // Q, rotated, is whole

  // Shared addresses (bytes). Q row r0 + 4 i, chunk c: row r0 + 4 i has low
  // bits a + 4 (i & 1), so the chunk sits at (qa[i & 1] ^ (c << 4)) + 1024 i.
  // The warp's P rows a + 4 i likewise; this lane's P column b + 8 j of row
  // a + 4 i at (pst[i & 1] ^ (j << 5)) + 1024 i.
  const uint32_t qrow = smem_u32(q_s) + hw * FQ * D * 4 + r0 * 256 + (a << 4);
  const uint32_t qa[2] = {qrow, qrow ^ 64};
  const uint32_t prow = smem_u32(p_s) + warp * WR * FK * 4 + a * 256 + (a << 4);
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
    if (kRope && t == 0) rotate_own_f32<NT, FK, 1>(k_s, lo, hi, rk, tid, k_landed);
    else k_landed();
    int* ids = ids2 + (t & 1) * FK;  // tile t + 1's copies go to the other half
    if (tid < FK) ids[tid] = lo + t * FK + tid < hi ? remap(ids[tid]) : NO_ROW_K;
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
        rotate_own_f32<NT, FK, 1>(k_s, lo + (t + 1) * FK, hi, rk, tid, [] { cp_async_wait<0>(); });
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
    describe[6] = FK;
    describe[7] = 1;
    return describe_kernel(kern, threads, smem, describe);
  }
  const dim3 grid((S + FQ - 1) / FQ, hkv * (hq / hkv / HPC));
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

template <bool kRope>
int launch_fwd(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_k,
               void* out, float* lse, int S, int Sk, int hq, int hkv, float scale, int is_bf16,
               Rope rq, Rope rk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_fwd_bf16<kRope>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg_q, seg_k,
        static_cast<__nv_bfloat16*>(out), lse, S, Sk, hq, hkv, scale, rq, rk, st);
  }
  return launch_fwd_f32<kRope>(static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), seg_q, seg_k,
                               static_cast<float*>(out), lse, S, Sk, hq, hkv, scale, rq, rk, st);
}

}  // namespace

// q [S, hq*64], k/v [Sk, hkv*64], seg_q [S], seg_k [Sk] int32 (non-decreasing
// once 0 is remapped to 2^30); out [S, hq*64] in q's dtype, lse [S, hq] f32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_segment_attn_fwd(const void* q, const void* k, const void* v,
                                      const int* seg_q, const int* seg_k, void* out,
                                      float* lse, int S, int Sk, int hq, int hkv,
                                      float scale, int is_bf16, void* stream) {
  return launch_fwd<false>(q, k, v, seg_q, seg_k, out, lse, S, Sk, hq, hkv, scale, is_bf16,
                           Rope{}, Rope{}, stream);
}

// The same with RoPE fused: q and k unrotated, cos_q/sin_q [S, P] and
// cos_k/sin_k [Sk, P] f32 (pass q's for k when k has none), 1 <= P <= 32.
extern "C" int flash_segment_attn_rope_fwd(const void* q, const void* k, const void* v,
                                           const int* seg_q, const int* seg_k,
                                           const float* cos_q, const float* sin_q,
                                           const float* cos_k, const float* sin_k, int P,
                                           void* out, float* lse, int S, int Sk, int hq,
                                           int hkv, float scale, int is_bf16, void* stream) {
  return launch_fwd<true>(q, k, v, seg_q, seg_k, out, lse, S, Sk, hq, hkv, scale, is_bf16,
                          make_rope(cos_q, sin_q, P), make_rope(cos_k, sin_k, P), stream);
}

// The f32 kernel's launch shape at hq / hkv heads (kRope when rope != 0):
// out[8] = threads a CTA, dynamic shared memory bytes, registers a thread,
// CTAs an SM, q heads a CTA, q rows a thread, kv rows a tile, K/V buffers.
// Launches nothing; returns a CUDA error code.
extern "C" int flash_segment_attn_f32_fwd_config(int hq, int hkv, int rope, int* out) {
  return rope ? launch_fwd_f32<true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                     nullptr, 0, 0, hq, hkv, 0.f, Rope{}, Rope{}, 0, out)
              : launch_fwd_f32<false>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                      nullptr, 0, 0, hq, hkv, 0.f, Rope{}, Rope{}, 0, out);
}
