// VQ nearest-neighbour search for Hopper (sm_90a), one launch.
//
// Replaces the TPU kernel `_vq_kernel` reached through `vq_nearest_pallas`
// (titok_tpu/ops/vq_distance.py), entry `vq_nearest`.
//
// Computes, for every row s of z [S, D] against the codebook c [N, D] (f32,
// row-major):
//   d(s, n)   = |c_n|^2 - 2 * (z_s . c_n)          fp32 on the FMA pipes
//   idx[s]    = argmin_n d(s, n)                    ties to the lowest n
//   dist[s]   = min_n d(s, n)
// A row whose distances are all NaN keeps (idx 0, dist +inf), as the JAX
// kernel's running pair starts.
//
// What bounds it on the H100: 2*S*N*D flops of fp32 FMA (base_vq: S = 4096,
// N = 16384, D = 8 gives 1.07 GFLOP, 16 us at 67 TFLOP/s) against about
// 0.7 MB of inputs and outputs (0.2 us at 3.35 TB/s): compute-bound, on the
// FMA pipes, and so on instruction issue, since every instruction that is
// not an FMA takes an issue slot from one. No TF32 or bf16 tensor-core
// product: a rounded product flips near-ties, and token ids must not depend
// on it. Three things keep it from the bound: about 10.6 instructions a
// (row, code) pair where the bound counts 8 FMAs; an issue rate under one a
// cycle even with 16 warps an SM; and a fixed cost a launch (launch, the
// first loads, the reduction and the final recomputation), which no split
// of the work hides.
//
// What the design does about it:
// - D + 1 FP32 operations a pair: z is scaled by -2 (exact) as it is
//   loaded, -2 z.c is one multiply and D - 1 FMAs, and the norm is added
//   last (starting the chain from the norm would save the add, but rounds
//   every step at the norm's magnitude, and the gate rejects it).
// - One FMNMX a pair for the argmin: a thread folds each step of TILE codes
//   into a running min per row and only then compares it with the row's best,
//   keeping the step's first code as the winning run (3 instructions a step).
//   The code inside the winning run is found once per row at the end, by
//   recomputing the run's distances in the same order and taking the lowest
//   code that equals the minimum: the same bits, so the lowest index.
// - A register tile of ROWS rows by CB codes a thread: each code's D values
//   (two 16-byte loads at D = 8, the same address for the lanes of a group)
//   and a quarter of a 16-byte load of norms feed ROWS * D FP32 operations.
// - The code axis is split three ways, so each row block is spread over
//   many warps: across the 2 lane groups of a warp (a group of 16 lanes
//   holds ROWS * 16 = 64 rows), across the warps of a CTA (all on the same
//   rows), and across the CTAs of a thread-block cluster (<= 8). Each (CTA,
//   warp, group) walks its own contiguous range of codes in TILE-code steps
//   through a private 3-stage ring in shared memory, filled by cp.async two
//   steps ahead. The group computes the norms of each staged step in shared
//   memory once, in a fixed order, among the FMAs of the step before.
// - The planner (ops/vq_distance.py: plan_for) gives one CTA of up to 16
//   warps to an SM: more warps a scheduler hide the loads' latency, and a
//   CTA that fills its SM keeps a cluster's CTAs on separate SMs. At the
//   one shape the model runs (S 4096, N 16384, D 8) that is 64 row blocks
//   by clusters of 2: 128 CTAs of 16 warps.
// - One launch, no scratch: the (min, run start) pairs are reduced across
//   the lane groups by shuffles, then every warp sends its pair of each row
//   to the cluster rank that finishes the row (distributed shared memory,
//   one cluster barrier); each rank reduces its rows' pairs, recomputes the
//   winning runs and writes idx and dist. Every reduction takes the smaller
//   distance and, of equal ones, the lower run start, so ties go to the
//   lowest index and two launches give the same bits, whatever the plan.
// - Any S, N and 1 <= D <= 16: rows past S are computed on zeros and not
//   written; codes past a range's end get a NaN norm, which FMNMX skips.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int ROWS = 4;       // rows per thread
constexpr int G = 2;          // lane groups of a warp, each on its own codes
constexpr int TILE = 32;      // codes of one range per ring step (one argmin run)
constexpr int STAGES = 3;     // ring steps in shared memory per range
constexpr int MAX_DIM = 16;
constexpr int MAX_WARPS = 16;
constexpr int MAX_CLUSTER = 8;
constexpr int CB = 4;         // codes a register tile holds

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// |c|^2 in a fixed order, each step rounded once; the main loop and the
// final recomputation call this same function, so they get the same bits.
template <int D>
__device__ __forceinline__ float code_norm(const float (&c)[D]) {
  float acc = __fmul_rn(c[0], c[0]);
#pragma unroll
  for (int d = 1; d < D; ++d) acc = __fmaf_rn(c[d], c[d], acc);
  return acc;
}

// d(s, n) from the -2-scaled row and the code's norm: -2 z.c by one
// multiply and D - 1 FMAs, then the norm added, each rounded once (the
// chain started from the norm instead saves the add but rounds every step
// at the norm's magnitude, and fails the gate).
template <int D>
__device__ __forceinline__ float distance(const float (&zr)[D], const float (&c)[D], float cn) {
  float acc = __fmul_rn(zr[0], c[0]);
#pragma unroll
  for (int d = 1; d < D; ++d) acc = __fmaf_rn(zr[d], c[d], acc);
  return __fadd_rn(acc, cn);
}

// D floats from p: 16-byte loads where D allows it and p is aligned
template <int D>
__device__ __forceinline__ void load_code(float (&c)[D], const float* p, bool vec16) {
  if constexpr (D % 4 == 0) {
    if (vec16) {
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 v = *reinterpret_cast<const float4*>(p + d);
        c[d] = v.x;
        c[d + 1] = v.y;
        c[d + 2] = v.z;
        c[d + 3] = v.w;
      }
      return;
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) c[d] = p[d];
}

// (d, t) replaces (bd, bt) when its distance is smaller or, equal, its run
// starts at a lower code. A run start of -1 (no finite distance seen) goes
// with +inf and loses to any finite distance.
__device__ __forceinline__ void take_min(float& bd, int& bt, float d, int t) {
  if (d < bd || (d == bd && t < bt)) {
    bd = d;
    bt = t;
  }
}

// Shared memory, in floats: for every range a ring of steps, each its codes
// and their norms (4 floats of padding after each, so that the groups of a
// warp read through different banks); then, for the rows the rank finishes
// (rank k: rows k, k + K, ... of the row block), a (distance, run start)
// pair from every (rank, warp), the winning index and the row of z.
template <int D>
__host__ __device__ constexpr int step_floats() { return TILE * D + 4 + TILE + 4; }

template <int D>
__host__ __device__ constexpr int smem_floats(int warps, int cluster) {
  const int per_rank = (ROWS * 32 / G + cluster - 1) / cluster;
  return STAGES * warps * G * step_floats<D>() + (2 * cluster * warps + 1 + D) * per_rank;
}
// the most any plan takes: 16 warps of the largest D, every cluster size
constexpr int max_smem_bytes() {
  int most = 0;
  for (int k = 1; k <= MAX_CLUSTER; ++k)
    most = smem_floats<MAX_DIM>(MAX_WARPS, k) > most ? smem_floats<MAX_DIM>(MAX_WARPS, k) : most;
  return 4 * most;
}
static_assert(max_smem_bytes() <= 227 * 1024, "a plan would not fit an H100 SM's shared memory");

// grid: row blocks * cluster CTAs, cluster (cluster, 1, 1); block 32 * warps.
// Range r = (rank * warps + warp) * G + group covers codes
// [r * per_range, (r + 1) * per_range) within [0, N); per_range is a
// multiple of 4, so every range starts 16-byte aligned when cb is.
template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32)
vq_nearest_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                  int* __restrict__ idx, float* __restrict__ dist, int S, int N, int per_range,
                  int vec16) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int W = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int gl = 32 / G;  // lanes of a group
  const int grp = lane / gl, li = lane % gl;
  constexpr int RW = ROWS * gl;  // rows of the CTA
  const int WG = W * G;
  const int row0 = (blockIdx.x / K) * RW;

  const int per_rank = (RW + K - 1) / K;  // rows this rank finishes
  const int KW = K * W;
  float* ring_s = smem;                                        // [STAGES][WG][step_floats]
  float* fin_d = ring_s + STAGES * WG * step_floats<D>();     // [KW][per_rank]
  int* fin_t = reinterpret_cast<int*>(fin_d + KW * per_rank);  // [KW][per_rank]
  int* hit = fin_t + KW * per_rank;                            // [per_rank]
  float* zfin = reinterpret_cast<float*>(hit + per_rank);      // [per_rank][D]
  // every CTA of the cluster has started once this phase completes; waited
  // for before the first write to another CTA's shared memory
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // this lane's group: its range of codes and its ring
  const int range = (rank * W + warp) * G + grp;
  const int nb = static_cast<int>(min((long long)N, (long long)range * per_range));
  const int ne = min(N, nb + per_range);
  const int steps = (per_range + TILE - 1) / TILE;  // the same for every range
  float* ring = ring_s + (warp * G + grp) * step_floats<D>();
  const int slot_floats = WG * step_floats<D>();  // one ring slot of the CTA

  // the group's lanes copy step `step` of its range into ring slot `slot`
  auto issue = [&](int step, int slot) {
    const int n = nb + step * TILE;
    const int limit = (ne - n) * D;  // floats of the step inside the range
    float* dst = ring + slot * slot_floats;
    const float* src = cb + (size_t)n * D;
    for (int e = li * 4; e < TILE * D; e += gl * 4) {
      if (vec16 && e + 4 <= limit) {
        cp_async16(dst + e, src + e);
      } else {
        for (int k = 0; k < 4 && e + k < limit; ++k) cp_async4(dst + e + k, src + e + k);
      }
    }
  };
  // the norms of step `step`, from its codes in slot `slot`: lane li takes
  // codes li, li + 32 / G, ...; NaN past the range's end
  auto norms = [&](int step, int slot) {
    const float* cs = ring + slot * slot_floats;
    float* ns = ring + slot * slot_floats + TILE * D + 4;
    auto one = [&](int k) {
      const int j = li + k * gl;
      float c[D];
      load_code<D>(c, cs + j * D, true);
      ns[j] = nb + step * TILE + j < ne ? code_norm<D>(c) : NAN;
    };
#pragma unroll
    for (int k = 0; k < G; ++k) one(k);
  };

  issue(0, 0);
  // the rows of z this rank finishes, for the recomputation at the end
  for (int e = threadIdx.x; e < per_rank * D; e += blockDim.x) {
    const int row = rank + K * (e / D);
    if (row < RW && row0 + row < S) cp_async4(zfin + e, z + (size_t)(row0 + row) * D + e % D);
  }
  cp_async_commit();
  if (steps > 1) issue(1, 1);
  cp_async_commit();

  // this lane's rows, scaled by -2 (exact)
  float zr[ROWS][D];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r * gl + li;
#pragma unroll
    for (int d = 0; d < D; ++d)
      zr[r][d] = row < S ? __fmul_rn(-2.f, z[(size_t)row * D + d]) : 0.f;
  }
  cp_async_wait<1>();
  __syncwarp();  // step 0 landed
  norms(0, 0);

  float best[ROWS];
  int best_t[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    best[r] = INFINITY;
    best_t[r] = -1;
  }

  // step s: its codes and norms are in slot s % 3; step s + 1 landed at
  // the top and its norms are computed among the FMAs of step s; step s + 2
  // is in flight
  for (int step = 0; step < steps; ++step) {
    const int slot = step % STAGES;
    cp_async_wait<0>();
    __syncwarp();  // step s + 1 landed; norms of step s written; step s - 1 read
    if (step + 2 < steps) issue(step + 2, (step + 2) % STAGES);
    cp_async_commit();
    const int t = nb + step * TILE;  // the step's first code: its argmin run
    const float* cs = ring + slot * slot_floats;
    const float* ns = cs + TILE * D + 4;
    // the run's min per row: FMNMX skips NaN, so +inf stays for a run with
    // no finite distance, and the strict < below keeps the earlier run
    float m[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) m[r] = INFINITY;
#pragma unroll
    for (int j = 0; j < TILE; j += CB) {
      // a ROWS x CB tile of distances, each computed as distance() does
      float nv[CB], cv[CB][D], acc[ROWS][CB];
#pragma unroll
      for (int c = 0; c < CB; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(ns + j + c);
        nv[c] = v.x;
        nv[c + 1] = v.y;
        nv[c + 2] = v.z;
        nv[c + 3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < CB; ++c) load_code<D>(cv[c], cs + (j + c) * D, true);
#pragma unroll
      for (int d = 0; d < D; ++d)
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int c = 0; c < CB; ++c)
            acc[r][c] = d == 0 ? __fmul_rn(zr[r][0], cv[c][0])
                               : __fmaf_rn(zr[r][d], cv[c][d], acc[r][c]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < CB; ++c) m[r] = fminf(m[r], __fadd_rn(acc[r][c], nv[c]));
    }
    // last in the block, so that the loads and FMAs of the next step's norms
    // can be scheduled among those of this step (no store comes before them)
    norms(step + 1, (step + 1) % STAGES);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (m[r] < best[r]) {
        best[r] = m[r];
        best_t[r] = t;
      }
    }
  }

  // the warp's groups by shuffles; then every warp sends its pair of each
  // row to the rank that finishes the row, into that CTA's shared memory
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    for (int o = gl; o < 32; o <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, best[r], o);
      const int ot = __shfl_xor_sync(0xffffffffu, best_t[r], o);
      take_min(best[r], best_t[r], od, ot);
    }
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = r * gl + li;
      const int slot = (rank * W + warp) * per_rank + row / K;
      cluster.map_shared_rank(fin_d, row % K)[slot] = best[r];
      cluster.map_shared_rank(fin_t, row % K)[slot] = best_t[r];
    }
  }
  cluster.sync();  // release the sends, acquire the ones received

  // the rank's rows i (row rank + K * i of the block), one a thread: the
  // K * W pairs, in place of the first
  for (int i = threadIdx.x; i < per_rank; i += blockDim.x) {
    float bd = fin_d[i];
    int bt = fin_t[i];
    for (int l = 1; l < KW; ++l) take_min(bd, bt, fin_d[l * per_rank + i], fin_t[l * per_rank + i]);
    fin_d[i] = bd;
    fin_t[i] = bt;
    hit[i] = 0x7fffffff;
  }
  __syncthreads();
  // each (row, code of its winning run), one a thread: the code's distance
  // recomputed as the main loop computed it; the lowest code that meets the
  // minimum is the lowest index
#pragma unroll 4
  for (int p = threadIdx.x; p < per_rank * TILE; p += blockDim.x) {
    const int i = p / TILE, n = fin_t[i] + p % TILE;
    if (rank + K * i < RW && row0 + rank + K * i < S && fin_t[i] >= 0 && n < N) {
      float zs[D], c[D];
#pragma unroll
      for (int d = 0; d < D; ++d) zs[d] = __fmul_rn(-2.f, zfin[i * D + d]);
      load_code<D>(c, cb + (size_t)n * D, vec16);
      if (distance<D>(zs, c, code_norm<D>(c)) == fin_d[i]) atomicMin(&hit[i], n);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < per_rank; i += blockDim.x) {
    const int s = row0 + rank + K * i;
    if (rank + K * i < RW && s < S) {
      // no finite distance: (0, +inf); a run without its minimum, which the
      // gate's range check catches: -1
      idx[s] = fin_t[i] < 0 ? 0 : hit[i] == 0x7fffffff ? -1 : hit[i];
      dist[s] = fin_d[i];
    }
  }
}

// The launch of plan (warps, cluster, per_range) for S rows: grid, block,
// shared memory (the kernel's limit raised first where it needs more than
// 48 KB) and the cluster.
template <int D>
int launch(const float* z, const float* cb, int* idx, float* dist, int S, int N, int warps,
           int cluster, int per_range, cudaStream_t st) {
  const int bytes = smem_floats<D>(warps, cluster) * 4;
  static int allowed = 48 * 1024;  // per instantiation: raised as needed
  if (bytes > allowed) {
    cudaError_t e = cudaFuncSetAttribute(vq_nearest_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = bytes;
  }
  constexpr int rows = ROWS * 32 / G;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((S + rows - 1) / rows) * cluster);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int vec16 = (reinterpret_cast<uintptr_t>(cb) % 16) == 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, vq_nearest_kernel<D>, z, cb, idx, dist, S, N,
                                             per_range, vec16));
}

}  // namespace

// z [S, D], codebook [N, D] f32; outputs idx [S] int32, dist [S] f32. The
// plan (ops/vq_distance.py: plan_for): `warps` a CTA (1-16), `cluster` CTAs
// a cluster (1-8), `per_range` codes a range (a multiple of 4; cluster *
// warps * 2 ranges cover N). Launches on `stream`; returns the launch's
// error (cudaErrorInvalidValue for arguments the kernel does not take),
// then cudaGetLastError().
extern "C" int vq_nearest(const float* z, const float* codebook, int* idx, float* dist, int S,
                          int N, int D, int warps, int cluster, int per_range, void* stream) {
  if (S <= 0) return 0;
  if (!(N > 0 && warps >= 1 && warps <= MAX_WARPS && cluster >= 1 && cluster <= MAX_CLUSTER &&
        per_range >= 1 && per_range % 4 == 0 && (long long)per_range * cluster * warps * G >= N))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (D) {
#define VQ_CASE(d)                                                        \
  case d:                                                                 \
    err = launch<d>(z, codebook, idx, dist, S, N, warps, cluster, per_range, st); \
    break;
    VQ_CASE(1) VQ_CASE(2) VQ_CASE(3) VQ_CASE(4) VQ_CASE(5) VQ_CASE(6) VQ_CASE(7) VQ_CASE(8)
    VQ_CASE(9) VQ_CASE(10) VQ_CASE(11) VQ_CASE(12) VQ_CASE(13) VQ_CASE(14) VQ_CASE(15) VQ_CASE(16)
#undef VQ_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// Marks a build whose vq_nearest is the one-launch kernel above (its C entry
// takes a plan, no scratch and no norms), for tools/compare_attn.py.
extern "C" int vq_nearest_one_launch() { return 1; }
