// VQ nearest-neighbour search for Hopper (sm_90a).
//
// Replaces the TPU kernel `_vq_kernel` reached through `vq_nearest_pallas`
// (titok_tpu/ops/vq_distance.py), entry `vq_nearest`.
//
// Computes, for every row s of z [S, D] against the codebook c [N, D] (f32,
// row-major) with the code norms cn [N] = |c_n|^2 computed outside:
//   d(s, n)   = cn[n] - 2 * (z_s . c_n)            fp32, the dot on FMA
//   idx[s]    = argmin_n d(s, n)                    ties to the lowest n
//   dist[s]   = min_n d(s, n)
// A row whose distances are all NaN keeps (idx 0, dist +inf), as the JAX
// kernel's running pair starts.
//
// What bounds it on the H100: 2*S*N*D flops of fp32 FMA (base_vq: S = 4096,
// N = 16384, D = 8 gives 1.07 GFLOP, 16 us at 67 TFLOP/s) against about
// 0.75 MB of inputs and outputs (0.2 us at 3.35 TB/s): compute-bound, on the
// FMA pipes. No TF32 or bf16 tensor-core product: a rounded product flips
// near-ties, and token ids must not depend on it. The S*N compares and
// selects are work on top of the FMAs that the bound does not count.
//
// What the design does about it:
// - Each thread owns ROWS rows (4) with their D values in registers, so one
//   code read from shared memory (a broadcast: every lane reads the same
//   address) feeds 4*D FMAs.
// - A CTA (128 threads, 512 rows) walks one range of codes in tiles of 256
//   codes and their norms, staged in shared memory; each thread keeps a
//   running (min, argmin) per row in ascending code order with a strict <,
//   so within a range the lowest index wins a tie.
// - When S alone gives few CTAs (S = 4096 gives 8), N is split into P
//   ranges (blockIdx.y) so the grid fills the card; each range writes its
//   (min, argmin) per row to scratch [P, S], and a second kernel reduces
//   the P pairs of a row in ascending range order with a strict <: ties
//   still go to the lowest index.
// - Any S, N and 1 <= D <= 16: rows past S and codes past N are masked; no
//   row is padded into the result.
// Not yet: a register tile of codes as well as rows, packed half-width
// compares, one pass without scratch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 4;       // rows per thread
constexpr int TILE_N = 256;   // codes per shared-memory tile
constexpr int MAX_DIM = 16;

template <int D>
__global__ void __launch_bounds__(THREADS)
vq_partial(const float* __restrict__ z, const float* __restrict__ cb,
           const float* __restrict__ cn, float* __restrict__ part_d,
           int* __restrict__ part_i, int S, int N, int codes_per_split) {
  __shared__ __align__(16) float c_s[TILE_N * D];
  __shared__ float cn_s[TILE_N];

  const int row0 = blockIdx.x * (THREADS * ROWS) + threadIdx.x;
  float zr[ROWS][D];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r * THREADS;
#pragma unroll
    for (int d = 0; d < D; ++d) zr[r][d] = row < S ? z[(size_t)row * D + d] : 0.f;
  }
  float best[ROWS];
  int arg[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    best[r] = INFINITY;
    arg[r] = 0;
  }

  const int n_begin = blockIdx.y * codes_per_split;
  const int n_end = min(N, n_begin + codes_per_split);
  for (int t0 = n_begin; t0 < n_end; t0 += TILE_N) {
    const int tn = min(TILE_N, n_end - t0);
    __syncthreads();  // the previous tile is no longer read
    const float* src = cb + (size_t)t0 * D;
    for (int i = threadIdx.x; i < tn * D; i += THREADS) c_s[i] = src[i];
    for (int i = threadIdx.x; i < tn; i += THREADS) cn_s[i] = cn[t0 + i];
    __syncthreads();
    for (int j = 0; j < tn; ++j) {
      float c[D];
#pragma unroll
      for (int d = 0; d < D; ++d) c[d] = c_s[j * D + d];
      const float cnj = cn_s[j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float dot = zr[r][0] * c[0];
#pragma unroll
        for (int d = 1; d < D; ++d) dot = fmaf(zr[r][d], c[d], dot);
        const float dist = fmaf(-2.f, dot, cnj);  // -2*dot is exact: one rounding
        if (dist < best[r]) {
          best[r] = dist;
          arg[r] = t0 + j;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r * THREADS;
    if (row < S) {
      part_d[(size_t)blockIdx.y * S + row] = best[r];
      part_i[(size_t)blockIdx.y * S + row] = arg[r];
    }
  }
}

// The P ranges' pairs of each row, in ascending range (so code) order.
__global__ void vq_reduce(const float* __restrict__ part_d, const int* __restrict__ part_i,
                          int* __restrict__ idx, float* __restrict__ dist, int S, int P) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= S) return;
  float best = part_d[row];
  int arg = part_i[row];
  for (int p = 1; p < P; ++p) {
    const float d = part_d[(size_t)p * S + row];
    if (d < best) {
      best = d;
      arg = part_i[(size_t)p * S + row];
    }
  }
  idx[row] = arg;
  dist[row] = best;
}

template <int D>
void launch_partial(dim3 grid, cudaStream_t st, const float* z, const float* cb,
                    const float* cn, float* part_d, int* part_i, int S, int N, int per) {
  vq_partial<D><<<grid, THREADS, 0, st>>>(z, cb, cn, part_d, part_i, S, N, per);
}

}  // namespace

// z [S, D], codebook [N, D], cn [N] f32; scratch part_d [P, S] f32 and
// part_i [P, S] int32; outputs idx [S] int32, dist [S] f32. Launches on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for a D the
// kernel does not take).
extern "C" int vq_nearest(const float* z, const float* codebook, const float* cn,
                          float* part_d, int* part_i, int* idx, float* dist, int S, int N,
                          int D, int P, void* stream) {
  if (S <= 0) return 0;
  if (N <= 0 || P <= 0 || D < 1 || D > MAX_DIM) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per = (N + P - 1) / P;
  const dim3 grid((S + THREADS * ROWS - 1) / (THREADS * ROWS), P);
  switch (D) {
#define VQ_CASE(d) \
  case d:          \
    launch_partial<d>(grid, st, z, codebook, cn, part_d, part_i, S, N, per); \
    break;
    VQ_CASE(1) VQ_CASE(2) VQ_CASE(3) VQ_CASE(4) VQ_CASE(5) VQ_CASE(6) VQ_CASE(7) VQ_CASE(8)
    VQ_CASE(9) VQ_CASE(10) VQ_CASE(11) VQ_CASE(12) VQ_CASE(13) VQ_CASE(14) VQ_CASE(15)
    VQ_CASE(16)
#undef VQ_CASE
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  vq_reduce<<<(S + 255) / 256, 256, 0, st>>>(part_d, part_i, idx, dist, S, P);
  return static_cast<int>(cudaGetLastError());
}
