// Tiled stationary covariance build and its vector-Jacobian product,
// hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels george_tpu/ops/pallas_cov.py
// _fwd_kernel (the forward build) and _bwd_kernel (its custom VJP).  Given
// metric-transformed coordinates A1 (N1, d), A2 (N2, d) and the radial
// parameters p (NP), the forward computes
//
//     K[i, j] = k(p; r2_ij),   r2_ij = sum_d (a1_id - a2_jd)^2,
//
// and the backward, for a cotangent g (N1, N2) and W = g * dk/d(r2),
//
//     dp_q  = sum_ij g_ij dk/dp_q (p; r2_ij)
//     dA1_i = 2 (rowsum_i(W) a1_i - sum_j W_ij a2_j) =  2 sum_j W_ij delta_ij
//     dA2_j = 2 (colsum_j(W) a2_j - sum_i W_ij a1_i) = -2 sum_i W_ij delta_ij
//
// with delta_ij = a1_i - a2_j, the difference r2 is formed from.  The kernel
// sums W_ij delta_ij: one product an entry and coordinate serves both
// reductions, and no rowsum(W) a1_i - sum_j W_ij a2_j cancels.
//
// Every array may carry a leading batch dimension B (the vmapped sampler
// density): p (B, PS), A1 (B, N1, d), A2 (B, N2, d), K and g (B, N1, N2),
// PS = max(NP, 1) (a dummy entry where NP = 0, never read).
//
// Instantiation (macros, see ops/cov.py): SC_T the scalar type (float or
// double), SC_NDIM the coordinate count d; the radial function comes from
// the generated header radial.cuh (dsl/cuda_codegen.generate_radial):
// gt::radial::radial_value<T, S> (the spec's value:, S = T or Dual<T, NP>
// for the NP parameter tangents) and gt::radial::radial_slope<T> (the
// spec's grad: r2, which is guarded where the slope diverges, e.g. 0 at
// r2 = 0 for ExpKernel, so the diagonal gives W_ii = 0, never 0 * inf).
//
// What bounds them.  Both are bound by bytes on the H100: the forward
// writes N1 N2 entries (1.07 GB of float32 at N = 16384, 0.32 ms at
// 3.35 TB/s) and the backward reads g (the same); each reads O(N d) else.
// Their ~3d + radial operations an entry (~15-35 instructions) take a
// large share of that time at the FP32 issue rate, so the arithmetic must
// hide under the memory traffic, and the traffic must be g or K once.  A
// radial parameter's tangents (a Dual pow an entry) make the backward
// bound by its instructions instead.
//
// Design.  A thread owns VEC = 16 / sizeof(T) consecutive columns (one
// 16-byte access a row), a warp 32 VEC columns, a block 8 warps.
//  * Forward: a block writes a tile of FR rows x 32 VEC columns; each warp
//    walks every 8th row, reads that row's a1 by a broadcast load and
//    writes VEC entries a thread with one 16-byte streaming store (K is
//    written once and read by the next kernel, never by this one).  No
//    shared memory, no barrier.  A row whose start is not 16-byte aligned
//    (N2 not a multiple of VEC) takes scalar stores.
//  * Backward, one pass over g.  A block owns a band of 64 rows and walks a
//    strip of 64 x 32 VEC tiles along it (the launcher splits a band into
//    strips only where the bands alone leave SMs idle).  Each thread
//    brings its own 8 rows x VEC columns of every tile into shared memory
//    by cp.async (16 bytes a row), STAGES - 1 tiles ahead of use, so the
//    loads overlap the radial arithmetic; it reads back only what it
//    copied, so the ring needs no barrier.  For each entry it forms r2,
//    W and W delta once (and the dp tangents where NP > 0) and adds W delta
//    to its row's and its column's sums:
//    - rows: the 8 rows' sums over the thread's VEC columns are reduced
//      over the warp's 32 lanes by a transposing butterfly (each step
//      halves the values a lane holds; 9 shuffles for 8 rows), and each
//      row's tile sum is added to a double accumulator carried across the
//      strip in registers;
//    - columns: the VEC columns' sums over the thread's 8 rows go to shared
//      memory, the 8 warps' are summed in warp order, and each column's
//      band partial (in T: a sum within one tile) is written once.
//    Sums within a tile run in T, across tiles in double.  Shared memory
//    is 3 stages x 32 KB plus the column exchange, two blocks an SM.
//    Keeping both reductions inside a warp (a warp owning 4 VEC columns of
//    all 64 rows) was slower on the H100: with each thread copying its
//    own 64-byte pieces of rows, and no barrier, g was read at two thirds
//    of this layout's rate; with the block copying whole rows and one
//    barrier a tile, it matched this layout at best.
//  * Finalize (one launch): a warp of lanes per 32 rows of A1 (or A2) sums
//    the strips' (or bands') partials, 8 warps over interleaved partials,
//    then the warps in order; where NP > 0 one block per (batch, parameter)
//    sums the blocks' dp partials in a fixed tree.
//    No float atomics anywhere: the result is the same bit for bit from
//    run to run.  A backward is 2 grid launches; the column partials are
//    N1 / 64 x N2 x d values of T (2-3% of g's bytes, written and read).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "dual.cuh"
#include "radial.cuh"

#ifndef SC_T
#error "SC_T (float or double) must be defined"
#endif
#ifndef SC_NDIM
#error "SC_NDIM must be defined"
#endif

typedef SC_T T;
typedef double acc_t;

#define NDIM SC_NDIM
#define NP GT_RADIAL_NP
#define PS (NP > 0 ? NP : 1)

namespace {

using gt::radial::radial_slope;
using gt::radial::radial_value;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kVec = 16 / (int)sizeof(T);  // columns a thread
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32 * kVec;            // columns a tile
// Forward: rows a block.
constexpr int kFwdRows = 128;
// Backward: rows a thread, rows a band (a tile), ring stages.
constexpr int kRows = 8;
constexpr int kBand = kWarps * kRows;
constexpr int kStages = 3;
constexpr int kTile = kBand * kCols;
// Two blocks an SM in float32; the float64 thread's registers allow one.
constexpr int kMinBlocks = sizeof(T) == 4 ? 2 : 1;

// 16 bytes of T: a streaming store to global memory, a store to and a load
// from shared memory.
__device__ __forceinline__ void store16(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store16(double* p, const double* v) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}
__device__ __forceinline__ void put16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void put16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load16(const double* p, double* v) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x, v[1] = q.y;
}

__device__ __forceinline__ T r2_of(const T* a, const T* b) {
  T r2 = T(0);
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    const T d = a[k] - b[k];
    r2 += d * d;
  }
  return r2;
}

// The coordinates of the thread's kVec columns from j0 (0 past n2).
__device__ __forceinline__ void load_cols(T (&c)[kVec][NDIM],
                                          const T* __restrict__ a2b, int j0,
                                          int n2) {
#pragma unroll
  for (int v = 0; v < kVec; ++v)
#pragma unroll
    for (int k = 0; k < NDIM; ++k)
      c[v][k] = j0 + v < n2 ? __ldg(a2b + (size_t)(j0 + v) * NDIM + k)
                            : T(0);
}

// Grid (row tiles x column tiles, B): a tile of kFwdRows x kCols.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
cov_fwd(const T* __restrict__ p, const T* __restrict__ a1,
        const T* __restrict__ a2, T* __restrict__ K, int n1, int n2,
        int ctiles) {
  const int b = blockIdx.y;
  const int rt = blockIdx.x / ctiles, ct = blockIdx.x - rt * ctiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = ct * kCols + lane * kVec;
  if (j0 >= n2) return;
  T pv[PS];
#pragma unroll
  for (int q = 0; q < PS; ++q) pv[q] = p[(size_t)b * PS + q];
  T c[kVec][NDIM];
  load_cols(c, a2 + (size_t)b * n2 * NDIM, j0, n2);
  const T* a1b = a1 + (size_t)b * n1 * NDIM;
  T* Kb = K + (size_t)b * n1 * n2 + j0;
  const int i0 = rt * kFwdRows + warp;
#pragma unroll 4
  for (int r = 0; r < kFwdRows / kWarps; ++r) {
    const int i = i0 + kWarps * r;
    if (i >= n1) break;
    T ra[NDIM];
#pragma unroll
    for (int k = 0; k < NDIM; ++k) ra[k] = __ldg(a1b + (size_t)i * NDIM + k);
    T out[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      out[v] = radial_value<T, T>(pv, r2_of(ra, c[v]));
    T* dst = Kb + (size_t)i * n2;
    if (kAligned) {
      store16(dst, out);
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        if (j0 + v < n2) __stcs(dst + v, out[v]);
    }
  }
}

// The thread's share of one tile of g (rows i0 + warp kRows + r, columns
// jt + lane kVec + v) into its own slots of a stage; zeros past the edges.
template <bool kAligned>
__device__ __forceinline__ void copy_tile(T* __restrict__ st,
                                          const T* __restrict__ gb, int n1,
                                          int n2, int i0, int jt, int warp,
                                          int lane) {
  const int j = jt + lane * kVec;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ii = warp * kRows + r, i = i0 + ii;
    T* dst = st + ii * kCols + lane * kVec;
    if (kAligned) {
      const bool in = i < n1 && j < n2;
      __pipeline_memcpy_async(dst, in ? gb + (size_t)i * n2 + j : gb, 16,
                              in ? 0 : 16);
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const bool in = i < n1 && j + v < n2;
        __pipeline_memcpy_async(dst + v,
                                in ? gb + (size_t)i * n2 + j + v : gb,
                                sizeof(T), in ? 0 : sizeof(T));
      }
    }
  }
}

// v[r], r < 8: this lane's partials of the warp's 8 rows.  Returns the sum
// over the warp's 32 lanes of row lane >> 2: each step trades half of the
// rows a lane holds with its partner and keeps the other half, summed.
// The 4 lanes holding a row get the same bits (a + b == b + a).
__device__ __forceinline__ T warp_rows_sum(T (&v)[kRows], int lane) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const bool hi = lane & 16;
    const T send = hi ? v[s] : v[s + 4];
    v[s] = (hi ? v[s + 4] : v[s]) + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const bool hi = lane & 8;
    const T send = hi ? v[s] : v[s + 2];
    v[s] = (hi ? v[s + 2] : v[s]) + __shfl_xor_sync(kFull, send, 8);
  }
  {
    const bool hi = lane & 4;
    const T send = hi ? v[0] : v[1];
    v[0] = (hi ? v[1] : v[0]) + __shfl_xor_sync(kFull, send, 4);
  }
  v[0] += __shfl_xor_sync(kFull, v[0], 2);
  v[0] += __shfl_xor_sync(kFull, v[0], 1);
  return v[0];
}

// Shared memory of the backward block: the ring, the column exchange and
// the dp exchange.
constexpr size_t kRingBytes = sizeof(T) * kStages * kTile;
constexpr size_t kRedBytes = sizeof(T) * NDIM * kWarps * kCols;
constexpr size_t kBwdSmem =
    kRingBytes + kRedBytes + sizeof(acc_t) * kWarps * PS;

// Grid (bands x strips, B).  part_rows (B, strips, d, N1) and part_dp
// (B, bands x strips, PS) in double, part_cols (B, bands, d, N2) in T.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cov_bwd_tiles(const T* __restrict__ p, const T* __restrict__ a1,
              const T* __restrict__ a2, const T* __restrict__ g,
              acc_t* __restrict__ part_rows, acc_t* __restrict__ part_dp,
              T* __restrict__ part_cols, int n1, int n2, int bands,
              int strips, int ctiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);
  T* const red = ring + kStages * kTile;               // [d][warp][kCols]
  acc_t* const dred = reinterpret_cast<acc_t*>(red + NDIM * kWarps * kCols);
  const int b = blockIdx.y;
  const int band = blockIdx.x / strips, strip = blockIdx.x - band * strips;
  const int t0 = (int)((long long)strip * ctiles / strips);
  const int t1 = (int)((long long)(strip + 1) * ctiles / strips);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = band * kBand;
  const T* gb = g + (size_t)b * n1 * n2;
  const T* a2b = a2 + (size_t)b * n2 * NDIM;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (t0 + s < t1)
      copy_tile<kAligned>(ring + s * kTile, gb, n1, n2, i0, (t0 + s) * kCols,
                          warp, lane);
    __pipeline_commit();
  }

  T pv[PS];
#pragma unroll
  for (int q = 0; q < PS; ++q) pv[q] = p[(size_t)b * PS + q];
  T ra[kRows][NDIM];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + warp * kRows + r;
#pragma unroll
    for (int k = 0; k < NDIM; ++k)
      ra[r][k] = i < n1 ? a1[((size_t)b * n1 + i) * NDIM + k] : T(0);
  }
  acc_t racc[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) racc[k] = 0.0;
  acc_t dpa[PS];
#pragma unroll
  for (int q = 0; q < PS; ++q) dpa[q] = 0.0;
#if NP > 0
  gt::Dual<T, NP> pd[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    pd[q] = gt::constant<T, NP>(pv[q]);
    pd[q].d[q] = T(1);
  }
#endif

  T c[kVec][NDIM];
  load_cols(c, a2b, t0 * kCols + lane * kVec, n2);
  for (int t = t0; t < t1; ++t) {
    const int it = t - t0;
    if (t + kStages - 1 < t1)
      copy_tile<kAligned>(ring + ((it + kStages - 1) % kStages) * kTile, gb,
                          n1, n2, i0, (t + kStages - 1) * kCols, warp, lane);
    __pipeline_commit();
    T cn[kVec][NDIM];
    load_cols(cn, a2b, (t + 1) * kCols + lane * kVec, n2);
    __pipeline_wait_prior(kStages - 1);  // this thread's share of tile t

    const T* st = ring + (it % kStages) * kTile + warp * kRows * kCols +
                  lane * kVec;
    T rowv[NDIM][kRows];
    T colv[NDIM][kVec];
#pragma unroll
    for (int k = 0; k < NDIM; ++k)
#pragma unroll
      for (int v = 0; v < kVec; ++v) colv[k][v] = T(0);
    T dpt[PS];
#pragma unroll
    for (int q = 0; q < PS; ++q) dpt[q] = T(0);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      T gv[kVec];
      load16(st + r * kCols, gv);
#pragma unroll
      for (int k = 0; k < NDIM; ++k) rowv[k][r] = T(0);
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        T dl[NDIM];
        T r2 = T(0);
#pragma unroll
        for (int k = 0; k < NDIM; ++k) {
          dl[k] = ra[r][k] - c[v][k];
          r2 += dl[k] * dl[k];
        }
        const T w = gv[v] * radial_slope<T>(pv, r2);
#pragma unroll
        for (int k = 0; k < NDIM; ++k) {
          const T wd = w * dl[k];
          rowv[k][r] += wd;
          colv[k][v] += wd;
        }
#if NP > 0
        const gt::Dual<T, NP> kv = radial_value<T, gt::Dual<T, NP>>(pd, r2);
#pragma unroll
        for (int q = 0; q < NP; ++q) dpt[q] += gv[v] * kv.d[q];
#endif
      }
    }
#pragma unroll
    for (int k = 0; k < NDIM; ++k)
      racc[k] += (acc_t)warp_rows_sum(rowv[k], lane);
#pragma unroll
    for (int q = 0; q < PS; ++q) dpa[q] += (acc_t)dpt[q];

    // Columns: the 8 warps' sums, in warp order, one partial a column.
    __syncthreads();  // the previous tile's exchange has been read
#pragma unroll
    for (int k = 0; k < NDIM; ++k)
      put16(red + (k * kWarps + warp) * kCols + lane * kVec, colv[k]);
    __syncthreads();
    const int jt = t * kCols;
    for (int e = tid; e < NDIM * kCols; e += kThreads) {
      const int k = e / kCols, col = e - k * kCols;
      T s = T(0);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[(k * kWarps + w) * kCols + col];
      if (jt + col < n2)
        part_cols[(((size_t)b * bands + band) * NDIM + k) * n2 + jt + col] = s;
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v)
#pragma unroll
      for (int k = 0; k < NDIM; ++k) c[v][k] = cn[v][k];
  }

  // Rows: lanes 4 m hold row m of the warp's 8.
  const int i = i0 + warp * kRows + (lane >> 2);
  if ((lane & 3) == 0 && i < n1) {
#pragma unroll
    for (int k = 0; k < NDIM; ++k)
      part_rows[(((size_t)b * strips + strip) * NDIM + k) * n1 + i] = racc[k];
  }
#if NP > 0
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    acc_t s = dpa[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) dred[warp * PS + q] = s;
  }
  __syncthreads();
  if (tid < NP) {
    acc_t s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += dred[w * PS + tid];
    part_dp[(((size_t)b * bands + band) * strips + strip) * PS + tid] = s;
  }
#else
  (void)part_dp;
  (void)dpa;
  (void)dred;
#endif
}

// dA1, dA2 and dp from the partials.  Grid (rblocks + cblocks + NP, B):
// a block of 32 rows of A1 (the first rblocks) or A2 (the next cblocks),
// its 8 warps over interleaved partials, then the warps in order; or (NP >
// 0) one parameter's dp over the blocks' partials in a fixed tree.
__global__ void __launch_bounds__(kThreads)
cov_bwd_finalize(const acc_t* __restrict__ part_rows,
                 const acc_t* __restrict__ part_dp,
                 const T* __restrict__ part_cols, T* __restrict__ dp,
                 T* __restrict__ da1, T* __restrict__ da2, int n1, int n2,
                 int bands, int strips, int rblocks, int cblocks) {
  __shared__ acc_t red[kThreads * (NDIM > 1 ? NDIM : 1)];
  const int b = blockIdx.y;
  const int x = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (x < rblocks + cblocks) {
    const bool row = x < rblocks;
    const int i = (row ? x : x - rblocks) * 32 + lane;
    const int n = row ? n1 : n2;
    const int parts = row ? strips : bands;
    acc_t s[NDIM];
#pragma unroll
    for (int k = 0; k < NDIM; ++k) s[k] = 0.0;
    if (i < n) {
      for (int c = warp; c < parts; c += kWarps) {
#pragma unroll
        for (int k = 0; k < NDIM; ++k) {
          const size_t at = (((size_t)b * parts + c) * NDIM + k) * n + i;
          s[k] += row ? part_rows[at] : (acc_t)part_cols[at];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NDIM; ++k) red[(warp * 32 + lane) * NDIM + k] = s[k];
    __syncthreads();
    if (warp == 0 && i < n) {
      T* out = (row ? da1 : da2) + ((size_t)b * n + i) * NDIM;
#pragma unroll
      for (int k = 0; k < NDIM; ++k) {
        acc_t t = 0.0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) t += red[(w * 32 + lane) * NDIM + k];
        out[k] = (T)((row ? 2.0 : -2.0) * t);
      }
    }
    return;
  }
  const int q = x - rblocks - cblocks;
  const int nblk = bands * strips;
  acc_t s = 0.0;
  for (int l = tid; l < nblk; l += kThreads)
    s += part_dp[((size_t)b * nblk + l) * PS + q];
  red[tid] = s;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (tid < h) red[tid] += red[tid + h];
    __syncthreads();
  }
  if (tid == 0) dp[(size_t)b * PS + q] = (T)red[0];
}

// The backward's layout for (B, N1, N2) on the current device.
struct Plan {
  int bands, ctiles, strips;
  long long rows, dps, cols;  // words of each partial array
};

// Resident backward blocks on the current device (the SMs times the blocks
// an SM holds), once per device; 0 where the query failed.
int resident_blocks() {
  static int cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0) {
    int sms = 0, per = 0;
    if (cudaFuncSetAttribute(cov_bwd_tiles<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kBwdSmem) != cudaSuccess ||
        cudaFuncSetAttribute(cov_bwd_tiles<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kBwdSmem) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, cov_bwd_tiles<true>, kThreads, kBwdSmem) != cudaSuccess ||
        per < 1)
      return 0;
    cache[dev] = sms * per;
  }
  return cache[dev];
}

// Strips a band: the fewest that keep the `res` resident blocks busy, by
// waves of blocks times the tiles (plus one for the block's own start and
// end) each block walks.
Plan plan(int B, int n1, int n2, long long res) {
  Plan pl;
  pl.bands = (n1 + kBand - 1) / kBand;
  pl.ctiles = (n2 + kCols - 1) / kCols;
  const long long nb = (long long)B * pl.bands;
  long long best = -1;
  pl.strips = 1;
  for (int s = 1; s <= pl.ctiles && s <= 64; ++s) {
    const long long waves = (nb * s + res - 1) / res;
    const long long cost = waves * ((pl.ctiles + s - 1) / s + 1);
    if (best < 0 || cost < best) best = cost, pl.strips = s;
  }
  pl.rows = (long long)B * pl.strips * NDIM * n1;
  pl.dps = (long long)B * pl.bands * pl.strips * PS;
  pl.cols = ((long long)B * pl.bands * NDIM * n2 * (long long)sizeof(T) +
             sizeof(acc_t) - 1) / sizeof(acc_t);
  return pl;
}

bool aligned(const void* ptr, int n2) {
  return n2 % kVec == 0 && ((size_t)ptr & 15) == 0;
}

}  // namespace

extern "C" {

// (NDIM, NP, sizeof(T)) of this instantiation.
void sc_config(int* out) {
  out[0] = NDIM;
  out[1] = NP;
  out[2] = (int)sizeof(T);
}

// The largest N1 and N2 the grids take, and the largest B.
void sc_limits(int* out) {
  out[0] = 2147483647;  // N1: row tiles and bands are folded into gridDim.x
  out[1] = 2147483647;  // N2
  out[2] = 65535;       // B on gridDim.y
}

// Words (acc_t) of the backward's workspace on the current device: the
// row, dp and column partials; -1 where the device query failed.
long long sc_bwd_workspace_words(int B, int n1, int n2) {
  if (B <= 0 || n1 <= 0 || n2 <= 0) return 0;
  const int res = resident_blocks();
  if (res == 0) return -1;
  const Plan pl = plan(B, n1, n2, res);
  return pl.rows + pl.dps + pl.cols;
}

// Grid launches of one backward call.
int sc_bwd_grid_launches(int B, int n1, int n2) {
  return B > 0 && n1 > 0 && n2 > 0 ? 2 : 0;
}

// (bands, strips a band, column tiles, resident blocks) of the backward
// at (B, N1, N2) on the current device.
void sc_bwd_plan(int B, int n1, int n2, int* out) {
  const int res = resident_blocks();
  const Plan pl = plan(B, n1, n2, res > 0 ? res : 1);
  out[0] = pl.bands;
  out[1] = pl.strips;
  out[2] = pl.ctiles;
  out[3] = res;
}

const char* sc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int sc_fwd_launch(const void* p, const void* a1, const void* a2, void* K,
                  int B, int n1, int n2, void* stream) {
  if (B <= 0 || n1 <= 0 || n2 <= 0) return 0;
  const int ctiles = (n2 + kCols - 1) / kCols;
  const long long tiles =
      (long long)((n1 + kFwdRows - 1) / kFwdRows) * ctiles;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (aligned(K, n2))
    cov_fwd<true><<<grid, kThreads, 0, s>>>((const T*)p, (const T*)a1,
                                            (const T*)a2, (T*)K, n1, n2,
                                            ctiles);
  else
    cov_fwd<false><<<grid, kThreads, 0, s>>>((const T*)p, (const T*)a1,
                                             (const T*)a2, (T*)K, n1, n2,
                                             ctiles);
  return (int)cudaGetLastError();
}

int sc_bwd_launch(const void* p, const void* a1, const void* a2,
                  const void* g, void* dp, void* da1, void* da2, void* ws,
                  int B, int n1, int n2, void* stream) {
  if (B <= 0 || n1 <= 0 || n2 <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int res = resident_blocks();
  if (res == 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
  }
  const Plan pl = plan(B, n1, n2, res);
  if ((long long)pl.bands * pl.strips > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  acc_t* part_rows = (acc_t*)ws;
  acc_t* part_dp = part_rows + pl.rows;
  T* part_cols = (T*)(part_dp + pl.dps);
  const dim3 grid(pl.bands * pl.strips, B);
  if (aligned(g, n2))
    cov_bwd_tiles<true><<<grid, kThreads, kBwdSmem, s>>>(
        (const T*)p, (const T*)a1, (const T*)a2, (const T*)g, part_rows,
        part_dp, part_cols, n1, n2, pl.bands, pl.strips, pl.ctiles);
  else
    cov_bwd_tiles<false><<<grid, kThreads, kBwdSmem, s>>>(
        (const T*)p, (const T*)a1, (const T*)a2, (const T*)g, part_rows,
        part_dp, part_cols, n1, n2, pl.bands, pl.strips, pl.ctiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rblocks = (n1 + 31) / 32, cblocks = (n2 + 31) / 32;
  cov_bwd_finalize<<<dim3(rblocks + cblocks + NP, B), kThreads, 0, s>>>(
      part_rows, part_dp, part_cols, (T*)dp, (T*)da1, (T*)da2, n1, n2,
      pl.bands, pl.strips, rblocks, cblocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
