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
//     dA1_i = 2 (rowsum_i(W) a1_i - sum_j W_ij a2_j)
//     dA2_j = 2 (colsum_j(W) a2_j - sum_i W_ij a1_i).
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
// What bounds it.  The forward writes N1 N2 entries and reads O(N d):
// bytes, 1.07 GB of float32 output at N = 16384 (0.32 ms at 3.35 TB/s);
// its ~3d + radial operations per entry are far under the FP32 rate.  The
// backward reads g once in each of its two passes.
//
// Design.
//  * Forward: one 64 x 64 output tile per block of 64 x 4 threads.  The
//    tile's 64 rows of A1 are staged in shared memory; each thread holds
//    its column's a2 in registers and walks 16 rows, so a warp writes 32
//    consecutive entries of a row of K (coalesced).  r2 comes from exact
//    differences, never from |a|^2 + |b|^2 - 2ab, which is not exact at
//    coincident points.  Ragged edges are masked; nothing is padded.
//  * Backward: no W is stored; each pass recomputes r2 and the radial.
//    - Row pass (dA1, dp): a block of 32 x 8 threads owns 32 rows and a
//      chunk of SC_CHUNK columns; lane tx walks columns tx, tx + 32, ...
//      (reads of g coalesced) and warp ty keeps rows ty + 8r, r < 4.  Each
//      thread accumulates rowsum(W), W @ A2 and the dp tangents for its
//      rows in double; the block reduces them over its 32 lanes in shared
//      memory in a fixed order and writes one partial per (chunk, row) and
//      one dp partial per block.  The W @ A2 contraction is done here, in
//      the kernel's body.
//    - Column pass (dA2): a block of 32 x 8 threads owns 32 columns and a
//      chunk of SC_CHUNK rows; lane tx keeps column tx (reads of g
//      coalesced along the row), warp ty walks rows ty, ty + 8, ...; the 8
//      warps' partials are summed in a fixed order.  g is read in place:
//      no transposed copy.
//    - Finalize: one thread per row of A1 and per row of A2 sums the
//      chunks' partials in chunk order and forms dA1 / dA2; a second small
//      kernel (NP > 0) sums the dp partials of the row pass, one block per
//      (batch, parameter), in a fixed tree.
//    No float atomics anywhere: the result is the same bit for bit from
//    run to run.  A backward is 3 launches (4 where NP > 0).

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
#define NACC (1 + NDIM)

// Forward tile.
#define F_ROWS 64
#define F_COLS 64
#define F_TY 4
// Backward blocks: 32 lanes x 8 warps; rows (row pass) or columns (column
// pass) per block, and the length of the walked chunk.
#define B_TX 32
#define B_TY 8
#define B_RPT 4
#define B_ROWS (B_TY * B_RPT)
#define SC_CHUNK 1024

namespace {

using gt::radial::radial_slope;
using gt::radial::radial_value;

__device__ __forceinline__ T r2_of(const T* a, const T* b) {
  T r2 = T(0);
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    const T d = a[k] - b[k];
    r2 += d * d;
  }
  return r2;
}

__global__ void __launch_bounds__(F_COLS * F_TY)
cov_fwd(const T* __restrict__ p, const T* __restrict__ a1,
        const T* __restrict__ a2, T* __restrict__ K, int n1, int n2) {
  __shared__ T s1[F_ROWS * NDIM];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * F_ROWS;
  const int j = blockIdx.x * F_COLS + threadIdx.x;
  const int tid = threadIdx.y * F_COLS + threadIdx.x;
  const T* a1b = a1 + (size_t)b * n1 * NDIM;
  for (int t = tid; t < F_ROWS * NDIM; t += F_COLS * F_TY) {
    const int i = i0 + t / NDIM;
    s1[t] = i < n1 ? a1b[(size_t)i0 * NDIM + t] : T(0);
  }
  T pv[PS];
#pragma unroll
  for (int q = 0; q < PS; ++q) pv[q] = p[(size_t)b * PS + q];
  T c[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k)
    c[k] = j < n2 ? a2[((size_t)b * n2 + j) * NDIM + k] : T(0);
  __syncthreads();
  if (j >= n2) return;
  T* Kb = K + (size_t)b * n1 * n2;
  for (int r = threadIdx.y; r < F_ROWS; r += F_TY) {
    const int i = i0 + r;
    if (i >= n1) break;
    const T r2 = r2_of(s1 + r * NDIM, c);
    Kb[(size_t)i * n2 + j] = radial_value<T, T>(pv, r2);
  }
}

// One entry's contributions: W = g k'(r2) and, for NP > 0, g dk/dp.
struct Entry {
  T w;
  T dp[PS];
};

__device__ __forceinline__ Entry entry(const T* pv, T r2, T gij) {
  Entry e;
  e.w = gij * radial_slope<T>(pv, r2);
#if NP > 0
  gt::Dual<T, NP> pd[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    pd[q] = gt::constant<T, NP>(pv[q]);
    pd[q].d[q] = T(1);
  }
  const gt::Dual<T, NP> k = radial_value<T, gt::Dual<T, NP>>(pd, r2);
#pragma unroll
  for (int q = 0; q < NP; ++q) e.dp[q] = gij * k.d[q];
#else
  e.dp[0] = T(0);
#endif
  return e;
}

// Row pass: partial rowsum(W) and W @ A2 per (column chunk, row), and dp
// per block.  Grid (column chunks, row blocks, B).
__global__ void __launch_bounds__(B_TX * B_TY)
cov_bwd_rows(const T* __restrict__ p, const T* __restrict__ a1,
             const T* __restrict__ a2, const T* __restrict__ g,
             acc_t* __restrict__ part_rows, acc_t* __restrict__ part_dp,
             int n1, int n2) {
  __shared__ acc_t red[B_TX * B_TY * (NACC > PS ? NACC : PS)];
  const int b = blockIdx.z;
  const int chunk = blockIdx.x, nchunk = gridDim.x;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * B_ROWS;
  const int jend = min(n2, (chunk + 1) * SC_CHUNK);
  T pv[PS];
#pragma unroll
  for (int q = 0; q < PS; ++q) pv[q] = p[(size_t)b * PS + q];
  T ra[B_RPT][NDIM];
  acc_t acc[B_RPT][NACC];
  acc_t dp[PS];
#pragma unroll
  for (int q = 0; q < PS; ++q) dp[q] = 0.0;
#pragma unroll
  for (int r = 0; r < B_RPT; ++r) {
    const int i = i0 + ty + B_TY * r;
#pragma unroll
    for (int k = 0; k < NDIM; ++k)
      ra[r][k] = i < n1 ? a1[((size_t)b * n1 + i) * NDIM + k] : T(0);
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[r][k] = 0.0;
  }
  const T* gb = g + (size_t)b * n1 * n2;
  for (int j = chunk * SC_CHUNK + tx; j < jend; j += B_TX) {
    T c[NDIM];
#pragma unroll
    for (int k = 0; k < NDIM; ++k)
      c[k] = a2[((size_t)b * n2 + j) * NDIM + k];
#pragma unroll
    for (int r = 0; r < B_RPT; ++r) {
      const int i = i0 + ty + B_TY * r;
      if (i < n1) {
        const Entry e = entry(pv, r2_of(ra[r], c), gb[(size_t)i * n2 + j]);
        acc[r][0] += (acc_t)e.w;
#pragma unroll
        for (int k = 0; k < NDIM; ++k) acc[r][1 + k] += (acc_t)e.w * c[k];
#pragma unroll
        for (int q = 0; q < NP; ++q) dp[q] += (acc_t)e.dp[q];
      }
    }
  }
  // Sum over the 32 lanes, row by row, in lane order.
  const int tid = ty * B_TX + tx;
#pragma unroll
  for (int r = 0; r < B_RPT; ++r) {
#pragma unroll
    for (int k = 0; k < NACC; ++k) red[tid * NACC + k] = acc[r][k];
    __syncthreads();
    const int i = i0 + ty + B_TY * r;
    for (int k = tx; k < NACC; k += B_TX) {
      acc_t s = 0.0;
      for (int l = 0; l < B_TX; ++l) s += red[(ty * B_TX + l) * NACC + k];
      if (i < n1)
        part_rows[(((size_t)b * nchunk + chunk) * n1 + i) * NACC + k] = s;
    }
    __syncthreads();
  }
#if NP > 0
#pragma unroll
  for (int q = 0; q < NP; ++q) red[tid * NP + q] = dp[q];
  __syncthreads();
  if (tid < NP) {
    acc_t s = 0.0;
    for (int l = 0; l < B_TX * B_TY; ++l) s += red[l * NP + tid];
    const size_t blk = (size_t)blockIdx.y * nchunk + chunk;
    const size_t nblk = (size_t)gridDim.y * nchunk;
    part_dp[((size_t)b * nblk + blk) * NP + tid] = s;
  }
#else
  (void)part_dp;
  (void)dp;
#endif
}

// Column pass: partial colsum(W) and W^T @ A1 per (row chunk, column).
// Grid (column blocks, row chunks, B).
__global__ void __launch_bounds__(B_TX * B_TY)
cov_bwd_cols(const T* __restrict__ p, const T* __restrict__ a1,
             const T* __restrict__ a2, const T* __restrict__ g,
             acc_t* __restrict__ part_cols, int n1, int n2) {
  __shared__ acc_t red[B_TX * B_TY * NACC];
  const int b = blockIdx.z;
  const int chunk = blockIdx.y, nchunk = gridDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * B_TX + tx;
  const int iend = min(n1, (chunk + 1) * SC_CHUNK);
  T pv[PS];
#pragma unroll
  for (int q = 0; q < PS; ++q) pv[q] = p[(size_t)b * PS + q];
  T c[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k)
    c[k] = j < n2 ? a2[((size_t)b * n2 + j) * NDIM + k] : T(0);
  acc_t acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.0;
  const T* gb = g + (size_t)b * n1 * n2;
  if (j < n2) {
    for (int i = chunk * SC_CHUNK + ty; i < iend; i += B_TY) {
      T ra[NDIM];
#pragma unroll
      for (int k = 0; k < NDIM; ++k)
        ra[k] = a1[((size_t)b * n1 + i) * NDIM + k];
      const Entry e = entry(pv, r2_of(ra, c), gb[(size_t)i * n2 + j]);
      acc[0] += (acc_t)e.w;
#pragma unroll
      for (int k = 0; k < NDIM; ++k) acc[1 + k] += (acc_t)e.w * ra[k];
    }
  }
  const int tid = ty * B_TX + tx;
#pragma unroll
  for (int k = 0; k < NACC; ++k) red[tid * NACC + k] = acc[k];
  __syncthreads();
  // Sum over the 8 warps, in warp order.
  for (int t = tid; t < B_TX * NACC; t += B_TX * B_TY) {
    const int l = t / NACC, k = t % NACC;
    const int jj = blockIdx.x * B_TX + l;
    acc_t s = 0.0;
    for (int w = 0; w < B_TY; ++w) s += red[(w * B_TX + l) * NACC + k];
    if (jj < n2)
      part_cols[(((size_t)b * nchunk + chunk) * n2 + jj) * NACC + k] = s;
  }
}

// dA1 and dA2 from the chunk partials: one thread per row of A1 or A2.
// Grid (ceil((n1 + n2) / 256), B).
__global__ void __launch_bounds__(256)
cov_bwd_finalize(const T* __restrict__ a1, const T* __restrict__ a2,
                 const acc_t* __restrict__ part_rows,
                 const acc_t* __restrict__ part_cols, T* __restrict__ da1,
                 T* __restrict__ da2, int n1, int n2, int nchunk_rows,
                 int nchunk_cols) {
  const int b = blockIdx.y;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n1 + n2) return;
  const bool row = o < n1;
  const int i = row ? o : o - n1;
  const int n = row ? n1 : n2;
  const int nchunk = row ? nchunk_rows : nchunk_cols;
  const acc_t* part = row ? part_rows : part_cols;
  const T* a = (row ? a1 : a2) + ((size_t)b * n + i) * NDIM;
  T* out = (row ? da1 : da2) + ((size_t)b * n + i) * NDIM;
  acc_t s[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) s[k] = 0.0;
  for (int c = 0; c < nchunk; ++c) {
    const acc_t* q = part + (((size_t)b * nchunk + c) * n + i) * NACC;
#pragma unroll
    for (int k = 0; k < NACC; ++k) s[k] += q[k];
  }
#pragma unroll
  for (int k = 0; k < NDIM; ++k)
    out[k] = (T)(2.0 * (s[0] * (acc_t)a[k] - s[1 + k]));
}

// dp from the row pass's per-block partials: one block per (parameter,
// batch), a strided sum per thread and a fixed tree over the block.
__global__ void __launch_bounds__(256)
cov_bwd_dp(const acc_t* __restrict__ part_dp, T* __restrict__ dp,
           int nblk) {
  __shared__ acc_t red[256];
  const int q = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  acc_t s = 0.0;
  for (int l = t; l < nblk; l += 256)
    s += part_dp[((size_t)b * nblk + l) * PS + q];
  red[t] = s;
  __syncthreads();
  for (int h = 128; h > 0; h >>= 1) {
    if (t < h) red[t] += red[t + h];
    __syncthreads();
  }
  if (t == 0) dp[(size_t)b * PS + q] = (T)red[0];
}

int row_chunks(int n2) { return (n2 + SC_CHUNK - 1) / SC_CHUNK; }
int row_blocks(int n1) { return (n1 + B_ROWS - 1) / B_ROWS; }
int col_blocks(int n2) { return (n2 + B_TX - 1) / B_TX; }
int col_chunks(int n1) { return (n1 + SC_CHUNK - 1) / SC_CHUNK; }

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
  out[0] = 65535 * B_ROWS;   // N1: row blocks on gridDim.y
  out[1] = 2147483647;       // N2: column tiles on gridDim.x
  out[2] = 65535;            // B on gridDim.z / gridDim.y
}

// Words (acc_t) of the backward's workspace: the row and column partials
// and the dp partials.
long long sc_bwd_workspace_words(int B, int n1, int n2) {
  const long long rows = (long long)B * row_chunks(n2) * n1 * NACC;
  const long long cols = (long long)B * col_chunks(n1) * n2 * NACC;
  const long long dps = (long long)B * row_chunks(n2) * row_blocks(n1) * PS;
  return rows + cols + dps;
}

const char* sc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int sc_fwd_launch(const void* p, const void* a1, const void* a2, void* K,
                  int B, int n1, int n2, void* stream) {
  if (B <= 0 || n1 <= 0 || n2 <= 0) return 0;
  const dim3 grid((n2 + F_COLS - 1) / F_COLS, (n1 + F_ROWS - 1) / F_ROWS, B);
  cov_fwd<<<grid, dim3(F_COLS, F_TY), 0, (cudaStream_t)stream>>>(
      (const T*)p, (const T*)a1, (const T*)a2, (T*)K, n1, n2);
  return (int)cudaGetLastError();
}

int sc_bwd_launch(const void* p, const void* a1, const void* a2,
                  const void* g, void* dp, void* da1, void* da2, void* ws,
                  int B, int n1, int n2, void* stream) {
  if (B <= 0 || n1 <= 0 || n2 <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = row_chunks(n2), rb = row_blocks(n1);
  const int cb = col_blocks(n2), cc = col_chunks(n1);
  acc_t* part_rows = (acc_t*)ws;
  acc_t* part_cols = part_rows + (size_t)B * rc * n1 * NACC;
  acc_t* part_dp = part_cols + (size_t)B * cc * n2 * NACC;
  cov_bwd_rows<<<dim3(rc, rb, B), dim3(B_TX, B_TY), 0, s>>>(
      (const T*)p, (const T*)a1, (const T*)a2, (const T*)g, part_rows,
      part_dp, n1, n2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cov_bwd_cols<<<dim3(cb, cc, B), dim3(B_TX, B_TY), 0, s>>>(
      (const T*)p, (const T*)a1, (const T*)a2, (const T*)g, part_cols, n1,
      n2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cov_bwd_finalize<<<dim3((n1 + n2 + 255) / 256, B), 256, 0, s>>>(
      (const T*)a1, (const T*)a2, part_rows, part_cols, (T*)da1, (T*)da2, n1,
      n2, rc, cc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (NP > 0) {
    cov_bwd_dp<<<dim3(PS, B), 256, 0, s>>>(part_dp, (T*)dp, rc * rb);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // extern "C"
