// Batched dense GP log-likelihood with its gradient, for Hopper (sm_90a).
//
// Replaces the TPU kernel george_tpu/ops/pallas_dense.py::_kernel_builder
// (launched through make_dense_batched_vg, pl.pallas_call).  Per chain b,
// with theta_b = [mean | log white noise | kernel parameters]:
//
//   K   = k(theta; X, X) + diag(v + exp(wn)),  r = y - mean
//   ll  = -0.5 (N log 2 pi + log det K + r^T K^-1 r)
//   d ll / d theta_a = 0.5 sum_ij (alpha alpha^T - K^-1)_ij dK_ij / d theta_a
//                      (alpha = K^-1 r; the mean's is sum_i alpha_i)
//
// NaN (ll and gradient) when a Cholesky pivot is not positive; the caller
// maps it to a rejected proposal.  k is the kernel tree, generated per tree
// by george_tpu_torch/dsl/cuda_codegen.py into dense_tree.cuh as
// gt::tree::kernel_value<T, S>; dK is the same function over Dual<T, NA>
// (dual.cuh), whose NA tangents are seeded by the active parameters.
//
// What bounds it on the H100: operations and the latency of their
// dependency chain, not bytes.  A call reads theta (B x D_full) and the
// shared inputs once and writes B x (1 + NA) values, while each chain runs
// an O(N^3) pipeline (N^3/3 Cholesky, N^3/3 inverse, N^3/3 for K^-1) whose
// steps depend on each other.  The design keeps every intermediate of a
// chain inside its thread block: one block per chain, the N x N working
// matrix in shared memory, every step a block-wide loop with
// __syncthreads between dependent steps:
//
//   1. build the lower triangle of K (the generated tree, primal only);
//   2. right-looking Cholesky, column by column (scale, then the trailing
//      update), L over K's lower triangle; log det from the pivots;
//   3. S = L^-1 in place, column by column from the last (LAPACK's trti2);
//      steps 2 and 3 are block_chol.cuh's, shared with dense_spine.cu;
//   4. z = S r, alpha = S^T z, r^T K^-1 r = |z|^2;
//   5. K^-1 = S^T S into the strict upper triangle and a diagonal vector
//      (S stays below, so every entry is one independent dot product);
//   6. the gradient: sum over the lower triangle of the weighted
//      W_ij dK_ij, dK from the dual tree evaluated in place, then a
//      shared-memory tree reduction over the block.
//
// Layout: row-major with leading dimension N + 1 (column walks then hit
// distinct banks).  Shared memory holds the matrix when it fits the
// block's 227 KB (at config #5's widths float32 up to N = 233, float64 up
// to N = 162); beyond that (N = 256 in either type) the matrix lives in a
// per-chain slice of a device-memory workspace the wrapper allocates,
// reached through the same generic pointer, and shared memory holds the
// vectors only.  The TPU kernel's layout (chains on the 128 vector lanes,
// 8-column panels, Neumann inverses of the diagonal blocks, padding to a
// multiple of 8) answers the TPU's vector unit and is not carried over.
//
// Compile-time configuration (nvcc -D):
//   DV_T   scalar type, float or double
//   DV_NA  number of active parameters (tangents)
// and the generated dense_tree.cuh (found on the include path): the tree's
// kernel_value, GT_TREE_NP (its parameters) and GT_TREE_NDIM (input
// dimension).
//
// Runtime description (int32 `meta`, built by george_tpu_torch/ops/dense.py):
//   [n_mean, n_wn, NA, active[NA]], indices into the full parameter vector
//   [mean (n_mean) | log white noise (n_wn) | kernel (GT_TREE_NP)].

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "block_chol.cuh"
#include "dual.cuh"
#include "dense_tree.cuh"

#ifndef DV_T
#error "define DV_T (float or double)"
#endif
#ifndef DV_NA
#error "define DV_NA (number of active parameters)"
#endif

#define DV_THREADS 256
#define DV_WARPS (DV_THREADS / 32)

namespace gt {
namespace dense {

typedef DV_T T;
constexpr int NA = DV_NA;
constexpr int NAR = NA > 0 ? NA : 1;
constexpr int NP = GT_TREE_NP;
constexpr int NDIM = GT_TREE_NDIM;
typedef Dual<T, NA> DT;

// Shared-memory words (of T) besides the matrix: x (n x NDIM), r, noise,
// alpha, z, the K^-1 diagonal (n each), theta (d_full) and the reduction
// buffer (NAR x DV_THREADS).
__host__ __device__ inline size_t vector_words(int n, int d_full) {
  return (size_t)n * NDIM + 5 * (size_t)n + (size_t)d_full +
         (size_t)NAR * DV_THREADS;
}

__host__ __device__ inline size_t matrix_words(int n) {
  return (size_t)n * (size_t)(n + 1);
}

__global__ void __launch_bounds__(DV_THREADS)
dense_vg_kernel(const T* __restrict__ theta, const T* __restrict__ x,
                const T* __restrict__ y, const T* __restrict__ v,
                const int* __restrict__ meta, T* __restrict__ ll,
                T* __restrict__ jac, int B, int n, int d_full, T* ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const s = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  // Loops over a triangle give each warp whole rows and each lane the
  // columns lane, lane + 32, ...: no index arithmetic beyond a stride, and
  // neighbouring lanes on neighbouring words.
  const int warp = tid / 32, lane = tid % 32;
  const int ld = n + 1;

  T* const sx = s;
  T* const sr = sx + (size_t)n * NDIM;
  T* const snoise = sr + n;
  T* const salpha = snoise + n;
  T* const sz = salpha + n;
  T* const skd = sz + n;
  T* const sth = skd + n;
  T* const sred = sth + d_full;
  T* const M = ws ? ws + (size_t)b * matrix_words(n)
                  : sred + (size_t)NAR * DV_THREADS;

  const int n_mean = meta[0];
  const int n_wn = meta[1];
  const int n_scalar = n_mean + n_wn;

  // 0. Inputs into shared memory.
  for (int k = tid; k < d_full; k += DV_THREADS)
    sth[k] = theta[(size_t)b * d_full + k];
  for (int k = tid; k < n * NDIM; k += DV_THREADS) sx[k] = x[k];
  __syncthreads();
  const T mu = n_mean ? sth[0] : T(0);
  const T wn = n_wn ? exp(sth[n_mean]) : T(0);
  for (int i = tid; i < n; i += DV_THREADS) {
    sr[i] = y[i] - mu;
    snoise[i] = v[i] + wn;
  }
  __syncthreads();

  // 1. The lower triangle of K.
  const T* const thk = sth + n_scalar;
  for (int i = warp; i < n; i += DV_WARPS) {
    for (int j = lane; j <= i; j += 32) {
      T k = tree::kernel_value<T, T>(thk, sx + (size_t)i * NDIM,
                                     sx + (size_t)j * NDIM);
      if (i == j) k += snoise[i];
      M[(size_t)i * ld + j] = k;
    }
  }
  __syncthreads();

  // 2. Cholesky (block_chol.cuh); a failed pivot exits the whole block.
  T logdet;
  if (!block::cholesky<T, DV_THREADS>(M, n, ld, &logdet)) {
    if (tid == 0) {
      ll[b] = T(NAN);
      for (int a = 0; a < NA; ++a) jac[(size_t)a * B + b] = T(NAN);
    }
    return;
  }

  // 3. S = L^-1 in place (block_chol.cuh), column j of L staged in sz.
  block::invert_lower<T, DV_THREADS>(M, n, ld, sz);

  // 4. z = S r, then alpha = S^T z.
  for (int i = tid; i < n; i += DV_THREADS) {
    T acc = T(0);
    const T* row = M + (size_t)i * ld;
    for (int k = 0; k <= i; ++k) acc += row[k] * sr[k];
    sz[i] = acc;
  }
  __syncthreads();
  for (int k = tid; k < n; k += DV_THREADS) {
    T acc = T(0);
    for (int i = k; i < n; ++i) acc += M[(size_t)i * ld + k] * sz[i];
    salpha[k] = acc;
  }

  // 5. K^-1 = S^T S: (i <= j) sum_{k >= j} S_ki S_kj, into the strict upper
  // triangle (row i, column j) and the diagonal vector.
  for (int i = warp; i < n; i += DV_WARPS) {
    for (int j = i + lane; j < n; j += 32) {
      T acc = T(0);
      for (int k = j; k < n; ++k)
        acc += M[(size_t)k * ld + i] * M[(size_t)k * ld + j];
      if (i == j)
        skd[i] = acc;
      else
        M[(size_t)i * ld + j] = acc;
    }
  }
  __syncthreads();

  // 6. The gradient over the lower triangle: weight 1/2 on the diagonal,
  // 1 off it (W and dK are symmetric).
  DT thd[NP > 0 ? NP : 1];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    thd[p] = constant<T, NA>(thk[p]);
#pragma unroll
    for (int a = 0; a < NA; ++a)
      if (meta[3 + a] == n_scalar + p) thd[p].d[a] = T(1);
  }
  DT wnd = constant<T, NA>(wn);
#pragma unroll
  for (int a = 0; a < NA; ++a)
    if (n_wn && meta[3 + a] == n_mean) wnd.d[a] = wn;
  T acc[NAR];
#pragma unroll
  for (int a = 0; a < NAR; ++a) acc[a] = T(0);
  for (int i = warp; i < n; i += DV_WARPS) {
    for (int j = lane; j <= i; j += 32) {
      const T kinv = i == j ? skd[i] : M[(size_t)j * ld + i];
      const T w = (i == j ? T(0.5) : T(1)) * (salpha[i] * salpha[j] - kinv);
      DT dk = tree::kernel_value<T, DT>(thd, sx + (size_t)i * NDIM,
                                        sx + (size_t)j * NDIM);
      if (i == j) dk = dk + wnd;
#pragma unroll
      for (int a = 0; a < NA; ++a) acc[a] += w * dk.d[a];
    }
  }
#pragma unroll
  for (int a = 0; a < NA; ++a) sred[a * DV_THREADS + tid] = acc[a];
  __syncthreads();
  for (int stride = DV_THREADS / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int a = 0; a < NA; ++a)
        sred[a * DV_THREADS + tid] += sred[a * DV_THREADS + tid + stride];
    }
    __syncthreads();
  }

  if (tid == 0) {
    T quad = T(0), sum_alpha = T(0);
    for (int i = 0; i < n; ++i) {
      quad += sz[i] * sz[i];
      sum_alpha += salpha[i];
    }
    ll[b] = T(-0.5) * (T(n) * T(1.8378770664093453) + logdet + quad);
    for (int a = 0; a < NA; ++a)
      jac[(size_t)a * B + b] =
          (n_mean && meta[3 + a] == 0) ? sum_alpha : sred[a * DV_THREADS];
  }
}

}  // namespace dense
}  // namespace gt

// ---------------------------------------------------------------------------
// Plain C interface (loaded with ctypes).
// ---------------------------------------------------------------------------

extern "C" {

// Compile-time configuration of this build, for the caller to verify:
// out[0] = NA, out[1] = the tree's parameter count, out[2] = its input
// dimension, out[3] = sizeof(scalar), out[4] = threads per block.
void dense_vg_config(int* out) {
  out[0] = gt::dense::NA;
  out[1] = gt::dense::NP;
  out[2] = gt::dense::NDIM;
  out[3] = (int)sizeof(gt::dense::T);
  out[4] = DV_THREADS;
}

// Dynamic shared memory of one block, in bytes, with (with_matrix = 1) or
// without the N x (N + 1) matrix.
long long dense_vg_smem_bytes(int n, int d_full, int with_matrix) {
  size_t words = gt::dense::vector_words(n, d_full);
  if (with_matrix) words += gt::dense::matrix_words(n);
  return (long long)(words * sizeof(gt::dense::T));
}

// The most dynamic shared memory a block may have on the current device.
int dense_vg_max_smem(void) {
  int dev = 0, value = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return value;
}

// Words of device workspace per chain when the matrix does not fit in
// shared memory (the caller passes ws = NULL when it does).
long long dense_vg_workspace_words(int n) {
  return (long long)gt::dense::matrix_words(n);
}

// Launches on `stream`; returns the CUDA error code (0 on success).  No
// synchronisation and no allocation: ll (B,), jac (NA, B) and ws (B x
// matrix words, or NULL) are the caller's.
int dense_vg_launch(const void* theta, const void* x, const void* y,
                    const void* v, const void* meta, void* ll, void* jac,
                    int B, int n, int d_full, void* ws, void* stream) {
  const size_t smem =
      (size_t)dense_vg_smem_bytes(n, d_full, ws == NULL ? 1 : 0);
  cudaError_t err = cudaFuncSetAttribute(
      gt::dense::dense_vg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gt::dense::dense_vg_kernel<<<B, DV_THREADS, smem, (cudaStream_t)stream>>>(
      (const gt::dense::T*)theta, (const gt::dense::T*)x,
      (const gt::dense::T*)y, (const gt::dense::T*)v, (const int*)meta,
      (gt::dense::T*)ll, (gt::dense::T*)jac, B, n, d_full,
      (gt::dense::T*)ws);
  return (int)cudaGetLastError();
}

const char* dense_vg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
