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
// chain inside its thread block (one block a chain, of 8 warps up to
// N = 128 and 16 above) and works on 16 x 16 tiles, each tile operation
// one warp's (csrc/tile_chol.cuh):
//
//   0. N padded to n_pad = 16 ceil(N / 16) (nb = n_pad / 16 <= 16 tiles a
//      side) with the identity: K_pad = diag(K, I), r_pad = 0, so that the
//      log-determinant, z, alpha and the real block of K^-1 do not change;
//   1. the lower tiles of K_pad, one warp a tile (the generated tree,
//      primal only; noise on the diagonal, the identity on the padding);
//   2. tile::factor_invert: the blocked Cholesky and T = L^-1 in place,
//      the diagonal tiles factored and inverted in one warp's registers;
//      log det from the pivots;
//   3. z = T r (one warp a tile-row) and alpha = T^T z (one warp a
//      tile-column), each finished by a warp reduction; r^T K^-1 r = |z|^2;
//   4. tile::gram: K^-1 = T^T T in place over the tiles, in LAPACK's
//      xLAUUM order, one warp a tile;
//   5. the gradient over the lower tiles, one warp a tile, padding skipped:
//      W_ij = alpha_i alpha_j - K^-1_ij (weight 1/2 on the diagonal) times
//      dK_ij from the dual tree, then a warp and a block reduction.
//
// Block barriers a chain: 46 at N = 128 (nb = 8, 8 warps: 36 for the
// factor and inverse, 6 for T^T T), 90 at N = 256 (nb = 16, 16 warps: 76
// and 10); a column-by-column Cholesky and inverse take two a pivot and
// two a column, 512 and 1024.
//
// Layout: the packed lower tiles (tile_chol.cuh: 1280 bytes a tile in
// float32, 2304 in float64) live in shared memory wherever they and the
// vectors fit a block's 227 KB: at config #5's widths every N <= 256 in
// float32 (136 tiles, 174 KB), N <= 208 in float64 (91 tiles, 205 KB).
// Beyond that (float64, N = 209 to 256) they live in a per-chain slice of a
// device-memory workspace the wrapper allocates (each slice a multiple of
// 16 bytes), reached by the same code through the generic pointer, and
// shared memory holds the vectors only.  The TPU kernel's layout (chains on
// the 128 vector lanes, 8-column panels, Neumann inverses of the diagonal
// blocks) answers the TPU's vector unit and is not carried over; its
// padding (to a multiple of 8, with the identity) is, to 16.
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

#include "dual.cuh"
#include "dense_tree.cuh"
#include "tile_chol.cuh"

#ifndef DV_T
#error "define DV_T (float or double)"
#endif
#ifndef DV_NA
#error "define DV_NA (number of active parameters)"
#endif

// Warps a block: 8 up to N = 128 (four float32 chains an SM at config #5's
// widths), 16 above (one chain an SM holds N = 256's 136 tiles in float32:
// twice the warps to share them).  Each measured faster on its side of
// the switch (PERF.md, section 6).  tile::factor_invert needs
// nb - 1 <= warps (one warp a tile of a column of the inverse), which
// dense_vg_launch checks.
#define DV_WARPS 8
#define DV_WARPS_WIDE 16
#define DV_THREADS (DV_WARPS * 32)

namespace gt {
namespace dense {

typedef DV_T T;
constexpr int NA = DV_NA;
constexpr int NAR = NA > 0 ? NA : 1;
constexpr int NP = GT_TREE_NP;
constexpr int NDIM = GT_TREE_NDIM;
constexpr int LD = tile::Tile<T>::LD;
typedef Dual<T, NA> DT;

__host__ __device__ inline int tiles_a_side(int n) { return (n + 15) / 16; }

__host__ __device__ inline int warps_for(int n) {
  return tiles_a_side(n) <= 8 ? DV_WARPS : DV_WARPS_WIDE;
}

// Shared-memory words (of T) besides the tiles: x (n_pad x NDIM), r, z,
// alpha (n_pad each), theta (d_full), the block reduction (NAR x warps)
// and the failure flag (one word).
__host__ __device__ inline size_t vector_words(int n, int d_full) {
  const size_t np = 16 * (size_t)tiles_a_side(n);
  return np * (NDIM + 3) + (size_t)d_full + (size_t)NAR * warps_for(n) + 1;
}

__host__ __device__ inline size_t matrix_words(int n) {
  return (size_t)tile::tri_words<T>(tiles_a_side(n));
}

// (i, j) of the lower tile t + step from (i, j) of tile t, in row-major
// order over the packed lower triangle (from i = 0, j = t, step 0: tile t).
__device__ __forceinline__ void next_tile(int& i, int& j, int step) {
  j += step;
  while (j > i) j -= ++i;
}

template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
dense_vg_kernel(const T* __restrict__ theta, const T* __restrict__ x,
                const T* __restrict__ y, const T* __restrict__ v,
                const int* __restrict__ meta, T* __restrict__ ll,
                T* __restrict__ jac, int B, int n, int d_full, T* ws) {
  constexpr int THREADS = WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const s = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nb = tiles_a_side(n), np = 16 * nb;
  const int tiles = nb * (nb + 1) / 2;

  T* const M = ws ? ws + (size_t)b * matrix_words(n) : s;
  T* const sx = ws ? s : s + matrix_words(n);
  T* const sr = sx + (size_t)np * NDIM;
  T* const sz = sr + np;
  T* const salpha = sz + np;
  T* const sth = salpha + np;
  T* const sred = sth + d_full;
  int* const flag = reinterpret_cast<int*>(sred + NAR * WARPS);

  const int n_mean = meta[0];
  const int n_wn = meta[1];
  const int n_scalar = n_mean + n_wn;

  // 0. Inputs into shared memory, zero on the padding.
  for (int k = tid; k < d_full; k += THREADS)
    sth[k] = theta[(size_t)b * d_full + k];
  for (int k = tid; k < np * NDIM; k += THREADS)
    sx[k] = k < n * NDIM ? x[k] : T(0);
  if (tid == 0) *flag = 0;
  __syncthreads();
  const T mu = n_mean ? sth[0] : T(0);
  const T wn = n_wn ? exp(sth[n_mean]) : T(0);
  for (int i = tid; i < np; i += THREADS) sr[i] = i < n ? y[i] - mu : T(0);

  // 1. The lower tiles of K_pad, one warp a tile; zeros above the diagonal
  // of the diagonal tiles.
  const T* const thk = sth + n_scalar;
  {
    int i = 0, j = warp;
    next_tile(i, j, 0);
    for (int t = warp; t < tiles; t += WARPS, next_tile(i, j, WARPS)) {
      T* const tl = tile::at(M, i, j);
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = e & 15;
        const int gi = 16 * i + r, gj = 16 * j + c;
        T k;
        if (i == j && c > r) {
          k = T(0);
        } else if (gi >= n || gj >= n) {
          k = T(gi == gj);
        } else {
          k = tree::kernel_value<T, T>(thk, sx + (size_t)gi * NDIM,
                                       sx + (size_t)gj * NDIM);
          if (gi == gj) k += v[gi] + wn;
        }
        tl[r * LD + c] = k;
      }
    }
  }
  __syncthreads();

  // 2. Cholesky and T = L^-1 over the tiles.  A failed pivot is seen by
  // every thread after one barrier, so the block exits as one.
  T logdet;
  if (!tile::factor_invert<T, WARPS>(M, nb, flag, logdet)) {
    if (tid == 0) {
      ll[b] = T(NAN);
      for (int a = 0; a < NA; ++a) jac[(size_t)a * B + b] = T(NAN);
    }
    return;
  }

  // 3. z = T r, one warp a tile-row: lane (r, h) sums row r's columns
  // 8h .. 8h + 7 of each tile, the two halves added by a shuffle.
  {
    const int r = lane & 15, h = lane >> 4;
    for (int i = warp; i < nb; i += WARPS) {
      T acc = T(0);
      for (int k = 0; k <= i; ++k) {
        const T* const row = tile::at(M, i, k) + r * LD + 8 * h;
        const T* const rk = sr + 16 * k + 8 * h;
        T a[8];
        tile::load4(row, a);
        tile::load4(row + 4, a + 4);
#pragma unroll
        for (int q = 0; q < 8; ++q) acc = fma(a[q], rk[q], acc);
      }
      acc += __shfl_xor_sync(tile::kFull, acc, 16);
      if (h == 0) sz[16 * i + r] = acc;
    }
  }
  __syncthreads();
  // alpha = T^T z, one warp a tile-column: lane (c, h) sums column c over
  // rows {0-3, 8-11} (h = 0) or {4-7, 12-15} (h = 1) of each tile, so that
  // the two half-warps read distinct banks.
  {
    const int c = lane & 15, h = lane >> 4;
    for (int k = warp; k < nb; k += WARPS) {
      T acc = T(0);
      for (int i = k; i < nb; ++i) {
        const T* const tl = tile::at(M, i, k);
        const T* const zi = sz + 16 * i;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int row = (q & 3) + 8 * (q >> 2) + 4 * h;
          acc = fma(tl[row * LD + c], zi[row], acc);
        }
      }
      acc += __shfl_xor_sync(tile::kFull, acc, 16);
      if (h == 0) salpha[16 * k + c] = acc;
    }
  }

  // 4. K^-1 = T^T T in place (its first barrier orders the reads of T
  // above before any tile is overwritten; it returns synchronised).
  tile::gram<T, WARPS>(M, nb);

  // 5. The gradient over the lower tiles: weight 1/2 on the diagonal, 1 off
  // it (W and dK are symmetric); the padding skipped.
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
  {
    int i = 0, j = warp;
    next_tile(i, j, 0);
    for (int t = warp; t < tiles; t += WARPS, next_tile(i, j, WARPS)) {
      const T* const tl = tile::at(M, i, j);
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = e & 15;
        const int gi = 16 * i + r, gj = 16 * j + c;
        if (gi >= n || gj >= n || (i == j && c > r)) continue;
        const T w = (gi == gj ? T(0.5) : T(1)) *
                    (salpha[gi] * salpha[gj] - tl[r * LD + c]);
        DT dk = tree::kernel_value<T, DT>(thd, sx + (size_t)gi * NDIM,
                                          sx + (size_t)gj * NDIM);
        if (gi == gj) dk = dk + wnd;
#pragma unroll
        for (int a = 0; a < NA; ++a) acc[a] = fma(w, dk.d[a], acc[a]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[a] += __shfl_xor_sync(tile::kFull, acc[a], o);
    if (lane == 0) sred[a * WARPS + warp] = acc[a];
  }
  __syncthreads();

  if (tid == 0) {
    T quad = T(0), sum_alpha = T(0);
    for (int i = 0; i < n; ++i) {
      quad += sz[i] * sz[i];
      sum_alpha += salpha[i];
    }
    ll[b] = T(-0.5) * (T(n) * T(1.8378770664093453) + logdet + quad);
    for (int a = 0; a < NA; ++a) {
      T g = T(0);
      for (int w = 0; w < WARPS; ++w) g += sred[a * WARPS + w];
      jac[(size_t)a * B + b] = (n_mean && meta[3 + a] == 0) ? sum_alpha : g;
    }
  }
}

template <int WARPS>
int launch(const void* theta, const void* x, const void* y, const void* v,
           const void* meta, void* ll, void* jac, int B, int n, int d_full,
           void* ws, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dense_vg_kernel<WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dense_vg_kernel<WARPS><<<B, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const T*)theta, (const T*)x, (const T*)y, (const T*)v,
      (const int*)meta, (T*)ll, (T*)jac, B, n, d_full, (T*)ws);
  return (int)cudaGetLastError();
}

}  // namespace dense
}  // namespace gt

// ---------------------------------------------------------------------------
// Plain C interface (loaded with ctypes).
// ---------------------------------------------------------------------------

extern "C" {

// Compile-time configuration of this build, for the caller to verify:
// out[0] = NA, out[1] = the tree's parameter count, out[2] = its input
// dimension, out[3] = sizeof(scalar), out[4] = threads per block up to
// N = 128 (twice that above).
void dense_vg_config(int* out) {
  out[0] = gt::dense::NA;
  out[1] = gt::dense::NP;
  out[2] = gt::dense::NDIM;
  out[3] = (int)sizeof(gt::dense::T);
  out[4] = DV_THREADS;
}

// Dynamic shared memory of one block, in bytes, with (with_matrix = 1) or
// without the packed tiles.
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

// Words of device workspace per chain when the tiles do not fit in shared
// memory (the caller passes ws = NULL when they do): a multiple of 16
// bytes, so that every chain's slice of a 16-byte-aligned workspace is.
long long dense_vg_workspace_words(int n) {
  return (long long)gt::dense::matrix_words(n);
}

// Launches on `stream`; returns the CUDA error code (0 on success).  No
// synchronisation and no allocation: ll (B,), jac (NA, B) and ws (B x
// workspace words, 16-byte aligned, or NULL) are the caller's.
int dense_vg_launch(const void* theta, const void* x, const void* y,
                    const void* v, const void* meta, void* ll, void* jac,
                    int B, int n, int d_full, void* ws, void* stream) {
  if (n < 1 || n > 256 ||
      gt::dense::tiles_a_side(n) - 1 > gt::dense::warps_for(n))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)dense_vg_smem_bytes(n, d_full, ws == NULL ? 1 : 0);
  return gt::dense::warps_for(n) == DV_WARPS
             ? gt::dense::launch<DV_WARPS>(theta, x, y, v, meta, ll, jac, B,
                                           n, d_full, ws, smem, stream)
             : gt::dense::launch<DV_WARPS_WIDE>(theta, x, y, v, meta, ll,
                                                jac, B, n, d_full, ws, smem,
                                                stream);
}

const char* dense_vg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
