// Block-wide Cholesky factor and triangular inverse of one n x n
// symmetric positive-definite matrix held by one thread block, shared by
// csrc/dense_vg.cu (its steps 2 and 3) and csrc/dense_spine.cu.
//
// M is row-major with leading dimension ld (n + 1 in both kernels, so that
// column walks hit distinct banks), in shared or device memory through a
// generic pointer.  Only the lower triangle is read or written.  Every
// thread of the block calls each function with the same arguments.

#ifndef GT_BLOCK_CHOL_CUH
#define GT_BLOCK_CHOL_CUH

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace gt {
namespace block {

// L = chol(M) in place over the lower triangle: right-looking, column by
// column (scale the column, then the trailing update, each warp whole rows
// and each lane the columns lane, lane + 32, ...).  Every thread reads the
// same pivot after a barrier, so the failure test is uniform over the
// block: at the first pivot that is not positive (or is NaN) all threads
// return false, M part-factored.  Otherwise *logdet = sum_k log(pivot_k)
// and the block is synchronised on return.
template <typename T, int THREADS>
__device__ __forceinline__ bool cholesky(T* M, int n, int ld, T* logdet) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  constexpr int WARPS = THREADS / 32;
  T acc = T(0);
  for (int k = 0; k < n; ++k) {
    const T d = M[(size_t)k * ld + k];
    if (!(d > T(0))) return false;
    const T lkk = sqrt(d);
    acc += log(d);
    for (int i = k + 1 + tid; i < n; i += THREADS)
      M[(size_t)i * ld + k] /= lkk;
    __syncthreads();
    if (tid == 0) M[(size_t)k * ld + k] = lkk;
    for (int i = k + 1 + warp; i < n; i += WARPS) {
      const T lik = M[(size_t)i * ld + k];
      for (int j = k + 1 + lane; j <= i; j += 32)
        M[(size_t)i * ld + j] -= lik * M[(size_t)j * ld + k];
    }
    __syncthreads();
  }
  *logdet = acc;
  return true;
}

// S = L^-1 in place over the lower triangle (LAPACK's trti2), column by
// column from the last: S_ij = -S_jj sum_{k=j+1..i} S_ik L_kj, with
// S_jj = 1 / L_jj.  `col` is n words of shared memory (column j of L is
// staged there).  The block is synchronised on return.
template <typename T, int THREADS>
__device__ __forceinline__ void invert_lower(T* M, int n, int ld, T* col) {
  const int tid = threadIdx.x;
  for (int j = n - 1; j >= 0; --j) {
    for (int i = j + 1 + tid; i < n; i += THREADS)
      col[i] = M[(size_t)i * ld + j];
    __syncthreads();
    const T sjj = T(1) / M[(size_t)j * ld + j];
    for (int i = j + 1 + tid; i < n; i += THREADS) {
      // The longest of these dot products (row n - 1) sets the depth of
      // the whole inverse: four partial sums break its dependency chain.
      T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
      const T* row = M + (size_t)i * ld;
      int k = j + 1;
      for (; k + 3 <= i; k += 4) {
        a0 += row[k] * col[k];
        a1 += row[k + 1] * col[k + 1];
        a2 += row[k + 2] * col[k + 2];
        a3 += row[k + 3] * col[k + 3];
      }
      for (; k <= i; ++k) a0 += row[k] * col[k];
      M[(size_t)i * ld + j] = -sjj * ((a0 + a1) + (a2 + a3));
    }
    __syncthreads();
    if (tid == 0) M[(size_t)j * ld + j] = sjj;
  }
  __syncthreads();
}

}  // namespace block
}  // namespace gt

#endif  // GT_BLOCK_CHOL_CUH
