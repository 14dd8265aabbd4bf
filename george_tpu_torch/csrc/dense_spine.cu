// The spine of the blocked dense engine, for Hopper (sm_90a): per chain,
// the Cholesky factor, its inverse and the log-determinant of one
// 128 x 128 symmetric positive-definite block.
//
// Replaces the TPU kernel george_tpu/ops/dense_mxu.py::_spine_kernel
// (launched through _spine, pl.pallas_call).  For each chain b:
//
//   L = chol(S_b)   (lower; only the lower triangle of S_b is read)
//   T_b = L^-1      (lower, the upper triangle written as zero)
//   logdet_b = sum_k log(d_k),  d_k the k-th pivot (L_kk^2)
//
// A pivot that is not positive (or is NaN) makes that chain's T and
// logdet NaN, as the reference's log and 1/sqrt of such a pivot do; other
// chains are unaffected.
//
// What bounds it on the H100: at B = 4096 blocks in float32 the call reads
// S's lower triangle (135 MB) and writes T and logdet (268 MB): 0.12 ms at
// 3.35 TB/s, for ~1.4 MFLOP a chain (0.09 ms at 67 TFLOP/s), so bytes set
// the bound; in practice the time is the depth of each chain's dependent
// steps (128 pivots, each followed by a block-wide barrier, and a
// triangular inverse whose longest row is a chain of 127 multiply-adds).
// The design keeps a whole chain in one thread block: the block in shared
// memory with leading dimension 129 (column walks hit distinct banks;
// float32 66 KB, float64 132 KB), the column-by-column right-looking
// Cholesky and the in-place inverse of block_chol.cuh (shared with
// csrc/dense_vg.cu), one coalesced read of the lower triangle and one
// coalesced write of the block.  The TPU kernel's layout (chains on the
// 128 vector lanes, 8 x 8 Neumann inverses of the diagonal sub-blocks,
// block substitution in a fori_loop) answers the TPU's vector unit and is
// not carried over.
//
// Compile-time configuration (nvcc -D):
//   SP_T   scalar type, float or double
//
// Layout: S and T are chain-major (B, 128, 128), row-major, contiguous;
// logdet is (B,).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "block_chol.cuh"

#ifndef SP_T
#error "define SP_T (float or double)"
#endif

#define SP_N 128
#define SP_LD (SP_N + 1)
#define SP_THREADS 256
#define SP_WARPS (SP_THREADS / 32)

namespace gt {
namespace spine {

typedef SP_T T;

// Shared-memory words: the block (SP_N x SP_LD) and one column buffer.
constexpr size_t kSmemWords = (size_t)SP_N * SP_LD + SP_N;

__global__ void __launch_bounds__(SP_THREADS)
spine_kernel(const T* __restrict__ S, T* __restrict__ Tout,
             T* __restrict__ logdet) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const M = reinterpret_cast<T*>(smem_raw);
  T* const col = M + (size_t)SP_N * SP_LD;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const T* const src = S + (size_t)b * SP_N * SP_N;
  T* const dst = Tout + (size_t)b * SP_N * SP_N;

  // The lower triangle of S, each warp whole rows (nothing reads above it).
  for (int i = warp; i < SP_N; i += SP_WARPS)
    for (int j = lane; j <= i; j += 32)
      M[i * SP_LD + j] = src[(size_t)i * SP_N + j];
  __syncthreads();

  // 1. Cholesky and 2. T = L^-1 in place (block_chol.cuh).  A failed pivot
  // is seen by every thread, so the block exits as one.
  T ld;
  if (!block::cholesky<T, SP_THREADS>(M, SP_N, SP_LD, &ld)) {
    for (int e = tid; e < SP_N * SP_N; e += SP_THREADS) dst[e] = T(NAN);
    if (tid == 0) logdet[b] = T(NAN);
    return;
  }
  block::invert_lower<T, SP_THREADS>(M, SP_N, SP_LD, col);

  // 3. Out: the lower triangle of T, zeros above it.
  for (int e = tid; e < SP_N * SP_N; e += SP_THREADS) {
    const int i = e / SP_N, j = e % SP_N;
    dst[e] = j <= i ? M[i * SP_LD + j] : T(0);
  }
  if (tid == 0) logdet[b] = ld;
}

}  // namespace spine
}  // namespace gt

// ---------------------------------------------------------------------------
// Plain C interface (loaded with ctypes).
// ---------------------------------------------------------------------------

extern "C" {

// Compile-time configuration of this build, for the caller to verify:
// out[0] = block width, out[1] = sizeof(scalar), out[2] = threads a block.
void dense_spine_config(int* out) {
  out[0] = SP_N;
  out[1] = (int)sizeof(gt::spine::T);
  out[2] = SP_THREADS;
}

// Launches B blocks on `stream`; returns the CUDA error code (0 on
// success).  No synchronisation and no allocation: S (B, 128, 128),
// T (B, 128, 128) and logdet (B,) are the caller's.
int dense_spine_launch(const void* S, void* T, void* logdet, int B,
                       void* stream) {
  const size_t smem = gt::spine::kSmemWords * sizeof(gt::spine::T);
  cudaError_t err = cudaFuncSetAttribute(
      gt::spine::spine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gt::spine::spine_kernel<<<B, SP_THREADS, smem, (cudaStream_t)stream>>>(
      (const gt::spine::T*)S, (gt::spine::T*)T, (gt::spine::T*)logdet);
  return (int)cudaGetLastError();
}

const char* dense_spine_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
