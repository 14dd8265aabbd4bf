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
// What bounds it on the H100: at B = 4096 blocks the call reads S's lower
// triangle and writes T and logdet: 403 MB in float32, 0.1205 ms at
// 3.35 TB/s (float64 0.2410 ms), against ~1.4 MFLOP a chain (0.09 ms at
// the FP32 peak of 67 TFLOP/s), so bytes set the bound.  What sets the
// time is each chain's chain of dependent steps and how many chains an SM
// holds to hide it.  The design (csrc/tile_chol.cuh): one chain per
// thread block of 8 warps, the lower triangle as 36 packed 16 x 16 tiles
// in shared memory (46 KB in float32, 83 KB in float64: four chains an SM
// in float32, two in float64), loaded with 16-byte cp.async copies of
// tile rows; a blocked right-looking Cholesky whose diagonal tiles one
// warp factors and inverts in registers with shuffles, and whose panel
// products and trailing updates are 16 x 16 x 16 products one warp a tile;
// then the blocked inverse in place, 7 block columns.  36 block barriers
// for the factor and inverse, where a column-by-column pair takes 512.
// FMAs on the CUDA cores in both types: the spine's float32 gate is twice
// the plain float32 error, which TF32 would not meet, and its 1.4 MFLOP a
// chain do not need the tensor cores.  The TPU kernel's layout (chains on
// the 128 vector lanes, 8 x 8 Neumann inverses of the diagonal
// sub-blocks) answers the TPU's vector unit and is not carried over.
//
// Compile-time configuration (nvcc -D):
//   SP_T   scalar type, float or double
//
// Layout: S and T are chain-major (B, 128, 128), row-major, contiguous,
// 16-byte aligned; logdet is (B,).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "tile_chol.cuh"

#ifndef SP_T
#error "define SP_T (float or double)"
#endif

#define SP_N 128
#define SP_NB (SP_N / 16)
#define SP_THREADS 256
#define SP_WARPS (SP_THREADS / 32)
static_assert(SP_NB - 1 <= SP_WARPS,
              "tile::factor_invert's inverse takes one warp a tile");

namespace gt {
namespace spine {

typedef SP_T T;
typedef tile::Tile<T> Tl;

// Chains an SM holds at once: the shared memory of one chain sets it.
constexpr int kMinBlocks = sizeof(T) == 4 ? 4 : 2;
// Shared-memory bytes: the packed tiles and the failure flag.
constexpr size_t kSmemBytes =
    (size_t)tile::tri_words<T>(SP_NB) * sizeof(T) + 16;

__global__ void __launch_bounds__(SP_THREADS, kMinBlocks)
spine_kernel(const T* __restrict__ S, T* __restrict__ Tout,
             T* __restrict__ logdet) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const M = reinterpret_cast<T*>(smem_raw);
  int* const flag = reinterpret_cast<int*>(M + tile::tri_words<T>(SP_NB));
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const T* const src = S + (size_t)b * SP_N * SP_N;
  T* const dst = Tout + (size_t)b * SP_N * SP_N;

  // The 36 tiles of the lower triangle (the diagonal tiles whole; their
  // upper halves are never read), each warp whole tiles, each lane 16-byte
  // pieces of tile rows.
  constexpr int kVecs = 16 / Tl::W;  // 16-byte pieces of a tile row
  for (int t = warp, i = 0, j = 0; t < SP_NB * (SP_NB + 1) / 2;
       t += SP_WARPS) {
    while (i * (i + 1) / 2 + j != t) {  // (i, j) of packed index t
      if (++j > i) j = 0, ++i;
    }
    T* const tl = tile::at(M, i, j);
    for (int e = lane; e < 16 * kVecs; e += 32) {
      const int r = e / kVecs, c = (e % kVecs) * Tl::W;
      __pipeline_memcpy_async(tl + r * Tl::LD + c,
                              src + (size_t)(16 * i + r) * SP_N + 16 * j + c,
                              16);
    }
  }
  __pipeline_commit();
  if (tid == 0) *flag = 0;
  __pipeline_wait_prior(0);
  __syncthreads();

  // Cholesky and T = L^-1 over the tiles.  A failed pivot is seen by every
  // thread after one barrier, so the block exits as one.
  T ld;
  if (!tile::factor_invert<T, SP_WARPS>(M, SP_NB, flag, ld)) {
    for (int e = tid; e < SP_N * SP_N; e += SP_THREADS) dst[e] = T(NAN);
    if (tid == 0) logdet[b] = T(NAN);
    return;
  }

  // Out: T row by row, each warp whole rows in 16-byte pieces, zeros above
  // the diagonal.
  constexpr int kRowVecs = SP_N / Tl::W;
  for (int e = tid; e < SP_N * kRowVecs; e += SP_THREADS) {
    const int r = e / kRowVecs, c = (e % kRowVecs) * Tl::W;
    typename Tl::V v;
    T* const out = reinterpret_cast<T*>(&v);
    if (c / 16 <= r / 16) {
      tile::load_vec(tile::at(M, r / 16, c / 16) + (r % 16) * Tl::LD + c % 16,
                     out);
#pragma unroll
      for (int w = 0; w < Tl::W; ++w)
        if (c + w > r) out[w] = T(0);
    } else {
#pragma unroll
      for (int w = 0; w < Tl::W; ++w) out[w] = T(0);
    }
    *reinterpret_cast<typename Tl::V*>(dst + (size_t)r * SP_N + c) = v;
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
// out[0] = block width, out[1] = sizeof(scalar), out[2] = threads a block,
// out[3] = shared-memory bytes a block, out[4] = blocks an SM is built for.
void dense_spine_config(int* out) {
  out[0] = SP_N;
  out[1] = (int)sizeof(gt::spine::T);
  out[2] = SP_THREADS;
  out[3] = (int)gt::spine::kSmemBytes;
  out[4] = gt::spine::kMinBlocks;
}

// Launches B blocks on `stream`; returns the CUDA error code (0 on
// success).  No synchronisation and no allocation: S (B, 128, 128),
// T (B, 128, 128) and logdet (B,) are the caller's.
int dense_spine_launch(const void* S, void* T, void* logdet, int B,
                       void* stream) {
  const size_t smem = gt::spine::kSmemBytes;
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
