// Batched A B^T for Hopper (sm_90a): O[b] = A[b] . B[b]^T for (B, N, N)
// inputs, in full FP32 (or FP64) on the CUDA cores.
//
// Replaces the two TPU kernels of benchmarks/pallas_batched_mm.py,
// make_chunk (line 75: C chains per grid step, one per-chain dot each) and
// make_batchdim (line 124: C chains per grid step, one batched dot).  Both
// compute this one function, the Schur downdate of the blocked dense
// engine (george_tpu/ops/dense_mxu.py::_mmT, (4096, 128, 128) at
// Precision.HIGHEST).  Here the number of chains a thread block takes, C,
// is a template parameter, so one kernel plays both roles and a benchmark
// can sweep C as the TPU script sweeps its chunk.
//
// What bounds it on the H100: at B = 4096, N = 128 the product is
// 2 B N^3 = 17.2 GFLOP (0.26 ms at the FP32 peak of 67 TFLOP/s) over
// 805 MB (0.24 ms at 3.35 TB/s): operations, barely.  The design is the
// classic shared-memory tiling: a block owns one 64 x 64 output tile of
// C chains in turn; 16-deep K-slices of A's rows and B's rows are staged
// in shared memory (transposed, so that the inner loop reads a row of
// each), and each of its 256 threads accumulates a 4 x 4 sub-tile in
// registers with plain FMAs.  Rows of the sub-tile are 16 apart, so a warp
// reads consecutive words of B's slice and writes consecutive words of O.
// No tensor cores: TF32 would not be the f32-exact product that
// Precision.HIGHEST gave.
//
// Compile-time configuration (nvcc -D):
//   MM_T   scalar type, float or double
// Runtime: C in {1, 8, 32, 64} (the counts tools/batched_mm.py sweeps);
// any N >= 1 (the edges masked).

#include <cuda_runtime.h>
#include <stddef.h>

#ifndef MM_T
#error "define MM_T (float or double)"
#endif

#define MM_TILE 64
#define MM_K 16
#define MM_THREADS 256

namespace gt {
namespace mmT {

typedef MM_T T;

template <int C>
__global__ void __launch_bounds__(MM_THREADS)
mmT_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
           T* __restrict__ O, int nb, int n) {
  // [k][row], padded so that the transposing stores spread over banks.
  __shared__ T As[MM_K][MM_TILE + 1];
  __shared__ T Bs[MM_K][MM_TILE + 1];
  const int tiles = (n + MM_TILE - 1) / MM_TILE;
  const int i0 = (blockIdx.x / tiles) * MM_TILE;
  const int j0 = (blockIdx.x % tiles) * MM_TILE;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t nn = (size_t)n * n;

  for (int c = 0; c < C; ++c) {
    const int b = blockIdx.y * C + c;
    if (b >= nb) break;
    const T* const a = A + (size_t)b * nn;
    const T* const bm = Bm + (size_t)b * nn;
    T acc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][q] = T(0);

    for (int k0 = 0; k0 < n; k0 += MM_K) {
      // 64 rows x 16 columns of each operand, 4 words a thread; sixteen
      // neighbouring threads read sixteen neighbouring words of one row.
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int e = tid + l * MM_THREADS;
        const int r = e / MM_K, kk = e % MM_K;
        const int gk = k0 + kk;
        const int gi = i0 + r, gj = j0 + r;
        As[kk][r] = (gi < n && gk < n) ? a[(size_t)gi * n + gk] : T(0);
        Bs[kk][r] = (gj < n && gk < n) ? bm[(size_t)gj * n + gk] : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < MM_K; ++kk) {
        T ra[4], rb[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) ra[m] = As[kk][ty + 16 * m];
#pragma unroll
        for (int q = 0; q < 4; ++q) rb[q] = Bs[kk][tx + 16 * q];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][q] += ra[m] * rb[q];
      }
      __syncthreads();
    }

    T* const o = O + (size_t)b * nn;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int gi = i0 + ty + 16 * m;
      if (gi >= n) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gj = j0 + tx + 16 * q;
        if (gj < n) o[(size_t)gi * n + gj] = acc[m][q];
      }
    }
  }
}

template <int C>
cudaError_t launch(const T* A, const T* Bm, T* O, int nb, int n,
                   cudaStream_t stream) {
  const int tiles = (n + MM_TILE - 1) / MM_TILE;
  const dim3 grid(tiles * tiles, (nb + C - 1) / C);
  mmT_kernel<C><<<grid, MM_THREADS, 0, stream>>>(A, Bm, O, nb, n);
  return cudaGetLastError();
}

}  // namespace mmT
}  // namespace gt

// ---------------------------------------------------------------------------
// Plain C interface (loaded with ctypes).
// ---------------------------------------------------------------------------

extern "C" {

// out[0] = sizeof(scalar), out[1] = output tile width, out[2] = threads.
void batched_mmT_config(int* out) {
  out[0] = (int)sizeof(gt::mmT::T);
  out[1] = MM_TILE;
  out[2] = MM_THREADS;
}

// Launches on `stream`; returns the CUDA error code (0 on success), or
// cudaErrorInvalidValue for a chain count C the build does not hold.  No
// synchronisation and no allocation: A, B and O (nb, n, n) are the
// caller's.
int batched_mmT_launch(const void* A, const void* Bm, void* O, int nb, int n,
                       int chains_per_block, void* stream) {
  typedef gt::mmT::T T;
  const T* a = (const T*)A;
  const T* b = (const T*)Bm;
  T* o = (T*)O;
  cudaStream_t s = (cudaStream_t)stream;
  switch (chains_per_block) {
    case 1: return (int)gt::mmT::launch<1>(a, b, o, nb, n, s);
    case 8: return (int)gt::mmT::launch<8>(a, b, o, nb, n, s);
    case 32: return (int)gt::mmT::launch<32>(a, b, o, nb, n, s);
    case 64: return (int)gt::mmT::launch<64>(a, b, o, nb, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* batched_mmT_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
