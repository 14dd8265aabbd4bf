// Batched A B^T for Hopper (sm_90a): O[b] = A[b] . B[b]^T for (B, N, N)
// inputs, float32 to float32 accuracy on the tensor cores (3xTF32), float64
// in FP64 FMAs.
//
// Replaces the two TPU kernels of benchmarks/pallas_batched_mm.py,
// make_chunk (line 75: C chains per grid step, one per-chain dot each) and
// make_batchdim (line 124: C chains per grid step, one batched dot).  Both
// compute this one function, the Schur downdate of the blocked dense
// engine (george_tpu/ops/dense_mxu.py::_mmT, (4096, 128, 128) at
// Precision.HIGHEST).  Here the number of chains a thread block takes in
// turn, C, is a template parameter, so one kernel plays both roles and a
// benchmark can sweep C as the TPU script sweeps its chunk.
//
// What bounds it on the H100: at B = 4096, N = 128 the product is
// 2 B N^3 = 17.2 GFLOP over 805 MB in float32.  On the CUDA cores that is
// 0.26 ms at the FP32 peak of 67 TFLOP/s against 0.24 ms for the bytes at
// 3.35 TB/s, and an FP32-FMA design of this tiling (8 x 8 a thread) ran
// behind torch.matmul.  So float32 runs on the tensor cores as three TF32
// products, the split of CUTLASS's 3xTF32 and the H100's counterpart of
// Precision.HIGHEST's multi-pass bf16 on the TPU: each operand
// x = hi + lo with hi = x rounded to TF32 and lo = x - hi, and
// a b = hi.hi + hi.lo + lo.hi within ~2^-21 |a| |b|.  Three passes of
// 17.2 GFLOP at the TF32 peak of 495 TFLOP/s take 0.10 ms, so the bytes
// set the bound.  Each 8-deep step's three products go into a zeroed
// fragment on the tensor core and that fragment into the FP32 accumulator
// on the CUDA cores, so the tensor core's own accumulation never spans
// more than one step.  An infinite input gives NaN (its lo is inf - inf).
// float64 runs in FP64 FMAs, an 8 x 8 sub-tile a thread.
//
// The shared tiling: a block owns one output tile of 128 x 128 (a whole
// chain at N = 128); the operands arrive as K-slices (32 words in float32,
// 16 in float64) through a three-stage ring of 16-byte cp.async copies, so
// the copy of slice s + 2 overlaps the products of slice s.  The ring runs
// across the C chains of a block, so the next chain's first slices load
// while the last products of this one run.  Where C chains a block leave
// fewer than two blocks an SM, the tile shrinks to 64 x 64 so that the
// grid still covers the card.
//
// Compile-time configuration (nvcc -D):
//   MM_T   scalar type, float or double
// Runtime: C in {1, 8, 32, 64} (the counts tools/batched_mm.py sweeps);
// any N >= 1 (the edges zero-filled on the way in and masked on the way
// out; 16-byte copies where N is a multiple of 16 bytes' worth, word
// copies otherwise).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#ifndef MM_T
#error "define MM_T (float or double)"
#endif

#define MM_THREADS 256
#define MM_STAGES 3

namespace gt {
namespace mmT {

typedef MM_T T;

constexpr int kVec = 16 / sizeof(T);             // words in 16 bytes
constexpr int kBK = sizeof(T) == 4 ? 32 : 16;    // K-slice (words)
constexpr int kLD = kBK + kVec;                  // padded slice row

// -- float64: FP64 FMAs, an MI x MI sub-tile a thread -------------------------
//
// Thread (tx, ty) of 16 x 16 holds rows ty + 16 i and columns tx + 16 j, so
// that a warp's reads of B's rows hit distinct banks (kLD = 4 banks apart)
// and its writes are runs of 16 words; the inner loop reads 16-byte
// vectors of both operands' rows.
template <int MI>
struct FmaCore {
  static constexpr int TS = 16 * MI;
  static constexpr int kMinBlocks = MI == 4 ? 2 : 1;
  T acc[MI][MI];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < MI; ++j) acc[i][j] = T(0);
  }

  static __device__ __forceinline__ void load16(const T* p, T* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int w = 0; w < kVec; ++w) out[w] = e[w];
  }

  __device__ __forceinline__ void slice(const T* as, const T* bs) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int k = 0; k < kBK; k += kVec) {
      T a[MI][kVec];
#pragma unroll
      for (int i = 0; i < MI; ++i) load16(as + (ty + 16 * i) * kLD + k, a[i]);
#pragma unroll
      for (int j = 0; j < MI; ++j) {
        T b[kVec];
        load16(bs + (tx + 16 * j) * kLD + k, b);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int w = 0; w < kVec; ++w)
            acc[i][j] = fma(a[i][w], b[w], acc[i][j]);
      }
    }
  }

  // The tile's entries into o (rows and columns below n), then zero.
  __device__ __forceinline__ void flush(T* o, int i0, int j0, int n) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int gi = i0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < MI; ++j) {
        const int gj = j0 + tx + 16 * j;
        if (gi < n && gj < n) o[(size_t)gi * n + gj] = acc[i][j];
        acc[i][j] = T(0);
      }
    }
  }
};

// -- float32: 3xTF32 on mma.sync.m16n8k8 --------------------------------------

// d += a b over one m16n8k8 step (PTX fragment layouts: a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, n g),
// b1 (k t + 4, n g); d0, d1 (g, 2t and 2t + 1), d2, d3 (g + 8, ...);
// g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b over one m16n8k8 step (the accumulator operand zero).
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
}

// The 8 warps as 2 x 4, each a (TS / 2) x (TS / 4) warp tile of MT x NT
// m16n8 fragments.  Shared-memory rows are kLD = 36 words, so the
// fragment reads (row g, column t) hit 32 distinct banks.
template <int TS_>
struct Tf32x3Core {
  static constexpr int TS = TS_;
  static constexpr int MT = TS / 32, NT = TS / 32;
  static constexpr int kMinBlocks = TS == 64 ? 4 : 2;
  float acc[MT][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
  }

  // x = hi + lo: hi is x rounded to TF32's 10 mantissa bits (to nearest,
  // ties away: cvt.rna's rounding, in two integer operations where the
  // conversion instruction's rate set the kernel's time), lo = x - hi
  // exactly, which the tensor core cuts to TF32 (an error of at most
  // 2^-22 |x|; the dropped lo.lo term is at most 2^-22 |a| |b|).
  static __device__ __forceinline__ void split(float x, uint32_t& hi,
                                               uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }

  // One K-slice, 8 deep at a time.  B's fragments of the warp tile are
  // split once a step and kept; A's one m16 fragment at a time, so that
  // the live registers stay under the 128 that two blocks an SM allow.
  __device__ __forceinline__ void slice(const float* as, const float* bs) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const float* const wa = as + ((warp >> 2) * (TS / 2) + g) * kLD + t;
    const float* const wb = bs + ((warp & 3) * (TS / 4) + g) * kLD + t;
#pragma unroll 1
    for (int k = 0; k < kBK; k += 8) {
      uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          split(wb[8 * j * kLD + k + 4 * e], bhi[j][e], blo[j][e]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(wa[(16 * m + 8 * (e & 1)) * kLD + k + 4 * (e >> 1)], ahi[e],
                alo[e]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float d[4];
          mma_tf32_zero(d, alo, bhi[j]);
          mma_tf32(d, ahi, blo[j]);
          mma_tf32(d, ahi, bhi[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] += d[e];
        }
      }
    }
  }

  __device__ __forceinline__ void flush(float* o, int i0, int j0, int n) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = i0 + (warp >> 2) * (TS / 2) + (lane >> 2);
    const int c = j0 + (warp & 3) * (TS / 4) + 2 * (lane & 3);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gi = r + 16 * m + 8 * h, gj = c + 8 * j;
          float* const p = o + (size_t)gi * n + gj;
          const float v0 = acc[m][j][2 * h], v1 = acc[m][j][2 * h + 1];
          if (gi < n && gj + 1 < n && n % 2 == 0) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else if (gi < n && gj < n) {
            p[0] = v0;
            if (gj + 1 < n) p[1] = v1;
          }
          acc[m][j][2 * h] = acc[m][j][2 * h + 1] = 0.0f;
        }
  }
};

// The core of each scalar type and tile width (128 or 64).
template <typename S, int TS> struct CoreOf;
template <int TS> struct CoreOf<float, TS> { typedef Tf32x3Core<TS> type; };
template <int TS> struct CoreOf<double, TS> {
  typedef FmaCore<TS / 16> type;
};

template <class Core>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)MM_STAGES * 2 * Core::TS * kLD * sizeof(T);
}

// -- the kernel ---------------------------------------------------------------

// Columns k0 .. k0 + kBK of the tile's rows i0 + r of a and j0 + r of b
// (one chain's (n, n) matrices) into the stage's as and bs, in pieces of
// STEP words (16 bytes, or one word where rows do not start on 16 bytes);
// pieces out of range are zero-filled without a read.
template <int TS, int STEP>
__device__ __forceinline__ void copy_slice(T* as, T* bs, const T* a,
                                           const T* b, int k0, int i0,
                                           int j0, int n) {
  constexpr int kPerRow = kBK / STEP;
  constexpr size_t kBytes = STEP * sizeof(T);
#pragma unroll 1
  for (int e = threadIdx.x; e < TS * kPerRow; e += MM_THREADS) {
    const int r = e / kPerRow, k = k0 + (e % kPerRow) * STEP;
    const bool ain = k < n && i0 + r < n, bin = k < n && j0 + r < n;
    const int d = r * kLD + k - k0;
    __pipeline_memcpy_async(as + d, ain ? a + (size_t)(i0 + r) * n + k : a,
                            kBytes, ain ? 0 : kBytes);
    __pipeline_memcpy_async(bs + d, bin ? b + (size_t)(j0 + r) * n + k : b,
                            kBytes, bin ? 0 : kBytes);
  }
}

template <int C, class Core>
__global__ void __launch_bounds__(MM_THREADS, Core::kMinBlocks)
mmT_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
           T* __restrict__ O, int nb, int n, int vec) {
  constexpr int TS = Core::TS;  // output tile side
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const As = reinterpret_cast<T*>(smem_raw);   // [stage][TS][kLD]
  T* const Bs = As + MM_STAGES * TS * kLD;        // [stage][TS][kLD]
  const int tiles = (n + TS - 1) / TS;
  const int i0 = (blockIdx.x / tiles) * TS;
  const int j0 = (blockIdx.x % tiles) * TS;
  const int c0 = blockIdx.y * C;
  const int nk = (n + kBK - 1) / kBK;
  const int items = min(C, nb - c0) * nk;  // (chain, K-slice) pairs
  const int tid = threadIdx.x;
  const size_t nn = (size_t)n * n;

  // Item t (chain c0 + t / nk, K-slice t % nk) goes to stage
  // t % MM_STAGES; `ic`, `ik` walk the items fetched, `cc`, `ck` those
  // computed.
  int ic = 0, ik = 0;
  auto fetch = [&]() {
    const int s = (ic * nk + ik) % MM_STAGES;
    T* const as = As + s * TS * kLD;
    T* const bs = Bs + s * TS * kLD;
    const T* const a = A + (size_t)(c0 + ic) * nn;
    const T* const b = Bm + (size_t)(c0 + ic) * nn;
    if (vec)
      copy_slice<TS, kVec>(as, bs, a, b, ik * kBK, i0, j0, n);
    else
      copy_slice<TS, 1>(as, bs, a, b, ik * kBK, i0, j0, n);
    if (++ik == nk) ik = 0, ++ic;
  };

#pragma unroll
  for (int s = 0; s < MM_STAGES - 1; ++s) {
    if (s < items) fetch();
    __pipeline_commit();
  }

  Core core;
  core.zero();
  for (int t = 0, cc = 0, ck = 0; t < items; ++t) {
    __pipeline_wait_prior(MM_STAGES - 2);
    // Slice t has landed for every thread, and every thread is done with
    // the stage that item t + MM_STAGES - 1 refills.
    __syncthreads();
    if (t + MM_STAGES - 1 < items) fetch();
    __pipeline_commit();
    core.slice(As + (t % MM_STAGES) * TS * kLD,
               Bs + (t % MM_STAGES) * TS * kLD);
    if (++ck == nk) {  // the chain's last slice: write its tile
      core.flush(O + (size_t)(c0 + cc) * nn, i0, j0, n);
      ck = 0, ++cc;
    }
  }
}

template <int C, int TS>
cudaError_t launch(const T* A, const T* Bm, T* O, int nb, int n, int vec,
                   cudaStream_t stream) {
  typedef typename CoreOf<T, TS>::type Core;
  const size_t smem = smem_bytes<Core>();
  cudaError_t err = cudaFuncSetAttribute(
      mmT_kernel<C, Core>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + TS - 1) / TS;
  const dim3 grid(tiles * tiles, (nb + C - 1) / C);
  mmT_kernel<C, Core><<<grid, MM_THREADS, smem, stream>>>(A, Bm, O, nb, n,
                                                           vec);
  return cudaGetLastError();
}

// The 128-wide tile where the grid it gives fills two blocks an SM, else
// the 64-wide one.
template <int C>
cudaError_t launch_c(const T* A, const T* Bm, T* O, int nb, int n, int vec,
                     cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long tiles = (n + 127) / 128;
  const long blocks = tiles * tiles * ((nb + C - 1) / C);
  return blocks >= 2L * sms ? launch<C, 128>(A, Bm, O, nb, n, vec, stream)
                            : launch<C, 64>(A, Bm, O, nb, n, vec, stream);
}

}  // namespace mmT
}  // namespace gt

// ---------------------------------------------------------------------------
// Plain C interface (loaded with ctypes).
// ---------------------------------------------------------------------------

extern "C" {

// out[0] = sizeof(scalar), out[1] = widest output tile, out[2] = threads,
// out[3] and out[4] = shared-memory bytes a block with the 128-wide and
// with the 64-wide tile.
void batched_mmT_config(int* out) {
  using namespace gt::mmT;
  out[0] = (int)sizeof(T);
  out[1] = 128;
  out[2] = MM_THREADS;
  out[3] = (int)smem_bytes<CoreOf<T, 128>::type>();
  out[4] = (int)smem_bytes<CoreOf<T, 64>::type>();
}

// Launches on `stream`; returns the CUDA error code (0 on success), or
// cudaErrorInvalidValue for a chain count C the build does not hold.  No
// synchronisation and no allocation: A, B and O (nb, n, n) are the
// caller's; `vec` (16-byte copies) needs n a multiple of 16 / sizeof(T)
// and A and B 16-byte aligned.
int batched_mmT_launch(const void* A, const void* Bm, void* O, int nb, int n,
                       int chains_per_block, int vec, void* stream) {
  typedef gt::mmT::T T;
  const T* a = (const T*)A;
  const T* b = (const T*)Bm;
  T* o = (T*)O;
  cudaStream_t s = (cudaStream_t)stream;
  switch (chains_per_block) {
    case 1: return (int)gt::mmT::launch_c<1>(a, b, o, nb, n, vec, s);
    case 8: return (int)gt::mmT::launch_c<8>(a, b, o, nb, n, vec, s);
    case 32: return (int)gt::mmT::launch_c<32>(a, b, o, nb, n, vec, s);
    case 64: return (int)gt::mmT::launch_c<64>(a, b, o, nb, n, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* batched_mmT_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
