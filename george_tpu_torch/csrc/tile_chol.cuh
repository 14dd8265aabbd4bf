// Tiled Cholesky factor, triangular inverse and Gram product T^T T of one
// symmetric positive-definite matrix of up to 16 x 16 tiles (N <= 256)
// held by one thread block, for Hopper (sm_90a).  Used by
// csrc/dense_spine.cu (factor and inverse at N = 128) and csrc/dense_vg.cu
// (all three, at N = 16 to 256).
//
// The matrix lives as its lower triangle of 16 x 16 tiles, packed: tile
// (i, j), i >= j, at index i (i + 1) / 2 + j, each tile row-major with a
// padded row (Tile<T>::LD words: 20 in float32, 18 in float64, so that the
// warps' 16-byte row reads below hit distinct banks), in shared memory or,
// through the same generic pointer, in device memory (16-byte aligned).
// The whole algorithm is tile operations, each done by one warp:
//
//   diag       the 16 x 16 diagonal tile factored and inverted in registers
//              with warp shuffles (no block barrier): L_jj, T_jj = L_jj^-1,
//              the log-pivots, and the failure test;
//   nt/nn/tn   a 16 x 16 x 16 product, C (+/-)= A B^T, C += A B or
//              C += A^T B, from 16-byte (tn: 16- and 8-byte) shared-memory
//              reads and FMAs in registers.
//
// factor_invert() runs a blocked right-looking Cholesky over the nb panels
// (per panel: L_ij = A_ij T_jj^T, then the trailing update
// A_ik -= L_ij L_kj^T of the next panel's column, then the next diagonal
// tile on one warp while the others finish the update; three block
// barriers a panel), then the blocked inverse in place, column by column
// from the right: T_ij = -(sum_{k=j+1..i} T_ik L_kj) T_jj, one warp a tile
// of the column (so nb - 1 <= warps; two barriers a column).  gram() then
// forms T^T T over the same tiles in place (a barrier a round of one tile
// a warp).  At N = 128 (nb = 8, 8 warps) the factor and inverse take 36
// block barriers, where a column-by-column Cholesky and inverse take two a
// pivot and two a column, 512.  Every thread of the block calls each
// function with the same arguments.

#ifndef GT_TILE_CHOL_CUH
#define GT_TILE_CHOL_CUH

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace gt {
namespace tile {

constexpr int kSide = 16;                // tile side
constexpr unsigned kFull = 0xffffffffu;  // all lanes of a warp

// Per scalar type: the 16-byte vector, its width, the padded row (LD) and
// the reciprocal square root of a pivot, on the diagonal tiles' critical
// path (in float32 rsqrtf and one Newton step, shorter than an IEEE
// square root and division; in float64 CUDA's rsqrt, within 1 ulp).
template <typename T> struct Tile;
template <> struct Tile<float> {
  typedef float4 V;
  static constexpr int W = 4;
  static constexpr int LD = 20;
  static __device__ __forceinline__ float inv_sqrt(float d) {
    const float y = rsqrtf(d);
    return y * fmaf(-0.5f * d * y, y, 1.5f);
  }
};
template <> struct Tile<double> {
  typedef double2 V;
  static constexpr int W = 2;
  static constexpr int LD = 18;
  static __device__ __forceinline__ double inv_sqrt(double d) {
    return rsqrt(d);
  }
};

// Words of one padded tile, and of the packed lower triangle of nb x nb
// tiles (a multiple of 16 bytes in both types).
template <typename T>
__host__ __device__ constexpr int tile_words() {
  return kSide * Tile<T>::LD;
}
template <typename T>
__host__ __device__ constexpr int tri_words(int nb) {
  return nb * (nb + 1) / 2 * tile_words<T>();
}

template <typename T>
__device__ __forceinline__ T* at(T* M, int i, int j) {
  return M + (size_t)(i * (i + 1) / 2 + j) * tile_words<T>();
}

// W consecutive words from 16-byte-aligned shared memory.
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, T* out) {
  typedef typename Tile<T>::V V;
  const V v = *reinterpret_cast<const V*>(p);
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int w = 0; w < Tile<T>::W; ++w) out[w] = e[w];
}

// Four consecutive words (16 bytes in float32, 32 in float64).
template <typename T>
__device__ __forceinline__ void load4(const T* p, T* out) {
#pragma unroll
  for (int w = 0; w < 4; w += Tile<T>::W) load_vec(p + w, out + w);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const T* in) {
  typedef typename Tile<T>::V V;
#pragma unroll
  for (int w = 0; w < 4; w += Tile<T>::W) {
    V v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int u = 0; u < Tile<T>::W; ++u) e[u] = in[w + u];
    *reinterpret_cast<V*>(p + w) = v;
  }
}

// -- the 16 x 16 x 16 products ------------------------------------------------
//
// A lane holds 8 entries of the result: rows r0 and r0 + 8 (r0 = lane / 4)
// and four columns.  In the NT form (B read by rows) the columns are
// cg, cg + 4, cg + 8, cg + 12 (cg = lane % 4), in the NN form (B read by
// columns) 4 cg .. 4 cg + 3, so that both read shared memory in 16-byte
// vectors without bank conflicts.

// acc[a][q] += sum_k A[r0 + 8a][k] B[cg + 4q][k].
template <typename T>
__device__ __forceinline__ void nt(T (&acc)[2][4], const T* A, const T* B,
                                   int lane) {
  constexpr int LD = Tile<T>::LD, W = Tile<T>::W;
  const int r0 = lane >> 2, cg = lane & 3;
#pragma unroll
  for (int k = 0; k < kSide; k += W) {
    T a[2][W];
    load_vec(A + r0 * LD + k, a[0]);
    load_vec(A + (r0 + 8) * LD + k, a[1]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      T b[W];
      load_vec(B + (cg + 4 * q) * LD + k, b);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        acc[0][q] = fma(a[0][w], b[w], acc[0][q]);
        acc[1][q] = fma(a[1][w], b[w], acc[1][q]);
      }
    }
  }
}

// acc[a][q] += sum_k A[r0 + 8a][k] B[k][4 cg + q].
template <typename T>
__device__ __forceinline__ void nn(T (&acc)[2][4], const T* A, const T* B,
                                   int lane) {
  constexpr int LD = Tile<T>::LD, W = Tile<T>::W;
  const int r0 = lane >> 2, cg = lane & 3;
#pragma unroll
  for (int k = 0; k < kSide; k += W) {
    T a[2][W];
    load_vec(A + r0 * LD + k, a[0]);
    load_vec(A + (r0 + 8) * LD + k, a[1]);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      T b[4];
      load4(B + (k + w) * LD + 4 * cg, b);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[0][q] = fma(a[0][w], b[q], acc[0][q]);
        acc[1][q] = fma(a[1][w], b[q], acc[1][q]);
      }
    }
  }
}

// The NT layout's 8 entries out: C = acc, or C -= acc.
template <typename T, bool SUB>
__device__ __forceinline__ void put_nt(T* C, const T (&acc)[2][4], int lane) {
  constexpr int LD = Tile<T>::LD;
  const int r0 = lane >> 2, cg = lane & 3;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      T& c = C[(r0 + 8 * a) * LD + cg + 4 * q];
      c = SUB ? c - acc[a][q] : acc[a][q];
    }
}

// The NN layout's 8 entries, out, times s.
template <typename T>
__device__ __forceinline__ void put_nn(T* C, const T (&acc)[2][4], T s,
                                       int lane) {
  constexpr int LD = Tile<T>::LD;
  const int r0 = lane >> 2, cg = lane & 3;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    T v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = s * acc[a][q];
    store4(C + (r0 + 8 * a) * LD + 4 * cg, v);
  }
}

// Two consecutive words (8 bytes in float32, 16 in float64), from and to
// memory aligned to their size.
template <typename T> struct Pair;
template <> struct Pair<float> { typedef float2 V; };
template <> struct Pair<double> { typedef double2 V; };

template <typename T>
__device__ __forceinline__ void load2(const T* p, T* out) {
  const typename Pair<T>::V v = *reinterpret_cast<const typename Pair<T>::V*>(p);
  out[0] = v.x;
  out[1] = v.y;
}

template <typename T>
__device__ __forceinline__ void store2(T* p, T a, T b) {
  typename Pair<T>::V v;
  v.x = a;
  v.y = b;
  *reinterpret_cast<typename Pair<T>::V*>(p) = v;
}

// The TN form: a lane holds rows 4 rg .. 4 rg + 3 (rg = lane / 8) and
// columns 2 cp, 2 cp + 1 (cp = lane % 8) of the result, so that it reads
// A's row k in one 16-byte piece (four of C's rows) and B's row k in one
// pair; all 32 lanes read within one row of each tile, without bank
// conflicts.  acc[t][u] += sum_k A[k][4 rg + t] B[k][2 cp + u].
template <typename T>
__device__ __forceinline__ void tn(T (&acc)[4][2], const T* A, const T* B,
                                   int lane) {
  constexpr int LD = Tile<T>::LD;
  const int rg = lane >> 3, cp = lane & 7;
#pragma unroll
  for (int k = 0; k < kSide; ++k) {
    T a[4], b[2];
    load4(A + k * LD + 4 * rg, a);
    load2(B + k * LD + 2 * cp, b);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      acc[t][0] = fma(a[t], b[0], acc[t][0]);
      acc[t][1] = fma(a[t], b[1], acc[t][1]);
    }
  }
}

// The TN layout's 8 entries out: C = acc.
template <typename T>
__device__ __forceinline__ void put_tn(T* C, const T (&acc)[4][2],
                                       int lane) {
  constexpr int LD = Tile<T>::LD;
  const int rg = lane >> 3, cp = lane & 7;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    store2(C + (4 * rg + t) * LD + 2 * cp, acc[t][0], acc[t][1]);
}

// -- the diagonal tile --------------------------------------------------------
//
// One warp factors the tile D (only its lower triangle is read) and writes
// T = L^-1 over it (lower, exact zeros above).  A lane holds rows 2 r0 and
// 2 r0 + 1 (r0 = lane / 4) and columns 4 cg .. 4 cg + 3 (cg = lane % 4) of
// the matrix being factored (a) and of the inverse being built (x), so
// that every shuffle below reads one register index on every lane.  Pivot
// p: L_pp = sqrt(a_pp), column p of L scaled from a, the rank-1 update of
// a (entries at or above the pivot row or column become scratch, never
// read again as data), and the same step of the forward substitution
// L x = I: row p of x divided by L_pp, then subtracted from the rows below
// it.  Adds the sum of log(a_pp) over the pivots to `logdet`.  Returns
// false (on every lane) if a pivot is not positive or is NaN; D is then
// part-written.
template <typename T>
__device__ __forceinline__ bool diag(T* D, int lane, T& logdet) {
  constexpr int LD = Tile<T>::LD;
  const int r0 = lane >> 2, cg = lane & 3;
  T a[2][4], x[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    load4(D + (2 * r0 + h) * LD + 4 * cg, a[h]);
#pragma unroll
    for (int q = 0; q < 4; ++q) x[h][q] = T(2 * r0 + h == 4 * cg + q);
  }
  bool ok = true;
  T dp = T(1);  // pivot `lane` (lanes 0..15), for one log each at the end
#pragma unroll
  for (int p = 0; p < kSide; ++p) {
    // a_pp lives on lane 4 (p / 2) + p / 4 at [p % 2][p % 4]; column p of
    // this lane's rows on lane 4 r0 + p / 4 at [h][p % 4].
    const T d = __shfl_sync(kFull, a[p & 1][p & 3], 4 * (p >> 1) + (p >> 2));
    T l[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      l[h] = __shfl_sync(kFull, a[h][p & 3], 4 * r0 + (p >> 2));
    ok = ok && d > T(0);
    if (lane == p) dp = d;
    const T inv = Tile<T>::inv_sqrt(d);
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] *= inv;  // L[2 r0 + h][p] below p
    // L[c][p] for this lane's columns c = 4 cg + q: row c is held as
    // l[c % 2] by lanes 4 (c / 2) + *.
    T lc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      lc[q] = __shfl_sync(kFull, l[q & 1], 4 * (2 * cg + (q >> 1)) + cg);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[h][q] = fma(-l[h], lc[q], a[h][q]);
    // x: row p /= L_pp, then row r -= L[r][p] row p for r > p.
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (2 * r0 + h == p)
#pragma unroll
        for (int q = 0; q < 4; ++q) x[h][q] *= inv;
    T xp[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      xp[q] = __shfl_sync(kFull, x[p & 1][q], 4 * (p >> 1) + cg);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const T m = 2 * r0 + h > p ? l[h] : T(0);
#pragma unroll
      for (int q = 0; q < 4; ++q) x[h][q] = fma(-m, xp[q], x[h][q]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) store4(D + (2 * r0 + h) * LD + 4 * cg, x[h]);
  // The log-pivots summed over the warp (a log a lane, not 16 a lane).
  T lg = log(dp);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) lg += __shfl_xor_sync(kFull, lg, o);
  logdet += lg;
  return ok;
}

// -- the blocked factor and inverse -------------------------------------------
//
// M: the packed tiles of an nb x nb block matrix (1 <= nb <= 16; nb = 8 for
// 128 x 128), the lower triangle of an SPD matrix (the upper halves of the
// diagonal tiles are scratch, never read as data).  `flag`: one int of
// shared memory, zero on entry.  On return every tile (i, j) holds T_ij of
// T = L^-1 (the diagonal tiles with exact zeros above their diagonal),
// `logdet` is the sum of the log-pivots on warp 0 (undefined elsewhere),
// and the block is synchronised.  Returns false on every thread if a pivot
// is not positive or is NaN (M is then part-written).  Needs WARPS >= 2
// and nb - 1 <= WARPS (the caller's to ensure: nb is known at run time).
template <typename T, int WARPS>
__device__ __forceinline__ bool factor_invert(T* M, int nb, int* flag,
                                              T& logdet) {
  static_assert(WARPS >= 2, "warp 0 factors while the others update");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T ld = T(0);
  // (a) the first diagonal tile: L_00, then T_00 in its place.
  if (warp == 0 && !diag(at(M, 0, 0), lane, ld) && lane == 0) *flag = 1;
  __syncthreads();
  if (*flag) return false;
  for (int j = 0; j < nb - 1; ++j) {
    // (b) the panel: L_ij = A_ij T_jj^T, one warp a tile.
    for (int i = j + 1 + warp; i < nb; i += WARPS) {
      T acc[2][4] = {};
      nt(acc, at(M, i, j), at(M, j, j), lane);
      __syncwarp();
      put_nt<T, false>(at(M, i, j), acc, lane);
    }
    __syncthreads();
    // (c) the trailing update A_ik -= L_ij L_kj^T, j < k <= i: first the
    // next panel's column k = j + 1, one warp a tile, then, while warp 0
    // factors the next diagonal tile (a), the rest, dealt to the other
    // warps in turn.  Each product is summed from zero and subtracted
    // once: subtracting its 16 terms from A_ik one by one rounds 16 times
    // at A_ik's scale, and the Schur complement cancels.
    for (int i = j + 1 + warp; i < nb; i += WARPS) {
      T acc[2][4] = {};
      nt(acc, at(M, i, j), at(M, j + 1, j), lane);
      put_nt<T, true>(at(M, i, j + 1), acc, lane);
    }
    __syncthreads();
    if (warp == 0) {
      if (!diag(at(M, j + 1, j + 1), lane, ld) && lane == 0) *flag = 1;
    } else {
      int t = 0;
      for (int i = j + 2; i < nb; ++i)
        for (int k = j + 2; k <= i; ++k, ++t)
          if (t % (WARPS - 1) == warp - 1) {
            T acc[2][4] = {};
            nt(acc, at(M, i, j), at(M, k, j), lane);
            put_nt<T, true>(at(M, i, k), acc, lane);
          }
    }
    __syncthreads();
    if (*flag) return false;
  }
  // The inverse, in place, block column j from the right: each tile
  // (i, j) below the diagonal is one warp's (nb - 1 <= WARPS).  Its sum
  // reads L's column j and the finished columns right of it; the barrier
  // lets every warp finish reading column j before any overwrites it.
  for (int j = nb - 2; j >= 0; --j) {
    const int i = j + 1 + warp;
    T acc[2][4] = {};
    if (i < nb)
      for (int k = j + 1; k <= i; ++k) nn(acc, at(M, i, k), at(M, k, j), lane);
    __syncthreads();
    if (i < nb) {
      T* const Tij = at(M, i, j);
      put_nn(Tij, acc, T(1), lane);
      __syncwarp();
      T out[2][4] = {};
      nn(out, Tij, at(M, j, j), lane);
      __syncwarp();
      put_nn(Tij, out, T(-1), lane);
    }
    __syncthreads();
  }
  logdet = ld;
  return true;
}

// -- the Gram product T^T T ---------------------------------------------------
//
// M: the packed tiles of T (lower, as factor_invert() leaves them).  On
// return tile (i, j), i >= j, holds (T^T T)_ij = sum_{k >= i} T_ki^T T_kj
// (the diagonal tiles whole), and the block is synchronised.  In place, in
// LAPACK's xLAUUM order: tiles in row-major order from the top, one warp a
// tile, in rounds of WARPS tiles.  A round sums each of its tiles from zero
// into registers (tn), then a barrier, then writes them: tile (i, j) reads
// rows k >= i of T, which no round before it has written, except row i's
// T_ii and T_ij, which only the round that holds (i, i) or (i, j)
// overwrites, after that round's barrier.
template <typename T, int WARPS>
__device__ __forceinline__ void gram(T* M, int nb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = nb * (nb + 1) / 2;
  // (i, j) of tile t = warp in row-major order over the lower triangle.
  int i = 0, j = warp;
  while (j > i) j -= ++i;
  for (int t0 = 0; t0 < tiles; t0 += WARPS) {
    const bool mine = t0 + warp < tiles;
    T acc[4][2] = {};
    if (mine)
      for (int k = i; k < nb; ++k) tn(acc, at(M, k, i), at(M, k, j), lane);
    __syncthreads();
    if (mine) put_tn(at(M, i, j), acc, lane);
    j += WARPS;
    while (j > i) j -= ++i;
  }
  __syncthreads();
}

}  // namespace tile
}  // namespace gt

#endif  // GT_TILE_CHOL_CUH
