// Fused Kalman-filter log-likelihood with its gradient, for Hopper (sm_90a).
//
// Replaces both TPU kernels of george_tpu/ops/pallas_kalman.py (launched
// through make_kalman_vg, pl.pallas_call): _kernel_builder, which keeps the
// series in SMEM up to N = 32768, and _kernel_builder_streaming, which
// streams longer series (up to N = 2^22) from HBM through a double-buffered
// window by async DMA.  Here one kernel plays both roles for every N up to
// 2^22: the series always streams from device memory through a
// double-buffered shared-memory window filled by cp.async.  The whole N-step
// filter of a sum of Markovian GP terms runs in one program, stationary
// init, then per step a closed-form predict (Phi, Q per gap) and a
// Joseph-form observe.  It returns ll per chain and the derivative of ll
// with respect to every active parameter, carried forward alongside the
// primal as dual numbers (the TPU kernel traced jax.jvp inside its body;
// here Dual<T, NA> spells the same forward mode out).
//
// What bounds it on the H100: arithmetic and latency, not bytes.  A call
// reads theta (B x D_full) and the shared (dt, y, v) series once and writes
// B x (1 + NA) values, well under a megabyte, while each chain runs N
// dependent steps of ~100 primal operations, each carried with NA tangents.
// The design keeps all of it off device memory: the D x D state and its NA
// tangents in registers (the term list, the state dimension and NA are
// compile-time, so every small loop unrolls and the block-diagonal
// structure of Phi folds away), and the shared series staged through shared
// memory, since every lane reads the same step at the same time.
//
// Two launches of one library, chosen by the segment count S:
//   S = 1  one chain a thread (kalman_vg_kernel, 128 threads a block): the
//          series through a block-wide cp.async double buffer of KV_CHUNK
//          steps.  Enough where B alone fills the card (B = 16384 is 128
//          blocks).
//   S > 1  each chain's series split in time over S warps
//          (kalman_vg_seg_kernel, below): a group of 32 chains is one
//          thread-block cluster of S / W blocks of W warps, one launch a
//          call, so that a few long chains still fill the card (B = 1024
//          chains gave 8 busy SMs at S = 1).  The critical path falls from
//          N steps to ~3 N / (S + 1), for about twice the operations.
// ops/kalman.choose_segments picks S from (B, N, D).
//
// Compile-time configuration (nvcc -D):
//   KV_T     scalar type, float or double
//   KV_NA    number of active parameters (tangents)
//   KV_FAMS  the family codes of the terms, in state order, as the decimal
//            digits after a leading 1 (nvcc splits -D values at commas):
//            0 matern-1/2, 1 matern-3/2, 2 matern-5/2, 3 cosine, 4 constant;
//            e.g. 1102 is matern-3/2 + matern-1/2 + matern-5/2
//
// Runtime description (int32 `meta`, built by george_tpu_torch/ops/kalman.py):
//   [n_mean, n_wn, NA, active[NA],
//    per term: rate index (-1: none), nscale, (naxes, index) x nscale]
// with every index into the full parameter vector
// [mean (n_mean) | log white noise (n_wn) | kernel].  sigma2 of a term is
// prod(naxes * exp(theta[index])); its rate is c_p exp(-theta[rate] / 2)
// (materns) or 2 pi / exp(theta[rate]) (cosine).

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dual.cuh"

#ifndef KV_T
#error "define KV_T (float or double)"
#endif
#ifndef KV_NA
#error "define KV_NA (number of active parameters)"
#endif
#ifndef KV_FAMS
#error "define KV_FAMS (1 followed by the term family codes)"
#endif

#define KV_THREADS 128
#define KV_CHUNK 512
// The split series (S > 1): steps of a warp's chunk, warps a block, blocks
// a cluster (above 8 a non-portable cluster size, which the H100 takes).
#define KS_CHUNK 32
#define KS_MAX_WARPS 8
#define KS_MAX_CLUSTER 16
// A state of more dimensions runs S = 1 only, and its library holds no
// segment kernel: the element's A, C and J with their tangents spill
// heavily there (D = 4, the zoo's cosine + Matern-3/2, builds in 41 s with
// 17 KB of float64 spill stores on the H100's nvcc; D = 6, Matern-3/2 +
// Matern-1/2 + Matern-5/2, had not finished after 780 s).
#define KS_MAX_D 4

namespace kv {

namespace cg = cooperative_groups;
using namespace gt;  // Dual<T, NA>, constant, exp / log / sin / cos

#define KV_HD GT_HD

// ---------------------------------------------------------------------------
// Compile-time layout of the state.  Every call below has constant
// arguments once the loops around it are unrolled, so it folds away.
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int fam_dim(int fam) {
  return fam == 0 ? 1 : fam == 1 ? 2 : fam == 2 ? 3 : fam == 3 ? 2 : 1;
}

__host__ __device__ constexpr int n_digits(long long v) {
  return v < 10 ? 1 : 1 + n_digits(v / 10);
}

__host__ __device__ constexpr int n_terms() { return n_digits(KV_FAMS) - 1; }

__host__ __device__ constexpr int term_fam(int t) {
  long long v = KV_FAMS;
  for (int u = n_terms() - 1; u > t; --u) v /= 10;
  return int(v % 10);
}

__host__ __device__ constexpr int term_off(int t) {
  int off = 0;
  for (int u = 0; u < t; ++u) off += fam_dim(term_fam(u));
  return off;
}

__host__ __device__ constexpr int state_dim() { return term_off(n_terms()); }

// Index of the term that owns state coordinate i.
__host__ __device__ constexpr int term_of(int i) {
  int t = 0;
  while (t + 1 < n_terms() && term_off(t + 1) <= i) ++t;
  return t;
}

__host__ __device__ constexpr bool same_block(int i, int j) {
  return term_of(i) == term_of(j);
}

// The observed coordinate of every block is its first one.
__host__ __device__ constexpr bool is_obs(int i) {
  return term_off(term_of(i)) == i;
}

// Structural non-zeros of the stationary covariance of a family.
__host__ __device__ constexpr bool pinf_nz(int fam, int i, int j) {
  return fam == 2 ? ((i + j) % 2 == 0) : (i == j);
}

__host__ __device__ constexpr double matern_c(int fam) {
  return fam == 0 ? 1.0 : fam == 1 ? 1.7320508075688772 : 2.23606797749979;
}

constexpr int NT = n_terms();
constexpr int D = state_dim();
constexpr int NA = KV_NA;
typedef KV_T T;
typedef Dual<T, NA> DT;

// ---------------------------------------------------------------------------
// The filter, written once over DT.
// ---------------------------------------------------------------------------

// Per-term stationary covariance, in-block entries only.
KV_HD void stationary(const DT (&s2)[NT], const DT (&rate)[NT],
                      DT (&Pinf)[D][D]) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int o = term_off(t);
    const DT s = s2[t];
    switch (term_fam(t)) {
      case 1: {
        const DT lam = rate[t];
        Pinf[o][o] = s;
        Pinf[o + 1][o + 1] = s * lam * lam;
        break;
      }
      case 2: {
        const DT l2 = rate[t] * rate[t];
        const DT kappa = l2 / 3.0;
        Pinf[o][o] = s;
        Pinf[o][o + 2] = -s * kappa;
        Pinf[o + 1][o + 1] = s * kappa;
        Pinf[o + 2][o] = -s * kappa;
        Pinf[o + 2][o + 2] = s * l2 * l2;
        break;
      }
      case 3:
        Pinf[o][o] = s;
        Pinf[o + 1][o + 1] = s;
        break;
      default:  // matern-1/2 and constant
        Pinf[o][o] = s;
        break;
    }
  }
}

// Per-gap transition Phi and process noise Q = Pinf - Phi Pinf Phi^T,
// in-block entries only.
KV_HD void transition(const DT (&rate)[NT], const DT (&Pinf)[D][D], T dt,
                      DT (&Phi)[D][D], DT (&Q)[D][D]) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int o = term_off(t);
    const int fam = term_fam(t);
    const DT lam = rate[t];
    switch (fam) {
      case 0:
        Phi[o][o] = exp(-(lam * dt));
        break;
      case 1: {
        const DT lt = lam * dt;
        const DT e = exp(-lt);
        Phi[o][o] = e * (1.0 + lt);
        Phi[o][o + 1] = e * dt;
        Phi[o + 1][o] = -e * lam * lam * dt;
        Phi[o + 1][o + 1] = e * (1.0 - lt);
        break;
      }
      case 2: {
        const DT lt = lam * dt;
        const DT e = exp(-lt);
        const DT l2 = lam * lam;
        Phi[o][o] = e * (1.0 + lt + 0.5 * lt * lt);
        Phi[o][o + 1] = e * dt * (1.0 + lt);
        Phi[o][o + 2] = e * 0.5 * dt * dt;
        Phi[o + 1][o] = e * (-0.5 * l2 * lam * dt * dt);
        Phi[o + 1][o + 1] = e * (1.0 + lt - lt * lt);
        Phi[o + 1][o + 2] = e * dt * (1.0 - 0.5 * lt);
        Phi[o + 2][o] = e * (l2 * lam * dt * (0.5 * lt - 1.0));
        Phi[o + 2][o + 1] = e * (l2 * dt * (lt - 3.0));
        Phi[o + 2][o + 2] = e * (1.0 - 2.0 * lt + 0.5 * lt * lt);
        break;
      }
      case 3: {
        const DT wt = lam * dt;
        const DT c = cos(wt);
        const DT s = sin(wt);
        Phi[o][o] = c;
        Phi[o][o + 1] = -s;
        Phi[o + 1][o] = s;
        Phi[o + 1][o + 1] = c;
        break;
      }
      default:
        Phi[o][o] = constant<T, NA>(T(1));
        break;
    }
    const int d = fam_dim(fam);
#pragma unroll
    for (int i = 0; i < d; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        DT acc;
        bool first = true;
#pragma unroll
        for (int k = 0; k < d; ++k) {
#pragma unroll
          for (int l = 0; l < d; ++l) {
            if (!pinf_nz(fam, k, l)) continue;
            const DT term = Phi[o + i][o + k] * Pinf[o + k][o + l] *
                            Phi[o + j][o + l];
            acc = first ? term : acc + term;
            first = false;
          }
        }
        const DT q = pinf_nz(fam, i, j) ? Pinf[o + i][o + j] - acc : -acc;
        Q[o + i][o + j] = q;
        Q[o + j][o + i] = q;
      }
    }
  }
}

KV_HD void predict(const DT (&Phi)[D][D], const DT (&Q)[D][D], DT (&m)[D],
                   DT (&P)[D][D]) {
  DT mp[D];
  DT PhiP[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    bool first = true;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (!same_block(i, k)) continue;
      const DT term = Phi[i][k] * m[k];
      mp[i] = first ? term : mp[i] + term;
      first = false;
    }
#pragma unroll
    for (int j = 0; j < D; ++j) {
      bool first_j = true;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        if (!same_block(i, k)) continue;
        const DT term = Phi[i][k] * P[k][j];
        PhiP[i][j] = first_j ? term : PhiP[i][j] + term;
        first_j = false;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    m[i] = mp[i];
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      DT acc;
      bool first = true;
#pragma unroll
      for (int l = 0; l < D; ++l) {
        if (!same_block(j, l)) continue;
        const DT term = PhiP[i][l] * Phi[j][l];
        acc = first ? term : acc + term;
        first = false;
      }
      if (same_block(i, j)) acc = acc + Q[i][j];
      P[i][j] = acc;
      P[j][i] = acc;
    }
  }
}

// Joseph-form observation of r (residual) with variance v: updates (m, P)
// and returns the gain K, the innovation, its variance S and 1 / S.
KV_HD void update(DT (&m)[D], DT (&P)[D][D], const DT& r, const DT& v,
                  DT (&K)[D], DT& innov, DT& S, DT& inv) {
  DT Ph[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    bool first = true;
#pragma unroll
    for (int o = 0; o < D; ++o) {
      if (!is_obs(o)) continue;
      Ph[i] = first ? P[i][o] : Ph[i] + P[i][o];
      first = false;
    }
  }
  S = v;
  innov = r;
#pragma unroll
  for (int o = 0; o < D; ++o) {
    if (!is_obs(o)) continue;
    S = S + Ph[o];
    innov = innov - m[o];
  }
  inv = 1.0 / S;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    K[i] = Ph[i] * inv;
    m[i] = m[i] + K[i] * innov;
  }
  // (I - K h^T) P (I - K h^T)^T + v K K^T, expanded: BP = P - K Ph^T,
  // then P' = BP - (BP h) K^T + v K K^T.
  DT BP[D][D];
  DT BPh[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    bool first = true;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      BP[i][j] = P[i][j] - K[i] * Ph[j];
      if (!is_obs(j)) continue;
      BPh[i] = first ? BP[i][j] : BPh[i] + BP[i][j];
      first = false;
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const DT p = BP[i][j] - BPh[i] * K[j] + v * K[i] * K[j];
      P[i][j] = p;
      P[j][i] = p;
    }
  }
}

// update() that adds the prediction-error term of the observation to acc.
KV_HD void observe(DT (&m)[D], DT (&P)[D][D], const DT& r, const DT& v,
                   DT& acc) {
  DT K[D];
  DT innov, S, inv;
  update(m, P, r, v, K, innov, S, inv);
  acc = acc - 0.5 * (log(6.283185307179586 * S) + innov * innov * inv);
}

// One chain's parameters as duals (value and NA tangents): per-term
// (sigma2, rate), the stationary covariance Pinf (in-block structural
// non-zeros only), the mean and the white-noise variance.
struct Chain {
  DT s2[NT];
  DT rate[NT];
  DT Pinf[D][D];
  DT mu;
  DT vwn;

  // From the chain's full parameter vector th and the runtime description.
  KV_HD void setup(const T* __restrict__ th, const int* __restrict__ meta) {
    const int n_mean = meta[0];
    const int n_wn = meta[1];
    int act[NA > 0 ? NA : 1];
#pragma unroll
    for (int j = 0; j < NA; ++j) act[j] = meta[3 + j];

    auto param = [&](int idx) {
      DT p;
      p.v = th[idx];
#pragma unroll
      for (int j = 0; j < NA; ++j) p.d[j] = act[j] == idx ? T(1) : T(0);
      return p;
    };

    const int* q = meta + 3 + NA;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int ri = q[0];
      const int ns = q[1];
      q += 2;
      DT s = constant<T, NA>(T(1));
      for (int u = 0; u < ns; ++u, q += 2) {
        s = s * (T(q[0]) * exp(param(q[1])));
      }
      s2[t] = s;
      const int fam = term_fam(t);
      if (fam <= 2) {
        rate[t] = matern_c(fam) * exp(-0.5 * param(ri));
      } else if (fam == 3) {
        rate[t] = 6.283185307179586 / exp(param(ri));
      } else {
        rate[t] = constant<T, NA>(T(0));
      }
    }
    mu = n_mean ? param(0) : constant<T, NA>(T(0));
    vwn = n_wn ? exp(param(n_mean)) : constant<T, NA>(T(0));
    stationary(s2, rate, Pinf);
  }

  // The stationary prior: m = 0, P = Pinf.
  KV_HD void prior(DT (&m)[D], DT (&P)[D][D]) const {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      m[i] = constant<T, NA>(T(0));
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const bool nz = same_block(i, j) &&
                        pinf_nz(term_fam(term_of(i)), i - term_off(term_of(i)),
                                j - term_off(term_of(i)));
        P[i][j] = nz ? Pinf[i][j] : constant<T, NA>(T(0));
      }
    }
  }

  // One filter step: the gap dt into the observation (y, v).
  KV_HD void step(T dt, T y, T v, DT (&m)[D], DT (&P)[D][D], DT& acc) const {
    DT Phi[D][D];
    DT Q[D][D];
    transition(rate, Pinf, dt, Phi, Q);
    predict(Phi, Q, m, P);
    observe(m, P, y - mu, v + vwn, acc);
  }
};

// Issue the asynchronous copy of the chunk of steps [base, base + KV_CHUNK)
// (gaps dt[base - 1 + i], observations y / v[base + i]) into shared memory,
// one element per thread and iteration, as one cp.async batch.
KV_HD void stage(const T* __restrict__ dt, const T* __restrict__ y,
                 const T* __restrict__ v, int base, int n, T* s_dt, T* s_y,
                 T* s_v) {
  const int cnt = min(KV_CHUNK, n - base);
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    __pipeline_memcpy_async(s_dt + i, dt + base - 1 + i, sizeof(T));
    __pipeline_memcpy_async(s_y + i, y + base + i, sizeof(T));
    __pipeline_memcpy_async(s_v + i, v + base + i, sizeof(T));
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(KV_THREADS)
kalman_vg_kernel(const T* __restrict__ theta, const T* __restrict__ dt,
                 const T* __restrict__ y, const T* __restrict__ v,
                 const int* __restrict__ meta, T* __restrict__ ll,
                 T* __restrict__ jac, int B, int n, int d_full) {
  __shared__ __align__(16) T s_dt[2][KV_CHUNK];
  __shared__ __align__(16) T s_y[2][KV_CHUNK];
  __shared__ __align__(16) T s_v[2][KV_CHUNK];

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = b < B;
  // Threads past the batch run chain 0 so that every thread takes part in
  // the shared-memory staging; they store nothing.
  const T* th = theta + (size_t)(live ? b : 0) * d_full;

  Chain ch;
  ch.setup(th, meta);
  DT m[D];
  DT P[D][D];
  ch.prior(m, P);
  DT acc = constant<T, NA>(T(0));
  // Step 0 observes the stationary prior directly.
  observe(m, P, y[0] - ch.mu, v[0] + ch.vwn, acc);

  // The series streams through a double-buffered shared-memory window:
  // the copy of chunk c + 1 (cp.async) is in flight while the steps of
  // chunk c run, and is waited for before they read it.
  const int n_chunks = (n - 1 + KV_CHUNK - 1) / KV_CHUNK;
  if (n_chunks > 0) stage(dt, y, v, 1, n, s_dt[0], s_y[0], s_v[0]);
  for (int c = 0; c < n_chunks; ++c) {
    const int base = 1 + c * KV_CHUNK;
    const int cnt = min(KV_CHUNK, n - base);
    const int buf = c & 1;
    if (c + 1 < n_chunks) {
      stage(dt, y, v, base + KV_CHUNK, n, s_dt[buf ^ 1], s_y[buf ^ 1],
            s_v[buf ^ 1]);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      ch.step(s_dt[buf][i], s_y[buf][i], s_v[buf][i], m, P, acc);
    }
    // Every thread is done with this buffer before the next iteration
    // stages chunk c + 2 into it.
    __syncthreads();
  }

  if (live) {
    ll[b] = acc.v;
#pragma unroll
    for (int j = 0; j < NA; ++j) jac[(size_t)j * B + b] = acc.d[j];
  }
}

// ---------------------------------------------------------------------------
// The series split in time: S > 1 segments a chain, one warp each (lane =
// chain), the warps of a group of 32 chains spread over the blocks of one
// thread-block cluster.
//
// Stage 1: segment 0 filters from the stationary prior to its end state;
// every later segment but the last folds its observations into one element
// (A, b, C, eta, J) of the associative-scan filter (Sarkka and
// Garcia-Fernandez 2021; george_tpu/ops/state_space.py, the parallel
// filter), conditioned on the state before its first observation.  Cluster
// barrier.  Stage 2: each segment carries segment 0's end state through the
// elements before its own, in order.  Stage 3: it re-filters its own
// observations from there (Chain::step, as the S = 1 kernel), summing the
// same prediction-error terms.  Cluster barrier; warp 0 of rank 0 adds the
// segments' sums in segment order.  The end state, the elements and the
// sums pass through a scratch tensor of the caller's, lane-interleaved and
// read and written with ld.cg / st.cg (through L2: the SMs' L1 caches are
// not coherent), so every state dimension takes the same road.
// ---------------------------------------------------------------------------

constexpr int TRI = D * (D + 1) / 2;
constexpr int NC = NA + 1;  // words of one DT
// A slot of the hand-off: an element, or (slot 0) the state, m in b and P
// in C.  C and J are symmetric: their lower triangles.
constexpr int OFF_B = D * D;
constexpr int OFF_C = OFF_B + D;
constexpr int OFF_ETA = OFF_C + TRI;
constexpr int OFF_J = OFF_ETA + D;
constexpr int SLOT = OFF_J + TRI;

static_assert(KS_CHUNK == 32, "one step of a warp's chunk per lane");

KV_HD constexpr int tri(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

// Words of one group's hand-off: S - 1 slots, then S partial sums.
__host__ __device__ inline size_t group_words(int S) {
  return ((size_t)(S - 1) * SLOT + S) * NC * 32;
}

KV_HD void put(T* base, int vi, const DT& x) {
  T* p = base + (size_t)vi * NC * 32 + (threadIdx.x & 31);
  __stcg(p, x.v);
#pragma unroll
  for (int j = 0; j < NA; ++j) __stcg(p + (j + 1) * 32, x.d[j]);
}

KV_HD DT get(const T* base, int vi) {
  const T* p = base + (size_t)vi * NC * 32 + (threadIdx.x & 31);
  DT x;
  x.v = __ldcg(p);
#pragma unroll
  for (int j = 0; j < NA; ++j) x.d[j] = __ldcg(p + (j + 1) * 32);
  return x;
}

// First observation of segment s of S (n for s = S): S segments of equal
// length, segment 0 always holding observation 0 (ops/kalman.segment_bounds
// is the same formula).
KV_HD int seg_start(int s, int S, int n) {
  if (s <= 0) return 0;
  if (s >= S) return n;
  const long long st = (long long)s * n / S;
  return st < 1 ? 1 : (int)st;
}

// Issue the copy of observations [base, min(base + KS_CHUNK, last)) into
// one of a warp's buffers (gaps, values, variances), one step a lane.
KV_HD void warp_stage(const T* __restrict__ dt, const T* __restrict__ y,
                      const T* __restrict__ v, int base, int last, T* buf) {
  const int i = threadIdx.x & 31;
  if (base + i < last) {
    __pipeline_memcpy_async(buf + i, dt + base - 1 + i, sizeof(T));
    __pipeline_memcpy_async(buf + KS_CHUNK + i, y + base + i, sizeof(T));
    __pipeline_memcpy_async(buf + 2 * KS_CHUNK + i, v + base + i, sizeof(T));
  }
  __pipeline_commit();
}

// body(dt, y, v) for every observation k of [first, last), first >= 1 (the
// gap into k is dt[k - 1]).  Every lane reads the same step, so the series
// streams through a double-buffered window of the warp's own (buf: 2 x 3 x
// KS_CHUNK): the copy of the next chunk is in flight while the steps of
// this one run.
template <typename F>
KV_HD void warp_steps(const T* __restrict__ dt, const T* __restrict__ y,
                      const T* __restrict__ v, int first, int last, T* buf,
                      F&& body) {
  if (first >= last) return;
  const int n_chunks = (last - first + KS_CHUNK - 1) / KS_CHUNK;
  warp_stage(dt, y, v, first, last, buf);
  for (int c = 0; c < n_chunks; ++c) {
    const int base = first + c * KS_CHUNK;
    const int cnt = min(KS_CHUNK, last - base);
    const T* cur = buf + (c & 1) * 3 * KS_CHUNK;
    if (c + 1 < n_chunks) {
      warp_stage(dt, y, v, base + KS_CHUNK, last,
                 buf + ((c + 1) & 1) * 3 * KS_CHUNK);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();
    for (int i = 0; i < cnt; ++i) {
      body(cur[i], cur[KS_CHUNK + i], cur[2 * KS_CHUNK + i]);
    }
    // Every lane is done with this buffer before it is staged again.
    __syncwarp();
  }
}

// A segment's element, conditioned on the state x before its first
// observation: x_k | x ~ N(A x + b, C), and the likelihood of the
// segment's observations so far is exp(eta^T x - x^T J x / 2) up to a
// constant.  identity() then fold() once per observation: the scan's
// combine with a one-step right operand, whose J is rank one (no solve).
struct Element {
  DT A[D][D];
  DT b[D];
  DT C[D][D];
  DT eta[D];
  DT J[D][D];

  KV_HD void identity() {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      b[i] = constant<T, NA>(T(0));
      eta[i] = constant<T, NA>(T(0));
#pragma unroll
      for (int j = 0; j < D; ++j) {
        A[i][j] = constant<T, NA>(T(i == j ? 1 : 0));
        C[i][j] = constant<T, NA>(T(0));
        J[i][j] = constant<T, NA>(T(0));
      }
    }
  }

  // (b, C) take the filter's predict and Joseph update; A the same maps,
  // A <- (I - K H) Phi A; with w = (H Phi A)^T, J gains w w^T / S and eta
  // w innov / S.
  KV_HD void fold(const Chain& ch, T dt, T y, T v) {
    DT Phi[D][D];
    DT Q[D][D];
    transition(ch.rate, ch.Pinf, dt, Phi, Q);
    predict(Phi, Q, b, C);
    DT PA[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        bool first = true;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          if (!same_block(i, k)) continue;
          const DT term = Phi[i][k] * A[k][j];
          PA[i][j] = first ? term : PA[i][j] + term;
          first = false;
        }
      }
    }
    DT w[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      bool first = true;
#pragma unroll
      for (int o = 0; o < D; ++o) {
        if (!is_obs(o)) continue;
        w[j] = first ? PA[o][j] : w[j] + PA[o][j];
        first = false;
      }
    }
    DT K[D];
    DT innov, S, inv;
    update(b, C, y - ch.mu, v + ch.vwn, K, innov, S, inv);
    const DT ri = innov * inv;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) A[i][j] = PA[i][j] - K[i] * w[j];
      eta[i] = eta[i] + w[i] * ri;
      const DT wi = w[i] * inv;
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        J[i][j] = J[i][j] + wi * w[j];
        J[j][i] = J[i][j];
      }
    }
  }

  KV_HD void store(T* slot) const {
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) put(slot, i * D + j, A[i][j]);
      put(slot, OFF_B + i, b[i]);
      put(slot, OFF_ETA + i, eta[i]);
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        put(slot, OFF_C + tri(i, j), C[i][j]);
        put(slot, OFF_J + tri(i, j), J[i][j]);
      }
    }
  }
};

KV_HD void store_state(T* slot, const DT (&m)[D], const DT (&P)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    put(slot, OFF_B + i, m[i]);
#pragma unroll
    for (int j = 0; j <= i; ++j) put(slot, OFF_C + tri(i, j), P[i][j]);
  }
}

KV_HD void load_state(const T* slot, DT (&m)[D], DT (&P)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    m[i] = get(slot, OFF_B + i);
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      P[i][j] = get(slot, OFF_C + tri(i, j));
      P[j][i] = P[i][j];
    }
  }
}

KV_HD void swap_if(bool c, DT& a, DT& b) {
  const DT t = a;
  a = c ? b : a;
  b = c ? t : b;
}

// R <- G^-1 R by Gauss-Jordan elimination with partial pivoting (on the
// primal values), in registers.
KV_HD void solve(DT (&G)[D][D], DT (&R)[D][D + 1]) {
#pragma unroll
  for (int k = 0; k < D; ++k) {
    int p = k;
    T best = gt::fabs(G[k][k].v);
#pragma unroll
    for (int i = k + 1; i < D; ++i) {
      const T a = gt::fabs(G[i][k].v);
      if (a > best) {
        best = a;
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < D; ++i) {
      const bool sw = p == i;
#pragma unroll
      for (int j = k; j < D; ++j) swap_if(sw, G[k][j], G[i][j]);
#pragma unroll
      for (int j = 0; j <= D; ++j) swap_if(sw, R[k][j], R[i][j]);
    }
    const DT inv = 1.0 / G[k][k];
#pragma unroll
    for (int j = k + 1; j < D; ++j) G[k][j] = G[k][j] * inv;
#pragma unroll
    for (int j = 0; j <= D; ++j) R[k][j] = R[k][j] * inv;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      if (i == k) continue;
      const DT f = G[i][k];
#pragma unroll
      for (int j = k + 1; j < D; ++j) G[i][j] = G[i][j] - f * G[k][j];
#pragma unroll
      for (int j = 0; j <= D; ++j) R[i][j] = R[i][j] - f * R[k][j];
    }
  }
}

// Carry the filtered state (m, P) before a segment through the segment's
// element (the scan's combine of the state, as (0, m, P, 0, 0), with it):
// M = (I + P J)^-1, m <- A M (m + P eta) + b, P <- A M P A^T + C.
KV_HD void apply(const T* slot, DT (&m)[D], DT (&P)[D][D]) {
  DT G[D][D];
  DT R[D][D + 1];
  {
    DT J[D][D];
    DT eta[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      eta[i] = get(slot, OFF_ETA + i);
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        J[i][j] = get(slot, OFF_J + tri(i, j));
        J[j][i] = J[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      DT t = m[i];
#pragma unroll
      for (int k = 0; k < D; ++k) t = t + P[i][k] * eta[k];
      R[i][D] = t;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        DT g = P[i][0] * J[0][j];
#pragma unroll
        for (int k = 1; k < D; ++k) g = g + P[i][k] * J[k][j];
        G[i][j] = i == j ? g + 1.0 : g;
        R[i][j] = P[i][j];
      }
    }
  }
  solve(G, R);
  DT A[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) A[i][j] = get(slot, i * D + j);
  }
  DT AR[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    DT t = get(slot, OFF_B + i);
#pragma unroll
    for (int k = 0; k < D; ++k) t = t + A[i][k] * R[k][D];
    m[i] = t;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      DT u = A[i][0] * R[0][j];
#pragma unroll
      for (int k = 1; k < D; ++k) u = u + A[i][k] * R[k][j];
      AR[i][j] = u;
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      DT p = get(slot, OFF_C + tri(i, j));
#pragma unroll
      for (int l = 0; l < D; ++l) p = p + AR[i][l] * A[j][l];
      P[i][j] = p;
      P[j][i] = p;
    }
  }
}

// (A template, so that a library held to S = 1 instantiates none of it.)
template <int = 0>
KV_HD void split_vg(const T* __restrict__ theta, const T* __restrict__ dt,
                    const T* __restrict__ y, const T* __restrict__ v,
                    const int* __restrict__ meta, T* __restrict__ ll,
                    T* __restrict__ jac, T* scratch, int B, int n,
                    int d_full, int S) {
  extern __shared__ __align__(16) unsigned char ks_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int W = blockDim.x >> 5;
  const int nblocks = (int)cluster.num_blocks();
  const int seg = (int)cluster.block_rank() * W + warp;
  const int group = blockIdx.x / nblocks;
  const int b = group * 32 + lane;
  const bool live = b < B;
  // Lanes past the batch run chain 0 and store nothing of their own.
  const T* th = theta + (size_t)(live ? b : 0) * d_full;
  T* buf = reinterpret_cast<T*>(ks_smem) + warp * 6 * KS_CHUNK;
  T* hand = scratch + (size_t)group * group_words(S);
  T* sums = hand + (size_t)(S - 1) * SLOT * NC * 32;

  Chain ch;
  ch.setup(th, meta);
  const int first = seg_start(seg, S, n);
  const int last = seg_start(seg + 1, S, n);
  DT m[D];
  DT P[D][D];
  DT acc = constant<T, NA>(T(0));

  // Stage 1.
  if (seg == 0) {
    ch.prior(m, P);
    observe(m, P, y[0] - ch.mu, v[0] + ch.vwn, acc);
    warp_steps(dt, y, v, 1, last, buf,
               [&](T d, T yk, T vk) { ch.step(d, yk, vk, m, P, acc); });
    store_state(hand, m, P);
  } else if (seg < S - 1 && first < last) {
    Element e;
    e.identity();
    warp_steps(dt, y, v, first, last, buf,
               [&](T d, T yk, T vk) { e.fold(ch, d, yk, vk); });
    e.store(hand + (size_t)seg * SLOT * NC * 32);
  }
  cluster.sync();

  // Stages 2 and 3.
  if (seg > 0 && first < last) {
    load_state(hand, m, P);
    for (int k = 1; k < seg; ++k) {
      if (seg_start(k, S, n) < seg_start(k + 1, S, n)) {
        apply(hand + (size_t)k * SLOT * NC * 32, m, P);
      }
    }
    warp_steps(dt, y, v, first, last, buf,
               [&](T d, T yk, T vk) { ch.step(d, yk, vk, m, P, acc); });
  }
  if (seg > 0) put(sums, seg, acc);
  cluster.sync();

  if (seg == 0 && live) {
    for (int s = 1; s < S; ++s) acc = acc + get(sums, s);
    ll[b] = acc.v;
#pragma unroll
    for (int j = 0; j < NA; ++j) jac[(size_t)j * B + b] = acc.d[j];
  }
}

constexpr bool SPLIT = D <= KS_MAX_D;

__global__ void __launch_bounds__(KS_MAX_WARPS * 32)
kalman_vg_seg_kernel(const T* __restrict__ theta, const T* __restrict__ dt,
                     const T* __restrict__ y, const T* __restrict__ v,
                     const int* __restrict__ meta, T* __restrict__ ll,
                     T* __restrict__ jac, T* scratch, int B, int n,
                     int d_full, int S) {
  if constexpr (SPLIT) {
    split_vg<>(theta, dt, y, v, meta, ll, jac, scratch, B, n, d_full, S);
  }
}

}  // namespace kv

// ---------------------------------------------------------------------------
// Plain C interface (loaded with ctypes).
// ---------------------------------------------------------------------------

extern "C" {

// Compile-time configuration of this build, for the caller to verify:
// out[0] = state dimension, out[1] = number of terms, out[2] = NA,
// out[3] = sizeof(scalar).
void kalman_vg_config(int* out) {
  out[0] = kv::D;
  out[1] = kv::NT;
  out[2] = kv::NA;
  out[3] = (int)sizeof(kv::T);
}

// Words of the scratch tensor a launch over S segments needs (0 for S = 1).
long long kalman_vg_scratch_words(int B, int segments) {
  if (segments <= 1) return 0;
  return (long long)((B + 31) / 32) * (long long)kv::group_words(segments);
}

// Launches on `stream`; returns the launch's error (0 on success).  No
// synchronisation and no allocation: ll (B,), jac (NA, B) and, for S > 1,
// the scratch (kalman_vg_scratch_words) are the caller's.  segments = 1 is
// one chain a thread; segments = S > 1 splits each chain's series over S
// warps, `cluster` blocks of S / cluster warps (one cluster per 32
// chains).
int kalman_vg_launch(const void* theta, const void* dt, const void* y,
                     const void* v, const void* meta, void* ll, void* jac,
                     void* scratch, int B, int n, int d_full, int segments,
                     int cluster, void* stream) {
  if (segments <= 1) {
    const int blocks = (B + KV_THREADS - 1) / KV_THREADS;
    kv::kalman_vg_kernel<<<blocks, KV_THREADS, 0, (cudaStream_t)stream>>>(
        (const kv::T*)theta, (const kv::T*)dt, (const kv::T*)y,
        (const kv::T*)v, (const int*)meta, (kv::T*)ll, (kv::T*)jac, B, n,
        d_full);
    return (int)cudaGetLastError();
  }
  const int warps = cluster > 0 ? segments / cluster : 0;
  if (!kv::SPLIT || cluster < 1 || cluster > KS_MAX_CLUSTER || warps < 1 ||
      warps * cluster != segments || warps > KS_MAX_WARPS ||
      scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (cluster > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        kv::kalman_vg_seg_kernel,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((B + 31) / 32) * cluster));
  cfg.blockDim = dim3((unsigned)(32 * warps));
  cfg.dynamicSmemBytes = (size_t)warps * 6 * KS_CHUNK * sizeof(kv::T);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kv::kalman_vg_seg_kernel, (const kv::T*)theta, (const kv::T*)dt,
      (const kv::T*)y, (const kv::T*)v, (const int*)meta, (kv::T*)ll,
      (kv::T*)jac, (kv::T*)scratch, B, n, d_full, segments);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* kalman_vg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
