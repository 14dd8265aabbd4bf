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
// The design keeps all of it off device memory: one chain per thread, the
// D x D state and its NA tangents in registers (the term list, the state
// dimension and NA are compile-time, so every small loop unrolls and the
// block-diagonal structure of Phi folds away), and the shared series staged
// through shared memory in chunks of KV_CHUNK steps, since every thread of a
// block reads the same element at the same step; the copy of the next chunk
// overlaps the steps of the current one.  Occupancy is whatever B gives (B = 16384
// is 128 blocks of 128 threads); filling the card better is later work.
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

namespace kv {

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

// Joseph-form observation of r (residual) with variance v; adds the
// prediction-error term of this observation to acc.
KV_HD void observe(DT (&m)[D], DT (&P)[D][D], const DT& r, const DT& v,
                   DT& acc) {
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
  DT S = v;
  DT innov = r;
#pragma unroll
  for (int o = 0; o < D; ++o) {
    if (!is_obs(o)) continue;
    S = S + Ph[o];
    innov = innov - m[o];
  }
  const DT inv = 1.0 / S;
  DT K[D];
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
  acc = acc - 0.5 * (log(6.283185307179586 * S) + innov * innov * inv);
}

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

  // Per-term (sigma2, rate), the mean and the white-noise variance.
  DT s2[NT];
  DT rate[NT];
  const int* q = meta + 3 + NA;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int ri = q[0];
    const int ns = q[1];
    q += 2;
    DT s = constant<T, NA>(T(1));
    for (int u = 0; u < ns; ++u, q += 2) s = s * (T(q[0]) * exp(param(q[1])));
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
  const DT mu = n_mean ? param(0) : constant<T, NA>(T(0));
  const DT vwn = n_wn ? exp(param(n_mean)) : constant<T, NA>(T(0));

  DT Pinf[D][D];
  stationary(s2, rate, Pinf);

  DT m[D];
  DT P[D][D];
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
  DT acc = constant<T, NA>(T(0));
  // Step 0 observes the stationary prior directly.
  observe(m, P, y[0] - mu, v[0] + vwn, acc);

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
      DT Phi[D][D];
      DT Q[D][D];
      transition(rate, Pinf, s_dt[buf][i], Phi, Q);
      predict(Phi, Q, m, P);
      observe(m, P, s_y[buf][i] - mu, s_v[buf][i] + vwn, acc);
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

// Launches on `stream`; returns cudaGetLastError() (0 on success).  No
// synchronisation and no allocation: ll (B,) and jac (NA, B) are the
// caller's.
int kalman_vg_launch(const void* theta, const void* dt, const void* y,
                     const void* v, const void* meta, void* ll, void* jac,
                     int B, int n, int d_full, void* stream) {
  const int blocks = (B + KV_THREADS - 1) / KV_THREADS;
  kv::kalman_vg_kernel<<<blocks, KV_THREADS, 0, (cudaStream_t)stream>>>(
      (const kv::T*)theta, (const kv::T*)dt, (const kv::T*)y,
      (const kv::T*)v, (const int*)meta, (kv::T*)ll, (kv::T*)jac, B, n,
      d_full);
  return (int)cudaGetLastError();
}

const char* kalman_vg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
