// -*- c++ -*-
// Host-side point orderings (george's utils.nd_sort_samples and the orderings
// a hierarchical solver needs).  Which index permutation makes the
// off-diagonal blocks of a covariance low-rank is pointer-chasing and
// partial-sorting work on the host, so it is plain C++, built with g++ at
// first use and loaded by ctypes (george_tpu_torch/native/__init__.py).
//
// Exposed over a plain C ABI:
//
//   gt_distance_order  — order by distance from the first sample (george's
//                        nd_sort_samples: a k-d tree query of every point).
//   gt_kd_order        — recursive median splits on the widest-spread axis.
//                        The splits at sizes n/2, n/4, ... align with a
//                        hierarchical solver's levels, so every off-diagonal
//                        block couples two spatially separated clusters.
//   gt_hilbert_order   — Hilbert space-filling-curve order (Skilling's
//                        transpose algorithm), another locality order whose
//                        prefix property also respects the halving.
//
// All entry points take row-major (n, d) float64 coordinates and write a
// permutation of 0..n-1 into out. Return 0 on success, nonzero on bad input.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

int gt_distance_order(const double* pts, int64_t n, int64_t d, int64_t* out) {
  if (n <= 0 || d <= 0) return 1;
  std::vector<double> dist(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    double s = 0.0;
    for (int64_t k = 0; k < d; ++k) {
      const double diff = pts[i * d + k] - pts[k];
      s += diff * diff;
    }
    dist[static_cast<size_t>(i)] = s;
  }
  std::iota(out, out + n, int64_t{0});
  std::stable_sort(out, out + n, [&](int64_t a, int64_t b) {
    return dist[static_cast<size_t>(a)] < dist[static_cast<size_t>(b)];
  });
  return 0;
}

namespace {

void kd_recurse(const double* pts, int64_t d, int64_t* idx, int64_t n) {
  if (n <= 2) return;
  // Pick the axis with the largest coordinate spread over this cluster.
  int64_t best_axis = 0;
  double best_spread = -1.0;
  for (int64_t k = 0; k < d; ++k) {
    double lo = pts[idx[0] * d + k], hi = lo;
    for (int64_t i = 1; i < n; ++i) {
      const double v = pts[idx[i] * d + k];
      lo = std::min(lo, v);
      hi = std::max(hi, v);
    }
    if (hi - lo > best_spread) {
      best_spread = hi - lo;
      best_axis = k;
    }
  }
  // Median split at n/2 — matches the HODLR tree's exact halving, so the
  // level-q off-diagonal blocks couple disjoint spatial clusters.
  const int64_t mid = n / 2;
  std::nth_element(idx, idx + mid, idx + n, [&](int64_t a, int64_t b) {
    return pts[a * d + best_axis] < pts[b * d + best_axis];
  });
  kd_recurse(pts, d, idx, mid);
  kd_recurse(pts, d, idx + mid, n - mid);
}

}  // namespace

int gt_kd_order(const double* pts, int64_t n, int64_t d, int64_t* out) {
  if (n <= 0 || d <= 0) return 1;
  std::iota(out, out + n, int64_t{0});
  kd_recurse(pts, d, out, n);
  return 0;
}

namespace {

// Skilling's "transpose" Hilbert encoding: in-place conversion of per-axis
// bit-interleaved coordinates X[0..d) (b bits each) into the transposed
// Hilbert index (public-domain algorithm, J. Skilling, AIP Conf. Proc. 707).
void axes_to_transpose(uint32_t* X, int b, int d) {
  uint32_t M = 1u << (b - 1), P, Q, t;
  // Inverse undo.
  for (Q = M; Q > 1; Q >>= 1) {
    P = Q - 1;
    for (int i = 0; i < d; ++i) {
      if (X[i] & Q) {
        X[0] ^= P;  // invert
      } else {      // exchange
        t = (X[0] ^ X[i]) & P;
        X[0] ^= t;
        X[i] ^= t;
      }
    }
  }
  // Gray encode.
  for (int i = 1; i < d; ++i) X[i] ^= X[i - 1];
  t = 0;
  for (Q = M; Q > 1; Q >>= 1) {
    if (X[d - 1] & Q) t ^= Q - 1;
  }
  for (int i = 0; i < d; ++i) X[i] ^= t;
}

}  // namespace

int gt_hilbert_order(const double* pts, int64_t n, int64_t d, int bits,
                     int64_t* out) {
  if (n <= 0 || d <= 0 || bits < 1 || bits > 30 || d > 16) return 1;
  // Normalize each axis to [0, 2^bits).
  std::vector<double> lo(static_cast<size_t>(d)), scale(static_cast<size_t>(d));
  for (int64_t k = 0; k < d; ++k) {
    double mn = pts[k], mx = pts[k];
    for (int64_t i = 1; i < n; ++i) {
      const double v = pts[i * d + k];
      mn = std::min(mn, v);
      mx = std::max(mx, v);
    }
    lo[static_cast<size_t>(k)] = mn;
    const double span = mx - mn;
    scale[static_cast<size_t>(k)] =
        span > 0 ? ((double)((1u << bits) - 1)) / span : 0.0;
  }
  // Per-point Hilbert key: d words of b bits in transposed form, flattened
  // to a lexicographically-comparable bit string (MSB-first interleave).
  const int words = (bits * static_cast<int>(d) + 63) / 64;
  std::vector<uint64_t> keys(static_cast<size_t>(n * words), 0);
  std::vector<uint32_t> X(static_cast<size_t>(d));
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t k = 0; k < d; ++k) {
      double v = (pts[i * d + k] - lo[static_cast<size_t>(k)]) *
                 scale[static_cast<size_t>(k)];
      if (v < 0) v = 0;
      const double cap = (double)((1u << bits) - 1);
      if (v > cap) v = cap;
      X[static_cast<size_t>(k)] = static_cast<uint32_t>(v);
    }
    axes_to_transpose(X.data(), bits, static_cast<int>(d));
    // Interleave: bit (bits-1-j) of axis i is bit position j*d + i from the
    // top of the key.
    uint64_t* key = &keys[static_cast<size_t>(i * words)];
    int pos = 0;
    for (int j = bits - 1; j >= 0; --j) {
      for (int64_t k = 0; k < d; ++k, ++pos) {
        if (X[static_cast<size_t>(k)] & (1u << j)) {
          key[pos / 64] |= (uint64_t{1} << (63 - (pos % 64)));
        }
      }
    }
  }
  std::iota(out, out + n, int64_t{0});
  std::stable_sort(out, out + n, [&](int64_t a, int64_t b) {
    const uint64_t* ka = &keys[static_cast<size_t>(a * words)];
    const uint64_t* kb = &keys[static_cast<size_t>(b * words)];
    for (int w = 0; w < words; ++w) {
      if (ka[w] != kb[w]) return ka[w] < kb[w];
    }
    return false;
  });
  return 0;
}

}  // extern "C"
