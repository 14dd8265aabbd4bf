// Forward-mode dual numbers for the hand-written kernels (kalman_vg.cu,
// dense_vg.cu and the kernel trees generated by dsl/cuda_codegen.py).
//
// Dual<T, NA> is a value and NA tangents.  Every function below has a
// plain-scalar overload beside its dual one, in this namespace, so an
// expression written once compiles for T (the primal alone) and for
// Dual<T, NA> (value and tangents); mixed dual / scalar arithmetic treats
// the scalar as a constant.  Nothing here allocates or synchronises.

#ifndef GT_DUAL_CUH
#define GT_DUAL_CUH

#include <math.h>
#include <type_traits>

#define GT_HD __device__ __forceinline__

namespace gt {

template <typename T, int NA>
struct Dual {
  typedef T scalar;
  static constexpr int na = NA;
  T v;
  T d[NA > 0 ? NA : 1];
};

template <typename X>
struct is_dual : std::false_type {};
template <typename T, int NA>
struct is_dual<Dual<T, NA>> : std::true_type {};

#define GT_DUAL template <typename T, int NA> GT_HD Dual<T, NA>
#define GT_DUAL_S                                                         \
  template <typename T, int NA, typename S,                               \
            typename = typename std::enable_if<std::is_arithmetic<S>::value>::type> \
  GT_HD Dual<T, NA>

template <typename T, int NA>
GT_HD Dual<T, NA> constant(T v) {
  Dual<T, NA> r;
  r.v = v;
#pragma unroll
  for (int j = 0; j < NA; ++j) r.d[j] = T(0);
  return r;
}

// The primal of a scalar or a dual.
template <typename X>
GT_HD X value_of(const X& x) { return x; }
template <typename T, int NA>
GT_HD T value_of(const Dual<T, NA>& x) { return x.v; }

// x as type R: a scalar becomes a constant dual; a dual stays itself.
template <typename R, typename X>
GT_HD R promote(const X& x) {
  if constexpr (is_dual<R>::value && !is_dual<X>::value) {
    return constant<typename R::scalar, R::na>(typename R::scalar(x));
  } else {
    return R(x);
  }
}

// The type of an expression mixing a and b: the dual one, if any.
template <typename A, typename B>
using common_t = typename std::conditional<is_dual<A>::value, A, B>::type;

// Arithmetic.

GT_DUAL operator+(const Dual<T, NA>& a, const Dual<T, NA>& b) {
  Dual<T, NA> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int j = 0; j < NA; ++j) r.d[j] = a.d[j] + b.d[j];
  return r;
}

GT_DUAL operator-(const Dual<T, NA>& a, const Dual<T, NA>& b) {
  Dual<T, NA> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int j = 0; j < NA; ++j) r.d[j] = a.d[j] - b.d[j];
  return r;
}

GT_DUAL operator-(const Dual<T, NA>& a) {
  Dual<T, NA> r;
  r.v = -a.v;
#pragma unroll
  for (int j = 0; j < NA; ++j) r.d[j] = -a.d[j];
  return r;
}

GT_DUAL operator+(const Dual<T, NA>& a) { return a; }

GT_DUAL operator*(const Dual<T, NA>& a, const Dual<T, NA>& b) {
  Dual<T, NA> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int j = 0; j < NA; ++j) r.d[j] = a.d[j] * b.v + a.v * b.d[j];
  return r;
}

GT_DUAL operator/(const Dual<T, NA>& a, const Dual<T, NA>& b) {
  Dual<T, NA> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int j = 0; j < NA; ++j) r.d[j] = (a.d[j] - r.v * b.d[j]) / b.v;
  return r;
}

GT_DUAL_S operator+(const Dual<T, NA>& a, S s) {
  Dual<T, NA> r = a;
  r.v = a.v + T(s);
  return r;
}
GT_DUAL_S operator+(S s, const Dual<T, NA>& a) { return a + s; }
GT_DUAL_S operator-(const Dual<T, NA>& a, S s) {
  Dual<T, NA> r = a;
  r.v = a.v - T(s);
  return r;
}
GT_DUAL_S operator-(S s, const Dual<T, NA>& a) {
  Dual<T, NA> r = -a;
  r.v = T(s) - a.v;
  return r;
}
GT_DUAL_S operator*(const Dual<T, NA>& a, S s) {
  Dual<T, NA> r;
  r.v = a.v * T(s);
#pragma unroll
  for (int j = 0; j < NA; ++j) r.d[j] = a.d[j] * T(s);
  return r;
}
GT_DUAL_S operator*(S s, const Dual<T, NA>& a) { return a * s; }
GT_DUAL_S operator/(const Dual<T, NA>& a, S s) {
  Dual<T, NA> r;
  r.v = a.v / T(s);
#pragma unroll
  for (int j = 0; j < NA; ++j) r.d[j] = a.d[j] / T(s);
  return r;
}
GT_DUAL_S operator/(S s, const Dual<T, NA>& a) {
  Dual<T, NA> r;
  r.v = T(s) / a.v;
#pragma unroll
  for (int j = 0; j < NA; ++j) r.d[j] = -r.v * a.d[j] / a.v;
  return r;
}

// The tangent part of a dual (value 0), for adding a closed-form
// derivative times it; a scalar has none.
GT_DUAL tangent_of(const Dual<T, NA>& a) {
  Dual<T, NA> r = a;
  r.v = T(0);
  return r;
}

// Elementary functions: every scalar overload first (the dual versions'
// slopes call them), then f(a) with the tangents f'(a) da.

#define GT_SCALAR(name, cfun)                                             \
  GT_HD float name(float x) { return ::cfun##f(x); }                      \
  GT_HD double name(double x) { return ::cfun(x); }

GT_SCALAR(exp, exp)
GT_SCALAR(log, log)
GT_SCALAR(sqrt, sqrt)
GT_SCALAR(sin, sin)
GT_SCALAR(cos, cos)
GT_SCALAR(tan, tan)
GT_SCALAR(sinh, sinh)
GT_SCALAR(cosh, cosh)
GT_SCALAR(tanh, tanh)
GT_SCALAR(fabs, fabs)
GT_SCALAR(erf, erf)
GT_SCALAR(erfc, erfc)

#undef GT_SCALAR

// slope is f'(x) written in x (the primal) and y = f(x).
#define GT_UNARY(name, slope_expr)                                        \
  GT_DUAL name(const Dual<T, NA>& a) {                                    \
    Dual<T, NA> r;                                                        \
    const T x = a.v;                                                      \
    const T y = name(x);                                                  \
    (void)x;                                                              \
    (void)y;                                                              \
    const T slope = (slope_expr);                                         \
    r.v = y;                                                              \
    _Pragma("unroll") for (int j = 0; j < NA; ++j) r.d[j] = a.d[j] * slope; \
    return r;                                                             \
  }

GT_UNARY(exp, y)
GT_UNARY(log, T(1) / x)
GT_UNARY(sqrt, T(0.5) / y)
GT_UNARY(sin, cos(x))
GT_UNARY(cos, -sin(x))
GT_UNARY(tan, T(1) + y * y)
GT_UNARY(sinh, cosh(x))
GT_UNARY(cosh, sinh(x))
GT_UNARY(tanh, T(1) - y * y)
GT_UNARY(fabs, x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0)))
GT_UNARY(erf, T(1.1283791670955126) * exp(-x * x))
GT_UNARY(erfc, T(-1.1283791670955126) * exp(-x * x))

#undef GT_UNARY

// pow with a real exponent: a ** b = exp(b log a) in its derivatives.
GT_HD float pow(float a, float b) { return ::powf(a, b); }
GT_HD double pow(double a, double b) { return ::pow(a, b); }

GT_DUAL pow(const Dual<T, NA>& a, const Dual<T, NA>& b) {
  Dual<T, NA> r;
  r.v = pow(a.v, b.v);
  const T da = b.v * pow(a.v, b.v - T(1));
  const T db = r.v * log(a.v);
#pragma unroll
  for (int j = 0; j < NA; ++j) r.d[j] = a.d[j] * da + b.d[j] * db;
  return r;
}
GT_DUAL_S pow(const Dual<T, NA>& a, S b) {
  Dual<T, NA> r;
  r.v = pow(a.v, T(b));
  const T da = T(b) * pow(a.v, T(b) - T(1));
#pragma unroll
  for (int j = 0; j < NA; ++j) r.d[j] = a.d[j] * da;
  return r;
}
GT_DUAL_S pow(S a, const Dual<T, NA>& b) {
  Dual<T, NA> r;
  r.v = pow(T(a), b.v);
  const T db = r.v * log(T(a));
#pragma unroll
  for (int j = 0; j < NA; ++j) r.d[j] = b.d[j] * db;
  return r;
}

// pow with a static integral exponent, by repeated products (C's pow of a
// negative base by an integral real, without the NaN of exp(b log a)).
template <int K, typename X>
GT_HD X ipow(const X& x) {
  if constexpr (K < 0) {
    return promote<X>(1.0f) / ipow<-K>(x);
  } else if constexpr (K == 0) {
    return promote<X>(1.0f);
  } else if constexpr (K == 1) {
    return x;
  } else {
    return ipow<K - 1>(x) * x;
  }
}

// Selection: both operands promoted to the common type.
template <typename A, typename B>
GT_HD common_t<A, B> where(bool c, const A& a, const B& b) {
  return c ? promote<common_t<A, B>>(a) : promote<common_t<A, B>>(b);
}
template <typename A, typename B>
GT_HD common_t<A, B> maximum(const A& a, const B& b) {
  return where(value_of(a) >= value_of(b), a, b);
}
template <typename A, typename B>
GT_HD common_t<A, B> minimum(const A& a, const B& b) {
  return where(value_of(a) <= value_of(b), a, b);
}

}  // namespace gt

#endif  // GT_DUAL_CUH
