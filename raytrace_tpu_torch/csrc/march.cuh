// Per-ray Kerr geodesic march: the step of ops/integrate.py, one ray at a time.
//
// Shared by the CUDA kernel (march.cu, built by nvcc for sm_90a) and the
// host build the CPU tests compile with g++ (march_host.cpp). The header
// includes no CUDA header: RT_HD is __host__ __device__ under nvcc and plain
// `inline` otherwise.
//
// Each function mirrors its counterpart in raytrace_tpu_torch/ops/integrate.py
// and geometry/kerr.py op for op (same operand order, same finfo.tiny floors,
// same NaN behaviour of max/min), so a build without FMA contraction (g++
// -ffp-contract=off, nvcc --fmad=false) rounds like the plain torch march
// wherever the two libms agree on sin/cos/pow. What the lock-step
// march does with masks happens here with branches: a ray that is no longer
// active leaves the loop, so the _safe_eval_state pass is not needed.

#pragma once

#include <float.h>
#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define RT_HD __host__ __device__ __forceinline__
#define RT_NOINLINE static __host__ __device__ __noinline__
#else
#define RT_HD inline
#define RT_NOINLINE static __attribute__((noinline))
#endif

namespace rt {

constexpr int STATUS_DEST = 1 << 0;
constexpr int STATUS_HORIZON = 1 << 1;
constexpr int STATUS_RLIM = 1 << 2;
constexpr int STATUS_STEPLIM = 1 << 3;
constexpr int STATUS_ERGO = 1 << 4;
constexpr int STATUS_NEG_ENERGY = 1 << 5;
constexpr int STATUS_NUMERIC = 1 << 6;
constexpr int STATUS_TERMINAL = STATUS_DEST | STATUS_HORIZON | STATUS_RLIM |
                                STATUS_STEPLIM | STATUS_NUMERIC;

constexpr int METHOD_RK4 = 1;
constexpr int METHOD_RK45 = 2;
constexpr int METHOD_EULER = 3;

// Destinations (destinations.py): the parameters p0..p3 of Params are
//   DEST_THETA  ThetaLimit / FlatDisc   (theta_lim, -, -, -)
//   DEST_ISCO   DiscWithISCO            (r_isco, r_out, theta_lim, -)
//   DEST_PLANE  FlatPlane               (sin incl, cos incl, phi0, z_s)
//   DEST_SHELL  SphericalShell          (r_shell, -, -, -)
// FlatPlane's sin and cos of the inclination are made once in double on the
// host (math.sin, as the plain FlatPlane makes them) and rounded to T like
// the other parameters, so no step evaluates them in T.
constexpr int DEST_THETA = 0;
constexpr int DEST_ISCO = 1;
constexpr int DEST_PLANE = 2;
constexpr int DEST_SHELL = 3;

constexpr double PI = 3.14159265358979323846;

// DOPRI5 tableau (Dormand & Prince 1980), as in ops/integrate.py: each
// constant is computed in double and rounded once to the working type.
constexpr double A21 = 1.0 / 5;
constexpr double A31 = 3.0 / 40, A32 = 9.0 / 40;
constexpr double A41 = 44.0 / 45, A42 = -56.0 / 15, A43 = 32.0 / 9;
constexpr double A51 = 19372.0 / 6561, A52 = -25360.0 / 2187,
                 A53 = 64448.0 / 6561, A54 = -212.0 / 729;
constexpr double A61 = 9017.0 / 3168, A62 = -355.0 / 33, A63 = 46732.0 / 5247,
                 A64 = 49.0 / 176, A65 = -5103.0 / 18656;
constexpr double B1 = 35.0 / 384, B3 = 500.0 / 1113, B4 = 125.0 / 192,
                 B5 = -2187.0 / 6784, B6 = 11.0 / 84;
constexpr double E1 = 71.0 / 57600, E3 = -71.0 / 16695, E4 = 71.0 / 1920,
                 E5 = -17253.0 / 339200, E6 = 22.0 / 525, E7 = -1.0 / 40;

// Precise libm calls for each working type (no fast-math intrinsics).
//
// sin and cos go through a guard. The CUDA math library reduces the
// argument of sinf/cosf (sin/cos) with a few FMAs (Cody-Waite) while
// |x| < TRIG_FAST_F32 (TRIG_FAST_F64), and beyond it with a Payne-Hanek
// reduction: a loop over a table, through local memory in float32, a
// call in float64. Inlined into the step, that slow path costs the step
// registers, branches and a stack frame, and a ray never takes it (|theta|
// stays near [0, pi]). The guard's branch to the out-of-line functions
// below is the library's own test, `fabs(x) >= TRIG_FAST_*` (the
// thresholds are those of its PTX, setp.ltu against 105615 and 2^31), so
// the compiler knows it false on the fast branch and drops the slow path
// there; a test in any other form (`fabs(x) < threshold`) leaves it in.
// NaN fails the test and takes the fast branch, as in the library. Both
// branches call the same sinf/cosf (sin/cos), so the bits are the
// library's by construction. On the card the fast branch takes sin and
// cos of one angle with one sincosf (sincos) call, which shares the range
// reduction that two calls do apart and gives their bits (chip_smoke.py
// checks every float and 1e9 doubles); the host build calls sin and cos.
constexpr float TRIG_FAST_F32 = 105615.0f;
constexpr double TRIG_FAST_F64 = 2147483648.0;

template <typename T> struct SinCos {
  T s, c;
};

RT_NOINLINE SinCos<float> sincos_far(float x) { return SinCos<float>{sinf(x), cosf(x)}; }
RT_NOINLINE SinCos<double> sincos_far(double x) { return SinCos<double>{sin(x), cos(x)}; }
RT_NOINLINE float cos_far(float x) { return cosf(x); }
RT_NOINLINE double cos_far(double x) { return cos(x); }

RT_HD SinCos<float> m_sincos(float x) {
  if (fabsf(x) >= TRIG_FAST_F32) return sincos_far(x);
#if defined(__CUDA_ARCH__)
  SinCos<float> o;
  sincosf(x, &o.s, &o.c);
  return o;
#else
  return SinCos<float>{sinf(x), cosf(x)};
#endif
}
RT_HD SinCos<double> m_sincos(double x) {
  if (fabs(x) >= TRIG_FAST_F64) return sincos_far(x);
#if defined(__CUDA_ARCH__)
  SinCos<double> o;
  sincos(x, &o.s, &o.c);
  return o;
#else
  return SinCos<double>{sin(x), cos(x)};
#endif
}
RT_HD float m_cos(float x) { return fabsf(x) >= TRIG_FAST_F32 ? cos_far(x) : cosf(x); }
RT_HD double m_cos(double x) { return fabs(x) >= TRIG_FAST_F64 ? cos_far(x) : cos(x); }
RT_HD float m_sqrt(float x) { return sqrtf(x); }
RT_HD double m_sqrt(double x) { return sqrt(x); }
RT_HD float m_abs(float x) { return fabsf(x); }
RT_HD double m_abs(double x) { return fabs(x); }
RT_HD float m_pow(float x, float y) { return powf(x, y); }
RT_HD double m_pow(double x, double y) { return pow(x, y); }

template <typename T> struct Lim;
template <> struct Lim<float> {
  RT_HD static float tiny() { return FLT_MIN; }
  RT_HD static float eps() { return FLT_EPSILON; }
  RT_HD static float max() { return FLT_MAX; }
  RT_HD static float inf() { return HUGE_VALF; }
};
template <> struct Lim<double> {
  RT_HD static double tiny() { return DBL_MIN; }
  RT_HD static double eps() { return DBL_EPSILON; }
  RT_HD static double max() { return DBL_MAX; }
  RT_HD static double inf() { return HUGE_VAL; }
};

// torch.maximum / torch.minimum: a NaN operand gives NaN.
template <typename T> RT_HD T vmax(T a, T b) { return (a > b || a != a) ? a : b; }
// vmax against a floor c that is a constant, never NaN: then "a > c or a
// is NaN" is "not a <= c", one compare where vmax takes two, and the
// result is vmax's for every a.
template <typename T> RT_HD T vmax_floor(T a, T c) { return !(a <= c) ? a : c; }
template <typename T> RT_HD T vmin(T a, T b) { return (a < b || a != a) ? a : b; }
template <typename T> RT_HD bool finite(T x) { return m_abs(x) <= Lim<T>::max(); }

// _safe_div: |den| floored at the smallest normal.
template <typename T> RT_HD T safe_div(T num, T den) {
  const T t = Lim<T>::tiny();
  const T s = m_abs(den) < t ? (den < 0 ? -t : t) : den;
  return num / s;
}

template <typename T> struct Ctrl {
  T precision, theta_precision, max_tstep, maxtstep_rlim, max_phistep,
      min_step, rk45_tol, horizon_eps, safety, fac_min, fac_max;
};

// The spin a and the two products of it that the rates take. The plain
// march multiplies the Python-float spin in double (a * a, 2.0 * a * a) and
// rounds the product once into the working type; these are made the same
// way on the host, so a float32 march of an unrounded spin rounds alike.
template <typename T> struct Spin {
  T a, a2, two_a2;
};

// The constants of a step in the working type: the DOPRI5 tableau and pi,
// each rounded once from the double above (make_params). The step reads
// them from the launch parameters (Params::k, the constant bank): a double
// that is not a short immediate would cost the card two uniform moves at
// each use; a float operand from the constant bank costs what an
// immediate does. The same values and the same operations either way.
template <typename T> struct Consts {
  T a21, a31, a32, a41, a42, a43, a51, a52, a53, a54, a61, a62, a63, a64, a65;
  T b1, b3, b4, b5, b6, e1, e3, e4, e5, e6, e7;
  T pi, two_pi, half_pi;
};

// Scalars of one march: spin, outer radius, the inner absorbing radius and
// the destination's four parameters (see DEST_*), plus the step budgets
// and the step's constants.
template <typename T> struct Params {
  Spin<T> spin;
  T r_max, horizon, p0, p1, p2, p3;
  int steplim, max_iters;
  Ctrl<T> c;
  Consts<T> k;
};

// The 21 per-ray arrays the march reads and writes (struct of arrays).
// emit travels with the batch but the march does not change it.
template <typename T> struct Fields {
  T *t, *r, *theta, *phi, *pt, *pr, *ptheta, *pphi;
  const T *k, *h, *Q;
  T *rdot_sign, *thetadot_sign, *dt;
  const T* emit;
  int32_t *steps, *status, *rdot_flips, *eq_cross;
  bool *r_was_positive, *theta_was_positive;
};

template <typename T> struct Ray {
  T t, r, theta, phi, pt, pr, ptheta, pphi, k, h, Q, rdot_sign, thetadot_sign, dt;
  int32_t steps, status, rdot_flips, eq_cross;
  bool rwp, twp;
};

template <typename T> struct Rates {
  T pt, pr, ptheta, pphi, thetadot_sq, rdot_sq, sin_t, inv_rhosq;
};

// geometry/kerr.py geodesic_rates, op for op.
template <typename T>
RT_HD Rates<T> geodesic_rates(T r, T theta, T k, T h, T Q, T rdot_sign,
                              T thetadot_sign, const Spin<T>& s) {
  const T a = s.a;
  const SinCos<T> sc = m_sincos(theta);
  const T sin_t = sc.s;
  const T cos_t = sc.c;
  T sin2 = sin_t * sin_t;
  const T rhosq = r * r + (a * cos_t) * (a * cos_t);
  const T delta = r * r - T(2) * r + s.a2;
  const T tiny = Lim<T>::tiny();
  sin2 = vmax_floor(sin2, tiny);
  const T rd = rhosq * delta;
  const T inv_all = T(1) / (rd * sin2);
  const T inv_rhosq_delta = inv_all * sin2;
  const T inv_sin2 = inv_all * rd;
  const T inv_rhosq = delta * inv_rhosq_delta;

  Rates<T> o;
  o.pt = ((rhosq * (r * r + s.a2) + s.two_a2 * r * sin2) * k -
          T(2) * a * r * h) * inv_rhosq_delta;
  o.pphi = (T(2) * a * r * sin2 * k + (rhosq - T(2) * r) * h) * inv_all;
  const T cos2 = cos_t * cos_t;
  const T ka = k * a;
  o.thetadot_sq = (Q + cos2 * (ka * ka - h * h * inv_sin2)) * (inv_rhosq * inv_rhosq);
  o.ptheta = m_sqrt(vmax_floor(m_abs(o.thetadot_sq), tiny)) * thetadot_sign;
  o.rdot_sq = (k * o.pt - h * o.pphi - rhosq * o.ptheta * o.ptheta) * (delta * inv_rhosq);
  o.pr = m_sqrt(vmax_floor(m_abs(o.rdot_sq), tiny)) * rdot_sign;
  o.sin_t = sin_t;
  o.inv_rhosq = inv_rhosq;
  return o;
}

// ThetaLimit.step_limit: parameter distance to the surface along ptheta.
template <typename T>
RT_HD T theta_step_limit(T tl, T theta, T ptheta) {
  if (tl > 0 && ptheta > 0 && theta < tl) return (tl - theta) / ptheta;
  if (tl < 0 && ptheta < 0 && theta > -tl) return (-tl - theta) / ptheta;
  return Lim<T>::inf();
}

template <typename T> RT_HD bool theta_reached(T tl, T theta) {
  return (tl > 0 && theta >= tl) || (tl < 0 && theta <= -tl);
}

// DiscWithISCO._in_annulus: r in [r_isco, r_out]; r_out <= 0 has no outer edge.
template <typename T> RT_HD bool in_annulus(const Params<T>& p, T r) {
  return r >= p.p0 && (p.p1 <= 0 || r <= p.p1);
}

// Destination.reached after a committed step from prev_theta. DiscWithISCO
// stops only where theta crossed |theta_lim| since the previous step, from
// either side, inside the annulus; theta_lim == 0 never stops. FlatPlane
// stops where the projection onto the line of sight (FlatPlane.projection,
// same operand order) is at or below -z_s; SphericalShell at r >= r_shell.
template <int DEST, typename T>
RT_HD bool dest_reached(const Params<T>& p, T r, T theta, T phi, T prev_theta) {
  if (DEST == DEST_THETA) return theta_reached(p.p0, theta);
  if (DEST == DEST_PLANE) {
    const SinCos<T> sc = m_sincos(theta);
    return r * (sc.s * p.p0 * m_cos(phi - p.p2) + sc.c * p.p1) <= -p.p3;
  }
  if (DEST == DEST_SHELL) return r >= p.p0;
  const T tl = p.p2;
  const T lim = tl > 0 ? tl : -tl;
  const bool crossed = (prev_theta < lim && theta >= lim) || (prev_theta > lim && theta <= lim);
  return tl != 0 && crossed && in_annulus(p, r);
}

// Destination.step_limit at the step's starting point: DiscWithISCO clamps
// onto its surface only where the step starts inside the annulus;
// SphericalShell caps the step along pr where the ray climbs towards the
// shell from inside; FlatPlane has no cap (the base Destination's +inf).
template <int DEST, typename T>
RT_HD T dest_step_limit(const Params<T>& p, T r, T theta, T pr, T ptheta) {
  if (DEST == DEST_THETA) return theta_step_limit(p.p0, theta, ptheta);
  if (DEST == DEST_PLANE) return Lim<T>::inf();
  if (DEST == DEST_SHELL) return (pr > 0 && r < p.p0) ? (p.p0 - r) / pr : Lim<T>::inf();
  return in_annulus(p, r) ? theta_step_limit(p.p2, theta, ptheta) : Lim<T>::inf();
}

template <typename T> RT_HD bool is_active(const Ray<T>& ray) {
  return ray.steps >= 0 && (ray.status & STATUS_TERMINAL) == 0;
}

// _k1_stage: turning-point sign bookkeeping on rates at the current point.
template <typename T> struct K1 {
  bool theta_flip, r_flip, rwp, twp;
  T rdot_sign, thetadot_sign, pr1;
};

template <typename T> RT_HD K1<T> k1_stage(const Ray<T>& ray, const Rates<T>& k1) {
  K1<T> s;
  s.theta_flip = k1.thetadot_sq < 0 && ray.twp;
  s.thetadot_sign = s.theta_flip ? -ray.thetadot_sign : ray.thetadot_sign;
  s.twp = !s.theta_flip && k1.thetadot_sq >= 0;
  s.r_flip = k1.rdot_sq <= 0 && ray.rwp && !s.theta_flip;
  s.rdot_sign = s.r_flip ? -ray.rdot_sign : ray.rdot_sign;
  s.rwp = s.theta_flip ? ray.rwp : (k1.rdot_sq > 0);
  s.pr1 = m_abs(k1.pr) * s.rdot_sign;
  return s;
}

// _nonphysical_status and _k1_finite for an advancing ray; returns false
// (and flags NUMERIC) when the first-stage rates are not finite.
template <typename T>
RT_HD bool k1_checks(Ray<T>& ray, T a, const Rates<T>& k1, T pr1) {
  const T killing = (T(1) - T(2) * ray.r * k1.inv_rhosq) * k1.pt +
                    (T(2) * a * ray.r * k1.sin_t * k1.sin_t * k1.inv_rhosq) * k1.pphi;
  if (k1.pt <= 0) ray.status |= STATUS_ERGO;
  if (killing < 0) ray.status |= STATUS_NEG_ENERGY;
  if (finite(k1.pt) && finite(pr1) && finite(k1.ptheta) && finite(k1.pphi)) return true;
  ray.status |= STATUS_NUMERIC;
  return false;
}

// _polar_reflect on one ray.
template <typename T>
RT_HD void polar_reflect(const Consts<T>& k, T& theta, T& phi, T& thetadot_sign) {
  const bool low = theta < 0;
  const bool high = theta > k.pi;
  theta = low ? -theta : (high ? k.two_pi - theta : theta);
  if (low || high) {
    phi = phi + k.pi;
    thetadot_sign = -thetadot_sign;
  }
}

// The position half of _commit for an accepted step: new point and
// momentum, equator crossing, then horizon > rlim > destination.
template <int DEST, typename T>
RT_HD void commit(Ray<T>& ray, const Params<T>& p, T capture, T t, T r, T theta,
                  T phi, T pt, T pr, T ptheta, T pphi) {
  const T prev_theta = ray.theta;
  ray.t = t;
  ray.r = r;
  ray.theta = theta;
  ray.phi = phi;
  ray.pt = pt;
  ray.pr = pr;
  ray.ptheta = ptheta;
  ray.pphi = pphi;
  const T half_pi = p.k.half_pi;
  if ((prev_theta < half_pi && theta >= half_pi) || (prev_theta > half_pi && theta <= half_pi))
    ray.eq_cross += 1;
  if (r <= capture)
    ray.status |= STATUS_HORIZON;
  else if (p.r_max > 0 && r >= p.r_max)
    ray.status |= STATUS_RLIM;
  else if (dest_reached<DEST>(p, r, theta, phi, prev_theta))
    ray.status |= STATUS_DEST;
}

// The counting half of _commit: step and turning-point counters, then the
// step-limit test, which follows the count.
template <typename T>
RT_HD void count_step(Ray<T>& ray, const Params<T>& p, bool counted, bool r_flip) {
  if (counted) {
    ray.steps += 1;
    if (r_flip) ray.rdot_flips += 1;
  }
  if (ray.steps >= 0 && (ray.status & (STATUS_DEST | STATUS_HORIZON | STATUS_RLIM)) == 0 &&
      ray.steps >= p.steplim)
    ray.status |= STATUS_STEPLIM;
}

// One Euler or RK4 iteration (_euler_rk4_body).
template <typename T, int METHOD, int DEST>
RT_HD void euler_rk4_step(Ray<T>& ray, const Params<T>& p, T capture) {
  const Spin<T>& a = p.spin;
  const Ctrl<T>& c = p.c;
  const Rates<T> k1 = geodesic_rates(ray.r, ray.theta, ray.k, ray.h, ray.Q,
                                     ray.rdot_sign, ray.thetadot_sign, a);
  const K1<T> s = k1_stage(ray, k1);
  ray.rdot_sign = s.rdot_sign;
  ray.thetadot_sign = s.thetadot_sign;
  ray.rwp = s.rwp;
  ray.twp = s.twp;
  // a flip ray skips the step but still counts it (integrate.py:138-145)
  if (s.theta_flip || !k1_checks(ray, a.a, k1, s.pr1)) {
    count_step(ray, p, true, s.r_flip);
    return;
  }
  const T pt1 = k1.pt, pr1 = s.pr1, pth1 = k1.ptheta, pph1 = k1.pphi;
  const T r = ray.r, theta = ray.theta;

  // _base_step_size, then (ThetaLimit only: integrate.py:289-293) the clamp
  // onto the surface
  T step = m_abs(safe_div(r - p.horizon, pr1)) / c.precision;
  const T theta_cap = m_abs(safe_div(theta, pth1));
  if (step > theta_cap / c.precision) step = theta_cap / c.theta_precision;
  if (c.max_tstep > 0) {
    const T t_cap = m_abs(safe_div(c.max_tstep, pt1));
    if (r < c.maxtstep_rlim && step > t_cap) step = t_cap;
  }
  if (c.max_phistep > 0) {
    const T phi_cap = m_abs(safe_div(c.max_phistep, pph1));
    if (step > phi_cap) step = phi_cap;
  }
  step = vmax(step, c.min_step);
  if (p.r_max > 0 && r + pr1 * step > p.r_max) step = m_abs(safe_div(p.r_max - r, pr1));
  if (DEST == DEST_THETA) step = vmin(step, theta_step_limit(p.p0, theta, pth1));

  if (METHOD == METHOD_EULER) {  // the step is the k1 rates; they are the new momentum
    const T t_n = ray.t + pt1 * step;
    const T r_n = r + pr1 * step;
    T th_n = theta + pth1 * step;
    T ph_n = ray.phi + pph1 * step;
    polar_reflect(p.k, th_n, ph_n, ray.thetadot_sign);
    commit<DEST>(ray, p, capture, t_n, r_n, th_n, ph_n, pt1, pr1, pth1, pph1);
    count_step(ray, p, true, s.r_flip);
    return;
  }
  const T half = step / T(2);
  const T rs = s.rdot_sign, ts = s.thetadot_sign;
  const Rates<T> k2 = geodesic_rates(r + half * pr1, theta + half * pth1, ray.k, ray.h, ray.Q, rs, ts, a);
  const Rates<T> k3 = geodesic_rates(r + half * k2.pr, theta + half * k2.ptheta, ray.k, ray.h, ray.Q, rs, ts, a);
  const Rates<T> k4 = geodesic_rates(r + step * k3.pr, theta + step * k3.ptheta, ray.k, ray.h, ray.Q, rs, ts, a);
  const T w = step / T(6);
  const T t_n = ray.t + w * (pt1 + T(2) * k2.pt + T(2) * k3.pt + k4.pt);
  const T r_n = r + w * (pr1 + T(2) * k2.pr + T(2) * k3.pr + k4.pr);
  T th_n = theta + w * (pth1 + T(2) * k2.ptheta + T(2) * k3.ptheta + k4.ptheta);
  T ph_n = ray.phi + w * (pph1 + T(2) * k2.pphi + T(2) * k3.pphi + k4.pphi);
  polar_reflect(p.k, th_n, ph_n, ray.thetadot_sign);

  commit<DEST>(ray, p, capture, t_n, r_n, th_n, ph_n, k4.pt, k4.pr, k4.ptheta, k4.pphi);
  count_step(ray, p, true, s.r_flip);
}

// One DOPRI5 iteration (_rk45_body). `step` is the carried adaptive step
// and `k1` the FSAL carry: rates at the current point. Returns whether a
// step was accepted (and committed).
template <typename T, int DEST>
RT_HD bool rk45_step(Ray<T>& ray, const Params<T>& p, T capture, T& step, Rates<T>& k1) {
  const Spin<T>& a = p.spin;
  const Ctrl<T>& c = p.c;
  k1.ptheta = m_abs(k1.ptheta) * ray.thetadot_sign;
  const K1<T> s = k1_stage(ray, k1);
  ray.rdot_sign = s.rdot_sign;
  ray.thetadot_sign = s.thetadot_sign;
  ray.rwp = s.rwp;
  ray.twp = s.twp;
  if (s.theta_flip) {  // skips the step, counts it; step and carry unchanged
    count_step(ray, p, true, false);
    return false;
  }
  if (!k1_checks(ray, a.a, k1, s.pr1)) {
    count_step(ray, p, false, false);
    return false;
  }
  const T pt1 = k1.pt, pr1 = s.pr1, pth1 = k1.ptheta, pph1 = k1.pphi;
  const T r = ray.r, theta = ray.theta;

  // horizon step-cap on the carried step (raytracer.cpp:1412-1434)
  T step_max = m_abs(safe_div(r - p.horizon, pr1)) / c.precision;
  if (c.max_phistep > 0) step_max = vmin(step_max, m_abs(safe_div(c.max_phistep, pph1)));
  if (c.max_tstep > 0 && r < c.maxtstep_rlim)
    step_max = vmin(step_max, m_abs(safe_div(c.max_tstep, pt1)));
  if (step > step_max) step = step_max;

  // destination clamp: a clamped accepted step keeps the old step size
  const T lim = dest_step_limit<DEST>(p, r, theta, pr1, pth1);
  const bool clamped = lim < step;
  const T h_try = clamped ? lim : step;

  const T rs = s.rdot_sign, ts = s.thetadot_sign;
  const T kk = ray.k, hh = ray.h, QQ = ray.Q;
  const Consts<T> tab = p.k;
  const Rates<T> k2 = geodesic_rates(r + h_try * (tab.a21 * pr1), theta + h_try * (tab.a21 * pth1),
                                     kk, hh, QQ, rs, ts, a);
  const Rates<T> k3 = geodesic_rates(
      r + h_try * (tab.a31 * pr1 + tab.a32 * k2.pr),
      theta + h_try * (tab.a31 * pth1 + tab.a32 * k2.ptheta), kk, hh, QQ, rs, ts, a);
  const Rates<T> k4 = geodesic_rates(
      r + h_try * (tab.a41 * pr1 + tab.a42 * k2.pr + tab.a43 * k3.pr),
      theta + h_try * (tab.a41 * pth1 + tab.a42 * k2.ptheta + tab.a43 * k3.ptheta),
      kk, hh, QQ, rs, ts, a);
  const Rates<T> k5 = geodesic_rates(
      r + h_try * (tab.a51 * pr1 + tab.a52 * k2.pr + tab.a53 * k3.pr + tab.a54 * k4.pr),
      theta + h_try * (tab.a51 * pth1 + tab.a52 * k2.ptheta + tab.a53 * k3.ptheta +
                       tab.a54 * k4.ptheta),
      kk, hh, QQ, rs, ts, a);
  const Rates<T> k6 = geodesic_rates(
      r + h_try * (tab.a61 * pr1 + tab.a62 * k2.pr + tab.a63 * k3.pr + tab.a64 * k4.pr +
                   tab.a65 * k5.pr),
      theta + h_try * (tab.a61 * pth1 + tab.a62 * k2.ptheta + tab.a63 * k3.ptheta +
                       tab.a64 * k4.ptheta + tab.a65 * k5.ptheta),
      kk, hh, QQ, rs, ts, a);

  // 5th-order solution (b2 = 0), reflect, then the FSAL stage k7 at the new
  // point with the pre-reflection polar sign
  const T r_new = r + h_try * (tab.b1 * pr1 + tab.b3 * k3.pr + tab.b4 * k4.pr + tab.b5 * k5.pr +
                               tab.b6 * k6.pr);
  T th_new = theta + h_try * (tab.b1 * pth1 + tab.b3 * k3.ptheta + tab.b4 * k4.ptheta +
                              tab.b5 * k5.ptheta + tab.b6 * k6.ptheta);
  const T t_new = ray.t + h_try * (tab.b1 * pt1 + tab.b3 * k3.pt + tab.b4 * k4.pt +
                                   tab.b5 * k5.pt + tab.b6 * k6.pt);
  T phi_new = ray.phi + h_try * (tab.b1 * pph1 + tab.b3 * k3.pphi + tab.b4 * k4.pphi +
                                 tab.b5 * k5.pphi + tab.b6 * k6.pphi);
  T ts_r = ts;
  polar_reflect(tab, th_new, phi_new, ts_r);
  const Rates<T> k7 = geodesic_rates(r_new, th_new, kk, hh, QQ, rs, ts, a);

  const T err_r = h_try * (tab.e1 * pr1 + tab.e3 * k3.pr + tab.e4 * k4.pr + tab.e5 * k5.pr +
                           tab.e6 * k6.pr + tab.e7 * k7.pr);
  const T err_th = h_try * (tab.e1 * pth1 + tab.e3 * k3.ptheta + tab.e4 * k4.ptheta +
                            tab.e5 * k5.ptheta + tab.e6 * k6.ptheta + tab.e7 * k7.ptheta);
  const T sc_r = c.rk45_tol * (T(1) + vmax(m_abs(r), m_abs(r_new)));
  const T sc_th = c.rk45_tol * (T(1) + vmax(m_abs(theta), m_abs(th_new)));
  const T e_r = err_r / sc_r;
  const T e_th = err_th / sc_th;
  const T err_norm = m_sqrt(T(0.5) * (e_r * e_r + e_th * e_th));

  // a non-finite trial is a maximal-error reject; still non-finite at the
  // MIN_STEP floor, the ray is numerically dead
  const bool trial_ok = finite(err_norm) && finite(r_new) && finite(th_new) &&
                        finite(t_new) && finite(phi_new);
  const T err_eff = trial_ok ? err_norm : T(1e30);
  if (!trial_ok && h_try <= c.min_step) ray.status |= STATUS_NUMERIC;

  T fac = c.safety * m_pow(T(1) / vmax_floor(err_eff, T(1e-10)), T(0.2));
  fac = vmin(vmax(fac, c.fac_min), c.fac_max);
  const T step_new = vmax(h_try * fac, c.min_step);

  const bool accept_err = err_eff <= T(1);
  const bool force = !accept_err && step_new <= c.min_step;
  const bool accept = (accept_err || force) && trial_ok;

  step = (accept_err && clamped) ? step : step_new;
  if (accept) {
    ray.thetadot_sign = ts_r;
    commit<DEST>(ray, p, capture, t_new, r_new, th_new, phi_new, k7.pt, k7.pr, k7.ptheta, k7.pphi);
    k1 = k7;
  }
  count_step(ray, p, accept, s.r_flip);
  return accept;
}

// capture shell floored at 200 ulp of the working type (_commit)
template <typename T> RT_HD T capture_radius(const Params<T>& p) {
  const T eps_eff = vmax(p.c.horizon_eps, T(200) * Lim<T>::eps());
  return p.horizon * (T(1) + eps_eff);
}

// The march of one ray as a state machine with three operations (load,
// one iteration, store), which march_one runs for the grid launch and,
// ray after ray in each lane, for the lane-refill schedule (march.cu).
// Everything a ray carries between iterations lives here and is set
// afresh by lane_load: the step budget `it`, and for RK45 the adaptive
// step and the FSAL carry k1.
// An RK45 lane keeps no copy of what k1 holds: once a step is accepted
// (`moved`), the ray's pt, pr and pphi are k1's, bit for bit, until the
// next accepted step, so the store takes them from k1 and the march never
// reads ray.pt, ray.pr or ray.pphi (nor ray.dt, which `step` carries).
// ray.ptheta stays: each iteration rewrites k1.ptheta's sign.
template <typename T> struct Lane {
  Ray<T> ray;
  int64_t i;     // the ray's index in the batch
  int it;        // iterations of this ray so far (max_iters is per ray)
  T step;        // RK45: the carried adaptive step
  Rates<T> k1;   // RK45: rates at the current point
  bool moved;    // RK45: a step was accepted since the load
};

// Load ray i; an RK45 ray that is active takes its step from dt and its
// FSAL carry from the rates at its starting point.
template <typename T, int METHOD>
RT_HD void lane_load(const Params<T>& p, const Fields<T>& f, int64_t i, Lane<T>& l) {
  l.ray = Ray<T>{f.t[i], f.r[i], f.theta[i], f.phi[i], f.pt[i], f.pr[i], f.ptheta[i],
                 f.pphi[i], f.k[i], f.h[i], f.Q[i], f.rdot_sign[i], f.thetadot_sign[i],
                 f.dt[i], f.steps[i], f.status[i], f.rdot_flips[i], f.eq_cross[i],
                 f.r_was_positive[i], f.theta_was_positive[i]};
  l.i = i;
  l.it = 0;
  l.moved = false;
  if (METHOD == METHOD_RK45) {
    l.step = l.ray.dt;
    if (is_active(l.ray))
      l.k1 = geodesic_rates(l.ray.r, l.ray.theta, l.ray.k, l.ray.h, l.ray.Q,
                            l.ray.rdot_sign, l.ray.thetadot_sign, p.spin);
  }
}

// Whether the lane's ray takes another iteration.
template <typename T> RT_HD bool lane_running(const Params<T>& p, const Lane<T>& l) {
  return l.it < p.max_iters && is_active(l.ray);
}

// One iteration of the lane's ray (the caller has checked lane_running).
template <typename T, int METHOD, int DEST>
RT_HD void lane_step(const Params<T>& p, T capture, Lane<T>& l) {
  if (METHOD == METHOD_RK45)
    l.moved = rk45_step<T, DEST>(l.ray, p, capture, l.step, l.k1) || l.moved;
  else
    euler_rk4_step<T, METHOD, DEST>(l.ray, p, capture);
  ++l.it;
}

// Store the lane's ray back into slot l.i; stuck rays get their (positive)
// step count negated. An RK45 ray that never moved keeps the momentum it
// was loaded with, in place.
template <typename T, int METHOD>
RT_HD void lane_store(const Fields<T>& f, Lane<T>& l) {
  Ray<T>& ray = l.ray;
  if (METHOD == METHOD_RK45) ray.dt = l.step;
  if ((ray.status & (STATUS_STEPLIM | STATUS_NUMERIC)) != 0 && ray.steps > 0)
    ray.steps = -ray.steps;
  const int64_t i = l.i;
  f.t[i] = ray.t;
  f.r[i] = ray.r;
  f.theta[i] = ray.theta;
  f.phi[i] = ray.phi;
  if (METHOD != METHOD_RK45) {
    f.pt[i] = ray.pt;
    f.pr[i] = ray.pr;
    f.ptheta[i] = ray.ptheta;
    f.pphi[i] = ray.pphi;
  } else if (l.moved) {
    f.pt[i] = l.k1.pt;
    f.pr[i] = l.k1.pr;
    f.ptheta[i] = ray.ptheta;
    f.pphi[i] = l.k1.pphi;
  }
  f.rdot_sign[i] = ray.rdot_sign;
  f.thetadot_sign[i] = ray.thetadot_sign;
  f.dt[i] = ray.dt;
  f.steps[i] = ray.steps;
  f.status[i] = ray.status;
  f.rdot_flips[i] = ray.rdot_flips;
  f.eq_cross[i] = ray.eq_cross;
  f.r_was_positive[i] = ray.rwp;
  f.theta_was_positive[i] = ray.twp;
}

// March ray i of the batch to termination (or max_iters) and store it;
// returns its iterations (every trial, accepted or rejected).
template <typename T, int METHOD, int DEST>
RT_HD int march_one(const Params<T>& p, const Fields<T>& f, int64_t i) {
  const T capture = capture_radius(p);
  Lane<T> l;
  lane_load<T, METHOD>(p, f, i, l);
  while (lane_running(p, l)) lane_step<T, METHOD, DEST>(p, capture, l);
  lane_store<T, METHOD>(f, l);
  return l.it;
}

// Build the march scalars in the working type from the caller's doubles.
// Each is rounded once to T, as torch rounds a Python float it compares
// with or subtracts from a tensor of type T: a ray landing on an annulus
// edge then stops or passes in both marches alike.
template <typename T>
inline Params<T> make_params(double spin, double r_max, double horizon, const double* dest,
                             int steplim, int max_iters, const double* ctrl) {
  Params<T> p;
  p.spin = Spin<T>{T(spin), T(spin * spin), T(2.0 * spin * spin)};
  p.r_max = T(r_max);
  p.horizon = T(horizon);
  p.p0 = T(dest[0]);
  p.p1 = T(dest[1]);
  p.p2 = T(dest[2]);
  p.p3 = T(dest[3]);
  p.steplim = steplim;
  p.max_iters = max_iters;
  p.c = Ctrl<T>{T(ctrl[0]), T(ctrl[1]), T(ctrl[2]), T(ctrl[3]), T(ctrl[4]), T(ctrl[5]),
                T(ctrl[6]), T(ctrl[7]), T(ctrl[8]), T(ctrl[9]), T(ctrl[10])};
  p.k = Consts<T>{T(A21), T(A31), T(A32), T(A41), T(A42), T(A43), T(A51), T(A52),
                  T(A53), T(A54), T(A61), T(A62), T(A63), T(A64), T(A65),
                  T(B1),  T(B3),  T(B4),  T(B5),  T(B6),  T(E1),  T(E3),  T(E4),
                  T(E5),  T(E6),  T(E7),  T(PI),  T(2.0 * PI), T(PI / 2)};
  return p;
}

template <typename T>
inline Fields<T> make_fields(void* const* ptr) {
  return Fields<T>{
      static_cast<T*>(ptr[0]),  static_cast<T*>(ptr[1]),  static_cast<T*>(ptr[2]),
      static_cast<T*>(ptr[3]),  static_cast<T*>(ptr[4]),  static_cast<T*>(ptr[5]),
      static_cast<T*>(ptr[6]),  static_cast<T*>(ptr[7]),  static_cast<const T*>(ptr[8]),
      static_cast<const T*>(ptr[9]), static_cast<const T*>(ptr[10]),
      static_cast<T*>(ptr[11]), static_cast<T*>(ptr[12]), static_cast<T*>(ptr[13]),
      static_cast<const T*>(ptr[14]),
      static_cast<int32_t*>(ptr[15]), static_cast<int32_t*>(ptr[16]),
      static_cast<int32_t*>(ptr[17]), static_cast<int32_t*>(ptr[18]),
      static_cast<bool*>(ptr[19]), static_cast<bool*>(ptr[20])};
}

}  // namespace rt
