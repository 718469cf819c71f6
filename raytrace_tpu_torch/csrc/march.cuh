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
#else
#define RT_HD inline
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

// Destinations (destinations.py): the parameters p0..p2 of Params are
//   DEST_THETA  ThetaLimit / FlatDisc   (theta_lim, -, -)
//   DEST_ISCO   DiscWithISCO            (r_isco, r_out, theta_lim)
constexpr int DEST_THETA = 0;
constexpr int DEST_ISCO = 1;

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
RT_HD float m_sin(float x) { return sinf(x); }
RT_HD double m_sin(double x) { return sin(x); }
RT_HD float m_cos(float x) { return cosf(x); }
RT_HD double m_cos(double x) { return cos(x); }
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

// Scalars of one march: spin, outer radius, the inner absorbing radius and
// the destination's three parameters (see DEST_*), plus the step budgets.
template <typename T> struct Params {
  Spin<T> spin;
  T r_max, horizon, p0, p1, p2;
  int steplim, max_iters;
  Ctrl<T> c;
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
  const T sin_t = m_sin(theta);
  const T cos_t = m_cos(theta);
  T sin2 = sin_t * sin_t;
  const T rhosq = r * r + (a * cos_t) * (a * cos_t);
  const T delta = r * r - T(2) * r + s.a2;
  const T tiny = Lim<T>::tiny();
  sin2 = vmax(sin2, tiny);
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
  o.ptheta = m_sqrt(vmax(m_abs(o.thetadot_sq), tiny)) * thetadot_sign;
  o.rdot_sq = (k * o.pt - h * o.pphi - rhosq * o.ptheta * o.ptheta) * (delta * inv_rhosq);
  o.pr = m_sqrt(vmax(m_abs(o.rdot_sq), tiny)) * rdot_sign;
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
// either side, inside the annulus; theta_lim == 0 never stops.
template <int DEST, typename T>
RT_HD bool dest_reached(const Params<T>& p, T r, T theta, T prev_theta) {
  if (DEST == DEST_THETA) return theta_reached(p.p0, theta);
  const T tl = p.p2;
  const T lim = tl > 0 ? tl : -tl;
  const bool crossed = (prev_theta < lim && theta >= lim) || (prev_theta > lim && theta <= lim);
  return tl != 0 && crossed && in_annulus(p, r);
}

// Destination.step_limit at the step's starting point: DiscWithISCO clamps
// onto its surface only where the step starts inside the annulus.
template <int DEST, typename T>
RT_HD T dest_step_limit(const Params<T>& p, T r, T theta, T ptheta) {
  if (DEST == DEST_THETA) return theta_step_limit(p.p0, theta, ptheta);
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
template <typename T> RT_HD void polar_reflect(T& theta, T& phi, T& thetadot_sign) {
  const bool low = theta < 0;
  const bool high = theta > T(PI);
  theta = low ? -theta : (high ? T(2.0 * PI) - theta : theta);
  if (low || high) {
    phi = phi + T(PI);
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
  const T half_pi = T(PI / 2);
  if ((prev_theta < half_pi && theta >= half_pi) || (prev_theta > half_pi && theta <= half_pi))
    ray.eq_cross += 1;
  if (r <= capture)
    ray.status |= STATUS_HORIZON;
  else if (p.r_max > 0 && r >= p.r_max)
    ray.status |= STATUS_RLIM;
  else if (dest_reached<DEST>(p, r, theta, prev_theta))
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
    polar_reflect(th_n, ph_n, ray.thetadot_sign);
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
  polar_reflect(th_n, ph_n, ray.thetadot_sign);

  commit<DEST>(ray, p, capture, t_n, r_n, th_n, ph_n, k4.pt, k4.pr, k4.ptheta, k4.pphi);
  count_step(ray, p, true, s.r_flip);
}

// One DOPRI5 iteration (_rk45_body). `step` is the carried adaptive step
// and `k1` the FSAL carry: rates at the current point.
template <typename T, int DEST>
RT_HD void rk45_step(Ray<T>& ray, const Params<T>& p, T capture, T& step, Rates<T>& k1) {
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
    return;
  }
  if (!k1_checks(ray, a.a, k1, s.pr1)) {
    count_step(ray, p, false, false);
    return;
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
  const T lim = dest_step_limit<DEST>(p, r, theta, pth1);
  const bool clamped = lim < step;
  const T h_try = clamped ? lim : step;

  const T rs = s.rdot_sign, ts = s.thetadot_sign;
  const T kk = ray.k, hh = ray.h, QQ = ray.Q;
  const Rates<T> k2 = geodesic_rates(r + h_try * (T(A21) * pr1), theta + h_try * (T(A21) * pth1),
                                     kk, hh, QQ, rs, ts, a);
  const Rates<T> k3 = geodesic_rates(
      r + h_try * (T(A31) * pr1 + T(A32) * k2.pr),
      theta + h_try * (T(A31) * pth1 + T(A32) * k2.ptheta), kk, hh, QQ, rs, ts, a);
  const Rates<T> k4 = geodesic_rates(
      r + h_try * (T(A41) * pr1 + T(A42) * k2.pr + T(A43) * k3.pr),
      theta + h_try * (T(A41) * pth1 + T(A42) * k2.ptheta + T(A43) * k3.ptheta),
      kk, hh, QQ, rs, ts, a);
  const Rates<T> k5 = geodesic_rates(
      r + h_try * (T(A51) * pr1 + T(A52) * k2.pr + T(A53) * k3.pr + T(A54) * k4.pr),
      theta + h_try * (T(A51) * pth1 + T(A52) * k2.ptheta + T(A53) * k3.ptheta +
                       T(A54) * k4.ptheta),
      kk, hh, QQ, rs, ts, a);
  const Rates<T> k6 = geodesic_rates(
      r + h_try * (T(A61) * pr1 + T(A62) * k2.pr + T(A63) * k3.pr + T(A64) * k4.pr +
                   T(A65) * k5.pr),
      theta + h_try * (T(A61) * pth1 + T(A62) * k2.ptheta + T(A63) * k3.ptheta +
                       T(A64) * k4.ptheta + T(A65) * k5.ptheta),
      kk, hh, QQ, rs, ts, a);

  // 5th-order solution (b2 = 0), reflect, then the FSAL stage k7 at the new
  // point with the pre-reflection polar sign
  const T r_new = r + h_try * (T(B1) * pr1 + T(B3) * k3.pr + T(B4) * k4.pr + T(B5) * k5.pr +
                               T(B6) * k6.pr);
  T th_new = theta + h_try * (T(B1) * pth1 + T(B3) * k3.ptheta + T(B4) * k4.ptheta +
                              T(B5) * k5.ptheta + T(B6) * k6.ptheta);
  const T t_new = ray.t + h_try * (T(B1) * pt1 + T(B3) * k3.pt + T(B4) * k4.pt +
                                   T(B5) * k5.pt + T(B6) * k6.pt);
  T phi_new = ray.phi + h_try * (T(B1) * pph1 + T(B3) * k3.pphi + T(B4) * k4.pphi +
                                 T(B5) * k5.pphi + T(B6) * k6.pphi);
  T ts_r = ts;
  polar_reflect(th_new, phi_new, ts_r);
  const Rates<T> k7 = geodesic_rates(r_new, th_new, kk, hh, QQ, rs, ts, a);

  const T err_r = h_try * (T(E1) * pr1 + T(E3) * k3.pr + T(E4) * k4.pr + T(E5) * k5.pr +
                           T(E6) * k6.pr + T(E7) * k7.pr);
  const T err_th = h_try * (T(E1) * pth1 + T(E3) * k3.ptheta + T(E4) * k4.ptheta +
                            T(E5) * k5.ptheta + T(E6) * k6.ptheta + T(E7) * k7.ptheta);
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

  T fac = c.safety * m_pow(T(1) / vmax(err_eff, T(1e-10)), T(0.2));
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
}

// March ray i of the batch to termination (or max_iters) and store it.
template <typename T, int METHOD, int DEST>
RT_HD void march_one(const Params<T>& p, const Fields<T>& f, int64_t i) {
  Ray<T> ray{f.t[i], f.r[i], f.theta[i], f.phi[i], f.pt[i], f.pr[i], f.ptheta[i],
             f.pphi[i], f.k[i], f.h[i], f.Q[i], f.rdot_sign[i], f.thetadot_sign[i],
             f.dt[i], f.steps[i], f.status[i], f.rdot_flips[i], f.eq_cross[i],
             f.r_was_positive[i], f.theta_was_positive[i]};

  // capture shell floored at 200 ulp of the working type (_commit)
  const T eps_eff = vmax(p.c.horizon_eps, T(200) * Lim<T>::eps());
  const T capture = p.horizon * (T(1) + eps_eff);

  if (is_active(ray)) {
    if (METHOD == METHOD_RK45) {
      T step = ray.dt;
      Rates<T> k1 = geodesic_rates(ray.r, ray.theta, ray.k, ray.h, ray.Q, ray.rdot_sign,
                                   ray.thetadot_sign, p.spin);
      for (int it = 0; it < p.max_iters && is_active(ray); ++it)
        rk45_step<T, DEST>(ray, p, capture, step, k1);
      ray.dt = step;
    } else {
      for (int it = 0; it < p.max_iters && is_active(ray); ++it)
        euler_rk4_step<T, METHOD, DEST>(ray, p, capture);
    }
  }
  // stuck rays get their (positive) step count negated
  if ((ray.status & (STATUS_STEPLIM | STATUS_NUMERIC)) != 0 && ray.steps > 0)
    ray.steps = -ray.steps;

  f.t[i] = ray.t;
  f.r[i] = ray.r;
  f.theta[i] = ray.theta;
  f.phi[i] = ray.phi;
  f.pt[i] = ray.pt;
  f.pr[i] = ray.pr;
  f.ptheta[i] = ray.ptheta;
  f.pphi[i] = ray.pphi;
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
  p.steplim = steplim;
  p.max_iters = max_iters;
  p.c = Ctrl<T>{T(ctrl[0]), T(ctrl[1]), T(ctrl[2]), T(ctrl[3]), T(ctrl[4]), T(ctrl[5]),
                T(ctrl[6]), T(ctrl[7]), T(ctrl[8]), T(ctrl[9]), T(ctrl[10])};
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
