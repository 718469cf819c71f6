// Per-ray float64 redshift chains of the emissivity app, one ray at a time.
//
// Shared by the CUDA kernels (redshift.cu, built into the march library by
// nvcc) and the host build the CPU tests compile with g++
// (redshift_host.cpp). Like march.cuh, which it includes for the guarded
// trig and geodesic_rates, it includes no CUDA header.
//
// Each function mirrors its torch counterpart op for op, in torch's order
// of operations on the card, so that a build without FMA contraction
// (nvcc --fmad=false, g++ -ffp-contract=off) gives the chain's bits:
//   sanitize            ops/redshift.py _sanitize
//   metric              geometry/kerr.py metric_coeffs
//   frame_dot           geometry/kerr.py metric_dot, against the photon's
//                       momentum_from_consts (march.cuh geodesic_rates)
//   orbit_energy        ops/redshift.py _frame_energy: _resolve_V (V = -1
//                       Keplerian) and _orbit_et, not reversed
//   disc_energy         ops/redshift.py ray_redshift_dest's energy against
//                       destinations._keplerian_four_velocity
//   emis_weights        apps/emissivity.py disc_hit_mask or the rd hit test,
//                       ops/reductions.py radial_bin_index and
//                       apps/emissivity.py emissivity_bin_weights
// A division by a Python float is, on the card, a product with its
// reciprocal (torch's CUDA division by a CPU scalar), made once on the host
// (make_emis_params); a power with a scalar exponent takes torch's forms
// (pow_scalar). The card's sqrt, cos, log and pow are the CUDA math
// library's, which torch's kernels call; the host's are the C library's,
// so the host build agrees with torch's CPU chain to a few ulp.

#pragma once

#include "march.cuh"

namespace rt {

constexpr int EMIS_PLAIN = 0;  // emissivity.cpp: z < 1e-2, V = -1 orbit
constexpr int EMIS_RD = 1;     // emissivity_rd.cpp: theta >= theta_lim - 1e-3, 4-velocity

// The per-ray arrays the kernels read (struct of arrays); t and emit are
// read by emis_weights alone.
struct EmisRays {
  const double *t, *r, *theta, *k, *h, *Q, *rdot_sign, *thetadot_sign, *emit;
  const int32_t *steps, *status;
};

// What emis_weights writes: the bin id, the bin scatter's mask (a disc hit in
// a bin) and the four weight columns.
struct EmisOut {
  int64_t* ids;
  bool* mask;
  double *flux, *emis, *g, *time;
};

// The spin and the two products of it that the metric and the rates take,
// made in double as Python makes a * a and 2.0 * a * a.
inline Spin<double> make_spin(double spin) {
  return Spin<double>{spin, spin * spin, 2.0 * spin * spin};
}

// The scalars of emis_weights, made on the host from the caller's doubles.
struct EmisParams {
  Spin<double> spin;
  int route, logbin;
  double r_isco, theta_min, r_min, inv_r_min, inv_step, n_bins, gamma, n_primary;
};

// theta_lim - 1e-3 as Python makes it; 1 / r_min and 1 / (log dr or dr) as
// torch makes the reciprocal of a CPU scalar it divides by on the card.
inline EmisParams make_emis_params(double spin, int route, double r_isco, double theta_lim,
                                   int logbin, double r_min, double step, int64_t n_bins,
                                   double gamma, double n_primary) {
  EmisParams p;
  p.spin = make_spin(spin);
  p.route = route;
  p.logbin = logbin;
  p.r_isco = r_isco;
  p.theta_min = theta_lim - 1e-3;
  p.r_min = r_min;
  p.inv_r_min = 1.0 / r_min;
  p.inv_step = 1.0 / step;
  p.n_bins = static_cast<double>(n_bins);
  p.gamma = gamma;
  p.n_primary = n_primary;
  return p;
}

RT_HD double m_log(double x) { return log(x); }
RT_HD double m_rsqrt(double x) {
#if defined(__CUDA_ARCH__)
  return rsqrt(x);
#else
  return 1.0 / sqrt(x);
#endif
}

// torch.pow(x, e) with a Python-float exponent: torch's forms for 0, 1,
// 0.5, -0.5, -1, 2, 3 and -2, the library's pow otherwise. Torch's own pow
// kernel is built with FMA contraction, which changes the library pow's
// last bits, so for any other exponent the result is an ulp or two from
// torch's (2 measured at 2.5 on an H100); the forms are torch's bits.
RT_HD double pow_scalar(double x, double e) {
  if (e == 0.0) return 1.0;
  if (e == 1.0) return x;
  if (e == 0.5) return m_sqrt(x);
  if (e == -0.5) return m_rsqrt(x);
  if (e == -1.0) return 1.0 / x;
  if (e == 2.0) return x * x;
  if (e == 3.0) return x * x * x;
  if (e == -2.0) return 1.0 / (x * x);
  return m_pow(x, e);
}

// The fields the redshift reads at a ray's position, after _sanitize.
struct Site {
  double r, theta, k, h, Q;
};

RT_HD Site sanitize(double r, double theta, double k, double h, double Q, int32_t steps,
                    int32_t status) {
  const bool meaningful =
      (steps > 0 && (status & (STATUS_DEST | STATUS_RLIM)) != 0) || steps == 0;
  return meaningful ? Site{r, theta, k, h, Q} : Site{10.0, 1.0, 1.0, 0.0, 1.0};
}

// The Kerr metric's components that the frame energies take.
struct Metric {
  double g_tt, g_tphi, g_rr, g_thth, g_phph, e2nu, e2psi, omega;
};

RT_HD Metric metric(double r, double theta, const Spin<double>& s) {
  const SinCos<double> sc = m_sincos(theta);
  const double sin_t = sc.s, cos_t = sc.c;
  const double rhosq = r * r + (s.a * cos_t) * (s.a * cos_t);
  const double delta = r * r - 2.0 * r + s.a2;
  const double r2a2 = r * r + s.a2;
  const double sigmasq = r2a2 * r2a2 - s.a2 * delta * sin_t * sin_t;
  Metric g;
  g.e2nu = rhosq * delta / sigmasq;
  g.e2psi = sigmasq * sin_t * sin_t / rhosq;
  g.omega = 2.0 * s.a * r / sigmasq;
  g.g_tt = g.e2nu - g.omega * g.omega * g.e2psi;
  g.g_tphi = g.omega * g.e2psi;
  g.g_rr = -rhosq / delta;
  g.g_thth = -rhosq;
  g.g_phph = -g.e2psi;
  return g;
}

// metric_dot(g, (ut, 0, 0, uph), p): the zero legs multiply too, as torch's
// zeros do (a NaN or infinite momentum leg gives NaN).
RT_HD double frame_dot(const Metric& g, double ut, double uph, const Rates<double>& p) {
  const double zero = 0.0;
  return g.g_tt * ut * p.pt + g.g_tphi * (ut * p.pphi + uph * p.pt) + g.g_rr * zero * p.pr +
         g.g_thth * zero * p.ptheta + g.g_phph * uph * p.pphi;
}

// The photon's energy in the frame of an observer orbiting at Omega = V
// (V = -1: Keplerian at the ray's radius), the Lorentz factor's argument
// floored at the smallest normal.
RT_HD double orbit_energy(const Site& x, double rdot_sign, double thetadot_sign,
                          const Spin<double>& s, double V) {
  const double kepler = 1.0 / (s.a + x.r * m_sqrt(x.r));
  const double v = V == -1.0 ? kepler : V;
  const Metric g = metric(x.r, x.theta, s);
  const double dv = v - g.omega;
  const double arg = 1.0 - dv * dv * g.e2psi / g.e2nu;
  const double gamma = 1.0 / m_sqrt(vmax(arg, Lim<double>::tiny()));
  const double ut = gamma / m_sqrt(g.e2nu);
  const Rates<double> p =
      geodesic_rates(x.r, x.theta, x.k, x.h, x.Q, rdot_sign, thetadot_sign, s);
  return frame_dot(g, ut, ut * v, p);
}

// The photon's energy against the disc's Keplerian 4-velocity, with its own
// rounding order (gamma * V / sqrt(e2nu)) and no floor.
RT_HD double disc_energy(const Site& x, double rdot_sign, double thetadot_sign,
                         const Spin<double>& s) {
  const Metric g = metric(x.r, x.theta, s);
  const double V = 1.0 / (s.a + x.r * m_sqrt(x.r));
  const double dv = V - g.omega;
  const double gamma = 1.0 / m_sqrt(1.0 - dv * dv * g.e2psi / g.e2nu);
  const double ut = gamma / m_sqrt(g.e2nu);
  const double uph = gamma * V / m_sqrt(g.e2nu);
  const Rates<double> p =
      geodesic_rates(x.r, x.theta, x.k, x.h, x.Q, rdot_sign, thetadot_sign, s);
  return frame_dot(g, ut, uph, p);
}

// redshift_start's emitted energy of ray i (orbit at Omega = V).
RT_HD double emit_one(const EmisRays& f, const Spin<double>& s, double V, int64_t i) {
  const Site x = sanitize(f.r[i], f.theta[i], f.k[i], f.h[i], f.Q[i], f.steps[i], f.status[i]);
  return orbit_energy(x, f.rdot_sign[i], f.thetadot_sign[i], s, V);
}

// Everything from the marched ray i to the bin scatter's inputs: the
// redshift g = emit / E, the route's hit test, the radial bin and the
// weights 1 / (n_primary g), 1 / g^gamma, g and t.
RT_HD void emis_weights(const EmisRays& f, const EmisParams& p, const EmisOut& o, int64_t i) {
  const double r = f.r[i], theta = f.theta[i];
  const int32_t steps = f.steps[i];
  const Site x = sanitize(r, theta, f.k[i], f.h[i], f.Q[i], steps, f.status[i]);
  const double recv = p.route == EMIS_RD
                          ? disc_energy(x, f.rdot_sign[i], f.thetadot_sign[i], p.spin)
                          : orbit_energy(x, f.rdot_sign[i], f.thetadot_sign[i], p.spin, -1.0);
  const double g = f.emit[i] / recv;
  const bool near = p.route == EMIS_RD ? theta >= p.theta_min : r * m_cos(theta) < 1e-2;
  const bool hit = steps > 0 && near && g > 0 && r >= p.r_isco;
  const double ir =
      p.logbin ? floor(m_log(r * p.inv_r_min) * p.inv_step) : floor((r - p.r_min) * p.inv_step);
  const bool in_range = ir >= 0 && ir < p.n_bins;
  o.ids[i] = in_range ? static_cast<int64_t>(ir) : 0;
  o.mask[i] = hit && in_range;
  o.flux[i] = 1.0 / (p.n_primary * g);
  o.emis[i] = 1.0 / pow_scalar(g, p.gamma);
  o.g[i] = g;
  o.time[i] = f.t[i];
}

inline EmisRays make_emis_rays(const void* const* ptr) {
  return EmisRays{static_cast<const double*>(ptr[0]), static_cast<const double*>(ptr[1]),
                  static_cast<const double*>(ptr[2]), static_cast<const double*>(ptr[3]),
                  static_cast<const double*>(ptr[4]), static_cast<const double*>(ptr[5]),
                  static_cast<const double*>(ptr[6]), static_cast<const double*>(ptr[7]),
                  static_cast<const double*>(ptr[8]), static_cast<const int32_t*>(ptr[9]),
                  static_cast<const int32_t*>(ptr[10])};
}

// cols: the four weight columns, n float64 each, one after another.
inline EmisOut make_emis_out(void* ids, void* mask, void* cols, int64_t n) {
  double* c = static_cast<double*>(cols);
  return EmisOut{static_cast<int64_t*>(ids), static_cast<bool*>(mask), c, c + n, c + 2 * n,
                  c + 3 * n};
}

}  // namespace rt
