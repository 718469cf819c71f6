// Host build of the per-ray march in march.cuh, one ray after another.
//
// The CUDA kernel (march.cu) runs the same march_one<T, METHOD, DEST> per
// thread; this file lets the CPU tests check that step logic with g++
// against the plain torch march, where no CUDA compiler or card exists. Same
// argument list as rt_march_launch, without the stream.
//
//   g++ -x c++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC march_host.cpp

#include "march.cuh"

namespace {

template <typename T, int METHOD, int DEST>
void run(const rt::Params<T>& p, const rt::Fields<T>& f, int64_t n) {
  for (int64_t i = 0; i < n; ++i) rt::march_one<T, METHOD, DEST>(p, f, i);
}

template <typename T, int METHOD>
int run_dest(int dest, const rt::Params<T>& p, const rt::Fields<T>& f, int64_t n) {
  if (dest == rt::DEST_THETA)
    run<T, METHOD, rt::DEST_THETA>(p, f, n);
  else if constexpr (METHOD == rt::METHOD_EULER)  // Euler with DiscWithISCO: not built
    return 1;
  else if (dest == rt::DEST_ISCO)
    run<T, METHOD, rt::DEST_ISCO>(p, f, n);
  else
    return 1;
  return 0;
}

template <typename T>
int run_all(void* const* ptr, int64_t n, double spin, double r_max, double horizon, int dest,
            const double* dest_params, int steplim, int max_iters, const double* ctrl,
            int method) {
  const rt::Params<T> p =
      rt::make_params<T>(spin, r_max, horizon, dest_params, steplim, max_iters, ctrl);
  const rt::Fields<T> f = rt::make_fields<T>(ptr);
  if (method == rt::METHOD_RK4) return run_dest<T, rt::METHOD_RK4>(dest, p, f, n);
  if (method == rt::METHOD_RK45) return run_dest<T, rt::METHOD_RK45>(dest, p, f, n);
  if (method == rt::METHOD_EULER) return run_dest<T, rt::METHOD_EULER>(dest, p, f, n);
  return 1;
}

template <typename T>
void isco_reached_all(const T* r, const T* theta, const T* prev_theta, int64_t n,
                      const double* dest_params, bool* out) {
  const double ctrl[11] = {};
  const rt::Params<T> p = rt::make_params<T>(0.0, 0.0, 0.0, dest_params, 0, 0, ctrl);
  for (int64_t i = 0; i < n; ++i)
    out[i] = rt::dest_reached<rt::DEST_ISCO>(p, r[i], theta[i], prev_theta[i]);
}

}  // namespace

// DiscWithISCO.reached on n given points, with the destination's parameters
// built by make_params as the march builds them: the CPU tests hold the
// rounding of the annulus edges to the plain march's, one ulp at a time.
extern "C" int rt_isco_reached_host(const void* r, const void* theta, const void* prev_theta,
                                    int64_t n, double r_isco, double r_out, double theta_lim,
                                    int dtype, bool* out) {
  const double dest_params[3] = {r_isco, r_out, theta_lim};
  if (dtype == 0)
    isco_reached_all(static_cast<const float*>(r), static_cast<const float*>(theta),
                     static_cast<const float*>(prev_theta), n, dest_params, out);
  else if (dtype == 1)
    isco_reached_all(static_cast<const double*>(r), static_cast<const double*>(theta),
                     static_cast<const double*>(prev_theta), n, dest_params, out);
  else
    return 1;
  return 0;
}

extern "C" int rt_march_host(void* t, void* r, void* theta, void* phi, void* pt, void* pr,
                             void* ptheta, void* pphi, void* k, void* h, void* Q,
                             void* rdot_sign, void* thetadot_sign, void* dt, void* emit,
                             void* steps, void* status, void* rdot_flips, void* eq_cross,
                             void* r_was_positive, void* theta_was_positive, int64_t n,
                             double spin, double r_max, double horizon, int dest,
                             double dest_p0, double dest_p1, double dest_p2, int steplim,
                             int max_iters, double precision, double theta_precision,
                             double max_tstep, double maxtstep_rlim, double max_phistep,
                             double min_step, double rk45_tol, double horizon_eps,
                             double safety, double fac_min, double fac_max, int method,
                             int dtype) {
  void* const ptr[21] = {t, r, theta, phi, pt, pr, ptheta, pphi, k, h, Q,
                         rdot_sign, thetadot_sign, dt, emit, steps, status,
                         rdot_flips, eq_cross, r_was_positive, theta_was_positive};
  const double dest_params[3] = {dest_p0, dest_p1, dest_p2};
  const double ctrl[11] = {precision, theta_precision, max_tstep, maxtstep_rlim,
                           max_phistep, min_step, rk45_tol, horizon_eps,
                           safety, fac_min, fac_max};
  if (dtype == 0)
    return run_all<float>(ptr, n, spin, r_max, horizon, dest, dest_params, steplim,
                          max_iters, ctrl, method);
  if (dtype == 1)
    return run_all<double>(ptr, n, spin, r_max, horizon, dest, dest_params, steplim,
                           max_iters, ctrl, method);
  return 1;
}
