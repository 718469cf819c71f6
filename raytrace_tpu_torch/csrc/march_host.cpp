// Host build of the per-ray march in march.cuh, one ray after another.
//
// The CUDA kernel (march.cu) runs the same march_one<T, METHOD> per thread;
// this file lets the CPU tests check that step logic with g++ against the
// plain torch march, where no CUDA compiler or card exists. Same argument
// list as rt_march_launch, without the stream.
//
//   g++ -x c++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC march_host.cpp

#include "march.cuh"

namespace {

template <typename T>
void run(void* const* ptr, int64_t n, double spin, double r_max, double horizon,
         double theta_lim, int steplim, int max_iters, const double* ctrl, int method) {
  const rt::Params<T> p =
      rt::make_params<T>(spin, r_max, horizon, theta_lim, steplim, max_iters, ctrl);
  const rt::Fields<T> f = rt::make_fields<T>(ptr);
  for (int64_t i = 0; i < n; ++i) {
    if (method == rt::METHOD_RK4)
      rt::march_one<T, rt::METHOD_RK4>(p, f, i);
    else
      rt::march_one<T, rt::METHOD_RK45>(p, f, i);
  }
}

}  // namespace

extern "C" int rt_march_host(void* t, void* r, void* theta, void* phi, void* pt, void* pr,
                             void* ptheta, void* pphi, void* k, void* h, void* Q,
                             void* rdot_sign, void* thetadot_sign, void* dt, void* emit,
                             void* steps, void* status, void* rdot_flips, void* eq_cross,
                             void* r_was_positive, void* theta_was_positive, int64_t n,
                             double spin, double r_max, double horizon, double theta_lim,
                             int steplim, int max_iters, double precision,
                             double theta_precision, double max_tstep, double maxtstep_rlim,
                             double max_phistep, double min_step, double rk45_tol,
                             double horizon_eps, double safety, double fac_min,
                             double fac_max, int method, int dtype) {
  void* const ptr[21] = {t, r, theta, phi, pt, pr, ptheta, pphi, k, h, Q,
                         rdot_sign, thetadot_sign, dt, emit, steps, status,
                         rdot_flips, eq_cross, r_was_positive, theta_was_positive};
  const double ctrl[11] = {precision, theta_precision, max_tstep, maxtstep_rlim,
                           max_phistep, min_step, rk45_tol, horizon_eps,
                           safety, fac_min, fac_max};
  if (method != rt::METHOD_RK4 && method != rt::METHOD_RK45) return 1;
  if (dtype == 0)
    run<float>(ptr, n, spin, r_max, horizon, theta_lim, steplim, max_iters, ctrl, method);
  else if (dtype == 1)
    run<double>(ptr, n, spin, r_max, horizon, theta_lim, steplim, max_iters, ctrl, method);
  else
    return 1;
  return 0;
}
