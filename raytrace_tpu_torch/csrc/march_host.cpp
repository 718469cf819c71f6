// Host build of the per-ray march in march.cuh, one ray after another,
// an emulation of the lane-refill schedule, and the guarded trig.
//
// The CUDA kernel (march.cu) runs the same march_one<T, METHOD, DEST> per
// thread; this file lets the CPU tests check that step logic with g++
// against the plain torch march, where no CUDA compiler or card exists. Same
// argument list as rt_march_launch up to dtype, then `warps`: 0 marches
// ray after ray (march_one); w > 0 hands the rays out as
// march_refill_kernel does, 32 at a time to w warps sharing one counter;
// then `iters`, null or an int64 that the march adds its rays' iterations
// to, as the kernels' launch counter does.
//
//   g++ -x c++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC march_host.cpp

#include "march.cuh"

namespace {

// The lane-refill schedule over `warps` warps sharing one counter: each
// warp in turn takes the next 32 ray indices with one counter add and
// marches those below n, lane after lane, as march_refill_kernel does,
// and adds the iterations of all its rays to `iters` where it is set.
template <typename T, int METHOD, int DEST>
void run_refill(const rt::Params<T>& p, const rt::Fields<T>& f, int64_t n, int warps,
                int64_t* iters) {
  const uint64_t count = static_cast<uint64_t>(n);
  uint64_t next = 0;
  int64_t total = 0;
  for (bool live = true; live;) {
    live = false;
    for (int w = 0; w < warps; ++w) {
      const uint64_t base = next;
      next += 32;
      if (base >= count) continue;
      live = true;
      for (uint64_t lane = 0; lane < 32; ++lane)
        if (base + lane < count)
          total += rt::march_one<T, METHOD, DEST>(p, f, static_cast<int64_t>(base + lane));
    }
  }
  if (iters != nullptr) *iters += total;
}

// warps = 0: march_one ray after ray; otherwise the refill schedule.
template <typename T, int METHOD, int DEST>
void run(const rt::Params<T>& p, const rt::Fields<T>& f, int64_t n, int warps, int64_t* iters) {
  if (warps > 0) {
    run_refill<T, METHOD, DEST>(p, f, n, warps, iters);
    return;
  }
  for (int64_t i = 0; i < n; ++i) {
    const int it = rt::march_one<T, METHOD, DEST>(p, f, i);
    if (iters != nullptr) *iters += it;
  }
}

template <typename T, int METHOD>
int run_dest(int dest, const rt::Params<T>& p, const rt::Fields<T>& f, int64_t n, int warps,
             int64_t* iters) {
  switch (dest) {
    case rt::DEST_THETA: run<T, METHOD, rt::DEST_THETA>(p, f, n, warps, iters); return 0;
    case rt::DEST_ISCO: run<T, METHOD, rt::DEST_ISCO>(p, f, n, warps, iters); return 0;
    case rt::DEST_PLANE: run<T, METHOD, rt::DEST_PLANE>(p, f, n, warps, iters); return 0;
    case rt::DEST_SHELL: run<T, METHOD, rt::DEST_SHELL>(p, f, n, warps, iters); return 0;
    default: return 1;
  }
}

template <typename T>
int run_all(void* const* ptr, int64_t n, double spin, double r_max, double horizon, int dest,
            const double* dest_params, int steplim, int max_iters, const double* ctrl,
            int method, int warps, int64_t* iters) {
  const rt::Params<T> p =
      rt::make_params<T>(spin, r_max, horizon, dest_params, steplim, max_iters, ctrl);
  const rt::Fields<T> f = rt::make_fields<T>(ptr);
  if (method == rt::METHOD_RK4) return run_dest<T, rt::METHOD_RK4>(dest, p, f, n, warps, iters);
  if (method == rt::METHOD_RK45)
    return run_dest<T, rt::METHOD_RK45>(dest, p, f, n, warps, iters);
  if (method == rt::METHOD_EULER)
    return run_dest<T, rt::METHOD_EULER>(dest, p, f, n, warps, iters);
  return 1;
}

template <typename T, int DEST>
void reached_all(const void* const* pts, int64_t n, const double* dest_params, bool* out) {
  const T* r = static_cast<const T*>(pts[0]);
  const T* theta = static_cast<const T*>(pts[1]);
  const T* phi = static_cast<const T*>(pts[2]);
  const T* prev_theta = static_cast<const T*>(pts[3]);
  const double ctrl[11] = {};
  const rt::Params<T> p = rt::make_params<T>(0.0, 0.0, 0.0, dest_params, 0, 0, ctrl);
  for (int64_t i = 0; i < n; ++i)
    out[i] = rt::dest_reached<DEST>(p, r[i], theta[i], phi[i], prev_theta[i]);
}

template <typename T>
int reached_dest(int dest, const void* const* pts, int64_t n, const double* dest_params,
                 bool* out) {
  switch (dest) {
    case rt::DEST_THETA: reached_all<T, rt::DEST_THETA>(pts, n, dest_params, out); return 0;
    case rt::DEST_ISCO: reached_all<T, rt::DEST_ISCO>(pts, n, dest_params, out); return 0;
    case rt::DEST_PLANE: reached_all<T, rt::DEST_PLANE>(pts, n, dest_params, out); return 0;
    case rt::DEST_SHELL: reached_all<T, rt::DEST_SHELL>(pts, n, dest_params, out); return 0;
    default: return 1;
  }
}

template <typename T> void trig_all(const void* x, int64_t n, void* s, void* c, void* cc) {
  const T* xs = static_cast<const T*>(x);
  for (int64_t i = 0; i < n; ++i) {
    const rt::SinCos<T> o = rt::m_sincos(xs[i]);
    static_cast<T*>(s)[i] = o.s;
    static_cast<T*>(c)[i] = o.c;
    static_cast<T*>(cc)[i] = rt::m_cos(xs[i]);
  }
}

}  // namespace

// Destination.reached on n given points (r, theta, phi, prev_theta), with
// the destination's code and parameters as rt_march_host takes them, built
// by make_params as the march builds them: the CPU tests hold the rounding
// of the surfaces (DiscWithISCO's annulus edges, FlatPlane's projection) to
// the plain march's, one ulp at a time.
extern "C" int rt_reached_host(const void* r, const void* theta, const void* phi,
                               const void* prev_theta, int64_t n, int dest, double dest_p0,
                               double dest_p1, double dest_p2, double dest_p3, int dtype,
                               bool* out) {
  const void* const pts[4] = {r, theta, phi, prev_theta};
  const double dest_params[4] = {dest_p0, dest_p1, dest_p2, dest_p3};
  if (dtype == 0) return reached_dest<float>(dest, pts, n, dest_params, out);
  if (dtype == 1) return reached_dest<double>(dest, pts, n, dest_params, out);
  return 1;
}

// The guarded trig of march.cuh on n points of the working type (dtype 0
// float, 1 double): sin and cos from m_sincos into s and c, m_cos into cc.
extern "C" int rt_trig_host(const void* x, int64_t n, int dtype, void* s, void* c, void* cc) {
  if (dtype == 0) {
    trig_all<float>(x, n, s, c, cc);
    return 0;
  }
  if (dtype == 1) {
    trig_all<double>(x, n, s, c, cc);
    return 0;
  }
  return 1;
}

extern "C" int rt_march_host(void* t, void* r, void* theta, void* phi, void* pt, void* pr,
                             void* ptheta, void* pphi, void* k, void* h, void* Q,
                             void* rdot_sign, void* thetadot_sign, void* dt, void* emit,
                             void* steps, void* status, void* rdot_flips, void* eq_cross,
                             void* r_was_positive, void* theta_was_positive, int64_t n,
                             double spin, double r_max, double horizon, int dest,
                             double dest_p0, double dest_p1, double dest_p2, double dest_p3,
                             int steplim, int max_iters, double precision,
                             double theta_precision, double max_tstep, double maxtstep_rlim,
                             double max_phistep, double min_step, double rk45_tol,
                             double horizon_eps,
                             double safety, double fac_min, double fac_max, int method,
                             int dtype, int warps, void* iters) {
  void* const ptr[21] = {t, r, theta, phi, pt, pr, ptheta, pphi, k, h, Q,
                         rdot_sign, thetadot_sign, dt, emit, steps, status,
                         rdot_flips, eq_cross, r_was_positive, theta_was_positive};
  const double dest_params[4] = {dest_p0, dest_p1, dest_p2, dest_p3};
  const double ctrl[11] = {precision, theta_precision, max_tstep, maxtstep_rlim,
                           max_phistep, min_step, rk45_tol, horizon_eps,
                           safety, fac_min, fac_max};
  auto* its = static_cast<int64_t*>(iters);
  if (warps < 0) return 1;
  if (dtype == 0)
    return run_all<float>(ptr, n, spin, r_max, horizon, dest, dest_params, steplim,
                          max_iters, ctrl, method, warps, its);
  if (dtype == 1)
    return run_all<double>(ptr, n, spin, r_max, horizon, dest, dest_params, steplim,
                           max_iters, ctrl, method, warps, its);
  return 1;
}
