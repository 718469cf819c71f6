// Host build of the emissivity's redshift chains in redshift.cuh, one ray
// after another.
//
// The CUDA kernels (redshift.cu) run the same emit_one and emis_weights per
// thread; this file lets the CPU tests check them with g++ against torch's
// chain, where no CUDA compiler or card exists. The same arguments as
// rt_emit_launch and rt_emis_weights_launch, without the stream.
//
//   g++ -x c++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC redshift_host.cpp

#include "redshift.cuh"

extern "C" {

int rt_emit_host(const void* const* rays, void* emit, int64_t n, double spin, double V) {
  const rt::EmisRays f = rt::make_emis_rays(rays);
  const rt::Spin<double> s = rt::make_spin(spin);
  double* out = static_cast<double*>(emit);
  for (int64_t i = 0; i < n; ++i) out[i] = rt::emit_one(f, s, V, i);
  return 0;
}

int rt_emis_weights_host(const void* const* rays, void* ids, void* mask, void* cols, int64_t n,
                         double spin, int route, double r_isco, double theta_lim, int logbin,
                         double r_min, double step, int64_t n_bins, double gamma,
                         double n_primary) {
  if (route != rt::EMIS_PLAIN && route != rt::EMIS_RD) return 1;
  const rt::EmisRays f = rt::make_emis_rays(rays);
  const rt::EmisParams p = rt::make_emis_params(spin, route, r_isco, theta_lim, logbin, r_min,
                                                step, n_bins, gamma, n_primary);
  const rt::EmisOut o = rt::make_emis_out(ids, mask, cols, n);
  for (int64_t i = 0; i < n; ++i) rt::emis_weights(f, p, o, i);
  return 0;
}

}  // extern "C"
