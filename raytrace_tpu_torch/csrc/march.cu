// Geodesic march kernel for Hopper (sm_90a): one thread marches one ray.
//
// Replaces the TPU kernel raytrace_tpu/ops/pallas_kernel.py::_make_kernel
// (the pl.pallas_call in _trace_pallas_padded) in every variant it builds:
// the methods euler, rk4 and rk45 with each of its four destinations,
// ThetaLimit/FlatDisc (dest_kind "theta"), DiscWithISCO ("isco"),
// FlatPlane ("plane") and SphericalShell ("shell"), in float32 (as on the
// TPU) and float64 — 24 instantiations. Like the Pallas kernel it keeps
// each ray's whole march out of device memory: a thread loads its ray's 21
// fields from the struct-of-arrays batch (coalesced across the warp), runs
// the march in registers until its own ray is no longer active or max_iters
// is reached, and stores once. Method and destination are template
// parameters (march_kernel<T, METHOD, DEST>), so each instantiation keeps
// only its own branch: the theta variants carry no annulus or plane test
// and no Euler code.
//
// What bounds it on this card: not memory — each ray moves about 170 bytes
// in and out against hundreds of steps of 1 (Euler), 4 (RK4) or 7 (DOPRI5)
// rate evaluations, each with a sin, a cos, two square roots and a divide.
// It is bound by FP32 (or FP64) transcendental and divide throughput and by
// warp divergence: a warp runs until its slowest lane finishes, and stuck
// photon-sphere rays run to steplim. DiscWithISCO adds divergence of its
// own: a ray that crosses the plane inside the ISCO marches on to the
// horizon while its neighbours beyond the ISCO have stopped. FlatPlane's
// test costs a sin and two cos per committed step on top of the rates.
//
// What the design does about that: registers only (no shared memory, no
// spills wanted; the FSAL carry of DOPRI5 saves one of the seven rate
// evaluations per step), and early exit per thread, so a finished ray costs
// its warp nothing but an idle lane. Compaction, persistent blocks and
// lifetime-aware ray ordering are left for later.
//
// Numerics: no --use_fast_math (it flushes denormals and approximates the
// transcendentals that the finfo.tiny floors and the DOPRI5 controller rely
// on); precise sin/cos/sqrt/pow. Built with --fmad=false: with nvcc's
// default contraction of a*b+c into one FMA the kernel rounds differently
// from the plain torch march's separate ops, and in float32 the DOPRI5
// controller (rk45_tol = 1e-8, below float32's resolution) then takes other
// accept/reject decisions — on an H100 only 71.6% of the golden grid's rays
// kept the plain march's step count, against the 98% gate. Without
// contraction every gate holds and the kernel's time is within 1% of the
// contracted build's (ops/march_kernel.py builds it so; PERF.md has both).
// One exception is left: the CUDA math library is inlined into its caller
// and compiled under the caller's flags, and torch builds its own kernels
// with contraction. On an H100 the two builds agreed on 2e7 random inputs
// each to double sin, cos and sqrt and to powf, but double pow(x, 0.2)
// came out an ulp apart on 14 of them (tests/test_torch_march.py holds the
// pow case on the card). The DOPRI5 controller takes that pow once a
// step, so in float64 a few RK45 rays in a million take a step an ulp apart
// and end near the plain march's result rather than on its bits (PERF.md
// has the counts). Building pow apart with contraction (relocatable device
// code) makes those rays bitwise too, but costs the float64 RK45 kernel
// ~50% of its time (225 registers in place of 128), so it is not done.
// The destination's parameters are rounded once from double to the working
// type, as torch rounds the Python floats the plain march compares with.

#include <cuda_runtime.h>

#include "march.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, int METHOD, int DEST>
__global__ void __launch_bounds__(kThreads)
    march_kernel(rt::Params<T> p, rt::Fields<T> f, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) rt::march_one<T, METHOD, DEST>(p, f, i);
}

template <typename T, int METHOD>
cudaError_t launch_dest(int dest, unsigned blocks, const rt::Params<T>& p,
                        const rt::Fields<T>& f, int64_t n, cudaStream_t stream) {
  switch (dest) {
    case rt::DEST_THETA:
      march_kernel<T, METHOD, rt::DEST_THETA><<<blocks, kThreads, 0, stream>>>(p, f, n);
      break;
    case rt::DEST_ISCO:
      march_kernel<T, METHOD, rt::DEST_ISCO><<<blocks, kThreads, 0, stream>>>(p, f, n);
      break;
    case rt::DEST_PLANE:
      march_kernel<T, METHOD, rt::DEST_PLANE><<<blocks, kThreads, 0, stream>>>(p, f, n);
      break;
    case rt::DEST_SHELL:
      march_kernel<T, METHOD, rt::DEST_SHELL><<<blocks, kThreads, 0, stream>>>(p, f, n);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(void* const* ptr, int64_t n, double spin, double r_max, double horizon,
                   int dest, const double* dest_params, int steplim, int max_iters,
                   const double* ctrl, int method, cudaStream_t stream) {
  const rt::Params<T> p =
      rt::make_params<T>(spin, r_max, horizon, dest_params, steplim, max_iters, ctrl);
  const rt::Fields<T> f = rt::make_fields<T>(ptr);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (method == rt::METHOD_RK4)
    return launch_dest<T, rt::METHOD_RK4>(dest, blocks, p, f, n, stream);
  if (method == rt::METHOD_RK45)
    return launch_dest<T, rt::METHOD_RK45>(dest, blocks, p, f, n, stream);
  if (method == rt::METHOD_EULER)
    return launch_dest<T, rt::METHOD_EULER>(dest, blocks, p, f, n, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch the march on `stream` over n rays, updating the arrays in place;
// returns cudaGetLastError() after the launch (0 on success). Does not
// synchronise. method: 1 = RK4, 2 = RK45, 3 = Euler. dest and dest_p0..p3:
// 0 = ThetaLimit (theta_lim), 1 = DiscWithISCO (r_isco, r_out, theta_lim),
// 2 = FlatPlane (sin incl, cos incl, phi0, z_s), 3 = SphericalShell
// (r_shell); unused parameters are ignored.
// dtype: 0 = float32, 1 = float64. ctrl holds the 11 StepControl values in
// declaration order.
int rt_march_launch(void* t, void* r, void* theta, void* phi, void* pt, void* pr,
                    void* ptheta, void* pphi, void* k, void* h, void* Q,
                    void* rdot_sign, void* thetadot_sign, void* dt, void* emit,
                    void* steps, void* status, void* rdot_flips, void* eq_cross,
                    void* r_was_positive, void* theta_was_positive, int64_t n,
                    double spin, double r_max, double horizon, int dest, double dest_p0,
                    double dest_p1, double dest_p2, double dest_p3, int steplim,
                    int max_iters, double precision, double theta_precision, double max_tstep,
                    double maxtstep_rlim, double max_phistep, double min_step,
                    double rk45_tol, double horizon_eps, double safety, double fac_min,
                    double fac_max, int method, int dtype, void* stream) {
  void* const ptr[21] = {t, r, theta, phi, pt, pr, ptheta, pphi, k, h, Q,
                         rdot_sign, thetadot_sign, dt, emit, steps, status,
                         rdot_flips, eq_cross, r_was_positive, theta_was_positive};
  const double dest_params[4] = {dest_p0, dest_p1, dest_p2, dest_p3};
  const double ctrl[11] = {precision, theta_precision, max_tstep, maxtstep_rlim,
                           max_phistep, min_step, rk45_tol, horizon_eps,
                           safety, fac_min, fac_max};
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float>(ptr, n, spin, r_max, horizon, dest, dest_params, steplim,
                                 max_iters, ctrl, method, s)
      : dtype == 1 ? launch<double>(ptr, n, spin, r_max, horizon, dest, dest_params,
                                    steplim, max_iters, ctrl, method, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
