// The emissivity's float64 redshift chains for Hopper (sm_90a), one thread a
// ray, on the per-ray routines of redshift.cuh.
//
// Replaces no TPU kernel. The JAX package leaves these chains to XLA, which
// fuses them into a few loops; the port ran them as torch's elementwise
// kernels: about 330 launches a job at the two ends of the march, each a
// full pass over 2.5M float64 values (~4.8 ms of device time a job), and
// the post-march chain made V a card tensor, a blocking copy that kept the
// host from queueing anything until the march had ended.
//  - emit_kernel: redshift_start's emitted energy (before the march).
//  - emis_weights_kernel: everything after the march up to the bin scatter
//    (bins.cu): the redshift, the route's hit test, the bin ids and the
//    four weight columns.
// What bounds them on this card: the reads and writes, ~72 B a ray for
// emit_kernel and ~121 B for emis_weights_kernel (0.3 GB a job at 2.5M
// rays, ~0.1 ms at 3.35 TB/s), and the FP64 divides and square roots between.
// What the design does about that: each field is read once and each
// output written once, every intermediate stays in registers, and every
// scalar is a launch argument, so nothing is copied to the card.

#include <cuda_runtime.h>

#include <cstdint>

#include "redshift.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void emit_kernel(rt::EmisRays f, rt::Spin<double> s, double V, int64_t n,
                            double* __restrict__ emit) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) emit[i] = rt::emit_one(f, s, V, i);
}

__global__ void emis_weights_kernel(rt::EmisRays f, rt::EmisParams p, rt::EmisOut o,
                                    int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) rt::emis_weights(f, p, o, i);
}

unsigned blocks(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// rays: 11 device pointers, in order t, r, theta, k, h, Q, rdot_sign,
// thetadot_sign, emit (n float64 each; t and emit unread here, may be
// null), steps, status (n int32 each). Writes emit (n float64) on `stream`:
// each ray's energy in the frame of material orbiting at Omega = V (V = -1
// Keplerian). Returns cudaGetLastError() after the launch (0 on success);
// does not synchronise.
int rt_emit_launch(const void* const* rays, void* emit, int64_t n, double spin, double V,
                   void* stream) {
  if (n <= 0 || n > (int64_t{1} << 40)) return static_cast<int>(cudaErrorInvalidValue);
  emit_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rt::make_emis_rays(rays), rt::make_spin(spin), V, n, static_cast<double*>(emit));
  return static_cast<int>(cudaGetLastError());
}

// rays as rt_emit_launch's, all 11 read. Writes on `stream` ids (n int64),
// mask (n bool: a disc hit of `route`, 0 plain or 1 rd, in a bin) and cols
// (4 x n float64: flux, emis, redshift, time weights), from the scalars
// make_emis_params takes (step: log dr for log bins, dr for linear ones).
// Returns cudaGetLastError() after the launch; does not synchronise.
int rt_emis_weights_launch(const void* const* rays, void* ids, void* mask, void* cols,
                           int64_t n, double spin, int route, double r_isco, double theta_lim,
                           int logbin, double r_min, double step, int64_t n_bins, double gamma,
                           double n_primary, void* stream) {
  if (n <= 0 || n > (int64_t{1} << 40) || (route != rt::EMIS_PLAIN && route != rt::EMIS_RD))
    return static_cast<int>(cudaErrorInvalidValue);
  emis_weights_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rt::make_emis_rays(rays),
      rt::make_emis_params(spin, route, r_isco, theta_lim, logbin, r_min, step, n_bins, gamma,
                           n_primary),
      rt::make_emis_out(ids, mask, cols, n), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
