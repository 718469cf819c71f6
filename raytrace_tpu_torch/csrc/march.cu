// Geodesic march kernel for Hopper (sm_90a): each thread marches rays.
//
// Replaces the TPU kernel raytrace_tpu/ops/pallas_kernel.py::_make_kernel
// (the pl.pallas_call in _trace_pallas_padded) in every variant it builds:
// the methods euler, rk4 and rk45 with each of its four destinations,
// ThetaLimit/FlatDisc (dest_kind "theta"), DiscWithISCO ("isco"),
// FlatPlane ("plane") and SphericalShell ("shell"), in float32 (as on the
// TPU) and float64 — 24 instantiations — and the compaction schedule that
// raytrace_tpu/ops/compaction.py runs around it. Like the Pallas kernel it
// keeps each ray's whole march out of device memory: a thread loads its
// ray's 21 fields from the struct-of-arrays batch, runs the march in
// registers until the ray is no longer active or max_iters is reached, and
// stores once. Method and destination are template parameters
// (march_kernel<T, METHOD, DEST>), so each instantiation keeps only its own
// branch: the theta variants carry no annulus or plane test and no Euler
// code. The per-ray march is the state machine of march.cuh (lane_load,
// lane_step, lane_store); both schedules below drive it.
//
// What bounds it on this card: not memory — each ray moves about 170 bytes
// in and out against hundreds to thousands of steps of 1 (Euler), 4 (RK4)
// or 6 (DOPRI5, with the FSAL carry) rate evaluations, each with a sin, a
// cos, two square roots and a divide. What a step issues does. Built
// --fmad=false, every a*b+c is two instructions, and the precise divide,
// square root, sin and cos are sequences of tens of them; chip_smoke.py
// (phase 1) counts, from each kernel's SASS and by pipe, the least that
// one full iteration of its loop issues, whichever branches it takes. A
// float32 RK4 iteration issues at least ~650 instructions (~740 on its
// longest path), ~370 of them FP32: the kernel is bound by issue (four
// warp instructions a clock an SM), not by the FP32 pipe. A float64 RK45
// iteration issues at least ~1,630 (~1,920), ~880 of them on the FP64
// pipe (64 lanes an SM, half of the issue rate), which binds it a little
// before issue does. Beside that bound:
//  - occupancy: the f64 RK45 instantiations take 122-128 registers a
//    thread, 4 blocks of 128 threads (16 warps, 25%) an SM, enough to keep
//    those pipes fed on the throughput-bound batches;
//  - lane, block and wave tails: a warp runs until its slowest lane ends
//    (step counts of one batch spread from hundreds to ~10^4), a block
//    until its slowest warp does, and the last wave of a one-thread-per-ray
//    grid leaves SMs nearly empty;
//  - a stuck photon-sphere ray runs to steplim: its dependent steps take at
//    least its step count times the latency of one step.
//
// What the design does about them. The step issues less for the same bits
// (march.cuh): sin and cos of an angle come from one sincos call under a
// guard that lets the compiler drop the math library's slow range
// reduction from the step (its out-of-line branch calls the same
// functions); a floor against a constant takes one compare (FMNMX.NAN in
// float32); the step reads its constants from the launch parameters,
// where float64 would build each 64-bit literal with two moves. Together
// that is 14% fewer instructions a full iteration for float32 RK4 and 5%
// fewer FP64 instructions for float64 RK45, bitwise the same results, and
// 4-19% off every main-path row of the kernel table on an H100 (PERF.md). The lane-refill
// schedule (march_refill_kernel) launches only as many blocks as are
// resident at once (SM count x the occupancy of the kernel) and keeps
// them: a warp takes 32 consecutive ray indices from a global counter with
// one atomicAdd, marches them, and takes the next 32 once all its lanes
// are done. That removes the block and wave tails, not the lane tail
// inside a warp. Refilling single lanes as they free up was slower (a
// ballot a pass, divergent loads). On an H100 the refill schedule takes
// ~5% off the float64 RK45 discplane march, which no ray holds past ~10^4
// steps, so the launcher (ops/march_kernel.py) gives it that kernel
// (refilled() below) and the grid launch (one thread per ray, ceil(n /
// 128) blocks) to the rest: on the float32 RK4 emissivity and disc-image
// batches refill was 9% and 5% slower than the grid launch at the same 9
// blocks an SM (lane utilisation there is already 0.97-0.99), on the
// float64 RK45 sourceplane batch 1% slower, and where one
// stuck ray sets the time (the f64 RK45 plane batch) every refill variant
// tried was slower: the persistent grid keeps the ray's SM full until the
// counter runs dry, where the grid launch's retiring blocks thin it out.
// What the design does not do: a lone stuck ray is not sped up beyond its
// step's latency — its steps depend on one another, and bitwise agreement
// with the plain march fixes their number and order — nor is a warp's lane
// tail; and the math library's own sequences (divide, square root, sincos,
// pow) are not rewritten.
// Nor does the launch reorder its rays. A long-first order was tried on
// the float32 RK45 theta and isco kernels: the rays with the smallest
// separatrix score (Carter's radial potential minimised over 64 radii,
// ops/diff.py::separatrix_score) at the head of the launch, each alone in
// its block or warp, so that the rays that outlive the bulk would start in
// its first wave. Every order gives the same bits. On an H100 80GB HBM3 at 700 W
// (PERF.md) the score found none of them: of the rays still
// marching once 99.9% of each main-path batch had ended, the top 0.1% by
// score held at most 0.2%, and of the disc image's 36 rays stuck at 1e5
// steps the top 1% held one. Long-first was within 0.2% of the natural
// order on the disc-image batches and 1.3% slower on the emissivity
// batch, before the 2.1-2.2 ms that the score, the partition and the
// gathers cost, so the launcher keeps the natural order and has no order
// of its own. The disc-image isco batch sits 13% above its 64 longest
// rays marched alone (370.0 against 326.9 ms): its slowest stuck ray
// starts 35.9 ms into the launch; and the emissivity batch's longest ray
// starts at once but steps 1.43x slower than alone (3.81 against 2.67
// us) while the bulk shares its SM.
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
// Both schedules run each ray through the same IEEE operations in the same
// order, so they give the same bits.

#include <cuda_runtime.h>

#include "march.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int SCHEDULE_GRID = 0;
constexpr int SCHEDULE_REFILL = 1;
// Blocks an SM the refill kernels are built for: the occupancy of the f64
// RK45 grid kernel (124 registers, ptxas -v on sm_90a), so that the refill
// loop's few live values cost no resident block.
constexpr int kRefillBlocks = 4;

template <typename T>
using KernelFn = void (*)(rt::Params<T>, rt::Fields<T>, int64_t, unsigned long long*,
                          unsigned long long*);

#if defined(RT_LAUNCH_TRACE)
// The launch-trace side build (nvcc -DRT_LAUNCH_TRACE; chip_smoke.py phase
// 13 builds it apart, the launcher never loads it). In the kernels it
// traces (traced() below) every ray records %globaltimer when its march
// starts and when it stores, by slot, and each ray followed (traced[i] >=
// 0, a row of the tables) also its SM, its block, its iterations and the
// timer every `stride` iterations. The march itself is march_one's.
struct LaunchTrace {
  unsigned long long* start;    // n
  unsigned long long* stop;     // n
  const int* traced;            // n: the slot's row, or -1
  int* sm;                      // rows
  int* block;                   // rows
  int* iters;                   // rows
  unsigned long long* samples;  // rows x n_samples
  int stride, n_samples;
};
__device__ LaunchTrace g_trace;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int sm_id() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return static_cast<int>(s);
}

template <typename T, int METHOD, int DEST>
__device__ int march_traced(const rt::Params<T>& p, const rt::Fields<T>& f, int64_t i) {
  const LaunchTrace tr = g_trace;
  const int row = tr.traced[i];
  const T capture = rt::capture_radius(p);
  rt::Lane<T> l;
  rt::lane_load<T, METHOD>(p, f, i, l);
  tr.start[i] = global_ns();
  while (rt::lane_running(p, l)) {
    if (row >= 0 && l.it % tr.stride == 0 && l.it / tr.stride < tr.n_samples)
      tr.samples[static_cast<int64_t>(row) * tr.n_samples + l.it / tr.stride] = global_ns();
    rt::lane_step<T, METHOD, DEST>(p, capture, l);
  }
  const int iters = l.it;
  rt::lane_store<T, METHOD>(f, l);
  tr.stop[i] = global_ns();
  if (row >= 0) {
    tr.sm[row] = sm_id();
    tr.block[row] = static_cast<int>(blockIdx.x);
    tr.iters[row] = iters;
  }
  return iters;
}

// The instantiations the trace build traces: the float32 RK45 theta and
// isco kernels, whose launches chip_smoke.py phase 13 traces.
template <typename T, int METHOD, int DEST>
__host__ __device__ constexpr bool traced() {
  return sizeof(T) == 4 && METHOD == rt::METHOD_RK45 &&
         (DEST == rt::DEST_THETA || DEST == rt::DEST_ISCO);
}
#endif

// March ray i as this build's kernels do; returns its iterations.
template <typename T, int METHOD, int DEST>
__device__ __forceinline__ int march_ray(const rt::Params<T>& p, const rt::Fields<T>& f,
                                         int64_t i) {
#if defined(RT_LAUNCH_TRACE)
  if constexpr (traced<T, METHOD, DEST>()) return march_traced<T, METHOD, DEST>(p, f, i);
#endif
  return rt::march_one<T, METHOD, DEST>(p, f, i);
}

// The lane-iteration counter of a launch: the warp's lanes sum their
// iterations `it` and lane 0 adds the sum to *slot, one atomicAdd a warp.
// Every lane of the warp calls it (blocks are whole warps).
__device__ __forceinline__ void add_warp_iterations(unsigned long long* slot,
                                                    unsigned long long it) {
  for (int offset = 16; offset > 0; offset /= 2) it += __shfl_down_sync(0xffffffffu, it, offset);
  if (threadIdx.x % 32 == 0) atomicAdd(slot, it);
}

// The grid launch: thread i marches ray i. With `iters` set, the launch
// adds its rays' iterations to it (add_warp_iterations); null, nothing.
template <typename T, int METHOD, int DEST>
__global__ void __launch_bounds__(kThreads)
    march_kernel(rt::Params<T> p, rt::Fields<T> f, int64_t n, unsigned long long*,
                 unsigned long long* iters) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int it = 0;
  if (i < n) it = march_ray<T, METHOD, DEST>(p, f, i);
  if (iters != nullptr) add_warp_iterations(iters, static_cast<unsigned long long>(it));
}

// The lane-refill schedule: a persistent warp takes the next 32 ray
// indices from the counter `next` (one atomicAdd, by lane 0, its result
// shuffled to the others), each lane marches its ray to the end as thread
// i does under the grid launch, and the warp takes 32 more once all its
// lanes are done, until the counter passes n. Indices >= n are no ray.
// `iters`, where set, takes the iterations of all the warp's rays at once.
template <typename T, int METHOD, int DEST>
__global__ void __launch_bounds__(kThreads, kRefillBlocks)
    march_refill_kernel(rt::Params<T> p, rt::Fields<T> f, int64_t n,
                        unsigned long long* next, unsigned long long* iters) {
  const unsigned lane = threadIdx.x % 32;
  const unsigned long long count = static_cast<unsigned long long>(n);
  unsigned long long it = 0;
  for (;;) {
    unsigned long long base = 0;
    if (lane == 0) base = atomicAdd(next, 32ull);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= count) break;  // the same in every lane
    if (base + lane < count)
      it += rt::march_one<T, METHOD, DEST>(p, f, static_cast<int64_t>(base + lane));
  }
  if (iters != nullptr) add_warp_iterations(iters, it);
}

// The instantiation that runs the lane-refill schedule, the only one whose
// refill kernel is built (ops/march_kernel.py, _REFILLED, says the same to
// the launcher).
template <typename T, int METHOD, int DEST>
constexpr bool refilled() {
  return sizeof(T) == 8 && METHOD == rt::METHOD_RK45 && DEST == rt::DEST_ISCO;
}

// The kernel of one schedule; nullptr where it is not built.
template <typename T, int METHOD, int DEST>
KernelFn<T> pick(int schedule) {
  if (schedule == SCHEDULE_GRID) return march_kernel<T, METHOD, DEST>;
  if constexpr (refilled<T, METHOD, DEST>())
    if (schedule == SCHEDULE_REFILL) return march_refill_kernel<T, METHOD, DEST>;
  return nullptr;
}

template <typename T, int METHOD>
KernelFn<T> pick_dest(int dest, int schedule) {
  switch (dest) {
    case rt::DEST_THETA: return pick<T, METHOD, rt::DEST_THETA>(schedule);
    case rt::DEST_ISCO: return pick<T, METHOD, rt::DEST_ISCO>(schedule);
    case rt::DEST_PLANE: return pick<T, METHOD, rt::DEST_PLANE>(schedule);
    case rt::DEST_SHELL: return pick<T, METHOD, rt::DEST_SHELL>(schedule);
    default: return nullptr;
  }
}

template <typename T>
KernelFn<T> pick_method(int method, int dest, int schedule) {
  if (method == rt::METHOD_RK4) return pick_dest<T, rt::METHOD_RK4>(dest, schedule);
  if (method == rt::METHOD_RK45) return pick_dest<T, rt::METHOD_RK45>(dest, schedule);
  if (method == rt::METHOD_EULER) return pick_dest<T, rt::METHOD_EULER>(dest, schedule);
  return nullptr;
}

// Blocks of `kernel` resident on an SM of the current device, and the SMs.
cudaError_t occupancy(const void* kernel, int* per_sm, int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, 0);
  return err;
}

// Blocks of a refill kernel resident on the card at once, queried on its
// first launch and kept (one card per process).
cudaError_t resident_blocks(const void* kernel, unsigned* blocks) {
  constexpr int kSlots = 8;  // more than the refill kernels built
  static const void* kernels[kSlots];
  static unsigned resident[kSlots];
  int s = 0;
  for (; s < kSlots && kernels[s] != nullptr; ++s)
    if (kernels[s] == kernel) {
      *blocks = resident[s];
      return cudaSuccess;
    }
  int per_sm = 0, sms = 0;
  const cudaError_t err = occupancy(kernel, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  *blocks = static_cast<unsigned>(per_sm) * static_cast<unsigned>(sms);
  if (s < kSlots) {
    resident[s] = *blocks;
    kernels[s] = kernel;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(void* const* ptr, int64_t n, double spin, double r_max, double horizon,
                   int dest, const double* dest_params, int steplim, int max_iters,
                   const double* ctrl, int method, int schedule, unsigned long long* next,
                   unsigned long long* iters, cudaStream_t stream) {
  const KernelFn<T> kernel = pick_method<T>(method, dest, schedule);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const rt::Params<T> p =
      rt::make_params<T>(spin, r_max, horizon, dest_params, steplim, max_iters, ctrl);
  const rt::Fields<T> f = rt::make_fields<T>(ptr);
  unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (schedule == SCHEDULE_REFILL) {
    if (next == nullptr) return cudaErrorInvalidValue;
    unsigned resident = 0;
    const cudaError_t err = resident_blocks(reinterpret_cast<const void*>(kernel), &resident);
    if (err != cudaSuccess) return err;
    if (resident < blocks) blocks = resident;
  }
  void* args[] = {const_cast<rt::Params<T>*>(&p), const_cast<rt::Fields<T>*>(&f), &n, &next,
                  &iters};
  const cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                           dim3(kThreads), args, 0, stream);
  const cudaError_t last = cudaGetLastError();  // also clears a refused launch's error
  return err != cudaSuccess ? err : last;
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
// declaration order. schedule: 0 = grid launch, 1 = lane refill (built for
// the refilled() instantiations only), whose `next` is a zeroed device
// uint64 (the ray counter, fresh for every launch). iters: null, or a
// device int64 that the launch adds its rays' iterations to (every trial,
// accepted or rejected; the span recorder's launch counter).
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
                    double fac_max, int method, int dtype, int schedule, void* next,
                    void* iters, void* stream) {
  void* const ptr[21] = {t, r, theta, phi, pt, pr, ptheta, pphi, k, h, Q,
                         rdot_sign, thetadot_sign, dt, emit, steps, status,
                         rdot_flips, eq_cross, r_was_positive, theta_was_positive};
  const double dest_params[4] = {dest_p0, dest_p1, dest_p2, dest_p3};
  const double ctrl[11] = {precision, theta_precision, max_tstep, maxtstep_rlim,
                           max_phistep, min_step, rk45_tol, horizon_eps,
                           safety, fac_min, fac_max};
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* counter = static_cast<unsigned long long*>(next);
  auto* its = static_cast<unsigned long long*>(iters);
  const cudaError_t err =
      dtype == 0 ? launch<float>(ptr, n, spin, r_max, horizon, dest, dest_params, steplim,
                                 max_iters, ctrl, method, schedule, counter, its, s)
      : dtype == 1 ? launch<double>(ptr, n, spin, r_max, horizon, dest, dest_params,
                                    steplim, max_iters, ctrl, method, schedule, counter, its, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// What the card makes of one kernel (method, dest, dtype and schedule as
// rt_march_launch takes them): out[0] blocks resident on an SM, out[1]
// SMs, out[2] registers a thread, out[3] local memory a thread in bytes
// (stack and spills). Returns a CUDA error code, 0 on success.
int rt_march_kernel_info(int method, int dest, int dtype, int schedule, int* out) {
  const void* kernel =
      dtype == 0 ? reinterpret_cast<const void*>(pick_method<float>(method, dest, schedule))
      : dtype == 1 ? reinterpret_cast<const void*>(pick_method<double>(method, dest, schedule))
                   : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = occupancy(kernel, &out[0], &out[1]);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

#if defined(RT_LAUNCH_TRACE)
// Point the trace build's traced kernels at their tables (LaunchTrace)
// for the launches that follow; returns a CUDA error code.
int rt_launch_trace_set(void* start, void* stop, const void* traced, void* sm, void* block,
                        void* iters, void* samples, int stride, int n_samples) {
  const LaunchTrace tr{static_cast<unsigned long long*>(start),
                       static_cast<unsigned long long*>(stop), static_cast<const int*>(traced),
                       static_cast<int*>(sm), static_cast<int*>(block), static_cast<int*>(iters),
                       static_cast<unsigned long long*>(samples), stride, n_samples};
  return static_cast<int>(cudaMemcpyToSymbol(g_trace, &tr, sizeof(tr)));
}
#endif

}  // extern "C"
