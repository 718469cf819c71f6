#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (raytrace_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases, one line each with its seconds; any failed check raises, so the
script exits non-zero:
  0. device: name and power limit, TF32 off;
  1. build the march kernel from csrc/ with nvcc (ptxas registers, stack
     and spills of each kernel: the 24 grid-launch kernels and the
     lane-refill one); beside it, in parallel, the same source as a cubin,
     whose nvdisasm gives the least and the most that one full iteration
     of each grid kernel's march loop issues, by pipe (loop_issue; the
     least are the bound's instructions), the
     guarded trig of csrc/march.cuh checked bit for bit against the CUDA
     math library on every float32 and 1e9 float64 samples (trig_check),
     and the launch-trace side build of csrc/march.cu (-DRT_LAUNCH_TRACE,
     for phase 13; never the launcher's library);
  2. parity: the kernel against the plain torch march on the card, rk4 and
     rk45, float32 and float64, on the golden 0.05 grid (5,040 rays);
  3. golden: apps.emissivity.compute on the card against the reference
     binary's emissivity profile, with the count gates of
     tests/test_emissivity.py; and the midspin lamppost below the ISCO
     (spin 0.5, h 3) against its golden under the gates of
     tests/test_emissivity.py:158-196;
  4. full size: the emissivity CLI on par_example/emissivity.par (about
     2.5 M rays, RK45), and again with --integrator=rk4; the kernel's
     launch count is zeroed before and read after each run. Then the
     kernel against the plain march on that run's own batch (the par
     file's lamppost after redshift_start, float32 march, the par file's
     spin), with the float32 parity gates, as phase 12 holds its batches
     (hold_full_width);
  5. timing with CUDA events (kernel best of 3 after a warm-up, the plain
     march one run): the bench workload of bench.py (0.01 grid, 125,800
     rays) on the kernel, and the kernel against the plain march on the
     0.05 grid;
  6. image parity: the DiscWithISCO (rk4, rk45) and Euler (ThetaLimit)
     instantiations against the plain march, float32 and float64, on the
     82 x 82 isco golden grid (image-plane rays marched with spin -0.998);
  7. image goldens through apps.imageplane_disc_image.compute on the card:
     the isco variant against the reference binary's isco image, and the
     plain rk45 float32 run at dist 1e4 (501 x 501 rays) against the
     far-field golden with the gates of analysis/tpu_validation.py;
  8. image full width: main, main_rd and main_isco on
     par_example/imageplane_disc_image.par (1,002,001 rays; main_isco also
     with --integrator=rk4, main also with --integrator=euler), the launch
     count zeroed before and read after each run, the FITS file read back;
     then the kernel against the plain march on that batch
     (hold_full_width): isco rk45, euler x theta and isco rk4;
  9. image timing with CUDA events: each new instantiation against its
     plain version on the 82 x 82 grid (the plain march's float32 run of
     phase 6, timed there);
 10. caustic parity: the caustics slice's instantiations against the plain
     march at steplim 3000, float32 and float64, with CUDA-event times
     (kernel best of 3, plain one run): euler x isco and euler/rk4/rk45 x
     plane on 21 x 21 bundle grids of the discplane and plane goldens'
     geometries, euler/rk4/rk45 x shell (float64) on the lamppost 0.05 grid
     with SphericalShell(40) and the boundary at r = 2.5; the variants that
     phase 12 compares at full width (the caustic runs' float64 ones, the
     shell route's float32 ones) are left to it;
 11. caustic goldens through apps.caustics.compute on the card, float64
     march, with the gates of tests/test_caustics.py:97-219; the discplane
     golden again in float32 against analysis/tpu_validation.py's gates;
 12. caustic full width: main_discplane (also --integrator=euler),
     main_plane (also --integrator=rk4) and main_sourceplane on
     par_example/caustic_*.par (1,255,005 / 1,255,005 / 251,001 rays), the
     launch count zeroed before and read after each run, the variant and
     float64 checked at the route, the FITS file read back. Then the kernel
     against the plain march on each run's own batch, and the
     SphericalShell route on the bench grid (trace_auto, float32,
     euler/rk4/rk45) on its batch (hold_full_width);
 13. schedules: on every main path's full-width batch held above (the two
     emissivity batches, five disc-image ones, the five caustic runs and
     the three shell routes), at its CLI's steplim, the kernel under the
     schedule the launcher gives it; where that is the lane-refill
     schedule (the float64 RK45 isco kernel), it and the grid
     launch timed in turns (grid, refill, refill, grid), the refill result
     bitwise the grid launch's; occupancy, registers, lane figures from
     the step counts, one step's latency of the batch's longest ray alone,
     the 64 longest rays marched alone, each in its own warp (the batch's
     latency floor), and the bound (time_schedules). On the three float32
     RK45 theta and isco batches (emissivity, disc image isco and theta)
     the launch-trace build, bitwise the launcher's kernel: when the 64
     longest rays start and end, their latency a step while the bulk runs
     and after it, their warp-mates, their SMs, and those rays alone
     (trace_longest);
 14. slice parity (slice_phases): the kernel against the plain march,
     euler/rk4/rk45 x theta in float32 and float64 at steplim 3000, on four
     batches built as the slice's apps build them (slice_batch): a jet
     (v_jet 0.5, h 5), an arbitrary 4-velocity source, the returning-radiation
     disc source at r = 6 and a HEALPix order-4 lamppost (15,360 rays); a
     superluminal jet (v 0.6 at r = 4) ends NUMERIC with no real fate on
     both routes; RadialVelocityField goes through trace_auto to the plain
     march on the card with no kernel launch;
 15. slice full width: lamppost main_sky (static and --v_jet=0.5),
     main_angdist and main_sky_discfrac (--integrator=rk4, euler) and
     return_radiation main_photonfrac_r on par_example/emissivity.par's
     grid and source (2,507,316 rays), healpix_apps main_to_disc at order 8
     (3,932,160 rays), main_photonfrac with its defaults (20 launches of
     5,040 rays) and trace_rays main on par_example/trace_rays.par; each
     CLI's wall, its march's share (CUDA events around trace_auto) and its
     launch count (zeroed before, read after), its output read back; then
     the kernel against the plain march on the jet sky, disc-source and
     HEALPix batches (hold_full_width);
 16. the two trajectory goldens through trace_rays main and main_imageplane
     on the card, under the gates of tests/test_capabilities.py:346-440;
 17. the outflow and wind family, the perf harness and the line profile at
     full width on the card (outflow_phases): outflow main, main_ent,
     main_spectrum and main_emis_bin on par_example/outflow.par (3,600
     rays, 200 bins; 50 x 25 x 50 cells), main_pointsource_mapper on
     par_example/pointsource_mapper.par (31,500 rays), pcyg at its defaults
     (Nx 200, Nen 400, dz 0.01), the disc-wind and SEI profiles at Nen 200,
     perf_test on par_example/perf_test.par (5,040 rays; euler, rk4, rk45 x
     3 repeats, through the kernel) and the line profile traced on
     par_example/imageplane_disc_image.par's geometry and grid and read
     from phase 8's FITS file; each run's wall, its march's share (CUDA
     events around the march) and lock-step iterations, its kernel
     launches (zeroed before, read after, by variant), its output read back
     and checked;
     17b. the line profile's spin secant: apps.imageplane_disc_image.compute
     through the kernel (rk45 x theta, march_dtype float64) at spins 0.88
     and 0.92 on the dense 89 x 89 camera (dist 100, incl 55, r_disc 15),
     folded and held against the reference binary's pair under the gates
     of tests/test_diff.py:335-418; the float32 march's figures beside;
 18. slice checks on the card: pcyg against the reference binary's golden
     (tests/test_capabilities.py:210-245); map_rays and run_source_trace
     on the card against the CPU on phase 17's geometries cut to a few
     hundred rays; the radial-flight mapper and flat-limit source-tracer
     checks of tests/test_weakfield.py; the RK45 rejected-trial share
     (ops/diagnostics.py, the plain float32 DOPRI5 march, which the kernel
     follows bit for bit) on the perf_test.par grid and the emissivity
     batch, and how much of the rk45 x theta f32 row's excess over its
     bound the rejected trials explain.
 19. gradients (gradient_phases; ops/diff.py, torch autograd over the
     plain step, no kernel of its own), float64 at full width:
     a. trace_scan's forward (3072 lock-step iterations) against the march
        kernel (rk4 x theta f64, steplim 3073) on the bench lamppost
        (125,800 rays): every ray that ends within the iterations has the
        same status and steps, r, phi, theta and t within rtol 1e-12 (the
        share bit for bit printed); the launch is the kernels line's
        rk4 x theta f64 record, timed as phase 13 times the others;
     b. emissivity_gradient_pipeline(0.998, 5, 2) on that grid, 3072
        iterations: the value alone, value and reverse-mode gradient in
        (spin, h, gamma) (checkpointed chunks of 64), and forward mode in
        each parameter, equal to reverse to rtol 1e-10; walls, ms a
        forward and a backward step, peak device memory;
     c. the reference-binary gates of tests/test_diff.py:134-214:
        d(emis)/d(spin) by forward mode against the 0.89/0.91 goldens' FD,
        and the height secant against the h 4.5/5.5 goldens (0.05 grid,
        6144 iterations);
     d. line_profile_observable on the 89 x 89 dense grid (dist 100, incl
        55, r_disc 15, 2048 iterations): the gradient of the profile's sum
        in (spin, incl), reverse against forward mode to rtol 1e-10;
     the phase's numbers on one line, {"gradients": {...}}; 19a's row times
     the kernel's launch alone (launch_ms), best of 3 after a warm-up, its
     march being short enough for prepare's casts to swamp it;
 20. resume, progress, checkpoints and sharding (resume_shard_phases):
     a. trace_kernel_phased (phase_iters 2048) against one trace_kernel
        launch on the emissivity par file's batch (rk4 bit for bit; rk45
        rays that differ counted), its launches and overhead; then the
        phased kernel against the phased plain march (trace_compacted,
        progress=True) on the bench grid at STUCK_STEPLIM, bit for bit;
     b. rk4 f32 on the bench grid: 150 iterations, save_rays, load_rays
        onto the card, resume = the uninterrupted march bit for bit;
     c. the emissivity CLI with --show_progress=1 and RT_PROFILE in a
        subprocess: the phase line and the bar on stderr, a Chrome trace
        naming the march kernel once a phase, the device's idle share over
        the march+bin phase (device_idle), the output equal to the run
        without the key;
     d. a world of one over NCCL in this process: apps.emissivity.compute
        over the mesh against without it (a world of one with no group;
        both timed with the card to themselves), sharded_caustic_trace on
        phase 10's plane bundles against trace_auto, and the dry-run case
        (dryrun_case, __graft_entry__.py's sizes) with the gradient against
        MULTICHIP_r05.json's pins to rtol 1e-8;
     e. after the timed turns, 2 gloo ranks on the card run dryrun_case
        (multiprocess_check.launch) beside the rest of d: traces and
        gathered bundles bit for bit the world of one's, sums and gradients
        to rtol 1e-12;
     f. started with e, multiprocess_check (one NCCL process, 384
        iterations), then scaling_bench: their JSON, one line each;
     the phase's numbers on one line, {"resume_and_shards": {...}}.
A main path's batch is held against the plain march in full
(hold_full_width): at kernel_steplim where no ray sticks, otherwise at
STUCK_STEPLIM, so that every ray, stuck or not, is compared over its
first STUCK_STEPLIM steps, the kernel under the launcher's schedule and,
where that is the lane-refill schedule, bitwise the grid launch's. On the
card the plain march replays each compaction epoch's iteration as a CUDA
graph (ops/integrate.py).
The last lines are phase 13's launch-trace record, phase 19's, phase 20's,
the per-kernel JSON record and the device record.
A record's ms is its main path's batch at the CLI's steplim under the
schedule the launcher gives it; bound_ms the largest of its issue times
(each pipe's instructions, and all of them, over the card's rates; see
SASS_PIPES) and its bytes over the memory rate, bound_by "operations" or
"bytes" (as every record of the line has them) and bound_pipe the binding
one; issue_per_step the least that one full loop iteration issues by pipe,
on which the bound stands, and issue_per_step_most the most (loop_issue);
latency_bound_ms the longest ray's steps times one step's latency,
lone_floor_ms the 64 longest rays marched alone; a
record's launches include phase 20's (phased, sharded and CLI runs);
rk45 x theta f32 also reject_share and bound_ms_with_trials (phase 18).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SPIN = 0.998
SOURCE = (0.0, 5.0, 1e-3, 1.5707)
GOLDEN = ROOT / "tests" / "golden" / "emissivity_a0.998_h5_g0.05.dat"
GOLDEN_MIDSPIN = ROOT / "tests" / "golden" / "emissivity_a0.5_h3_g0.05.dat"
PARFILE = ROOT / "par_example" / "emissivity.par"
IMAGE_PARFILE = ROOT / "par_example" / "imageplane_disc_image.par"
GOLDEN_ISCO = ROOT / "tests" / "golden" / "disc_image_isco_a0.998_i60_rk45.bin"
GOLDEN_FAR = ROOT / "tests" / "golden" / "disc_image_d10000_a0.998_i80_rk45.bin"
IMAGE_MAPS = ("flux", "r", "phi", "enshift", "time", "emis")
# the image slice's new instantiations: (method, destination kind)
IMAGE_VARIANTS = (("rk4", "isco"), ("rk45", "isco"), ("euler", "theta"))
# full-width runs: (entry point, extra argument, kernel variant it launches)
IMAGE_RUNS = (
    ("main", None, "rk45_theta"),
    ("main_rd", "--integrator=rk4", "rk4_theta"),
    ("main_isco", None, "rk45_isco"),
    ("main_isco", "--integrator=rk4", "rk4_isco"),
    ("main", "--integrator=euler", "euler_theta"),
)
REPLACES = "raytrace_tpu/ops/pallas_kernel.py:96"
SOURCE_FILE = "raytrace_tpu_torch/csrc/march.cu"
BENCH_STEPLIM = {"rk4": 30_000, "rk45": 40_000}
# The plain march costs its lock-step iteration count, and a ray stuck at
# kernel_steplim holds it for ~125k iterations: a batch with stuck rays is
# compared at STUCK_STEPLIM (phases 4, 8, 12)
STUCK_STEPLIM = 10_000
# phase 19: trace_scan's n_steps of the emissivity gradient (and of 19a's
# batch), and of the binned profile's reference-binary gates
GRAD_STEPS = 3072
BINNED_STEPS = 6144
CAUSTIC_PARFILES = {t: ROOT / "par_example" / f"caustic_{n}.par"
                    for t, n in (("disc", "discplane"), ("plane", "plane"),
                                 ("sphere", "sourceplane"))}
CAUSTIC_MAINS = {"disc": "main_discplane", "plane": "main_plane", "sphere": "main_sourceplane"}
# full-width runs: (target, extra argument, kernel variant it launches)
CAUSTIC_RUNS = (
    ("disc", None, "rk45_isco_f64"),
    ("disc", "--integrator=euler", "euler_isco_f64"),
    ("plane", None, "rk45_plane_f64"),
    ("plane", "--integrator=rk4", "rk4_plane_f64"),
    ("sphere", None, "rk45_theta_f64"),
)
# phase 10: (method, destination kind, march dtype)
CAUSTIC_PARITY = (
    [("euler", "isco", "float32")]
    + [(m, "plane", "float32") for m in ("euler", "rk4", "rk45")] + [("euler", "plane", "float64")]
    + [(m, "shell", "float64") for m in ("euler", "rk4", "rk45")]
)
SHELL = dict(r_shell=40.0, boundary=2.5)
# phases 14-16: the lamppost family, moving sources, returning radiation,
# HEALPix and the trajectory dumps
SLICE_KINDS = ("jet", "vel", "disc", "healpix")
SLICE_STEPLIM = 3000
TRACE_RAYS_PARFILE = ROOT / "par_example" / "trace_rays.par"
TRAJ_GOLDEN = ROOT / "tests" / "golden" / "trace_rays_a0.998_r5_euler.dat"
TRAJ_GOLDEN_IP = ROOT / "tests" / "golden" / "trace_rays_imageplane_a0.9_d100_i60_euler.dat"
# phase 15: (app module, entry, extra arguments, tag, variant, launches,
# batch held at full width or None); every run but the last two reads the
# emissivity par file's grid (2,507,316 rays) and source
SLICE_RUNS = (
    ("lamppost", "main_sky", [], "sky static", "rk45_theta", 1, None),
    ("lamppost", "main_sky", ["--v_jet=0.5"], "sky jet", "rk45_theta", 1, "jet"),
    ("lamppost", "main_angdist", [], "angdist", "rk45_theta", 1, None),
    ("lamppost", "main_sky_discfrac", ["--integrator=rk4"], "discfrac rk4", "rk4_theta", 1, None),
    ("lamppost", "main_sky_discfrac", ["--integrator=euler"], "discfrac euler", "euler_theta", 1,
     None),
    ("return_radiation", "main_photonfrac_r", ["--r_source=6"], "photonfrac_r", "rk45_theta", 1,
     "disc"),
    ("healpix_apps", "main_to_disc", ["--order=8"], "healpix to_disc", "rk45_theta", 1,
     "healpix"),
    ("return_radiation", "main_photonfrac", ["--spin=0.998"], "photonfrac", "rk45_theta", 20,
     None),
    ("trace_rays", "main", [], "trace_rays", None, 0, None),
)
# phases 17-18: the outflow and wind family, the perf harness, the line
# profile. Phase 17's runs: (app module, entry, arguments, tag, (module,
# function) timed as the march, par file's batch checked by check_outflow)
OUTFLOW_PARFILE = ROOT / "par_example" / "outflow.par"
MAPPER_PARFILE = ROOT / "par_example" / "pointsource_mapper.par"
PERF_PARFILE = ROOT / "par_example" / "perf_test.par"
PCYG_GOLDEN = ROOT / "tests" / "golden" / "pcyg_nx200_nen400.dat"
OUTFLOW_RUNS = (
    ("outflow", "main", [f"--parfile={OUTFLOW_PARFILE}"], "outflow", "run_source_trace"),
    ("outflow", "main_ent", [f"--parfile={OUTFLOW_PARFILE}"], "outflow ent",
     "run_source_trace"),
    ("outflow", "main_spectrum", [f"--parfile={OUTFLOW_PARFILE}", "--spectrum={lines}"],
     "outflow spectrum", "run_source_trace"),
    ("outflow", "main_emis_bin", [f"--parfile={OUTFLOW_PARFILE}"], "emis_bin", "map_rays"),
    ("outflow", "main_pointsource_mapper", [f"--parfile={MAPPER_PARFILE}"], "pointsource mapper",
     "map_rays"),
    ("pcyg", "main", [], "pcyg", "compute"),
    ("sobolev_wind", "main_disc_wind", ["--Nen=200"], "disc wind", "disc_wind_profile"),
    ("sobolev_wind", "main_pcyg_sei", ["--Nen=200"], "pcyg sei", "pcyg_sei_profile"),
    ("perf_test", "main", [f"--parfile={PERF_PARFILE}"], "perf test", "trace_auto"),
    ("line_profile", "main", [f"--parfile={IMAGE_PARFILE}"], "line profile", "trace_auto"),
    ("line_profile", "main", ["--image={image}", "--Nen=200"], "line profile image", None),
)
# The bound of a march (march_bound) counts what one full iteration of the
# kernel's march loop must issue, by pipe. Phase 1 reads it from nvdisasm
# of csrc/march.cu built as a cubin with the march kernel's flags, grid
# kernel by grid kernel (step_issue): the fewest instructions of any
# straight path through the loop body that takes a whole step
# (loop_issue). Each pipe's count times the steps of the unstuck rays,
# over the pipe's lanes an SM x the SMs x the card's clocks.max.sm, is one
# lower bound; all instructions over the 128 an SM issues a clock (4
# schedulers, one warp instruction each) another; the bytes over the memory rate the last. Lanes an SM for
# compute capability 9.0 (CUDA C++ Programming Guide, throughput of native
# arithmetic instructions, results a clock an SM): FP32 add, multiply and
# multiply-add 128; FP64 add, multiply, multiply-add 64 (the FP64 compares
# and min/max issue to the same pipe); MUFU (reciprocal, reciprocal square
# root and the other special functions) 16; 32-bit integer add, multiply,
# shift, compare, min/max and logic 64 (float compares, min/max and selects
# go to the same ALU); type conversions 16. Control, memory, uniform-
# datapath and barrier instructions count only towards issue.
SASS_PIPES = {
    "fp32": ("FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I", "FSWZADD", "HFMA2",
             "HADD2", "HMUL2"),
    "fp64": ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET"),
    "mufu": ("MUFU",),
    "int": ("IADD3", "IADD", "IMAD", "IMUL", "IMNMX", "ISETP", "ISET", "LOP3", "LOP", "SHF",
            "SHL", "SHR", "SEL", "FSEL", "FSETP", "FSET", "FMNMX", "FCHK", "PRMT", "LEA", "MOV",
            "IABS", "P2R", "R2P", "PLOP3", "BMSK", "SGXT", "IDP", "BREV", "VIADD", "VIMNMX",
            "IADD32I", "LOP32I", "IMAD32I", "MOV32I", "ISCADD", "CS2R"),
    "conv": ("F2I", "I2F", "F2F", "I2I", "F2FP", "FRND", "I2FP", "F2IP", "POPC", "FLO"),
}
PIPE_OF = {op: pipe for pipe, ops in SASS_PIPES.items() for op in ops}
PIPE_LANES = {"fp32": 128, "fp64": 64, "mufu": 16, "int": 64, "conv": 16}
ISSUE_LANES = 128
PIPES = tuple(PIPE_LANES) + ("total",)
# what phase 1 counts and reads: (method, destination kind, dtype name) ->
# instructions of one loop iteration by pipe; the card's SMs and clock
STEP_ISSUE = {}
CARD = {}
HBM_BYTES_PER_S = 3.35e12
KINDS = ("theta", "isco", "plane", "shell")
# CUDA math library subroutines that only its slow paths call, and the
# guarded trig's out-of-line branch (csrc/march.cuh, sincos_far, cos_far)
SLOW_CALLEE = r"slowpath|mediumpath|_full|_far"
# The guarded trig of csrc/march.cuh (m_sincos, m_cos) against the CUDA
# math library's sinf/cosf and sin/cos, built with the march kernel's flags
# and compared bit for bit: every float32 bit pattern, and for float64
# n seeded samples (a quarter each uniform on [-8, 8], log-uniform in
# magnitude from 2^-40 to 2^40, raw 64-bit patterns, and within 2^20 ulps
# of a multiple of pi/4 up to 1e3) plus every double within WIDTH ulps of
# k pi/4 for |k| <= 1273 (|k pi/4| <= 1e3).
TRIG_CHECK = r"""
#include "march.cuh"
__device__ unsigned long long mismatches[4];
__device__ __forceinline__ bool same(float a, float b) { return __float_as_uint(a) == __float_as_uint(b); }
__device__ __forceinline__ bool same(double a, double b) {
  return __double_as_longlong(a) == __double_as_longlong(b);
}
__device__ __forceinline__ void check(float x) {
  const rt::SinCos<float> g = rt::m_sincos(x);
  const float s = sinf(x), c = cosf(x);
  if (!same(g.s, s) || !same(g.c, c)) atomicAdd(&mismatches[0], 1ull);
  if (!same(rt::m_cos(x), c)) atomicAdd(&mismatches[1], 1ull);
}
__device__ __forceinline__ void check(double x) {
  const rt::SinCos<double> g = rt::m_sincos(x);
  const double s = sin(x), c = cos(x);
  if (!same(g.s, s) || !same(g.c, c)) atomicAdd(&mismatches[2], 1ull);
  if (!same(rt::m_cos(x), c)) atomicAdd(&mismatches[3], 1ull);
}
__device__ __forceinline__ unsigned long long mix(unsigned long long z) {  // splitmix64
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}
__device__ __forceinline__ double nudge(double x, long long ulps) {
  return __longlong_as_double(__double_as_longlong(x) + ulps);  // x != 0: same sign
}
__global__ void check_f32() {
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < (1ull << 32); i += stride)
    check(__uint_as_float((unsigned)i));
}
__global__ void check_f64(unsigned long long n, unsigned long long seed, long long width) {
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  const double quarter_pi = 0.78539816339744830962;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long u = mix(seed ^ mix(i));
    const double unit = (u >> 11) * 0x1.0p-53;
    const double sign = (u & 1) ? -1.0 : 1.0;
    double x;
    switch (i & 3) {
      case 0: x = 16.0 * unit - 8.0; break;
      case 1: x = sign * exp2(80.0 * unit - 40.0); break;
      case 2: x = __longlong_as_double((long long)u); break;
      default: {
        const long long k = (long long)((u >> 8) % 2547) - 1273;
        x = k == 0 ? sign * unit : nudge(k * quarter_pi, (long long)((u >> 40) % 2097153) - 1048576);
      }
    }
    check(x);
  }
  // every double within `width` ulps of k pi/4, |k| <= 1273
  const unsigned long long sweep = 2547ull * (2 * width + 1);
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < sweep; i += stride) {
    const long long k = (long long)(i / (2 * width + 1)) - 1273;
    const long long d = (long long)(i % (2 * width + 1)) - width;
    check(k == 0 ? d * 0x1.0p-1074 : nudge(k * quarter_pi, d));
  }
}
extern "C" int trig_check(unsigned long long n, unsigned long long seed, long long width,
                          unsigned long long* out) {
  const unsigned long long zero[4] = {0, 0, 0, 0};
  cudaError_t err = cudaMemcpyToSymbol(mismatches, zero, sizeof(zero));
  if (err != cudaSuccess) return (int)err;
  check_f32<<<132 * 16, 256>>>();
  check_f64<<<132 * 16, 256>>>(n, seed, width);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, mismatches, sizeof(zero));
  return (int)err;
}
"""
TRIG_SAMPLES, TRIG_SEED, TRIG_WIDTH = 1_000_000_000, 5, 4096

class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            print(f"[phase] {self.name}: ok in {time.perf_counter() - self.t0:.2f} s", flush=True)


def smi_query(fields: str, units: bool = False) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}",
         "--format=csv,noheader" + ("" if units else ",nounits")],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def smi_line() -> str:
    return smi_query("name,power.limit", units=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, torch, repeats=3, warmup=True):
    """Best of ``repeats`` CUDA-event times of fn(), after one warm-up
    unless ``warmup`` is False."""
    if warmup:
        fn()
        torch.cuda.synchronize()
    best = float("inf")
    out = None
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best, out


def lamppost(grid, dtype, spin=SPIN, source=SOURCE, V=0.0):
    """Lamppost batch on the card after redshift_start, built in float64 as
    apps.emissivity.compute builds it, then cast to ``dtype``."""
    from raytrace_tpu_torch.ops.redshift import redshift_start
    from raytrace_tpu_torch.sources import point_source

    rays = point_source(source, V, spin, grid, device="cuda")
    return redshift_start(rays, spin, V).to(dtype=dtype)


def image_rays(grid, dtype, torch, dist=500.0, incl=60.0, spin=SPIN):
    """Image-plane batch on the card after redshift_start, built as
    apps.imageplane_disc_image.compute builds it (float64, with the
    knife-edge floor of the march dtype), then cast to ``dtype``. March it
    with the spin -spin."""
    from raytrace_tpu_torch.ops.redshift import redshift_start
    from raytrace_tpu_torch.sources import image_plane

    rays = image_plane(dist, incl, grid, spin, device="cuda", work_dtype=dtype)
    return redshift_start(rays, -spin, 0.0, reverse=True).to(dtype=dtype)


def image_dest(kind, r_disc, spin=SPIN):
    """The destination of the isco app (DiscWithISCO) or of the plain one."""
    from raytrace_tpu_torch.destinations import DiscWithISCO, ThetaLimit
    from raytrace_tpu_torch.geometry import isco_radius

    return DiscWithISCO(isco_radius(spin), r_disc) if kind == "isco" else ThetaLimit()


def read_image_golden(path, n):
    """The reference binary's raw maps (tests/test_images.py:85-94)."""
    import numpy as np

    raw = path.read_bytes()
    maps = {name: np.frombuffer(raw, "<f8", count=n * n, offset=i * n * n * 8).reshape(n, n)
            for i, name in enumerate(IMAGE_MAPS)}
    counts = np.fromfile(f"{path}.counts", dtype="<i4").reshape(n, n)
    return maps, counts


def image_golden_check(tag, out, path, n, count_tol, tols, min_pixels):
    """Disc-ray count within count_tol of the reference's, and the median
    relative deviation of each map over pixels with >= 3 rays in both runs
    below its tolerance."""
    import numpy as np

    maps, counts = read_image_golden(path, n)
    n_mine, n_ref = int(out["counts"].sum()), int(counts.sum())
    good = (counts >= 3) & (out["counts"] >= 3)
    devs = {f: float(np.median(np.abs(out[f][good] / maps[f][good] - 1))) for f in tols}
    print(f"golden {tag}: disc rays {n_mine} (reference {n_ref}, {n_mine - n_ref:+d}), "
          f"{int(good.sum())} pixels with >= 3 rays in both, median rel dev {devs}")
    check(abs(n_mine - n_ref) <= count_tol * n_ref, f"{tag}: disc-ray count off")
    check(good.sum() >= min_pixels, f"{tag}: only {int(good.sum())} gated pixels")
    for f, tol in tols.items():
        check(devs[f] < tol, f"{tag}: {f} median dev {devs[f]:.3e} >= {tol}")


def read_dense_golden(tag, n=89):
    """A raw-dump disc-image golden of the line-profile pair
    (tests/test_diff.py:362-376): the .bin frames transposed to [x][y],
    the .counts dump x-major already."""
    maps, counts = read_image_golden(ROOT / "tests" / "golden" / f"disc_image_{tag}.bin", n)
    return {k: v.T for k, v in maps.items()}, counts


def line_profile(maps, counts):
    """The folded line profile P and its ray counts N over 48 bins of
    E_obs/E_rest on [0.3, 1.3] (tests/test_diff.py:378-388)."""
    import numpy as np

    edges = np.linspace(0.3, 1.3, 49)
    good = ((counts > 0) & np.isfinite(maps["flux"]) & np.isfinite(maps["enshift"])
            & (maps["enshift"] > 0))
    e = maps["enshift"][good]
    P, _ = np.histogram(e, bins=edges, weights=(maps["flux"] * counts)[good])
    N, _ = np.histogram(e, bins=edges, weights=counts[good].astype(float))
    return P, N


def secant_figures(prof):
    """The count-gated bins and, on them, the level and secant deviations of
    the profiles ``prof`` (spin -> (P, N)) from the reference binary's pair
    at spins 0.88 and 0.92 (tests/test_diff.py:398-418)."""
    import numpy as np

    PA, NA = line_profile(*read_dense_golden("dense_a0.88_i55"))
    PB, NB = line_profile(*read_dense_golden("dense_a0.92_i55"))
    (PmA, NmA), (PmB, NmB) = prof[0.88], prof[0.92]
    gate = ((NA >= 100) & (NB >= 100) & (np.abs(NB - NA) <= 0.02 * NA) & (NmA >= 100)
            & (np.abs(NmB - NmA) <= 0.02 * NmA)
            & (np.abs(PB / np.where(PA == 0, 1, PA) - 1) > 0.01))
    lev = np.abs(PmA[gate] / PA[gate] - 1)
    rel = np.abs((PmB - PmA)[gate] / (PB - PA)[gate] - 1)
    return gate, lev, rel


def sass_kernels(dis):
    """Kernel name -> (instructions, labels) from nvdisasm output: each
    kernel's .text section with its subroutines; an instruction is
    (address, predicated, opcode, operands), a label maps to the index of
    the instruction that follows it."""
    import re

    insn = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
    out, cur, pending = {}, None, []
    for line in dis.splitlines():
        m = re.match(r"^\.text\.(\S+):\s*$", line)
        if m:
            cur, pending = out.setdefault(m.group(1), ([], {})), []
            continue
        if cur is None:
            continue
        if re.match(r"^\.(?!L_)\S+", line):
            cur = None
            continue
        m = re.match(r"^(\S+):\s*$", line)
        if m:
            pending.append(m.group(1))
            continue
        m = insn.search(line)
        if m:
            for label in pending:
                cur[1][label] = len(cur[0])
            pending = []
            a, pred, op, args = m.groups()
            cur[0].append((int(a, 16), bool(pred), op, args.strip()))
    return out


def loop_issue(instrs, labels):
    """Instructions by pipe that one full iteration of a kernel's march
    loop issues on its straight path: {"least": counts, "most": counts}.
    A loop's straight paths run from its header to a latch through the
    blocks that are not slow: a block that calls a slow path of the CUDA
    math library (SLOW_CALLEE), touches local memory, or lies on a loop
    inside the march loop (the Payne-Hanek reduction) is slow. A full
    iteration evaluates every rate of its method, each with two square
    roots, so the full paths are the straight ones that take the most
    MUFU.RSQ (a step that ends after its first rates takes fewer).
    "least" holds, pipe by pipe, the fewest instructions of any full path:
    what every full iteration issues, whichever branches it takes. "most"
    holds the counts of the full path that issues the most. A subroutine
    that a block calls (double pow's) adds its own least or most over its
    straight paths to RET. The march loop is the loop whose full paths
    issue the most (the lane-refill kernel's loop over rays holds it)."""
    import re
    from collections import Counter

    def target(args):
        return labels[re.search(r"`\(([^)]+)\)", args).group(1)]

    leaders = {0}
    for i, (_, _, op, args) in enumerate(instrs):
        base = op.split(".")[0]
        if base in ("BRA", "CALL"):
            leaders.add(target(args))
        if base in ("BRA", "EXIT", "RET", "CALL"):
            leaders.add(i + 1)
    starts = sorted(i for i in leaders if i < len(instrs))
    blocks = list(zip(starts, starts[1:] + [len(instrs)]))
    block_of = {b: k for k, (b, _) in enumerate(blocks)}
    succ, slow, callee, ret, size = [], [], [], [], []
    for k, (b, e) in enumerate(blocks):
        _, pred, op, args = instrs[e - 1]
        base = op.split(".")[0]
        ops = [instrs[i][2].split(".")[0] for i in range(b, e)]
        size.append(e - b)
        slow_call = base == "CALL" and re.search(SLOW_CALLEE, args) is not None
        slow.append(slow_call or "LDL" in ops or "STL" in ops)
        callee.append(block_of[target(args)] if base == "CALL" and not slow_call else None)
        ret.append(base == "RET")
        nxt = [k + 1] if k + 1 < len(blocks) else []
        if base == "BRA":
            cond = pred or re.match(r"!?U?P[T0-9]", args) is not None
            succ.append([block_of[target(args)]] + (nxt if cond else []))
        elif base in ("EXIT", "RET"):
            succ.append(nxt if pred else [])
        else:
            succ.append(nxt)

    def back_edges(entry, allowed):
        """Edges u -> h found by a DFS from entry over `allowed` whose head is on the stack."""
        edges, state, stack = [], {entry: 1}, [(entry, iter(succ[entry]))]
        while stack:
            k, it = stack[-1]
            for t in it:
                if t not in allowed:
                    continue
                if state.get(t) == 1:
                    edges.append((k, t))
                elif t not in state:
                    state[t] = 1
                    stack.append((t, iter(succ[t])))
                    break
            else:
                state[k] = 2
                stack.pop()
        return edges

    def natural_loop(header, latches):
        body, todo = {header}, list(latches)
        pred = {}
        for k, ts in enumerate(succ):
            for t in ts:
                pred.setdefault(t, []).append(k)
        while todo:
            k = todo.pop()
            if k not in body:
                body.add(k)
                todo.extend(pred.get(k, []))
        return body

    def least_of(a, b):
        return Counter({p: min(a[p], b[p]) for p in set(a) | set(b)})

    def paths(entry, sinks, allowed, loop):
        """(least, most) over the paths from entry to a sink through the
        allowed blocks (a DAG: callers remove the cycles), None if there is
        none; for a loop (loop=True) only over its full paths: the most square roots
        (MUFU.RSQ) and more divides (MUFU.RCP) than half as many, so a
        divide beyond the rates' one each, the step size's. Square roots
        and divides are counted in the loop's own blocks."""
        order, state, stack = [], {entry: 1}, [(entry, iter(succ[entry]))]
        while stack:
            k, it = stack[-1]
            for t in it:
                if t in allowed and t not in state:
                    state[t] = 1
                    stack.append((t, iter(succ[t])))
                    break
            else:
                state[k] = 2
                order.append(k)
                stack.pop()
        own = {}
        for k in state:
            c = Counter()
            for i in range(*blocks[k]):
                c[PIPE_OF.get(instrs[i][2].split(".")[0], "other")] += 1
            c["total"] = size[k]
            ops = [instrs[i][2] for i in range(*blocks[k])]
            marks = (sum(op.startswith("MUFU.RSQ") for op in ops),
                     sum(op.startswith("MUFU.RCP") for op in ops))
            lo, hi = c, c
            if callee[k] is not None:
                s_lo, s_hi = subroutine(callee[k])
                lo, hi = c + s_lo, c + s_hi
            own[k] = (lo, hi, marks)
        # best[k][(roots, divides)]: (least, most) over the paths from entry to k
        best = {entry: {own[entry][2]: own[entry][:2]}}
        for k in reversed(order):
            for t in succ[k] if k in best else ():
                if t not in state or t == entry:
                    continue
                lo_t, hi_t, (r_t, d_t) = own[t]
                at = best.setdefault(t, {})
                for (r, d), (lo, hi) in best[k].items():
                    lo, hi, m = lo + lo_t, hi + hi_t, (r + r_t, d + d_t)
                    if m in at:
                        lo0, hi0 = at[m]
                        lo, hi = least_of(lo, lo0), max(hi, hi0, key=lambda c: c["total"])
                    at[m] = (lo, hi)
        ends = [(m, lohi) for k in best if k in sinks for m, lohi in best[k].items()]
        if loop:
            roots = max((r for (r, _), _ in ends), default=0)
            ends = [(m, lohi) for m, lohi in ends if m[0] == roots and 2 * m[1] > roots]
        if not ends:
            return None
        least = ends[0][1][0]
        for _, (lo, _) in ends[1:]:
            least = least_of(least, lo)
        return least, max((hi for _, (_, hi) in ends), key=lambda c: c["total"])

    def acyclic(region, entry):
        """The region's blocks that are not slow and lie on no loop of the
        region other than the one through `entry`."""
        keep = {k for k in region if not slow[k]}
        inner = set()
        for u, h in back_edges(entry, keep):
            if h != entry:
                inner |= natural_loop(h, [u]) & keep
        return keep - inner

    def subroutine(entry):
        blocks_from = set()
        todo = [entry]
        while todo:
            k = todo.pop()
            if k not in blocks_from:
                blocks_from.add(k)
                todo.extend(succ[k])  # a RET that is predicated falls through
        allowed = acyclic(blocks_from, entry)
        return paths(entry, {k for k in allowed if ret[k]}, allowed, False)

    loops = {}
    for u, h in back_edges(0, set(range(len(blocks)))):
        loops.setdefault(h, []).append(u)
    found = []
    for header, latches in loops.items():
        allowed = acyclic(natural_loop(header, latches), header)
        if header in allowed and set(latches) & allowed:
            found.append(paths(header, set(latches) & allowed, allowed, True))
    found = [f for f in found if f is not None]
    if not found:
        raise RuntimeError("no full straight path through a loop of the kernel")
    least, most = max(found, key=lambda f: f[1]["total"])
    return {"least": least, "most": most}


def start_probe_builds(tmp):
    """nvcc, started at once, of what phase 1 builds beside the library:
    csrc/march.cu as a cubin with the march kernel's flags (for step_issue),
    the guarded-trig check (TRIG_CHECK, for trig_check) and the
    launch-trace side build (TRACE_LIB, for phase 13's trace_longest)."""
    from raytrace_tpu_torch.ops import march_kernel

    lib_only = ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
    cubin = march_kernel.nvcc_command(march_kernel.CSRC / "march.cu", Path(tmp) / "march.cubin")
    src = Path(tmp) / "trig_check.cu"
    src.write_text(TRIG_CHECK)
    check_lib = march_kernel.nvcc_command(src, Path(tmp) / "libtrig_check.so")
    march_kernel.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmds = {"march cubin": [c for c in cubin if c not in lib_only] + ["-cubin"],
            "trig check": check_lib[:1] + ["-I", str(march_kernel.CSRC)] + check_lib[1:],
            "launch trace build": march_kernel.nvcc_command(
                march_kernel.CSRC / "march.cu", march_kernel.BUILD_DIR / TRACE_LIB,
                defines=("RT_LAUNCH_TRACE",))}
    return {name: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, cmd in cmds.items()}


def step_issue(tmp):
    """issue_by_kernel of the march cubin that start_probe_builds made,
    disassembled with nvdisasm."""
    import shutil

    from raytrace_tpu_torch.ops import march_kernel

    nvdisasm = shutil.which("nvdisasm") or str(Path(march_kernel._nvcc()).parent / "nvdisasm")
    dis = subprocess.run([nvdisasm, str(Path(tmp) / "march.cubin")], check=True,
                         capture_output=True, text=True).stdout
    out = issue_by_kernel(dis)
    check(len(out) == 24, f"{len(out)} grid kernels in the SASS, 24 expected")
    return out


def issue_by_kernel(dis):
    """loop_issue of each grid kernel (march_kernel<T, METHOD, DEST>) in
    nvdisasm output, by (method, destination kind, dtype name)."""
    import re

    methods = {1: "rk4", 2: "rk45", 3: "euler"}
    out = {}
    for name, (instrs, labels) in sass_kernels(dis).items():
        m = re.search(r"12march_kernelI([fd])Li(\d)ELi(\d)E", name)
        if m:
            dtype = "float32" if m.group(1) == "f" else "float64"
            out[methods[int(m.group(2))], KINDS[int(m.group(3))], dtype] = loop_issue(instrs, labels)
    return out


def trig_check(tmp):
    """TRIG_CHECK on the card: the guarded trig against the CUDA math
    library's, bit for bit, on every float32 and TRIG_SAMPLES float64
    samples plus the pi/4 sweep; fails on any mismatch."""
    import ctypes

    lib = ctypes.CDLL(str(Path(tmp) / "libtrig_check.so"))
    lib.trig_check.argtypes = [ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_longlong,
                               ctypes.c_void_p]
    lib.trig_check.restype = ctypes.c_int
    out = (ctypes.c_ulonglong * 4)()
    t0 = time.perf_counter()
    err = lib.trig_check(TRIG_SAMPLES, TRIG_SEED, TRIG_WIDTH, out)
    check(err == 0, f"trig check failed with CUDA error {err}")
    print(f"trig check ({time.perf_counter() - t0:.2f} s): m_sincos / m_cos against sinf, cosf "
          f"on all 2^32 float32 patterns: {out[0]} / {out[1]} differ; against sin, cos on "
          f"{TRIG_SAMPLES} seeded float64 samples and the {2547 * (2 * TRIG_WIDTH + 1)} doubles "
          f"within {TRIG_WIDTH} ulps of k pi/4 (|k| <= 1273): {out[2]} / {out[3]} differ")
    check(not any(out), "the guarded trig differs from the CUDA math library's")


def issue_line(c):
    return ", ".join(f"{p} {c[p]}" for p in PIPES)


def march_bound(out, method, dest, march_dtype):
    """(bound_ms, pipe) of one march: the largest of each pipe's issue time,
    the issue time of all its instructions, and its bytes over the memory
    rate (see SASS_PIPES). The instructions are the least that one full
    iteration of the instantiation issues (STEP_ISSUE, loop_issue) times
    the counted steps of the rays that ended without being stuck (steps >
    0). A rejected RK45 trial is a full iteration that counts no step, so
    it adds to the time and not to the bound; a step that a turning point
    skips counts as one and issues less (its first rates only, a few a
    ray). The bytes are the 21 fields read once and the 17 the kernel
    writes (11 floats, 4 counters, 2 gates) written once per ray. pipe is
    the binding one: fp32, fp64, mufu, int, conv, issue or bytes."""
    from raytrace_tpu_torch.ops import march_kernel

    name = str(march_dtype).replace("torch.", "")
    kind = dest if isinstance(dest, str) else KINDS[march_kernel._dest_args(dest)[0]]
    c = STEP_ISSUE[method, kind, name]["least"]
    size = 4 if name == "float32" else 8
    steps = int(out.steps[out.steps > 0].sum())
    clocks = CARD["sms"] * CARD["clock_hz"]
    times = {p: c[p] * steps / (PIPE_LANES[p] * clocks) for p in PIPE_LANES}
    times["issue"] = c["total"] * steps / (ISSUE_LANES * clocks)
    times["bytes"] = out.n_rays * ((15 * size + 18) + (11 * size + 18)) / HBM_BYTES_PER_S
    pipe = max(times, key=times.get)
    return times[pipe] * 1e3, pipe


def parity(a, b, live, dtype, torch):
    """Count-gated agreement of two marches of one batch (tests/test_native.py:22-36)."""
    import numpy as np

    sa, sb = a.status.cpu().numpy(), b.status.cpu().numpy()
    status_rate = float((sa == sb)[live].mean())
    same = (sa == sb) & live
    ra, rb = a.r.double().cpu().numpy(), b.r.double().cpu().numpy()
    eq_steps = a.steps.cpu().numpy() == b.steps.cpu().numpy()
    steps_rate = float(eq_steps[same].mean())
    # a ray whose march went non-finite (NUMERIC) ends with r = NaN; NaN in
    # both counts as equal, NaN in one of the two as infinitely far apart
    nan_a, nan_b = np.isnan(ra), np.isnan(rb)
    d = np.abs(ra - rb)
    d[nan_a & nan_b] = 0.0
    d[nan_a ^ nan_b] = np.inf
    rel = d / np.abs(np.where(nan_b, 1.0, rb))
    med_dr = float(np.median(d[same]))
    med_rel = float(np.median(rel[same]))
    max_abs = float(d[same & eq_steps].max())
    same_bits = eq_steps & (sa == sb) & (d == 0)
    bitwise = float(same_bits[live].mean())
    nan_status = sorted({int(s) for s in sb[live & nan_b]})
    if dtype == torch.float64:
        ok = status_rate > 0.99 and steps_rate > 0.99 and med_dr < 1e-10
    else:
        ok = status_rate > 0.98 and steps_rate > 0.98 and med_rel < 1e-5
    return dict(status_rate=status_rate, steps_rate=steps_rate, median_dr=med_dr,
                median_rel_dr=med_rel, max_abs_err=max_abs, bitwise_rate=bitwise,
                not_bitwise=int((live & ~same_bits).sum()),
                nan_r=int((live & (nan_a | nan_b)).sum()), nan_status=nan_status, ok=ok)


def parity_line(tag, p):
    return (f"parity {tag}: status {p['status_rate']:.5f} steps {p['steps_rate']:.5f} "
            f"median|dr| {p['median_dr']:.3e} median|dr|/r {p['median_rel_dr']:.3e} "
            f"max|dr| (equal status and steps) {p['max_abs_err']:.3e} "
            f"bitwise (status, steps, r) {p['bitwise_rate']:.5f} ({p['not_bitwise']} rays not) "
            f"non-finite r {p['nan_r']} (plain statuses {p['nan_status']})")


def caustic_batch(kind, dtype):
    """Phase 10's batch of one surface, with the spin and the keywords of
    its march: 21 x 21 caustic bundles of the discplane golden's geometry
    (DiscWithISCO) or the plane golden's (FlatPlane), built as
    apps.caustics.compute builds them in ``dtype`` and marched with -SPIN;
    the lamppost 0.05 grid with SphericalShell and its boundary."""
    import math

    from raytrace_tpu_torch.destinations import DiscWithISCO, FlatPlane, SphericalShell
    from raytrace_tpu_torch.geometry import isco_radius
    from raytrace_tpu_torch.ops.redshift import redshift_start
    from raytrace_tpu_torch.sources import ImagePlaneGrid, PointSourceGrid, image_plane_bundles

    if kind == "shell":
        return (lamppost(PointSourceGrid.from_steps(0.05, 0.05), dtype), SPIN,
                dict(dest=SphericalShell(SHELL["r_shell"]), boundary=SHELL["boundary"],
                     r_max=1000.0))
    if kind == "isco":
        grid = ImagePlaneGrid.from_steps(-12.0, 12.0, 1.2, -12.0, 12.0, 1.2)
        incl, kw = 60.0, dict(dest=DiscWithISCO(isco_radius(SPIN), 20.0), r_max=550.0)
    else:
        grid = ImagePlaneGrid.from_steps(-10.0, 10.0, 1.0, -10.0, 10.0, 1.0)
        incl, kw = 30.0, dict(dest=FlatPlane(math.radians(30.0), 0.0, 500.0), r_max=2000.0)
    rays, _ = image_plane_bundles(500.0, incl, grid, SPIN, device="cuda", dtype=dtype)
    return redshift_start(rays, -SPIN, 0.0, reverse=True), -SPIN, kw


# the reference binary's caustic maps: (names, inclination, size, hit map)
CAUSTIC_GOLDENS = {
    "discplane": (("det_j", "sign_j", "order", "hit", "radius", "phi", "x_disc", "y_disc",
                   "redshift"), 60, 81, "hit"),
    "plane": (("det_j", "sign_j", "order", "hit", "x_s", "y_s", "rdot_flips", "equat_cross"),
              30, 81, "hit"),
    "sourceplane": (("det_j", "sign_j", "order", "escaped", "theta_s", "phi_s", "rdot_flips",
                     "equat_cross"), 30, 82, "escaped"),
}
# gates: tests/test_caustics.py:97-219 (float64), analysis/tpu_validation.py:64,151-206 (f32)
CAUSTIC_GATES = {
    "discplane": dict(hit=(">", 0.985), radius=("<", 1e-5), redshift=("<", 1e-5),
                      order=(">", 0.999), pixels=(">", 3000), det_median=("<", 0.02),
                      det_p90=("<", 0.10), sign=(">", 0.99)),
    "plane": dict(hit=(">", 0.985), x_s=("<", 1e-4), y_s=("<", 1e-4), order=(">", 0.999),
                  pixels=(">", 2000), det_median=("<", 0.01), det_p90=("<", 0.05),
                  sign=(">", 0.99)),
    "sourceplane": dict(hit=(">", 0.999), theta_s=("<", 1e-7), phi_s=("<", 1e-7),
                        order=(">", 0.999), pixels=(">", 4000), det_median=("<", 1e-4),
                        det_p90=("<", 1e-3), sign=(">", 0.999)),
    "discplane_f32": dict(hit=(">", 0.98), pixels=(">", 3000), radius=("<", 1e-3),
                          det_median=("<", 0.10), good_frac=(">", 0.80)),
}


def caustic_golden_check(tag, app, maps, gates):
    """Measure the caustic maps against the reference binary's and check
    ``gates`` (a CAUSTIC_GATES entry)."""
    import numpy as np

    from raytrace_tpu_torch.apps.caustics import SENTINEL

    names, incl, n, hit_key = CAUSTIC_GOLDENS[app]
    raw = np.fromfile(ROOT / "tests" / "golden" / f"caustic_{app}_a0.998_i{incl}_rk45.bin", "<f8")
    ref = {nm: raw[i * n * n:(i + 1) * n * n].reshape(n, n) for i, nm in enumerate(names)}
    hm, hr = maps[hit_key].astype(bool), ref[hit_key] > 0.5
    both = hm & hr
    om, dm, dr = maps["order"], maps["det_j"], ref["det_j"]
    ok = (both & np.isfinite(dm) & np.isfinite(dr) & (dm != SENTINEL) & (np.abs(dr) < 1e29)
          & (om == ref["order"]))
    rel = np.abs(dm[ok] / dr[ok] - 1)
    same_sign = np.sign(dm[ok]) == np.sign(dr[ok])
    v = dict(hit=(hm == hr).mean(), order=(om[both] == ref["order"][both]).mean(),
             pixels=int(ok.sum()), det_median=np.median(rel), det_p90=np.percentile(rel, 90),
             sign=same_sign.mean(), good_frac=((rel < 0.5) & same_sign).mean())
    for f in ("radius", "redshift"):
        if f in ref:
            v[f] = np.median(np.abs(maps[f][both] / ref[f][both] - 1))
    for f in ("x_s", "y_s", "theta_s"):
        if f in ref:
            v[f] = np.median(np.abs(maps[f][both] - ref[f][both]))
    if "phi_s" in ref:
        d = np.abs(maps["phi_s"][both] - ref["phi_s"][both])
        v["phi_s"] = np.median(np.minimum(d, 2 * np.pi - d))
    print(f"golden {tag}: " + ", ".join(f"{k} {float(x):.6g}" for k, x in v.items()))
    for k, (op, lim) in gates.items():
        check(v[k] > lim if op == ">" else v[k] < lim, f"{tag}: {k} {v[k]} not {op} {lim}")


def kernel_march(rays, spin, schedule, **kw):
    """trace_kernel under ``schedule`` ("grid" or "refill")
    through march_kernel._trace, with trace_kernel's keywords and defaults."""
    import inspect

    from raytrace_tpu_torch.ops import march_kernel

    args = {k: v.default for k, v in inspect.signature(march_kernel.trace_kernel).parameters.items()
            if v.kind is v.KEYWORD_ONLY}
    args.update(kw)
    return march_kernel._trace(rays, spin, schedule, **args)


def own_schedule(method, kw, march_dtype):
    """The schedule the launcher gives an instantiation."""
    from raytrace_tpu_torch.destinations import ThetaLimit
    from raytrace_tpu_torch.ops import march_kernel

    return march_kernel.schedule_of(method, kw.get("dest") or ThetaLimit(), march_dtype)


def same_bits(a, b, torch):
    """The names of the marched fields in which two results differ bitwise."""
    from raytrace_tpu_torch.ops import march_kernel

    views = {torch.float32: torch.int32, torch.float64: torch.int64}
    bad = []
    for f in march_kernel.F_FIELDS + march_kernel.I_FIELDS + march_kernel.B_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype in views:
            x, y = x.view(views[x.dtype]), y.view(views[y.dtype])
        if not torch.equal(x, y):
            bad.append(f)
    return bad


def hold_full_width(tag, rays, spin, method, kw, out, march_dtype, torch):
    """The kernel against the plain march on a main path's own batch
    ``rays``, whose kernel output at kernel_steplim is ``out``, in full: at
    kernel_steplim where no ray stuck, otherwise at STUCK_STEPLIM. The
    kernel runs the launcher's schedule; where that is the lane-refill
    schedule, it is also held bitwise, every field, to the grid launch.
    Returns the parity record and the plain
    march's (ms, one run; steplim)."""
    from raytrace_tpu_torch.ops import kernel_steplim, trace
    from raytrace_tpu_torch.rays import RAY_STATUS_STEPLIM

    steps = out.steps.abs()
    stuck = (out.status & RAY_STATUS_STEPLIM) != 0
    steplim = STUCK_STEPLIM if bool(stuck.any()) else kernel_steplim(method)
    print(f"main path {tag}: {int(stuck.sum())} rays stuck at kernel_steplim, "
          f"{int((~stuck & (steps > steplim)).sum())} others past steplim {steplim}, "
          f"max {int(steps.max())}")
    own = own_schedule(method, kw, march_dtype)
    kernel_kw = dict(kw, method=method, steplim=steplim, march_dtype=march_dtype)
    a = kernel_march(rays, spin, own, **kernel_kw)
    if own == "refill":
        diff = same_bits(a, kernel_march(rays, spin, "grid", **kernel_kw), torch)
        check(not diff, f"full_{tag}: refill and grid launch differ in {diff}")
    p_ms, b = cuda_ms(lambda: trace(rays, spin, method=method, steplim=steplim, **kw), torch,
                      repeats=1, warmup=False)
    p = parity(a, b, (rays.steps == 0).cpu().numpy(), march_dtype, torch)
    print(parity_line(f"full_{tag}", p) + f" | {rays.n_rays} rays, steplim {steplim}, "
          f"schedule {own}" + (", bitwise the grid launch's in all 21 fields"
                               if own == "refill" else "") + f", plain {p_ms:.1f} ms (one run)")
    check(p["ok"], f"parity gates failed for full_{tag}: {p}")
    return p, (p_ms, steplim)


def lane_stats(steps, resident_lanes):
    """From per-ray step counts in launch order: the warp lane utilisation
    of the grid launch (steps over 32 x each warp's longest), and for the
    refill schedule the steps each resident lane would take if the work
    spread evenly, against the longest ray's."""
    import numpy as np

    s = np.abs(steps).astype(np.int64)
    pad = np.zeros(-len(s) % 32, np.int64)
    warps = np.concatenate([s, pad]).reshape(-1, 32)
    return dict(grid_lane_util=float(s.sum() / (32 * warps.max(axis=1).sum())),
                even_lane_steps=float(s.sum() / resident_lanes), max_steps=int(s.max()),
                median_steps=float(np.median(s)))


def step_latency_us(rays, spin, out, schedule, kw, torch):
    """One step's latency of a lone ray: the batch's longest ray marched
    alone to N and to 2N steps (N half its step count), the difference over
    N; CUDA events around the launch alone, on fresh copies of the prepared
    buffers, best of 5 each. Returns (us a step or None where the
    difference does not come out positive, the ray's steps)."""
    from raytrace_tpu_torch.ops import march_kernel
    from raytrace_tpu_torch.ops.integrate import StepControl

    longest = int(out.steps.abs().argmax())
    n_steps = int(out.steps.abs()[longest])
    one = rays[longest:longest + 1]
    half = max(n_steps // 2, 1)
    args = dict(dest=None, r_max=1000.0, ctrl=StepControl(), boundary=None)
    args.update((k, v) for k, v in kw.items() if k in args)
    ms = []
    for lim in (half, 2 * half):
        _, _, buf, scalars = march_kernel.prepare(one, spin, method=kw["method"], steplim=lim,
                                                  march_dtype=kw["march_dtype"], **args)
        fresh = {f: b.clone() for f, b in buf.items()}

        def launch():
            for f, b in buf.items():
                b.copy_(fresh[f])
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            march_kernel._launch(buf, scalars, schedule)
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop)

        launch()
        ms.append(min(launch() for _ in range(5)))
    return ((ms[1] - ms[0]) * 1e3 / half if ms[1] > ms[0] else None), n_steps


def launch_ms(rays, spin, kw, schedule, torch, repeats=3):
    """The march kernel's launch alone on ``rays`` (``kw`` holds method,
    steplim and march_dtype, and any of dest, r_max, ctrl and boundary):
    CUDA events around ``_launch`` on prepared buffers, restored from a
    copy before each launch outside the events, best of ``repeats`` after a
    warm-up."""
    from raytrace_tpu_torch.ops import march_kernel
    from raytrace_tpu_torch.ops.integrate import StepControl

    args = dict(dest=None, r_max=1000.0, ctrl=StepControl(), boundary=None)
    args.update((k, v) for k, v in kw.items() if k in args)
    _, _, buf, scalars = march_kernel.prepare(rays, spin, method=kw["method"],
                                              steplim=kw["steplim"],
                                              march_dtype=kw["march_dtype"], **args)
    fresh = {f: b.clone() for f, b in buf.items()}
    best = float("inf")
    for i in range(repeats + 1):
        for f, b in buf.items():
            b.copy_(fresh[f])
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        march_kernel._launch(buf, scalars, schedule)
        stop.record()
        torch.cuda.synchronize()
        if i:
            best = min(best, start.elapsed_time(stop))
    return best


def time_schedules(path, variant, rays, spin, kw, method, dtype, torch, steplim=None):
    """Phase 13 on one main path's full-width batch at its CLI's steplim
    (or ``steplim``; phase 19 times its batch at trace_scan's budget):
    the kernel under the launcher's schedule, one CUDA-event launch each of
    two after a warm-up; where that is the refill schedule, it and the grid
    launch in turns (grid, refill, refill, grid), the refill result bitwise
    the grid launch's. Occupancy and registers of each kernel timed, lane
    figures from the step counts in launch order, one step's latency of the
    longest ray alone, the TRACE_ROWS longest rays marched alone
    (alone_batch; the batch's latency floor), and the bound."""
    from raytrace_tpu_torch.destinations import ThetaLimit
    from raytrace_tpu_torch.ops import kernel_steplim, march_kernel

    dname = str(dtype).replace("torch.", "")
    dest = kw.get("dest") or ThetaLimit()
    kind = KINDS[march_kernel._dest_args(dest)[0]]
    own = march_kernel.schedule_of(method, dest, dtype)
    steplim = steplim or kernel_steplim(method)
    kernel_kw = dict(kw, method=method, steplim=steplim, march_dtype=dtype)
    order = ["grid", "refill", "refill", "grid"] if own == "refill" else ["grid", "grid"]
    info = {sch: march_kernel.kernel_info(method, dest, dtype, sch) for sch in order}
    grid_out = kernel_march(rays, spin, "grid", **kernel_kw)
    if own == "refill":
        diff = same_bits(kernel_march(rays, spin, "refill", **kernel_kw), grid_out, torch)
        check(not diff, f"{path} {variant}: refill and grid launch differ in {diff}")
    times = {sch: [] for sch in info}
    for sch in order:
        ms, _ = cuda_ms(lambda: kernel_march(rays, spin, sch, **kernel_kw), torch, repeats=1,
                        warmup=False)
        times[sch].append(ms)
    best = {sch: min(t) for sch, t in times.items()}
    resident = info[own]["blocks_per_sm"] * info[own]["sms"] * 128
    lanes = lane_stats(grid_out.steps.cpu().numpy(), resident)
    lat_us, longest = step_latency_us(rays, spin, grid_out, own, kernel_kw, torch)
    t_bound, t_by = march_bound(grid_out, method, dest, dtype)
    lat_bound = None if lat_us is None else longest * lat_us / 1e3
    rows = torch.argsort(grid_out.steps.abs(), descending=True, stable=True)[:TRACE_ROWS]
    floor_ms = launch_ms(alone_batch(rays, rows, torch), spin, kernel_kw, own, torch)
    print(f"schedules {path} {variant} ({rays.n_rays} rays, {dname}, steplim {steplim}): "
          f"steps median {lanes['median_steps']:.0f} max {lanes['max_steps']}; grid launch "
          f"lane utilisation {lanes['grid_lane_util']:.4f}; steps a resident lane if spread "
          f"evenly {lanes['even_lane_steps']:.1f} against the longest ray's {lanes['max_steps']}")
    for sch, t in times.items():
        i = info[sch]
        print(f"  {sch}: {i['registers']} registers, local {i['local_bytes']} B, "
              f"{i['blocks_per_sm']} blocks an SM x {i['sms']} SMs; "
              f"ms in turns {' '.join(f'{x:.3f}' for x in t)}")
    print(f"  own schedule {own}: {best[own]:.3f} ms"
          + (f"; refill / grid {best['refill'] / best['grid']:.4f}" if own == "refill" else "")
          + "; lone-ray step latency "
          + (f"{lat_us:.4f} us x {longest} steps = {lat_bound:.4f} ms" if lat_us else
             f"not resolved over the longest ray's {longest} steps")
          + f"; the {TRACE_ROWS} longest rays alone, each in its own warp, {floor_ms:.3f} ms"
          + f"; issue bound {t_bound:.4f} ms ({t_by}; one full loop iteration at least "
          f"{issue_line(STEP_ISSUE[method, kind, dname]['least'])})")
    return dict(ms=best[own], schedule=own, grid_ms=times["grid"],
                refill_ms=times.get("refill"), bound_ms=t_bound, bound_pipe=t_by,
                issue=STEP_ISSUE[method, kind, dname], info=info[own],
                latency_bound_ms=lat_bound, step_latency_us=lat_us, steplim=steplim,
                n_rays=rays.n_rays, lone_floor_ms=floor_ms)


# Phase 13's launch trace of the float32 RK45 theta and isco kernels: the
# rays the launch-trace build follows (the longest by step count) and the
# timer samples it keeps of each; the share of the batch whose end marks
# the end of the bulk; the side build, beside the library in
# march_kernel.BUILD_DIR; the variants (float32) whose main-path batches
# phase 13 traces.
TRACE_ROWS = 64
TRACE_SAMPLES = 1024
BULK_SHARE = 0.999
TRACE_LIB = "libraytrace_march_trace.so"
TRACED = ("rk45_theta", "rk45_isco")


def open_trace_library(path=None):
    """The launch-trace side build (march.cu with RT_LAUNCH_TRACE, at
    ``path``, default TRACE_LIB in the build directory), its entry point
    declared."""
    import ctypes

    from raytrace_tpu_torch.ops import march_kernel

    lib = march_kernel.open_library(path or march_kernel.BUILD_DIR / TRACE_LIB)
    lib.rt_launch_trace_set.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
    lib.rt_launch_trace_set.restype = ctypes.c_int
    return lib


def trace_build_march(lib, rays, spin, kernel_kw, torch):
    """``rays`` marched by the grid launch of the trace build ``lib``, as
    trace_kernel marches them (prepare, one launch, finish, with
    trace_kernel's keywords and defaults), counted nowhere: phase 13's
    diagnostic launches are not the main paths'."""
    import inspect

    from raytrace_tpu_torch.ops import march_kernel

    args = {k: v.default for k, v in inspect.signature(march_kernel.trace_kernel).parameters.items()
            if v.kind is v.KEYWORD_ONLY}
    args.update(kernel_kw)
    refine = args.pop("refine_crossing")
    r, dest, buf, scalars = march_kernel.prepare(rays, spin, **args)
    device = buf["r"].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rt_march_launch(*march_kernel.pointers(buf), *scalars,
                                  march_kernel._SCHEDULE_CODE["grid"], None, None, stream)
    check(err == 0, f"the trace build's launch failed with CUDA error {err}")
    return march_kernel.finish(r, buf, dest, spin, refine)


def launch_trace(lib, rays, spin, kernel_kw, longest, torch):
    """One launch of the trace build ``lib`` on ``rays``, following the
    rays ``longest``: every ray's start and store times, and the SM,
    block, iterations and timer samples of the rays followed. Returns the
    tables (numpy, by ray for start and stop, by row for the rest), the
    sample stride and the result."""
    from raytrace_tpu_torch.ops.integrate import march_budget

    n, dev, rows = rays.n_rays, rays.r.device, len(longest)
    traced = torch.full((n,), -1, dtype=torch.int32, device=dev)
    traced[longest] = torch.arange(rows, dtype=torch.int32, device=dev)
    start, stop = (torch.zeros(n, dtype=torch.int64, device=dev) for _ in range(2))
    sm, block, iters = (torch.zeros(rows, dtype=torch.int32, device=dev) for _ in range(3))
    samples = torch.zeros(rows, TRACE_SAMPLES, dtype=torch.int64, device=dev)
    stride = -(-march_budget(kernel_kw["steplim"]) // TRACE_SAMPLES)
    torch.cuda.synchronize()
    err = lib.rt_launch_trace_set(start.data_ptr(), stop.data_ptr(), traced.data_ptr(),
                                  sm.data_ptr(), block.data_ptr(), iters.data_ptr(),
                                  samples.data_ptr(), stride, TRACE_SAMPLES)
    check(err == 0, f"rt_launch_trace_set failed with CUDA error {err}")
    out = trace_build_march(lib, rays, spin, kernel_kw, torch)
    torch.cuda.synchronize()
    tables = {k: v.cpu().numpy() for k, v in dict(start=start, stop=stop, sm=sm, block=block,
                                                    iters=iters, samples=samples).items()}
    return tables, stride, out


def trace_figures(tables, stride, steps, longest, lone_us):
    """What one traced launch shows of the rays it followed (``longest``;
    ``steps`` the batch's |steps| by ray, numpy): when they start and end,
    as shares of the launch (first start to last store); their mean
    latency a step while the bulk runs (until BULK_SHARE of the rays have
    stored) and after it, from the timer samples, against ``lone_us``
    (step_latency_us: the longest ray alone); their warp-mates still
    marching at half their steps; the SMs they ran on; and the same by row
    for the rays that end last. Returns the figures and the rows."""
    import numpy as np

    start, stop = tables["start"].astype(np.float64), tables["stop"].astype(np.float64)
    n = len(start)
    t0, t1 = start.min(), stop.max()
    span = t1 - t0
    t_bulk = np.quantile(stop, BULK_SHARE)
    s = longest
    iters = tables["iters"].astype(np.int64)
    st = steps[longest].astype(np.int64)
    rows = []
    for j in range(len(longest)):
        valid = min(TRACE_SAMPLES, -(-int(iters[j]) // stride))
        times = tables["samples"][j, :valid].astype(np.float64)
        done = int((times <= t_bulk).sum()) * stride  # iterations begun by the bulk's end
        per_step = iters[j] / max(st[j], 1)  # iterations an accepted step
        under = after = None
        if t_bulk > start[s[j]] and done > 0:
            under = (min(t_bulk, stop[s[j]]) - start[s[j]]) / done * per_step / 1e3
        if stop[s[j]] > t_bulk and iters[j] > done:
            after = (stop[s[j]] - max(t_bulk, start[s[j]])) / (iters[j] - done) * per_step / 1e3
        w = s[j] // 32 * 32
        mates = [m for m in range(w, min(w + 32, n)) if m != s[j]]
        rows.append(dict(ray=int(longest[j]), steps=int(st[j]), iters=int(iters[j]),
                         start_ms=(start[s[j]] - t0) / 1e6, stop_ms=(stop[s[j]] - t0) / 1e6,
                         step_us_under_bulk=under, step_us_after_bulk=after,
                         mates_at_half=int((steps[mates] * 2 >= st[j]).sum()),
                         sm=int(tables["sm"][j]), block=int(tables["block"][j])))
    share = (start[s] - t0) / span
    mean = (lambda k: float(np.mean([r[k] for r in rows if r[k] is not None]))
            if any(r[k] is not None for r in rows) else None)
    return dict(
        launch_ms=float(span / 1e6), bulk_end_ms=float((t_bulk - t0) / 1e6),
        start_share_median=float(np.median(share)), start_share_max=float(share.max()),
        end_share_median=float(np.median((stop[s] - t0) / span)),
        step_us_under_bulk=mean("step_us_under_bulk"), step_us_after_bulk=mean(
            "step_us_after_bulk"), step_us_alone=lone_us,
        mates_at_half_mean=float(np.mean([r["mates_at_half"] for r in rows])),
        rows_with_a_mate_at_half=sum(r["mates_at_half"] > 0 for r in rows),
        sms=len({r["sm"] for r in rows}), rows=len(rows),
        last=sorted(rows, key=lambda r: -r["stop_ms"])[:4],
    ), rows


def alone_batch(rays, longest, torch):
    """The rays ``longest`` of ``rays``, each alone in its warp: lane 0,
    the other 31 lanes dead rays (steps -1), one warp a scheduler. Marched
    with the card to themselves, the slowest of them is, under bitwise
    agreement, a floor for any order of the batch."""
    pad = rays[longest.repeat_interleave(32)]
    dead = torch.arange(32 * len(longest), device=longest.device) % 32 != 0
    return pad.replace(steps=torch.where(dead, -1, pad.steps))


def trace_longest(lib, path, variant, rays, spin, kw, method, dtype, timed, torch):
    """Phase 13 on a float32 RK45 kernel's full-width batch at its CLI's
    steplim (``timed``: its time_schedules record), with the trace build
    ``lib``: one launch following the TRACE_ROWS longest rays
    (trace_figures), bitwise the launcher's kernel, and those rays alone
    (alone_batch), each one's own time. Returns the figures."""
    import numpy as np

    from raytrace_tpu_torch.ops import kernel_steplim

    kernel_kw = dict(kw, method=method, steplim=kernel_steplim(method), march_dtype=dtype)
    natural = kernel_march(rays, spin, "grid", **kernel_kw)
    steps = natural.steps.abs().cpu().numpy().astype(np.int64)
    longest = torch.from_numpy(np.argsort(-steps, kind="stable")[:TRACE_ROWS].copy()).to(
        rays.r.device)
    tables, stride, out = launch_trace(lib, rays, spin, kernel_kw, longest, torch)
    diff = same_bits(out, natural, torch)
    check(not diff, f"{path} {variant}: the trace build differs in {diff}")
    figures, rows = trace_figures(tables, stride, steps, longest.cpu().numpy(),
                                  timed["step_latency_us"])
    head = torch.arange(len(longest), device=longest.device) * 32
    tables, _, out = launch_trace(lib, alone_batch(rays, longest, torch), spin, kernel_kw, head,
                                  torch)
    check(np.array_equal(out.steps[head].abs().cpu().numpy(), steps[longest.cpu().numpy()]),
          f"{path} {variant}: a ray marched alone took other steps than in its batch")
    alone = (tables["stop"] - tables["start"])[head.cpu().numpy()] / 1e6
    for r, ms in zip(rows, alone):
        r["alone_ms"] = float(ms)
    slowest = rows[int(np.argmax(alone))]
    print(f"launch trace {path} {variant} ({rays.n_rays} rays): the {TRACE_ROWS} longest rays "
          f"alone, each in its own warp: {timed['lone_floor_ms']:.3f} ms (best of 3); traced, "
          f"the slowest {slowest['alone_ms']:.3f} ms (ray {slowest['ray']}, {slowest['steps']} "
          f"steps, {slowest['iters']} iterations; in the batch it starts at "
          f"{slowest['start_ms']:.3f} ms and stores at {slowest['stop_ms']:.3f}), the longest "
          f"by steps (the latency term's ray) {alone[0]:.3f} ms")
    print(f"  trace: {json.dumps(figures)}")
    return dict(slowest_alone_ms=slowest["alone_ms"], slowest_start_ms=slowest["start_ms"],
                trace={x: v for x, v in figures.items() if x != "last"})


def slice_batch(kind):
    """Phase 14's batch of one source, on the card in float64 after
    redshift_start, as the slice's apps build it, and its spin: a jet
    (v_jet = 0.5, h = 5, spin 0.998) and an arbitrary 4-velocity (u_r 0.1,
    u_phi 0.02 at r = 6, theta = 0.8) through apps.lamppost._build_source on the
    0.05 grid, the disc source at r = 6 (spin 0.9) of return_radiation on
    the 0.05 grid, and a HEALPix order-4 lamppost (15,360 rays)."""
    from raytrace_tpu_torch.apps import lamppost as lamppost_app
    from raytrace_tpu_torch.apps import return_radiation
    from raytrace_tpu_torch.config import Config
    from raytrace_tpu_torch.geometry import keplerian_omega
    from raytrace_tpu_torch.ops.redshift import redshift_start
    from raytrace_tpu_torch.sources import PointSourceGrid, healpix_point_source

    grid = PointSourceGrid.from_steps(0.05, 0.05)
    if kind in ("jet", "vel"):
        extra = (["--source=0 5 1e-3 0", "--v_jet=0.5"] if kind == "jet"
                 else ["--source=0 6 0.8 0", "--u_r=0.1", "--u_phi=0.02"])
        rays, spin, _ = lamppost_app._build_source(Config([f"--spin={SPIN}"] + extra), grid)
        return redshift_start(rays, spin, 0.0), spin
    if kind == "disc":
        rays = return_radiation.disc_source_rays(6.0, 0.9, grid, device="cuda")
        return redshift_start(rays, 0.9, keplerian_omega(6.0, 0.9)), 0.9
    rays, _ = healpix_point_source((0.0, 5.0, 1e-3, 0.0), SPIN, order=4, device="cuda")
    return redshift_start(rays, SPIN, 0.0), SPIN


class Recorder:
    """Wraps a module's ``trace_auto`` (or its function ``name``) while
    in use, recording what its last call marched and how (rays, spin,
    keywords and result), the milliseconds all its calls took on the card
    (CUDA events around each call, synchronised after it, as the app
    synchronises when it reads the result back) and each call's method and
    kernel launches. A call of ``trace_in_ranges`` is recorded once its
    last range has landed: its result is then the landed pieces laid end
    to end, and its milliseconds run to that landing."""

    def __init__(self, module, name="trace_auto"):
        self.module, self.name = module, name
        self.seen = {}
        self.ms = 0.0
        self.calls = []  # (method keyword, kernel launches) a call

    def __enter__(self):
        import torch

        from raytrace_tpu_torch.ops import march_kernel

        real = self.real = getattr(self.module, self.name)

        def record(start, before, args, kw, out):
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
            torch.cuda.synchronize()
            self.ms += start.elapsed_time(stop)
            self.calls.append((kw.get("method"), march_kernel.launches - before))
            self.seen.update(rays=args[0] if args else None, spin=args[1] if len(args) > 1
                             else None, kw=dict(kw), out=out)

        def landing(landed, start, before, args, kw):
            parts = {}
            for k0, k1, out, stream in landed:
                parts[k0] = out
                yield k0, k1, out, stream
            ordered = [parts[k] for k in sorted(parts)]
            record(start, before, args, kw, ordered[0].replace(**{
                f.name: torch.cat([getattr(p, f.name) for p in ordered])
                for f in dataclasses.fields(ordered[0])}))

        def route(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            before = march_kernel.launches
            start.record()
            out = real(*args, **kw)
            if self.name == "trace_in_ranges":
                return landing(out, start, before, args, kw)
            record(start, before, args, kw, out)
            return out

        setattr(self.module, self.name, route)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


class TextTimer:
    """Times, on the host clock, the text files an app module writes while
    in use: each ``TextOutput`` from its opening to its close, the rows'
    formatting and writing included."""

    def __init__(self, module):
        self.module, self.s = module, 0.0

    def __enter__(self):
        timer = self
        self.real = getattr(self.module, "TextOutput", None)
        if self.real is not None:
            class Timed(self.real):
                def __init__(self, *args, **kw):
                    self._t0 = time.perf_counter()
                    super().__init__(*args, **kw)

                def close(self):
                    super().close()
                    timer.s += time.perf_counter() - self._t0

            self.module.TextOutput = Timed
        return self

    def __exit__(self, *exc):
        if self.real is not None:
            self.module.TextOutput = self.real


def load_trajectories(path):
    """The trajectories of a dump, one array of rows each (the reader of
    tests/test_capabilities.py:355-368)."""
    import numpy as np

    trajs, cur = [], []
    for line in open(path):
        s = line.split()
        if not s:
            if cur:
                trajs.append(np.array(cur))
                cur = []
            continue
        cur.append([float(v) for v in s])
    if cur:
        trajs.append(np.array(cur))
    return trajs


def check_slice_output(entry, outfile, n_rays):
    """Read a phase-15 CLI's output back and check it: the sky map's four
    FITS images over the direction grid with a real fate for nearly every
    live ray, finite text columns of the expected shape, a dump of one
    trajectory a ray. Returns a line for the log."""
    import numpy as np

    from raytrace_tpu_torch.io import read_fits

    if entry == "main_sky":
        fits = read_fits(str(outfile))
        fate = fits["FATE"]
        check(fate.size == n_rays, f"FATE holds {fate.size} rays, not {n_rays}")
        for ext in ("LAND_R", "REDSHIFT", "TIME"):
            check(fits[ext].shape == fate.shape, f"{ext} shape {fits[ext].shape}")
        check(np.isfinite(fits["LAND_R"]).all() and np.isfinite(fits["REDSHIFT"]).all(),
              "non-finite sky map")
        live = fate.size - int((fate == -1).sum())
        disc = fits["LAND_R"][fate == 1]
        check(live > 0.99 * n_rays and disc.size > 0.05 * n_rays and (disc > 1.0).all(),
              f"sky fates: {live} live of {n_rays}, {disc.size} on the disc")
        return (f"escape {(fate == 2).sum() / live:.4f} disc {(fate == 1).sum() / live:.4f} "
                f"capture {(fate == 0).sum() / live:.4f} of {live} rays")
    if entry == "main":
        trajs = load_trajectories(outfile)
        check(len(trajs) == n_rays and all(len(t) > 1 and np.isfinite(t).all() for t in trajs),
              f"trajectory dump: {len(trajs)} of {n_rays} rays")
        return f"{len(trajs)} trajectories, {sum(len(t) for t in trajs)} rows"
    rows = np.atleast_2d(np.loadtxt(outfile))
    cols = {"main_angdist": 6, "main_sky_discfrac": 4, "main_photonfrac_r": 5,
            "main_to_disc": 5, "main_photonfrac": 5}[entry]
    check(rows.shape[1] == cols, f"{entry}: {rows.shape[1]} columns")
    if entry == "main_sky_discfrac":
        check(abs(rows[0, :3].sum() - 1) < 0.01 and rows[0, 3] > 0.99 * n_rays,
              f"discfrac row {rows[0]}")
        return f"disc {rows[0, 0]:.4f} escape {rows[0, 1]:.4f} capture {rows[0, 2]:.4f}"
    if entry == "main_photonfrac":
        check(rows.shape[0] == 20 and (np.abs(rows[:, 1:4].sum(axis=1) - 1) < 0.01).all(),
              f"photonfrac rows {rows}")
        return (f"20 radii, return {rows[0, 1]:.4f} at r {rows[0, 0]:.3f} to {rows[-1, 1]:.4f} "
                f"at r {rows[-1, 0]:.3f}")
    counts = rows[:, 1]
    check(counts.sum() > 0 and np.isfinite(rows[counts > 0]).all(),
          f"{entry}: empty or non-finite bins")
    return f"{rows.shape[0]} bins, {counts.sum():.0f} rays binned"


def ptxas_lines(log):
    """One line per kernel of nvcc's -Xptxas -v output: schedule, method,
    destination and dtype, then registers, stack and spills."""
    import re

    methods, dests = {1: "rk4", 2: "rk45", 3: "euler"}, ("theta", "isco", "plane", "shell")
    kernels, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            kernels.setdefault(name, {}).update(stack=m.group(1), stores=m.group(2),
                                                loads=m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kernels.setdefault(name, {})["regs"] = m.group(1)
    out = []
    for name, k in sorted(kernels.items()):
        m = re.search(r"(march_kernel|march_refill_kernel)I([fd])Li(\d)ELi(\d)E", name)
        if not m:
            continue
        sched = "grid" if m.group(1) == "march_kernel" else "refill"
        out.append(f"{methods[int(m.group(3))]} x {dests[int(m.group(4))]} "
                   f"{'f32' if m.group(2) == 'f' else 'f64'} ({sched}): {k.get('regs')} registers, "
                   f"stack {k.get('stack')} B, spill stores {k.get('stores')} B, "
                   f"loads {k.get('loads')} B")
    return out


def slice_phases(launches, torch):
    """Phases 14-16: the lamppost family, moving sources, returning
    radiation, HEALPix and the trajectory dumps. Adds the kernel launches of
    phase 15's runs to ``launches`` by variant."""
    import importlib

    import numpy as np

    from raytrace_tpu_torch import ops
    from raytrace_tpu_torch.apps import emissivity, trace_rays
    from raytrace_tpu_torch.apps import lamppost as lamppost_app
    from raytrace_tpu_torch.config import Config
    from raytrace_tpu_torch.destinations import RadialVelocityField
    from raytrace_tpu_torch.ops import kernel_steplim, march_kernel, trace, trace_auto
    from raytrace_tpu_torch.sources import PointSourceGrid

    with Phase("14 slice parity"):
        for kind in SLICE_KINDS:
            rays64, spin = slice_batch(kind)
            live = (rays64.steps == 0).cpu().numpy()
            for dtype in (torch.float32, torch.float64):
                rays = rays64.to(dtype=dtype)
                for method in ("euler", "rk4", "rk45"):
                    kw = dict(method=method, steplim=SLICE_STEPLIM)
                    a = march_kernel.trace_kernel(rays, spin, march_dtype=dtype, **kw)
                    torch.cuda.synchronize()
                    p_ms, b = cuda_ms(lambda: trace(rays, spin, **kw), torch, repeats=1,
                                      warmup=False)
                    p = parity(a, b, live, dtype, torch)
                    tag = f"{kind}_{method}_{str(dtype).replace('torch.float', 'f')}"
                    print(parity_line(tag, p) + f" | {rays.n_rays} rays, plain {p_ms:.1f} ms")
                    check(p["ok"], f"parity gates failed for {tag}: {p}")
        del rays64, rays, a, b

        # a superluminal jet (tests/test_lamppost.py:163): NaN constants, no
        # real fate on either route, the kernel ending every ray at once
        cfg = Config(["--spin=0.9", "--source=0 4 1e-3 0", "--v_jet=0.6", "--dcosalpha=0.05",
                      "--dbeta=0.05", "--r_esc=50", "--steplim=2000"])
        grid = PointSourceGrid.from_steps(0.05, 0.05)
        rays, spin, _ = lamppost_app._build_source(cfg, grid)
        before = march_kernel.launches
        out, fate, live = lamppost_app._trace_fates(cfg, rays, spin, grid)
        check(march_kernel.launches == before + 1, "the superluminal batch missed the kernel")
        plain = trace(rays, spin, method="rk45", r_max=50.0, steplim=2000)
        for route, st, steps in (("kernel", out.status, out.steps), ("plain", plain.status,
                                                                     plain.steps)):
            st, steps = st.cpu().numpy()[live], steps.cpu().numpy()[live]
            check(((st & 7) == 0).all() and ((st & 64) != 0).all() and (steps <= 1).all(),
                  f"superluminal jet on the {route} route: statuses {sorted(set(st))}, "
                  f"steps up to {steps.max()}")
        check((fate[live] == -1).all(), "a superluminal ray got a real fate")
        print(f"superluminal jet (v 0.6 at r = 4, spin 0.9): {int(live.sum())} live rays, "
              f"NUMERIC without DEST/HORIZON/RLIM on the kernel and the plain route, "
              f"no real fate")

        # RadialVelocityField through trace_auto: the plain march, on the card
        rays, spin = slice_batch("jet")
        before, plain_routes = march_kernel.launches, ops.routes["plain"]
        p_ms, out = cuda_ms(lambda: trace_auto(rays, spin, method="rk45",
                                               dest=RadialVelocityField(0.3), r_max=60.0,
                                               steplim=SLICE_STEPLIM), torch, repeats=1,
                            warmup=False)
        check(march_kernel.launches == before and ops.routes["plain"] == plain_routes + 1,
              "RadialVelocityField did not take the plain route")
        check(out.r.is_cuda and out.r.dtype == torch.float64, "RadialVelocityField left the card")
        ends = out.status[rays.steps == 0]
        check(bool((((ends & 1) == 0) & ((ends & 6) != 0)).float().mean() > 0.99),
              "RadialVelocityField rays did not run to the horizon or r_max")
        print(f"RadialVelocityField(0.3) through trace_auto: plain march on {out.r.device}, "
              f"{out.r.dtype}, no kernel launch, {p_ms:.1f} ms")
        del rays, out, plain

    with Phase("15 slice full width"):
        n_par = emissivity.compute_args(Config([f"--parfile={PARFILE}"]))["grid"].n_rays
        slice_held = {}
        with tempfile.TemporaryDirectory() as tmp:
            for mod, entry, extra, tag, variant, n_expect, hold in SLICE_RUNS:
                app = importlib.import_module(f"raytrace_tpu_torch.apps.{mod}")
                suffix = ".fits" if entry == "main_sky" else ".dat"
                outfile = Path(tmp) / f"{tag.replace(' ', '_')}{suffix}"
                par = (TRACE_RAYS_PARFILE if mod == "trace_rays" else
                       None if entry == "main_photonfrac" else PARFILE)
                argv = ([f"--parfile={par}"] if par else []) + [f"--outfile={outfile}"] + extra
                march_kernel.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rec = Recorder(app) if hasattr(app, "trace_auto") else contextlib.nullcontext()
                with rec:
                    rc = getattr(app, entry)(argv)
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                n_launch = march_kernel.launches
                check(rc == 0, f"{mod}.{entry} {extra} returned {rc}")
                check(n_launch == n_expect,
                      f"{mod}.{entry} {extra}: {n_launch} kernel launches, not {n_expect}")
                if variant:
                    launches[variant] = launches.get(variant, 0) + n_launch
                n_rays = {"main_to_disc": 5 * 12 * 4**8, "main_photonfrac": 20 * 5040,
                          "main": 25}.get(entry, n_par)
                line = check_slice_output(entry, outfile, n_rays)
                march = (f"march (trace_auto) {rec.ms / 1e3:.3f} s = "
                         f"{rec.ms / 1e3 / wall:.1%} of it" if isinstance(rec, Recorder)
                         else "march in plain torch (trace_with_history)")
                print(f"full width {mod}.{entry} {' '.join(extra)} ({tag}): {n_rays} rays, wall "
                      f"{wall:.3f} s, {n_rays / wall:.4e} rays/s, {march}, {n_launch} kernel "
                      f"launch(es); {line}")
                if hold:
                    seen = rec.seen
                    kw = dict(seen["kw"])
                    method = kw.pop("method")
                    kw.pop("steplim")
                    check(seen["rays"].r.dtype == torch.float64 and method == "rk45",
                          f"{tag} marched {method} on a {seen['rays'].r.dtype} batch")
                    slice_held[hold] = (seen["rays"].to(dtype=torch.float32), seen["spin"], kw)
                    seen.clear()

        # the kernel against the plain march on three of those batches, as
        # trace_auto marched them (float32), in full
        for hold, (rays, spin, kw) in slice_held.items():
            out = march_kernel.trace_kernel(rays, spin, method="rk45",
                                            steplim=kernel_steplim("rk45"), **kw)
            hold_full_width(f"{hold}_rk45_f32", rays, spin, "rk45", kw, out, torch.float32,
                            torch)
        del slice_held, rays, out

    with Phase("16 trajectory goldens"):
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "lamppost.dat"
            t0 = time.perf_counter()
            rc = trace_rays.main([f"--outfile={out}", "--source=0 5 1E-3 0", "--V=0",
                                  "--spin=0.998", "--dcosalpha=0.4", "--dbeta=0.8",
                                  "--r_max=50", "--theta_max=1.5707963", "--write_step=20",
                                  "--integrator=euler"])
            wall = time.perf_counter() - t0
            ref, mine = load_trajectories(TRAJ_GOLDEN), load_trajectories(out)
            check(rc == 0 and len(mine) == len(ref) == 40, f"lamppost dump: {len(mine)} rays")
            matched = 0
            for m in mine:  # tests/test_capabilities.py:387-404
                d = [np.linalg.norm(m[0] - r[0]) for r in ref]
                j = int(np.argmin(d))
                n = min(len(m), len(ref[j]), 10)
                matched += d[j] <= 1e-5 and np.abs(m[:n] - ref[j][:n]).max() < 1e-4
            print(f"trajectory golden (lamppost, euler, spin 0.998): {matched} of 40 matched "
                  f"to 1e-4 (gate 34), wall {wall:.3f} s")
            check(matched >= 34, f"only {matched}/40 lamppost trajectories matched")

            out = Path(tmp) / "imageplane.dat"
            t0 = time.perf_counter()
            rc = trace_rays.main_imageplane([
                f"--outfile={out}", "--dist=100", "--incl=60", "--spin=0.9", "--x0=-6.5",
                "--xmax=5.5", "--Nx=3", "--y0=-6.5", "--ymax=5.5", "--Ny=3", "--write_step=50",
                "--n_snapshots=1024", "--integrator=euler", "--thetamax=0"])
            wall = time.perf_counter() - t0
            ref, mine = load_trajectories(TRAJ_GOLDEN_IP), load_trajectories(out)
            check(rc == 0 and len(mine) == len(ref) == 9, f"image-plane dump: {len(mine)} rays")
            worst = -np.inf
            for m, r in zip(mine, ref):  # tests/test_capabilities.py:430-440
                check(abs(len(m) - len(r)) <= 1, f"snapshot counts {len(m)} and {len(r)}")
                n = max(2, min(len(m), len(r)) // 2)
                excess = np.abs(m[:n] - r[:n]) - (2e-4 + 2e-5 * np.abs(r[:n]))
                worst = max(worst, float(excess.max()))
            print(f"trajectory golden (image plane, euler, spin 0.9): 9 trajectories, leading "
                  f"halves within rtol 2e-5 + atol 2e-4 (largest |diff| - tolerance "
                  f"{worst:.3e}), wall {wall:.3f} s")
            check(worst <= 0.0, "image-plane trajectories off the reference")


def check_outflow_output(entry, tag, outfile, out):
    """Read a phase-17 CLI's output back and check it: finite text columns
    of the expected shape, emission >= 0, the P-Cygni trough, the mapper's
    FITS cube, the emissivity cube's shape, the perf statistics ordered.
    ``out`` is what the run printed. Returns a line for the log."""
    import re

    import numpy as np

    from raytrace_tpu_torch.io import read_fits

    if entry == "main_pointsource_mapper":
        fits = read_fits(str(outfile))
        for ext in ("TIME", "REDSHIFT", "NRAYS", "VOLUME"):
            check(fits[ext].shape == (50, 25, 50) and np.isfinite(fits[ext]).all(),
                  f"{ext}: shape {fits[ext].shape}")
        check(fits["NRAYS"].sum() > 0 and (fits["VOLUME"] >= 0).all(), "empty illumination map")
        h5 = Path(f"{outfile}.h5").exists()
        return (f"{int(fits['NRAYS'].sum())} cell entries in {int((fits['NRAYS'] > 0).sum())} "
                f"cells; .h5 {'written' if h5 else 'not written (no h5py)'}")
    if entry == "main_emis_bin":
        data = np.load(f"{outfile}.npz")
        check(data["emissivity"].shape == (50, 25, 50), f"emissivity {data['emissivity'].shape}")
        check(data["count"].sum() > 0, "no cell entries")
        return f"emissivity {data['emissivity'].shape}, {int(data['count'].sum())} cell entries"
    if entry == "main" and tag == "perf test":
        stats = re.findall(r"median/p90/p99/max\s+([\d.]+) / ([\d.]+) / ([\d.]+) / (\d+)", out)
        check(len(stats) == 3, f"perf test printed {len(stats)} statistics lines")
        for st in stats:
            v = [float(x) for x in st]
            check(v[0] <= v[1] <= v[2] <= v[3], f"perf statistics out of order: {v}")
        rj = re.search(r"reject fraction p50/p90/p99/mean\s+(.*)", out)
        check(rj is not None, "perf test printed no reject line")
        return f"median/p90/p99/max {stats}; rk45 reject fraction p50/p90/p99/mean {rj.group(1)}"
    rows = np.atleast_2d(np.loadtxt(outfile))
    cols = {"outflow": 4, "outflow ent": 2, "outflow spectrum": 2, "pcyg": 4, "disc wind": 3,
            "pcyg sei": 3, "line profile": 2, "line profile image": 2}[tag]
    check(rows.shape[1] == cols and np.isfinite(rows).all(), f"{tag}: shape {rows.shape}")
    if tag == "outflow":
        check((rows[:, 2] >= 0).all() and rows[:, 2].sum() > 0, "outflow emission < 0 or none")
        return f"{len(np.unique(rows[:, 0]))} rays see the wind, {rows.shape[0]} rows"
    if tag == "outflow ent":
        resp = np.load(f"{outfile}.ent.npz")["response"]
        check((rows[:, 1] >= 0).all() and rows[:, 1].sum() > 0 and resp.shape == (200, 1),
              f"outflow ent spectrum or response {resp.shape}")
        return f"spectrum peak at E = {rows[rows[:, 1].argmax(), 0]:.4f}, response {resp.shape}"
    if tag == "pcyg":  # tests/test_capabilities.py:191-200, tests/test_cli_sweep.py:369-384
        en, c, total = rows[:, 0], rows[:, 2] / rows[:, 2].sum(), rows[:, 3]
        blue, red = c[(en > 1.05) & (en < 1.19)].mean(), c[(en > 0.85) & (en < 0.95)].mean()
        cont = np.median(total[:10])
        check(blue < red and total[len(total) // 2:].min() < 0.99 * cont
              and np.allclose(total[:5], cont, rtol=0.01) and rows[:, 1].sum() > 0,
              "no P-Cygni trough in pcyg")
        return (f"blue continuum {blue / red:.4f} of the red; total's trough "
                f"{total[len(total) // 2:].min() / cont:.4f} of the continuum")
    if tag == "pcyg sei":
        check(rows[:, 2].min() < 0.95 and rows[:, 2].max() > 1.01, "no P-Cygni trough in SEI")
        return f"flux {rows[:, 2].min():.4f} to {rows[:, 2].max():.4f}"
    check((rows[:, -1] >= 0).all() and rows[:, -1].sum() > 0, f"{tag}: negative or empty")
    return f"{rows.shape[0]} rows, peak at {rows[rows[:, -1].argmax(), 0]:.4f}"


def reject_run(name, rays, spin, torch, r_max=1000.0):
    """The RK45 rejected-trial statistics of a float32 batch on the card,
    at the smallest n_steps of 8192, 32768 and 131072 that leaves at most
    1% of its lanes unfinished."""
    from raytrace_tpu_torch.ops.diagnostics import rk45_reject_stats

    for n_steps in (8192, 32768, 131072):
        t0 = time.perf_counter()
        rj = rk45_reject_stats(rays, spin, r_max=r_max, n_steps=n_steps)
        wall = time.perf_counter() - t0
        if rj["n_unfinished"] <= 0.01 * rj["n_lanes"]:
            break
    frac = rj["rejects_total"] / max(rj["trials_total"], 1)
    print(f"rk45 rejected trials, {name} ({rays.n_rays} rays, float32, plain DOPRI5 on the "
          f"card, n_steps {n_steps}, {wall:.2f} s): p50 {rj['reject_frac_p50']} p90 "
          f"{rj['reject_frac_p90']} p99 {rj['reject_frac_p99']} mean {rj['reject_frac_mean']}; "
          f"{rj['rejects_total']} of {rj['trials_total']} trials ({frac:.4%}), "
          f"{rj['n_unfinished']} of {rj['n_lanes']} lanes unfinished")
    check(rj["n_unfinished"] <= 0.01 * rj["n_lanes"], f"{name}: too many unfinished lanes")
    return dict(rj, n_steps=n_steps, share=frac)


def outflow_phases(launches, image_fits, torch):
    """Phases 17, 17b and 18: the outflow and wind family, the perf harness,
    the line profile and its spin secant golden. Adds phase 17's kernel launches to ``launches`` by
    variant; returns the reject statistics of the emissivity batch."""
    import importlib
    import io
    import math

    import numpy as np

    from raytrace_tpu_torch.apps import emissivity, imageplane_disc_image
    from raytrace_tpu_torch.apps import pcyg as pcyg_app
    from raytrace_tpu_torch.config import Config
    from raytrace_tpu_torch.ops import integrate, mapper, march_kernel, source_tracer
    from raytrace_tpu_torch.ops.integrate import StepControl
    from raytrace_tpu_torch.ops.redshift import redshift_start
    from raytrace_tpu_torch.rays import blank_batch
    from raytrace_tpu_torch.sources import (ImagePlaneGrid, PointSourceGrid, image_plane,
                                            point_source)

    with Phase("17 outflow family full width"):
        with tempfile.TemporaryDirectory() as tmp:
            lines = Path(tmp) / "lines.dat"
            lines.write_text("0.9 0.5\n1.0 1.0\n1.1 0.25\n")
            for mod, entry, extra, tag, march in OUTFLOW_RUNS:
                app = importlib.import_module(f"raytrace_tpu_torch.apps.{mod}")
                outfile = Path(tmp) / (tag.replace(" ", "_") + (
                    ".fits" if entry == "main_pointsource_mapper" else ".dat"))
                argv = [f"--outfile={outfile}"] + [a.format(lines=lines, image=image_fits)
                                                   for a in extra]
                # the disc-image compute marches through the sharded layer
                target = (importlib.import_module("raytrace_tpu_torch.parallel.sharding")
                          if tag == "line profile" else app)
                rec = Recorder(target, march) if march else contextlib.nullcontext()
                march_kernel.launches = 0
                integrate.iterations = 0
                torch.cuda.synchronize()
                buf = io.StringIO()
                t0 = time.perf_counter()
                with rec, TextTimer(app) as text, contextlib.redirect_stdout(buf):
                    rc = getattr(app, entry)(argv)
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                n_launch, iters = march_kernel.launches, integrate.iterations
                check(rc == 0, f"{mod}.{entry} returned {rc}")
                by_variant = {}
                for method, n in (rec.calls if march else ()):
                    if n:
                        by_variant[f"{method}_theta"] = by_variant.get(f"{method}_theta", 0) + n
                check(sum(by_variant.values()) == n_launch, f"{tag}: launches outside the march")
                if tag == "perf test":
                    check(by_variant == {"euler_theta": 4, "rk4_theta": 4, "rk45_theta": 4},
                          f"perf test launches {by_variant}")
                elif tag == "line profile":
                    check(by_variant == {"rk45_theta": 1}, f"line profile launches {by_variant}")
                else:
                    check(n_launch == 0, f"{tag} launched the march kernel {n_launch} times")
                for variant, n in by_variant.items():
                    launches[variant] = launches.get(variant, 0) + n
                line = check_outflow_output(entry, tag, outfile, buf.getvalue())
                share = (f"march ({march}) {rec.ms / 1e3:.4f} s = {rec.ms / 1e3 / wall:.1%}"
                         if march else "no march (numpy over the FITS maps)")
                # the lock-step iterations counted by the march loop itself
                per_iter = ""
                if march in ("run_source_trace", "map_rays", "compute"):
                    check(iters > 0, f"{tag}: no lock-step iteration counted")
                    per_iter = f", {iters} lock-step iterations, {rec.ms / iters:.4f} ms each"
                elif iters:
                    per_iter = f", {iters} plain lock-step iterations"
                writer = (f", text writer {text.s:.4f} s = {text.s / wall:.1%}"
                          if text.real is not None else "")
                print(f"full width {mod}.{entry} ({tag}): wall {wall:.3f} s, {share}{per_iter}"
                      f"{writer}, {n_launch} kernel launch(es) {by_variant}; {line}")

    with Phase("17b line-profile spin secant golden"):
        # the folded line profile of the dense disc image at spins 0.88 and 0.92
        # against the reference binary's pair, with the gates of
        # tests/test_diff.py:335-418, each spin through the kernel by the app's
        # route (trace_auto) in float64, as the CPU tests hold it: the app's
        # float32 march (printed beside) misses these gates, its step sequence
        # set by float32 noise at rk45_tol 1e-8
        grid = ImagePlaneGrid.from_steps(-10.875, 11.125, 0.25, -10.875, 11.125, 0.25)
        figures = {}
        for dtype in (torch.float64, torch.float32):
            prof, walls = {}, []
            for a in (0.88, 0.92):
                before = march_kernel.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = imageplane_disc_image.compute(a, 100.0, 55.0, grid, 15.0, method="rk45",
                                                    steplim=100000, device="cuda",
                                                    march_dtype=dtype)
                walls.append(time.perf_counter() - t0)
                check(march_kernel.launches == before + 1,
                      f"line profile at spin {a}: {march_kernel.launches - before} launches")
                prof[a] = line_profile({k: np.nan_to_num(v) for k, v in out.items()},
                                       out["counts"])
            gate, lev, rel = figures[dtype] = secant_figures(prof)
            print(f"golden line-profile secant (89 x 89, rk45 x theta "
                  f"{str(dtype).replace('torch.float', 'f')} kernel): walls {walls[0]:.3f} + "
                  f"{walls[1]:.3f} s, {int(gate.sum())} gated bins (>= 15), level median "
                  f"{np.median(lev):.3e} (1e-3), secant median {np.median(rel):.3e} (0.01), "
                  f"max {rel.max():.3e} (0.10)" + ("" if dtype == torch.float64 else
                                                   "; float32, not gated"))
        gate, lev, rel = figures[torch.float64]
        check(gate.sum() >= 15, f"line-profile secant: only {int(gate.sum())} gated bins")
        check(np.median(lev) < 1e-3, f"line-profile level off: {lev}")
        check(np.median(rel) < 0.01 and rel.max() < 0.10, f"line-profile secant off: {rel}")

    with Phase("18 outflow family checks"):
        # pcyg against the reference binary (tests/test_capabilities.py:210-245)
        ref = np.loadtxt(PCYG_GOLDEN)
        t0 = time.perf_counter()
        en, emis, cont, _ = (o.cpu().numpy() for o in pcyg_app.compute(nx=200, n_en=400,
                                                                       device="cuda"))
        wall = time.perf_counter() - t0
        nz = ref[:, 1] > 0
        rel = np.abs(emis[nz] / ref[nz, 1] - 1)
        relc = np.abs(cont / ref[:, 2] - 1)
        print(f"pcyg golden (Nx 200, Nen 400) on the card in {wall:.3f} s: emission median "
              f"{np.median(rel):.3e} (gate 1e-6), p99 {np.percentile(rel, 99):.3e} (5e-3), max "
              f"{rel.max():.3e} (0.05); continuum max {relc.max():.3e} (2e-3)")
        check(np.allclose(en, ref[:, 0], rtol=1e-8) and ((emis > 0) == nz).all()
              and np.median(rel) < 1e-6 and np.percentile(rel, 99) < 5e-3 and rel.max() < 0.05
              and relc.max() < 2e-3, "pcyg off the reference golden")

        # the marches on the card against the CPU, on phase 17's geometries cut
        # to a few hundred rays (float64 both; the card's libm and atomic sums)
        mcfg = Config([f"--parfile={MAPPER_PARFILE}"])
        spin = mcfg.get("spin", float)
        grid = PointSourceGrid.from_steps(0.2, 0.2, -0.995, 0.995, -3.0, 3.3)  # off beta = -pi
        mgrid = mapper.MapperGrid(1.5, 100.0, 50, 25, 50)
        res = {}
        for dev in ("cpu", "cuda"):
            rays = point_source((0.0, 5.0, 1e-3, 0.0), 0.0, spin, grid, device=dev)
            res[dev] = mapper.map_rays(redshift_start(rays, spin, 0.0), spin, mgrid,
                                       r_lim=100.0, theta_lim=math.pi / 2, steplim=100_000)
        # every ray's status and steps and every cell's count equal; the
        # cells' time and redshift sums to rtol 1e-9 (the atomic additions
        # and the card's libm move them by ~1e-15)
        (cf, cm), (gf, gm) = res["cpu"], res["cuda"]
        st_ne = int((gf.status.cpu() != cf.status).sum())
        sp_ne = int((gf.steps.cpu() != cf.steps).sum())
        cn, gn = cm["count"].numpy(), gm["count"].cpu().numpy()
        worst = {k: float(np.max(np.abs(gm[k].cpu().numpy() - cm[k].numpy())
                                 / np.maximum(np.abs(cm[k].numpy()), 1e-300), initial=0.0))
                 for k in ("time", "redshift")}
        print(f"map_rays card vs CPU ({grid.n_rays} rays, 50 x 25 x 50 cells, euler): "
              f"{st_ne} statuses and {sp_ne} step counts differ (gate 0), {int((cn != gn).sum())} "
              f"cell counts of {int((cn > 0).sum())} populated differ (gate 0), count total "
              f"{gn.sum():.0f}; largest relative difference of time {worst['time']:.3e}, "
              f"redshift {worst['redshift']:.3e} (gate 1e-9)")
        check(st_ne == 0 and sp_ne == 0 and (cn == gn).all() and cn.sum() > 0
              and max(worst.values()) <= 1e-9, "map_rays on the card off the CPU")

        ocfg = Config([f"--parfile={OUTFLOW_PARFILE}"])
        spin, dist = ocfg.get("spin", float), ocfg.get("dist", float)
        x0, xmax, nx = ocfg.get("x0", float), ocfg.get("xmax", float), 16
        plane = ImagePlaneGrid(nx, nx, x0, x0, (xmax - x0) / (nx - 1), (xmax - x0) / (nx - 1))
        wind = source_tracer.WindModel(v0=ocfg.get("source_vel", float))
        bins = source_tracer.EnergyTimeBins(en0=ocfg.get("en0", float),
                                            en_max=ocfg.get("enmax", float),
                                            n_en=ocfg.get("Nen", int), dt=1e4)
        res = {}
        for dev in ("cpu", "cuda"):
            rays = image_plane(dist, ocfg.get("incl", float), plane, spin, device=dev)
            rays = redshift_start(rays, -spin, V=0.0, reverse=True)
            res[dev] = source_tracer.run_source_trace(
                rays, -spin, wind, bins, stop=source_tracer.SphericalStop(
                    ocfg.get("source_radius", float)), r_lim=1.5 * dist, steplim=100_000)
        # every ray's status and steps equal; every emis, absorb and
        # response bin to rtol 1e-9 (the response's atomic additions and the
        # card's libm move them by ~1e-15), zero where the CPU's is zero
        c, g = res["cpu"], res["cuda"]
        st_ne = int((g[0].status.cpu() != c[0].status).sum())
        sp_ne = int((g[0].steps.cpu() != c[0].steps).sum())
        rel = [float(torch.max(torch.abs(x.cpu() - y) / torch.abs(y).clamp_min(1e-300)))
               for x, y in zip(g[1:4], c[1:4])]
        print(f"run_source_trace card vs CPU ({plane.n_rays} rays, {bins.n_en} bins, euler): "
              f"{st_ne} statuses and {sp_ne} step counts differ (gate 0); largest relative "
              f"difference of emis {rel[0]:.3e}, absorb {rel[1]:.3e}, response {rel[2]:.3e} "
              f"over every bin (gate 1e-9); {int((c[1].sum(dim=1) > 0).sum())} rays see the wind")
        check(st_ne == 0 and sp_ne == 0 and max(rel) <= 1e-9 and float(c[3].sum()) > 0,
              "run_source_trace on the card off the CPU")

        # tests/test_weakfield.py:48-77: radial photons enter the radial
        # cells at the Schwarzschild flight time
        r0, r_max = 1000.0, 1500.0
        wgrid = mapper.MapperGrid(r0=r0, r_max=r_max, n_r=10, n_theta=4, n_phi=4, logbin_r=False)
        full = lambda v: torch.full((4,), v, dtype=torch.float64, device="cuda")
        rays = blank_batch(4, device="cuda").replace(
            r=full(r0 + 1e-6), theta=full(math.pi / 2), phi=full(0.0), t=full(0.0), k=full(1.0),
            h=full(0.0), Q=full(0.0), rdot_sign=full(1.0), thetadot_sign=full(1.0),
            steps=torch.zeros(4, dtype=torch.int32, device="cuda"), emit=full(1.0))
        t0 = time.perf_counter()
        _, maps = mapper.map_rays(rays, 0.0, wgrid, method="rk4", r_lim=r_max * 1.05,
                                  steplim=200_000, ctrl=StepControl(precision=1000.0))
        t_map = mapper.average_maps(maps)["time"]
        count = maps["count"].cpu().numpy()
        r_entry = r0 + np.arange(wgrid.n_r) * (r_max - r0) / wgrid.n_r
        t_exact = r_entry - r0 + 2.0 * np.log((r_entry - 2.0) / (r0 - 2.0))
        t_mean = np.array([t_map[i][count[i] > 0].mean() for i in range(wgrid.n_r)])
        err = np.abs(t_mean[1:] - t_exact[1:])
        print(f"weak field, mapper radial flight on the card: largest |t - t_exact| "
              f"{err.max():.4f} (gate 2.5), {time.perf_counter() - t0:.2f} s")
        check((count.sum(axis=(1, 2)) > 0)[1:].all() and (err < 2.5).all()
              and np.allclose(t_mean[1:], r_entry[1:] - r0, atol=2.5), "radial flight off")

        # tests/test_weakfield.py:128-183: the source tracer's absorption
        # columns through a shell at r ~ 1e5 M against straight lines
        scale = 1e5
        fwind = source_tracer.WindModel(v0=0.2, r_in=0.5 * scale, r_out=scale, theta_min=0.0,
                                        theta_max=math.pi, motion=1)
        fbins = source_tracer.EnergyTimeBins(en0=0.75, en_max=1.30, n_en=25, logbin_en=False,
                                             t0=0.0, dt=1e8, n_t=1)
        impacts = [0.55 * scale, 0.7 * scale, 0.85 * scale]
        fgrid = ImagePlaneGrid(nx=3, ny=1, x0=impacts[0], y0=0.0, dx=0.15 * scale, dy=1.0)
        t0 = time.perf_counter()
        _, _, absorb, _ = source_tracer.run_source_trace(
            image_plane(20 * scale, 90.0, fgrid, 0.0, device="cuda"), 0.0, fwind, fbins,
            method="rk4", r_lim=21 * scale, steplim=400_000,
            ctrl=StepControl(precision=2000.0, max_phistep=0.005))
        absorb = absorb.cpu().numpy()
        worst = []
        for i, b in enumerate(impacts):
            z = np.arange(-1.2 * scale, 1.2 * scale, 5.0)
            r = torch.tensor(np.sqrt(b * b + z * z))
            v, rho = fwind.velocity(r).numpy(), fwind.density(r).numpy()
            e_loc = np.sqrt(1.0 - v * v) / (1.0 - v * z / r.numpy())
            ien = fbins.energy_index(torch.tensor(e_loc)).numpy()
            ok = ((r.numpy() > fwind.r_in) & (r.numpy() < fwind.r_out) & (ien >= 0)
                  & (ien < fbins.n_en))
            col = np.zeros(fbins.n_en)
            np.add.at(col, ien[ok], 5.0 * rho[ok])
            core = col > 0.2 * col.max()
            relb = np.abs(absorb[i][core] / col[core] - 1.0)
            worst.append((abs(absorb[i].sum() / col.sum() - 1), np.median(relb), relb.max()))
            check(core.sum() >= 5 and worst[-1][0] < 0.02 and worst[-1][1] < 0.1
                  and worst[-1][2] < 0.35, f"flat-limit columns off at b = {b}: {worst[-1]}")
        print(f"weak field, source tracer flat limit on the card ({time.perf_counter() - t0:.2f} "
              f"s): total, core median, core max relative error by impact parameter "
              f"{[tuple(round(float(x), 4) for x in w) for w in worst]} (gates 0.02, 0.1, 0.35)")

        # the RK45 rejected-trial share on the perf harness's grid and on the
        # emissivity batch, both float32 as the kernel marches them
        pcfg = Config([f"--parfile={PERF_PARFILE}"])
        rays = point_source(tuple(pcfg.get_array("source", float, 4)), 0.0,
                            pcfg.get("spin", float), PointSourceGrid.from_steps(
                                pcfg.get("dcosalpha", float), pcfg.get("dbeta", float)),
                            device="cuda").to(dtype=torch.float32)
        reject_run("perf_test.par grid", rays, pcfg.get("spin", float), torch,
                   r_max=pcfg.get("r_max", float))
        par = emissivity.compute_args(Config([f"--parfile={PARFILE}"]))
        rays = lamppost(par["grid"], torch.float32, spin=par["spin"], source=par["source"],
                        V=par["V"])
        return reject_run("emissivity batch", rays, par["spin"], torch)


def forward_derivative(fn, params, i, torch):
    """fn(*params) and its forward-mode derivative in params[i]
    (torch.autograd.forward_ad), each returned as a plain tensor."""
    from torch.autograd import forward_ad as fwad

    with fwad.dual_level():
        args = [fwad.make_dual(p, torch.ones_like(p)) if j == i else p
                for j, p in enumerate(params)]
        value, tangent = fwad.unpack_dual(fn(*args))
        return value.clone(), tangent.clone()


def gradient_phases(launches, torch):
    """Phase 19: the differentiable pipeline (ops/diff.py) on the card.
    Adds 19a's kernel launch to ``launches``; returns its record's parity
    and timing for the kernels line, and the phase's numbers."""
    import math

    import numpy as np

    from raytrace_tpu_torch.ops import march_kernel
    from raytrace_tpu_torch.ops.diff import (emissivity_binned_profile,
                                             emissivity_gradient_pipeline,
                                             line_profile_observable, trace_scan)
    from raytrace_tpu_torch.rays import RAY_STATUS_TERMINAL
    from raytrace_tpu_torch.sources import ImagePlaneGrid, PointSourceGrid

    f64 = torch.float64
    nums = {"card": smi_line()}

    def walled(fn):
        """fn() with its wall (s) and peak device memory (GiB)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30

    bench_grid = PointSourceGrid.from_steps(0.01, 0.01)
    with Phase("19a gradients: trace_scan against the kernel"):
        n_steps = GRAD_STEPS
        rays = lamppost(bench_grid, f64)
        kw = dict(r_max=500.0)
        scan, scan_s, _ = walled(lambda: trace_scan(rays, SPIN, method="rk4", n_steps=n_steps,
                                                    **kw))
        march_kernel.launches = 0
        out = march_kernel.trace_kernel(rays, SPIN, method="rk4", steplim=n_steps + 1,
                                        march_dtype=f64, **kw)
        torch.cuda.synchronize()
        launches["rk4_theta_f64"] = march_kernel.launches
        check(march_kernel.launches == 1, "19a: the kernel was not launched once")
        live = rays.steps == 0
        ended = live & ((scan.status & RAY_STATUS_TERMINAL) != 0)
        unfinished = live & ~ended
        check(bool((out.steps[unfinished].abs() == n_steps + 1).all()),
              "19a: a ray trace_scan left unfinished ended early on the kernel")
        same = (out.status == scan.status) & (out.steps == scan.steps)
        check(bool(same[ended].all()), f"19a: {int((~same & ended).sum())} of "
              f"{int(ended.sum())} ended rays differ in status or steps")
        gaps = {}
        for f in ("r", "phi", "theta", "t"):
            a, b = getattr(out, f)[ended], getattr(scan, f)[ended]
            both_nan = a.isnan() & b.isnan()
            rel = torch.where(both_nan, 0.0, (a - b).abs() / b.abs().clamp_min(1e-300))
            gaps[f] = dict(bitwise=float(((a == b) | both_nan).double().mean()),
                           max_rel=float(rel.max()))
        print(f"19a: bench lamppost {rays.n_rays} rays, rk4 float64, {int(ended.sum())} ended "
              f"within n_steps {n_steps} (status and steps equal on all), "
              f"{int(unfinished.sum())} unfinished; trace_scan against the kernel at steplim "
              f"{n_steps + 1}: {gaps}; trace_scan wall {scan_s:.3f} s")
        check(all(g["max_rel"] <= 1e-12 for g in gaps.values()),
              f"19a: r, phi, theta or t beyond rtol 1e-12: {gaps}")
        p = parity(out, scan, ended.cpu().numpy(), f64, torch)
        check(p["ok"], f"19a parity: {p}")
        timed = time_schedules("gradients", "rk4_theta_f64", rays, SPIN, kw, "rk4", f64, torch,
                               steplim=n_steps + 1)
        # the row's ms: the launch alone, as short a march as this one is
        # otherwise swamped by prepare's casts and allocations in the events
        with_prepare = timed["ms"]
        timed["ms"] = launch_ms(rays, SPIN, dict(kw, method="rk4", steplim=n_steps + 1,
                                                 march_dtype=f64), "grid", torch)
        print(f"19a: the rk4 x theta f64 launch alone {timed['ms']:.3f} ms (best of 3 after a "
              f"warm-up; with prepare and finish {with_prepare:.3f} ms), bound "
              f"{timed['bound_ms']:.4f} ms: {timed['ms'] / timed['bound_ms']:.3f}x")
        nums["19a"] = dict(rays=rays.n_rays, ended=int(ended.sum()), gaps=gaps,
                           trace_scan_s=scan_s, kernel_ms=timed["ms"])
        held = (p, (scan_s * 1e3, n_steps + 1))
        del scan, out, rays

    with Phase("19b gradients: emissivity pipeline at full width"):
        f = lambda s, h, g: emissivity_gradient_pipeline(s, h, g, bench_grid, n_steps=GRAD_STEPS)
        params = [torch.tensor(x, dtype=f64, device="cuda") for x in (SPIN, 5.0, 2.0)]
        with torch.no_grad():
            value, value_s, value_gib = walled(lambda: f(*params))
        leaves = [q.clone().requires_grad_(True) for q in params]

        def reverse():
            v = f(*leaves)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grads = torch.autograd.grad(v, leaves)
            torch.cuda.synchronize()
            return v.detach(), torch.stack(grads), time.perf_counter() - t0

        (v_rev, g_rev, back_s), rev_s, rev_gib = walled(reverse)
        fwd = []
        fwd_s = []
        for i in range(3):
            (v_fwd, t), s, fwd_gib = walled(lambda: forward_derivative(f, params, i, torch))
            fwd.append(float(t))
            fwd_s.append(s)
            check(bool(v_fwd == value), f"19b: forward-mode value {float(v_fwd)} is not "
                  f"the value alone {float(value)}")
        g_rev = g_rev.tolist()
        rel = [abs(a - b) / abs(b) if b else abs(a) for a, b in zip(fwd, g_rev)]
        nums["19b"] = dict(
            rays=bench_grid.n_rays, n_steps=GRAD_STEPS, value=float(value),
            grad_reverse=g_rev, grad_forward=fwd, rel_forward_reverse=rel,
            value_s=value_s, value_and_grad_s=rev_s, forward_mode_s=fwd_s,
            ms_per_forward_step=(rev_s - back_s) / GRAD_STEPS * 1e3,
            ms_per_backward_step=back_s / GRAD_STEPS * 1e3,
            ms_per_step_value=value_s / GRAD_STEPS * 1e3,
            peak_gib=dict(value=value_gib, reverse=rev_gib, forward=fwd_gib),
            checkpoint_every=64)
        print(f"19b: E(spin, h, gamma) = {float(value)!r} on {bench_grid.n_rays} rays, n_steps "
              f"{GRAD_STEPS}; reverse {g_rev}, forward {fwd}, |fwd/rev - 1| {rel}; value alone "
              f"{value_s:.3f} s, value + gradient {rev_s:.3f} s (backward {back_s:.3f} s), "
              f"forward mode {[round(x, 3) for x in fwd_s]} s; peak {value_gib:.2f} / "
              f"{rev_gib:.2f} / {fwd_gib:.2f} GiB")
        check(float(value) > 0 and float(v_rev) == float(value),
              f"19b: the recorded value {float(v_rev)} is not the value alone {float(value)}")
        check(all(math.isfinite(x) for x in g_rev + fwd), "19b: a gradient is not finite")
        check(max(rel) <= 1e-10, f"19b: forward and reverse mode differ by {rel}")

    with Phase("19c gradients: reference-binary gates"):
        cols = ["r", "area", "rays", "flux", "emis", "g", "t"]
        ref = {tag: dict(zip(cols, np.loadtxt(ROOT / "tests" / "golden" /
                                              f"emissivity_{tag}_g0.05.dat").T))
               for tag in ("a0.89_h5_rmin2.5", "a0.91_h5_rmin2.5", "a0.998_h4.5",
                           "a0.998_h5.5")}
        grid = PointSourceGrid.from_steps(0.05, 0.05, -0.995, 0.995, -math.pi, math.pi)
        n_steps = BINNED_STEPS
        # d(emis)/d(spin) at 0.9 against the reference binary's central
        # difference (tests/test_diff.py:134-173)
        A, B = ref["a0.89_h5_rmin2.5"], ref["a0.91_h5_rmin2.5"]
        fd = (B["emis"] - A["emis"]) / 0.02
        with np.errstate(divide="ignore", invalid="ignore"):
            signal = np.abs(B["emis"] / np.where(A["emis"] == 0, 1, A["emis"]) - 1)
        gate = (A["rays"] >= 100) & (A["rays"] == B["rays"]) & (signal > 0.004)
        check(gate.sum() >= 3, "19c: fewer than 3 gated bins")
        spin = torch.tensor(0.9, dtype=f64, device="cuda")
        counts = {}
        (emis_mid, d_emis), spin_s, spin_gib = walled(lambda: forward_derivative(
            lambda a: torch.stack(emissivity_binned_profile(a, 5.0, 2.0, grid, r_min=2.5,
                                                            n_steps=n_steps)), [spin], 0, torch))
        counts_mid = emis_mid[1].cpu().numpy()
        d_emis = d_emis[0].cpu().numpy()
        check((np.abs(counts_mid[gate] - A["rays"][gate]) <= 0.10 * A["rays"][gate]).all(),
              "19c: the midpoint run's gated bins are not populated like the reference's")
        rel_spin = np.abs(d_emis[gate] / fd[gate] - 1.0)
        # the height secant at spin 0.998 (tests/test_diff.py:176-214)
        A, B = ref["a0.998_h4.5"], ref["a0.998_h5.5"]
        secant_s = time.perf_counter()
        for h in (4.5, 5.5):
            e, c = emissivity_binned_profile(SPIN, h, 2.0, grid, n_steps=n_steps)
            counts[h] = (e.cpu().numpy(), c.cpu().numpy())
        secant_s = time.perf_counter() - secant_s
        (e45, c45), (e55, c55) = counts[4.5], counts[5.5]
        hgate = ((A["rays"] >= 100) & (B["rays"] >= 100)
                 & (np.abs(A["rays"] - B["rays"]) < 0.10 * A["rays"])
                 & (np.abs(c45 - A["rays"]) < 0.10 * A["rays"])
                 & (np.abs(c55 - B["rays"]) < 0.10 * B["rays"]))
        check(hgate.sum() >= 5, "19c: fewer than 5 height-gated bins")
        rel_h = np.abs((e55 - e45)[hgate] / (B["emis"] - A["emis"])[hgate] - 1.0)
        nums["19c"] = dict(rays=grid.n_rays, n_steps=n_steps, spin_gated_bins=int(gate.sum()),
                           spin_rel=rel_spin.tolist(), spin_forward_s=spin_s,
                           spin_peak_gib=spin_gib, height_gated_bins=int(hgate.sum()),
                           height_median=float(np.median(rel_h)), height_max=float(rel_h.max()),
                           height_values_s=secant_s)
        print(f"19c: d(emis)/d(spin) by forward mode against the reference FD on "
              f"{int(gate.sum())} gated bins: {rel_spin} (gate < 0.10), {spin_s:.3f} s; height "
              f"secant on {int(hgate.sum())} bins: median {np.median(rel_h):.4f} (< 0.15), max "
              f"{rel_h.max():.4f} (< 0.25), {secant_s:.3f} s for both values")
        check(rel_spin.max() < 0.10, f"19c: d(emis)/d(spin) off the reference FD: {rel_spin}")
        check(np.median(rel_h) < 0.15 and rel_h.max() < 0.25, f"19c: height secant {rel_h}")

    with Phase("19d gradients: line profile"):
        grid = ImagePlaneGrid.from_steps(-10.875, 11.125, 0.25, -10.875, 11.125, 0.25)
        f = lambda a, i: line_profile_observable(a, i, grid, dist=100.0, r_disc=15.0,
                                                 n_steps=2048).sum()
        params = [torch.tensor(x, dtype=f64, device="cuda") for x in (0.9, 55.0)]
        leaves = [q.clone().requires_grad_(True) for q in params]
        (v_rev, g_rev), rev_s, rev_gib = walled(
            lambda: (lambda v: (v.detach(), torch.stack(torch.autograd.grad(v, leaves))))(
                f(*leaves)))
        g_rev = g_rev.tolist()
        fwd, fwd_s = [], []
        for i in range(2):
            (v_fwd, t), s, fwd_gib = walled(lambda: forward_derivative(f, params, i, torch))
            fwd.append(float(t))
            fwd_s.append(s)
        rel = [abs(a - b) / abs(b) if b else abs(a) for a, b in zip(fwd, g_rev)]
        nums["19d"] = dict(rays=grid.n_rays, n_steps=2048, value=float(v_rev),
                           grad_reverse=g_rev, grad_forward=fwd, rel_forward_reverse=rel,
                           value_and_grad_s=rev_s, forward_mode_s=fwd_s,
                           peak_gib=dict(reverse=rev_gib, forward=fwd_gib))
        print(f"19d: line profile sum {float(v_rev)!r} on {grid.n_rays} rays; d/d(spin, incl) "
              f"reverse {g_rev}, forward {fwd}, |fwd/rev - 1| {rel}; value + gradient "
              f"{rev_s:.3f} s, forward mode {[round(x, 3) for x in fwd_s]} s; peak "
              f"{rev_gib:.2f} / {fwd_gib:.2f} GiB")
        check(float(v_rev) > 0 and float(v_fwd) == float(v_rev),
              f"19d: values {float(v_rev)} (reverse), {float(v_fwd)} (forward)")
        check(all(math.isfinite(x) for x in g_rev + fwd), "19d: a gradient is not finite")
        check(max(rel) <= 1e-10, f"19d: forward and reverse mode differ by {rel}")
    return held, timed, nums


def device_idle(trace_path):
    """From a torch.profiler Chrome trace: the span of the recorded section
    (first event's start to last event's end, host and card), the card's
    busy time in it (the union of its kernels, copies and sets) and the
    idle share, and the march kernel's events and time."""
    events = [e for e in json.loads(Path(trace_path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    gpu = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, reach = 0.0, start
    for a, b in gpu:
        a = max(a, reach)
        if b > a:
            busy += b - a
            reach = b
    march = [e for e in events if e.get("cat") == "kernel" and "march_kernel" in e["name"]]
    return dict(span_ms=(end - start) / 1e3, busy_ms=busy / 1e3,
                idle_share=1.0 - busy / (end - start), device_events=len(gpu),
                march_kernels=len(march), march_ms=sum(float(e["dur"]) for e in march) / 1e3,
                march_name=march[0]["name"] if march else None)


def counted(fn, tallies, variant):
    """fn(), its kernel launches added to ``tallies[variant]``."""
    from raytrace_tpu_torch.ops import march_kernel

    before = march_kernel.launches
    out = fn()
    tallies[variant] = tallies.get(variant, 0) + march_kernel.launches - before
    return out


def dryrun_case(mesh):
    """Phase 20e's sharded functions at the dry-run sizes of
    __graft_entry__.py:64-160 on ``mesh`` (a multiprocess_check.launch
    target, and phase 20d's world of one): sharded_trace of the padded 0.25
    lamppost grid (rk4, r_max 50, steplim 256; this rank's shard),
    sharded_emissivity_bins (rk4 and rk45, steplim 2048, 16 bins out to r
    50), sharded_caustic_trace of the 5 x 5 bundles (dist 100, incl 30, r_max
    110, steplim 20000; full width), and multiprocess_check.check_case (the
    gradient at 1024 iterations, which MULTICHIP_r05.json's pins need, and
    the fit step at multiprocess_check's 384). Returns arrays, and the
    kernel launches by variant."""
    import torch

    from raytrace_tpu_torch.destinations import ThetaLimit
    from raytrace_tpu_torch.ops.reductions import bin_edges
    from raytrace_tpu_torch.parallel import (pad_rays, shard_rays, sharded_caustic_trace,
                                             sharded_emissivity_bins, sharded_trace)
    from raytrace_tpu_torch.parallel.multiprocess_check import check_case
    from raytrace_tpu_torch.sources import (ImagePlaneGrid, PointSourceGrid, image_plane_bundles,
                                            point_source)

    tallies, out = {}, {}
    grid = PointSourceGrid.from_steps(0.25, 0.25, -0.9, 0.9, -3.0, 3.0)
    rays = point_source((0.0, 5.0, 1e-3, 0.0), 0.0, SPIN, grid, device=mesh.device)
    shard = shard_rays(pad_rays(rays, mesh.size), mesh)
    traced = counted(lambda: sharded_trace(shard, SPIN, mesh, method="rk4", r_max=50.0,
                                           steplim=256), tallies, "rk4_theta")
    out.update({f"trace_{f}": getattr(traced, f) for f in traced.__dataclass_fields__})
    _, _, dr = bin_edges(1.3, 50.0, 16, True, device="cpu")
    for method in ("rk4", "rk45"):
        counts, sums = counted(lambda: sharded_emissivity_bins(
            shard, SPIN, mesh, r_min=1.3, dr=float(dr), n_r=16, n_primary=float(grid.n_rays),
            method=method, r_max=50.0, steplim=2048), tallies, f"{method}_theta")
        out[f"bins_{method}"] = torch.stack([counts, *sums.values()])
    bundles, _ = image_plane_bundles(100.0, 30.0, ImagePlaneGrid.from_steps(-8.0, 8.0, 4.0, -8.0,
                                                                             8.0, 4.0),
                                     SPIN, eps_frac=0.01, device=mesh.device)
    caustic = counted(lambda: sharded_caustic_trace(bundles, -SPIN, mesh,
                                                    dest=ThetaLimit(math.pi / 2), r_max=110.0,
                                                    steplim=20000), tallies, "rk45_theta")
    out.update({f"caustic_{f}": getattr(caustic, f) for f in caustic.__dataclass_fields__})
    case = check_case(mesh, fit_steps=384)
    out["grad"] = [case["value"], *case["grads"]]
    out["fit"] = [case["fit_loss"], *case["fit_grads"]]
    out.update({f"launches_{k}": v for k, v in tallies.items()})
    return out


def resume_shard_phases(launches, torch):
    """Phase 20: the resumable march, checkpoints, progress and profiling,
    and the sharded layer over torch.distributed. Adds this phase's kernel
    launches to ``launches`` by variant; returns its numbers."""
    import os
    import socket
    import threading

    import numpy as np
    import torch.distributed as dist

    from raytrace_tpu_torch.apps import emissivity
    from raytrace_tpu_torch.config import Config
    from raytrace_tpu_torch.ops import kernel_steplim, march_kernel, trace_auto, trace_compacted
    from raytrace_tpu_torch.parallel import make_ray_mesh, sharded_caustic_trace
    from raytrace_tpu_torch.parallel.multiprocess_check import launch
    from raytrace_tpu_torch.rays import RAY_STATUS_STEPLIM
    from raytrace_tpu_torch.sources import PointSourceGrid
    from raytrace_tpu_torch.utils import load_rays, save_rays

    nums = {"card": smi_line()}
    par = emissivity.compute_args(Config([f"--parfile={PARFILE}"]))
    bench_grid = PointSourceGrid.from_steps(0.01, 0.01)

    def walled(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(stop), (time.perf_counter() - t0) * 1e3

    with Phase("20a resume: phased kernel march at full width"):
        rays = lamppost(par["grid"], torch.float32, spin=par["spin"], source=par["source"],
                        V=par["V"])
        nums["20a"] = {}
        for method in ("rk4", "rk45"):
            kw = dict(method=method, steplim=kernel_steplim(method))
            single, one_ms, one_wall = walled(lambda: march_kernel.trace_kernel(rays, par["spin"],
                                                                             **kw))
            march_kernel.launches = 0
            phased, ph_ms, ph_wall = walled(lambda: march_kernel.trace_kernel_phased(
                rays, par["spin"], phase_iters=2048, **kw))
            n_launch = march_kernel.launches
            launches[f"{method}_theta"] += n_launch
            diff = same_bits(phased, single, torch)
            moved = torch.zeros(rays.n_rays, dtype=torch.bool, device="cuda")
            for f in march_kernel.F_FIELDS + march_kernel.I_FIELDS + march_kernel.B_FIELDS:
                a, b = getattr(phased, f), getattr(single, f)
                moved |= ~((a == b) | (a.isnan() & b.isnan())) if a.is_floating_point() else a != b
            rel = ((phased.r.double() - single.r.double()).abs() / single.r.double().abs())[moved]
            rec = dict(rays=rays.n_rays, launches=n_launch, one_ms=one_ms, phased_ms=ph_ms,
                       overhead_ms=ph_ms - one_ms, one_wall_ms=one_wall, phased_wall_ms=ph_wall,
                       fields_differing=diff, rays_differing=int(moved.sum()),
                       max_rel_dr=float(rel.max()) if rel.numel() else 0.0,
                       steplim=kw["steplim"], max_steps=int(single.steps.abs().max()))
            nums["20a"][method] = rec
            print(f"20a {method} x theta f32: {rays.n_rays} rays, steplim {kw['steplim']}, "
                  f"longest ray {rec['max_steps']} steps; one launch {one_ms:.3f} ms (CUDA events), "
                  f"phased (phase_iters 2048) {n_launch} launches {ph_ms:.3f} ms, overhead "
                  f"{ph_ms - one_ms:.3f} ms (host walls {one_wall:.3f} / {ph_wall:.3f} ms); "
                  f"{rec['rays_differing']} rays differ from the one launch in {diff}, max "
                  f"|dr|/r {rec['max_rel_dr']:.3e}")
            check(n_launch >= 1, f"20a {method}: the phased march never launched the kernel")
            if method == "rk4":
                check(not diff, f"20a rk4: phased and one launch differ in {diff}")
        del rays, single, phased
        # the RK45 gate: the phased kernel against the phased plain march over
        # the same boundaries, on the bench grid at STUCK_STEPLIM
        bench = lamppost(bench_grid, torch.float32)
        kw = dict(method="rk45", steplim=STUCK_STEPLIM)
        march_kernel.launches = 0
        pk = march_kernel.trace_kernel_phased(bench, SPIN, phase_iters=2048, **kw)
        launches["rk45_theta"] += march_kernel.launches
        (pp, pp_ms, _) = walled(lambda: trace_compacted(bench, SPIN, progress=True,
                                                         phase_iters=2048, **kw))
        diff = same_bits(pk, pp, torch)
        stuck = int(((pk.status & RAY_STATUS_STEPLIM) != 0).sum())
        print(f"20a rk45 gate: phased kernel against the phased plain march on the bench grid "
              f"({bench.n_rays} rays, steplim {STUCK_STEPLIM}, {stuck} stuck): differ in {diff} "
              f"(plain {pp_ms:.1f} ms)")
        check(not diff, f"20a rk45: phased kernel and phased plain march differ in {diff}")
        nums["20a"]["rk45_gate"] = dict(rays=bench.n_rays, fields_differing=diff, stuck=stuck)

    with Phase("20b resume: checkpoint on the card"):
        kw = dict(method="rk4", steplim=kernel_steplim("rk4"))
        full = march_kernel.trace_kernel(bench, SPIN, **kw)
        march_kernel.launches = 0
        part = march_kernel.trace_kernel(bench, SPIN, max_iters=150, refine_crossing=False, **kw)
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "rays.npz")
            t0 = time.perf_counter()
            save_rays(path, part, spin=SPIN, iterations=150)
            loaded, meta = load_rays(path, device="cuda")
            io_s = time.perf_counter() - t0
        out = march_kernel.trace_kernel(loaded, SPIN, resume=True, **kw)
        launches["rk4_theta"] += march_kernel.launches
        diff = same_bits(out, full, torch)
        live = int(part.active.sum())
        print(f"20b: rk4 f32 kernel, {bench.n_rays} rays: 150 iterations leave {live} active; "
              f"save_rays and load_rays onto the card {io_s:.3f} s; resumed = uninterrupted "
              f"{'bit for bit' if not diff else 'NOT bitwise: ' + str(diff)}")
        check(live > 0 and float(meta["spin"]) == SPIN, "20b: nothing left to resume")
        check(not diff, f"20b: resumed and uninterrupted differ in {diff}")
        nums["20b"] = dict(rays=bench.n_rays, active_at_150=live, io_s=io_s)
        del full, part, loaded, out

    with Phase("20c resume: show_progress and RT_PROFILE through the CLI"), \
            tempfile.TemporaryDirectory() as tmp:
        prof, on, off = Path(tmp) / "prof", Path(tmp) / "on.dat", Path(tmp) / "off.dat"
        env = dict(os.environ, RT_PROFILE=str(prof))
        env.pop("RT_PROGRESS", None)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "raytrace_tpu_torch.apps.emissivity", f"--parfile={PARFILE}",
             f"--outfile={on}", "--show_progress=1"], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"20c: the CLI failed:\n{proc.stderr[-3000:]}")
        bars = [ln for ln in proc.stderr.splitlines() if ln.startswith("march[rk45]")]
        phases = sum(ln.endswith(" live]") for ln in bars)
        launches["rk45_theta"] += phases
        check("[emissivity plain march+bin] ..." in proc.stderr and phases > 0,
              f"20c: no phase line or bar on stderr:\n{proc.stderr[-2000:]}")
        # the profiler's trace, and beside it the port's spans (utils.profiling)
        traces = list(prof.rglob("trace.json"))
        check(len(traces) == 1 and (traces[0].parent / "spans.json").is_file(),
              f"20c: profile directory holds {list(prof.rglob('*.json'))}")
        idle = device_idle(traces[0])
        check(idle["march_kernels"] == phases,
              f"20c: the trace names {idle['march_kernels']} march kernels for {phases} phases")
        check("RT_PROGRESS" not in os.environ, "20c: RT_PROGRESS is set in this process")
        check(emissivity.main([f"--parfile={PARFILE}", f"--outfile={off}"]) == 0,
              "20c: the run without the key failed")
        a, b = np.loadtxt(on), np.loadtxt(off)
        same_cols = [i for i in range(7) if np.array_equal(a[:, i], b[:, i], equal_nan=True)]
        check(a.shape == b.shape == (100, 7) and np.array_equal(a[:, :3], b[:, :3]),
              "20c: bins, areas or counts differ with show_progress")
        check(np.allclose(a, b, rtol=1e-12, atol=0, equal_nan=True),
              "20c: the columns differ beyond the atomics' reassociation")
        print(f"20c: emissivity CLI --show_progress=1 RT_PROFILE: exit 0 in {cli_s:.3f} s, "
              f"{len(bars)} bar lines, {phases} phases (launches); trace {traces[0].name} names "
              f"{idle['march_name']!r} {idle['march_kernels']} times ({idle['march_ms']:.3f} ms); "
              f"the march+bin phase spans {idle['span_ms']:.3f} ms, the card busy "
              f"{idle['busy_ms']:.3f} ms over {idle['device_events']} events: idle share "
              f"{idle['idle_share']:.4f}; output columns bitwise the run without the key: "
              f"{same_cols} (the rest within rtol 1e-12: index_add_ adds float64 in any order)")
        nums["20c"] = dict(cli_s=cli_s, phases=phases, bitwise_columns=same_cols, **idle)

    with Phase("20d shard: world of one over NCCL, in process"):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                                rank=0)
        background, gloo, mpc = {}, None, None

        def ranks():
            try:
                background["ranks"] = launch("chip_smoke:dryrun_case", 2, device="cuda",
                                             backend="gloo")
            except Exception as e:  # reported by the phase below, which raises
                background["error"] = e

        try:
            mesh = make_ray_mesh()
            check(mesh.size == 1 and mesh.device == torch.device("cuda", 0), f"20d: {mesh}")
            # NCCL sets its communicator up at the first collective: apart
            _, init_ms, _ = walled(lambda: dist.all_reduce(torch.zeros(1, device="cuda")))
            # timed alone on the card, before the ranks below start: compute
            # over the NCCL mesh, and without a mesh (a world of one with no
            # group, which calls no collective): the same sharded path
            runs = {"sharded": [], "unsharded": []}
            for which in ("sharded", "unsharded", "unsharded", "sharded"):
                march_kernel.launches = 0
                out, ms, wall = walled(lambda: emissivity.compute(
                    **par, mesh=mesh if which == "sharded" else None))
                check(march_kernel.launches == 1, f"20d: {which} compute did not launch once")
                if which == "sharded":
                    launches["rk45_theta"] += march_kernel.launches
                    shard_out = out
                else:
                    plain_out = out
                runs[which].append((ms, wall))
            (shard_ms, shard_wall), (plain_ms, plain_wall) = (min(runs[k]) for k in runs)
            for k in ("r", "area", "rays"):
                check(np.array_equal(shard_out[k], plain_out[k]), f"20d: {k} differs")
            bitwise = [k for k in shard_out
                       if np.array_equal(shard_out[k], plain_out[k], equal_nan=True)]
            for k in ("flux", "emis", "redshift", "time"):
                check(np.allclose(shard_out[k], plain_out[k], rtol=1e-12, equal_nan=True),
                      f"20d: {k} differs beyond the atomics' reassociation")
            print(f"20d: emissivity compute over a world of one (NCCL; its first all_reduce "
                  f"{init_ms:.3f} ms) on the par file's {par['grid'].n_rays} rays, in turns, "
                  f"the card to itself (mesh, no mesh, no mesh, mesh; CUDA events, host walls): "
                  f"NCCL mesh {runs['sharded']} ms, no mesh {runs['unsharded']} ms; bitwise "
                  f"columns {bitwise}, the rest within rtol 1e-12")
            # the 2 gloo ranks (20e) and multiprocess_check (20f) share the
            # card with the rest of this phase from here on
            gloo = threading.Thread(target=ranks)
            gloo.start()
            mpc_out = Path(tempfile.mkdtemp()) / "mpc.json"
            mpc = subprocess.Popen([sys.executable, "-m",
                                    "raytrace_tpu_torch.parallel.multiprocess_check",
                                    str(mpc_out), "--n_steps", "384"], cwd=ROOT,
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            rays, spin, ckw = caustic_batch("plane", torch.float64)
            ckw = dict(ckw, method="rk45", steplim=kernel_steplim("rk45"),
                       march_dtype=torch.float64)
            march_kernel.launches = 0
            sc = sharded_caustic_trace(rays, spin, mesh, **ckw)
            launches["rk45_plane_f64"] += march_kernel.launches
            diff = same_bits(sc, trace_auto(rays, spin, **ckw), torch)
            check(not diff, f"20d: sharded_caustic_trace and trace_auto differ in {diff}")
            print(f"20d: sharded_caustic_trace on the plane golden's {rays.n_rays} bundle rays "
                  f"(rk45 f64) = trace_auto bit for bit")
            t0 = time.perf_counter()
            world1 = dryrun_case(mesh)
            case_s = time.perf_counter() - t0
            for k in [k for k in world1 if k.startswith("launches_")]:
                launches[k[len("launches_"):]] += world1.pop(k)
            pins = [31.0060045484864, 76.33067409568959, 35.020458010357046, 5.64657169302714]
            rtol = [abs(a - b) / abs(b) for a, b in zip(world1["grad"], pins)]
            print(f"20d: sharded_emissivity_gradient (dry run: 0.25 grid, 1024 iterations) value "
                  f"and d/d(spin, h, gamma) {world1['grad']} against MULTICHIP_r05.json's "
                  f"{pins}: rtol {rtol}; the dry-run case in {case_s:.3f} s (the card "
                  f"shared with the 2 gloo ranks and multiprocess_check)")
            check(max(rtol) <= 1e-8, f"20d: gradient pins off by {rtol}")
            nums["20d"] = dict(nccl_first_all_reduce_ms=init_ms, turns=runs,
                               sharded_ms=shard_ms, sharded_wall_ms=shard_wall,
                               unsharded_ms=plain_ms, unsharded_wall_ms=plain_wall,
                               bitwise_columns=bitwise, grad=world1["grad"], pin_rtol=rtol,
                               dryrun_case_s=case_s)
        finally:
            if gloo is not None:
                gloo.join()
            mpc_log = mpc.communicate()[0] if mpc is not None else ""
            dist.destroy_process_group()

    with Phase("20e shard: two gloo ranks on the card"):
        check("error" not in background, f"20e: the ranks failed: {background.get('error')}")
        ranks = background["ranks"]
        host = lambda v: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
        world1 = {k: host(v) for k, v in world1.items()}
        for k in [k for k in ranks[0] if k.startswith("launches_")]:
            launches[k[len("launches_"):]] += int(sum(r[k] for r in ranks))
        # the ranks' shards end to end are the world of one's batch (200
        # rays: no padding for 2), bit for bit
        for f in (k for k in world1 if k.startswith("trace_")):
            got = np.concatenate([r[f] for r in ranks])
            check(np.array_equal(got, world1[f], equal_nan=True), f"20e: {f} differs")
        gaps = {}
        for r in ranks:
            for f in (k for k in world1 if k.startswith("caustic_")):
                check(np.array_equal(r[f], world1[f], equal_nan=True), f"20e: {f} differs")
            for k in ("bins_rk4", "bins_rk45", "grad", "fit"):
                if k.startswith("bins"):
                    check(np.array_equal(r[k][0], world1[k][0]), f"20e: {k} counts differ")
                rel = np.abs(r[k] - world1[k]) / np.maximum(np.abs(world1[k]), 1e-300)
                gaps[k] = max(gaps.get(k, 0.0), float(np.nanmax(rel)))
        print(f"20e: 2 gloo ranks on one card: traces and gathered bundles bit for bit the world "
              f"of one's, bin counts equal; largest relative gap of the merged sums and "
              f"gradients {gaps}")
        check(all(g <= 1e-12 for g in gaps.values()), f"20e: sums or gradients off: {gaps}")
        nums["20e"] = dict(rel_gaps=gaps)

    with Phase("20f shard: multiprocess_check and scaling_bench"):
        check(mpc.returncode == 0, f"20f: multiprocess_check failed:\n{mpc_log[-3000:]}")
        record = json.loads(mpc_out.read_text())
        print(json.dumps({"multiprocess_check": record}))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "raytrace_tpu_torch.parallel.scaling_bench"],
                              cwd=ROOT, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"20f: scaling_bench failed:\n{proc.stderr[-3000:]}")
        lines = proc.stdout.strip().splitlines()
        scaling = [json.loads(ln) for ln in lines if ln.startswith("{")]
        print(json.dumps({"scaling_bench": scaling, "note": [ln for ln in lines
                                                             if not ln.startswith("{")]}))
        check(scaling and scaling[0]["binned"] > 0, "20f: scaling_bench binned nothing")
        nums["20f"] = dict(multiprocess_check=record, scaling=scaling,
                           scaling_s=time.perf_counter() - t0)
    return nums


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    if not (ROOT / "raytrace_tpu_torch").is_dir():
        print(f"chip_smoke: no raytrace_tpu_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from raytrace_tpu_torch.apps import caustics, emissivity, imageplane_disc_image
    from raytrace_tpu_torch.config import Config
    from raytrace_tpu_torch.destinations import SphericalShell
    from raytrace_tpu_torch.io import read_fits
    from raytrace_tpu_torch.ops import kernel_steplim, march_kernel, trace, trace_auto
    from raytrace_tpu_torch.sources import ImagePlaneGrid, PointSourceGrid

    # lives until the script ends: phase 8 writes the disc image phase 17 folds
    keep = tempfile.TemporaryDirectory()
    image_fits = Path(keep.name) / "disc_image.fits"

    with Phase("0 device"):
        device_name = torch.cuda.get_device_name(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"device: {device_name} | torch {torch.__version__} cuda {torch.version.cuda} "
              f"| devices {torch.cuda.device_count()}")
        print(f"nvidia-smi: {smi_line()}")
        print("tf32: matmul and cudnn TF32 off (nothing on the path uses them)")

    with Phase("1 build"):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            probes = start_probe_builds(tmp)  # beside the library's own nvcc
            try:
                log = march_kernel.build(force=True)
                march_kernel.load()
                print(f"build: nvcc sm_90a in {time.perf_counter() - t0:.1f} s")
                for line in ptxas_lines(log):
                    print(f"ptxas: {line}")
                for name, proc in probes.items():
                    out, _ = proc.communicate()
                    check(proc.returncode == 0, f"nvcc of the {name} failed:\n{out[-3000:]}")
            finally:
                for proc in probes.values():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            print(f"probes built in {time.perf_counter() - t0:.1f} s")
            STEP_ISSUE.update(step_issue(tmp))
            trig_check(tmp)
        CARD.update(sms=torch.cuda.get_device_properties(0).multi_processor_count,
                    clock_hz=1e6 * float(smi_query("clocks.max.sm")))
        print(f"card: {CARD['sms']} SMs, clocks.max.sm {CARD['clock_hz'] / 1e6:.0f} MHz")
        for (method, kind, dname), c in sorted(STEP_ISSUE.items()):
            print(f"issue {method} x {kind} {dname}: one full loop iteration, least "
                  f"{issue_line(c['least'])}; most {issue_line(c['most'])}")

    with Phase("2 parity"):
        golden_grid = PointSourceGrid.from_steps(0.05, 0.05)
        for dtype in (torch.float32, torch.float64):
            rays = lamppost(golden_grid, dtype)
            live = (rays.steps == 0).cpu().numpy()
            for method in ("rk4", "rk45"):
                a = march_kernel.trace_kernel(rays, SPIN, method=method, steplim=3000,
                                              march_dtype=dtype)
                torch.cuda.synchronize()
                b = trace(rays, SPIN, method=method, steplim=3000)
                torch.cuda.synchronize()
                p = parity(a, b, live, dtype, torch)
                tag = f"{method}_{str(dtype).replace('torch.float', 'f')}"
                print(parity_line(tag, p))
                check(p["ok"], f"parity gates failed for {tag}: {p}")

    with Phase("3 golden"):
        ref = dict(zip(["r", "area", "rays", "flux", "emis", "redshift", "time"],
                       np.loadtxt(GOLDEN).T))
        before = march_kernel.launches
        grid = emissivity.PointSourceGrid.from_steps(0.05, 0.05)
        out = emissivity.compute(SPIN, SOURCE, V=0.0, grid=grid, r_max=1000.0, r_disc=500.0,
                                 n_r=100, logbin_r=True, gamma=2.0, method="rk45",
                                 steplim=20000, device="cuda")
        check(march_kernel.launches > before, "golden run did not launch the kernel")
        gated = (ref["rays"] >= 100) & (out["rays"] >= 100) & (
            np.abs(out["rays"] - ref["rays"]) < 0.10 * np.maximum(ref["rays"], 1))
        devs = {f: float(np.abs(out[f][gated] / ref[f][gated] - 1).max())
                for f in ("emis", "flux", "redshift", "time")}
        print(f"golden: {int(gated.sum())} gated bins, max rel dev {devs}")
        check(gated.sum() >= 12, "fewer than 12 gated bins")
        check(devs["emis"] < 0.10 and devs["flux"] < 0.10, f"emis/flux off: {devs}")
        check(devs["redshift"] < 0.005 and devs["time"] < 0.05, f"redshift/time off: {devs}")

        # the midspin lamppost below the ISCO, with the gates of
        # tests/test_emissivity.py:158-196 (the reference's sub-annulus quirk
        # puts every bin area 1.5-2.5% high at this spin)
        ref = dict(zip(["r", "area", "rays", "flux", "emis", "redshift", "time"],
                       np.loadtxt(GOLDEN_MIDSPIN).T))
        before = march_kernel.launches
        grid = emissivity.PointSourceGrid.from_steps(0.05, 0.05, -0.995, 0.995, -math.pi, math.pi)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = emissivity.compute(0.5, (0.0, 3.0, 1e-3, 1.5707), V=0.0, grid=grid, r_max=1000.0,
                                 r_disc=500.0, n_r=100, logbin_r=True, gamma=2.0, method="rk45",
                                 steplim=20000, device="cuda")
        wall = time.perf_counter() - t0
        check(march_kernel.launches > before, "midspin golden run did not launch the kernel")
        r_dev = float(np.abs(out["r"] / ref["r"] - 1).max())
        area = np.abs(out["area"] / ref["area"] - 1)
        gated = (ref["rays"] >= 100) & (out["rays"] >= 100) & (
            np.abs(out["rays"] - ref["rays"]) < 0.10 * np.maximum(ref["rays"], 1))
        devs = {f: float(np.abs(out[f][gated] / ref[f][gated] - 1).max())
                for f in ("emis", "flux", "redshift", "time")}
        print(f"golden midspin (a 0.5, h 3, rk45 f32 kernel): wall {wall:.3f} s, r max rel dev "
              f"{r_dev:.3e} (gate 1e-6), area rel dev {area.min():.4f}-{area.max():.4f} "
              f"(0.015-0.025), {int(gated.sum())} gated bins (>= 6), max rel dev {devs} "
              f"(emis 0.10, redshift 0.005, time 0.05; flux not gated)")
        check(r_dev <= 1e-6, f"midspin r off: {r_dev}")
        check(0.015 < area.min() and area.max() < 0.025, f"midspin areas off: {area}")
        check(gated.sum() >= 6, "midspin: fewer than 6 gated bins")
        check(devs["emis"] < 0.10 and devs["redshift"] < 0.005 and devs["time"] < 0.05,
              f"midspin emis/redshift/time off: {devs}")

    launches = {}
    held = {}  # (main path, variant) -> (parity record, plain ms, plain steplim)
    batches = []  # (main path, variant, rays, spin, march keywords, method, march dtype)
    with Phase("4 full size"):
        par = emissivity.compute_args(Config([f"--parfile={PARFILE}"]))
        n_rays = par["grid"].n_rays
        with tempfile.TemporaryDirectory() as tmp:
            for method in ("rk45", "rk4"):
                outfile = Path(tmp) / f"emissivity_{method}.dat"
                argv = [f"--parfile={PARFILE}", f"--outfile={outfile}"]
                if method == "rk4":
                    argv.append("--integrator=rk4")
                march_kernel.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc = emissivity.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches[f"{method}_theta"] = march_kernel.launches
                check(rc == 0, f"emissivity main returned {rc}")
                check(march_kernel.launches > 0, f"main path ({method}) never launched the kernel")
                prof = np.loadtxt(outfile)
                check(prof.shape == (100, 7), f"output shape {prof.shape}")
                full = prof[:, 2] >= 100
                check(full.sum() >= 12, f"only {int(full.sum())} bins with >= 100 rays")
                check(np.isfinite(prof[full, 4]).all(), "non-finite emissivity in populated bins")
                print(f"full size {method}: {n_rays} rays, wall {wall:.3f} s, "
                      f"{n_rays / wall:.4e} rays/s, {int(full.sum())} bins >= 100 rays, "
                      f"{march_kernel.launches} kernel launch(es)")

        # the kernel against the plain march on the main path's own batch:
        # built as compute builds it, marched in float32 as trace_auto marches
        # it, with the par file's (unrounded) spin
        rays = lamppost(par["grid"], torch.float32, spin=par["spin"],
                        source=par["source"], V=par["V"])
        for method in ("rk45", "rk4"):
            out = march_kernel.trace_kernel(rays, par["spin"], method=method,
                                            steplim=kernel_steplim(method))
            held["emissivity", f"{method}_theta"] = hold_full_width(
                f"{method}_f32", rays, par["spin"], method, {}, out, torch.float32, torch)
            batches.append(("emissivity", f"{method}_theta", rays, par["spin"], {}, method,
                            torch.float32))
        del out

    with Phase("5 timing"):
        bench_grid = PointSourceGrid.from_steps(0.01, 0.01)
        golden_grid = PointSourceGrid.from_steps(0.05, 0.05)
        for method in ("rk4", "rk45"):
            steplim = BENCH_STEPLIM[method]
            rays = lamppost(bench_grid, torch.float32)
            live = (rays.steps == 0).cpu().numpy()
            ms, out = cuda_ms(lambda: march_kernel.trace_kernel(
                rays, SPIN, method=method, steplim=steplim), torch)
            steps = np.abs(out.steps.cpu().numpy()).astype(np.int64)
            stuck = (out.status.cpu().numpy() & 8) != 0
            useful = int(steps[live & ~stuck].sum())
            print(f"bench {method}: {int(live.sum())} rays, steplim {steplim}, kernel "
                  f"{ms:.3f} ms, {useful / (ms / 1e3):.4e} useful steps/s, "
                  f"{int((stuck & live).sum())} stuck")

            small = lamppost(golden_grid, torch.float32)
            k_ms, out = cuda_ms(lambda: march_kernel.trace_kernel(
                small, SPIN, method=method, steplim=steplim), torch)
            p_ms, _ = cuda_ms(lambda: trace(small, SPIN, method=method, steplim=steplim), torch,
                              repeats=1, warmup=False)
            b_ms, b_by = march_bound(out, method, "theta", torch.float32)
            print(f"kernel vs plain {method} f32 (5,040 rays, steplim {steplim}): "
                  f"kernel {k_ms:.3f} ms (best of 3), plain {p_ms:.3f} ms (one run), "
                  f"ratio {p_ms / k_ms:.1f}x, bound {b_ms:.4f} ms ({b_by})")

    image_plain_ms = {}
    with Phase("6 image parity"):
        isco_grid = ImagePlaneGrid.from_steps(-20.0, 20.0, 40.0 / 81, -20.0, 20.0, 40.0 / 81)
        for dtype in (torch.float32, torch.float64):
            rays = image_rays(isco_grid, dtype, torch)
            live = np.ones(isco_grid.n_rays, dtype=bool)
            for method, kind in IMAGE_VARIANTS:
                kw = dict(method=method, dest=image_dest(kind, 20.0), steplim=3000, r_max=550.0)
                a = march_kernel.trace_kernel(rays, -SPIN, march_dtype=dtype, **kw)
                torch.cuda.synchronize()
                p_ms, b = cuda_ms(lambda: trace(rays, -SPIN, **kw), torch, repeats=1, warmup=False)
                if dtype == torch.float32:
                    image_plain_ms[method, kind] = p_ms
                p = parity(a, b, live, dtype, torch)
                tag = f"{method}_{kind}_{str(dtype).replace('torch.float', 'f')}"
                print(parity_line(tag, p))
                check(p["ok"], f"parity gates failed for {tag}: {p}")

    with Phase("7 image goldens"):
        before = march_kernel.launches
        out = imageplane_disc_image.compute(
            SPIN, 500.0, 60.0, isco_grid, r_disc=20.0, img_nx=40, img_ny=40, variant="isco",
            method="rk45", steplim=100000, device="cuda")
        check(march_kernel.launches > before, "isco golden run did not launch the kernel")
        # float32 march: the envelope tests/test_f32.py holds the JAX f32
        # disc image to against f64
        image_golden_check("isco (rk45 f32, 82 x 82)", out, GOLDEN_ISCO, 40, 0.01,
                           {"r": 2e-3, "enshift": 1e-3, "time": 1e-4, "flux": 5e-3}, 500)
        far_grid = ImagePlaneGrid.from_steps(-30.0, 30.0, 60.0 / 500, -30.0, 30.0, 60.0 / 500)
        out = imageplane_disc_image.compute(
            SPIN, 1e4, 80.0, far_grid, r_disc=30.0, img_nx=250, img_ny=250, method="rk45",
            device="cuda")
        # analysis/tpu_validation.py:52,129-145
        image_golden_check("far field (rk45 f32, d 1e4, 501 x 501)", out, GOLDEN_FAR, 250, 0.02,
                           {"r": 0.01, "enshift": 0.005, "time": 0.001, "flux": 0.05}, 1000)

    with Phase("8 image full width"):
        image_cfg = Config([f"--parfile={IMAGE_PARFILE}"])
        nx = image_cfg.get("Nx", int)
        n_image = (nx + 1) ** 2
        with tempfile.TemporaryDirectory() as tmp:
            for entry, extra, variant in IMAGE_RUNS:
                outfile = Path(tmp) / f"{entry}_{variant}.fits"
                argv = [f"--parfile={IMAGE_PARFILE}", f"--outfile={outfile}"]
                if extra:
                    argv.append(extra)
                march_kernel.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc = getattr(imageplane_disc_image, entry)(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                n_launch = march_kernel.launches
                launches[variant] = launches.get(variant, 0) + n_launch
                check(rc == 0, f"{entry} returned {rc}")
                check(n_launch > 0, f"main path ({entry} {extra or ''}) never launched the kernel")
                fits = read_fits(str(outfile))
                hdr = fits["_headers"]["PRIMARY"]
                n_disc = int(hdr["DISCRAYS"])
                check(int(hdr["NRAYS"]) == n_image, f"NRAYS {hdr['NRAYS']} != {n_image}")
                for ext in ("FLUX", "RADIUS", "PHI", "ENSHIFT", "TIME", "EMIS", "NRAYS"):
                    check(fits[ext].shape == (nx, nx), f"{ext} shape {fits[ext].shape}")
                    check(np.isfinite(fits[ext]).all(), f"non-finite {ext}")
                check(n_disc == int(fits["NRAYS"].sum()) > 0.05 * n_image,
                      f"DISCRAYS {n_disc} against the count map's {fits['NRAYS'].sum()}")
                if entry == "main" and not extra:  # phase 17 folds it into a line
                    shutil.copy(outfile, image_fits)
                print(f"full width {entry} {extra or ''} ({variant}): {n_image} rays, wall "
                      f"{wall:.3f} s, {n_image / wall:.4e} rays/s, DISCRAYS {n_disc}, "
                      f"{n_launch} kernel launch(es)")

        # the kernel against the plain march on the main path's own batch
        full_grid = ImagePlaneGrid.from_steps(-30.0, 30.0, 60.0 / nx, -30.0, 30.0, 60.0 / nx)
        rays = image_rays(full_grid, torch.float32, torch, dist=1e4, incl=80.0)
        for method, kind in (("rk45", "isco"), ("euler", "theta"), ("rk4", "isco")):
            kw = dict(dest=image_dest(kind, 30.0), r_max=1.1e4)
            out = march_kernel.trace_kernel(rays, -SPIN, method=method,
                                            steplim=kernel_steplim(method), **kw)
            held["disc image", f"{method}_{kind}"] = hold_full_width(
                f"{method}_{kind}_f32", rays, -SPIN, method, kw, out, torch.float32, torch)
        for method, kind in (("rk45", "isco"), ("euler", "theta"), ("rk4", "isco"),
                             ("rk45", "theta"), ("rk4", "theta")):
            batches.append(("disc image", f"{method}_{kind}", rays, -SPIN,
                            dict(dest=image_dest(kind, 30.0), r_max=1.1e4), method, torch.float32))
        del out

    with Phase("9 image timing"):
        rays = image_rays(isco_grid, torch.float32, torch)
        for method, kind in IMAGE_VARIANTS:
            kw = dict(method=method, dest=image_dest(kind, 20.0), steplim=3000, r_max=550.0)
            k_ms, out = cuda_ms(lambda: march_kernel.trace_kernel(rays, -SPIN, **kw), torch)
            p_ms = image_plain_ms[method, kind]  # the plain march (seconds a run) of phase 6
            b_ms, b_by = march_bound(out, method, kind, torch.float32)
            print(f"kernel vs plain {method}/{kind} f32 (82 x 82 image-plane rays, steplim 3000): "
                  f"kernel {k_ms:.3f} ms (best of 3), plain {p_ms:.3f} ms (one run), "
                  f"ratio {p_ms / k_ms:.1f}x, bound {b_ms:.4f} ms ({b_by})")
        del rays

    small_timing = {}
    with Phase("10 caustic parity"):
        for method, kind, dname in CAUSTIC_PARITY:
            dtype = getattr(torch, dname)
            rays, spin, kw = caustic_batch(kind, dtype)
            kw = dict(kw, method=method, steplim=3000)
            k_ms, a = cuda_ms(lambda: march_kernel.trace_kernel(rays, spin, march_dtype=dtype,
                                                                **kw), torch)
            p_ms, b = cuda_ms(lambda: trace(rays, spin, **kw), torch, repeats=1, warmup=False)
            p = parity(a, b, (rays.steps == 0).cpu().numpy(), dtype, torch)
            b_ms, b_by = march_bound(a, method, kind, dtype)
            tag = f"{method}_{kind}_{dname.replace('float', 'f')}"
            print(parity_line(tag, p) + f" | {rays.n_rays} rays, kernel {k_ms:.3f} ms (best of 3), "
                  f"plain {p_ms:.1f} ms (one run), ratio {p_ms / k_ms:.0f}x, "
                  f"bound {b_ms:.4f} ms ({b_by})")
            check(p["ok"], f"parity gates failed for {tag}: {p}")
            small_timing[tag] = (k_ms, p_ms, b_ms, b_by)
            if tag == "euler_plane_f32":  # its latency term, as phase 13 takes the others'
                lat_us, longest = step_latency_us(rays, spin, a, "grid",
                                                  dict(kw, march_dtype=dtype), torch)
                print(f"latency term {tag}: lone-ray step latency "
                      + (f"{lat_us:.4f} us x {longest} steps = {longest * lat_us / 1e3:.4f} ms"
                         if lat_us else f"not resolved over the longest ray's {longest} steps"))
        del rays, a, b

    with Phase("11 caustic goldens"):
        before = march_kernel.launches
        disc_grid = ImagePlaneGrid.from_steps(-12.0, 12.0, 0.3, -12.0, 12.0, 0.3)
        disc_kw = dict(target="disc", r_disc=20.0, method="rk45", steplim=60000, device="cuda")
        maps = caustics.compute(SPIN, 500.0, 60.0, disc_grid, **disc_kw)
        caustic_golden_check("discplane (rk45 f64, 81 x 81 bundles)", "discplane", maps,
                             CAUSTIC_GATES["discplane"])
        maps = caustics.compute(SPIN, 500.0, 60.0, disc_grid, dtype=torch.float32, **disc_kw)
        caustic_golden_check("discplane (rk45 f32, the TPU's envelope)", "discplane", maps,
                             CAUSTIC_GATES["discplane_f32"])
        maps = caustics.compute(SPIN, 500.0, 30.0,
                                ImagePlaneGrid.from_steps(-10.0, 10.0, 0.25, -10.0, 10.0, 0.25),
                                target="plane", z_s=500.0, method="rk45", steplim=100000,
                                device="cuda")
        caustic_golden_check("plane (rk45 f64, 81 x 81 bundles)", "plane", maps,
                             CAUSTIC_GATES["plane"])
        dx = 24.0 / 81
        maps = caustics.compute(SPIN, 500.0, 30.0,
                                ImagePlaneGrid.from_steps(-12.0, 12.0, dx, -12.0, 12.0, dx),
                                target="sphere", r_lim=1000.0, method="rk45", steplim=100000,
                                device="cuda")
        caustic_golden_check("sourceplane (rk45 f64, 82 x 82)", "sourceplane", maps,
                             CAUSTIC_GATES["sourceplane"])
        check(march_kernel.launches == before + 4, "a caustic golden run did not launch the kernel")

    runs = {}
    with Phase("12 caustic full width"):
        # caustics.compute marches in pixel ranges as they land on one card
        # (seen: the ranges end to end)
        with Recorder(caustics, "trace_in_ranges") as rec, tempfile.TemporaryDirectory() as tmp:
            seen = rec.seen  # what the main path marched, and how
            for target, extra, variant in CAUSTIC_RUNS:
                outfile = Path(tmp) / f"{variant}.fits"
                argv = [f"--parfile={CAUSTIC_PARFILES[target]}", f"--outfile={outfile}"]
                if extra:
                    argv.append(extra)
                cli = caustics.compute_args(Config(argv), target)[0]
                march_kernel.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc = getattr(caustics, CAUSTIC_MAINS[target])(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                n_launch = march_kernel.launches
                launches[variant] = n_launch
                rays, kw = seen["rays"], dict(seen["kw"])
                method = kw.pop("method")
                march_dtype = kw.pop("march_dtype")
                kw.pop("steplim")
                kind = {"DiscWithISCO": "isco", "FlatPlane": "plane",
                        "ThetaLimit": "theta"}[type(kw["dest"]).__name__]
                check(rc == 0, f"{CAUSTIC_MAINS[target]} returned {rc}")
                check(n_launch > 0, f"main path ({target} {extra or ''}) never launched the "
                                    "kernel")
                check(f"{method}_{kind}_f64" == variant and march_dtype == torch.float64
                      and rays.r.dtype == torch.float64,
                      f"{target} {extra or ''} marched {method} x {kind} in {march_dtype}")
                fits = read_fits(str(outfile))
                shape = (cli["grid"].nx, cli["grid"].ny)
                for ext, _ in caustics._EXTENSIONS[target]:
                    check(fits[ext].shape == shape, f"{ext} shape {fits[ext].shape}")
                    check(np.isfinite(fits[ext]).all(), f"non-finite {ext}")
                hit_ext = {"disc": "HIT", "plane": "HIT_PLANE", "sphere": "ESCAPED"}[target]
                hits = int(fits[hit_ext].sum())
                check(hits > 0, f"{target}: no hits")
                print(f"full width {CAUSTIC_MAINS[target]} {extra or ''} ({variant}): "
                      f"{rays.n_rays} rays, wall {wall:.3f} s, {rays.n_rays / wall:.4e} rays/s, "
                      f"{hits} hits of {shape[0] * shape[1]} pixels, {n_launch} kernel "
                      f"launch(es)")
                runs[variant] = (rays, seen["spin"], kw, method, seen["out"])
                seen.clear()

        # the SphericalShell route (trace_auto, float32) on the bench grid
        bench_grid = PointSourceGrid.from_steps(0.01, 0.01)
        bench = lamppost(bench_grid, torch.float32)
        shell_kw = dict(dest=SphericalShell(SHELL["r_shell"]), boundary=SHELL["boundary"])
        for method in ("euler", "rk4", "rk45"):
            variant = f"{method}_shell_f32"
            march_kernel.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = trace_auto(bench, SPIN, method=method, **shell_kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[variant] = march_kernel.launches
            check(launches[variant] > 0, f"the shell route ({method}) never launched the kernel")
            print(f"shell route {method} (bench grid, {bench.n_rays} rays, float32): wall "
                  f"{wall:.3f} s, {launches[variant]} kernel launch(es)")
            runs[variant] = (bench, SPIN, shell_kw, method, out)

        for variant, (rays, spin, kw, method, out) in runs.items():
            path = "shell route" if "shell" in variant else "caustics"
            held[path, variant] = hold_full_width(variant, rays, spin, method, kw, out,
                                                  rays.r.dtype, torch)
            batches.append((path, variant, rays, spin, kw, method, rays.r.dtype))
        runs.clear()

    timed = {}
    traces = {}  # (main path, variant) -> phase 13's launch-trace figures
    with Phase("13 schedules"):
        trace_lib = open_trace_library()
        for tag, (k_ms, p_ms, b_ms, b_by) in small_timing.items():
            print(f"kernel vs plain {tag} (phase 10 grid, steplim 3000): kernel {k_ms:.3f} ms, "
                  f"plain {p_ms:.1f} ms, ratio {p_ms / k_ms:.0f}x, bound {b_ms:.4f} ms ({b_by})")
        for path, variant, rays, spin, kw, method, dtype in batches:
            timed[path, variant] = time_schedules(path, variant, rays, spin, kw, method, dtype,
                                                  torch)
            if variant in TRACED and dtype == torch.float32:
                traces[path, variant] = trace_longest(trace_lib, path, variant, rays, spin, kw,
                                                      method, dtype, timed[path, variant], torch)
        batches.clear()

    slice_phases(launches, torch)
    rejects = outflow_phases(launches, image_fits, torch)
    held["gradients", "rk4_theta_f64"], timed["gradients", "rk4_theta_f64"], grads = (
        gradient_phases(launches, torch))
    resumed = resume_shard_phases(launches, torch)

    print(f"nvidia-smi: {smi_line()}")
    # (name, variant key, main path whose batch timed it)
    records = [
        ("geodesic_march_rk45_f32", "rk45_theta", "emissivity"),
        ("geodesic_march_rk4_f32", "rk4_theta", "emissivity"),
        ("geodesic_march_euler_f32", "euler_theta", "disc image"),
        ("geodesic_march_rk4_isco_f32", "rk4_isco", "disc image"),
        ("geodesic_march_rk45_isco_f32", "rk45_isco", "disc image"),
    ] + [(f"geodesic_march_{v.replace('_theta', '')}", v, "caustics") for _, _, v in CAUSTIC_RUNS
         ] + [(f"geodesic_march_{m}_shell_f32", f"{m}_shell_f32", "shell route")
              for m in ("euler", "rk4", "rk45")
              ] + [("geodesic_march_rk4_f64", "rk4_theta_f64", "gradients")]
    kernels = []
    for name, variant, path in records:
        t, (p, (plain_ms, plain_steplim)) = timed[path, variant], held[path, variant]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE_FILE,
            "replaces": REPLACES,
            "launches": launches[variant],
            "max_abs_err": p["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": plain_ms,
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bound_pipe"] == "bytes" else "operations",
            "bound_pipe": t["bound_pipe"],
            "issue_per_step": {p: t["issue"]["least"].get(p, 0) for p in PIPES},
            "issue_per_step_most": {p: t["issue"]["most"].get(p, 0) for p in PIPES},
            "registers": t["info"]["registers"],
            "local_bytes": t["info"]["local_bytes"],
            "blocks_per_sm": t["info"]["blocks_per_sm"],
            "library_ms": None,
            "schedule": t["schedule"],
            "grid_ms": t["grid_ms"],
            "refill_ms": t["refill_ms"],
            "latency_bound_ms": t["latency_bound_ms"],
            "step_latency_us": t["step_latency_us"],
            "steplim": t["steplim"],
            "plain_steplim": plain_steplim,
            "lone_floor_ms": t["lone_floor_ms"],
            "batch": f"{path}, {t['n_rays']} rays",
        })
    # the bound counts accepted steps; a rejected trial is one more full
    # iteration of the loop, so the bound over the trials is the bound times
    # trials / accepted steps (the emissivity batch's finished lanes)
    rk45 = next(k for k in kernels if k["name"] == "geodesic_march_rk45_f32")
    per_step = rejects["trials_total"] / (rejects["trials_total"] - rejects["rejects_total"])
    rk45.update(reject_share=rejects["share"], bound_ms_with_trials=rk45["bound_ms"] * per_step)
    over, over_trials = rk45["ms"] / rk45["bound_ms"], rk45["ms"] / rk45["bound_ms_with_trials"]
    print(f"rk45 x theta f32 (emissivity): {rk45['ms']:.3f} ms against a bound of "
          f"{rk45['bound_ms']:.3f} ms ({over:.3f}x); the rejected trials "
          f"({rejects['share']:.4%} of the trials) raise the bound to "
          f"{rk45['bound_ms_with_trials']:.3f} ms ({over_trials:.3f}x): they explain "
          f"{(per_step - 1) / (over - 1):.1%} of the excess")
    print(json.dumps({"launch_trace": {f"{p}, {v}": t for (p, v), t in traces.items()}}))
    print(json.dumps({"gradients": grads}))
    print(json.dumps({"resume_and_shards": resumed}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                              "count": torch.cuda.device_count()}}))
    keep.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
