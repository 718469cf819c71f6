#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (raytrace_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases, one line each with its seconds; any failed check raises, so the
script exits non-zero:
  0. device: name and power limit, TF32 off;
  1. build the march kernel from csrc/ with nvcc (ptxas registers/spills);
  2. parity: the kernel against the plain torch march on the card, rk4 and
     rk45, float32 and float64, on the golden 0.05 grid (5,040 rays);
  3. golden: apps.emissivity.compute on the card against the reference
     binary's emissivity profile, with the count gates of
     tests/test_emissivity.py;
  4. full size: the emissivity CLI on par_example/emissivity.par (about
     2.5 M rays, RK45), and again with --integrator=rk4; the kernel's
     launch count is zeroed before and read after each run. Then the
     kernel against the plain march on that run's own batch (the par
     file's lamppost after redshift_start, float32 march, the par file's
     spin, kernel_steplim), with the float32 parity gates;
  5. timing with CUDA events (best of 3 after a warm-up): the bench
     workload of bench.py (0.01 grid, 125,800 rays) on the kernel, and the
     kernel against the plain march on the 0.05 grid;
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
     then the kernel against the plain march on that batch: isco rk45 at
     steplim 3000, euler x theta and isco rk4 at kernel_steplim, and the
     rays that stick under RK45 (with their neighbours) at steplim 10,000;
  9. image timing with CUDA events: each new instantiation against its
     plain version on the 82 x 82 grid, and the kernel at full width.
The last two lines are the per-kernel JSON record and the device record.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SPIN = 0.998
SOURCE = (0.0, 5.0, 1e-3, 1.5707)
GOLDEN = ROOT / "tests" / "golden" / "emissivity_a0.998_h5_g0.05.dat"
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
# cap of the plain-march comparison on the RK45 stuck rays (phase 8)
STUCK_STEPLIM = 10_000


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            print(f"[phase] {self.name}: ok in {time.perf_counter() - self.t0:.2f} s", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def take(rays, idx):
    """The rays of ``rays`` at the indices ``idx``."""
    import dataclasses

    return rays.replace(**{f.name: getattr(rays, f.name)[idx] for f in dataclasses.fields(rays)})


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
    bitwise = float((eq_steps & (sa == sb) & (d == 0))[live].mean())
    nan_status = sorted({int(s) for s in sb[live & nan_b]})
    if dtype == torch.float64:
        ok = status_rate > 0.99 and steps_rate > 0.99 and med_dr < 1e-10
    else:
        ok = status_rate > 0.98 and steps_rate > 0.98 and med_rel < 1e-5
    return dict(status_rate=status_rate, steps_rate=steps_rate, median_dr=med_dr,
                median_rel_dr=med_rel, max_abs_err=max_abs, bitwise_rate=bitwise,
                nan_r=int((live & (nan_a | nan_b)).sum()), nan_status=nan_status, ok=ok)


def parity_line(tag, p):
    return (f"parity {tag}: status {p['status_rate']:.5f} steps {p['steps_rate']:.5f} "
            f"median|dr| {p['median_dr']:.3e} median|dr|/r {p['median_rel_dr']:.3e} "
            f"max|dr| (equal status and steps) {p['max_abs_err']:.3e} "
            f"bitwise (status, steps, r) {p['bitwise_rate']:.5f} "
            f"non-finite r {p['nan_r']} (plain statuses {p['nan_status']})")


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

    from raytrace_tpu_torch.apps import emissivity, imageplane_disc_image
    from raytrace_tpu_torch.config import Config
    from raytrace_tpu_torch.io import read_fits
    from raytrace_tpu_torch.ops import kernel_steplim, march_kernel, trace
    from raytrace_tpu_torch.rays import RAY_STATUS_STEPLIM
    from raytrace_tpu_torch.sources import ImagePlaneGrid, PointSourceGrid

    with Phase("0 device"):
        name = torch.cuda.get_device_name(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"device: {name} | torch {torch.__version__} cuda {torch.version.cuda} "
              f"| devices {torch.cuda.device_count()}")
        print(f"nvidia-smi: {smi_line()}")
        print("tf32: matmul and cudnn TF32 off (nothing on the path uses them)")

    with Phase("1 build"):
        t0 = time.perf_counter()
        log = march_kernel.build(force=True)
        march_kernel.load()
        print(f"build: nvcc sm_90a in {time.perf_counter() - t0:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas: {line.strip()}")

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

    launches = {}
    full_parity = {}
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
        # it, with the par file's (unrounded) spin and kernel_steplim
        rays = lamppost(par["grid"], torch.float32, spin=par["spin"],
                        source=par["source"], V=par["V"])
        live = (rays.steps == 0).cpu().numpy()
        for method in ("rk45", "rk4"):
            steplim = kernel_steplim(method)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = march_kernel.trace_kernel(rays, par["spin"], method=method, steplim=steplim)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            b = trace(rays, par["spin"], method=method, steplim=steplim)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            p = parity(a, b, live, torch.float32, torch)
            tag = f"full_{method}_f32"
            print(parity_line(tag, p) + f" | {int(live.sum())} live rays, steplim {steplim}, "
                  f"kernel {t1 - t0:.3f} s, plain {t2 - t1:.3f} s (host clock)")
            check(p["ok"], f"parity gates failed for {tag}: {p}")
            full_parity[method] = p
        del rays, a, b

    timing = {}
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
            k_ms, _ = cuda_ms(lambda: march_kernel.trace_kernel(
                small, SPIN, method=method, steplim=steplim), torch)
            p_ms, _ = cuda_ms(lambda: trace(small, SPIN, method=method, steplim=steplim), torch)
            print(f"kernel vs plain {method} f32 (5,040 rays, steplim {steplim}): "
                  f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, ratio {p_ms / k_ms:.1f}x")
            timing[method] = (k_ms, p_ms)

    with Phase("6 image parity"):
        isco_grid = ImagePlaneGrid.from_steps(-20.0, 20.0, 40.0 / 81, -20.0, 20.0, 40.0 / 81)
        for dtype in (torch.float32, torch.float64):
            rays = image_rays(isco_grid, dtype, torch)
            live = np.ones(isco_grid.n_rays, dtype=bool)
            for method, kind in IMAGE_VARIANTS:
                kw = dict(method=method, dest=image_dest(kind, 20.0), steplim=3000, r_max=550.0)
                a = march_kernel.trace_kernel(rays, -SPIN, march_dtype=dtype, **kw)
                torch.cuda.synchronize()
                b = trace(rays, -SPIN, **kw)
                torch.cuda.synchronize()
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
                print(f"full width {entry} {extra or ''} ({variant}): {n_image} rays, wall "
                      f"{wall:.3f} s, {n_image / wall:.4e} rays/s, DISCRAYS {n_disc}, "
                      f"{n_launch} kernel launch(es)")

        # the isco kernel against the plain march on the main path's own
        # batch. The plain march is launch-bound (~5 ms per lock-step
        # iteration at 251k and at 1M rays alike), and under kernel_steplim
        # (1e5) a few dozen stuck photon-sphere rays hold it for 125k
        # iterations; steplim 3000 caps it at 3,766 while every other ray
        # (99.99th percentile: ~2,000 steps) ends as on the main path
        full_grid = ImagePlaneGrid.from_steps(-30.0, 30.0, 60.0 / nx, -30.0, 30.0, 60.0 / nx)
        rays = image_rays(full_grid, torch.float32, torch, dist=1e4, incl=80.0)
        live = np.ones(full_grid.n_rays, dtype=bool)
        kw = dict(method="rk45", dest=image_dest("isco", 30.0), steplim=3000, r_max=1.1e4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = march_kernel.trace_kernel(rays, -SPIN, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        b = trace(rays, -SPIN, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        p = parity(a, b, live, torch.float32, torch)
        print(parity_line("full_rk45_isco_f32", p) + f" | {full_grid.n_rays} rays, steplim 3000, "
              f"kernel {t1 - t0:.3f} s, plain {t2 - t1:.3f} s (host clock)")
        check(p["ok"], f"parity gates failed for full_rk45_isco_f32: {p}")
        full_parity["rk45_isco"] = p

        # euler x theta and rk4 x isco at the main path's own kernel_steplim:
        # no ray of this batch sticks with these methods (at most ~1,940
        # steps), so the plain march ends with the slowest ray, ~10 s each
        for method, kind in (("euler", "theta"), ("rk4", "isco")):
            steplim = kernel_steplim(method)
            kw = dict(method=method, dest=image_dest(kind, 30.0), steplim=steplim, r_max=1.1e4)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = march_kernel.trace_kernel(rays, -SPIN, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            b = trace(rays, -SPIN, **kw)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            p = parity(a, b, live, torch.float32, torch)
            tag = f"full_{method}_{kind}_f32"
            print(parity_line(tag, p) + f" | {full_grid.n_rays} rays, steplim {steplim}, "
                  f"kernel {t1 - t0:.3f} s, plain {t2 - t1:.3f} s (host clock)")
            check(p["ok"], f"parity gates failed for {tag}: {p}")
            full_parity[f"{method}_{kind}"] = p

        # the RK45 stuck-ray tail: the rays that run to kernel_steplim on the
        # main path, with their neighbours within two pixels, marched deeper
        # than above. kernel_steplim itself would hold the plain march for
        # ~125k launch-bound iterations (~11 min), so the cap is STUCK_STEPLIM
        kw = dict(method="rk45", dest=image_dest("isco", 30.0), r_max=1.1e4)
        a = march_kernel.trace_kernel(rays, -SPIN, steplim=kernel_steplim("rk45"), **kw)
        stuck = ((a.status & RAY_STATUS_STEPLIM) != 0).nonzero().flatten().cpu()
        ny = full_grid.ny
        win = torch.arange(-2, 3)
        ix = (stuck // ny)[:, None, None] + win[None, :, None]
        iy = (stuck % ny)[:, None, None] + win[None, None, :]
        inside = (ix >= 0) & (ix < full_grid.nx) & (iy >= 0) & (iy < ny)
        idx = torch.unique((ix * ny + iy)[inside]).to("cuda")
        sub = take(rays, idx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = march_kernel.trace_kernel(sub, -SPIN, steplim=STUCK_STEPLIM, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        b = trace(sub, -SPIN, steplim=STUCK_STEPLIM, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        p = parity(a, b, np.ones(sub.n_rays, dtype=bool), torch.float32, torch)
        n_cap = int(((b.status & RAY_STATUS_STEPLIM) != 0).sum())
        print(parity_line("stuck_rk45_isco_f32", p) + f" | {len(stuck)} rays stuck at "
              f"kernel_steplim, {sub.n_rays} with neighbours, steplim {STUCK_STEPLIM} "
              f"({n_cap} reach it in the plain march), kernel {t1 - t0:.3f} s, "
              f"plain {t2 - t1:.3f} s (host clock)")
        check(len(stuck) > 0 and n_cap >= len(stuck), "stuck rays did not reach the cap")
        check(p["ok"], f"parity gates failed for stuck_rk45_isco_f32: {p}")
        del rays, sub, a, b

    with Phase("9 image timing"):
        rays = image_rays(isco_grid, torch.float32, torch)
        for method, kind in IMAGE_VARIANTS:
            kw = dict(method=method, dest=image_dest(kind, 20.0), steplim=3000, r_max=550.0)
            k_ms, _ = cuda_ms(lambda: march_kernel.trace_kernel(rays, -SPIN, **kw), torch)
            # the plain march (seconds a run) once: phase 6 ran it on this batch
            p_ms, _ = cuda_ms(lambda: trace(rays, -SPIN, **kw), torch, repeats=1, warmup=False)
            print(f"kernel vs plain {method}/{kind} f32 (82 x 82 image-plane rays, steplim 3000): "
                  f"kernel {k_ms:.3f} ms (best of 3), plain {p_ms:.3f} ms (one run), "
                  f"ratio {p_ms / k_ms:.1f}x")
            timing[f"{method}_{kind}"] = (k_ms, p_ms)
        rays = image_rays(full_grid, torch.float32, torch, dist=1e4, incl=80.0)
        for method, kind in IMAGE_VARIANTS + (("rk45", "theta"),):
            kw = dict(method=method, dest=image_dest(kind, 30.0), steplim=kernel_steplim(method),
                      r_max=1.1e4)
            ms, out = cuda_ms(lambda: march_kernel.trace_kernel(rays, -SPIN, **kw), torch)
            steps = np.abs(out.steps.cpu().numpy())
            print(f"kernel {method}/{kind} f32 at full width ({full_grid.n_rays} rays): {ms:.3f} ms, "
                  f"steps median {np.median(steps):.0f} max {steps.max()}")
        del rays

    print(f"nvidia-smi: {smi_line()}")
    # (name, variant key, where its max_abs_err was measured)
    records = [
        ("geodesic_march_rk45_f32", "rk45_theta", full_parity["rk45"]),
        ("geodesic_march_rk4_f32", "rk4_theta", full_parity["rk4"]),
        ("geodesic_march_euler_f32", "euler_theta", full_parity["euler_theta"]),
        ("geodesic_march_rk4_isco_f32", "rk4_isco", full_parity["rk4_isco"]),
        ("geodesic_march_rk45_isco_f32", "rk45_isco", full_parity["rk45_isco"]),
    ]
    timing_key = {"rk45_theta": "rk45", "rk4_theta": "rk4"}
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCE_FILE,
            "replaces": REPLACES,
            "launches": launches[variant],
            "max_abs_err": p["max_abs_err"],
            "ms": timing[timing_key.get(variant, variant)][0],
            "plain_ms": timing[timing_key.get(variant, variant)][1],
        }
        for name, variant, p in records
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
