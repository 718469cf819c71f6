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
     kernel against the plain march on the 0.05 grid.
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
REPLACES = "raytrace_tpu/ops/pallas_kernel.py:96"
SOURCE_FILE = "raytrace_tpu_torch/csrc/march.cu"
BENCH_STEPLIM = {"rk4": 30_000, "rk45": 40_000}


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


def cuda_ms(fn, torch, repeats=3):
    """Best of ``repeats`` CUDA-event times of fn() after one warm-up."""
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

    from raytrace_tpu_torch.apps import emissivity
    from raytrace_tpu_torch.config import Config
    from raytrace_tpu_torch.ops import kernel_steplim, march_kernel, trace
    from raytrace_tpu_torch.sources import PointSourceGrid

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
                launches[method] = march_kernel.launches
                check(rc == 0, f"emissivity main returned {rc}")
                check(launches[method] > 0, f"main path ({method}) never launched the kernel")
                prof = np.loadtxt(outfile)
                check(prof.shape == (100, 7), f"output shape {prof.shape}")
                full = prof[:, 2] >= 100
                check(full.sum() >= 12, f"only {int(full.sum())} bins with >= 100 rays")
                check(np.isfinite(prof[full, 4]).all(), "non-finite emissivity in populated bins")
                print(f"full size {method}: {n_rays} rays, wall {wall:.3f} s, "
                      f"{n_rays / wall:.4e} rays/s, {int(full.sum())} bins >= 100 rays, "
                      f"{launches[method]} kernel launch(es)")

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

    print(f"nvidia-smi: {smi_line()}")
    kernels = [
        {
            "name": f"geodesic_march_{method}_f32",
            "route": "cuda",
            "source": SOURCE_FILE,
            "replaces": REPLACES,
            "launches": launches[method],
            "max_abs_err": full_parity[method]["max_abs_err"],
            "ms": timing[method][0],
            "plain_ms": timing[method][1],
        }
        for method in ("rk45", "rk4")
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
