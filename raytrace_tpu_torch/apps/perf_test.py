"""Integrator performance harness.

Counterpart of ``raytrace_tpu/apps/perf_test.py`` (reference
``src/tests/integrator_perf_test.cpp``): for each integrator on the
canonical lamppost workload (spin 0.998, source r = 5, theta = 1e-3,
integrator_perf_test.cpp:35-44) report

  * the wall time of the march alone (best of ``repeats`` after a warm-up
    run, the device synchronised by reading the result back),
  * step-count percentiles over completed rays (median / p90 / p99 / max),
  * estimated ODE function evaluations (1 per Euler step, 4 per RK4 step,
    6 per accepted DOPRI5 step, integrator_perf_test.cpp:49-50),
  * an ASCII log-binned step histogram (integrator_perf_test.cpp:119-169),
  * throughput in steps/s,
  * for rk45, the rejected-trial share (``ops/diagnostics.py``).

On the card the batch is cast to float32 and marched through ``trace_auto``,
that is by the march kernel (euler, rk4 or rk45 towards the disc plane); the
rejected trials are counted by the plain float32 DOPRI5 march of the same
batch, which the kernel follows bit for bit. With ``--device=cpu`` both run
the plain march in float64.

Par keys (all optional): spin, source (t r theta phi), dcosalpha, dbeta,
r_max, steplim, methods (space-separated subset of euler rk4 rk45), repeats,
rejects.

    python -m raytrace_tpu_torch.apps.perf_test --parfile=par_example/perf_test.par
        [--device=cuda|cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from raytrace_tpu_torch.apps import app_device, require_device
from raytrace_tpu_torch.config import Config
from raytrace_tpu_torch.ops import StepControl, trace_auto
from raytrace_tpu_torch.ops.diagnostics import rk45_reject_stats
from raytrace_tpu_torch.rays import RAY_STATUS_STEPLIM
from raytrace_tpu_torch.sources import PointSourceGrid, point_source

_FEVALS = {"euler": 1, "rk4": 4, "rk45": 6}


def march_batch(rays):
    """The batch as the harness marches it: float32 on the card (the march
    kernel's precision), unchanged on the CPU."""
    return rays.to(dtype=torch.float32) if rays.r.is_cuda else rays


def run_method(rays, spin, method, *, r_max, steplim, ctrl, repeats=1):
    """Time one integrator on ``march_batch(rays)``; returns a stats dict."""
    rays = march_batch(rays)

    def run():
        return trace_auto(rays, spin, method=method, r_max=r_max, steplim=steplim, ctrl=ctrl)

    out = run()
    _ = float(out.r.sum())  # warm-up; reading the sum waits for the device

    best = np.inf
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        out = run()
        _ = float(out.r.sum())
        best = min(best, time.perf_counter() - t0)

    live = rays.steps.cpu().numpy() >= 0
    steps = np.abs(out.steps.cpu().numpy()).astype(np.int64)[live]
    stuck = (out.status.cpu().numpy()[live] & RAY_STATUS_STEPLIM) != 0
    done = steps[~stuck]
    useful = int(done.sum())
    return {
        "method": method,
        "wall_s": best,
        "n_rays": int(live.sum()),
        "n_stuck": int(stuck.sum()),
        "steps_total": useful,
        "steps_per_s": useful / best,
        "median": float(np.median(done)) if done.size else 0.0,
        "p90": float(np.percentile(done, 90)) if done.size else 0.0,
        "p99": float(np.percentile(done, 99)) if done.size else 0.0,
        "max": int(done.max()) if done.size else 0,
        "fevals": useful * _FEVALS[method],
        "steps": steps,
    }


def step_histogram(steps, width=60, n_bins=12):
    """ASCII log-binned step histogram (integrator_perf_test.cpp:119-169)."""
    steps = steps[steps > 0]
    if steps.size == 0:
        return ["  (no completed rays)"]
    lo, hi = steps.min(), steps.max()
    edges = np.unique(np.geomspace(max(lo, 1), hi + 1, n_bins + 1).astype(np.int64))
    counts, _ = np.histogram(steps, bins=edges)
    peak = max(1, counts.max())
    lines = []
    for i, c in enumerate(counts):
        bar = "#" * max(0, int(round(width * c / peak)))
        lines.append(f"  {edges[i]:>8d}-{edges[i+1]-1:<8d} |{bar} {c}")
    return lines


def main(argv=None):
    cfg = Config(argv)
    spin = cfg.get("spin", float, 0.998)
    source = (cfg.get_array("source", float, 4)
              if cfg.key_exists("source") else [0.0, 5.0, 1e-3, 0.0])
    dca = cfg.get("dcosalpha", float, 0.05)
    db = cfg.get("dbeta", float, 0.05)
    r_max = cfg.get("r_max", float, 1000.0)
    steplim = cfg.get("steplim", int, 30_000)
    repeats = cfg.get("repeats", int, 1)
    methods = cfg.get("methods", str, "euler rk4 rk45").split()
    device = require_device(app_device(cfg))

    grid = PointSourceGrid.from_steps(dca, db)
    rays = march_batch(point_source(tuple(source), V=0.0, spin=spin, grid=grid, device=device))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"integrator perf test: {grid.n_rays} rays, spin {spin}, "
          f"source r = {source[1]}, device {name}, {rays.r.dtype}")

    ctrl = StepControl()
    results = []
    for m in methods:
        st = run_method(rays, spin, m, r_max=r_max, steplim=steplim, ctrl=ctrl, repeats=repeats)
        results.append(st)
        print(f"\n== {m} ==")
        print(f"  propagation wall time   {st['wall_s']*1e3:10.1f} ms"
              f"  ({st['n_rays']} rays, {st['n_stuck']} stuck)")
        print(f"  steps total / per s     {st['steps_total']:>10d} /"
              f" {st['steps_per_s']:.3e}")
        print(f"  steps median/p90/p99/max  {st['median']:.0f} /"
              f" {st['p90']:.0f} / {st['p99']:.0f} / {st['max']}")
        print(f"  est. function evals     {st['fevals']:>10d}")
        if m == "rk45" and cfg.get("rejects", bool, True):
            # trials the controller refused: full 7-stage evaluations that
            # advanced nothing (the step histogram's adaptive-path sibling)
            rj = rk45_reject_stats(rays, spin, r_max=r_max, n_steps=8192, ctrl=ctrl)
            print(f"  reject fraction p50/p90/p99/mean  "
                  f"{rj['reject_frac_p50']:.3f} / {rj['reject_frac_p90']:.3f}"
                  f" / {rj['reject_frac_p99']:.3f} / {rj['reject_frac_mean']:.3f}"
                  f"  ({rj['rejects_total']} of {rj['trials_total']} trials,"
                  f" {rj['n_unfinished']} unfinished)")
        print("  step histogram:")
        for line in step_histogram(st["steps"]):
            print(line)

    if len(results) > 1:
        base = results[0]
        print("\n== ratios vs", base["method"], "==")
        for st in results[1:]:
            print(f"  {st['method']}: wall {st['wall_s']/base['wall_s']:.2f}x,"
                  f" fevals {st['fevals']/max(1, base['fevals']):.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
