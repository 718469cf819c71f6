"""RK45 accept/reject accounting.

Counterpart of ``raytrace_tpu/ops/diagnostics.py``. A lock-step DOPRI5
lane spends some iterations re-trying a step the error controller refused:
a full 7-stage evaluation that advances nothing. Step counts cannot show
these rejected trials; this counts them per lane, so the RK4 to RK45
throughput ratio splits into stage count and rejection waste.

The plain DOPRI5 body (``ops/integrate.py::_rk45_body``) marches the batch
for a fixed number of lock-step iterations on its own device
(``_march``: compaction, CUDA-graph epochs on the card) with one more
per-lane counter of active iterations in its carry. The body counts
``steps`` only on accepted steps and polar flips, so per lane ``rejects =
trials - (|steps_final| - |steps_initial|)``. The march kernel marches a
float32 batch bit for bit as this plain march does, so on a float32 batch
on the card these are the kernel's own trials.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from raytrace_tpu_torch.destinations import ThetaLimit
from raytrace_tpu_torch.geometry.kerr import horizon_radius
from raytrace_tpu_torch.ops.integrate import (
    StepControl,
    _capture_radius,
    _march,
    _rk45_body,
    _seed_rk45_rates,
    _seed_rk45_step,
)
from raytrace_tpu_torch.rays import RayBatch


def _march_with_trials(rays: RayBatch, spin, r_max: float, n_steps: int, ctrl: StepControl):
    """``n_steps`` lock-step DOPRI5 iterations towards ThetaLimit(pi/2);
    returns the final batch and each lane's count of active iterations."""
    dest = ThetaLimit(math.pi / 2)
    horizon = horizon_radius(spin)
    capture = _capture_radius(horizon, ctrl.horizon_eps, rays.r)
    steplim = n_steps + 1
    rays = rays.replace(
        r_was_positive=torch.zeros_like(rays.r_was_positive),
        theta_was_positive=torch.ones_like(rays.theta_was_positive),
    )
    rays = rays.replace(dt=_seed_rk45_step(rays, spin, horizon, ctrl))

    def advance(st, step, carry):
        *rates, trials = carry
        a = st.active
        st, step, rates = _rk45_body(st, spin, horizon, capture, dest, r_max, steplim, ctrl, a,
                                     step, tuple(rates))
        return st, step, (*rates, trials + a.to(torch.int32))

    carry = (*_seed_rk45_rates(rays, rays.active, spin), torch.zeros_like(rays.steps))
    final, carry = _march(rays, rays.dt, carry, advance, n_steps)
    return final, carry[-1]


def rk45_reject_stats(rays: RayBatch, spin, *, r_max=1000.0, n_steps=8192,
                      ctrl: StepControl = StepControl()):
    """Per-lane trial and reject accounting over ``n_steps`` lock-step
    iterations of the plain DOPRI5 body, in the batch's dtype on its device.

    Returns a dict of statistics over the lanes that *finished* within the
    budget (a still-running photon-sphere lane's reject fraction would be
    that of its unfinished tail): p50/p90/p99/mean reject fraction, total
    trial and reject counts, and the number of unfinished lanes (excluded
    from the fractions, reported beside them).
    """
    live = rays.steps.cpu().numpy() == 0
    final, trials = _march_with_trials(rays, spin, float(r_max), int(n_steps), ctrl)
    trials = trials.cpu().numpy().astype(np.int64)
    moved = (np.abs(final.steps.cpu().numpy()).astype(np.int64)
             - np.abs(rays.steps.cpu().numpy()).astype(np.int64))
    rejects = trials - moved
    finished = live & ~final.active.cpu().numpy()
    n_fin = int(finished.sum())
    if n_fin:
        frac = rejects[finished] / np.maximum(trials[finished], 1)
        p50, p90, p99 = np.percentile(frac, [50, 90, 99])
        mean = float(frac.mean())
    else:
        p50 = p90 = p99 = mean = float("nan")
    return {
        "n_lanes": int(live.sum()),
        "n_finished": n_fin,
        "n_unfinished": int(live.sum()) - n_fin,
        "trials_total": int(trials[finished].sum()),
        "rejects_total": int(rejects[finished].sum()),
        "reject_frac_p50": round(float(p50), 4),
        "reject_frac_p90": round(float(p90), 4),
        "reject_frac_p99": round(float(p99), 4),
        "reject_frac_mean": round(mean, 4),
    }
