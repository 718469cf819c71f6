"""Trajectory recording: the per-step ray-path dump.

Counterpart of ``raytrace_tpu/ops/history.py``. The reference writes
trajectories from inside its propagators (per-ray file writes every
write_step steps within a radius window, raytracer.cpp:293-312); here the
whole batch marches in lock-step, uncompacted, and a snapshot of every ray
goes into a preallocated ``[n_snapshots, 5, N]`` tensor every
``write_step`` iterations. The radius window and the stop after leaving it
are applied on the host when the trajectories are written.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from raytrace_tpu_torch.destinations import ThetaLimit
from raytrace_tpu_torch.geometry.kerr import bl_to_cartesian, horizon_radius
from raytrace_tpu_torch.ops import integrate
from raytrace_tpu_torch.ops.integrate import (
    StepControl,
    _capture,
    _capture_radius,
    _euler_rk4_body,
    _rk45_body,
    _seed_rk45_rates,
    _seed_rk45_step,
)
from raytrace_tpu_torch.rays import RayBatch


def _snapshot(st: RayBatch) -> torch.Tensor:
    return torch.stack([st.t, st.r, st.theta, st.phi, st.active.to(st.r.dtype)])


def trace_with_history(
    rays: RayBatch,
    spin,
    *,
    method: str = "euler",
    dest=None,
    r_max=100.0,
    write_step: int = 10,
    n_snapshots: int = 512,
    ctrl: StepControl = StepControl(),
    boundary=None,
):
    """March the batch recording (t, r, theta, phi, active) snapshots.

    Runs up to n_snapshots * write_step lock-step iterations over the whole
    batch, in its dtype on its device, and records a snapshot after every
    write_step of them. Returns (final_rays, history), history of shape
    [n_snapshots, 5, N]. Once no ray is active the march stops and the
    remaining snapshots repeat the frozen final state with the flag 0:
    the tensor the JAX function's fixed-length scan gives.
    """
    if method not in ("euler", "rk4", "rk45"):
        raise ValueError(f"unknown method {method!r}")
    if dest is None:
        dest = ThetaLimit(math.pi / 2)
    horizon = horizon_radius(spin) if boundary is None else boundary
    steplim = n_snapshots * write_step + 1
    r_max = float(r_max)
    capture = _capture_radius(horizon, ctrl.horizon_eps, rays.r)

    st = rays.replace(
        r_was_positive=torch.zeros_like(rays.r_was_positive),
        theta_was_positive=torch.ones_like(rays.theta_was_positive),
    )
    if method == "rk45":
        st = st.replace(dt=_seed_rk45_step(st, spin, horizon, ctrl))
        rates = _seed_rk45_rates(st, st.active, spin)
    else:
        rates = None
    step = st.dt

    def advance(st, step, rates):
        if method == "rk45":
            return _rk45_body(st, spin, horizon, capture, dest, r_max, steplim, ctrl,
                              st.active, step, rates)
        return (_euler_rk4_body(st, spin, horizon, capture, dest, r_max, steplim, ctrl,
                                method, st.active), step, rates)

    history = torch.empty((n_snapshots, 5, rays.n_rays), dtype=rays.r.dtype,
                          device=rays.r.device)
    replay = None
    done = 0
    while done < n_snapshots and bool(st.active.any()):
        for _ in range(write_step):
            if replay is not None:
                replay.replay()
            else:
                st, step, rates = advance(st, step, rates)
                if st.r.is_cuda and integrate._CUDA_GRAPHS:
                    (st, step, rates), replay = _capture(advance, st, step, rates)
        history[done] = _snapshot(st)
        done += 1
    if done < n_snapshots:
        # no ray is active: every later iteration leaves the batch as it is
        history[done:] = _snapshot(st)
    return st.replace(dt=step.clone()), history


def dump_trajectories(filename: str, rays_in: RayBatch, history, spin, write_rmax=-1.0,
                      write_rmin=-1.0, cartesian: bool = True, precision: int = 6,
                      width: int = 15):
    """Write the recorded trajectories in the reference text format: one
    ``t x y z`` (or ``t r theta phi``) row a snapshot, rays separated by
    two blank lines, restricted to the radius window, a ray's recording
    stopping once it leaves the window after having entered it
    (raytracer.cpp:293-312). Live rays (steps >= 0) only; the Cartesian
    coordinates are computed once for all snapshots, in float64."""
    hist = torch.as_tensor(history).detach().to(device="cpu", dtype=torch.float64)
    t, r, theta, phi, active = (hist[:, i, :].numpy() for i in range(5))
    if cartesian:
        x, y, z = (c.numpy() for c in bl_to_cartesian(hist[:, 1], hist[:, 2], hist[:, 3], spin))
        cols = (t, x, y, z)
    else:
        cols = (t, r, theta, phi)
    live = rays_in.steps.cpu().numpy() >= 0
    in_window = np.ones(r.shape, dtype=bool)
    if write_rmax >= 0:
        in_window &= r < write_rmax
    if write_rmin >= 0:
        in_window &= r > write_rmin
    fmt = f"{{:>{width}.{precision}e}}"
    with open(filename, "w") as f:
        for ray in np.flatnonzero(live):
            started = False
            for s in range(hist.shape[0]):
                if active[s, ray] == 0 and s > 0 and active[s - 1, ray] == 0:
                    break  # the ray finished: no more snapshots
                if in_window[s, ray]:
                    started = True
                    f.write(" ".join(fmt.format(float(c[s, ray])) for c in cols) + "\n")
                elif started:
                    break
            f.write("\n\n")
