"""GR redshift: emitted and received photon energies in observer frames.

Counterpart of ``raytrace_tpu/ops/redshift.py`` (reference
raytracer.cpp:342-622). Backward-traced image planes march with the negated
spin, so these functions take the *trace* spin and a ``reverse`` flag:
where the reference flips back to the physical spin for the metric and the
tetrad it does so here too, and the photon's spatial momentum is reversed
before the frame projection (raytracer.cpp:367,409,488,541-544). The
``projradius`` option and the radially moving receiver (``motion = 1``) are
not ported yet.
"""

from __future__ import annotations

import math

import torch

from raytrace_tpu_torch.geometry.kerr import metric_coeffs, metric_dot, momentum_from_consts
from raytrace_tpu_torch.rays import RAY_STATUS_DEST, RAY_STATUS_RLIM, RayBatch


def _sanitize(rays: RayBatch) -> RayBatch:
    """Evaluate redshift quantities at a benign point for rays whose result
    is meaningless anyway (dead padding, horizon captures, stuck rays);
    untraced batches keep their source state."""
    meaningful = ((rays.steps > 0) & ((rays.status & (RAY_STATUS_DEST | RAY_STATUS_RLIM)) != 0)) | (
        rays.steps == 0
    )
    one = torch.ones_like(rays.k)
    return rays.replace(
        r=torch.where(meaningful, rays.r, 10.0 * one),
        theta=torch.where(meaningful, rays.theta, one),
        k=torch.where(meaningful, rays.k, one),
        h=torch.where(meaningful, rays.h, 0.0 * one),
        Q=torch.where(meaningful, rays.Q, one),
    )


def _orbit_et(r, theta, a, V):
    """Timelike tetrad leg of an observer orbiting at Omega = V; the
    Lorentz-factor argument is floored at the dtype's tiny where the orbit
    would be spacelike (those rays are masked out downstream)."""
    g = metric_coeffs(r, theta, a)
    dv = V - g.omega
    arg = 1.0 - dv * dv * g.e2psi / g.e2nu
    gamma = 1.0 / torch.sqrt(torch.clamp_min(arg, torch.finfo(arg.dtype).tiny))
    ut = gamma / torch.sqrt(g.e2nu)
    zero = torch.zeros_like(ut)
    return g, (ut, zero, zero, ut * V)


def _energy_in_frame(rays: RayBatch, spin, et, g, reverse: bool):
    """E = g_munu et^mu p^nu with the momentum re-derived from the constants
    at the ray's position (trace spin), spatial components reversed when
    tracing backwards."""
    pt, pr, ptheta, pphi = momentum_from_consts(
        rays.r, rays.theta, rays.k, rays.h, rays.Q, rays.rdot_sign, rays.thetadot_sign, spin
    )
    if reverse:
        pr, ptheta, pphi = -pr, -ptheta, -pphi
    return metric_dot(g, et, (pt, pr, ptheta, pphi))


def _resolve_V(V, a, r):
    """V = -1 selects the Keplerian orbit at the ray's radius
    (raytracer.cpp:391-394)."""
    kepler = 1.0 / (a + r * torch.sqrt(r))
    V = torch.as_tensor(V, dtype=r.dtype, device=r.device)
    return torch.where(V == -1, kepler, V)


def _frame_energy(rays: RayBatch, spin, V, reverse: bool):
    """Photon energy in the frame of an observer at each ray's position
    orbiting at Omega = V (V = -1 Keplerian). Reversed, the metric and the
    observer take the physical spin -spin, the momentum the trace spin."""
    a = -spin if reverse else spin
    rs = _sanitize(rays)
    g, et = _orbit_et(rs.r, rs.theta, a, _resolve_V(V, a, rs.r))
    return _energy_in_frame(rs, spin, et, g, reverse)


def _ratio(emit, recv, reverse: bool):
    """emit/recv, or recv/emit when traced backwards."""
    return recv / emit if reverse else emit / recv


def redshift_start(rays: RayBatch, spin, V, reverse: bool = False) -> RayBatch:
    """Store each ray's emitted energy in the frame of material at its
    initial position orbiting at Omega = V (raytracer.cpp:342-417). Call
    before the march; for image planes pass the trace spin and
    ``reverse=True``."""
    return rays.replace(emit=_frame_energy(rays, spin, V, reverse))


def ray_redshift(rays: RayBatch, spin, V=-1.0, reverse: bool = False):
    """Redshift emit/recv (recv/emit when reversed) at the ray endpoints
    for a receiver orbiting azimuthally at Omega = V (V = -1 Keplerian)."""
    return _ratio(rays.emit, _frame_energy(rays, spin, V, reverse), reverse)


def ray_redshift_dest(rays: RayBatch, spin, dest, reverse: bool = False):
    """Redshift against the destination's 4-velocity field
    (raytracer.cpp:450-477,556-600). The reference evaluates the metric and
    the observer with the *trace* spin here, reversed or not; so does this."""
    rs = _sanitize(rays)
    et = dest.four_velocity(rs.r, rs.theta, rs.phi, spin)
    g = metric_coeffs(rs.r, rs.theta, spin)
    return _ratio(rays.emit, _energy_in_frame(rs, spin, et, g, reverse), reverse)


def apply_redshift(rays: RayBatch, spin, V=-1.0, reverse: bool = False) -> RayBatch:
    return rays.replace(redshift=ray_redshift(rays, spin, V, reverse))


def apply_redshift_dest(rays: RayBatch, spin, dest, reverse: bool = False) -> RayBatch:
    return rays.replace(redshift=ray_redshift_dest(rays, spin, dest, reverse))


def range_phi(rays: RayBatch, lo=-math.pi, hi=math.pi) -> RayBatch:
    """Wrap phi into [lo, hi), skipping NaN/huge values and failed rays
    (raytracer.cpp:603-622)."""
    span = hi - lo
    wrapped = rays.phi - span * torch.floor((rays.phi - lo) / span)
    ok = (torch.abs(rays.phi) <= 1000) & torch.isfinite(rays.phi) & (rays.steps > 0)
    return rays.replace(phi=torch.where(ok, wrapped, rays.phi))
