"""GR redshift: emitted and received photon energies in observer frames.

Counterpart of ``raytrace_tpu/ops/redshift.py`` (reference
raytracer.cpp:342-622). Backward-traced image planes march with the negated
spin, so these functions take the *trace* spin and a ``reverse`` flag:
where the reference flips back to the physical spin for the metric and the
tetrad it does so here too, and the photon's spatial momentum is reversed
before the frame projection (raytracer.cpp:367,409,488,541-544).
``projradius`` takes the Keplerian velocity at the radius projected on the
equatorial plane; ``motion = 1`` makes the receiver move radially.
"""

from __future__ import annotations

import math

import torch

from . import mathfn
from .kerr import metric_coeffs, metric_dot, momentum_from_consts
from .rays import RAY_STATUS_DEST, RAY_STATUS_RLIM, RayBatch


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
    gamma = 1.0 / mathfn.sqrt(torch.clamp_min(arg, torch.finfo(arg.dtype).tiny))
    ut = gamma / mathfn.sqrt(g.e2nu)
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


def _resolve_V(V, a, r, theta, projradius: bool):
    """V = -1 selects the Keplerian orbit at the ray's radius, or at the
    radius projected parallel to the equatorial plane with ``projradius``
    (raytracer.cpp:391-394)."""
    r_eff = r * mathfn.sin(theta) if projradius else r
    kepler = 1.0 / (a + r_eff * mathfn.sqrt(r_eff))
    V = torch.as_tensor(V, dtype=r.dtype, device=r.device)
    return torch.where(V == -1, kepler, V)


def _radial_et(r, theta, spin, a, V):
    """Metric and timelike leg of an observer moving radially at dr/dt = V
    (motion = 1, raytracer.cpp:528-535): V < 0 is |V| times the local
    coordinate speed of light, which the reference scales with the trace
    spin; u^t's argument is floored at the dtype's tiny where the frame is
    spacelike, as ``_orbit_et`` floors its own."""
    g = metric_coeffs(r, theta, a)
    V = torch.as_tensor(V, dtype=r.dtype, device=r.device)
    spd = (r * r - 2.0 * r + spin + spin) / (r * r + spin * spin)
    Vr = torch.where(V < 0, torch.abs(V) * spd, V)
    arg = g.g_tt + g.g_rr * Vr * Vr
    ut = 1.0 / mathfn.sqrt(torch.clamp_min(arg, torch.finfo(arg.dtype).tiny))
    zero = torch.zeros_like(ut)
    return g, (ut, Vr * ut, zero, zero)


def _frame_energy(rays: RayBatch, spin, V, reverse: bool, projradius: bool = False,
                  motion: int = 0):
    """Photon energy in the frame of an observer at each ray's position:
    orbiting at Omega = V (motion 0; V = -1 Keplerian) or moving radially at
    dr/dt = V (motion 1). Reversed, the metric and the observer take the
    physical spin -spin, the momentum the trace spin."""
    a = -spin if reverse else spin
    rs = _sanitize(rays)
    if motion == 0:
        g, et = _orbit_et(rs.r, rs.theta, a, _resolve_V(V, a, rs.r, rs.theta, projradius))
    else:
        g, et = _radial_et(rs.r, rs.theta, spin, a, V)
    return _energy_in_frame(rs, spin, et, g, reverse)


def _ratio(emit, recv, reverse: bool):
    """emit/recv, or recv/emit when traced backwards."""
    return recv / emit if reverse else emit / recv


def redshift_start(rays: RayBatch, spin, V, reverse: bool = False,
                   projradius: bool = False) -> RayBatch:
    """Store each ray's emitted energy in the frame of material at its
    initial position orbiting at Omega = V (raytracer.cpp:342-417). Call
    before the march; for image planes pass the trace spin and
    ``reverse=True``."""
    return rays.replace(emit=_frame_energy(rays, spin, V, reverse, projradius))


def ray_redshift(rays: RayBatch, spin, V=-1.0, reverse: bool = False,
                 projradius: bool = False, motion: int = 0):
    """Redshift emit/recv (recv/emit when reversed) at the ray endpoints.
    motion = 0: the receiver orbits azimuthally at Omega = V (V = -1
    Keplerian); motion = 1: it moves radially at dr/dt = V, V < 0 meaning
    |V| times the local coordinate speed of light (raytracer.cpp:528-535)."""
    return _ratio(rays.emit, _frame_energy(rays, spin, V, reverse, projradius, motion), reverse)


def apply_redshift(rays: RayBatch, spin, V=-1.0, reverse: bool = False,
                   projradius: bool = False, motion: int = 0) -> RayBatch:
    return rays.replace(redshift=ray_redshift(rays, spin, V, reverse, projradius, motion))


def range_phi(rays: RayBatch, lo=-math.pi, hi=math.pi) -> RayBatch:
    """Wrap phi into [lo, hi), skipping NaN/huge values and failed rays
    (raytracer.cpp:603-622)."""
    span = hi - lo
    wrapped = rays.phi - span * torch.floor((rays.phi - lo) / span)
    ok = (torch.abs(rays.phi) <= 1000) & torch.isfinite(rays.phi) & (rays.steps > 0)
    return rays.replace(phi=torch.where(ok, wrapped, rays.phi))
