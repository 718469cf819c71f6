"""Ray termination surfaces and their observer velocity fields.

Counterpart of ``raytrace_tpu/destinations.py``: ``ThetaLimit`` (alias
``FlatDisc``), the reference's plain ``thetalim`` mode (raytracer.cpp:172) —
theta_lim > 0 stops at theta >= theta_lim, theta_lim < 0 stops at
theta <= |theta_lim|, theta_lim == 0 never stops on theta — and the
crossing-aware annulus ``DiscWithISCO``. Parameters are Python floats. The
``FlatPlane``, ``SphericalShell`` and ``RadialVelocityField`` surfaces are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from raytrace_tpu_torch.geometry.kerr import keplerian_omega, metric_coeffs


def _keplerian_four_velocity(r, theta, spin, V=None):
    """Circular-orbit 4-velocity at angular velocity V (Keplerian if None),
    as RayDestination<T>::four_velocity (ray_destination.h:59-78)."""
    g = metric_coeffs(r, theta, spin)
    if V is None:
        V = keplerian_omega(r, spin)
    dv = V - g.omega
    gamma = 1.0 / torch.sqrt(1.0 - dv * dv * g.e2psi / g.e2nu)
    ut = gamma / torch.sqrt(g.e2nu)
    zero = torch.zeros_like(ut)
    return (ut, zero, zero, gamma * V / torch.sqrt(g.e2nu))


def _theta_step_limit(tl, theta, ptheta):
    """Parameter distance to the theta = |tl| surface along ptheta; +inf
    where the ray is not closing in on it (ray_destination.h:55-57)."""
    inf = torch.full_like(ptheta, math.inf)
    safe = torch.where(ptheta == 0, torch.ones_like(ptheta), ptheta)
    if tl > 0:
        return torch.where((ptheta > 0) & (theta < tl), (tl - theta) / safe, inf)
    if tl < 0:
        return torch.where((ptheta < 0) & (theta > -tl), (-tl - theta) / safe, inf)
    return inf


class Destination:
    """Base of the surfaces: ``reached(r, theta, phi, prev_theta)`` after
    every step, ``step_limit(r, theta, phi, pr, ptheta, pphi)`` before it,
    and the 4-velocity of the material at the surface for redshifts —
    Keplerian circular orbits unless a surface says otherwise."""

    def four_velocity(self, r, theta, phi, spin):
        return _keplerian_four_velocity(r, theta, spin)


@dataclasses.dataclass(frozen=True)
class ThetaLimit(Destination):
    """Stop on a polar-angle limit — the reference's thetalim mode and its
    FlatDiscDestination (ray_destination.h:85-102) in one."""

    theta_lim: float = math.pi / 2

    def reached(self, r, theta, phi, prev_theta):
        tl = self.theta_lim
        if tl > 0:
            return theta >= tl
        if tl < 0:
            return theta <= -tl
        return torch.zeros_like(theta, dtype=torch.bool)

    def step_limit(self, r, theta, phi, pr, ptheta, pphi):
        return _theta_step_limit(self.theta_lim, theta, ptheta)


# The reference exposes FlatDiscDestination(theta_lim) with identical
# semantics to the thetalim mode.
FlatDisc = ThetaLimit


@dataclasses.dataclass(frozen=True)
class DiscWithISCO(Destination):
    """Equatorial annulus r in [r_isco, r_out] (r_out <= 0: no outer edge);
    rays inside the ISCO or beyond r_out pass through
    (ray_destination.h:115-152). Crossing-aware: a ray stops only when theta
    crossed |theta_lim| since the previous step, from either side;
    theta_lim == 0 never stops."""

    r_isco: float
    r_out: float = -1.0
    theta_lim: float = math.pi / 2

    def _in_annulus(self, r):
        inside = r >= self.r_isco
        if self.r_out <= 0:
            return inside
        return inside & (r <= self.r_out)

    def reached(self, r, theta, phi, prev_theta):
        if self.theta_lim == 0:
            return torch.zeros_like(theta, dtype=torch.bool)
        lim = abs(self.theta_lim)
        crossed = ((prev_theta < lim) & (theta >= lim)) | ((prev_theta > lim) & (theta <= lim))
        return self._in_annulus(r) & crossed

    def step_limit(self, r, theta, phi, pr, ptheta, pphi):
        """The ThetaLimit clamp, applied only where the step starts inside
        the annulus."""
        lim = _theta_step_limit(self.theta_lim, theta, ptheta)
        return torch.where(self._in_annulus(r), lim, torch.full_like(lim, math.inf))
