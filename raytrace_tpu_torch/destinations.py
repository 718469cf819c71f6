"""Ray termination surfaces and their observer velocity fields.

Counterpart of ``raytrace_tpu/destinations.py`` for the emissivity path:
``ThetaLimit`` (alias ``FlatDisc``), the reference's plain ``thetalim`` mode
(raytracer.cpp:172) — theta_lim > 0 stops at theta >= theta_lim,
theta_lim < 0 stops at theta <= |theta_lim|, theta_lim == 0 never stops on
theta. ``theta_lim`` is a Python float. The other surfaces are not ported yet.
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


@dataclasses.dataclass(frozen=True)
class ThetaLimit:
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
        """Parameter distance to the surface along ptheta; +inf where the ray
        is not closing in on it (ray_destination.h:55-57)."""
        tl = self.theta_lim
        inf = torch.full_like(ptheta, math.inf)
        safe = torch.where(ptheta == 0, torch.ones_like(ptheta), ptheta)
        if tl > 0:
            return torch.where((ptheta > 0) & (theta < tl), (tl - theta) / safe, inf)
        if tl < 0:
            return torch.where((ptheta < 0) & (theta > -tl), (-tl - theta) / safe, inf)
        return inf


# The reference exposes FlatDiscDestination(theta_lim) with identical
# semantics to the thetalim mode.
FlatDisc = ThetaLimit
