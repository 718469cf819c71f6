"""Ray termination surfaces and their observer velocity fields.

Counterpart of ``raytrace_tpu/destinations.py``: ``ThetaLimit`` (alias
``FlatDisc``), the reference's plain ``thetalim`` mode (raytracer.cpp:172) —
theta_lim > 0 stops at theta >= theta_lim, theta_lim < 0 stops at
theta <= |theta_lim|, theta_lim == 0 never stops on theta — the
crossing-aware annulus ``DiscWithISCO``, the caustic apps' source plane
``FlatPlane``, the far sphere ``SphericalShell`` and the never-stopping
``RadialVelocityField``. Parameters are Python floats. The march kernel
implements the four surfaces (``KERNEL_DESTINATIONS``);
``RadialVelocityField`` marches on the plain version.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from raytrace_tpu_torch import mathfn
from raytrace_tpu_torch.geometry.kerr import keplerian_omega, metric_coeffs


def _keplerian_four_velocity(r, theta, spin, V=None):
    """Circular-orbit 4-velocity at angular velocity V (Keplerian if None),
    as RayDestination<T>::four_velocity (ray_destination.h:59-78)."""
    g = metric_coeffs(r, theta, spin)
    if V is None:
        V = keplerian_omega(r, spin)
    dv = V - g.omega
    gamma = 1.0 / mathfn.sqrt(1.0 - dv * dv * g.e2psi / g.e2nu)
    ut = gamma / mathfn.sqrt(g.e2nu)
    zero = torch.zeros_like(ut)
    return (ut, zero, zero, gamma * V / mathfn.sqrt(g.e2nu))


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
    every step, ``step_limit(r, theta, phi, pr, ptheta, pphi)`` before it
    (+inf unless a surface caps the step, ray_destination.h:55-57), and the
    4-velocity of the material at the surface for redshifts — Keplerian
    circular orbits unless a surface says otherwise."""

    def step_limit(self, r, theta, phi, pr, ptheta, pphi):
        return torch.full_like(r, math.inf)

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


@dataclasses.dataclass(frozen=True)
class FlatPlane(Destination):
    """Flat lensing source plane perpendicular to the observer's line of
    sight, z_s gravitational radii behind the hole (ray_destination.h:172-204).

    The observer direction is n = (sin i cos phi0, sin i sin phi0, cos i) in
    spin-axis Cartesian coordinates; a ray stops where its signed projection
    along n drops to -z_s or below. sin i and cos i are taken once in double
    (``math``), so a float32 march rounds them once, as the CUDA kernel
    takes them; no step-size cap.
    """

    incl: float
    phi0: float = 0.0
    z_s: float = 100.0

    @property
    def sin_incl(self) -> float:
        return math.sin(self.incl)

    @property
    def cos_incl(self) -> float:
        return math.cos(self.incl)

    def projection(self, r, theta, phi):
        return r * (mathfn.sin(theta) * self.sin_incl * mathfn.cos(phi - self.phi0)
                    + mathfn.cos(theta) * self.cos_incl)

    def reached(self, r, theta, phi, prev_theta):
        return self.projection(r, theta, phi) <= -self.z_s

    def source_coords(self, r, theta, phi):
        """East/North Cartesian coordinates on the source plane, oriented as
        the image plane (ray_destination.h:195-203)."""
        X = r * mathfn.sin(theta) * mathfn.cos(phi)
        Y = r * mathfn.sin(theta) * mathfn.sin(phi)
        Z = r * mathfn.cos(theta)
        s0, c0 = math.sin(self.phi0), math.cos(self.phi0)
        x_s = -X * s0 + Y * c0
        y_s = -X * self.cos_incl * c0 - Y * self.cos_incl * s0 + Z * self.sin_incl
        return x_s, y_s


@dataclasses.dataclass(frozen=True)
class SphericalShell(Destination):
    """Stop on r >= r_shell, an explicit far sphere (the reference reaches
    it with thetalim = 0 and the rlim termination). The step is capped along
    pr where the ray climbs towards the shell from inside."""

    r_shell: float

    def reached(self, r, theta, phi, prev_theta):
        return r >= self.r_shell

    def step_limit(self, r, theta, phi, pr, ptheta, pphi):
        out = (pr > 0) & (r < self.r_shell)
        lim = (self.r_shell - r) / torch.where(pr == 0, torch.ones_like(pr), pr)
        return torch.where(out, lim, torch.full_like(pr, math.inf))


@dataclasses.dataclass(frozen=True)
class RadialVelocityField(Destination):
    """A destination that never stops a ray and carries a purely radial
    observer velocity field dr/dt = v, for the redshifts of radially moving
    material (the reference's motion = 1 mode, raytracer.cpp:528-535).
    v < 0 means |v| times the local coordinate speed of light, scaled as
    the reference scales it (with ``spin + spin`` where 2a is meant)."""

    v: float

    def reached(self, r, theta, phi, prev_theta):
        return torch.zeros_like(r, dtype=torch.bool)

    def four_velocity(self, r, theta, phi, spin):
        g = metric_coeffs(r, theta, spin)
        v = torch.full_like(r, self.v)
        v = torch.where(v < 0, torch.abs(v) * (r * r - 2.0 * r + spin + spin) / (r * r + spin * spin),
                        v)
        ut = 1.0 / mathfn.sqrt(g.g_tt + g.g_rr * v * v)
        zero = torch.zeros_like(ut)
        return (ut, v * ut, zero, zero)


# The surfaces the march kernel implements (csrc/march.cuh, DEST_*).
KERNEL_DESTINATIONS = (ThetaLimit, DiscWithISCO, FlatPlane, SphericalShell)
