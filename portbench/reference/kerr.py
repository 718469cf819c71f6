"""Kerr spacetime geometry in Boyer-Lindquist coordinates (G = M = c = 1).

Counterpart of ``raytrace_tpu/geometry/kerr.py`` for the lamppost-emissivity
path: plain functions on tensors that keep the dtype of their tensor inputs.
The spin ``a`` may be a Python float or a tensor. Op order and the
``finfo.tiny`` floors follow the JAX functions exactly, so f64 results agree
to rounding and the CUDA march kernel (``csrc/march.cuh``) mirrors the same
arithmetic.

Conventions: signature (+,-,-,-); coordinates (t, r, theta, phi); photon
constants of motion k = E, h = L_z and the Carter constant Q.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import mathfn


def horizon_radius(a, sign=1):
    """Event horizon radius r_+ = 1 + sqrt(1 - a^2) (kerr.h:13-20), for a
    Python-float or tensor spin."""
    if isinstance(a, torch.Tensor):
        return 1.0 + sign * mathfn.sqrt((1.0 - a) * (1.0 + a))
    return 1.0 + sign * math.sqrt((1.0 - a) * (1.0 + a))


def isco_radius(a, sign=1):
    """Innermost stable circular orbit radius (Bardeen, Press & Teukolsky
    1972); ``sign=+1`` prograde, ``-1`` retrograde (kerr.h:22-32).

    A Python-float spin gives a float. A tensor spin gives a tensor whose
    derivative, in reverse and forward mode, follows the JAX custom JVP
    (``_IscoRadius``): finite at a = 0, where the Bardeen expression's
    square root has an infinite derivative."""
    if isinstance(a, torch.Tensor):
        return _IscoRadius.apply(a, sign)
    cbrt = lambda x: float(np.cbrt(x))
    z1 = 1.0 + cbrt(1.0 - a * a) * (cbrt(1.0 + a) + cbrt(1.0 - a))
    z2 = math.sqrt(3.0 * a * a + z1 * z1)
    return 3.0 + z2 - sign * math.sqrt((3.0 - z1) * (3.0 + z1 + 2.0 * z2))


def _cbrt(x):
    """Real cube root with its sign (torch has no cbrt)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _isco_z12(a):
    z1 = 1.0 + _cbrt(1.0 - a * a) * (_cbrt(1.0 + a) + _cbrt(1.0 - a))
    z2 = mathfn.sqrt(3.0 * a * a + z1 * z1)
    return z1, z2


def _isco_tangent(a, da, sign):
    """d r_isco along the tangent ``da`` (linear in it), the rule of the JAX
    ``_isco_radius_jvp``: below |a| < eps^(1/4), u = 3 - z1 and its
    derivative come from their small-spin series (the exact u cancels
    catastrophically there), and the ratio's denominator is floored at
    sqrt(tiny), so the derivative is finite at a = 0 (0 there, the
    symmetric subgradient)."""
    z1, z2 = _isco_z12(a)
    c1, c2, c3 = _cbrt(1.0 - a * a), _cbrt(1.0 + a), _cbrt(1.0 - a)
    dcbrt = lambda c, dx: dx * ((1.0 / 3.0) * c ** -2)  # d cbrt(x) = dx / (3 cbrt(x)^2)
    dz1 = (dcbrt(c1, -2.0 * a * da) * (c2 + c3)
           + c1 * (dcbrt(c2, da) + dcbrt(c3, -da)))
    dz2 = (6.0 * a * da + 2.0 * z1 * dz1) * (0.5 / z2)

    a2 = a * a
    small = torch.abs(a) < torch.finfo(a.dtype).eps ** 0.25
    u = torch.where(small, (8.0 / 9.0) * a2 * (1.0 + (7.0 / 27.0) * a2), 3.0 - z1)
    du = torch.where(small, (16.0 / 9.0) * a * (1.0 + (14.0 / 27.0) * a2) * da, -dz1)
    v = 3.0 + z1 + 2.0 * z2
    t = mathfn.sqrt(u * v)
    floor = torch.finfo(a.dtype).tiny ** 0.5
    dt = (du * v + u * (2.0 * dz2 - du)) / (2.0 * torch.clamp_min(t, floor))
    return dz2 - sign * dt


class _IscoRadius(torch.autograd.Function):
    """``isco_radius`` of a tensor spin with the JAX custom JVP's derivative
    (``_isco_tangent``) in reverse mode (``backward``), forward mode
    (``jvp``) and under ``torch.func`` (``setup_context``, vmap rule)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, sign):
        z1, z2 = _isco_z12(a)
        return 3.0 + z2 - sign * mathfn.sqrt((3.0 - z1) * (3.0 + z1 + 2.0 * z2))

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, sign = inputs
        ctx.sign = sign
        ctx.save_for_backward(a)
        ctx.save_for_forward(a)

    @staticmethod
    def backward(ctx, grad):
        (a,) = ctx.saved_tensors
        return _isco_tangent(a, grad, ctx.sign), None

    @staticmethod
    def jvp(ctx, a_t, _sign_t):
        (a,) = ctx.saved_tensors
        return _isco_tangent(a, a_t, ctx.sign)


def keplerian_omega(r, a, sign=1):
    """Omega = 1 / (a + sign * r^{3/2}) of a circular equatorial orbit
    (kerr.h:34-38), for a Python-float or tensor radius."""
    root = mathfn.sqrt(r) if isinstance(r, torch.Tensor) else math.sqrt(r)
    return 1.0 / (a + sign * r * root)


def bl_to_cartesian(r, theta, phi, a):
    """Quasi-Cartesian coordinates of a Boyer-Lindquist point (kerr.h:40-56)."""
    rho = mathfn.sqrt(r * r + a * a) * mathfn.sin(theta)
    return rho * mathfn.cos(phi), rho * mathfn.sin(phi), r * mathfn.cos(theta)


class MetricCoeffs(NamedTuple):
    """Nonzero covariant Kerr metric components (kerr.h:93-124)."""

    g_tt: torch.Tensor
    g_tphi: torch.Tensor
    g_rr: torch.Tensor
    g_thth: torch.Tensor
    g_phph: torch.Tensor
    rhosq: torch.Tensor
    delta: torch.Tensor
    sigmasq: torch.Tensor
    e2nu: torch.Tensor
    e2psi: torch.Tensor
    omega: torch.Tensor


def metric_coeffs(r, theta, a) -> MetricCoeffs:
    """Covariant Kerr metric at (r, theta) for spin a (kerr.h:93-124)."""
    sin_t = mathfn.sin(theta)
    cos_t = mathfn.cos(theta)
    rhosq = r * r + (a * cos_t) * (a * cos_t)
    delta = r * r - 2.0 * r + a * a
    r2a2 = r * r + a * a
    sigmasq = r2a2 * r2a2 - a * a * delta * sin_t * sin_t
    e2nu = rhosq * delta / sigmasq
    e2psi = sigmasq * sin_t * sin_t / rhosq
    omega = 2.0 * a * r / sigmasq
    return MetricCoeffs(
        g_tt=e2nu - omega * omega * e2psi,
        g_tphi=omega * e2psi,
        g_rr=-rhosq / delta,
        g_thth=-rhosq,
        g_phph=-e2psi,
        rhosq=rhosq,
        delta=delta,
        sigmasq=sigmasq,
        e2nu=e2nu,
        e2psi=e2psi,
        omega=omega,
    )


def metric_dot(g: MetricCoeffs, u, v):
    """g_munu u^mu v^nu for 4-vectors given as (t, r, theta, phi) tuples (kerr.h:58-72)."""
    ut, ur, uth, uph = u
    vt, vr, vth, vph = v
    return (
        g.g_tt * ut * vt
        + g.g_tphi * (ut * vph + uph * vt)
        + g.g_rr * ur * vr
        + g.g_thth * uth * vth
        + g.g_phph * uph * vph
    )


class Tetrad(NamedTuple):
    """Orthonormal tetrad as (t, r, theta, phi) tuples: et, ephi, etheta, er."""

    et: tuple
    ephi: tuple
    etheta: tuple
    er: tuple


def orbit_tetrad(r, theta, a, V, g: MetricCoeffs | None = None) -> Tetrad:
    """Tetrad of an observer at (r, theta) orbiting at Omega = V (kerr.h:126-170)."""
    if g is None:
        g = metric_coeffs(r, theta, a)
    e2nu, e2psi, omega, rhosq, delta = g.e2nu, g.e2psi, g.omega, g.rhosq, g.delta
    dv = V - omega
    gamma = 1.0 / mathfn.sqrt(1.0 - dv * dv * e2psi / e2nu)
    inv_sqrt_e2nu = 1.0 / mathfn.sqrt(e2nu)
    zero = torch.zeros_like(gamma)

    et = (inv_sqrt_e2nu * gamma, zero, zero, inv_sqrt_e2nu * gamma * V)
    denom = mathfn.sqrt(e2nu - dv * dv * e2psi)
    e1t = dv * mathfn.sqrt(e2psi / e2nu) / denom
    e1ph = (e2nu + V * omega * e2psi - omega * omega * e2psi) / (
        mathfn.sqrt(e2nu * e2psi) * denom
    )
    ephi = (e1t, zero, zero, e1ph)
    etheta = (zero, zero, 1.0 / mathfn.sqrt(rhosq), zero)
    er = (zero, mathfn.sqrt(delta / rhosq), zero, zero)
    return Tetrad(et=et, ephi=ephi, etheta=etheta, er=er)


class GeodesicRates(NamedTuple):
    """Coordinate rates dx^mu/dlambda plus the signed squared rates and the
    geometry byproducts the step bookkeeping reuses."""

    pt: torch.Tensor
    pr: torch.Tensor
    ptheta: torch.Tensor
    pphi: torch.Tensor
    thetadot_sq: torch.Tensor
    rdot_sq: torch.Tensor
    sin_t: torch.Tensor
    cos_t: torch.Tensor
    rhosq: torch.Tensor
    inv_rhosq: torch.Tensor


def geodesic_rates(r, theta, k, h, Q, rdot_sign, thetadot_sign, a) -> GeodesicRates:
    """Photon coordinate velocities from the constants of motion (kerr.h:299-335).

    Same op order as the JAX function: one fused reciprocal
    1/(rhosq*delta*sin^2) serves every division, sin^2 is floored at the
    dtype's smallest normal, and both square roots take sqrt(max(|x|, tiny)).
    """
    sin_t = mathfn.sin(theta)
    cos_t = mathfn.cos(theta)
    sin2 = sin_t * sin_t
    rhosq = r * r + (a * cos_t) * (a * cos_t)
    delta = r * r - 2.0 * r + a * a
    tiny = torch.finfo(sin2.dtype).tiny
    sin2 = torch.clamp_min(sin2, tiny)
    rd = rhosq * delta
    inv_all = 1.0 / (rd * sin2)
    inv_rhosq_delta = inv_all * sin2
    inv_sin2 = inv_all * rd
    inv_rhosq = delta * inv_rhosq_delta

    pt = ((rhosq * (r * r + a * a) + 2.0 * a * a * r * sin2) * k - 2.0 * a * r * h) * inv_rhosq_delta
    pphi = (2.0 * a * r * sin2 * k + (rhosq - 2.0 * r) * h) * inv_all

    cos2 = cos_t * cos_t
    ka = k * a
    thetadot_sq = (Q + cos2 * (ka * ka - h * h * inv_sin2)) * (inv_rhosq * inv_rhosq)
    ptheta = mathfn.sqrt(torch.clamp_min(torch.abs(thetadot_sq), tiny)) * thetadot_sign

    rdot_sq = (k * pt - h * pphi - rhosq * ptheta * ptheta) * (delta * inv_rhosq)
    pr = mathfn.sqrt(torch.clamp_min(torch.abs(rdot_sq), tiny)) * rdot_sign

    return GeodesicRates(pt, pr, ptheta, pphi, thetadot_sq, rdot_sq,
                         sin_t, cos_t, rhosq, inv_rhosq)


def momentum_from_consts(r, theta, k, h, Q, rdot_sign, thetadot_sign, a):
    """(pt, pr, ptheta, pphi) from the constants of motion (kerr.h:299-335)."""
    rates = geodesic_rates(r, theta, k, h, Q, rdot_sign, thetadot_sign, a)
    return rates.pt, rates.pr, rates.ptheta, rates.pphi


class PhotonConstants(NamedTuple):
    k: torch.Tensor
    h: torch.Tensor
    Q: torch.Tensor
    rdot_sign: torch.Tensor
    thetadot_sign: torch.Tensor


def constants_from_angles(r, theta, alpha, beta, V, a, E=1.0) -> PhotonConstants:
    """Constants of motion for a photon emitted at local polar angles
    (alpha, beta) from a source at (r, theta) orbiting at Omega = V
    (raytracer.cpp:625-676); frame legs (et, e_phi, e_theta, e_r) with the
    reference's -1/sqrt(rhosq) theta leg."""
    g = metric_coeffs(r, theta, a)
    tet = orbit_tetrad(r, theta, a, V, g)
    sin_a = mathfn.sin(alpha)
    p0 = E
    p1 = E * sin_a * mathfn.cos(beta)  # along e_phi
    p2 = E * sin_a * mathfn.sin(beta)  # along e_theta (reference orientation: -theta)
    p3 = E * mathfn.cos(alpha)  # along e_r

    tdot = p0 * tet.et[0] + p1 * tet.ephi[0]
    phidot = p0 * tet.et[3] + p1 * tet.ephi[3]
    rdot = p3 * tet.er[1]
    thetadot = p2 * (-tet.etheta[2])
    return constants_from_rates(r, theta, tdot, rdot, thetadot, phidot, a)


def constants_from_rates(r, theta, tdot, rdot, thetadot, phidot, a) -> PhotonConstants:
    """(k, h, Q) and initial signs from coordinate rates (raytracer.cpp:661-672)."""
    sin_t = mathfn.sin(theta)
    cos_t = mathfn.cos(theta)
    sin2 = sin_t * sin_t
    rhosq = r * r + (a * cos_t) * (a * cos_t)

    k = (1.0 - 2.0 * r / rhosq) * tdot + (2.0 * a * r * sin2 / rhosq) * phidot

    denom = r * r + a * a * cos_t * cos_t - 2.0 * r
    h = phidot * ((r * r + a * a) * denom * sin2 + 2.0 * a * a * r * sin2 * sin2)
    h = (h - 2.0 * a * r * k * sin2) / denom

    cot = cos_t / sin_t
    Q = (rhosq * rhosq) * thetadot * thetadot - (a * k * cos_t + h * cot) * (
        a * k * cos_t - h * cot
    )

    one = torch.ones_like(r)
    rdot_sign = torch.where(rdot >= 0, one, -one)
    thetadot_sign = torch.where(thetadot > 0, one, -one)
    return PhotonConstants(k=k, h=h, Q=Q, rdot_sign=rdot_sign, thetadot_sign=thetadot_sign)
