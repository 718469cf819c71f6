"""Proper areas of equatorial accretion-disc annuli.

Counterpart of ``raytrace_tpu/geometry/disc.py`` (reference ``disc.h``):
the static-slice annulus area, and rest-frame parallelogram areas in the
Keplerian region and in the ISCO-plunge region, integrated over one disc
or over radial bins.
"""

from __future__ import annotations

import math

import torch

from . import mathfn
from .gramschmidt import gram_schmidt_tetrad
from .kerr import (
    Tetrad,
    horizon_radius,
    isco_radius,
    keplerian_omega,
    metric_coeffs,
    metric_dot,
    orbit_tetrad,
)


def _parallelogram_area(r, dr, dphi, a, tet: Tetrad):
    """Area of the (dr x dphi) coordinate parallelogram in the frame `tet`
    (disc.h:23-31); projected components ordered (phi, theta, r)."""
    g = metric_coeffs(r, torch.full_like(r, math.pi / 2), a)
    zero = torch.zeros_like(r)
    side_r = (zero, dr, zero, zero)
    side_phi = (zero, zero, zero, dphi * torch.ones_like(r))

    def project(side):
        return (
            metric_dot(g, side, tet.ephi),
            metric_dot(g, side, tet.etheta),
            metric_dot(g, side, tet.er),
        )

    u = project(side_r)
    v = project(side_phi)
    cx = u[1] * v[2] - u[2] * v[1]
    cy = u[2] * v[0] - u[0] * v[2]
    cz = u[0] * v[1] - u[1] * v[0]
    return mathfn.sqrt(cx * cx + cy * cy + cz * cz)


def rel_disc_area(r, dr, dphi, a):
    """Annulus area in the rest frame of Keplerian disc material (disc.h:11-32)."""
    theta = torch.full_like(r, math.pi / 2)
    tet = orbit_tetrad(r, theta, a, keplerian_omega(r, a))
    return _parallelogram_area(r, dr, dphi, a, tet)


def _sqrt(x):
    return mathfn.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def plunge_velocity(r, a, r_plunge=None):
    """4-velocity of a geodesic plunge from the ISCO at equatorial radius r,
    conserving the circular-orbit k and h at r_plunge (disc.h:44-57).
    ``a`` and ``r_plunge`` may be Python floats or tensors."""
    if r_plunge is None:
        r_plunge = isco_radius(a)
    delta = r * r - 2.0 * r + a * a
    u = 1.0 / r_plunge
    root = _sqrt(u * u * u)
    den = _sqrt(1.0 - 3.0 * u + 2.0 * a * root)
    k = (1.0 - 2.0 * u + a * root) / den
    h = (1.0 + a * a * u * u - 2.0 * a * root) / (_sqrt(u) * den)

    ut = ((r * r + a * a + 2.0 * a * a / r) * k - 2.0 * a * h / r) / delta
    ur_sq = (
        k * k
        - 1.0
        + 2.0 / r
        + (a * a * (k * k - 1.0) - h * h) / (r * r)
        + 2.0 * (h - a * k) * (h - a * k) / (r * r * r)
    )
    ur = -mathfn.sqrt(torch.clamp_min(ur_sq, 0.0))
    uphi = (2.0 * a * k / r + (1.0 - 2.0 / r) * h) / delta
    return (ut, ur, torch.zeros_like(ut), uphi)


def plunge_disc_area(r, dr, dphi, a, r_plunge=None):
    """Annulus area in the rest frame of ISCO-plunge material (disc.h:34-76)."""
    theta = torch.full_like(r, math.pi / 2)
    tet = gram_schmidt_tetrad(r, theta, plunge_velocity(r, a, r_plunge), a)
    return _parallelogram_area(r, dr, dphi, a, tet)


def _kep_plunge_area(r, dr, dphi, a, switch_r, force_keplerian, r_plunge):
    """Keplerian frame outside switch_r, plunge frame inside it; each branch
    is evaluated at a radius valid for it and sub-horizon annuli give 0, so
    neither the value nor the gradient of the branch not taken is inf or
    NaN (0 * inf in the backward pass of ``torch.where``)."""
    if force_keplerian:
        return rel_disc_area(r, dr, dphi, a)
    in_plunge = r < switch_r
    if isinstance(switch_r, torch.Tensor):
        kep = rel_disc_area(torch.maximum(r, switch_r), dr, dphi, a)
    else:
        kep = rel_disc_area(torch.clamp_min(r, switch_r), dr, dphi, a)
    r_h = horizon_radius(a)
    r_safe = 0.5 * (r_h + switch_r)
    above_horizon = r > r_h * (1.0 + 1e-9)
    plunge = plunge_disc_area(
        torch.where(in_plunge & above_horizon, r, r_safe), dr, dphi, a, r_plunge,
    )
    area = torch.where(in_plunge, plunge, kep)
    return torch.where(above_horizon, area, torch.zeros_like(area))


def integrate_disc_area_bins(
    r_lo, r_hi, a, force_keplerian=False, n_sub=50, dphi=0.1, logbin=True,
    r_plunge=None,
):
    """Rest-frame areas of many [r_lo_i, r_hi_i) bins at once: n_sub - 1
    sub-annuli per bin (log or linear), summed where positive (disc.h:125-141).

    ``a`` and ``r_plunge`` are Python floats or tensors (a tensor spin
    carries its gradient through the ISCO switch); the bins' dtype and
    device are those of ``r_lo``.
    """
    r_hi = r_hi.to(r_lo.dtype)
    r_isco = isco_radius(a)
    idx = torch.arange(n_sub - 1, dtype=r_lo.dtype, device=r_lo.device)
    if logbin:
        ratio = torch.exp(torch.log(r_hi / r_lo) / (n_sub - 1))
        r = r_lo[:, None] * ratio[:, None] ** idx[None, :]
        dr = r * (ratio[:, None] - 1.0)
    else:
        dr_lin = (r_hi - r_lo) / (n_sub - 1)
        r = r_lo[:, None] + idx[None, :] * dr_lin[:, None]
        dr = dr_lin[:, None].expand(r.shape)

    switch_r = r_isco if r_plunge is None else r_plunge
    area = _kep_plunge_area(r, dr, dphi, a, switch_r, force_keplerian, r_plunge)
    return torch.sum(torch.where(area > 0, area, torch.zeros_like(area)), dim=1)
