"""Metric Gram-Schmidt orthonormal tetrad for an arbitrary timelike 4-velocity.

Counterpart of ``raytrace_tpu/geometry/gramschmidt.py`` (reference
``gramschmidt_basis.h``); vectors are (t, r, theta, phi) tuples of tensors.
"""

from __future__ import annotations

import torch

from . import mathfn
from .kerr import MetricCoeffs, Tetrad, metric_coeffs, metric_dot


def _project_out(g: MetricCoeffs, v, e):
    """v minus its metric projection onto e (one Gram-Schmidt sweep step)."""
    coef = metric_dot(g, v, e) / metric_dot(g, e, e)
    return tuple(vi - coef * ei for vi, ei in zip(v, e))


def _normalise(g: MetricCoeffs, e):
    norm = mathfn.sqrt(torch.abs(metric_dot(g, e, e)))
    return tuple(ei / norm for ei in e)


def _orient(e, component_idx, want_positive):
    """Flip the whole vector so its given component has the requested sign
    (gramschmidt_basis.h:83-85)."""
    c = e[component_idx]
    flip = c < 0 if want_positive else c > 0
    sign = torch.where(flip, -torch.ones_like(c), torch.ones_like(c))
    return tuple(sign * ei for ei in e)


def gram_schmidt_tetrad(r, theta, u, a) -> Tetrad:
    """Orthonormal frame (et, e_phi, e_theta, e_r) for 4-velocity u at
    (r, theta), seeded with the coordinate r, theta, phi directions."""
    g = metric_coeffs(r, theta, a)
    u = torch.broadcast_tensors(*u)
    zero = torch.zeros_like(u[0])
    one = torch.ones_like(zero)
    et = tuple(u)

    er = _project_out(g, (zero, one, zero, zero), et)
    etheta = _project_out(g, _project_out(g, (zero, zero, one, zero), et), er)
    ephi = _project_out(
        g, _project_out(g, _project_out(g, (zero, zero, zero, one), et), er), etheta
    )

    er = _orient(er, 1, True)
    etheta = _orient(etheta, 2, False)
    ephi = _orient(ephi, 3, True)

    return Tetrad(
        et=_normalise(g, et),
        ephi=_normalise(g, ephi),
        etheta=_normalise(g, etheta),
        er=_normalise(g, er),
    )
