"""Moving point sources: radial jets and arbitrary 4-velocities.

Counterpart of ``raytrace_tpu/sources/moving.py`` (the capability of the
reference's JetPointSource, jetpointsource.cpp:156-229, and PointSourceVel,
pointsource_vel.cpp:113-260): the source frame is the metric Gram-Schmidt
tetrad of the source 4-velocity, and the emission directions are the same
(cos alpha, beta) solid-angle-uniform grid as the static lamppost's.
"""

from __future__ import annotations

import torch

from raytrace_tpu_torch import mathfn
from raytrace_tpu_torch.geometry.gramschmidt import gram_schmidt_tetrad
from raytrace_tpu_torch.geometry.kerr import constants_from_frame, metric_coeffs
from raytrace_tpu_torch.rays import RayBatch, blank_batch
from raytrace_tpu_torch.sources.pointsource import PointSourceGrid, grid_angles


def radial_four_velocity(r, theta, v, spin):
    """u^mu of material moving radially at dr/dt = v, normalised against
    g_tt (dt)^2 + g_rr (dr)^2 = 1 (jetpointsource.cpp:156-229; the
    reference's motion = 1 redshift observer, raytracer.cpp:528-535). NaN
    where the frame is superluminal (g_tt + g_rr v^2 < 0)."""
    g = metric_coeffs(r, theta, spin)
    ut = 1.0 / mathfn.sqrt(g.g_tt + g.g_rr * v * v)
    zero = torch.zeros_like(ut)
    return (ut, v * ut, zero, zero)


def _source_from_frame(pos, tet, spin, grid: PointSourceGrid, E, device, dtype) -> RayBatch:
    cosalpha, beta, dead = grid_angles(grid, device=device, dtype=dtype)
    alpha = torch.arccos(torch.clamp(cosalpha, -1.0, 1.0))
    sin_a = mathfn.sin(alpha)
    vx = sin_a * mathfn.cos(beta)
    vy = sin_a * mathfn.sin(beta)
    vz = cosalpha

    t0, r0, th0, ph0 = (float(p) for p in pos)
    full = lambda v: torch.full_like(cosalpha, v)
    r = full(r0)
    theta = full(th0)
    c = constants_from_frame(r, theta, tet, vx, vy, vz, spin, E)

    base = blank_batch(grid.n_rays, device=device, dtype=dtype)
    return base.replace(
        t=full(t0), r=r, theta=theta, phi=full(ph0),
        k=c.k, h=c.h, Q=c.Q, rdot_sign=c.rdot_sign, thetadot_sign=c.thetadot_sign,
        steps=torch.where(dead, -1, 0).to(torch.int32),
        alpha=cosalpha,
        beta=beta,
    )


def point_source_vel(pos, u4, spin, grid: PointSourceGrid, E=1.0, *, device,
                     dtype=torch.float64) -> RayBatch:
    """Lamppost at ``pos`` = (t, r, theta, phi) with the timelike source
    4-velocity ``u4`` = (ut, ur, uth, uph), floats or 0-d tensors
    (PointSourceVel capability)."""
    r0 = torch.tensor(float(pos[1]), dtype=dtype, device=device)
    th0 = torch.tensor(float(pos[2]), dtype=dtype, device=device)
    u4 = tuple(torch.as_tensor(u, dtype=dtype, device=device) for u in u4)
    tet = gram_schmidt_tetrad(r0, th0, u4, spin)
    return _source_from_frame(pos, tet, spin, grid, E, device, dtype)


def jet_point_source(pos, v_radial, spin, grid: PointSourceGrid, E=1.0, *, device,
                     dtype=torch.float64) -> RayBatch:
    """Lamppost moving radially at dr/dt = v_radial (JetPointSource
    capability): jet or ejecta emission, beamed along r."""
    r0 = torch.tensor(float(pos[1]), dtype=dtype, device=device)
    th0 = torch.tensor(float(pos[2]), dtype=dtype, device=device)
    v = torch.tensor(float(v_radial), dtype=dtype, device=device)
    u4 = radial_four_velocity(r0, th0, v, spin)
    return point_source_vel(pos, u4, spin, grid, E, device=device, dtype=dtype)
