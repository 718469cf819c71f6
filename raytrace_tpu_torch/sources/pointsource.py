"""Lamppost point source: a grid of rays over emission direction.

Counterpart of ``raytrace_tpu/sources/pointsource.py`` (reference
``pointsource.cpp``): every ray starts from one Boyer-Lindquist position and
the launch directions form a (cos alpha, beta) grid in the rest frame of a
source orbiting at angular velocity V — equal cells are equal solid angles.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from raytrace_tpu_torch.geometry.kerr import constants_from_angles
from raytrace_tpu_torch.rays import RayBatch, blank_batch
from raytrace_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class PointSourceGrid:
    """Static grid geometry."""

    n_cosalpha: int
    n_beta: int
    dcosalpha: float
    dbeta: float
    cosalpha0: float
    cosalphamax: float
    beta0: float
    betamax: float

    @classmethod
    def from_steps(cls, dcosalpha, dbeta, cosalpha0=-0.995, cosalphamax=0.995,
                   beta0=-math.pi, betamax=math.pi):
        # Grid-count convention of the reference ctor (pointsource.cpp:16-17):
        # truncating int conversion of (range/step) + 1.
        n_cosalpha = int((cosalphamax - cosalpha0) / dcosalpha) + 1
        n_beta = int((betamax - beta0) / dbeta) + 1
        return cls(n_cosalpha, n_beta, float(dcosalpha), float(dbeta),
                   float(cosalpha0), float(cosalphamax), float(beta0), float(betamax))

    @property
    def n_rays(self) -> int:
        return self.n_cosalpha * self.n_beta


def grid_angles(grid: PointSourceGrid, *, device, dtype=torch.float64):
    """The grid's flat (cos alpha, beta, dead) tensors. Rows at the top grid
    edge (cosalpha >= cosalphamax or beta >= betamax) are dead
    (pointsource.cpp:40-44)."""
    i = torch.arange(grid.n_cosalpha, dtype=torch.float64, device=device)
    j = torch.arange(grid.n_beta, dtype=torch.float64, device=device)
    cosalpha = (grid.cosalpha0 + i[:, None] * grid.dcosalpha).to(dtype)
    beta = (grid.beta0 + j[None, :] * grid.dbeta).to(dtype)
    cosalpha, beta = torch.broadcast_tensors(cosalpha, beta)
    cosalpha = cosalpha.reshape(-1)
    beta = beta.reshape(-1)
    dead = (cosalpha >= grid.cosalphamax) | (beta >= grid.betamax)
    return cosalpha, beta, dead


def point_source_from_angles(pos, V, spin, cosalpha, beta, dead=None, E=1.0) -> RayBatch:
    """Lamppost batch from explicit per-ray emission angles; ``dead`` rows
    get steps = -1 (pointsource.cpp:30-64). Dtype and device are those of
    ``cosalpha``; entries of ``pos`` may be tensors, whose gradients the
    batch carries."""
    if dead is None:
        dead = torch.zeros_like(cosalpha, dtype=torch.bool)
    alpha = torch.arccos(torch.clamp(cosalpha, -1.0, 1.0))
    t0, r0, th0, ph0 = (p if isinstance(p, torch.Tensor) else float(p) for p in pos)

    def full(v):  # a tensor entry keeps its graph (the source height under autograd)
        if isinstance(v, torch.Tensor):
            return v.to(cosalpha.device) * torch.ones_like(cosalpha)
        return torch.full_like(cosalpha, v)

    r = full(r0)
    theta = full(th0)
    c = constants_from_angles(r, theta, alpha, beta, V, spin, E)

    base = blank_batch(cosalpha.shape[0], device=cosalpha.device, dtype=cosalpha.dtype)
    return base.replace(
        t=full(t0),
        r=r,
        theta=theta,
        phi=full(ph0),
        k=c.k,
        h=c.h,
        Q=c.Q,
        rdot_sign=c.rdot_sign,
        thetadot_sign=c.thetadot_sign,
        steps=torch.where(dead, -1, 0).to(torch.int32),
        alpha=cosalpha,  # reference stores cos(alpha) in .alpha (pointsource.cpp:48)
        beta=beta,
    )


def point_source(pos, V, spin, grid: PointSourceGrid, E=1.0, *, device,
                 dtype=torch.float64) -> RayBatch:
    """Build the lamppost ray batch.

    Args:
      pos: (t, r, theta, phi) of the source.
      V: angular velocity Omega = dphi/dt of the source frame (0 = static).
      spin: black-hole spin.
      grid: direction grid; its top-edge rows are dead padding (steps = -1).
      E: emitted energy scale.

    Runs in the span ``rt.source`` (``utils.profiling``).
    """
    with span("rt.source"):
        cosalpha, beta, dead = grid_angles(grid, device=device, dtype=dtype)
        return point_source_from_angles(pos, V, spin, cosalpha, beta, dead, E)
