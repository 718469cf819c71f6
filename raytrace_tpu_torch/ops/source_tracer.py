"""Radiative transfer along backward-traced rays through an emitting volume.

Counterpart of ``raytrace_tpu/ops/source_tracer.py`` (reference
SourceTracer, src/source_tracer/source_tracer.cpp): as each image-plane ray
marches, inside an emitting region it accumulates into per-ray energy bins

    emis[ray, ien]   += epsilon * rho * E_loc^3 * exp(-absorb[ray, ien])
    absorb[ray, ien] += dl * rho

with dl the proper length of the step, rho the wind density and E_loc the
energy in the local wind frame, and a global (energy, time) response
alongside (source_tracer.cpp:232-275). A stopping criterion ends rays that
run into the opaque central source (outflow.cpp:17-32).

The batch marches in lock-step on its own device with the plain Euler / RK4
step body (``ops/integrate.py::_march``, CUDA-graph epochs on the card).
The per-ray [rays, n_en + 1] spectra ride with the rays (each ray adds into
its own row: ``scatter_add``); the response is one [n_en + 1, n_t + 1] map
that every iteration adds into with ``index_add_``, repeated bins adding up.
The last row and column are scrap bins for masked events. On the card the
response additions are atomic, so its float64 sums differ from run to run
by rounding.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from raytrace_tpu_torch import mathfn
from raytrace_tpu_torch.destinations import ThetaLimit
from raytrace_tpu_torch.geometry.kerr import horizon_radius, metric_coeffs
from raytrace_tpu_torch.ops.integrate import (
    StepControl,
    _capture_radius,
    _euler_rk4_body,
    _march,
)
from raytrace_tpu_torch.ops.mapper import _local_redshift
from raytrace_tpu_torch.rays import RAY_STATUS_DEST, RayBatch


@dataclasses.dataclass(frozen=True)
class WindModel:
    """Emitting-wind description. The defaults are the reference's
    hard-coded model (source_tracer.cpp:245-252): a shell 10 < r < 50,
    0.5 < theta < pi/2, radial beta-law velocity v(r) = v0 (0.01 + 0.99 (1
    - 1/r)), mass-continuity density rho = 1/(r^2 |v|)."""

    v0: float = 0.1
    r_in: float = 10.0
    r_out: float = 50.0
    theta_min: float = 0.5
    theta_max: float = math.pi / 2
    motion: int = 1  # radial

    def in_region(self, r, theta, phi):
        return (r > self.r_in) & (r < self.r_out) & (theta > self.theta_min) & (
            theta < self.theta_max)

    def velocity(self, r):
        return self.v0 * (0.01 + 0.99 * (1.0 - 1.0 / r))

    def density(self, r):
        return 1.0 / (r * r * torch.abs(self.velocity(r)))


@dataclasses.dataclass(frozen=True)
class SphericalStop:
    """Stop rays entering a sphere of radius R about the origin: the opaque
    central X-ray source (outflow.cpp:17-32)."""

    radius: float = 0.0

    def __call__(self, t, r, theta, phi):
        return r < self.radius


@dataclasses.dataclass(frozen=True)
class EnergyTimeBins:
    """Static (energy, time) response binning (source_tracer.h:60-75)."""

    en0: float = 0.1
    en_max: float = 10.0
    n_en: int = 200
    logbin_en: bool = True
    t0: float = 0.0
    dt: float = 10.0
    n_t: int = 1

    @property
    def den(self):
        if self.logbin_en:
            return math.exp(math.log(self.en_max / self.en0) / self.n_en)
        return (self.en_max - self.en0) / self.n_en

    def energy_index(self, e):
        f = lambda x: torch.full((), x, dtype=e.dtype, device=e.device)  # capturable
        if self.logbin_en:
            i = torch.floor(torch.log(e / f(self.en0)) / torch.log(f(self.den)))
        else:
            i = torch.floor((e - self.en0) / f(self.den))
        return i.to(torch.int32)

    def energies(self):
        i = np.arange(self.n_en)
        if self.logbin_en:
            return self.en0 * self.den**i
        return self.en0 + self.den * i


def run_source_trace(
    rays: RayBatch,
    spin,
    wind: WindModel,
    bins: EnergyTimeBins,
    *,
    stop=SphericalStop(0.0),
    method: str = "euler",
    r_lim=1000.0,
    theta_lim=0.0,
    reverse: bool = True,
    steplim: int = 100_000,
    ctrl: StepControl = StepControl(),
    max_iters: int | None = None,
):
    """March the batch (Euler, or RK4 for any other ``method``) towards
    ThetaLimit(theta_lim) through the wind, accumulating per-ray spectra,
    for at most ``max_iters`` (default steplim + 16) lock-step iterations.
    A ray that enters ``stop`` ends there with RAY_STATUS_DEST.

    Returns (final_rays, emis [N, n_en], absorb [N, n_en], response [n_en,
    n_t]) on the batch's device.
    """
    if max_iters is None:
        max_iters = steplim + 16
    horizon = horizon_radius(spin)
    capture = _capture_radius(horizon, ctrl.horizon_eps, rays.r)
    dest = ThetaLimit(theta_lim)
    r_lim = float(r_lim)

    rays = rays.replace(
        r_was_positive=torch.zeros_like(rays.r_was_positive),
        theta_was_positive=torch.ones_like(rays.theta_was_positive),
    )
    n, dtype, device = rays.n_rays, rays.r.dtype, rays.r.device
    emis = torch.zeros((n, bins.n_en + 1), dtype=dtype, device=device)
    absorb = torch.zeros((n, bins.n_en + 1), dtype=dtype, device=device)
    resp = torch.zeros(((bins.n_en + 1) * (bins.n_t + 1),), dtype=dtype, device=device)
    four_pi = torch.full((), 4.0 * math.pi, dtype=dtype, device=device)
    dt_bin = torch.full((), bins.dt, dtype=dtype, device=device)

    def advance(st, step, carry):
        emis, absorb = carry
        active = st.active
        st2 = _euler_rk4_body(st, spin, horizon, capture, dest, r_lim, steplim, ctrl, method,
                              active)
        moved = active & (st2.steps > st.steps)
        # stopping criterion: the ray ends where it enters the source
        stopped = moved & stop(st2.t, st2.r, st2.theta, st2.phi)
        st2 = st2.replace(status=st2.status | torch.where(stopped, RAY_STATUS_DEST, 0).to(
            torch.int32))

        dr = st2.r - st.r
        dth = st2.theta - st.theta
        dph = st2.phi - st.phi
        g = metric_coeffs(st2.r, st2.theta, spin)
        dl_sq = -(g.g_rr * dr * dr + g.g_thth * dth * dth + g.g_phph * dph * dph)
        dl = mathfn.sqrt(torch.clamp_min(dl_sq, 0.0))

        in_wind = moved & ~stopped & wind.in_region(st2.r, st2.theta, st2.phi)
        v = wind.velocity(st2.r)
        rho = wind.density(st2.r)
        g_loc = _local_redshift(st2.r, st2.theta, st2.phi, st2.k, st2.h, st2.Q,
                                st2.rdot_sign, st2.thetadot_sign, st2.emit, spin, v, reverse,
                                wind.motion)
        energy = 1.0 / g_loc
        ien = bins.energy_index(torch.clamp_min(energy, 1e-30))
        it_bin = torch.floor((st2.t - bins.t0) / dt_bin).to(torch.int32)

        good = (in_wind & (ien >= 0) & (ien < bins.n_en) & (dl > 0)
                & torch.isfinite(energy))
        ien_s = torch.where(good, ien, bins.n_en).long()
        it_s = torch.clamp(torch.where(good, it_bin, bins.n_t), 0, bins.n_t).long()

        # single point-source patch approximation (source_tracer.cpp:259-262)
        emissivity = (dl * dl) / (four_pi * st2.r * st2.r)
        col = ien_s[:, None]
        tau = absorb.gather(1, col)[:, 0]  # before this step's opacity
        dem = torch.where(good, emissivity * rho * energy**3 * torch.exp(-tau), 0.0)
        dab = torch.where(good, dl * rho, 0.0)
        resp.index_add_(0, ien_s * (bins.n_t + 1) + it_s,
                        torch.where(good, emissivity * dl * rho * energy**3, 0.0))
        return st2, step, (emis.scatter_add(1, col, dem[:, None]),
                           absorb.scatter_add(1, col, dab[:, None]))

    final, (emis, absorb) = _march(rays, rays.dt, (emis, absorb), advance, max_iters)
    resp = resp.reshape(bins.n_en + 1, bins.n_t + 1)
    return final, emis[:, :-1], absorb[:, :-1], resp[:-1, :-1]
