"""Volumetric transfer maps: the reverberation / time-lag machinery.

Counterpart of ``raytrace_tpu/ops/mapper.py`` (reference Mapper,
src/mapper/mapper.{h,cpp}): march rays and, every time a ray enters a new
cell of a 3-D (r, theta, phi) grid, add its arrival time, its local
redshift (in the frame of material following a velocity law) and a count
into that cell; divide by the counts at the end and pair with each cell's
proper volume sqrt(-g_rr g_thth g_phph) dr dtheta dphi (mapper.cpp:110-338).

The batch marches in lock-step on its own device with the plain Euler / RK4
step body (``ops/integrate.py::_march``, CUDA-graph epochs on the card);
every iteration adds the batch's cell-entry events into one [3, cells + 1]
map with ``index_add_`` (repeated cells add up; masked events go to the
last, scrap cell). On the card the additions are atomic, so float64 sums
differ from run to run by rounding.

As in the JAX package: the sign gates are the corrected was-positive gates
of the main integrator (not the reference's COUNT_MIN guard), and bin 0 of
every axis is included (mapper.cpp:247 drops it).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from raytrace_tpu_torch import mathfn
from raytrace_tpu_torch.destinations import ThetaLimit
from raytrace_tpu_torch.geometry.kerr import (
    horizon_radius,
    metric_coeffs,
    metric_dot,
    momentum_from_consts,
)
from raytrace_tpu_torch.ops.integrate import (
    StepControl,
    _capture_radius,
    _euler_rk4_body,
    _march,
)
from raytrace_tpu_torch.rays import RayBatch


@dataclasses.dataclass(frozen=True)
class MapperGrid:
    """Static 3-D binning geometry (mapper.h:51-53)."""

    r0: float
    r_max: float
    n_r: int
    n_theta: int
    n_phi: int
    logbin_r: bool = True
    theta_max: float = math.pi

    @property
    def dr(self):
        if self.logbin_r:
            return math.exp(math.log(self.r_max / self.r0) / self.n_r)
        return (self.r_max - self.r0) / self.n_r

    @property
    def dtheta(self):
        return self.theta_max / self.n_theta

    @property
    def dphi(self):
        return 2.0 * math.pi / self.n_phi

    @property
    def n_cells(self):
        return self.n_r * self.n_theta * self.n_phi

    def cell_index(self, r, theta, phi):
        """Flattened cell index (int32; -1 out of range) and the in-range
        mask. phi is wrapped."""
        f = lambda x: torch.full((), x, dtype=r.dtype, device=r.device)  # capturable
        if self.logbin_r:
            ir = torch.floor(torch.log(r / f(self.r0)) / torch.log(f(self.dr)))
        else:
            ir = torch.floor((r - self.r0) / f(self.dr))
        itheta = torch.floor(theta / f(self.dtheta)).to(torch.int32)
        phi_w = phi - 2 * math.pi * torch.floor((phi + math.pi) / f(2 * math.pi))
        iphi = torch.floor((phi_w + math.pi) / f(self.dphi)).to(torch.int32)
        ir = ir.to(torch.int32)
        ok = ((ir >= 0) & (ir < self.n_r) & (itheta >= 0) & (itheta < self.n_theta)
              & (iphi >= 0) & (iphi < self.n_phi))
        flat = (ir * self.n_theta + itheta) * self.n_phi + iphi
        return torch.where(ok, flat, -1), ok


def _local_redshift(r, theta, phi, k, h, Q, rdot_sign, thetadot_sign, emit, spin, V, reverse,
                    motion):
    """emit / E_local in the frame of material at (r, theta) moving with
    angular velocity V (motion 0) or radial velocity V (motion 1), the
    inverse ratio when ``reverse`` (the mapper's per-cell redshift,
    mapper.cpp:249-258)."""
    a = -spin if reverse else spin
    g = metric_coeffs(r, theta, a)
    if motion == 0:
        dv = V - g.omega
        gamma = 1.0 / mathfn.sqrt(1.0 - dv * dv * g.e2psi / g.e2nu)
        ut = gamma / mathfn.sqrt(g.e2nu)
        zero = torch.zeros_like(ut)
        et = (ut, zero, zero, ut * V)
    else:
        ut = 1.0 / mathfn.sqrt(g.g_tt + g.g_rr * V * V)
        zero = torch.zeros_like(ut)
        et = (ut, V * ut, zero, zero)
    pt, pr, pth, pph = momentum_from_consts(r, theta, k, h, Q, rdot_sign, thetadot_sign, spin)
    if reverse:
        pr, pth, pph = -pr, -pth, -pph
    recv = metric_dot(g, et, (pt, pr, pth, pph))
    return recv / emit if reverse else emit / recv


def velocity_law(motion, vel, vel_mode, r, theta, r_max, spin=0.0, reverse=False):
    """The mapper's material velocity field (mapper.cpp:249-256): motion 0
    is the projected-radius Keplerian orbit Omega = 1/(a + r_p^{3/2}) (spin
    negated for backward-traced planes); motion 1 is radial with vel_mode 0
    constant, 1 linear in r/r_max, 2 sqrt(r/r_max)."""
    if motion == 0:
        a_eff = -spin if reverse else spin
        r_p = r * mathfn.sin(theta)
        return 1.0 / (a_eff + r_p * mathfn.sqrt(r_p))
    if vel_mode == 0:
        return vel * torch.ones_like(r)
    if vel_mode == 1:
        return vel * (r / r_max)
    return vel * mathfn.sqrt(r / r_max)


def map_rays(
    rays: RayBatch,
    spin,
    grid: MapperGrid,
    *,
    method: str = "euler",
    r_lim=1000.0,
    theta_lim=math.pi,
    motion: int = 0,
    vel: float = 0.0,
    vel_mode: int = 0,
    reverse: bool = False,
    steplim: int = 100_000,
    ctrl: StepControl = StepControl(),
    max_iters: int | None = None,
):
    """March the batch (Euler, or RK4 for any other ``method``) towards
    ThetaLimit(theta_lim), adding cell-entry events into the 3-D maps, for
    at most ``max_iters`` (default steplim + 16) lock-step iterations.

    Returns (final_rays, dict(time, redshift, count) each [n_r, n_theta,
    n_phi] on the batch's device, not yet count-averaged).
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
    # time, redshift, count; the last cell is the scrap cell
    maps = torch.zeros((3, grid.n_cells + 1), dtype=rays.r.dtype, device=rays.r.device)
    last = torch.full((rays.n_rays,), -2, dtype=torch.int32, device=rays.r.device)

    def advance(st, step, carry):
        (last,) = carry
        active = st.active
        st2 = _euler_rk4_body(st, spin, horizon, capture, dest, r_lim, steplim, ctrl, method,
                              active)
        cell, in_range = grid.cell_index(st2.r, st2.theta, st2.phi)
        moved = active & in_range & (cell != last)
        V = velocity_law(motion, vel, vel_mode, st2.r, st2.theta, grid.r_max, spin, reverse)
        g_local = _local_redshift(st2.r, st2.theta, st2.phi, st2.k, st2.h, st2.Q,
                                  st2.rdot_sign, st2.thetadot_sign, st2.emit, spin, V,
                                  reverse, motion)
        good = moved & (g_local > 0) & torch.isfinite(g_local)
        idx = torch.where(good, cell, grid.n_cells).long()
        events = torch.stack([st2.t, g_local, torch.ones_like(g_local)])
        maps.index_add_(1, idx, torch.where(good, events, 0.0))
        return st2, step, (torch.where(active & in_range, cell, last),)

    final, _ = _march(rays, rays.dt, (last,), advance, max_iters)
    shape = (grid.n_r, grid.n_theta, grid.n_phi)
    out = {name: maps[i, :-1].reshape(shape)
           for i, name in enumerate(("time", "redshift", "count"))}
    return final, out


def cell_volumes(grid: MapperGrid, spin, *, device="cpu", dtype=torch.float64):
    """Proper volume of every cell (mapper.cpp:311-338), [n_r, n_theta,
    n_phi] on ``device``."""
    ir = torch.arange(grid.n_r, dtype=dtype, device=device)
    if grid.logbin_r:
        r = grid.r0 * torch.full_like(ir, grid.dr) ** ir
        dr = r * (grid.dr - 1.0)
    else:
        r = grid.r0 + grid.dr * ir
        dr = torch.full_like(r, grid.dr)
    theta = torch.arange(grid.n_theta, dtype=dtype, device=device) * grid.dtheta
    g = metric_coeffs(r[:, None], theta[None, :], spin)
    dv = mathfn.sqrt(-g.g_rr * g.g_thth * g.g_phph) * dr[:, None] * grid.dtheta * grid.dphi
    return dv[:, :, None].expand(grid.n_r, grid.n_theta, grid.n_phi)


def average_maps(maps: dict) -> dict:
    """Count-average the accumulated maps (mapper.cpp:304-309), as numpy
    arrays on the host."""
    host = {k: torch.as_tensor(v).cpu().numpy() for k, v in maps.items()}
    count = host["count"]
    with np.errstate(divide="ignore", invalid="ignore"):
        return {"time": host["time"] / count, "redshift": host["redshift"] / count,
                "count": count}


def save_hdf(path, grid: MapperGrid, avg: dict, volume, n_rays=None):
    """HDF5 export with the reference's layout (mapper.h:75-107): datasets
    ``time`` / ``redshift`` / ``Nrays`` / ``volume`` of shape (n_r,
    n_theta, n_phi), and the grid geometry as root attributes (r0, rmax,
    Nr, dr, logbin_r, theta_max, Ntheta, dtheta, Nphi, dphi). Needs h5py
    (ImportError without it)."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["r0"] = float(grid.r0)
        f.attrs["rmax"] = float(grid.r_max)
        f.attrs["Nr"] = int(grid.n_r)
        f.attrs["dr"] = float(grid.dr)
        f.attrs["logbin_r"] = int(grid.logbin_r)
        f.attrs["theta_max"] = float(grid.theta_max)
        f.attrs["Ntheta"] = int(grid.n_theta)
        f.attrs["dtheta"] = float(grid.dtheta)
        f.attrs["Nphi"] = int(grid.n_phi)
        f.attrs["dphi"] = float(grid.dphi)
        if n_rays is not None:
            f.attrs["n_rays"] = int(n_rays)
        f.create_dataset("time", data=np.nan_to_num(np.asarray(avg["time"], np.float64)))
        f.create_dataset("redshift", data=np.nan_to_num(np.asarray(avg["redshift"], np.float64)))
        f.create_dataset("Nrays", data=np.asarray(avg["count"], np.float64))
        f.create_dataset("volume", data=np.asarray(volume, np.float64))


def load_hdf(path):
    """Read a save_hdf file back: (MapperGrid, {time, redshift, count},
    volume), numpy arrays."""
    import h5py

    with h5py.File(path, "r") as f:
        grid = MapperGrid(
            r0=float(f.attrs["r0"]),
            r_max=float(f.attrs["rmax"]),
            n_r=int(f.attrs["Nr"]),
            n_theta=int(f.attrs["Ntheta"]),
            n_phi=int(f.attrs["Nphi"]),
            logbin_r=bool(f.attrs["logbin_r"]),
            theta_max=float(f.attrs["theta_max"]),
        )
        avg = {"time": np.asarray(f["time"]), "redshift": np.asarray(f["redshift"]),
               "count": np.asarray(f["Nrays"])}
        volume = np.asarray(f["volume"])
    return grid, avg, volume
