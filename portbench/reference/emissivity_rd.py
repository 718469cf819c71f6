"""The destination-API lamppost emissivity (emissivity_rd.cpp), computed by
the plain reference.

``emissivity_rd_columns`` is the table of
``apps.emissivity.compute(variant="rd")``: the rays of the plain
emissivity's point source marched with RK4 to ``ThetaLimit(theta_lim)``
(the reference's ``FlatDiscDestination``), redshifted against the
destination's Keplerian 4-velocity (``ray_redshift_dest``), kept where they
landed on the disc (the hit test below) and binned as the plain table is.
It strings together the frozen modules beside this file, which it leaves as
they are; only ``ray_redshift_dest`` is new, built from their own metric,
frame and ratio helpers.

Where this departs from emissivity_rd.cpp:
- the march is the lock-step plain march (``jobs.march``), its step budget
  the configuration's ``steplim`` (30,000 in the benchmark, the card's RK4
  cap) where the reference binary takes its STEPLIM of 1e7
  (raytracer.h:30-39); the theta crossing is refined onto theta_lim after
  it, as every port route does;
- the bins' areas and the primary-flux normalisation are the plain table's
  (``jobs.emissivity_columns``): r_max and r_disc as the app's defaults
  give them, the grid cells counted without the +1 fencepost;
- ``sum_dtype`` sets the precision of the bins' sums alone, so that a
  control can lower them and nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

from .destinations import ThetaLimit
from .disc import integrate_disc_area_bins
from .jobs import march, point_grid, source_position
from .kerr import isco_radius, metric_coeffs
from .pointsource import point_source
from .rays import RayBatch
from .reductions import bin_edges, radial_bin_profile
from .redshift import _energy_in_frame, _ratio, _sanitize, range_phi, redshift_start


def ray_redshift_dest(rays: RayBatch, spin, dest, reverse: bool = False):
    """Redshift emit/recv (recv/emit when reversed) against the 4-velocity
    of the material on ``dest`` at each ray's end (raytracer.cpp:450-477,
    556-600). The reference evaluates the metric and the observer with the
    trace spin here, reversed or not; so does this."""
    rs = _sanitize(rays)
    et = dest.four_velocity(rs.r, rs.theta, rs.phi, spin)
    g = metric_coeffs(rs.r, rs.theta, spin)
    return _ratio(rays.emit, _energy_in_frame(rs, spin, et, g, reverse), reverse)


@torch.no_grad()
def emissivity_rd_columns(par, *, device, march_dtype, dtype=torch.float64,
                          sum_dtype=None) -> dict:
    """The seven columns (r, area, rays, flux, emis, redshift, time) of the
    destination-API emissivity table, as numpy arrays."""
    spin, V, gamma = float(par["spin"]), float(par["V"]), float(par["gamma"])
    n_r, logbin = int(par["Nr"]), bool(par["logbin_r"])
    theta_lim = float(par["theta_lim"])
    dest = ThetaLimit(theta_lim)
    grid = point_grid(par)
    r_isco = isco_radius(spin)
    r_min = float(r_isco)
    disc_r, disc_width, dr = bin_edges(r_min, float(par["r_disc"]), n_r, logbin, device="cpu",
                                       dtype=dtype)
    areas = integrate_disc_area_bins(disc_r, disc_r + disc_width, spin)
    n_primary = ((grid.cosalphamax - grid.cosalpha0) / grid.dcosalpha) * (
        (grid.betamax - grid.beta0) / grid.dbeta)

    rays = point_source(source_position(par), V, spin, grid, device=device, dtype=dtype)
    rays = redshift_start(rays, spin, V)
    out = march(rays, spin, march_dtype=march_dtype, method=par["integrator"], dest=dest,
                r_max=float(par["r_max"]), steplim=int(par["steplim"]))
    out = range_phi(out)
    # the redshift against the disc's Keplerian 4-velocity (emissivity_rd.cpp:99-106)
    out = out.replace(redshift=ray_redshift_dest(out, spin, dest))
    # the hit test of emissivity_rd.cpp:116: landed on the disc's polar angle
    hit = (out.ok & (out.theta >= theta_lim - 1e-3) & (out.redshift > 0)
           & (out.r >= r_isco))
    g = out.redshift
    weights = {"flux": 1.0 / (n_primary * g), "emis": 1.0 / g**gamma, "redshift": g,
               "time": out.t}
    weights = {k: v.to(sum_dtype or dtype) for k, v in weights.items()}
    counts, sums = radial_bin_profile(out.r, hit, weights, r_min, dr, n_r, logbin)
    counts = counts.cpu().numpy()
    sums = {k: v.double().cpu().numpy() for k, v in sums.items()}
    area = areas.numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        return {"r": disc_r.numpy(), "area": area, "rays": counts.astype(np.int64),
                "flux": sums["flux"] / area, "emis": sums["emis"] / area,
                "redshift": sums["redshift"] / counts, "time": sums["time"] / counts}

