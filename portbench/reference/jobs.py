"""One job of each configuration, computed by the plain reference.

``emissivity_columns`` is the lamppost emissivity table of
``apps.emissivity.compute(variant="plain")``; ``disc_image_pixels`` is the
ISCO disc image of ``apps.imageplane_disc_image.compute(variant="isco")`` at
a chosen set of pixels, marching only the camera rays that land in them.
Both take a job's parameters as the harness gives them (the configuration
file's ``par`` with the traffic row laid over it) and build their own rays.

``dtype`` is the precision of the source, the redshift and the bins (float64
as the configurations state), ``sum_dtype`` that of the bins' sums (default
``dtype``), ``march_dtype`` that of the march; the controls take some of
them one precision lower. A march in another dtype than the batch
goes as the port's kernel route takes it: the fresh-propagation state (the
sign gates and the first RK45 step) is set in the batch's dtype, the 15
marched float fields are rounded once to ``march_dtype``, marched, and
widened back, and the theta crossing is refined in the batch's dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .destinations import DiscWithISCO, ThetaLimit
from .disc import integrate_disc_area_bins
from .imageplane import ImagePlaneGrid, image_plane
from .kerr import bl_to_cartesian, horizon_radius, isco_radius
from .march import StepControl, _fresh_propagation_state, _refine_theta_crossing, trace
from .pointsource import PointSourceGrid, point_source
from .rays import RAY_STATUS_DEST, RayBatch
from .reductions import bin_edges, pixel_accumulate, radial_bin_profile
from .redshift import apply_redshift, range_phi, redshift_start

# the float fields a march changes or carries, as the kernel takes them
MARCHED_FLOATS = ("t", "r", "theta", "phi", "pt", "pr", "ptheta", "pphi",
                  "k", "h", "Q", "rdot_sign", "thetadot_sign", "dt", "emit")
COUNTERS = ("steps", "status", "rdot_flips", "equatorial_crossings",
            "r_was_positive", "theta_was_positive")


def march(rays: RayBatch, spin, *, march_dtype, method="rk45", dest=None, r_max=1000.0,
          steplim=None, ctrl=StepControl()) -> RayBatch:
    """March ``rays`` to their ends in ``march_dtype`` (see the module's
    docstring), with the theta crossing refined."""
    dest = ThetaLimit(math.pi / 2) if dest is None else dest
    rays = _fresh_propagation_state(rays, spin, horizon_radius(spin), method, ctrl)
    kw = dict(method=method, dest=dest, r_max=r_max, steplim=steplim, ctrl=ctrl, resume=True,
              refine_crossing=False)
    if march_dtype == rays.r.dtype:
        out = trace(rays, spin, **kw)
    else:
        m = trace(rays.to(dtype=march_dtype), spin, **kw)
        upd = {f: getattr(m, f).to(rays.r.dtype) for f in MARCHED_FLOATS}
        upd.update({f: getattr(m, f) for f in COUNTERS})
        out = rays.replace(**upd)
    return _refine_theta_crossing(out, dest, spin)


def point_grid(par) -> PointSourceGrid:
    return PointSourceGrid.from_steps(par["dcosalpha"], par["dbeta"], par["cosalpha0"],
                                      par["cosalphamax"], par["beta0"], par["betamax"])


def source_position(par) -> list:
    """The source's (t, r, theta, phi), its height ``source_h`` when the
    job gives one (the app's key)."""
    pos = [float(v) for v in par["source"]]
    if "source_h" in par:
        pos[1] = float(par["source_h"])
    return pos


@torch.no_grad()
def emissivity_columns(par, *, device, march_dtype, dtype=torch.float64, sum_dtype=None) -> dict:
    """The seven columns (r, area, rays, flux, emis, redshift, time) of the
    lamppost emissivity table (emissivity.cpp), as numpy arrays."""
    spin, V, gamma = float(par["spin"]), float(par["V"]), float(par["gamma"])
    n_r, logbin = int(par["Nr"]), bool(par["logbin_r"])
    grid = point_grid(par)
    r_isco = isco_radius(spin)
    r_min = float(r_isco)
    disc_r, disc_width, dr = bin_edges(r_min, float(par["r_disc"]), n_r, logbin, device="cpu",
                                       dtype=dtype)
    areas = integrate_disc_area_bins(disc_r, disc_r + disc_width, spin)
    # the reference counts grid cells without the +1 fencepost (emissivity.cpp:61)
    n_primary = ((grid.cosalphamax - grid.cosalpha0) / grid.dcosalpha) * (
        (grid.betamax - grid.beta0) / grid.dbeta)

    rays = point_source(source_position(par), V, spin, grid, device=device, dtype=dtype)
    rays = redshift_start(rays, spin, V)
    out = march(rays, spin, march_dtype=march_dtype, method=par["integrator"],
                r_max=float(par["r_max"]))
    out = apply_redshift(range_phi(out), spin, V=-1.0)
    _, _, z = bl_to_cartesian(out.r, out.theta, out.phi, spin)
    hit = out.ok & (z < 1e-2) & (out.redshift > 0) & (out.r >= r_isco)
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


def powerlaw3(r, q1, rb1, q2, rb2, q3):
    """3-segment broken power-law emissivity (imageplane_disc_image.cpp:20-28)."""
    inner = r ** (-q1)
    middle = rb1 ** (q2 - q1) * r ** (-q2)
    outer = rb1 ** (q2 - q1) * rb2 ** (q3 - q2) * r ** (-q3)
    return torch.where(r < rb1, inner, torch.where(r < rb2, middle, outer))


def camera(par):
    """The camera grid (the app's spacing convention, imageplane_disc_image.cpp:79:
    dx = (xmax - x0) / Nx, so Nx + 1 rays an axis) and the image's size."""
    x0, xmax, nx = float(par["x0"]), float(par["xmax"]), int(par["Nx"])
    y0, ymax, ny = float(par.get("y0", x0)), float(par.get("ymax", xmax)), int(par.get("Ny", nx))
    grid = ImagePlaneGrid.from_steps(x0, xmax, (xmax - x0) / nx, y0, ymax, (ymax - y0) / ny)
    img_nx = int(par.get("img_Nx", nx))
    return grid, img_nx, int(par.get("img_Ny", img_nx))


def pixel_of(alpha, beta, grid, img_nx, img_ny):
    """Each ray's pixel (ix, iy) from its plane coordinates, the image
    flipped in y (imageplane_disc_image.cpp:132-140)."""
    img_dx = grid.dx * (grid.nx - 1) / img_nx
    img_dy = grid.dy * (grid.ny - 1) / img_ny
    ix = torch.floor((alpha - grid.x0) / img_dx).long()
    iy = torch.floor((beta - grid.y0) / img_dy).long()
    return ix, img_ny - iy - 1


MAPS = ("flux", "r", "phi", "enshift", "time", "emis")


@torch.no_grad()
def disc_image_pixels(par, pixels, *, device, march_dtype, dtype=torch.float64,
                      sum_dtype=None) -> dict:
    """The ISCO disc image's seven maps (counts and the six count-normalised
    maps) at the flat pixel indices ``pixels`` (ix * img_ny + iy), as numpy
    arrays in the order of ``pixels``. Only the camera rays that land in
    those pixels are marched."""
    spin, dist, incl = float(par["spin"]), float(par["dist"]), float(par["incl"])
    r_disc = float(par["r_disc"])
    grid, img_nx, img_ny = camera(par)
    r_isco = isco_radius(spin)
    dest = DiscWithISCO(r_isco=r_isco, r_out=r_disc)
    a_trace = -spin  # traced backwards (imageplane.cpp:12)

    rays = image_plane(dist, incl, grid, spin, float(par.get("plane_phi0", 0.0)), device=device,
                       dtype=dtype, work_dtype=march_dtype)
    rays = redshift_start(rays, a_trace, V=0.0, reverse=True)
    pixels = torch.as_tensor(np.asarray(pixels), dtype=torch.int64, device=device)
    wanted = torch.zeros(img_nx * img_ny, dtype=torch.bool, device=device)
    wanted[pixels] = True
    ix, iy = pixel_of(rays.alpha, rays.beta, grid, img_nx, img_ny)
    in_image = (ix >= 0) & (ix < img_nx) & (iy >= 0) & (iy < img_ny)
    flat = torch.where(in_image, ix * img_ny + iy, 0)
    rays = rays[torch.nonzero(in_image & wanted[flat]).squeeze(1)]

    out = march(rays, a_trace, march_dtype=march_dtype, method=par["integrator"], dest=dest,
                r_max=1.1 * dist)
    out = range_phi(apply_redshift(out, a_trace, V=-1.0, reverse=True))
    g = out.redshift
    hit = out.ok & ((out.status & RAY_STATUS_DEST) != 0) & (g > 0)
    q = [float(par[k]) for k in ("q1", "rb1", "q2", "rb2", "q3")]
    emis = powerlaw3(out.r, *q)
    weights = {"flux": emis / g**3, "r": out.r, "phi": out.phi, "enshift": 1.0 / g,
               "time": out.t, "emis": emis}
    weights = {k: v.to(sum_dtype or dtype) for k, v in weights.items()}
    ix, iy = pixel_of(out.alpha, out.beta, grid, img_nx, img_ny)
    counts, images = pixel_accumulate(ix, iy, hit, weights, img_nx, img_ny)
    counts = counts.reshape(-1)[pixels].double().cpu().numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        result = {k: images[k].reshape(-1)[pixels].double().cpu().numpy() / counts for k in MAPS}
    result["counts"] = counts
    return result
