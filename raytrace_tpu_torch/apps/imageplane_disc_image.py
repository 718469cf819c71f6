"""Redshifted accretion-disc images from a backward-traced observer plane.

Counterpart of ``raytrace_tpu/apps/imageplane_disc_image.py`` (one device;
reference ``imageplane_disc_image*.cpp``):

  * ``main`` (plain): theta-limit disc; per-pixel maps of flux
    epsilon(r)/g^3 with a 3-segment broken power-law emissivity, radius,
    phi, energy shift 1/g, arrival time and emissivity, count-normalised,
    written as a multi-extension FITS file;
  * ``main_rd``: the same through the destination API — FlatDisc at
    theta_lim, RK4 by default, the destination's 4-velocity redshift (with
    reverse=True, unlike the reference's ``_rd`` app);
  * ``main_isco``: the DiscWithISCO annulus; rays crossing the equator
    inside the ISCO continue to the horizon (Euler refused,
    imageplane_disc_image_isco.cpp:76-80).

    python -m raytrace_tpu_torch.apps.imageplane_disc_image --parfile=par_example/imageplane_disc_image.par [--device=cuda|cpu]

runs ``main`` on the card unless ``--device=cpu`` is given; ``main_rd`` and
``main_isco`` take the same arguments. ``show_progress = 1`` shows the
march's progress (``RT_PROGRESS``); ``RT_PROFILE=<dir>`` records a profiler
trace of the march and accumulation, and beside it, in ``spans.json``, the
port's spans (``rt.compute``, ``rt.source``, ``rt.march`` ...) and each
march launch's lane iterations on the trace's clock
(``utils.profiling.profile_trace``). Under ``torchrun`` with more than one
rank the rays split over the ranks (``parallel.sharded_disc_image``) and
rank 0 writes the file.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

from raytrace_tpu_torch.apps import app_device, require_device
from raytrace_tpu_torch.config import Config
from raytrace_tpu_torch.destinations import DiscWithISCO, FlatDisc, ThetaLimit
from raytrace_tpu_torch.geometry import isco_radius
from raytrace_tpu_torch.geometry.kerr import bl_to_cartesian
from raytrace_tpu_torch.io import FITSOutput
from raytrace_tpu_torch.ops import StepControl
from raytrace_tpu_torch.ops.reductions import pixel_accumulate
from raytrace_tpu_torch.ops.redshift import apply_redshift, apply_redshift_dest, range_phi
from raytrace_tpu_torch.parallel import RayMesh, auto_mesh, sharded_disc_image
from raytrace_tpu_torch.rays import RAY_STATUS_DEST
from raytrace_tpu_torch.sources import ImagePlaneGrid, image_plane
from raytrace_tpu_torch.utils import app_phase
from raytrace_tpu_torch.utils.profiling import span


def powerlaw3(r, q1, rb1, q2, rb2, q3):
    """3-segment broken power-law emissivity profile
    (imageplane_disc_image.cpp:20-28)."""
    inner = r ** (-q1)
    middle = rb1 ** (q2 - q1) * r ** (-q2)
    outer = rb1 ** (q2 - q1) * rb2 ** (q3 - q2) * r ** (-q3)
    return torch.where(r < rb1, inner, torch.where(r < rb2, middle, outer))


def accumulate_image_maps(
    out,
    spin,
    grid: ImagePlaneGrid,
    r_disc,
    img_nx,
    img_ny,
    *,
    variant="plain",
    dest=None,
    theta_lim=math.pi / 2,
    r_isco=None,
    q1=3.0,
    rb1=4.0,
    q2=3.0,
    rb2=10.0,
    q3=3.0,
    flip_image=True,
):
    """Post-march accumulation: redshift, hit mask, per-pixel maps
    (imageplane_disc_image.cpp:118-176). Returns (counts, images dict),
    not yet divided by the counts."""
    a_trace = -spin
    if r_isco is None:
        r_isco = isco_radius(spin)

    with span("rt.redshift"):
        if variant == "rd":
            out = apply_redshift_dest(out, a_trace, dest, reverse=True)
        else:
            out = apply_redshift(out, a_trace, V=-1.0, reverse=True)
        out = range_phi(out)

    g = out.redshift
    if variant == "plain":
        _, _, z = bl_to_cartesian(out.r, out.theta, out.phi, spin)
        hit = out.ok & (z < 1e-2) & (out.r >= r_isco) & (out.r < r_disc) & (g > 0)
    elif variant == "rd":
        hit = (out.ok & (out.theta >= theta_lim - 1e-3) & (out.r >= r_isco)
               & (out.r < r_disc) & (g > 0))
    else:  # isco: the destination already encodes the annulus
        hit = out.ok & ((out.status & RAY_STATUS_DEST) != 0) & (g > 0)

    # pixel binning from the stored plane coordinates
    # (imageplane_disc_image.cpp:132-140): img_dx = (xmax - x0)/img_Nx over
    # the grid's span x0 .. x0 + (nx-1)*dx = xmax
    img_dx = grid.dx * (grid.nx - 1) / img_nx
    img_dy = grid.dy * (grid.ny - 1) / img_ny
    ix = torch.floor((out.alpha - grid.x0) / img_dx).long()
    iy = torch.floor((out.beta - grid.y0) / img_dy).long()
    if flip_image:
        iy = img_ny - iy - 1

    emis = powerlaw3(out.r, q1, rb1, q2, rb2, q3)
    weights = {
        "flux": emis / g**3,
        "r": out.r,
        "phi": out.phi,
        "enshift": 1.0 / g,
        "time": out.t,
        "emis": emis,
    }
    return pixel_accumulate(ix, iy, hit, weights, img_nx, img_ny)


def compute(
    spin,
    dist,
    incl_deg,
    grid: ImagePlaneGrid,
    r_disc,
    img_nx=None,
    img_ny=None,
    q1=3.0,
    rb1=4.0,
    q2=3.0,
    rb2=10.0,
    q3=3.0,
    phi0=0.0,
    variant="plain",  # "plain" | "rd" | "isco"
    theta_lim=math.pi / 2,
    method="rk45",
    flip_image=True,
    steplim=None,
    ctrl=StepControl(),
    *,
    device,
    mesh=None,
    march_dtype=None,
):
    """Trace the camera grid on ``device`` and accumulate the per-pixel
    disc maps. Returns a dict of (img_nx, img_ny) numpy arrays: counts,
    flux, r, phi, enshift, time, emis — count-normalised like the reference
    (imageplane_disc_image.cpp:166-176).

    The batch is built, redshifted and binned in float64; the march goes
    through ``trace_auto``: the CUDA kernel in ``march_dtype`` for a CUDA
    device (float32 when None, as the TPU kernel marches), the plain march
    in float64 otherwise (where ``march_dtype`` must be None or float64).
    The image plane's knife-edge floor is set for the march's dtype. A CUDA
    device with no card visible raises.

    The march and the accumulation go through
    ``parallel.sharded_disc_image``: with a ``mesh``
    (``parallel.make_ray_mesh``) the camera is built on the mesh's device
    and its rays split over the ranks, each marches and accumulates its
    shard and one ``all_reduce`` merges the maps, so every rank returns the
    same maps; without one the process is a world of one on ``device``.

    Runs in the span ``rt.compute`` (``utils.profiling``): the camera in
    ``rt.source``, the redshifts in ``rt.redshift``, the march in
    ``rt.march``, the pixels in ``rt.bins``, the maps' copies to the host
    in ``rt.to_host``.
    """
    with span("rt.compute"):
        device = require_device(device if mesh is None else mesh.device)
        img_nx = img_nx or grid.nx
        img_ny = img_ny or grid.ny
        r_isco = isco_radius(spin)

        if variant == "plain":
            dest = ThetaLimit(math.pi / 2)
        elif variant == "rd":
            dest = FlatDisc(theta_lim)
        elif variant == "isco":
            if method == "euler":
                raise ValueError("Euler integrator not supported for the ISCO variant "
                                 "(imageplane_disc_image_isco.cpp:76-80)")
            dest = DiscWithISCO(r_isco=r_isco, r_out=r_disc)
        else:
            raise ValueError(f"unknown variant {variant!r}")

        if march_dtype is None:  # trace_auto marches a CUDA batch in float32 (ops/__init__.py)
            march_dtype = torch.float32 if device.type == "cuda" else torch.float64
        rays = image_plane(dist, incl_deg, grid, spin, phi0, device=device,
                           work_dtype=march_dtype)
        counts, images = sharded_disc_image(
            rays, spin, mesh or RayMesh(group=None, rank=0, size=1, device=device), grid=grid,
            r_disc=r_disc, img_nx=img_nx, img_ny=img_ny, method=method, r_max=1.1 * dist,
            steplim=steplim, ctrl=ctrl, variant=variant, dest=dest, theta_lim=theta_lim,
            r_isco=r_isco, q1=q1, rb1=rb1, q2=q2, rb2=rb2, q3=q3, flip_image=flip_image,
            march_dtype=march_dtype)
        with span("rt.to_host"):
            counts_np = counts.cpu().numpy()
            with np.errstate(divide="ignore", invalid="ignore"):
                result = {k: v.cpu().numpy() / counts_np for k, v in images.items()}
        result["counts"] = counts_np
        return result


def _main(variant):
    def main(argv=None):
        cfg = Config(argv)
        outfile = cfg.get("outfile", str)
        dist = cfg.get("dist", float)
        incl = cfg.get("incl", float)
        phi0 = cfg.get("plane_phi0", float, 0.0)
        spin = cfg.get("spin", float)
        r_disc = cfg.get("r_disc", float)
        x0 = cfg.get("x0", float, -r_disc)
        xmax = cfg.get("xmax", float, r_disc)
        nx = cfg.get("Nx", int)
        y0 = cfg.get("y0", float, x0)
        ymax = cfg.get("ymax", float, xmax)
        ny = cfg.get("Ny", int, nx)
        img_nx = cfg.get("img_Nx", int, nx)
        img_ny = cfg.get("img_Ny", int, img_nx)
        q1 = cfg.get("q1", float, 3.0)
        rb1 = cfg.get("rb1", float, 4.0)
        q2 = cfg.get("q2", float, 3.0)
        rb2 = cfg.get("rb2", float, 10.0)
        q3 = cfg.get("q3", float, 3.0)
        flip_image = cfg.get("flip_image", bool, True)
        method = cfg.get("integrator", str, "rk4" if variant == "rd" else "rk45").lower()
        rk45_tol = cfg.get("rk45_tol", float, 1e-8)
        theta_lim = cfg.get("theta_lim", float, math.pi / 2)
        steplim = cfg.get("steplim", int, -1)
        # reference par keys (imageplane_disc_image.par_example)
        precision = cfg.get("precision", float, 100.0)
        max_tstep = cfg.get("max_tstep", float, 1.0)
        device = app_device(cfg)
        # reference par key (imageplane_disc_image.par_example): the march's progress
        if cfg.get("show_progress", bool, False):
            os.environ.setdefault("RT_PROGRESS", "1")

        # ray-grid spacing convention of the app (imageplane_disc_image.cpp:79):
        # dx = (xmax - x0)/Nx, and the plane then carries Nx+1 rays per axis
        grid = ImagePlaneGrid.from_steps(x0, xmax, (xmax - x0) / nx, y0, ymax, (ymax - y0) / ny)
        print(f"disc_image[{variant}]: spin={spin} incl={incl} "
              f"{grid.nx}x{grid.ny} rays -> {img_nx}x{img_ny} image on {device}")
        mesh = auto_mesh(device)
        if mesh is not None:
            print(f"sharding {grid.n_rays} rays over {mesh.size} devices")
        with app_phase(f"disc_image {variant} march+accumulate"):
            out = compute(
                spin, dist, incl, grid, r_disc,
                img_nx=img_nx, img_ny=img_ny,
                q1=q1, rb1=rb1, q2=q2, rb2=rb2, q3=q3, phi0=phi0,
                variant=variant, theta_lim=theta_lim, method=method,
                flip_image=flip_image,
                steplim=None if steplim <= 0 else steplim,
                ctrl=StepControl(rk45_tol=rk45_tol, precision=precision, max_tstep=max_tstep),
                device=device, mesh=mesh,
            )

        n_disc = int(out["counts"].sum())
        print(f"{n_disc} rays hit the disc")
        if mesh is not None and mesh.rank != 0:
            return 0

        fits = FITSOutput(outfile)
        fits.write_comment("Raytraced images of accretion disc")
        fits.set_keyword("GENERATOR", f"imageplane_disc_image_{variant}")
        fits.set_keyword("DIST", dist, "Distance to image plane")
        fits.set_keyword("INCL", incl, "Inclination of line of sight")
        fits.set_keyword("SPIN", spin, "Black hole spin")
        fits.set_keyword("ISCO", float(isco_radius(spin)), "Innermost stable circular orbit")
        fits.set_keyword("RDISC", r_disc, "Maximum radius of disc")
        for key, val in [("Q1", q1), ("RB1", rb1), ("Q2", q2), ("RB2", rb2), ("Q3", q3)]:
            fits.set_keyword(key, val, "Emissivity profile parameter")
        fits.set_keyword("NRAYS", grid.n_rays, "Number of rays")
        fits.set_keyword("DISCRAYS", n_disc, "Rays hitting disc")
        for name, key in [
            ("FLUX", "flux"), ("RADIUS", "r"), ("PHI", "phi"),
            ("ENSHIFT", "enshift"), ("TIME", "time"), ("EMIS", "emis"),
            ("NRAYS", "counts"),
        ]:
            img = np.nan_to_num(out[key], nan=0.0, posinf=0.0, neginf=0.0)
            fits.write_image(img, extname=name)
            fits.set_keyword("AXIS1", "Image plane X", "Quantity along X axis")
            fits.set_keyword("AXIS2", "Image plane Y", "Quantity along Y axis")
            fits.set_keyword("XMAX", xmax, "End of X axis")
            fits.set_keyword("YMAX", ymax, "End of Y axis")
        fits.close()
        print(f"wrote {outfile}")
        return 0

    return main


main = _main("plain")
main_rd = _main("rd")
main_isco = _main("isco")

if __name__ == "__main__":
    sys.exit(main())
