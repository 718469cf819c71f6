"""Raw ray-trajectory dumps.

Counterpart of ``raytrace_tpu/apps/trace_rays.py`` (the reference's
``trace_rays``, src/ray_paths/trace_rays.cpp, ``trace_rays_imageplane``,
and the jet and moving-source variants): march a small ray set with
``ops.history.trace_with_history`` and write every write_step-th position
as text rows, (t, x, y, z) Cartesian or (t, r, theta, phi)
Boyer-Lindquist, within an optional radius window, rays separated by blank
lines, for the plotting layer. The recording march is plain torch in
float64 on the run's device.

    python -m raytrace_tpu_torch.apps.trace_rays --parfile=par_example/trace_rays.par [--device=cuda|cpu]

runs on the card unless ``--device=cpu`` is given.
"""

from __future__ import annotations

import math
import sys

import torch

from raytrace_tpu_torch import mathfn
from raytrace_tpu_torch.apps import app_device, require_device
from raytrace_tpu_torch.config import Config
from raytrace_tpu_torch.destinations import ThetaLimit
from raytrace_tpu_torch.geometry.kerr import keplerian_omega, metric_coeffs
from raytrace_tpu_torch.ops.history import dump_trajectories, trace_with_history
from raytrace_tpu_torch.sources import (
    ImagePlaneGrid,
    PointSourceGrid,
    image_plane,
    jet_point_source,
    point_source,
    point_source_vel,
)


def main(argv=None):
    """Lamppost trajectory dump (trace_rays.cpp)."""
    cfg = Config(argv)
    device = require_device(app_device(cfg))
    outfile = cfg.get("outfile", str)
    source = cfg.get_array("source", float, 4)
    V = cfg.get("V", float, -1.0)
    spin = cfg.get("spin", float)
    grid = PointSourceGrid.from_steps(
        cfg.get("dcosalpha", float),
        cfg.get("dbeta", float),
        cfg.get("cosalpha0", float, -0.995),
        cfg.get("cosalphamax", float, 0.995),
        cfg.get("beta0", float, -math.pi),
        cfg.get("betamax", float, math.pi),
    )
    r_max = cfg.get("r_max", float, 100.0)
    theta_max = cfg.get("theta_max", float, math.pi / 2)
    write_step = cfg.get("write_step", int, 10)
    write_rmin = cfg.get("write_rmin", float, -1.0)
    write_rmax = cfg.get("write_rmax", float, -1.0)
    write_cartesian = cfg.get("write_cartesian", bool, True)
    n_snapshots = cfg.get("n_snapshots", int, 1024)
    method = cfg.get("integrator", str, "euler").lower()

    # V = -1 means Keplerian at the source radius (trace_rays.cpp:59)
    if V == -1:
        V = float(keplerian_omega(source[1], spin))

    rays = point_source(tuple(source), V, spin, grid, device=device)
    print(f"trace_rays: {grid.n_rays} rays, {n_snapshots} snapshots "
          f"every {write_step} steps on {device}")
    _, history = trace_with_history(
        rays, spin, method=method, dest=ThetaLimit(theta_max), r_max=r_max,
        write_step=write_step, n_snapshots=n_snapshots,
    )
    dump_trajectories(outfile, rays, history, spin, write_rmax, write_rmin, write_cartesian)
    print(f"wrote {outfile}")
    return 0


def main_imageplane(argv=None):
    """Backward image-plane trajectory dump (trace_rays_imageplane.cpp),
    marched with the spin -spin out to 1.5 dist. The reference passes tol
    into the phi0 slot of its ctor (trace_rays_imageplane.cpp:58); phi0 is
    passed correctly here."""
    cfg = Config(argv)
    device = require_device(app_device(cfg))
    outfile = cfg.get("outfile", str)
    dist = cfg.get("dist", float)
    incl = cfg.get("incl", float)
    phi0 = cfg.get("plane_phi0", float, 0.0)
    spin = cfg.get("spin", float)
    x0 = cfg.get("x0", float)
    xmax = cfg.get("xmax", float)
    nx = cfg.get("Nx", int)
    y0 = cfg.get("y0", float)
    ymax = cfg.get("ymax", float)
    ny = cfg.get("Ny", int)
    theta_max = cfg.get("thetamax", float, 0.0)
    write_step = cfg.get("write_step", int, 10)
    write_rmin = cfg.get("write_rmin", float, -1.0)
    write_rmax = cfg.get("write_rmax", float, -1.0)
    write_cartesian = cfg.get("write_cartesian", bool, True)
    n_snapshots = cfg.get("n_snapshots", int, 1024)
    method = cfg.get("integrator", str, "euler").lower()

    dx = (xmax - x0) / max(nx - 1, 1)
    dy = (ymax - y0) / max(ny - 1, 1)
    grid = ImagePlaneGrid(nx=nx, ny=ny, x0=x0, y0=y0, dx=dx, dy=dy)
    rays = image_plane(dist, incl, grid, spin, phi0, device=device)
    print(f"trace_rays_imageplane: {grid.n_rays} rays on {device}")
    _, history = trace_with_history(
        rays, -spin, method=method, dest=ThetaLimit(theta_max), r_max=1.5 * dist,
        write_step=write_step, n_snapshots=n_snapshots,
    )
    dump_trajectories(outfile, rays, history, -spin, write_rmax, write_rmin, write_cartesian)
    print(f"wrote {outfile}")
    return 0


def _main_moving(kind):
    """Trajectory dumps of moving sources (trace_rays_jetpoint.cpp /
    trace_rays_vel.cpp capability)."""

    def main(argv=None):
        cfg = Config(argv)
        device = require_device(app_device(cfg))
        outfile = cfg.get("outfile", str)
        source = (cfg.get_array("source", float, 4) if cfg.key_exists("source")
                  else [0.0, cfg.get("source_h", float, 5.0), 1e-3, 0.0])
        spin = cfg.get("spin", float)
        grid = PointSourceGrid.from_steps(
            cfg.get("dcosalpha", float, 0.4), cfg.get("dbeta", float, 1.5),
            cfg.get("cosalpha0", float, -0.995),
            cfg.get("cosalphamax", float, 0.995),
            cfg.get("beta0", float, -math.pi), cfg.get("betamax", float, math.pi),
        )
        if kind == "jet":
            rays = jet_point_source(tuple(source), cfg.get("v_jet", float, 0.5), spin, grid,
                                    device=device)
        else:
            ur = cfg.get("u_r", float, 0.0)
            uph = cfg.get("u_phi", float, 0.0)
            g = metric_coeffs(torch.tensor(source[1], dtype=torch.float64),
                              torch.tensor(source[2], dtype=torch.float64), spin)
            a_, b_ = g.g_tt, 2.0 * g.g_tphi * uph
            c_ = g.g_rr * ur**2 + g.g_phph * uph**2 - 1.0
            ut = (-b_ + mathfn.sqrt(b_ * b_ - 4 * a_ * c_)) / (2 * a_)
            rays = point_source_vel(tuple(source), (ut, ur, 0.0 * ut, uph), spin, grid,
                                    device=device)
        _, history = trace_with_history(
            rays, spin, method=cfg.get("integrator", str, "euler").lower(),
            dest=ThetaLimit(cfg.get("theta_max", float, math.pi / 2)),
            r_max=cfg.get("r_max", float, 100.0),
            write_step=cfg.get("write_step", int, 10),
            n_snapshots=cfg.get("n_snapshots", int, 1024),
        )
        dump_trajectories(outfile, rays, history, spin,
                          cfg.get("write_rmax", float, -1.0),
                          cfg.get("write_rmin", float, -1.0),
                          cfg.get("write_cartesian", bool, True))
        print(f"wrote {outfile}")
        return 0

    return main


main_jetpoint = _main_moving("jet")
main_vel = _main_moving("vel")


if __name__ == "__main__":
    sys.exit(main())
