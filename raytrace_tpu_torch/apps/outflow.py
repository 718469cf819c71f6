"""Outflow / wind line-profile applications.

Counterpart of ``raytrace_tpu/apps/outflow.py`` (one device; the reference
outflow family, src/outflow/):

  * ``main`` (outflow.cpp): backward image-plane rays traced through an
    emitting wind; per-ray (= per impact parameter) emission and
    absorption spectra as text;
  * ``main_ent`` (outflow_ent.cpp): the summed spectrum and the (energy,
    time) response (``<outfile>.ent.npz``);
  * ``main_spectrum`` (outflow_spectrum.cpp): the per-ray emission folded
    through an input line spectrum (text or QDP, ``--spectrum=``);
  * ``main_pointsource_mapper`` (pointsource_mapper.cpp): lamppost
    illumination of the 3-D (r, theta, phi) volume through the mapper, per
    cell mean arrival time, redshift, ray count and proper volume, as NPZ
    and a FITS cube (and HDF5 where h5py is installed);
  * ``main_emis_bin`` (outflow_emis_bin.cpp): the wind emissivity binned
    through the image-plane mapper.

The rays are built, redshifted and marched in float64 on the run's device
by the lock-step marches of ``ops/source_tracer.py`` and ``ops/mapper.py``.

    python -m raytrace_tpu_torch.apps.outflow --parfile=par_example/outflow.par [--device=cuda|cpu]

runs ``main``; the other entry points take the same arguments
(``main_pointsource_mapper`` with ``par_example/pointsource_mapper.par``).
"""

from __future__ import annotations

import math
import sys

import numpy as np

from raytrace_tpu_torch.apps import app_device, require_device
from raytrace_tpu_torch.config import Config
from raytrace_tpu_torch.io import FITSOutput, TextOutput, read_spectrum
from raytrace_tpu_torch.ops.mapper import (
    MapperGrid,
    average_maps,
    cell_volumes,
    map_rays,
    save_hdf,
)
from raytrace_tpu_torch.ops.redshift import redshift_start
from raytrace_tpu_torch.ops.source_tracer import (
    EnergyTimeBins,
    SphericalStop,
    WindModel,
    run_source_trace,
)
from raytrace_tpu_torch.sources import (
    ImagePlaneGrid,
    PointSourceGrid,
    image_plane,
    point_source,
)


def _wind_setup(cfg):
    wind = WindModel(
        v0=cfg.get("source_vel", float, 0.1),
        r_in=cfg.get("wind_rin", float, 10.0),
        r_out=cfg.get("wind_rout", float, 50.0),
        theta_min=cfg.get("wind_thetamin", float, 0.5),
        theta_max=cfg.get("wind_thetamax", float, math.pi / 2),
    )
    bins = EnergyTimeBins(
        en0=cfg.get("en0", float, 0.1),
        en_max=cfg.get("enmax", float, 10.0),
        n_en=cfg.get("Nen", int, 200),
        logbin_en=cfg.get("logbin_en", bool, True),
        t0=cfg.get("t0", float, 0.0),
        dt=cfg.get("dt", float, 100.0),
        n_t=cfg.get("Nt", int, 1),
    )
    return wind, bins


def _map_grid(cfg):
    return MapperGrid(
        r0=cfg.get("map_r0", float, 1.5),
        r_max=cfg.get("map_rmax", float, 100.0),
        n_r=cfg.get("map_Nr", int, 50),
        n_theta=cfg.get("map_Ntheta", int, 25),
        n_phi=cfg.get("map_Nphi", int, 50),
        logbin_r=cfg.get("map_logbin_r", bool, True),
        theta_max=cfg.get("map_thetamax", float, math.pi),
    )


def _image_plane_rays(cfg):
    """The camera batch (float64, on the run's device) after
    ``redshift_start``; the plane's spacing is (xmax - x0)/(Nx - 1)."""
    device = require_device(app_device(cfg))
    dist = cfg.get("dist", float)
    incl = cfg.get("incl", float)
    spin = cfg.get("spin", float)
    x0 = cfg.get("x0", float)
    xmax = cfg.get("xmax", float)
    nx = cfg.get("Nx", int)
    y0 = cfg.get("y0", float, x0)
    ymax = cfg.get("ymax", float, xmax)
    ny = cfg.get("Ny", int, nx)
    dx = (xmax - x0) / max(nx - 1, 1)
    dy = (ymax - y0) / max(ny - 1, 1)
    grid = ImagePlaneGrid(nx=nx, ny=ny, x0=x0, y0=y0, dx=dx, dy=dy)
    rays = image_plane(dist, incl, grid, spin, device=device)
    rays = redshift_start(rays, -spin, V=0.0, reverse=True)
    return rays, grid, spin, dist


def _run_outflow(cfg):
    rays, grid, spin, dist = _image_plane_rays(cfg)
    wind, bins = _wind_setup(cfg)
    stop = SphericalStop(cfg.get("source_radius", float, 0.0))
    steplim = cfg.get("steplim", int, 100_000)
    _, emis, absorb, resp = run_source_trace(rays, -spin, wind, bins, stop=stop,
                                             r_lim=1.5 * dist, steplim=steplim)
    return grid, bins, emis.cpu().numpy(), absorb.cpu().numpy(), resp.cpu().numpy()


def main(argv=None):
    """Per-ray emission/absorption spectra (outflow.cpp)."""
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    grid, bins, emis, absorb, _ = _run_outflow(cfg)
    energies = bins.energies()
    with TextOutput(outfile) as f:
        for ray in range(emis.shape[0]):
            if emis[ray].sum() == 0:
                continue
            for ien in range(bins.n_en):
                f.row(ray, energies[ien], emis[ray, ien], absorb[ray, ien])
            f.newline(2)
    print(f"wrote {outfile}")
    return 0


def main_ent(argv=None):
    """Summed spectrum plus the (energy, time) response (outflow_ent.cpp)."""
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    grid, bins, emis, absorb, resp = _run_outflow(cfg)
    energies = bins.energies()
    spec = emis.sum(axis=0)
    with TextOutput(outfile) as f:
        f.write_columns(energies, spec)
    np.savez(outfile + ".ent.npz", energies=energies, response=resp)
    print(f"wrote {outfile} (+.ent.npz response {resp.shape})")
    return 0


def main_spectrum(argv=None):
    """Wind profile folded through an input line spectrum
    (outflow_spectrum.cpp)."""
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    specfile = cfg.get("spectrum", str)
    line_en, line_counts = read_spectrum(specfile)
    grid, bins, emis, absorb, _ = _run_outflow(cfg)
    energies = bins.energies()
    profile = emis.sum(axis=0)
    # fold: spectrum(E) = sum_l counts_l * profile(E / E_l), with the wind
    # profile computed around unit rest energy
    folded = np.zeros_like(energies)
    for e_l, c_l in zip(line_en, line_counts):
        shifted = np.interp(energies / e_l, energies, profile, left=0, right=0)
        folded += c_l * shifted
    with TextOutput(outfile) as f:
        f.write_columns(energies, folded)
    print(f"wrote {outfile}")
    return 0


def main_pointsource_mapper(argv=None):
    """Lamppost -> 3-D illumination map (pointsource_mapper.cpp)."""
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    source = cfg.get_array("source", float, 4)
    V = cfg.get("V", float, 0.0)
    spin = cfg.get("spin", float)
    device = require_device(app_device(cfg))
    grid = PointSourceGrid.from_steps(
        cfg.get("dcosalpha", float),
        cfg.get("dbeta", float),
        cfg.get("cosalpha0", float, -0.995),
        cfg.get("cosalphamax", float, 0.995),
        cfg.get("beta0", float, -math.pi),
        cfg.get("betamax", float, math.pi),
    )
    mgrid = _map_grid(cfg)
    steplim = cfg.get("steplim", int, 100_000)

    rays = point_source(tuple(source), V, spin, grid, device=device)
    rays = redshift_start(rays, spin, V)
    print(f"pointsource_mapper: {grid.n_rays} rays -> "
          f"{mgrid.n_r}x{mgrid.n_theta}x{mgrid.n_phi} cells on {device}")
    _, maps = map_rays(
        rays, spin, mgrid,
        r_lim=cfg.get("r_max", float, mgrid.r_max),
        theta_lim=cfg.get("theta_max", float, math.pi / 2),
        steplim=steplim,
    )
    avg = average_maps(maps)
    vol = cell_volumes(mgrid, spin).numpy()

    np.savez(
        outfile + ".npz",
        time=avg["time"], redshift=avg["redshift"], count=avg["count"],
        volume=vol, r0=mgrid.r0, r_max=mgrid.r_max, logbin_r=mgrid.logbin_r,
        n_rays=grid.n_rays,
    )
    fits = FITSOutput(outfile)
    fits.set_keyword("GENERATOR", "pointsource_mapper")
    fits.set_keyword("SPIN", spin)
    fits.set_keyword("NRAYS", grid.n_rays)
    for name, data in [("TIME", avg["time"]), ("REDSHIFT", avg["redshift"]),
                       ("NRAYS", avg["count"]), ("VOLUME", vol)]:
        fits.write_image(np.nan_to_num(data, nan=0.0), extname=name, transpose=False)
    fits.close()
    extra = ""
    try:
        save_hdf(outfile + ".h5", mgrid, avg, vol, n_rays=grid.n_rays)
        extra = f", {outfile}.h5"
    except ImportError:  # without h5py the NPZ and FITS outputs stand alone
        print("h5py is not installed: no HDF5 export")
    except OSError as exc:  # the NPZ and FITS outputs above already landed
        print(f"HDF5 export failed ({exc}); NPZ/FITS outputs are complete")
    print(f"wrote {outfile} and {outfile}.npz{extra}")
    return 0


def main_emis_bin(argv=None):
    """Wind emissivity binned through the image-plane mapper
    (outflow_emis_bin.cpp)."""
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    rays, grid, spin, dist = _image_plane_rays(cfg)
    mgrid = _map_grid(cfg)
    _, maps = map_rays(
        rays, -spin, mgrid, r_lim=1.5 * dist, theta_lim=0.0,
        motion=1, vel=cfg.get("source_vel", float, 0.1),
        vel_mode=cfg.get("vel_mode", int, 0), reverse=True,
        steplim=cfg.get("steplim", int, 100_000),
    )
    avg = average_maps(maps)
    vol = cell_volumes(mgrid, spin).numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        emissivity = avg["count"] / (grid.n_rays * vol) * np.nan_to_num(avg["redshift"]) ** -2
    np.savez(outfile + ".npz", emissivity=emissivity, **avg, volume=vol)
    print(f"wrote {outfile}.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
