"""Relativistic line profile from a traced disc image.

Counterpart of ``raytrace_tpu/apps/line_profile.py`` (the reference's
``python/line_from_image.ipynb`` analysis): fold a redshifted disc image
into the observed profile of an intrinsically narrow emission line, the
broad, skewed iron-K line. Each pixel adds its flux at observed energy
E = E_rest * g; the sum over pixels in energy bins is the profile.

Two modes: ``--image=<disc_image.fits>`` folds the maps of a disc-image
FITS file (numpy on the host); without it the disc image is traced first,
through ``apps.imageplane_disc_image.compute`` (the march kernel on the
card, rk45 by default). Both modes take ``--device`` as every app does.

    python -m raytrace_tpu_torch.apps.line_profile --parfile=par_example/imageplane_disc_image.par
        --outfile=line.dat [--image=<fits>] [--device=cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from raytrace_tpu_torch.apps import app_device, require_device
from raytrace_tpu_torch.config import Config
from raytrace_tpu_torch.io import TextOutput, read_fits


def line_profile_from_maps(flux, enshift, counts, e_rest=6.4, n_en=200, e0=None, e1=None):
    """Fold per-pixel (flux, g) maps into an observed line profile.

    flux is the count-normalised per-pixel flux map (already epsilon/g^3);
    enshift is the mean 1/redshift = E_obs/E_emit per pixel. A pixel's
    luminosity is flux * counts (each ray counted once). Returns the bin
    centres and the profile, between e0 (default 0.3 e_rest) and e1
    (default 1.3 e_rest) in n_en bins.
    """
    good = (counts > 0) & np.isfinite(flux) & np.isfinite(enshift) & (enshift > 0)
    e_obs = e_rest * enshift[good]
    w = (flux * counts)[good]
    if e0 is None:
        e0 = 0.3 * e_rest
    if e1 is None:
        e1 = 1.3 * e_rest
    edges = np.linspace(e0, e1, n_en + 1)
    prof, _ = np.histogram(e_obs, bins=edges, weights=w)
    centres = 0.5 * (edges[:-1] + edges[1:])
    return centres, prof


def main(argv=None):
    """Either --image=<disc_image.fits> (post-process) or a full trace with
    the disc-image parameters."""
    cfg = Config(argv)
    device = require_device(app_device(cfg))
    outfile = cfg.get("outfile", str)
    e_rest = cfg.get("line_en", float, 6.4)
    n_en = cfg.get("Nen", int, 200)

    if cfg.key_exists("image"):
        maps = read_fits(cfg.get("image", str))
        flux = maps["FLUX"].astype(float)
        enshift = maps["ENSHIFT"].astype(float)
        counts = maps["NRAYS"].astype(float)
    else:
        from raytrace_tpu_torch.apps.imageplane_disc_image import compute
        from raytrace_tpu_torch.sources import ImagePlaneGrid

        dist = cfg.get("dist", float)
        incl = cfg.get("incl", float)
        spin = cfg.get("spin", float)
        r_disc = cfg.get("r_disc", float)
        x0 = cfg.get("x0", float, -r_disc)
        xmax = cfg.get("xmax", float, r_disc)
        nx = cfg.get("Nx", int)
        dx = (xmax - x0) / nx
        grid = ImagePlaneGrid.from_steps(x0, xmax, dx, x0, xmax, dx)
        out = compute(
            spin, dist, incl, grid, r_disc,
            q1=cfg.get("q1", float, 3.0), rb1=cfg.get("rb1", float, 4.0),
            q2=cfg.get("q2", float, 3.0), rb2=cfg.get("rb2", float, 10.0),
            q3=cfg.get("q3", float, 3.0),
            method=cfg.get("integrator", str, "rk45").lower(),
            steplim=cfg.get("steplim", int, 20000),
            device=device,
        )
        flux, enshift, counts = out["flux"], out["enshift"], out["counts"]

    centres, prof = line_profile_from_maps(np.nan_to_num(flux), np.nan_to_num(enshift), counts,
                                           e_rest, n_en)
    with TextOutput(outfile) as f:
        f.write_columns(centres, prof)
    print(f"wrote {outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
