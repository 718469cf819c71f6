"""HEALPix-source applications: solid-angle-exact illumination.

Counterpart of ``raytrace_tpu/apps/healpix_apps.py`` (the reference's
src/healpix/ family):
  * ``main_to_disc``: HEALPix-uniform emission from a lamppost binned onto
    the disc, each pixel weighted by exactly 4 pi / npix (healpix_to_disc.cpp);
  * ``main_disc_photonfrac``: returning-radiation fractions of a
    disc-surface source emitting uniformly over its upper hemisphere
    (healpix_disc_source_photonfrac.cpp).
The whole 5 x npix batch is marched (``trace_auto``); the centre rays, the
first npix, are binned.

    python -m raytrace_tpu_torch.apps.healpix_apps --spin=0.998 --source="0 5 1e-3 0" --order=8 --outfile=hp.dat [--device=cuda|cpu]

runs ``main_to_disc`` on the card unless ``--device=cpu`` is given.
"""

from __future__ import annotations

import math
import sys

import numpy as np

from raytrace_tpu_torch.apps import app_device, require_device
from raytrace_tpu_torch.config import Config
from raytrace_tpu_torch.geometry import isco_radius, keplerian_omega
from raytrace_tpu_torch.io import TextOutput
from raytrace_tpu_torch.ops import trace_auto
from raytrace_tpu_torch.ops.reductions import bin_edges, radial_bin_profile
from raytrace_tpu_torch.ops.redshift import apply_redshift, range_phi, redshift_start
from raytrace_tpu_torch.rays import RAY_STATUS_DEST, RAY_STATUS_HORIZON, RAY_STATUS_RLIM
from raytrace_tpu_torch.sources import healpix_point_source


def _trace(cfg, rays, spin):
    rays = redshift_start(rays, spin, V=cfg.get("V", float, 0.0))
    out = trace_auto(rays, spin, method=cfg.get("integrator", str, "rk45").lower(),
                     r_max=cfg.get("r_esc", float, 500.0), steplim=cfg.get("steplim", int, 20000))
    return apply_redshift(range_phi(out), spin, V=-1.0)


def main_to_disc(argv=None):
    """HEALPix lamppost -> per-annulus r, count, flux, emissivity and mean
    redshift, every centre ray weighted by its pixel's 4 pi / npix."""
    cfg = Config(argv)
    device = require_device(app_device(cfg))
    outfile = cfg.get("outfile", str)
    spin = cfg.get("spin", float)
    order = cfg.get("order", int, 4)
    source = cfg.get_array("source", float, 4)
    rays, npix = healpix_point_source(tuple(source), spin, order=order,
                                      V=cfg.get("V", float, 0.0), device=device)
    print(f"healpix_to_disc: {npix} pixels x 5 rays, order {order}, on {device}")
    sub = _trace(cfg, rays, spin)[:npix]  # the centre rays are slot 0
    r_isco = isco_radius(spin)
    g = sub.redshift
    mask = sub.ok & ((sub.status & RAY_STATUS_DEST) != 0) & (g > 0) & (sub.r >= r_isco)

    r_min = cfg.get("rmin", float, r_isco)
    r_disc = cfg.get("r_disc", float, 100.0)
    n_r = cfg.get("Nr", int, 50)
    radii, _, dr = bin_edges(r_min, r_disc, n_r, True, device="cpu")
    w = 4.0 * math.pi / npix  # each pixel's solid angle
    counts, sums = radial_bin_profile(sub.r, mask,
                                      {"flux": w / g, "emis": w / g**2, "redshift": g},
                                      r_min, dr, n_r, True)
    counts = counts.cpu().numpy()
    sums = {k: v.cpu().numpy() for k, v in sums.items()}
    with np.errstate(divide="ignore", invalid="ignore"):
        with TextOutput(outfile) as f:
            f.write_columns(radii.numpy(), counts, sums["flux"], sums["emis"],
                            sums["redshift"] / counts)
    print(f"wrote {outfile}: {int(counts.sum())} disc hits")
    return 0


def main_disc_photonfrac(argv=None):
    """Disc-surface HEALPix source at --r_source -> return / escape /
    capture fractions over its upper-hemisphere pixels."""
    cfg = Config(argv)
    device = require_device(app_device(cfg))
    outfile = cfg.get("outfile", str, "")
    spin = cfg.get("spin", float)
    order = cfg.get("order", int, 4)
    r_src = cfg.get("r_source", float, 6.0)
    V = keplerian_omega(r_src, spin)
    rays, npix = healpix_point_source((0.0, r_src, math.pi / 2 - 1e-3, 0.0), spin, order=order,
                                      V=V, disc_source=True, device=device)
    sub = _trace(cfg, rays, spin)[:npix]
    live = sub.steps.cpu().numpy() > 0
    st = sub.status.cpu().numpy()
    r_end = sub.r.cpu().numpy()
    r_isco = isco_radius(spin)
    dest = (st & RAY_STATUS_DEST) != 0
    ret = live & dest & (r_end >= r_isco)
    esc = live & ((st & RAY_STATUS_RLIM) != 0)
    cap = live & (((st & RAY_STATUS_HORIZON) != 0) | (dest & (r_end < r_isco)))
    n = max(live.sum(), 1)
    print(f"r={r_src}: return {ret.sum() / n:.4f} escape {esc.sum() / n:.4f} "
          f"capture {cap.sum() / n:.4f} ({n} hemisphere pixels)")
    if outfile:
        with TextOutput(outfile) as f:
            f.row(r_src, ret.sum() / n, esc.sum() / n, cap.sum() / n, int(n))
        print(f"wrote {outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main_to_disc())
