"""Returning radiation: disc-to-disc re-illumination.

Counterpart of ``raytrace_tpu/apps/return_radiation.py`` (the reference's
src/return_radiation/ family): launch rays isotropically from a point on
the disc surface (theta = pi/2 - 1e-3, material in Keplerian orbit), march
them and measure
  * ``main_photonfrac``: the fractions returning to the disc, escaping and
    captured, per launch radius (disc_source_photonfrac.cpp);
  * ``main_photonfrac_r``: the returning rays binned by landing radius, the
    re-illumination kernel (disc_source_photonfrac_r.cpp);
  * ``main_return_angdist``: the launch directions that return
    (disc_source_return_angdist.cpp).

    python -m raytrace_tpu_torch.apps.return_radiation --spin=0.998 --outfile=frac.dat [--device=cuda|cpu]

runs ``main_photonfrac`` on the card unless ``--device=cpu`` is given.
"""

from __future__ import annotations

import math
import sys

import numpy as np

from raytrace_tpu_torch.apps import app_device, require_device
from raytrace_tpu_torch.config import Config
from raytrace_tpu_torch.geometry import isco_radius, keplerian_omega
from raytrace_tpu_torch.io import TextOutput
from raytrace_tpu_torch.ops import StepControl, trace_auto
from raytrace_tpu_torch.ops.reductions import bin_edges, radial_bin_profile
from raytrace_tpu_torch.ops.redshift import apply_redshift, range_phi, redshift_start
from raytrace_tpu_torch.rays import RAY_STATUS_DEST, RAY_STATUS_HORIZON, RAY_STATUS_RLIM
from raytrace_tpu_torch.sources import PointSourceGrid, point_source
from raytrace_tpu_torch.utils.progress import ProgressBar

DISC_EPS = 1e-3  # launch height above the disc plane (disc_source_photonfrac.cpp:55-62)


def disc_source_rays(r_launch, spin, grid: PointSourceGrid, *, device):
    """Ray batch from a point on the disc at radius r_launch, orbiting
    Keplerian."""
    V = keplerian_omega(float(r_launch), spin)
    return point_source((0.0, r_launch, math.pi / 2 - DISC_EPS, 0.0), V, spin, grid,
                        device=device)


def photon_fractions(r_launch, spin, grid: PointSourceGrid, r_esc=500.0, r_disc=500.0,
                     method="rk45", steplim=20000, ctrl=StepControl(), *, device):
    """March one disc-source launch radius on ``device``; returns the
    per-fate counts, the marched batch and the host masks of the returning
    and the live rays."""
    device = require_device(device)
    rays = disc_source_rays(r_launch, spin, grid, device=device)
    rays = redshift_start(rays, spin, V=keplerian_omega(float(r_launch), spin))
    out = trace_auto(rays, spin, method=method, r_max=r_esc, steplim=steplim, ctrl=ctrl)
    out = range_phi(out)
    out = apply_redshift(out, spin, V=-1.0)

    st = out.status.cpu().numpy()
    live = rays.steps.cpu().numpy() == 0
    r_isco = isco_radius(spin)
    r_end = out.r.cpu().numpy()
    dest = (st & RAY_STATUS_DEST) != 0
    disc_hit = dest & (r_end >= r_isco) & (r_end < r_disc) & live
    horizon = ((st & RAY_STATUS_HORIZON) != 0) & live
    escaped = ((st & RAY_STATUS_RLIM) != 0) & live
    # rays crossing inside the ISCO end on the plane; they plunge
    plunge = dest & (r_end < r_isco) & live
    return {
        "n_live": int(live.sum()),
        "n_return": int(disc_hit.sum()),
        "n_escape": int(escaped.sum()),
        "n_horizon": int(horizon.sum() + plunge.sum()),
        "out": out,
        "return_mask": disc_hit,
        "live": live,
    }


def main_photonfrac(argv=None):
    """Return / escape / capture fractions and the live count per launch
    radius (disc_source_photonfrac.cpp); by default 20 log-spaced radii
    from 1.01 r_isco to 50."""
    cfg = Config(argv)
    device = app_device(cfg)
    outfile = cfg.get("outfile", str)
    spin = cfg.get("spin", float)
    grid = PointSourceGrid.from_steps(
        cfg.get("dcosalpha", float, 0.05),
        cfg.get("dbeta", float, 0.05),
        cfg.get("cosalpha0", float, -0.995),
        cfg.get("cosalphamax", float, 0.995),
        cfg.get("beta0", float, -math.pi),
        cfg.get("betamax", float, math.pi),
    )
    r_esc = cfg.get("r_esc", float, 500.0)
    r0 = cfg.get("r0", float, isco_radius(spin) * 1.01)
    r_max = cfg.get("rmax", float, 50.0)
    n_r = cfg.get("Nr", int, 20)
    logbin = cfg.get("logbin_r", bool, True)
    steplim = cfg.get("steplim", int, 20000)

    radii, _, _ = bin_edges(r0, r_max, n_r, logbin, device="cpu")
    radii = radii.numpy()
    bar = ProgressBar(len(radii), label="launch radii")
    with TextOutput(outfile) as f:
        for i, r_l in enumerate(radii):
            res = photon_fractions(float(r_l), spin, grid, r_esc=r_esc, r_disc=r_esc,
                                   steplim=steplim, device=device)
            n = max(res["n_live"], 1)
            f.row(r_l, res["n_return"] / n, res["n_escape"] / n, res["n_horizon"] / n,
                  res["n_live"])
            bar.show(i + 1, extra=f"r={r_l:.3f} return {res['n_return'] / n:.3f} "
                     f"escape {res['n_escape'] / n:.3f} capture {res['n_horizon'] / n:.3f}")
    bar.done()
    print(f"wrote {outfile}")
    return 0


def main_photonfrac_r(argv=None):
    """Returning rays binned by landing radius (disc_source_photonfrac_r.cpp):
    r, count, photon flux over the live rays, mean redshift, mean time."""
    cfg = Config(argv)
    device = app_device(cfg)
    outfile = cfg.get("outfile", str)
    spin = cfg.get("spin", float)
    r_launch = cfg.get("r_source", float, 6.0)
    grid = PointSourceGrid.from_steps(cfg.get("dcosalpha", float, 0.02),
                                      cfg.get("dbeta", float, 0.02))
    r_esc = cfg.get("r_esc", float, 500.0)
    n_r = cfg.get("Nr", int, 50)
    logbin = cfg.get("logbin_r", bool, True)
    r_min = isco_radius(spin)
    r_disc = cfg.get("r_disc", float, 100.0)
    steplim = cfg.get("steplim", int, 20000)

    res = photon_fractions(r_launch, spin, grid, r_esc=r_esc, r_disc=r_disc,
                           steplim=steplim, device=device)
    out = res["out"]
    mask = out.r.new_tensor(res["return_mask"], dtype=bool)
    radii, _, dr = bin_edges(r_min, r_disc, n_r, logbin, device="cpu")
    counts, sums = radial_bin_profile(
        out.r, mask, {"flux": 1.0 / out.redshift, "redshift": out.redshift, "time": out.t},
        r_min, dr, n_r, logbin,
    )
    counts = counts.cpu().numpy()
    sums = {k: v.cpu().numpy() for k, v in sums.items()}
    with np.errstate(divide="ignore", invalid="ignore"):
        with TextOutput(outfile) as f:
            f.write_columns(radii.numpy(), counts, sums["flux"] / res["n_live"],
                            sums["redshift"] / counts, sums["time"] / counts)
    print(f"wrote {outfile}: {res['n_return']}/{res['n_live']} rays returned")
    return 0


def main_return_angdist(argv=None):
    """Launch cos(alpha) histogram of all live rays and of the returning
    ones, and their ratio (disc_source_return_angdist.cpp)."""
    cfg = Config(argv)
    device = app_device(cfg)
    outfile = cfg.get("outfile", str)
    spin = cfg.get("spin", float)
    r_launch = cfg.get("r_source", float, 6.0)
    grid = PointSourceGrid.from_steps(cfg.get("dcosalpha", float, 0.02),
                                      cfg.get("dbeta", float, 0.02))
    steplim = cfg.get("steplim", int, 20000)
    res = photon_fractions(r_launch, spin, grid, steplim=steplim, device=device)
    cosa = res["out"].alpha.cpu().numpy()  # launch cos(alpha)
    edges = np.linspace(-1, 1, cfg.get("Nang", int, 40) + 1)
    total, _ = np.histogram(cosa[res["live"]], bins=edges)
    returned, _ = np.histogram(cosa[res["return_mask"]], bins=edges)
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = returned / total
    with TextOutput(outfile) as f:
        f.write_columns(0.5 * (edges[:-1] + edges[1:]), total, returned, np.nan_to_num(frac))
    print(f"wrote {outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main_photonfrac())
