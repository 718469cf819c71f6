"""Lamppost diagnostic applications.

Counterpart of ``raytrace_tpu/apps/lamppost.py`` (the reference's
src/lamppost/ family):
  * ``main_sky``: a sky map over the launch-direction grid (cos alpha,
    beta) of where each photon ends, escape / disc / horizon, with its
    landing radius and redshift (pointsource_sky.cpp);
  * ``main_sky_discfrac``: the integrated fractions
    (pointsource_sky_discfrac.cpp);
  * ``main_angdist``: the angular emission distribution of static, jet and
    moving sources, with per-bin fates and the mean Killing energy
    (angdist_jetpoint.cpp, angdist_point_vel.cpp, angdist_point_plunge.cpp);
  * ``main_raystart``: the initial ray state (raystart_jetpoint.cpp);
  * ``main_solid_angle``: the solid-angle closure of the direction grid
    (source_solid_angle.cpp);
  * ``main_to_disc``: per-annulus illumination fraction, redshift and
    emissivity over ``apps.emissivity.compute`` (pointsource_to_disc.cpp).

Sources are built in float64; ``trace_auto`` marches them (the CUDA kernel
in float32 on the card, the plain march on the CPU).

    python -m raytrace_tpu_torch.apps.lamppost --parfile=par_example/emissivity.par --outfile=sky.fits [--v_jet=0.5] [--device=cuda|cpu]

runs ``main_sky`` on the card unless ``--device=cpu`` is given.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from raytrace_tpu_torch import mathfn
from raytrace_tpu_torch.apps import app_device, require_device
from raytrace_tpu_torch.config import Config
from raytrace_tpu_torch.geometry import isco_radius, metric_coeffs, momentum_from_consts
from raytrace_tpu_torch.geometry.disc import plunge_velocity
from raytrace_tpu_torch.io import FITSOutput, TextOutput
from raytrace_tpu_torch.ops import trace_auto
from raytrace_tpu_torch.ops.redshift import apply_redshift, range_phi, redshift_start
from raytrace_tpu_torch.rays import RAY_STATUS_DEST, RAY_STATUS_HORIZON, RAY_STATUS_RLIM
from raytrace_tpu_torch.sources import (
    PointSourceGrid,
    jet_point_source,
    point_source,
    point_source_vel,
)


def _np(x):
    return x.cpu().numpy()


def _grid_from_cfg(cfg, d_default=0.05):
    return PointSourceGrid.from_steps(
        cfg.get("dcosalpha", float, d_default),
        cfg.get("dbeta", float, d_default),
        cfg.get("cosalpha0", float, -0.995),
        cfg.get("cosalphamax", float, 0.995),
        cfg.get("beta0", float, -math.pi),
        cfg.get("betamax", float, math.pi),
    )


def _build_source(cfg, grid):
    """Source selector of the sky and angdist apps, on the run's device:
    static or orbiting at --V (the default), radial jet (--v_jet), plunging
    from the ISCO (--plunge) or any 4-velocity (--u_r/u_theta/u_phi, u^t
    solved from the normalisation). Returns (rays, spin, mode)."""
    device = require_device(app_device(cfg))
    if cfg.key_exists("source"):
        source = cfg.get_array("source", float, 4)
    else:
        source = [0.0, cfg.get("source_h", float, 5.0), 1e-3, 0.0]
    if cfg.args.key_exists("source_h"):
        source[1] = cfg.args.get("source_h", float)
    spin = cfg.get("spin", float)
    f64 = lambda x: torch.tensor(float(x), dtype=torch.float64)
    if cfg.key_exists("v_jet"):
        v = cfg.get("v_jet", float)
        rays = jet_point_source(tuple(source), v, spin, grid, device=device)
        mode = f"jet v={v}"
    elif cfg.key_exists("plunge"):
        # source plunging from the ISCO (angdist_point_plunge.cpp capability)
        u4 = plunge_velocity(f64(source[1]), spin)
        rays = point_source_vel(tuple(source), u4, spin, grid, device=device)
        mode = f"plunge r={source[1]}"
    elif cfg.key_exists("u_r"):
        ur = cfg.get("u_r", float, 0.0)
        uth = cfg.get("u_theta", float, 0.0)
        uph = cfg.get("u_phi", float, 0.0)
        g = metric_coeffs(f64(source[1]), f64(source[2]), spin)
        # g_tt ut^2 + 2 g_tphi ut uph + (spatial) = 1
        a_ = g.g_tt
        b_ = 2.0 * g.g_tphi * uph
        c_ = g.g_rr * ur**2 + g.g_thth * uth**2 + g.g_phph * uph**2 - 1.0
        ut = (-b_ + mathfn.sqrt(b_ * b_ - 4 * a_ * c_)) / (2 * a_)
        rays = point_source_vel(tuple(source), (ut, ur, uth, uph), spin, grid, device=device)
        mode = f"vel u=({float(ut):.3f},{ur},{uth},{uph})"
    else:
        V = cfg.get("V", float, 0.0)
        rays = point_source(tuple(source), V, spin, grid, device=device)
        mode = f"orbit V={V}"
    return rays, spin, mode


def _trace_fates(cfg, rays, spin, grid):
    """March the batch and classify each live ray: 0 captured (horizon, or
    crossing the plane inside the ISCO), 1 disc, 2 escaped, -1 none (dead
    or without a real end, as a superluminal source's rays). The launch
    energy takes --V even for a moving source, as the JAX app does."""
    r_max = cfg.get("r_esc", float, 500.0)
    steplim = cfg.get("steplim", int, 20000)
    method = cfg.get("integrator", str, "rk45").lower()
    rays = redshift_start(rays, spin, V=cfg.get("V", float, 0.0))
    out = trace_auto(rays, spin, method=method, r_max=r_max, steplim=steplim)
    out = range_phi(out)
    out = apply_redshift(out, spin, V=-1.0)
    st = _np(out.status)
    r_end = _np(out.r)
    live = _np(rays.steps) == 0
    r_isco = isco_radius(spin)
    fate = np.full(out.n_rays, -1, np.int32)
    fate[live & ((st & RAY_STATUS_HORIZON) != 0)] = 0
    fate[live & ((st & RAY_STATUS_DEST) != 0) & (r_end >= r_isco)] = 1
    fate[live & ((st & RAY_STATUS_RLIM) != 0)] = 2
    # equatorial crossings inside the ISCO plunge in
    fate[live & ((st & RAY_STATUS_DEST) != 0) & (r_end < r_isco)] = 0
    return out, fate, live


def main_sky(argv=None):
    """Direction-grid sky map of photon fates (pointsource_sky.cpp): FITS
    images FATE, LAND_R, REDSHIFT and TIME over (cos alpha, beta)."""
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    grid = _grid_from_cfg(cfg)
    rays, spin, mode = _build_source(cfg, grid)
    print(f"pointsource_sky [{mode}]: {grid.n_rays} rays on {rays.r.device}")
    out, fate, live = _trace_fates(cfg, rays, spin, grid)

    shape = (grid.n_cosalpha, grid.n_beta)
    fits = FITSOutput(outfile)
    fits.set_keyword("GENERATOR", "pointsource_sky")
    fits.set_keyword("SPIN", cfg.get("spin", float))
    fits.write_image(fate.reshape(shape).astype(np.int32), extname="FATE")
    fits.write_image(np.where(fate == 1, _np(out.r), 0.0).reshape(shape), extname="LAND_R")
    fits.write_image(np.where(fate == 1, _np(out.redshift), 0.0).reshape(shape),
                     extname="REDSHIFT")
    fits.write_image(_np(out.t).reshape(shape), extname="TIME")
    fits.close()
    n = max(live.sum(), 1)
    print(f"escape {np.sum(fate == 2) / n:.3f} disc {np.sum(fate == 1) / n:.3f} "
          f"capture {np.sum(fate == 0) / n:.3f}; wrote {outfile}")
    return 0


def main_sky_discfrac(argv=None):
    """Integrated disc / escape / capture fractions and the live count
    (pointsource_sky_discfrac.cpp)."""
    cfg = Config(argv)
    outfile = cfg.get("outfile", str, "")
    grid = _grid_from_cfg(cfg)
    rays, spin, mode = _build_source(cfg, grid)
    _, fate, live = _trace_fates(cfg, rays, spin, grid)
    n = max(live.sum(), 1)
    row = (np.sum(fate == 1) / n, np.sum(fate == 2) / n, np.sum(fate == 0) / n, int(n))
    print(f"[{mode}] disc {row[0]:.4f} escape {row[1]:.4f} capture {row[2]:.4f}")
    if outfile:
        with TextOutput(outfile) as f:
            f.row(*row)
        print(f"wrote {outfile}")
    return 0


def main_angdist(argv=None):
    """Angular emission distribution over the local cos(alpha): per bin the
    ray count, the mean Killing energy k (beaming shows as its anisotropy)
    and the disc / escape / capture fractions (angdist_* capability)."""
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    grid = _grid_from_cfg(cfg, d_default=0.02)
    rays, spin, mode = _build_source(cfg, grid)
    print(f"angdist [{mode}]: {grid.n_rays} rays on {rays.r.device}")
    out, fate, live = _trace_fates(cfg, rays, spin, grid)

    cosa = _np(out.alpha)
    kk = _np(out.k)
    n_bins = cfg.get("Nang", int, 40)
    edges = np.linspace(-1, 1, n_bins + 1)
    idx = np.clip(np.digitize(cosa, edges) - 1, 0, n_bins - 1)
    with TextOutput(outfile) as f:
        for i in range(n_bins):
            m = (idx == i) & live
            n = m.sum()
            if n == 0:
                f.row(0.5 * (edges[i] + edges[i + 1]), 0, 0.0, 0.0, 0.0, 0.0)
                continue
            f.row(
                0.5 * (edges[i] + edges[i + 1]),
                int(n),
                float(kk[m].mean()),
                float((fate[m] == 1).mean()),
                float((fate[m] == 2).mean()),
                float((fate[m] == 0).mean()),
            )
    print(f"wrote {outfile}")
    return 0


def main_raystart(argv=None):
    """Initial ray state of the live rays: cos alpha, beta, k, h, Q and the
    momentum (raystart_jetpoint.cpp capability)."""
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    grid = _grid_from_cfg(cfg, d_default=0.1)
    rays, spin, mode = _build_source(cfg, grid)
    pt, pr, pth, pph = momentum_from_consts(
        rays.r, rays.theta, rays.k, rays.h, rays.Q, rays.rdot_sign, rays.thetadot_sign, spin)
    live = _np(rays.steps) == 0
    cols = [_np(c)[live] for c in
            (rays.alpha, rays.beta, rays.k, rays.h, rays.Q, pt, pr, pth, pph)]
    with TextOutput(outfile) as f:
        f.write_columns(*cols)
    print(f"wrote {outfile} ({live.sum()} rays, {mode})")
    return 0


def main_solid_angle(argv=None):
    """Solid-angle closure of the direction grid: the live cells times
    dcosalpha * dbeta against the covered solid angle; exits 1 beyond 2%
    (source_solid_angle.cpp capability)."""
    cfg = Config(argv)
    device = require_device(app_device(cfg))
    grid = _grid_from_cfg(cfg, d_default=0.05)
    spin = cfg.get("spin", float, 0.9)
    source = cfg.get_array("source", float, 4) if cfg.key_exists("source") else [0, 5, 1e-3, 0]
    rays = point_source(tuple(source), 0.0, spin, grid, device=device)
    live = int((rays.steps == 0).sum())
    measured = live * grid.dcosalpha * grid.dbeta
    expected = (grid.cosalphamax - grid.cosalpha0) * (grid.betamax - grid.beta0)
    print(f"solid angle: measured {measured:.6f}, expected {expected:.6f}, "
          f"ratio {measured / expected:.6f}")
    return 0 if abs(measured / expected - 1) < 0.02 else 1


def main_to_disc(argv=None):
    """Per-annulus illumination fraction, mean redshift and emissivity
    (pointsource_to_disc.cpp), over ``apps.emissivity.compute``."""
    from raytrace_tpu_torch.apps.emissivity import compute

    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    spin = cfg.get("spin", float)
    grid = _grid_from_cfg(cfg)
    out = compute(
        spin,
        cfg.get_array("source", float, 4),
        V=cfg.get("V", float, 0.0),
        grid=grid,
        r_max=cfg.get("r_esc", float, 500.0),
        r_disc=cfg.get("r_disc", float, 100.0),
        n_r=cfg.get("Nr", int, 50),
        gamma=cfg.get("gamma", float, 2.0),
        steplim=cfg.get("steplim", int, 20000),
        device=app_device(cfg),
    )
    frac = out["rays"] / max(grid.n_rays, 1)
    with TextOutput(outfile) as f:
        f.write_columns(out["r"], frac, np.nan_to_num(out["redshift"]),
                        np.nan_to_num(out["emis"]))
    print(f"wrote {outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main_sky())
