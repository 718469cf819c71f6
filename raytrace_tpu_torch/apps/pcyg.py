"""Flat-space P-Cygni line profile from a spherical beta-law wind.

Counterpart of ``raytrace_tpu/apps/pcyg.py`` (reference standalone
``pcyg``, src/outflow/pcyg.cpp): a Cartesian grid of parallel sightlines
marches through a spherical wind shell (r_min < r < r_sph) around a star of
radius r_star; per sightline and per energy bin, resonant line emission
with self-absorption accumulates along z, the continuum from star-covering
sightlines is attenuated by the integrated line opacity, and the summed
spectrum shows the P-Cygni blue absorption trough and red emission wing.

All sightlines advance together, one z-plane an iteration, with the
[rays, energies + 1] emission and absorption updated in place (the last
column is the scrap bin of samples outside the shell or the energy grid).
On the card the first plane runs eagerly and the others replay it as one
CUDA graph.

    python -m raytrace_tpu_torch.apps.pcyg --outfile=pcyg.dat [--Nx=200 --Nen=400 --dz=0.01]
        [--device=cuda|cpu]
"""

from __future__ import annotations

import math
import sys

import torch

from raytrace_tpu_torch.apps import app_device, require_device
from raytrace_tpu_torch.config import Config
from raytrace_tpu_torch.io import TextOutput
from raytrace_tpu_torch.ops import integrate
from raytrace_tpu_torch.ops.integrate import _div, _sdiv


def compute(
    r_sph=10.0,
    r_min=5.0,
    r_star=5.0,
    v0=0.2,
    nx: int = 200,
    dz=0.01,
    en0=0.8,
    en_max=1.2,
    n_en: int = 400,
    logbin_en: bool = False,
    dens0=10.0,
    tau=1.5,
    line_emis=1e-6,
    n_z: int | None = None,
    *,
    device,
):
    """Returns (energy, obs_emis, obs_continuum, obs_total), float64
    tensors of n_en values on ``device``. ``n_z`` (default int(2 r_sph /
    dz), in Python floats) is the number of z-planes, z = r_sph - iz dz;
    each adds one to ``integrate.iterations``."""
    device = require_device(device)
    if n_z is None:
        n_z = int(2 * float(r_sph) / float(dz))
    f64 = torch.float64
    dx = 2 * r_sph / nx
    x = -r_sph + torch.arange(nx, dtype=f64, device=device) * dx
    X, Y = torch.meshgrid(x, x, indexing="ij")
    X = X.reshape(-1)
    Y = Y.reshape(-1)
    n_rays = nx * nx

    i_en = torch.arange(n_en, dtype=f64, device=device)
    if logbin_en:
        den = math.exp(math.log(en_max / en0) / (n_en - 1))
        energy_grid = en0 * torch.full_like(i_en, den) ** i_en
    else:
        den = (en_max - en0) / (n_en - 1)
        energy_grid = en0 + den * i_en
    log_den = torch.log(torch.tensor(den, dtype=f64, device=device))

    rho_sq = X * X + Y * Y
    alive = torch.ones(n_rays, dtype=torch.bool, device=device)
    emis = torch.zeros((n_rays, n_en + 1), dtype=f64, device=device)
    absorb = torch.zeros((n_rays, n_en + 1), dtype=f64, device=device)
    iz = torch.zeros((), dtype=f64, device=device)

    def plane():
        z = r_sph - iz * dz
        r = torch.sqrt(rho_sq + z * z)
        this_v = v0 * (0.01 + 0.99 * (1.0 - 1.0 / r))
        costh = z / r
        gamma = 1.0 / torch.sqrt(1.0 - this_v * this_v)
        e_loc = 1.0 / (gamma * (1.0 - this_v * costh))
        if logbin_en:
            ien = torch.floor(torch.log(_sdiv(e_loc, en0)) / log_den).to(torch.int32)
        else:
            ien = torch.floor(_sdiv(e_loc - en0, den)).to(torch.int32)
        dens = _div(dens0, r * r * torch.abs(this_v))

        in_shell = alive & (r < r_sph) & (r > r_min) & (ien >= 0) & (ien < n_en)
        idx = torch.where(in_shell, ien, n_en).long()[:, None]
        tau_here = absorb.gather(1, idx)[:, 0]  # before this plane's opacity
        demis = torch.where(in_shell, (1.0 / (r * r)) * dz * dens * torch.exp(-tau_here)
                            * e_loc**3, 0.0)
        emis.scatter_add_(1, idx, demis[:, None])
        absorb.scatter_add_(1, idx, torch.where(in_shell, dz * dens, 0.0)[:, None])
        alive.logical_and_(r >= r_star)  # the sightline stops at the stellar surface
        iz.add_(1.0)

    if n_z > 0:
        plane()
        integrate.iterations += 1
        if device.type == "cuda" and integrate._CUDA_GRAPHS:
            graph = integrate._graph(plane)
            for _ in range(n_z - 1):
                graph.replay()
                integrate.iterations += 1
        else:
            for _ in range(n_z - 1):
                plane()
                integrate.iterations += 1
    emis = emis[:, :-1]
    absorb = absorb[:, :-1]

    obs_emis = emis.sum(dim=0)
    emis_sum = obs_emis.sum()

    # continuum: sightlines covering the stellar disc, attenuated by the
    # integrated line opacity scaled to the requested total tau
    # (pcyg.cpp:103-143; the reference scales by the central ray's total)
    centre = torch.argmin(rho_sq)  # the first minimum
    tau_total = absorb[centre].sum()
    on_star = rho_sq < r_star * r_star
    cont = torch.where(on_star[:, None], torch.exp(-_div(tau, tau_total) * absorb), 0.0)
    obs_continuum = cont.sum(dim=0)
    continuum_sum = obs_continuum.sum()

    obs_total = _div(line_emis, emis_sum) * obs_emis + obs_continuum / continuum_sum
    return energy_grid, obs_emis, obs_continuum, obs_total


def main(argv=None):
    cfg = Config(argv)
    outfile = cfg.get("outfile", str, "pcyg.dat")
    out = compute(
        r_sph=cfg.get("rsph", float, 10.0),
        r_min=cfg.get("rmin", float, 5.0),
        r_star=cfg.get("rstar", float, 5.0),
        v0=cfg.get("V", float, 0.2),
        nx=cfg.get("Nx", int, 200),
        dz=cfg.get("dz", float, 0.01),
        en0=cfg.get("en0", float, 0.8),
        en_max=cfg.get("enmax", float, 1.2),
        n_en=cfg.get("Nen", int, 400),
        logbin_en=cfg.get("logbin_en", bool, False),
        dens0=cfg.get("dens0", float, 10.0),
        tau=cfg.get("tau", float, 1.5),
        line_emis=cfg.get("line_emis", float, 1e-6),
        device=app_device(cfg),
    )
    energy, obs_emis, obs_cont, obs_total = (o.cpu().numpy() for o in out)
    with TextOutput(outfile) as f:
        f.write_columns(energy, obs_emis, obs_cont, obs_total)
    print(f"wrote {outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
