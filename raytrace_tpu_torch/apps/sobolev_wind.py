"""Sobolev / SEI escape-probability wind line profiles.

Counterpart of ``raytrace_tpu/apps/sobolev_wind.py`` (reference standalone
models src/outflow/pcyg_sei.cpp, pcyg_rel.cpp, disc_wind.cpp): P-Cygni line
profiles from a beta-law wind in the Sobolev approximation with SEI-style
turbulent smearing, and the disc-wind variant with an equatorial wind cone
seen at any inclination (disc_wind.cpp:16-30):

  velocity    w(r) = w0 + (1 - w0)(1 - 1/r)^beta
  opt. depth  tau0(r) ∝ tau_tot w^alpha1 (1 - w)^alpha2 r (dw/dr) / w,
              normalised so the integral over w is tau_tot
  source fn   S(r) = (1 - sqrt(1 - 1/r^2)) / 2   (Castor 1970 dilution)
  resonance   solve w(r) mu = v along each (p, z) sightline
  tau(v,p)    Sobolev depth at resonance / (1 + sigma mu^2), smeared by
              erf((w mu - v)/turb) between the sightline entry and exit

Torch ops throughout: 64-point Gauss-Legendre quadrature for the tau
normalisation, a fixed 60-iteration bisection for the resonance points and
dense (p, phi) panel sums for the flux. The model is differentiable through
torch autograd: any ``WindParams`` field may be a tensor with
``requires_grad``. The resonance point depends on (v, p) alone, so it is
solved once on the (v, p) grid and broadcast over phi. sigma is evaluated
at r (disc_wind.cpp:203 passes r^2).

    python -m raytrace_tpu_torch.apps.sobolev_wind --outfile=disc_wind.dat [--Nen=200]
        [--device=cuda|cpu]

runs ``main_disc_wind``; ``main_pcyg_sei`` takes the same arguments.
"""

from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import torch

from raytrace_tpu_torch.apps import app_device, require_device
from raytrace_tpu_torch.config import Config
from raytrace_tpu_torch.io import TextOutput

_FLOATS = ("line_en", "vinf", "tau_tot", "wind_angle", "incl", "turb", "beta", "alpha1",
           "alpha2", "w0", "rout", "z")


@dataclasses.dataclass(frozen=True)
class WindParams:
    """XSPEC-ordered disc-wind parameters (disc_wind.cpp:16-30): Python
    floats or 0-d tensors (which may require grad)."""

    line_en: float = 1.0
    vinf: float = 0.1  # units of c
    tau_tot: float = 1.0
    wind_angle: float = 1.0  # cos of opening angle
    incl: float = 0.0  # radians
    turb: float = 0.1  # fraction of vinf
    beta: float = 1.0
    alpha1: float = 1.0
    alpha2: float = 1.0
    w0: float = 0.01
    rout: float = 10.0
    z: float = 0.0
    continuum: bool = True
    line_emis: bool = True

    def as_tensors(self, like: torch.Tensor) -> "WindParams":
        """Every float field as a 0-d tensor of ``like``'s dtype and device
        (a tensor keeps its graph)."""
        def cast(v):
            if not torch.is_tensor(v):
                v = torch.tensor(float(v), dtype=torch.float64)
            return v.to(dtype=like.dtype, device=like.device)

        return dataclasses.replace(self, **{f: cast(getattr(self, f)) for f in _FLOATS})


def _w(r, p: WindParams):
    return p.w0 + (1.0 - p.w0) * (1.0 - 1.0 / r) ** p.beta


def _dwdr(r, p: WindParams):
    return p.beta * (1.0 - p.w0) * (1.0 - 1.0 / r) ** (p.beta - 1.0) / (r * r)


def _sigma(r, p: WindParams):
    """r dlnw/dlnr - 1: the Sobolev directional factor (disc_wind.cpp:40-48)."""
    return r * _dwdr(r, p) / _w(r, p) - 1.0


def _tau_norm(p: WindParams, like, order=64):
    """integral_0^1 w^alpha1 (1-w)^alpha2 dw by Gauss-Legendre (numpy's
    nodes; replaces gsl_integration_qags, disc_wind.cpp:59-75)."""
    x, wts = np.polynomial.legendre.leggauss(order)
    x = torch.as_tensor(0.5 * (x + 1.0), dtype=like.dtype, device=like.device)
    wts = torch.as_tensor(0.5 * wts, dtype=like.dtype, device=like.device)
    return torch.sum(wts * x**p.alpha1 * (1.0 - x) ** p.alpha2)


def _tau0(r, p: WindParams, norm):
    w = _w(r, p)
    return p.tau_tot * w**p.alpha1 * (1.0 - w) ** p.alpha2 * r * _dwdr(r, p) / (w * norm)


def _source_func(r, p: WindParams):
    s = 0.5 * (1.0 - torch.sqrt(torch.clamp_min(1.0 - 1.0 / (r * r), 0.0)))
    return torch.where((r > 1.0) & p.line_emis, s, 0.0)


def _los_vel(z, pp, p: WindParams):
    """w(r) mu along the sightline at impact parameter pp (observer at
    z -> +inf; disc_wind.cpp:119-128)."""
    r = torch.sqrt(pp * pp + z * z)
    return _w(torch.clamp_min(r, 1.0 + 1e-9), p) * z / torch.clamp_min(r, 1e-12)


def _find_los_z(v, pp, p: WindParams, iters=60):
    """Bisection for the resonance point w mu = v on each sightline
    (replaces the GSL Brent solver, disc_wind.cpp:131-182). NaN where no
    root is bracketed."""
    lo = -p.rout * torch.ones_like(v * pp)
    hi = torch.where(pp > 1.0, p.rout, -torch.sqrt(torch.clamp_min(1.0 - pp * pp, 0.0)))
    f_lo = _los_vel(lo, pp, p) - v
    f_hi = _los_vel(hi, pp, p) - v
    bracketed = f_lo * f_hi <= 0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        f_mid = _los_vel(mid, pp, p) - v
        go_lo = f_lo * f_mid <= 0
        hi = torch.where(go_lo, mid, hi)
        lo, f_lo = torch.where(go_lo, lo, mid), torch.where(go_lo, f_lo, f_mid)
    root = 0.5 * (lo + hi)
    return torch.where(bracketed, root, math.nan)


def _z0_for(v, pp, p: WindParams):
    """Resonance point with the reference's fallbacks when no root exists
    (disc_wind.cpp:185-191)."""
    los_z = _find_los_z(v, pp, p)
    behind = -torch.sqrt(torch.clamp_min(p.rout**2 - pp * pp, 0.0))
    front = torch.sqrt(torch.clamp_min(p.rout**2 - pp * pp, 0.0))
    star = -torch.sqrt(torch.clamp_min(1.0 - pp * pp, 0.0))
    fallback = torch.where(v < -0.5, behind, torch.where((pp >= 1.0) & (v > 0.5), front, star))
    return torch.where(torch.isnan(los_z), fallback, los_z)


def _tau(z_start, z0, pp, phi, v, p: WindParams, norm):
    """Smeared Sobolev optical depth from z_start to the wind edge, with
    the resonance point z0 (disc_wind.cpp:184-204)."""
    r0 = torch.sqrt(pp * pp + z0 * z0)
    mu = z0 / torch.clamp_min(r0, 1e-12)

    r_in = torch.sqrt(pp * pp + z_start * z_start)
    mu_in = z_start / torch.clamp_min(r_in, 1e-12)
    w_in = _w(torch.clamp_min(r_in, 1.0 + 1e-9), p)
    w_out = _w(p.rout, p)
    mu_out = -torch.sqrt(torch.clamp_min(p.rout**2 - pp * pp, 0.0)) / p.rout
    profile = 0.5 * (torch.special.erf((w_in * mu_in - v) / p.turb)
                     - torch.special.erf((w_out * mu_out - v) / p.turb))
    costheta = (pp * torch.sin(phi) * torch.sin(p.incl) - z0 * torch.cos(p.incl)
                ) / torch.clamp_min(r0, 1e-12)
    in_wind = ((costheta < p.wind_angle) & (costheta > 0)).to(profile.dtype)
    r0c = torch.clamp_min(r0, 1.0 + 1e-6)
    return in_wind * profile * _tau0(r0c, p, norm) / (1.0 + _sigma(r0c, p) * mu * mu)


def _linspace(start, stop, num: int, endpoint: bool, like):
    """start (1 - t) + stop t at t = i / div, the endpoint appended: the
    form of ``jnp.linspace``, differentiable in tensor endpoints."""
    div = num - 1 if endpoint else num
    t = torch.arange(div, dtype=like.dtype, device=like.device)
    t = t / torch.tensor(float(div), dtype=like.dtype, device=like.device)
    out = start * (1 - t) + stop * t
    if endpoint:
        out = torch.cat([out, torch.as_tensor(stop, dtype=like.dtype,
                                              device=like.device).reshape(1)])
    return out


def disc_wind_profile(v_grid, p: WindParams, n_p: int = 160, n_phi: int = 48):
    """Normalised flux at each observed line-of-sight velocity (units of
    vinf), on ``v_grid``'s device and in its dtype: the (p, phi) panel
    integral of disc_wind.cpp:218-258 over the whole (v, p, phi) grid."""
    p = p.as_tensors(v_grid)
    norm = _tau_norm(p, v_grid)
    # log-spaced impact parameters: dense near the star (dp = p/precision,
    # floored, as the reference grows its panels)
    zero = torch.zeros((), dtype=v_grid.dtype, device=v_grid.device)
    pp = torch.cat([_linspace(1e-3, 1.0, n_p // 2, False, v_grid),
                    torch.exp(_linspace(zero, torch.log(p.rout), n_p // 2, True, v_grid))])
    dp = torch.diff(pp, append=p.rout.reshape(1))
    phi = _linspace(-math.pi, math.pi, n_phi, False, v_grid)
    dphi = 2 * math.pi / n_phi

    V, P, PHI = torch.meshgrid(v_grid, pp, phi, indexing="ij")
    V1, P1 = V[:, :, :1], P[:, :, :1]
    z0 = _z0_for(V1, P1, p).expand_as(V)
    r0 = torch.sqrt(P * P + z0 * z0)
    star_face = -torch.sqrt(torch.clamp_min(1.0 - P * P, 0.0))
    tau_star = _tau(star_face, z0, P, PHI, V, p, norm)
    tau_edge = _tau(torch.ones_like(P) * p.rout, z0, P, PHI, V, p, norm)
    this_tau = torch.where(P < 1.0, tau_star, tau_edge)

    emission = _source_func(r0, p) * (1.0 - torch.exp(-this_tau))
    costheta_star = P * torch.sin(PHI) * torch.sin(p.incl) + torch.sqrt(
        torch.clamp_min(1.0 - P * P, 0.0)) * torch.cos(p.incl)
    on_star = (P < 1.0) & (costheta_star > 0)
    contin = torch.where(on_star & p.continuum, torch.exp(-tau_star), 0.0)

    panel = P * (emission + contin) * dp[None, :, None] * dphi
    flux = panel.sum(dim=(1, 2))
    cont_norm = (torch.where(P < 1.0, P, 0.0) * dp[None, :, None] * dphi).sum(dim=(1, 2))
    return flux / cont_norm


def pcyg_sei_profile(v_grid, vinf=0.1, tau_tot=1.0, turb=0.1, beta=1.0, alpha1=1.0,
                     alpha2=1.0, w0=0.01, rout=10.0, line_emis=True, continuum=True, n_p=160,
                     *, device):
    """Spherically symmetric SEI profile (pcyg_sei.cpp capability): the
    disc-wind model with a full-sphere wind (wind_angle = 2 covers every
    azimuth at incl = 0), on ``device`` in float64."""
    device = require_device(device)
    p = WindParams(vinf=vinf, tau_tot=tau_tot, turb=turb, beta=beta, alpha1=alpha1,
                   alpha2=alpha2, w0=w0, rout=rout, wind_angle=2.0, incl=0.0,
                   line_emis=line_emis, continuum=continuum)
    v = torch.as_tensor(np.asarray(v_grid, dtype=np.float64), device=device)
    return disc_wind_profile(v, p, n_p=n_p, n_phi=8)


def main_disc_wind(argv=None):
    cfg = Config(argv)
    outfile = cfg.get("outfile", str, "disc_wind.dat")
    p = WindParams(
        line_en=cfg.get("line_en", float, 1.0),
        vinf=cfg.get("vinf", float, 0.1),
        tau_tot=cfg.get("tau_tot", float, 1.0),
        wind_angle=cfg.get("wind_angle", float, 1.0),
        incl=float(np.deg2rad(cfg.get("incl", float, 45.0))),
        turb=cfg.get("turb", float, 0.1),
        beta=cfg.get("beta", float, 1.0),
        alpha1=cfg.get("alpha1", float, 1.0),
        alpha2=cfg.get("alpha2", float, 1.0),
        w0=cfg.get("w0", float, 0.01),
        rout=cfg.get("rout", float, 10.0),
        z=cfg.get("z", float, 0.0),
        continuum=cfg.get("continuum", bool, True),
        line_emis=cfg.get("line_emis", bool, True),
    )
    device = require_device(app_device(cfg))
    n_en = cfg.get("Nen", int, 200)
    v = np.linspace(-1.5, 1.5, n_en)
    flux = disc_wind_profile(torch.as_tensor(v, device=device), p).cpu().numpy()
    # reference mapping (disc_wind.cpp:335): v = (line_en - E)/(line_en vinf)
    # so E = line_en (1 - v vinf) / (1 + z), the v < 0 trough blueward;
    # relativistic=1 takes the exact special-relativistic line-of-sight
    # Doppler factor (the pcyg_rel.cpp capability)
    vv = v * p.vinf
    if cfg.get("relativistic", bool, False):
        gamma = 1.0 / np.sqrt(1.0 - np.clip(vv * vv, 0.0, 0.999))
        energy = p.line_en * gamma * (1.0 - vv) / (1.0 + p.z)
    else:
        energy = p.line_en * (1.0 - vv) / (1.0 + p.z)
    with TextOutput(outfile) as f:
        f.write_columns(energy, v, flux)
    print(f"wrote {outfile}")
    return 0


def main_pcyg_sei(argv=None):
    cfg = Config(argv)
    outfile = cfg.get("outfile", str, "pcyg_sei.dat")
    n_en = cfg.get("Nen", int, 200)
    v = np.linspace(-1.5, 1.5, n_en)
    flux = pcyg_sei_profile(
        v,
        vinf=cfg.get("vinf", float, 0.1),
        tau_tot=cfg.get("tau_tot", float, 1.0),
        turb=cfg.get("turb", float, 0.1),
        beta=cfg.get("beta", float, 1.0),
        alpha1=cfg.get("alpha1", float, 1.0),
        alpha2=cfg.get("alpha2", float, 1.0),
        w0=cfg.get("w0", float, 0.01),
        rout=cfg.get("rout", float, 10.0),
        device=app_device(cfg),
    ).cpu().numpy()
    line_en = cfg.get("line_en", float, 1.0)
    vinf = cfg.get("vinf", float, 0.1)
    energy = line_en * (1.0 - v * vinf)  # v < 0 trough blueward (disc_wind.cpp:335)
    with TextOutput(outfile) as f:
        f.write_columns(energy, v, flux)
    print(f"wrote {outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main_disc_wind())
