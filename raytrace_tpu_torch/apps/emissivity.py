"""Lamppost -> disc emissivity profile (the reference's flagship app).

Counterpart of ``raytrace_tpu/apps/emissivity.py`` (one device; reference
``emissivity.cpp``): trace an isotropic grid of rays from a point source
above the hole, keep those striking the equatorial disc outside the ISCO,
and accumulate per radial bin the ray count, photon flux, emissivity
(redshift^-gamma for a power-law source of index gamma), mean redshift and
mean arrival time, normalised by the proper annulus area. ``main_rd`` is the
destination-API variant (``emissivity_rd.cpp``): FlatDisc at theta_lim, RK4
by default, the destination's 4-velocity redshift.

Output: 7 text columns (r, area, N_rays, flux, emis, <g>, <t>).

    python -m raytrace_tpu_torch.apps.emissivity --parfile=par_example/emissivity.par [--device=cuda|cpu]

runs on the card unless ``--device=cpu`` is given. ``show_progress = 1``
shows the march's progress (``RT_PROGRESS``); ``RT_PROFILE=<dir>`` records
a profiler trace of the march and binning, and beside it, in
``spans.json``, the port's spans (``rt.compute``, ``rt.source``,
``rt.march`` ...) and each march launch's lane iterations on the trace's
clock (``utils.profiling.profile_trace``). Under ``torchrun`` with more
than one rank the plain variant splits its rays over the ranks
(``parallel.sharded_emissivity_bins``) and rank 0 writes the file.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

from raytrace_tpu_torch.apps import app_device, require_device
from raytrace_tpu_torch.config import Config
from raytrace_tpu_torch.destinations import FlatDisc
from raytrace_tpu_torch.geometry import integrate_disc_area_bins, isco_radius
from raytrace_tpu_torch.geometry.kerr import bl_to_cartesian
from raytrace_tpu_torch.io import TextOutput
from raytrace_tpu_torch.ops import StepControl, reductions, redshift, trace_auto
from raytrace_tpu_torch.ops.reductions import bin_edges, radial_bin_profile
from raytrace_tpu_torch.ops.redshift import (apply_redshift, apply_redshift_dest, range_phi,
                                             redshift_start)
from raytrace_tpu_torch.parallel import (RayMesh, auto_mesh, pad_rays, shard_rays,
                                         sharded_emissivity_bins)
from raytrace_tpu_torch.sources import PointSourceGrid, point_source
from raytrace_tpu_torch.utils import app_phase
from raytrace_tpu_torch.utils.profiling import span


def disc_hit_mask(out, spin, r_isco=None):
    """Disc-hit selection (emissivity.cpp:99-107): completed ray, close to the
    equatorial plane in height z, physical redshift, outside the ISCO."""
    if r_isco is None:
        r_isco = isco_radius(spin)
    _, _, z = bl_to_cartesian(out.r, out.theta, out.phi, spin)
    return out.ok & (z < 1e-2) & (out.redshift > 0) & (out.r >= r_isco)


# the weights of the radial bins, in the order of emissivity_bin_weights
WEIGHTS = ("flux", "emis", "redshift", "time")


def emissivity_bin_weights(out, gamma, n_primary=1.0):
    """Per-ray weights of the radial bins (emissivity.cpp:108-121): photon
    flux 1/(N g), emissivity 1/g^gamma, redshift and arrival time."""
    g = out.redshift
    return {
        "flux": 1.0 / (n_primary * g),
        "emis": 1.0 / g**gamma,
        "redshift": g,
        "time": out.t,
    }


def start_redshift(rays, spin, V):
    """``redshift_start(rays, spin, V)`` in the span ``rt.redshift``: on a
    batch ``ops.redshift.kernel_takes`` (float64 on a card, no derivative)
    one launch of its kernel, in ``rt.redshift.kernel``; torch's chain
    otherwise, in ``rt.redshift.torch``. The same bits either way."""
    with span("rt.redshift"):
        if redshift.kernel_takes(rays, spin, V):
            with span("rt.redshift.kernel"):
                return redshift.emit_kernel(rays, spin, V)
        with span("rt.redshift.torch"):
            return redshift_start(rays, spin, V)


def disc_bins(out, spin, variant, *, r_min, dr, n_r, logbin_r, gamma, n_primary,
              theta_lim=math.pi / 2):
    """The marched batch ``out`` into the radial bins: each ray's redshift,
    the hit test of ``variant`` ("plain": ``disc_hit_mask`` after the
    Keplerian-orbit redshift; "rd": theta >= theta_lim - 1e-3 after the
    FlatDisc 4-velocity's), the weights (``emissivity_bin_weights``) in
    the span ``rt.redshift``, then the bins in ``rt.bins``. Returns
    (counts, {flux, emis, redshift, time}). On a batch
    ``ops.redshift.kernel_takes`` everything before the bins is one launch
    of ``emis_weights_kernel`` (``rt.redshift.kernel``), torch's chain
    otherwise (``rt.redshift.torch``); the same bits either way (but the
    emis weight for a ``gamma`` outside torch's forms of ``pow``)."""
    if redshift.kernel_takes(out, spin, theta_lim, r_min, dr, gamma, n_primary):
        with span("rt.redshift"), span("rt.redshift.kernel"):
            ids, mask, columns = redshift.emis_weights_kernel(
                out, spin, variant, r_isco=isco_radius(spin), theta_lim=theta_lim, r_min=r_min,
                dr=dr, n_bins=n_r, logbin=logbin_r, gamma=gamma, n_primary=n_primary)
        with span("rt.bins"):
            counts, *sums = reductions.masked_bins(columns, ids, mask, n_r, torch.float64)
        return counts, dict(zip(WEIGHTS, sums))
    with span("rt.redshift"), span("rt.redshift.torch"):
        if variant == "plain":
            out = apply_redshift(range_phi(out), spin, V=-1.0)
            mask = disc_hit_mask(out, spin)
        elif variant == "rd":
            # destination-API route (emissivity_rd.cpp:99-116): the 4-velocity
            # redshift, hit test on the landing polar angle
            out = apply_redshift_dest(range_phi(out), spin, FlatDisc(theta_lim))
            mask = (out.ok & (out.theta >= theta_lim - 1e-3) & (out.redshift > 0)
                    & (out.r >= isco_radius(spin)))
        else:
            raise ValueError(f"unknown variant {variant!r}")
        weights = emissivity_bin_weights(out, gamma, n_primary)
    return radial_bin_profile(out.r, mask, weights, r_min, dr, n_r, logbin_r)


def compute(
    spin,
    source,
    V=0.0,
    grid: PointSourceGrid | None = None,
    r_max=1000.0,
    r_min=None,
    r_disc=500.0,
    n_r=100,
    logbin_r=True,
    gamma=2.0,
    method="rk45",
    steplim=None,
    ctrl=StepControl(),
    variant="plain",  # "plain" (emissivity.cpp) | "rd" (emissivity_rd.cpp)
    theta_lim=math.pi / 2,
    *,
    device,
    mesh=None,
):
    """Run the emissivity pipeline on ``device``; returns a dict of per-bin
    numpy columns. Sources, redshifts and bins are built in float64; the
    march goes through ``trace_auto``: the CUDA kernel in float32 for a
    CUDA device, the plain march (float64) otherwise. A CUDA device with
    no card visible raises.

    The plain variant marches and bins through
    ``parallel.sharded_emissivity_bins``: with a ``mesh``
    (``parallel.make_ray_mesh``) the batch is built on the mesh's device
    and split over its ranks, each marches and bins its shard and one
    ``all_reduce`` merges the bins, so every rank returns the same columns;
    without one the process is a world of one on ``device``. The ``rd``
    variant marches the whole batch on the mesh's device.

    Runs in the span ``rt.compute`` (``utils.profiling``): the source in
    ``rt.source``, the redshifts in ``rt.redshift`` (``start_redshift``,
    ``disc_bins``: on a card each one kernel launch in
    ``rt.redshift.kernel``, with nothing copied to the card, so the host
    queues the post-march work while the card marches), the march in
    ``rt.march``, the bins in ``rt.bins``, then the bins' areas on the host
    in ``rt.areas`` (after the card's work is queued, so that on a card
    they are built while it runs), the columns' copies to the host in
    ``rt.to_host``."""
    with span("rt.compute"):
        device = require_device(device if mesh is None else mesh.device)
        if r_min is None or r_min < 0:
            r_min = float(isco_radius(spin))
        disc_r, disc_width, dr = bin_edges(r_min, r_disc, n_r, logbin_r, device="cpu")

        # grid-cell count for the primary-flux normalisation (emissivity.cpp:61):
        # the reference counts cells without the +1 fencepost
        n_primary = ((grid.cosalphamax - grid.cosalpha0) / grid.dcosalpha) * (
            (grid.betamax - grid.beta0) / grid.dbeta
        )

        rays = point_source(source, V, spin, grid, device=device)
        if variant == "plain":
            mesh = mesh or RayMesh(group=None, rank=0, size=1, device=device)
            counts, sums = sharded_emissivity_bins(
                shard_rays(pad_rays(rays, mesh.size), mesh), spin, mesh, V=V, r_min=r_min,
                dr=dr, n_r=n_r, logbin_r=logbin_r, gamma=gamma, n_primary=n_primary,
                method=method, r_max=r_max, steplim=steplim, ctrl=ctrl)
        elif variant == "rd":
            # destination-API route (emissivity_rd.cpp:99-116): FlatDisc surface
            rays = trace_auto(start_redshift(rays, spin, V), spin, method=method,
                              dest=FlatDisc(theta_lim), r_max=r_max, steplim=steplim, ctrl=ctrl)
            counts, sums = disc_bins(rays, spin, "rd", r_min=r_min, dr=dr, n_r=n_r,
                                     logbin_r=logbin_r, gamma=gamma, n_primary=n_primary,
                                     theta_lim=theta_lim)
        else:
            raise ValueError(f"unknown variant {variant!r}")
        with span("rt.areas"):
            # per-bin proper area in the disc material rest frame (emissivity.cpp:79)
            areas = integrate_disc_area_bins(disc_r, disc_r + disc_width, spin)
        with span("rt.to_host"):
            return _columns(disc_r, areas, counts, sums)


def _columns(disc_r, areas, counts, sums) -> dict:
    """The output columns from the bins' counts and sums: flux and emis
    per unit area, redshift and time per ray."""
    counts_np = counts.cpu().numpy()
    sums = {k: v.cpu().numpy() for k, v in sums.items()}
    areas_np = areas.numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        return {
            "r": disc_r.numpy(),
            "area": areas_np,
            "rays": counts_np.astype(np.int64),
            "flux": sums["flux"] / areas_np,
            "emis": sums["emis"] / areas_np,
            "redshift": sums["redshift"] / counts_np,
            "time": sums["time"] / counts_np,
        }


def compute_args(cfg: Config, variant: str = "plain") -> dict:
    """``compute``'s keyword arguments from a run configuration (par file
    and CLI), with the reference's defaults for ``variant``."""
    source = cfg.get_array("source", float, 4)
    if cfg.args.key_exists("source_h"):
        source[1] = cfg.args.get("source_h", float)
    spin = cfg.get("spin", float)
    V = cfg.get("V", float, 0.0)
    grid = PointSourceGrid.from_steps(
        cfg.get("dcosalpha", float),
        cfg.get("dbeta", float),
        cfg.get("cosalpha0", float, -0.995),
        cfg.get("cosalphamax", float, 0.995),
        cfg.get("beta0", float, -math.pi),
        cfg.get("betamax", float, math.pi),
    )
    # the reference reads both limits from the key "r_esc"
    # (emissivity.cpp:46,51 — documented quirk, SURVEY.md §7)
    r_max = cfg.get("r_esc", float, 1000.0)
    r_disc = cfg.get("r_esc", float, 500.0)
    r_min = cfg.get("rmin", float, -1.0)
    n_r = cfg.get("Nr", int, 100)
    logbin_r = cfg.get("logbin_r", bool, True)
    gamma = cfg.get("gamma", float, 2.0)
    method = cfg.get("integrator", str, "rk4" if variant == "rd" else "rk45").lower()
    steplim = cfg.get("steplim", int, -1)
    device = app_device(cfg)
    return dict(
        spin=spin,
        source=source,
        V=V,
        grid=grid,
        r_max=r_max,
        r_min=None if r_min < 0 else r_min,
        r_disc=r_disc,
        n_r=n_r,
        logbin_r=logbin_r,
        gamma=gamma,
        method=method,
        steplim=None if steplim <= 0 else steplim,
        variant=variant,
        theta_lim=cfg.get("theta_lim", float, math.pi / 2),
        device=device,
    )


def _main(variant):
    def main(argv=None):
        cfg = Config(argv)
        outfile = cfg.get("outfile", str)
        kw = compute_args(cfg, variant)
        # reference par key (emissivity.par_example): the march's progress
        if cfg.get("show_progress", bool, False):
            os.environ.setdefault("RT_PROGRESS", "1")
        print(f"emissivity[{variant}]: spin={kw['spin']} source={kw['source']} "
              f"{kw['grid'].n_rays} rays on {kw['device']}")
        mesh = auto_mesh(kw["device"])
        if mesh is not None and variant == "plain":
            print(f"sharding {kw['grid'].n_rays} rays over {mesh.size} devices")
        with app_phase(f"emissivity {variant} march+bin"):
            out = compute(**kw, mesh=mesh)
        if mesh is None or mesh.rank == 0:
            with TextOutput(outfile) as f:
                f.write_columns(
                    out["r"], out["area"], out["rays"], out["flux"], out["emis"],
                    out["redshift"], out["time"],
                )
            print(f"wrote {outfile}")
        return 0

    return main


main = _main("plain")
main_rd = _main("rd")


if __name__ == "__main__":
    sys.exit(main())
