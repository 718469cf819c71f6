"""The lamppost emissivity table: ``apps.emissivity.compute(variant="plain")``
on one job's spin, source height and grid; the reference recomputes the
whole table (``reference.jobs.emissivity_columns``)."""

from __future__ import annotations

from portbench.drivers import load_port
from portbench.judge import count_gap, precision, rel_gap
from portbench.reference import jobs

# the source layer's entry as the app calls it; a traced run times it
SOURCE = ("raytrace_tpu_torch.apps.emissivity", "point_source")
COLUMNS = ("r", "area", "flux", "emis", "redshift", "time")


def load(device) -> bool:
    """The port's entry imported and its march library loaded (built by
    nvcc on a checkout's first run: True then)."""
    return load_port(SOURCE[0], device)


def rays(par) -> int:
    return jobs.point_grid(par).n_rays


def run(par, device) -> dict:
    from raytrace_tpu_torch.apps import emissivity
    from raytrace_tpu_torch.sources import PointSourceGrid

    grid = PointSourceGrid.from_steps(par["dcosalpha"], par["dbeta"], par["cosalpha0"],
                                      par["cosalphamax"], par["beta0"], par["betamax"])
    return emissivity.compute(
        spin=float(par["spin"]), source=jobs.source_position(par), V=float(par["V"]),
        grid=grid, r_max=float(par["r_max"]), r_disc=float(par["r_disc"]), n_r=int(par["Nr"]),
        logbin_r=bool(par["logbin_r"]), gamma=float(par["gamma"]), method=par["integrator"],
        variant="plain", device=device)


def sample(par, config, rng):
    """The whole table is checked."""
    return None


def reference(par, sample, config, *, device, lower=None) -> dict:
    march_dtype, dtype, sum_dtype = precision(config, device, lower)
    return jobs.emissivity_columns(par, device=device, march_dtype=march_dtype, dtype=dtype,
                                   sum_dtype=sum_dtype)


def control(par, sample, config, *, device, kind="all") -> dict:
    """The control ``kind`` (``judge.CONTROLS``) in the port's place."""
    return reference(par, sample, config, device=device, lower=kind)


def compare(out, ref, sample) -> dict:
    return {"rays_gap": count_gap(out["rays"], ref["rays"]),
            "col_gap": max(rel_gap(out[c], ref[c]) for c in COLUMNS)}
