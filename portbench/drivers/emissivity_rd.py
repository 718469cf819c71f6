"""The destination-API lamppost emissivity table:
``apps.emissivity.compute(variant="rd")`` (FlatDisc at theta_lim, RK4 to
the configuration's step cap, the destination's 4-velocity redshift) on one
job's spin, source height and grid; the reference recomputes the whole table
(``reference.emissivity_rd.emissivity_rd_columns``). The source entry, the
rays a job traces, the sample (none: the whole table) and the comparison
are the plain emissivity's."""

from __future__ import annotations

from portbench.drivers.emissivity import SOURCE, compare, load, rays, sample  # noqa: F401
from portbench.judge import precision
from portbench.reference import jobs
from portbench.reference.emissivity_rd import emissivity_rd_columns


def run(par, device) -> dict:
    from raytrace_tpu_torch.apps import emissivity
    from raytrace_tpu_torch.sources import PointSourceGrid

    grid = PointSourceGrid.from_steps(par["dcosalpha"], par["dbeta"], par["cosalpha0"],
                                      par["cosalphamax"], par["beta0"], par["betamax"])
    return emissivity.compute(
        spin=float(par["spin"]), source=jobs.source_position(par), V=float(par["V"]),
        grid=grid, r_max=float(par["r_max"]), r_disc=float(par["r_disc"]), n_r=int(par["Nr"]),
        logbin_r=bool(par["logbin_r"]), gamma=float(par["gamma"]), method=par["integrator"],
        steplim=int(par["steplim"]), variant="rd", theta_lim=float(par["theta_lim"]),
        device=device)


def reference(par, sample, config, *, device, lower=None) -> dict:
    march_dtype, dtype, sum_dtype = precision(config, device, lower)
    return emissivity_rd_columns(par, device=device, march_dtype=march_dtype, dtype=dtype,
                                 sum_dtype=sum_dtype)


def control(par, sample, config, *, device, kind="all") -> dict:
    """The control ``kind`` (``judge.CONTROLS``) in the port's place."""
    return reference(par, sample, config, device=device, lower=kind)
