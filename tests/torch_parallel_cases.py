"""What each rank runs in tests/test_torch_parallel*.py: functions of a
``RayMesh`` that ``raytrace_tpu_torch.parallel.multiprocess_check.launch``
calls in every rank, and the tests call in-process on a world of one, so
that the two compare like for like. Each returns a dict of numpy arrays.
Not a test module (pytest collects ``test_*.py`` only)."""

import numpy as np
import torch

SPIN = 0.998
SOURCE = (0.0, 5.0, 1e-3, 0.0)
# tests/test_parallel.py's rays, bins, bundles and camera
TRACE_GRID = (0.15, 0.15, -0.9, 0.9, -3.0, 3.0)
TRACE_KW = dict(method="rk4", r_max=200.0, steplim=3000)
BINS = dict(r_min=1.3, r_disc=100.0, n_r=24)
CAUSTIC_GRID = (-8.0, 8.0, 1.6, -8.0, 8.0, 1.6)
CAUSTIC_KW = dict(target="disc", r_disc=15.0, use_bundles=True, method="rk45", steplim=20000)
IMAGE_GRID = (-12.0, 12.0, 1.5, -12.0, 12.0, 1.5)
GRAD_GRID = (0.3, 0.3, -0.9, 0.9, -3.0, 3.0)
FIT_GRID = (-10.5, 11.5, 2.0, -10.5, 11.5, 2.0)
FIT_KW = dict(dist=100.0, r_disc=15.0)


def _fields(rays, prefix):
    return {f"{prefix}{f}": getattr(rays, f).detach().cpu().numpy()
            for f in rays.__dataclass_fields__}


def lamppost(device="cpu"):
    from raytrace_tpu_torch.sources import PointSourceGrid, point_source

    grid = PointSourceGrid.from_steps(*TRACE_GRID)
    return grid, point_source(SOURCE, 0.0, SPIN, grid, device=device)


def caustic_bundles(device="cpu"):
    """The caustic test's bundle batch after redshift_start, with its
    propagation spin and destination, as apps.caustics.compute marches it
    at spin 0.9, dist 100, incl 60."""
    from raytrace_tpu_torch.destinations import DiscWithISCO
    from raytrace_tpu_torch.geometry import isco_radius
    from raytrace_tpu_torch.ops.redshift import redshift_start
    from raytrace_tpu_torch.sources import ImagePlaneGrid, image_plane_bundles

    rays, _ = image_plane_bundles(100.0, 60.0, ImagePlaneGrid.from_steps(*CAUSTIC_GRID), 0.9,
                                  0.0, eps_frac=0.01, device=device)
    rays = redshift_start(rays, -0.9, V=0.0, reverse=True)
    return rays, -0.9, DiscWithISCO(r_isco=isco_radius(0.9), r_out=15.0)


def marches(mesh):
    """This rank's shard of the padded lamppost after sharded_trace, and
    the three apps' compute over the mesh (``marches_alone`` without one):
    the emissivity bins (tests/test_parallel.py's rk4 bins through
    sharded_emissivity_bins), the caustic bundles' maps (through
    sharded_caustic_trace) and the disc image (sharded_disc_image)."""
    from raytrace_tpu_torch.parallel import pad_rays, shard_rays, sharded_trace

    _, rays = lamppost(mesh.device)
    shard = shard_rays(pad_rays(rays, mesh.size), mesh)
    out = _fields(sharded_trace(shard, SPIN, mesh, **TRACE_KW), "trace_")
    out.update(apps(mesh.device, mesh))
    return out


def apps(device, mesh=None):
    """The three apps' compute on ``device``, over ``mesh`` if given."""
    from raytrace_tpu_torch.apps import caustics, emissivity, imageplane_disc_image
    from raytrace_tpu_torch.sources import ImagePlaneGrid, PointSourceGrid

    out = {}
    emis = emissivity.compute(SPIN, SOURCE, grid=PointSourceGrid.from_steps(*TRACE_GRID),
                              r_max=TRACE_KW["r_max"], r_min=BINS["r_min"],
                              r_disc=BINS["r_disc"], n_r=BINS["n_r"], method="rk4",
                              steplim=TRACE_KW["steplim"], device=device, mesh=mesh)
    out.update({f"emis_{k}": v for k, v in emis.items()})
    maps = caustics.compute(0.9, 100.0, 60.0, ImagePlaneGrid.from_steps(*CAUSTIC_GRID),
                            device=device, mesh=mesh, **CAUSTIC_KW)
    out.update({f"caustic_{k}": np.asarray(maps[k]) for k in ("hit", "order", "det_j")})
    image = imageplane_disc_image.compute(0.9, 100.0, 60.0, ImagePlaneGrid.from_steps(*IMAGE_GRID),
                                          20.0, method="rk45", steplim=20000, device=device,
                                          mesh=mesh)
    out.update({f"image_{k}": v for k, v in image.items()})
    return out


def gradients(mesh, n_steps):
    """sharded_emissivity_gradient (spin 0.998, h 5, gamma 2, the 0.3 grid,
    r0 4) and sharded_line_profile_fit_step (target at spin 0.9, incl 55;
    step at 0.85, 57; dist 100, r_disc 15) at ``n_steps`` iterations."""
    from raytrace_tpu_torch.parallel import (sharded_emissivity_gradient,
                                             sharded_line_profile_fit_step)
    from raytrace_tpu_torch.sources import ImagePlaneGrid, PointSourceGrid

    value, grads = sharded_emissivity_gradient(
        SPIN, 5.0, 2.0, PointSourceGrid.from_steps(*GRAD_GRID), mesh, n_steps=n_steps, r0=4.0)
    loss, fit = sharded_line_profile_fit_step(0.85, 57.0, ImagePlaneGrid.from_steps(*FIT_GRID),
                                              fit_target(n_steps, mesh.device), mesh,
                                              n_steps=n_steps, **FIT_KW)
    return {"value": value.item(), "grads": torch.stack(grads).cpu().numpy(),
            "loss": loss.item(), "fit_grads": torch.stack(fit).cpu().numpy()}


def fit_target(n_steps, device="cpu"):
    """The fit's target: the profile at spin 0.9, incl 55 over the whole
    camera (48 energies over 0.3..1.3)."""
    from raytrace_tpu_torch.ops.diff import line_profile_from_xy
    from raytrace_tpu_torch.sources import ImagePlaneGrid

    x, y = ImagePlaneGrid.from_steps(*FIT_GRID).xy(device=device)
    energies = torch.linspace(0.3, 1.3, 48, dtype=torch.float64, device=device)
    with torch.no_grad():
        return line_profile_from_xy(0.9, 55.0, x, y, energies=energies, n_steps=n_steps,
                                    **FIT_KW)
