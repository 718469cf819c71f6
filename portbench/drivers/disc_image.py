"""The ISCO disc image: ``apps.imageplane_disc_image.compute(variant="isco")``
at one job's inclination; the reference recomputes a seeded sample of its
pixels (``reference.jobs.disc_image_pixels``), marching only the camera
rays that land in them."""

from __future__ import annotations

import numpy as np

from portbench.drivers import load_port
from portbench.judge import count_gap, precision, rel_gap
from portbench.reference import jobs

# the source layer's entry as the app calls it; a traced run times it
SOURCE = ("raytrace_tpu_torch.apps.imageplane_disc_image", "image_plane")


def load(device) -> bool:
    """The port's entry imported and its march library loaded (built by
    nvcc on a checkout's first run: True then)."""
    return load_port(SOURCE[0], device)


def rays(par) -> int:
    return jobs.camera(par)[0].n_rays


def run(par, device) -> dict:
    from raytrace_tpu_torch.apps import imageplane_disc_image as app
    from raytrace_tpu_torch.sources import ImagePlaneGrid

    g, img_nx, img_ny = jobs.camera(par)
    grid = ImagePlaneGrid(g.nx, g.ny, g.x0, g.y0, g.dx, g.dy)
    q = {k: float(par[k]) for k in ("q1", "rb1", "q2", "rb2", "q3")}
    return app.compute(float(par["spin"]), float(par["dist"]), float(par["incl"]), grid,
                       float(par["r_disc"]), img_nx=img_nx, img_ny=img_ny,
                       phi0=float(par.get("plane_phi0", 0.0)), variant="isco",
                       method=par["integrator"], device=device, **q)


def sample(par, config, rng):
    """A seeded sample of the image's pixels, as flat indices, sorted."""
    _, img_nx, img_ny = jobs.camera(par)
    return np.sort(rng.choice(img_nx * img_ny, size=int(config["check"]["pixels"]),
                              replace=False))


def reference(par, sample, config, *, device, lower=None) -> dict:
    march_dtype, dtype, sum_dtype = precision(config, device, lower)
    return jobs.disc_image_pixels(par, sample, device=device, march_dtype=march_dtype,
                                  dtype=dtype, sum_dtype=sum_dtype)


def control(par, sample, config, *, device, kind="all") -> dict:
    """The control ``kind`` (``judge.CONTROLS``) in the port's place: its
    sampled pixels laid into whole images (empty elsewhere)."""
    _, img_nx, img_ny = jobs.camera(par)
    low = reference(par, sample, config, device=device, lower=kind)
    out = {}
    for k, v in low.items():
        full = np.zeros(img_nx * img_ny) if k == "counts" else np.full(img_nx * img_ny, np.nan)
        full[sample] = v
        out[k] = full.reshape(img_nx, img_ny)
    return out


def compare(out, ref, sample) -> dict:
    prog = {k: np.asarray(out[k]).reshape(-1)[sample] for k in ref}
    return {"count_gap": count_gap(prog["counts"], ref["counts"]),
            "map_gap": max(rel_gap(prog[k], ref[k]) for k in jobs.MAPS)}
