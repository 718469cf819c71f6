"""The caustic map onto a flat source plane: ``apps.caustics.compute`` with
the keyword arguments ``compute_args(cfg, "plane")`` builds from one job's
par values, as rt-caustic-plane reaches it (no mesh, no FITS file). The
reference recomputes a seeded sample of its pixels
(``reference.caustic.caustic_plane_pixels``), marching only the bundles of
those pixels and of their grid neighbours."""

from __future__ import annotations

import numpy as np

from portbench.drivers import load_port
from portbench.judge import precision, rel_gap
from portbench.reference import caustic

# the source layer's entry as the app calls it; a traced run times it
SOURCE = ("raytrace_tpu_torch.apps.caustics", "image_plane_bundles")


def load(device) -> bool:
    """The port's entry imported and its march library loaded (built by
    nvcc on a checkout's first run: True then)."""
    return load_port(SOURCE[0], device)


def rays(par) -> int:
    return 5 * caustic.camera(par)[0].n_rays


def compute_kwargs(par, device) -> dict:
    """``compute``'s keyword arguments from the par values, through the
    app's own ``compute_args`` (its defaults apply to every key not given)."""
    from raytrace_tpu_torch.apps.caustics import compute_args
    from raytrace_tpu_torch.config import Config

    argv = [f"--{k}={v}" for k, v in par.items()] + [f"--device={device}"]
    return compute_args(Config(argv), "plane")[0]


def run(par, device) -> dict:
    from raytrace_tpu_torch.apps import caustics as app

    return app.compute(**compute_kwargs(par, device), mesh=None)


def sample(par, config, rng):
    """A seeded sample of the map's pixels, as flat indices, sorted."""
    grid, _ = caustic.camera(par)
    return np.sort(rng.choice(grid.n_rays, size=int(config["check"]["pixels"]), replace=False))


def reference(par, sample, config, *, device, lower=None) -> dict:
    if lower == "sums":
        raise ValueError("the caustic map sums nothing: the 'sums' control has nothing to "
                         "lower in this configuration")
    march_dtype, dtype, _ = precision(config, device, lower)
    return caustic.caustic_plane_pixels(par, sample, device=device, march_dtype=march_dtype,
                                        dtype=dtype)


def control(par, sample, config, *, device, kind="all") -> dict:
    """The control ``kind`` (``judge.CONTROLS``) in the port's place: its
    sampled pixels laid into whole maps (NaN elsewhere)."""
    grid, _ = caustic.camera(par)
    low = reference(par, sample, config, device=device, lower=kind)
    out = {}
    for k, v in low.items():
        full = np.full(grid.n_rays, np.nan)
        full[sample] = v
        out[k] = full.reshape(grid.nx, grid.ny)
    return out


# the maps that classify a pixel (whether it hit, its image order, its
# turning points and equatorial crossings, the sign of det J)
CLASS_MAPS = ("hit", "order", "rdot_flips", "equat_cross", "sign_j")


def differing(out, ref, sample, maps=caustic.MAPS):
    """For each sampled pixel, whether any of ``maps`` differs from the
    reference's: exactly, NaN equal to NaN, SENTINEL as a value."""
    diff = np.zeros(len(sample), dtype=bool)
    for k in maps:
        p = np.asarray(out[k], np.float64).reshape(-1)[sample]
        q = np.asarray(ref[k], np.float64)
        diff |= ~((p == q) | (np.isnan(p) & np.isnan(q)))
    return diff


def compare(out, ref, sample) -> dict:
    """``pixel_gap``: sampled pixels whose eight maps are not all the
    reference's; ``class_gap``: those whose classifying maps are not;
    ``coord_gap``: the largest relative gap of x_s and y_s."""
    return {"pixel_gap": int(differing(out, ref, sample).sum()),
            "class_gap": int(differing(out, ref, sample, CLASS_MAPS).sum()),
            "coord_gap": max(rel_gap(np.asarray(out[k]).reshape(-1)[sample], ref[k])
                             for k in ("x_s", "y_s"))}
