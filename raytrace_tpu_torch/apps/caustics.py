"""Caustic / critical-curve maps of the Kerr lens mapping.

Counterpart of ``raytrace_tpu/apps/caustics.py`` (one device; reference
``src/caustic/``):

  * ``main_discplane`` — lens map image plane -> equatorial disc annulus
    (DiscWithISCO): per-pixel Jacobian det J = d(x_d, y_d)/d(x, y) by
    central differences over 5-ray bundles (or grid neighbours), image-order
    classification, SENTINEL where satellites cross geodesic branch
    boundaries, and the alternating-sign checkerboard suppression pass;
  * ``main_plane`` — the same onto a flat source plane z_s behind the hole
    (FlatPlane, East/North source coordinates);
  * ``main_sourceplane`` — the Jacobian of (theta_s, phi_s) on a far source
    sphere at r_lim (ThetaLimit(0): no stop on theta; grid neighbours only).

The camera is traced on the card by the march kernel, in ``dtype`` (float64
by default: far-plane bundle Jacobians need it, see
``sources/imageplane.py::image_plane_bundles``); the Jacobians and the
suppression pass are numpy on the host, a copy of the JAX package's.

    python -m raytrace_tpu_torch.apps.caustics --parfile=par_example/caustic_discplane.par [--device=cuda|cpu]

runs ``main_discplane`` on the card unless ``--device=cpu`` is given;
``main_plane`` and ``main_sourceplane`` take the same arguments.
``show_progress = 1`` shows the march's progress (``RT_PROGRESS``);
``RT_PROFILE=<dir>`` records a profiler trace of the march and Jacobians.
Under ``torchrun`` with more than one rank the bundles' march splits over
the ranks (``parallel.sharded_caustic_trace``) and rank 0 writes the file.
"""

from __future__ import annotations

import functools
import os
import sys

import numpy as np
import torch

from raytrace_tpu_torch.apps import app_device, require_device
from raytrace_tpu_torch.config import Config
from raytrace_tpu_torch.destinations import DiscWithISCO, FlatPlane, ThetaLimit
from raytrace_tpu_torch.geometry import isco_radius
from raytrace_tpu_torch.io import FITSOutput
from raytrace_tpu_torch.ops import StepControl, trace_in_ranges
from raytrace_tpu_torch.ops.redshift import apply_redshift_dest, redshift_start
from raytrace_tpu_torch.parallel import auto_mesh, sharded_caustic_trace
from raytrace_tpu_torch.rays import (
    RAY_STATUS_DEST,
    RAY_STATUS_HORIZON,
    RAY_STATUS_RLIM,
    RAY_STATUS_STEPLIM,
)
from raytrace_tpu_torch.sources import ImagePlaneGrid, image_plane, image_plane_bundles
from raytrace_tpu_torch.utils import app_phase
from raytrace_tpu_torch.utils.profiling import span

SENTINEL = 1e30


def _order_map(phi_acc, rdot_flips, winding=2.0 * np.pi):
    """Image order: max of the phi-winding and radial-turning estimators
    (caustic_discplane.cpp:184-202)."""
    phi_ord = np.floor(np.abs(phi_acc) / winding).astype(np.int32)
    r_ord = (rdot_flips // 2).astype(np.int32)
    return np.maximum(phi_ord, r_ord)


def _order_map_sphere(phi_acc):
    """Source-sphere image order (caustic_sourceplane.cpp:205-215): a
    backward-traced direct-image ray accumulates ~pi reaching the far side,
    so order = max(floor(|phi_acc|/pi) - 1, 0); no radial-turning estimator."""
    phi_ord = np.floor(np.abs(phi_acc) / np.pi).astype(np.int32)
    return np.maximum(phi_ord - 1, 0)


def _det_and_sign(det, defined, mismatch):
    """det J where defined and order-matched, SENTINEL where defined but
    the orders differ, NaN elsewhere; and its sign (0 off the finite map)."""
    det_map = np.full(det.shape, np.nan)
    det_map = np.where(defined & ~mismatch, det, det_map)
    det_map = np.where(defined & mismatch, SENTINEL, det_map)
    sign_map = np.where(np.isfinite(det_map) & (det_map != SENTINEL), np.sign(det_map), 0.0)
    return det_map, sign_map


def _jacobian_bundle(coords, valid, phi_acc, rdot_flips, eps, hit_centre):
    """det J from E/W/N/S satellite target coordinates.

    coords: (xd, yd) each of shape (5, nx, ny) ordered [centre, east, west,
    north, south]; the order-match gate compares the satellites' rdot_flips
    and accumulated phi with the centre ray's (caustic_discplane.cpp:296-317)."""
    xd, yd = coords
    c, e, w, n, s = range(5)
    order_match = np.ones(xd.shape[1:], dtype=bool)
    for k in (e, w, n, s):
        order_match &= rdot_flips[k] == rdot_flips[c]
    for k in (e, w, n, s):
        order_match &= np.abs(phi_acc[k] - phi_acc[c]) < np.pi / 2
    sats_ok = valid[e] & valid[w] & valid[n] & valid[s]

    dxd_da = (xd[e] - xd[w]) / (2 * eps)
    dxd_db = (xd[n] - xd[s]) / (2 * eps)
    dyd_da = (yd[e] - yd[w]) / (2 * eps)
    dyd_db = (yd[n] - yd[s]) / (2 * eps)
    det = dxd_da * dyd_db - dxd_db * dyd_da
    return _det_and_sign(det, hit_centre & sats_ok, ~order_match)


def _shift(a, di, dj, fill=np.nan):
    """``a`` moved by (di, dj) cells, ``fill`` where nothing moved in."""
    nx, ny = a.shape
    out = np.full_like(a, fill, dtype=a.dtype if a.dtype.kind == "f" else None)
    src = a[max(0, -di): nx - max(0, di), max(0, -dj): ny - max(0, dj)]
    out[max(0, di): nx - max(0, -di), max(0, dj): ny - max(0, -dj)] = src
    return out


def _neighbours(a, fill=np.nan):
    """East, west, north and south neighbours of every cell."""
    return (_shift(a, -1, 0, fill), _shift(a, 1, 0, fill),
            _shift(a, 0, -1, fill), _shift(a, 0, 1, fill))


def _jacobian_grid(xd, yd, valid, phi_acc, rdot_flips, dx, dy):
    """Grid-neighbour central differences (caustic_discplane.cpp:340-440):
    the neighbours are the ray grid's own."""
    xe, xw, xn, xs = _neighbours(xd)
    ye, yw, yn, ys = _neighbours(yd)
    v = valid.astype(bool)
    ve, vw, vn, vs = _neighbours(v, False)
    fe, fw, fn, fs = _neighbours(rdot_flips, -99)
    pe, pw, pn, ps = _neighbours(phi_acc)

    order_match = (
        (fe == rdot_flips) & (fw == rdot_flips) & (fn == rdot_flips) & (fs == rdot_flips)
        & (np.abs(pe - phi_acc) < np.pi / 2) & (np.abs(pw - phi_acc) < np.pi / 2)
        & (np.abs(pn - phi_acc) < np.pi / 2) & (np.abs(ps - phi_acc) < np.pi / 2)
    )
    sats_ok = ve & vw & vn & vs
    det = ((xe - xw) / (2 * dx)) * ((yn - ys) / (2 * dy)) - (
        (xn - xs) / (2 * dy)
    ) * ((ye - yw) / (2 * dx))
    return _det_and_sign(det, v & sats_ok, ~order_match)


def _jacobian_grid_sphere(theta_s, phi_s, escaped, order, dx, dy):
    """Source-sphere Jacobian J = d(theta_s, phi_s)/d(x, y) by grid-neighbour
    central differences (caustic_sourceplane.cpp:244-305): defined where the
    pixel and its four neighbours escaped AND share its image order
    (SENTINEL at order boundaries, the photon-ring critical curves); each
    phi difference is wrapped into [-pi, pi] across the branch cut."""
    wrap = lambda d: np.mod(d + np.pi, 2.0 * np.pi) - np.pi

    te, tw, tn, ts = _neighbours(theta_s)
    pe, pw, pn, ps = _neighbours(phi_s)
    v = escaped.astype(bool)
    ve, vw, vn, vs = _neighbours(v, False)
    oe, ow, on, os_ = _neighbours(order, -99)

    sats_ok = ve & vw & vn & vs
    order_match = (oe == order) & (ow == order) & (on == order) & (os_ == order)
    dth_dx = (te - tw) / (2 * dx)
    dth_dy = (tn - ts) / (2 * dy)
    dph_dx = wrap(pe - pw) / (2 * dx)
    dph_dy = wrap(pn - ps) / (2 * dy)
    det = dth_dx * dph_dy - dth_dy * dph_dx
    return _det_and_sign(det, v & sats_ok, ~order_match)


def suppress_checkerboard(det_map, sign_map):
    """Suppress isolated alternating-sign pixels at geodesic branch
    boundaries (caustic_discplane.cpp:442-493): a pixel with more
    opposite-sign than same-sign 4-neighbours (and >= 2 of them) becomes
    SENTINEL."""
    s = sign_map
    nx, ny = s.shape
    padded = np.zeros((nx + 2, ny + 2))
    padded[1:-1, 1:-1] = s
    neigh = [padded[:-2, 1:-1], padded[2:, 1:-1], padded[1:-1, :-2], padded[1:-1, 2:]]
    n_same = sum(((nb * s) > 0) for nb in neigh)
    n_opp = sum(((nb * s) < 0) for nb in neigh)
    suppress = (s != 0) & (n_opp > n_same) & (n_opp >= 2)
    det_out = np.where(suppress, SENTINEL, det_map)
    sign_out = np.where(suppress, 0.0, sign_map)
    return det_out, sign_out, int(suppress.sum())


# the fields of the marched batch that the maps read, by target
_MAP_FIELDS = ("r", "theta", "phi", "steps", "status", "rdot_flips", "equatorial_crossings")

# The card's ranges (``ranges_for``): each holds at least _RANGE_PIXELS
# pixels, and a map splits into at most _MAX_RANGES of them, two for each of
# the 8 host connections that CUDA gives the streams by default: a range
# launched on a connection that is in use waits for the range before it to
# end, so more ranges slow a march whose ranges end together, and fewer
# leave more of the maps after the last range (PERF.md, the caustic map's host maps).
_RANGE_PIXELS = 4096
_MAX_RANGES = 16


def _pixel_maps(f, *, target, r_isco, r_disc, incl, phi0, winding, eps):
    """The maps that each pixel takes from its own rays alone, for a run of
    pixels: ``f`` holds the marched fields (``_MAP_FIELDS``, and
    ``redshift`` for the disc) of the run's rays as (slots, pixels) host
    arrays, slot 0 the centre ray. Returns flat per-pixel arrays: the maps
    under their names (det_j and sign_j from the bundles, when ``eps`` is
    set), and under names that start with ``_`` what ``_whole_maps`` still
    reads. Elementwise throughout, so a run's maps are bitwise the whole
    map's at its pixels."""
    r, theta, phi_acc, steps = f["r"], f["theta"], f["phi"], f["steps"]
    status = f["status"].astype(np.int64)
    flips = f["rdot_flips"].astype(np.int64)
    eq_cross = f["equatorial_crossings"].astype(np.int64)
    if target == "disc":
        g = f["redshift"]
        valid = (steps > 0) & (r >= float(r_isco)) & (r < r_disc) & (g > 0)
        phi_s = np.arctan2(np.sin(phi_acc), np.cos(phi_acc))
        xd = r * np.cos(phi_s)
        yd = r * np.sin(phi_s)
    elif target == "plane":
        valid = (steps > 0) & ((status & RAY_STATUS_DEST) != 0)
        X = r * np.sin(theta) * np.cos(phi_acc)
        Y = r * np.sin(theta) * np.sin(phi_acc)
        Z = r * np.cos(theta)
        xd = -X * np.sin(phi0) + Y * np.cos(phi0)
        yd = (-X * np.cos(incl) * np.cos(phi0) - Y * np.cos(incl) * np.sin(phi0)
              + Z * np.sin(incl))
    else:  # sphere
        valid = (steps > 0) & ((status & RAY_STATUS_RLIM) != 0)
        xd = theta
        yd = np.arctan2(np.sin(phi_acc), np.cos(phi_acc))

    if target == "sphere":
        order = _order_map_sphere(phi_acc[0])
    else:
        order = _order_map(phi_acc[0], flips[0], winding)
    hit = valid[0]

    pix = {
        "hit": hit.astype(np.int32),
        "order": np.where(hit, order, -1).astype(np.int32),
        "rdot_flips": flips[0].astype(np.int32),
        "equat_cross": eq_cross[0].astype(np.int32),
    }
    if target == "disc":
        pix |= {
            "radius": np.where(hit, r[0], 0.0),
            "phi": np.where(hit, phi_s[0], 0.0),
            "x_disc": np.where(hit, xd[0], 0.0),
            "y_disc": np.where(hit, yd[0], 0.0),
            "redshift": np.where(hit, g[0], 0.0),
        }
    elif target == "plane":
        pix |= {"x_s": np.where(hit, xd[0], 0.0), "y_s": np.where(hit, yd[0], 0.0)}
    else:
        pix |= {
            "theta_s": np.where(hit, xd[0], np.nan),
            "phi_s": np.where(hit, yd[0], np.nan),
            "escaped": hit.astype(np.int32),
        }

    if eps is not None:
        pix["det_j"], pix["sign_j"] = _jacobian_bundle((xd, yd), valid, phi_acc, flips, eps, hit)
    elif target != "sphere":
        pix |= {"_x": np.where(hit, xd[0], np.nan), "_y": np.where(hit, yd[0], np.nan),
                "_phi": phi_acc[0]}
    pix["_status"] = status[0]
    return pix


def _whole_maps(pix, *, target, grid: ImagePlaneGrid):
    """The maps from ``_pixel_maps``'s arrays over the whole grid: the
    grid-neighbour Jacobian where no bundle gave one, the checkerboard
    suppression and the per-status diagnostics, which read neighbours or
    the whole map."""
    shape = (grid.nx, grid.ny)
    maps = {k: v.reshape(shape) for k, v in pix.items() if not k.startswith("_")}
    hit = maps["hit"].astype(bool)
    if target == "sphere":
        det_map, sign_map = _jacobian_grid_sphere(maps["theta_s"], maps["phi_s"], hit,
                                                  maps["order"], grid.dx, grid.dy)
    elif "det_j" in maps:
        det_map, sign_map = maps["det_j"], maps["sign_j"]
    else:
        x, y, phi_acc = (pix[k].reshape(shape) for k in ("_x", "_y", "_phi"))
        det_map, sign_map = _jacobian_grid(x, y, hit, phi_acc, maps["rdot_flips"],
                                           grid.dx, grid.dy)

    if target == "sphere":
        # the reference sourceplane app has no checkerboard-suppression pass
        n_sup = 0
    else:
        det_map, sign_map, n_sup = suppress_checkerboard(det_map, sign_map)
    maps["det_j"] = det_map
    maps["sign_j"] = sign_map
    maps["n_suppressed"] = n_sup

    # per-status failure diagnostics (caustic_discplane.cpp:255-276)
    st0 = pix["_status"]
    maps["diag"] = {
        "horizon": int(((st0 & RAY_STATUS_HORIZON) != 0).sum()),
        "rlim": int(((st0 & RAY_STATUS_RLIM) != 0).sum()),
        "steplim": int(((st0 & RAY_STATUS_STEPLIM) != 0).sum()),
        "hits": int(hit.sum()),
    }
    return maps


def ranges_for(n_pixels: int) -> int:
    """How many pixel ranges ``compute`` splits a map of ``n_pixels`` into
    on a card: one a ``_RANGE_PIXELS`` pixels, at least one and at
    most ``_MAX_RANGES`` (PERF.md, the caustic map's host maps)."""
    return max(1, min(_MAX_RANGES, n_pixels // _RANGE_PIXELS))


def _range_bounds(n_pixels: int, ranges: int) -> list:
    """The first pixel of each of ``ranges`` near-equal runs of the flat
    map, and ``n_pixels`` after them; no run is empty."""
    k = max(1, min(ranges, n_pixels))
    return [n_pixels * i // k for i in range(k + 1)]


def _assemble(whole: dict, p0: int, p1: int, part: dict, n_pixels: int) -> None:
    """Write ``_pixel_maps``'s arrays of the pixels [p0, p1) into ``whole``'s
    arrays of the whole map (made at the first run)."""
    for k, v in part.items():
        if k not in whole:
            whole[k] = np.empty(n_pixels, dtype=v.dtype)
        whole[k][p0:p1] = v


def _range_major(bounds, n_slots: int, device) -> torch.Tensor:
    """The ray order in which each pixel range of ``bounds`` is one
    contiguous run of its ``n_slots`` x m rays, slot after slot: entry j is
    the index, in the camera's slot-major batch (slot * pixels + pixel), of
    the ray that goes to place j."""
    n_pixels = bounds[-1]
    cuts = n_slots * torch.tensor(bounds, dtype=torch.int64, device=device)
    j = torch.arange(n_slots * n_pixels, dtype=torch.int64, device=device)
    k = torch.searchsorted(cuts, j, right=True) - 1
    first, m = cuts[k], (cuts[k + 1] - cuts[k]) // n_slots
    q = j - first
    return (q // m) * n_pixels + first // n_slots + q % m


def compute(
    spin,
    dist,
    incl_deg,
    grid: ImagePlaneGrid,
    target="disc",  # "disc" | "plane" | "sphere"
    r_disc=None,
    z_s=None,
    r_lim=None,
    phi0=0.0,
    use_bundles=True,
    bundle_eps_frac=0.01,
    method="rk45",
    steplim=None,
    ctrl=StepControl(),
    dtype=torch.float64,
    *,
    device,
    mesh=None,
):
    """Trace the camera (bundles or plain grid) on ``device`` and build the
    caustic maps: a dict of (nx, ny) numpy maps whose keys depend on the
    target, always with det_j, sign_j and order, plus diagnostics.

    ``dtype`` is the working precision of the traced pipeline: the batch is
    seeded in float64 and rounded once to it, and ``trace_auto`` marches in
    it on the card (the kernel) and on the CPU (the plain march). A CUDA
    device with no card visible raises.

    The march comes back in pieces, each a run of pixel ranges, and the
    host maps each piece as it comes (``_pixel_maps``, ``_assemble``);
    the passes over the whole map follow (``_whole_maps``). On a card with
    no ``mesh`` the map splits into ``ranges_for`` pixel ranges, the batch
    is laid out range after range (``_range_major``) and
    ``ops.trace_in_ranges`` marches it: under the grid launch each range
    on its own stream, landing as it ends, so the host maps the ranges
    while those that hold stuck rays still march. Elsewhere the map is one
    range and the batch, in the camera's order, one piece: on the CPU
    marched by ``trace_in_ranges``, with a ``mesh``
    (``parallel.make_ray_mesh``) built on the mesh's device and marched
    over its ranks by ``parallel.sharded_caustic_trace``, gathered back to
    full width on each. The maps are bitwise those of one batch.

    Runs in the span ``rt.compute`` (``utils.profiling``): the camera in
    ``rt.source``, the start redshift in ``rt.redshift``, the march in
    ``rt.march``; then for each piece a ``rt.march.finish`` (ranges under
    the grid launch), the disc's redshift and the fields' copies to the
    host in ``rt.to_host`` and the per-pixel maps in ``rt.maps``; then a
    last ``rt.maps`` for the passes over the whole map.
    """
    with span("rt.compute"):
        device = require_device(device if mesh is None else mesh.device)
        a_trace = -spin
        incl = float(np.deg2rad(incl_deg))
        r_isco = isco_radius(spin)

        if target == "disc":
            dest = DiscWithISCO(r_isco=r_isco, r_out=r_disc)
            r_max = 1.1 * dist
            winding = 2 * np.pi
        elif target == "plane":
            dest = FlatPlane(incl=incl, phi0=phi0, z_s=z_s)
            r_max = r_lim if r_lim else 4.0 * z_s
            winding = 2 * np.pi
        elif target == "sphere":
            dest = ThetaLimit(0.0)  # never stop on theta; run to r_lim
            r_max = r_lim if r_lim else 1.5 * dist
            winding = np.pi
            use_bundles = False  # the reference differences grid neighbours only
        else:
            raise ValueError(f"unknown target {target!r}")

        if use_bundles:
            rays, eps = image_plane_bundles(dist, incl_deg, grid, spin, phi0,
                                            eps_frac=bundle_eps_frac, device=device, dtype=dtype)
        else:
            rays = image_plane(dist, incl_deg, grid, spin, phi0, device=device, dtype=dtype)
            eps = None

        n_slots = 5 if use_bundles else 1
        n_pixels = grid.nx * grid.ny
        # The CPU march's float64 sin, cos and pow may round a ray by its
        # place in the batch, so only the card's batch is reordered.
        n_ranges = ranges_for(n_pixels) if mesh is None and device.type == "cuda" else 1
        bounds = _range_bounds(n_pixels, n_ranges)
        cuts = [n_slots * p for p in bounds]
        if n_ranges > 1:
            rays = rays[_range_major(bounds, n_slots, device)]

        with span("rt.redshift"):
            rays = redshift_start(rays, a_trace, V=0.0, reverse=True)

        names = _MAP_FIELDS + (("redshift",) if target == "disc" else ())
        pixel = functools.partial(_pixel_maps, target=target, r_isco=r_isco, r_disc=r_disc,
                                  incl=incl, phi0=phi0, winding=winding, eps=eps)

        march = dict(dest=dest, r_max=r_max, method=method, steplim=steplim, ctrl=ctrl,
                     march_dtype=dtype)
        if mesh is None:
            pieces = trace_in_ranges(rays, a_trace, cuts, **march)
        else:
            pieces = [(0, 1, sharded_caustic_trace(rays, a_trace, mesh, **march), None)]
        host, pix = {}, {}
        for k0, k1, part, stream in pieces:
            # a piece with a stream is copied to pinned memory on it, without waiting
            with span("rt.to_host"), torch.cuda.stream(stream):
                if target == "disc":
                    part = apply_redshift_dest(part, a_trace, dest, reverse=True)
                for f in names:
                    x = getattr(part, f)
                    if f not in host:
                        host[f] = torch.empty(cuts[-1], dtype=x.dtype,
                                              pin_memory=stream is not None)
                    host[f][cuts[k0]:cuts[k1]].copy_(x, non_blocking=stream is not None)
                if stream is not None:
                    stream.synchronize()
            with span("rt.maps"):
                for k in range(k0, k1):
                    fields = {f: host[f][cuts[k]:cuts[k + 1]].numpy().reshape(n_slots, -1)
                              for f in names}
                    _assemble(pix, bounds[k], bounds[k + 1], pixel(fields), n_pixels)
        with span("rt.maps"):
            return _whole_maps(pix, target=target, grid=grid)


_EXTENSIONS = {
    "disc": [
        ("DET_J", "det_j"), ("SIGN_J", "sign_j"), ("ORDER", "order"),
        ("HIT", "hit"), ("RADIUS", "radius"), ("PHI", "phi"),
        ("X_DISC", "x_disc"), ("Y_DISC", "y_disc"), ("REDSHIFT", "redshift"),
    ],
    "plane": [
        ("DET_J", "det_j"), ("SIGN_J", "sign_j"), ("ORDER", "order"),
        ("HIT_PLANE", "hit"), ("X_S", "x_s"), ("Y_S", "y_s"),
        ("RDOT_FLIPS", "rdot_flips"), ("EQUAT_CROSS", "equat_cross"),
    ],
    "sphere": [
        ("DET_J", "det_j"), ("SIGN_J", "sign_j"), ("ORDER", "order"),
        ("ESCAPED", "escaped"), ("THETA_S", "theta_s"), ("PHI_S", "phi_s"),
        ("RDOT_FLIPS", "rdot_flips"), ("EQUAT_CROSS", "equat_cross"),
    ],
}


def compute_args(cfg: Config, target: str):
    """``compute``'s keyword arguments from a run configuration (par file
    and CLI), with the reference apps' defaults for ``target``, and the
    per-extension axis keywords of the FITS file (caustic_discplane.cpp:520-540)."""
    dist = cfg.get("dist", float)
    r_disc = cfg.get("r_disc", float, 30.0) if target == "disc" else None
    z_s = cfg.get("z_s", float, dist) if target == "plane" else None
    if target == "plane":
        r_lim = cfg.get("r_max", float, 4.0 * z_s)
    elif target == "sphere":
        r_lim = cfg.get("r_lim", float, 1.5 * dist)
    else:
        r_lim = None
    span = r_disc if r_disc else 30.0
    x0 = cfg.get("x0", float, -span)
    xmax = cfg.get("xmax", float, span)
    nx = cfg.get("Nx", int)
    y0 = cfg.get("y0", float, x0)
    ymax = cfg.get("ymax", float, xmax)
    ny = cfg.get("Ny", int, nx)
    dx = (xmax - x0) / nx
    dy = (ymax - y0) / ny
    grid = ImagePlaneGrid.from_steps(x0, xmax, dx, y0, ymax, dy)
    steplim = cfg.get("steplim", int, -1)
    kw = dict(
        spin=cfg.get("spin", float),
        dist=dist,
        incl_deg=cfg.get("incl", float),
        grid=grid,
        target=target,
        r_disc=r_disc,
        z_s=z_s,
        r_lim=r_lim,
        phi0=float(np.deg2rad(cfg.get("plane_phi0", float, 0.0))),
        use_bundles=cfg.get("use_bundles", bool, target != "sphere"),
        bundle_eps_frac=cfg.get("bundle_eps_frac", float, 0.01),
        method=cfg.get("integrator", str, "rk45").lower(),
        steplim=None if steplim <= 0 else steplim,
        ctrl=StepControl(rk45_tol=cfg.get("rk45_tol", float, 1e-8),
                         precision=cfg.get("precision", float, 100.0)),
        device=app_device(cfg),
    )
    axes = (("X0", x0), ("XMAX", xmax), ("DX", dx), ("NX", grid.nx),
            ("Y0", y0), ("YMAX", ymax), ("DY", dy), ("NY", grid.ny))
    return kw, axes


def _main(target):
    def main(argv=None):
        cfg = Config(argv)
        outfile = cfg.get("outfile", str)
        kw, axes = compute_args(cfg, target)
        # reference par key (caustic_*.par_example): the march's progress
        if cfg.get("show_progress", bool, False):
            os.environ.setdefault("RT_PROGRESS", "1")
        grid = kw["grid"]
        print(f"caustic_{target}: spin={kw['spin']} incl={kw['incl_deg']} {grid.nx}x{grid.ny} "
              f"pixels, bundles={kw['use_bundles']} on {kw['device']}")
        mesh = auto_mesh(kw["device"])
        if mesh is not None:
            print(f"sharding rays over {mesh.size} devices")
        with app_phase(f"caustic {target} march+jacobians"):
            maps = compute(**kw, mesh=mesh)
        d = maps["diag"]
        print(f"{d['hits']} hits; horizon={d['horizon']} rlim={d['rlim']} "
              f"steplim={d['steplim']}; {maps['n_suppressed']} pixels suppressed")
        if mesh is not None and mesh.rank != 0:
            return 0

        fits = FITSOutput(outfile)
        fits.write_comment(f"Kerr caustic / critical curve mapping ({target})")
        fits.set_keyword("GENERATOR", f"caustic_{target}")
        fits.set_keyword("DIST", kw["dist"])
        fits.set_keyword("INCL", kw["incl_deg"])
        fits.set_keyword("SPIN", kw["spin"])
        for key, val in (("RDISC", kw["r_disc"]), ("Z_S", kw["z_s"]), ("RLIM", kw["r_lim"])):
            if val:
                fits.set_keyword(key, val)
        fits.set_keyword("SENTINEL", SENTINEL, "branch-boundary marker value")
        if target == "disc":
            fits.set_keyword("ISCO", float(isco_radius(kw["spin"])))
        for extname, key in _EXTENSIONS[target]:
            fits.write_image(np.nan_to_num(np.asarray(maps[key], dtype=float), nan=0.0),
                             extname=extname)
            for k, v in axes:
                fits.set_keyword(k, v)
        fits.close()
        print(f"wrote {outfile}")
        return 0

    return main


main_discplane = _main("disc")
main_plane = _main("plane")
main_sourceplane = _main("sphere")

if __name__ == "__main__":
    sys.exit(main_discplane())
