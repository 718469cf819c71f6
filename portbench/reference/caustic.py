"""The caustic map onto a flat source plane (rt-caustic-plane), computed by
the plain reference at a chosen set of pixels.

Counterpart of ``apps.caustics.compute(target="plane")`` with 5-ray bundles
(caustic_plane.cpp, imageplane_bundles.h): each pixel's centre ray and its
east, west, north and south satellites at +-eps = eps_frac * min(dx, dy) are
traced backwards to ``FlatPlane``, z_s behind the hole; the maps are the
centre ray's hit, image order, source-plane coordinates (x_s, y_s), radial
turning points and equatorial crossings, and det J = d(x_s, y_s)/d(x, y) by
the satellites' central differences, with the checkerboard suppression pass.

Only the rays the pixels need are marched: each pixel's five, and the five
of each of its four grid neighbours, whose signs of det J the suppression
reads (a neighbour outside the map counts as sign 0). Each ray's march is
independent of the batch it is marched in, so the sampled maps are those of
the whole map at the same pixels.

The camera is seeded through the reference's ``_plane_ray`` in float64 on
the device it is given: on the card that is the same operations on the
same device as the port's camera, so the float64 starts are the port's
bits (CUDA's float64 arccos, arctan2, tan, sin and cos differ from the
host's by about an ulp, and an RK45 march at a tolerance of 1e-8 steers its
step on such round-off). The maps are numpy float64 on the host, as the app
computes them.

Departures from caustic_plane.cpp, as the port makes them: the polar impact
parameter of rays at y ~ 0 is floored (``imageplane._plane_ray``); det J is
NaN where the centre ray or a satellite missed the plane, SENTINEL where
they hit in different image orders (rdot_flips differ, or accumulated phi
differs by pi/2 or more); the suppression pass pads the map's edge with
sign 0.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import mathfn
from .destinations import Destination
from .imageplane import ImagePlaneGrid, _batch_from_parts, _plane_ray
from .jobs import march
from .march import StepControl
from .rays import RAY_STATUS_DEST
from .redshift import redshift_start

SENTINEL = 1e30
# the app's eight maps (its FITS extensions DET_J ... EQUAT_CROSS)
MAPS = ("hit", "order", "x_s", "y_s", "rdot_flips", "equat_cross", "det_j", "sign_j")
# what the maps read of each marched ray
FIELDS = ("r", "theta", "phi", "steps", "status", "rdot_flips", "equatorial_crossings")


@dataclasses.dataclass(frozen=True)
class FlatPlane(Destination):
    """Flat source plane perpendicular to the observer's line of sight, z_s
    behind the hole (ray_destination.h:172-204): a ray stops where its
    signed projection on n = (sin i cos phi0, sin i sin phi0, cos i) drops to
    -z_s or below; no step cap. sin i and cos i are taken once in double."""

    incl: float
    phi0: float = 0.0
    z_s: float = 100.0

    @property
    def sin_incl(self) -> float:
        return math.sin(self.incl)

    @property
    def cos_incl(self) -> float:
        return math.cos(self.incl)

    def projection(self, r, theta, phi):
        return r * (mathfn.sin(theta) * self.sin_incl * mathfn.cos(phi - self.phi0)
                    + mathfn.cos(theta) * self.cos_incl)

    def reached(self, r, theta, phi, prev_theta):
        return self.projection(r, theta, phi) <= -self.z_s

    def source_coords(self, r, theta, phi):
        """East/North coordinates on the plane, oriented as the image plane
        (ray_destination.h:195-203)."""
        X = r * mathfn.sin(theta) * mathfn.cos(phi)
        Y = r * mathfn.sin(theta) * mathfn.sin(phi)
        Z = r * mathfn.cos(theta)
        s0, c0 = math.sin(self.phi0), math.cos(self.phi0)
        x_s = -X * s0 + Y * c0
        y_s = -X * self.cos_incl * c0 - Y * self.cos_incl * s0 + Z * self.sin_incl
        return x_s, y_s


def camera(par):
    """The pixel grid and the satellites' offset eps, as the app reads the
    par file: Nx + 1 pixels an axis from x0 to xmax (dx = (xmax - x0) / Nx),
    y as x unless given."""
    x0, xmax, nx = float(par.get("x0", -30.0)), float(par.get("xmax", 30.0)), int(par["Nx"])
    y0, ymax = float(par.get("y0", x0)), float(par.get("ymax", xmax))
    ny = int(par.get("Ny", nx))
    grid = ImagePlaneGrid.from_steps(x0, xmax, (xmax - x0) / nx, y0, ymax, (ymax - y0) / ny)
    return grid, float(par.get("bundle_eps_frac", 0.01)) * min(grid.dx, grid.dy)


def destination(par) -> FlatPlane:
    z_s = float(par.get("z_s", par["dist"]))
    return FlatPlane(incl=float(np.deg2rad(float(par["incl"]))), phi0=_phi0(par), z_s=z_s)


def _phi0(par) -> float:
    return float(np.deg2rad(float(par.get("plane_phi0", 0.0))))


def bundle_rays(par, pixels, *, device, dtype, work_dtype):
    """The 5-ray bundles of the flat pixel indices ``pixels`` (ix * ny +
    iy), slot-major ([centre, east, west, north, south] x pixels), seeded in
    float64 on ``device`` and rounded once to ``dtype``; ``work_dtype``'s
    epsilon sets the knife-edge floor."""
    grid, eps = camera(par)
    f64 = torch.float64
    p = torch.as_tensor(np.asarray(pixels), dtype=torch.int64, device=device)
    xc = grid.x0 + torch.div(p, grid.ny, rounding_mode="floor").to(f64) * grid.dx
    yc = grid.y0 + torch.remainder(p, grid.ny).to(f64) * grid.dy
    offsets = [(0.0, 0.0), (eps, 0.0), (-eps, 0.0), (0.0, eps), (0.0, -eps)]
    x = torch.cat([xc + ox for ox, _ in offsets])
    y = torch.cat([yc + oy for _, oy in offsets])
    deg = torch.tensor(float(par["incl"]), dtype=f64)
    parts = _plane_ray(x, y, torch.tensor(float(par["dist"]), dtype=f64),
                       deg * torch.pi / 180.0, torch.tensor(_phi0(par), dtype=f64),
                       -float(par["spin"]), torch.finfo(work_dtype).eps)
    return _batch_from_parts(parts, x, y, device=device, dtype=dtype)


def step_control(par) -> StepControl:
    return StepControl(rk45_tol=float(par.get("rk45_tol", 1e-8)),
                       precision=float(par.get("precision", 100.0)))


def march_bundles(par, pixels, *, device, march_dtype, dtype=torch.float64) -> dict:
    """The marched bundles of ``pixels``: each of ``FIELDS`` as a numpy
    array of shape (5, len(pixels)). The whole map's 1,255,005 rays march
    as one batch in a few GB of a card's memory."""
    spin = float(par["spin"])
    z_s = float(par.get("z_s", par["dist"]))
    steplim = int(par.get("steplim", -1))
    rays = bundle_rays(par, pixels, device=device, dtype=dtype, work_dtype=march_dtype)
    rays = redshift_start(rays, -spin, V=0.0, reverse=True)
    out = march(rays, -spin, march_dtype=march_dtype, method=par.get("integrator", "rk45"),
                dest=destination(par), r_max=float(par.get("r_max", 4.0 * z_s)),
                steplim=None if steplim <= 0 else steplim, ctrl=step_control(par))
    return {f: getattr(out, f).cpu().numpy().reshape(5, -1) for f in FIELDS}


def _det_and_sign(det, defined, mismatch):
    det_map = np.full(det.shape, np.nan)
    det_map = np.where(defined & ~mismatch, det, det_map)
    det_map = np.where(defined & mismatch, SENTINEL, det_map)
    sign_map = np.where(np.isfinite(det_map) & (det_map != SENTINEL), np.sign(det_map), 0.0)
    return det_map, sign_map


def bundle_maps(fields, par) -> dict:
    """The maps before suppression, one entry a pixel of the bundles in
    ``fields`` (``march_bundles``): the app's expressions in numpy."""
    _, eps = camera(par)
    dest = destination(par)
    incl, phi0 = dest.incl, dest.phi0
    r, theta, phi_acc = fields["r"], fields["theta"], fields["phi"]
    status = fields["status"].astype(np.int64)
    flips = fields["rdot_flips"].astype(np.int64)
    valid = (fields["steps"] > 0) & ((status & RAY_STATUS_DEST) != 0)
    X = r * np.sin(theta) * np.cos(phi_acc)
    Y = r * np.sin(theta) * np.sin(phi_acc)
    Z = r * np.cos(theta)
    xd = -X * np.sin(phi0) + Y * np.cos(phi0)
    yd = -X * np.cos(incl) * np.cos(phi0) - Y * np.cos(incl) * np.sin(phi0) + Z * np.sin(incl)

    # image order: the larger of the phi windings and half the radial turns
    phi_ord = np.floor(np.abs(phi_acc[0]) / (2.0 * np.pi)).astype(np.int32)
    order = np.maximum(phi_ord, (flips[0] // 2).astype(np.int32))
    hit = valid[0]

    c, e, w, n, s = range(5)
    order_match = np.ones(hit.shape, dtype=bool)
    for k in (e, w, n, s):
        order_match &= flips[k] == flips[c]
    for k in (e, w, n, s):
        order_match &= np.abs(phi_acc[k] - phi_acc[c]) < np.pi / 2
    sats_ok = valid[e] & valid[w] & valid[n] & valid[s]
    dxd_da = (xd[e] - xd[w]) / (2 * eps)
    dxd_db = (xd[n] - xd[s]) / (2 * eps)
    dyd_da = (yd[e] - yd[w]) / (2 * eps)
    dyd_db = (yd[n] - yd[s]) / (2 * eps)
    det = dxd_da * dyd_db - dxd_db * dyd_da
    det_j, sign_j = _det_and_sign(det, hit & sats_ok, ~order_match)
    return {"hit": hit.astype(np.int32), "order": np.where(hit, order, -1).astype(np.int32),
            "x_s": np.where(hit, xd[0], 0.0), "y_s": np.where(hit, yd[0], 0.0),
            "rdot_flips": flips[0].astype(np.int32),
            "equat_cross": fields["equatorial_crossings"][0].astype(np.int32),
            "det_j": det_j, "sign_j": sign_j}


def neighbourhood(pixels, nx, ny):
    """The flat indices of ``pixels`` and of their four grid neighbours
    inside the map, sorted; and the neighbours' flat indices (-1 outside
    the map), in the order (ix - 1), (ix + 1), (iy - 1), (iy + 1)."""
    pixels = np.asarray(pixels, np.int64)
    ix, iy = np.divmod(pixels, ny)
    around = []
    for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        i, j = ix + di, iy + dj
        around.append(np.where((0 <= i) & (i < nx) & (0 <= j) & (j < ny), i * ny + j, -1))
    need = np.unique(np.concatenate([pixels] + [f[f >= 0] for f in around]))
    return need, around


def pixel_maps(fields, need, pixels, par) -> dict:
    """The eight maps at ``pixels`` from the marched bundles ``fields`` of
    the sorted pixels ``need`` (``neighbourhood``'s), which hold every
    pixel's grid neighbours inside the map; the suppression pass turns a
    pixel with more opposite-sign than same-sign neighbours, and at least
    two, into SENTINEL with sign 0 (caustic_discplane.cpp:442-493)."""
    grid, _ = camera(par)
    pixels = np.asarray(pixels, np.int64)
    _, around = neighbourhood(pixels, grid.nx, grid.ny)
    maps = bundle_maps(fields, par)
    out = {k: v[np.searchsorted(need, pixels)] for k, v in maps.items()}
    s = out["sign_j"]
    neigh = [np.where(f >= 0, maps["sign_j"][np.searchsorted(need, np.maximum(f, 0))], 0.0)
             for f in around]
    n_same = sum(((nb * s) > 0) for nb in neigh)
    n_opp = sum(((nb * s) < 0) for nb in neigh)
    suppress = (s != 0) & (n_opp > n_same) & (n_opp >= 2)
    out["det_j"] = np.where(suppress, SENTINEL, out["det_j"])
    out["sign_j"] = np.where(suppress, 0.0, s)
    return out


@torch.no_grad()
def caustic_plane_pixels(par, pixels, *, device, march_dtype, dtype=torch.float64) -> dict:
    """The caustic map's eight maps (``MAPS``) at the flat pixel indices
    ``pixels``, as numpy arrays in the order of ``pixels``, marching the
    bundles of the pixels and of their grid neighbours."""
    grid, _ = camera(par)
    need, _ = neighbourhood(pixels, grid.nx, grid.ny)
    fields = march_bundles(par, need, device=device, march_dtype=march_dtype, dtype=dtype)
    return pixel_maps(fields, need, pixels, par)
