"""Backward-traced image plane: the observer's camera grid.

Counterpart of ``raytrace_tpu/sources/imageplane.py`` (reference
``imageplane.cpp``): rays start on a distant plane perpendicular to the line
of sight (distance D, inclination incl) and are traced *backwards in time*
towards the hole. Time reversal is the negated spin of the propagation
(imageplane.cpp:12): march with ``spin=-spin`` and pass ``reverse=True`` to
every redshift call.

The constants of motion come from the analytic impact parameters
(imageplane.cpp:100-113): k = 1, h = -x sin i, l_theta = y,
Q = l_theta^2 - (a cos theta)^2 + (h / tan theta)^2.

The initial conditions are computed in float64 on the host CPU and rounded
once to the batch dtype: at dist = 10^4 the float32 ulp of r is ~10^-3 r_g,
so a float32 chain of arccos and the null-condition quadratic would put
several ulp of error on every start. The caustic apps' 5-ray bundles
(``image_plane_bundles``) are seeded the same way.
"""

from __future__ import annotations

import dataclasses

import torch

from raytrace_tpu_torch import mathfn
from raytrace_tpu_torch.geometry.kerr import metric_coeffs
from raytrace_tpu_torch.rays import RayBatch, blank_batch
from raytrace_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class ImagePlaneGrid:
    """Static image-plane grid geometry.

    The reference x-grid strides by dy (imageplane.cpp:43); every app passes
    dx == dy, and this grid uses dx.
    """

    nx: int
    ny: int
    x0: float
    y0: float
    dx: float
    dy: float

    @classmethod
    def from_steps(cls, x0, xmax, dx, y0, ymax, dy):
        nx = int((xmax - x0) / dx) + 1
        ny = int((ymax - y0) / dy) + 1
        return cls(nx, ny, float(x0), float(y0), float(dx), float(dy))

    @property
    def n_rays(self) -> int:
        return self.nx * self.ny

    def xy(self, *, device="cpu", dtype=torch.float64):
        """Flat plane coordinates (x major, as ``meshgrid(indexing="ij")``)."""
        x = self.x0 + torch.arange(self.nx, dtype=dtype, device=device) * self.dx
        y = self.y0 + torch.arange(self.ny, dtype=dtype, device=device) * self.dy
        X, Y = torch.meshgrid(x, y, indexing="ij")
        return X.reshape(-1), Y.reshape(-1)


def _plane_ray(x, y, D, incl, phi0, a_trace, work_eps):
    """Initial BL position, momentum and constants for each plane point, in
    the dtype of x (imageplane.cpp:50-113); a_trace is the negated spin.

    Rays with y ~ 0 start at their polar turning point, where the march's
    turning-point sign gate decides on rounding noise and the ray can
    random-walk over the pole. The polar impact parameter is floored at a
    value that dominates the cancellation noise of thetadot_sq in the dtype
    the *march* runs in (``work_eps``, its machine epsilon), and at 1e-4 r_g.
    """
    sin_i, cos_i = mathfn.sin(incl), mathfn.cos(incl)
    t = torch.zeros_like(x)
    r = mathfn.sqrt(D * D + x * x + y * y)
    theta = torch.arccos((D * cos_i + y * sin_i) / r)
    phi = phi0 + torch.arctan2(x, D * sin_i - y * cos_i)

    pr = D / r
    ptheta = mathfn.sin(torch.arccos(D / r)) / r
    denom = x * x + (D * sin_i - y * cos_i) ** 2
    pphi = x * sin_i / denom

    # p^t from the null condition g_munu p^mu p^nu = 0 (positive root)
    g = metric_coeffs(r, theta, a_trace)
    A = g.g_tt
    B = 2.0 * g.g_tphi * pphi
    C = g.g_rr * pr * pr + g.g_thth * ptheta * ptheta + g.g_phph * pphi * pphi
    disc = mathfn.sqrt(B * B - 4.0 * A * C)
    pt = (-B + disc) / (2.0 * A)
    pt = torch.where(pt < 0, (-B - disc) / (2.0 * A), pt)

    k = torch.ones_like(x)
    h = -x * sin_i
    cos_t, tan_t = mathfn.cos(theta), torch.tan(theta)
    noise = work_eps * (1.0 + (h / tan_t) ** 2 + (a_trace * cos_t) ** 2)
    floor = torch.clamp_min(mathfn.sqrt(100.0 * noise), 1e-4)
    ltheta = torch.where(torch.abs(y) < floor, torch.where(y < 0, -floor, floor), y)
    Q = ltheta * ltheta - (a_trace * cos_t) ** 2 + (h / tan_t) ** 2

    rdot_sign = -torch.ones_like(x)
    thetadot_sign = torch.where(ltheta >= 0, 1.0, -1.0).to(x.dtype)
    return t, r, theta, phi, (pt, pr, ptheta, pphi), (k, h, Q), rdot_sign, thetadot_sign


def _seeded_batch(x, y, dist, incl_deg, spin, phi0, *, device, dtype, work_dtype) -> RayBatch:
    """Seed the plane points (x, y) (float64 on the CPU) through _plane_ray
    in float64 and round every field once to ``dtype`` on ``device``."""
    f64 = torch.float64
    deg = torch.tensor(float(incl_deg), dtype=f64)
    parts = _plane_ray(
        x, y, torch.tensor(float(dist), dtype=f64), deg * torch.pi / 180.0,
        torch.tensor(float(phi0), dtype=f64), -float(spin), torch.finfo(work_dtype).eps,
    )
    return _batch_from_parts(parts, x, y, device=device, dtype=dtype)


def _batch_from_parts(parts, x, y, *, device, dtype) -> RayBatch:
    """Assemble a live batch on ``device`` from _plane_ray's parts, rounding
    every field once to ``dtype`` (a no-op for the all-traced construction,
    whose parts are already there and keep their graph)."""
    t, r, theta, phi, mom, consts, rdot_sign, thetadot_sign = parts
    c = lambda v: v.to(device=device, dtype=dtype)
    n = x.shape[0]
    base = blank_batch(n, device=device, dtype=dtype)
    return base.replace(
        t=c(t), r=c(r), theta=c(theta), phi=c(phi),
        pt=c(mom[0]), pr=c(mom[1]), ptheta=c(mom[2]), pphi=c(mom[3]),
        k=c(consts[0]), h=c(consts[1]), Q=c(consts[2]),
        rdot_sign=c(rdot_sign), thetadot_sign=c(thetadot_sign),
        steps=torch.zeros(n, dtype=torch.int32, device=device),
        alpha=c(x), beta=c(y),
    )


def _traced_batch(x, y, dist, incl_deg, spin, phi0) -> RayBatch:
    """The all-traced construction (the JAX image_plane under a traced
    parameter): _plane_ray in the dtype of the plane points (x, y) on their
    device, with ``spin`` and ``incl_deg`` as given, so their gradients
    reach every field. The knife-edge floor takes that dtype's epsilon."""
    as_t = lambda v: (v.to(device=x.device, dtype=x.dtype) if isinstance(v, torch.Tensor)
                      else torch.tensor(float(v), dtype=x.dtype, device=x.device))
    a_trace = -(spin.to(x.device) if isinstance(spin, torch.Tensor) else float(spin))
    parts = _plane_ray(x, y, as_t(dist), as_t(incl_deg) * torch.pi / 180.0, as_t(phi0),
                       a_trace, torch.finfo(x.dtype).eps)
    return _batch_from_parts(parts, x, y, device=x.device, dtype=x.dtype)


def image_plane(dist, incl_deg, grid: ImagePlaneGrid, spin, phi0=0.0, *, device,
                dtype=torch.float64, work_dtype=None) -> RayBatch:
    """Build the backward-traced camera batch on ``device``.

    Propagate the result with ``trace(rays, -spin, ...)`` and pass
    ``reverse=True`` to the redshift calls. ``rays.alpha``/``rays.beta``
    hold the plane (x, y) coordinates (imageplane.cpp:117-118).

    Every field is computed in float64 on the CPU and rounded once to
    ``dtype``. ``work_dtype`` is the dtype the march will run in (default
    ``dtype``): its epsilon sets the knife-edge floor of the polar impact
    parameter, so a float64 batch that ``trace_auto`` marches in float32 on
    a card passes ``work_dtype=torch.float32``.

    A tensor ``spin`` or ``incl_deg`` (a parameter under autograd) takes the
    all-traced construction instead: every field computed in ``dtype`` on
    ``device``, differentiable in both; ``work_dtype`` is then ``dtype``.

    Runs in the span ``rt.source`` (``utils.profiling``).
    """
    with span("rt.source"):
        if isinstance(spin, torch.Tensor) or isinstance(incl_deg, torch.Tensor):
            return _traced_batch(*grid.xy(device=device, dtype=dtype), dist, incl_deg, spin,
                                 phi0)
        work_dtype = dtype if work_dtype is None else work_dtype
        x, y = grid.xy(dtype=torch.float64)
        return _seeded_batch(x, y, dist, incl_deg, spin, phi0, device=device, dtype=dtype,
                             work_dtype=work_dtype)


def image_plane_bundles(dist, incl_deg, grid: ImagePlaneGrid, spin, phi0=0.0, eps_frac=0.01,
                        *, device, dtype=torch.float64):
    """5-ray bundles per pixel: the centre ray and E/W/N/S satellites at
    +-eps = eps_frac * min(dx, dy) (imageplane_bundles.h:44-200), for the
    caustic apps' lensing Jacobians. Returns the batch of 5 * nx * ny rays,
    ordered [centre, east (+x), west (-x), north (+y), south (-y)] x pixels
    (ray index = bundle slot * n_pixels + pixel), and eps.

    Seeded like ``image_plane``: plane coordinates and initial conditions
    in float64, one rounding to ``dtype``, which is also the march dtype
    and sets the knife-edge floor. A float32 march quantises the
    satellites' start directions at the ulp of theta (~1.2e-7 rad): adequate
    up to dist ~ 10^3 at eps_frac = 0.01, hence float64 for the par files'
    dist 10^4.
    """
    eps = eps_frac * min(grid.dx, grid.dy)
    offsets = [(0.0, 0.0), (eps, 0.0), (-eps, 0.0), (0.0, eps), (0.0, -eps)]
    xc, yc = grid.xy(dtype=torch.float64)
    x = torch.cat([xc + ox for ox, _ in offsets])
    y = torch.cat([yc + oy for _, oy in offsets])
    rays = _seeded_batch(x, y, dist, incl_deg, spin, phi0, device=device, dtype=dtype,
                         work_dtype=dtype)
    return rays, eps
