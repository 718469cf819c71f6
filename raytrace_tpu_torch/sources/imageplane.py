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
several ulp of error on every start. The 5-ray bundles of the caustic apps
(``image_plane_bundles``) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from raytrace_tpu_torch.geometry.kerr import metric_coeffs
from raytrace_tpu_torch.rays import RayBatch, blank_batch


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
    sin_i, cos_i = torch.sin(incl), torch.cos(incl)
    t = torch.zeros_like(x)
    r = torch.sqrt(D * D + x * x + y * y)
    theta = torch.arccos((D * cos_i + y * sin_i) / r)
    phi = phi0 + torch.arctan2(x, D * sin_i - y * cos_i)

    pr = D / r
    ptheta = torch.sin(torch.arccos(D / r)) / r
    denom = x * x + (D * sin_i - y * cos_i) ** 2
    pphi = x * sin_i / denom

    # p^t from the null condition g_munu p^mu p^nu = 0 (positive root)
    g = metric_coeffs(r, theta, a_trace)
    A = g.g_tt
    B = 2.0 * g.g_tphi * pphi
    C = g.g_rr * pr * pr + g.g_thth * ptheta * ptheta + g.g_phph * pphi * pphi
    disc = torch.sqrt(B * B - 4.0 * A * C)
    pt = (-B + disc) / (2.0 * A)
    pt = torch.where(pt < 0, (-B - disc) / (2.0 * A), pt)

    k = torch.ones_like(x)
    h = -x * sin_i
    cos_t, tan_t = torch.cos(theta), torch.tan(theta)
    noise = work_eps * (1.0 + (h / tan_t) ** 2 + (a_trace * cos_t) ** 2)
    floor = torch.clamp_min(torch.sqrt(100.0 * noise), 1e-4)
    ltheta = torch.where(torch.abs(y) < floor, torch.where(y < 0, -floor, floor), y)
    Q = ltheta * ltheta - (a_trace * cos_t) ** 2 + (h / tan_t) ** 2

    rdot_sign = -torch.ones_like(x)
    thetadot_sign = torch.where(ltheta >= 0, 1.0, -1.0).to(x.dtype)
    return t, r, theta, phi, (pt, pr, ptheta, pphi), (k, h, Q), rdot_sign, thetadot_sign


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
    """
    work_dtype = dtype if work_dtype is None else work_dtype
    f64 = torch.float64
    x, y = grid.xy(dtype=f64)
    deg = torch.tensor(float(incl_deg), dtype=f64)
    parts = _plane_ray(
        x, y, torch.tensor(float(dist), dtype=f64), deg * torch.pi / 180.0,
        torch.tensor(float(phi0), dtype=f64), -float(spin), torch.finfo(work_dtype).eps,
    )
    t, r, theta, phi, mom, consts, rdot_sign, thetadot_sign = parts
    c = lambda v: v.to(device=device, dtype=dtype)
    base = blank_batch(grid.n_rays, device=device, dtype=dtype)
    return base.replace(
        t=c(t), r=c(r), theta=c(theta), phi=c(phi),
        pt=c(mom[0]), pr=c(mom[1]), ptheta=c(mom[2]), pphi=c(mom[3]),
        k=c(consts[0]), h=c(consts[1]), Q=c(consts[2]),
        rdot_sign=c(rdot_sign), thetadot_sign=c(thetadot_sign),
        steps=torch.zeros(grid.n_rays, dtype=torch.int32, device=device),
        alpha=c(x), beta=c(y),
    )
