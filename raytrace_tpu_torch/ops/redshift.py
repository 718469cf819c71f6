"""GR redshift: emitted and received photon energies in observer frames.

Counterpart of ``raytrace_tpu/ops/redshift.py`` (reference
raytracer.cpp:342-622). Backward-traced image planes march with the negated
spin, so these functions take the *trace* spin and a ``reverse`` flag:
where the reference flips back to the physical spin for the metric and the
tetrad it does so here too, and the photon's spatial momentum is reversed
before the frame projection (raytracer.cpp:367,409,488,541-544).
``projradius`` takes the Keplerian velocity at the radius projected on the
equatorial plane; ``motion = 1`` makes the receiver move radially.

The emissivity app's two chains, ``redshift_start`` before the march and
its redshift, hit test, bin ids and weights after it, also run as two
hand-written kernels (``csrc/redshift.cu``: ``emit_kernel``,
``emis_weights_kernel``) on a batch ``kernel_takes``; they give the torch
chains' bits on the card (but for ``gamma`` outside torch's forms of
``pow``: ``emis_weights_kernel``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from raytrace_tpu_torch import mathfn
from raytrace_tpu_torch.geometry.kerr import metric_coeffs, metric_dot, momentum_from_consts
from raytrace_tpu_torch.ops.reductions import carries_derivative
from raytrace_tpu_torch.rays import RAY_STATUS_DEST, RAY_STATUS_RLIM, RayBatch

# The per-ray fields the redshift kernels read, in the order of their
# launch arguments (csrc/redshift.cu): float64 but the two int32 counters.
KERNEL_FIELDS = ("t", "r", "theta", "k", "h", "Q", "rdot_sign", "thetadot_sign", "emit",
                 "steps", "status")
_INT_FIELDS = ("steps", "status")

# the hit tests of emis_weights_kernel, by the emissivity's variant
_ROUTE_CODE = {"plain": 0, "rd": 1}

# Redshift kernel launches so far: counted where they are launched, nowhere else.
launches = 0


def _sanitize(rays: RayBatch) -> RayBatch:
    """Evaluate redshift quantities at a benign point for rays whose result
    is meaningless anyway (dead padding, horizon captures, stuck rays);
    untraced batches keep their source state."""
    meaningful = ((rays.steps > 0) & ((rays.status & (RAY_STATUS_DEST | RAY_STATUS_RLIM)) != 0)) | (
        rays.steps == 0
    )
    one = torch.ones_like(rays.k)
    return rays.replace(
        r=torch.where(meaningful, rays.r, 10.0 * one),
        theta=torch.where(meaningful, rays.theta, one),
        k=torch.where(meaningful, rays.k, one),
        h=torch.where(meaningful, rays.h, 0.0 * one),
        Q=torch.where(meaningful, rays.Q, one),
    )


def _orbit_et(r, theta, a, V):
    """Timelike tetrad leg of an observer orbiting at Omega = V; the
    Lorentz-factor argument is floored at the dtype's tiny where the orbit
    would be spacelike (those rays are masked out downstream)."""
    g = metric_coeffs(r, theta, a)
    dv = V - g.omega
    arg = 1.0 - dv * dv * g.e2psi / g.e2nu
    gamma = 1.0 / mathfn.sqrt(torch.clamp_min(arg, torch.finfo(arg.dtype).tiny))
    ut = gamma / mathfn.sqrt(g.e2nu)
    zero = torch.zeros_like(ut)
    return g, (ut, zero, zero, ut * V)


def _energy_in_frame(rays: RayBatch, spin, et, g, reverse: bool):
    """E = g_munu et^mu p^nu with the momentum re-derived from the constants
    at the ray's position (trace spin), spatial components reversed when
    tracing backwards."""
    pt, pr, ptheta, pphi = momentum_from_consts(
        rays.r, rays.theta, rays.k, rays.h, rays.Q, rays.rdot_sign, rays.thetadot_sign, spin
    )
    if reverse:
        pr, ptheta, pphi = -pr, -ptheta, -pphi
    return metric_dot(g, et, (pt, pr, ptheta, pphi))


def _resolve_V(V, a, r, theta, projradius: bool):
    """V = -1 selects the Keplerian orbit at the ray's radius, or at the
    radius projected parallel to the equatorial plane with ``projradius``
    (raytracer.cpp:391-394)."""
    r_eff = r * mathfn.sin(theta) if projradius else r
    kepler = 1.0 / (a + r_eff * mathfn.sqrt(r_eff))
    V = torch.as_tensor(V, dtype=r.dtype, device=r.device)
    return torch.where(V == -1, kepler, V)


def _radial_et(r, theta, spin, a, V):
    """Metric and timelike leg of an observer moving radially at dr/dt = V
    (motion = 1, raytracer.cpp:528-535): V < 0 is |V| times the local
    coordinate speed of light, which the reference scales with the trace
    spin; u^t's argument is floored at the dtype's tiny where the frame is
    spacelike, as ``_orbit_et`` floors its own."""
    g = metric_coeffs(r, theta, a)
    V = torch.as_tensor(V, dtype=r.dtype, device=r.device)
    spd = (r * r - 2.0 * r + spin + spin) / (r * r + spin * spin)
    Vr = torch.where(V < 0, torch.abs(V) * spd, V)
    arg = g.g_tt + g.g_rr * Vr * Vr
    ut = 1.0 / mathfn.sqrt(torch.clamp_min(arg, torch.finfo(arg.dtype).tiny))
    zero = torch.zeros_like(ut)
    return g, (ut, Vr * ut, zero, zero)


def _frame_energy(rays: RayBatch, spin, V, reverse: bool, projradius: bool = False,
                  motion: int = 0):
    """Photon energy in the frame of an observer at each ray's position:
    orbiting at Omega = V (motion 0; V = -1 Keplerian) or moving radially at
    dr/dt = V (motion 1). Reversed, the metric and the observer take the
    physical spin -spin, the momentum the trace spin."""
    a = -spin if reverse else spin
    rs = _sanitize(rays)
    if motion == 0:
        g, et = _orbit_et(rs.r, rs.theta, a, _resolve_V(V, a, rs.r, rs.theta, projradius))
    else:
        g, et = _radial_et(rs.r, rs.theta, spin, a, V)
    return _energy_in_frame(rs, spin, et, g, reverse)


def _ratio(emit, recv, reverse: bool):
    """emit/recv, or recv/emit when traced backwards."""
    return recv / emit if reverse else emit / recv


def redshift_start(rays: RayBatch, spin, V, reverse: bool = False,
                   projradius: bool = False) -> RayBatch:
    """Store each ray's emitted energy in the frame of material at its
    initial position orbiting at Omega = V (raytracer.cpp:342-417). Call
    before the march; for image planes pass the trace spin and
    ``reverse=True``."""
    return rays.replace(emit=_frame_energy(rays, spin, V, reverse, projradius))


def ray_redshift(rays: RayBatch, spin, V=-1.0, reverse: bool = False,
                 projradius: bool = False, motion: int = 0):
    """Redshift emit/recv (recv/emit when reversed) at the ray endpoints.
    motion = 0: the receiver orbits azimuthally at Omega = V (V = -1
    Keplerian); motion = 1: it moves radially at dr/dt = V, V < 0 meaning
    |V| times the local coordinate speed of light (raytracer.cpp:528-535)."""
    return _ratio(rays.emit, _frame_energy(rays, spin, V, reverse, projradius, motion), reverse)


def ray_redshift_dest(rays: RayBatch, spin, dest, reverse: bool = False):
    """Redshift against the destination's 4-velocity field
    (raytracer.cpp:450-477,556-600). The reference evaluates the metric and
    the observer with the *trace* spin here, reversed or not; so does this."""
    rs = _sanitize(rays)
    et = dest.four_velocity(rs.r, rs.theta, rs.phi, spin)
    g = metric_coeffs(rs.r, rs.theta, spin)
    return _ratio(rays.emit, _energy_in_frame(rs, spin, et, g, reverse), reverse)


def apply_redshift(rays: RayBatch, spin, V=-1.0, reverse: bool = False,
                   projradius: bool = False, motion: int = 0) -> RayBatch:
    return rays.replace(redshift=ray_redshift(rays, spin, V, reverse, projradius, motion))


def apply_redshift_dest(rays: RayBatch, spin, dest, reverse: bool = False) -> RayBatch:
    return rays.replace(redshift=ray_redshift_dest(rays, spin, dest, reverse))


def range_phi(rays: RayBatch, lo=-math.pi, hi=math.pi) -> RayBatch:
    """Wrap phi into [lo, hi), skipping NaN/huge values and failed rays
    (raytracer.cpp:603-622)."""
    span = hi - lo
    wrapped = rays.phi - span * torch.floor((rays.phi - lo) / span)
    ok = (torch.abs(rays.phi) <= 1000) & torch.isfinite(rays.phi) & (rays.steps > 0)
    return rays.replace(phi=torch.where(ok, wrapped, rays.phi))


def kernel_takes(rays: RayBatch, *scalars) -> bool:
    """Whether the emissivity's chains run as the kernels: a batch on a card
    with no derivative in its fields or scalars (``carries_derivative``).
    The CPU and a derivative take torch's chain. On a card the kernels take
    only a float64 batch and Python-number scalars, and anything else
    raises."""
    if not rays.r.is_cuda or any(
            carries_derivative(x) for x in (*(getattr(rays, f) for f in KERNEL_FIELDS), *scalars)
            if isinstance(x, torch.Tensor)):
        return False
    if rays.r.dtype != torch.float64:
        raise ValueError(f"the redshift kernels take a float64 batch, not {rays.r.dtype}")
    if any(isinstance(x, torch.Tensor) for x in scalars):
        raise TypeError("the redshift kernels take their scalars as Python numbers, not tensors")
    return True


def _pointers(rays: RayBatch):
    """The fields the kernels read, contiguous and in their dtypes, and a
    ctypes array of their data pointers in launch order."""
    fields = [getattr(rays, f).to(torch.int32 if f in _INT_FIELDS else torch.float64).contiguous()
              for f in KERNEL_FIELDS]
    return fields, (ctypes.c_void_p * len(fields))(*(x.data_ptr() for x in fields))


def emit_args(rays: RayBatch, spin, V):
    """``emit_kernel``'s inputs (kept alive with the call), its output
    ``emit`` and the launch's arguments but the stream."""
    fields, ptrs = _pointers(rays)
    emit = torch.empty_like(fields[1])
    return fields, emit, [ptrs, emit.data_ptr(), rays.n_rays, float(spin), float(V)]


def emis_weights_args(rays: RayBatch, spin, variant: str, *, r_isco, theta_lim, r_min, dr,
                      n_bins: int, logbin: bool, gamma, n_primary):
    """``emis_weights_kernel``'s inputs (kept alive with the call), its
    outputs (ids, mask, columns) and the launch's arguments but the
    stream: the bins' step is log(dr) for log bins (as
    ``reductions.radial_bin_index`` takes it), dr for linear ones."""
    fields, ptrs = _pointers(rays)
    n, device = rays.n_rays, fields[1].device
    ids = torch.empty(n, dtype=torch.int64, device=device)
    mask = torch.empty(n, dtype=torch.bool, device=device)
    columns = torch.empty(4, n, dtype=torch.float64, device=device)
    args = [ptrs, ids.data_ptr(), mask.data_ptr(), columns.data_ptr(), n, float(spin),
            _ROUTE_CODE[variant], float(r_isco), float(theta_lim), int(bool(logbin)),
            float(r_min), math.log(dr) if logbin else float(dr), int(n_bins), float(gamma),
            float(n_primary)]
    return fields, (ids, mask, list(columns)), args


def _launch(name: str, args: list, device) -> None:
    """One launch of the library's ``name`` on the current stream of
    ``device``, counted in ``launches``; raises on a CUDA error."""
    global launches
    from raytrace_tpu_torch.ops import march_kernel

    with torch.cuda.device(device):
        err = getattr(march_kernel.load(), name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")
    launches += 1


def emit_kernel(rays: RayBatch, spin, V) -> RayBatch:
    """``redshift_start(rays, spin, V)`` (not reversed, no ``projradius``)
    as one launch of ``emit_kernel`` on the current stream of the batch's
    card: the same bits, with ``spin`` and ``V`` passed by value. Counted
    in ``launches``; does not synchronise."""
    fields, emit, args = emit_args(rays, spin, V)
    if rays.n_rays:
        _launch("rt_emit_launch", args, emit.device)
    return rays.replace(emit=emit)


def emis_weights_kernel(rays: RayBatch, spin, variant: str, **scalars):
    """The emissivity's chain after the march as one launch of
    ``emis_weights_kernel`` on the current stream of the batch's card:
    each ray's redshift (``apply_redshift(range_phi(rays), spin, V=-1.0)``
    for ``variant`` "plain", ``apply_redshift_dest`` against the FlatDisc's
    4-velocity for "rd"), the variant's hit test, ``radial_bin_index``
    and ``emissivity_bin_weights``, from the keyword scalars of
    ``emis_weights_args``. Returns (ids, mask, columns): the int64 bin ids,
    the hits inside a bin and the flux, emis, redshift and time weights,
    which ``reductions.masked_bins`` takes. The same bits as the torch
    chain, but for a ``gamma`` that torch's pow takes no form of its own
    for (``csrc/redshift.cuh``, ``pow_scalar``): that emis column is the
    library's pow, an ulp or two from torch's. Every scalar passed by
    value. Counted in ``launches``; does not synchronise."""
    fields, (ids, mask, columns), args = emis_weights_args(rays, spin, variant, **scalars)
    if rays.n_rays:
        _launch("rt_emis_weights_launch", args, fields[1].device)
    return ids, mask, columns
