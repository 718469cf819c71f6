"""Differentiable geodesic tracing: torch autograd over the plain march.

Counterpart of ``raytrace_tpu/ops/diff.py``. ``trace`` (ops/integrate.py)
compacts lanes with in-place scatters and replays CUDA graphs, and autograd
goes through neither; ``trace_scan`` is the same masked lock-step march
over a *fixed* number of iterations, with every lane kept and frozen once
it ends, cut into chunks that ``torch.utils.checkpoint`` recomputes in the
backward pass. So the whole pipeline (source constants -> march ->
redshift -> smooth observables) is differentiable with respect to spin,
source height, the emissivity index gamma and the inclination, in reverse
mode (``.backward()``, ``torch.autograd.grad``) and in forward mode
(``torch.autograd.forward_ad``, ``torch.func.jvp`` / ``jacfwd``).
``torch.func``'s reverse transforms (``grad``, ``vjp``, ``jacrev``) refuse
the checkpoint's saved-tensor hooks.

The step bodies are those of the plain march, so a lane's values are the
plain march's; ``_safe_eval_state`` keeps the branch that a ``torch.where``
does not take free of inf and NaN in the backward pass. The JAX module's
docstring says what the gradients mean: masked freezing is transparent to
them, rays through turning points carry noisy ones, and ensemble spin
gradients hold the membership of the stop-gradient masks fixed.

The entry points that build their own rays (``emissivity_gradient_pipeline``,
``emissivity_binned_profile``, ``line_profile_observable``) run on the card
unless ``device="cpu"`` is passed, and raise without one
(``apps.require_device``); the others run on the device of the tensors
they are given. A tensor parameter is moved to that device, where its
gradient arrives.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch.autograd import forward_ad as fwad
from torch.utils.checkpoint import checkpoint

from raytrace_tpu_torch import mathfn
from raytrace_tpu_torch.apps import require_device
from raytrace_tpu_torch.destinations import ThetaLimit
from raytrace_tpu_torch.geometry import (
    bl_to_cartesian,
    horizon_radius,
    integrate_disc_area_bins,
    isco_radius,
)
from raytrace_tpu_torch.ops import integrate
from raytrace_tpu_torch.ops.integrate import (
    StepControl,
    _capture_radius,
    _euler_rk4_body,
    _fresh_propagation_state,
    _refine_theta_crossing,
    _rk45_body,
    _seed_rk45_rates,
)
from raytrace_tpu_torch.ops.redshift import apply_redshift, redshift_start
from raytrace_tpu_torch.ops.reductions import bin_edges, radial_bin_profile
from raytrace_tpu_torch.rays import (
    RAY_STATUS_DEST,
    RAY_STATUS_NUMERIC,
    RAY_STATUS_STEPLIM,
    RayBatch,
)
from raytrace_tpu_torch.sources import grid_angles, image_plane, point_source_from_angles
from raytrace_tpu_torch.sources.imageplane import _traced_batch

_FIELDS = tuple(f.name for f in dataclasses.fields(RayBatch))


def _on(p, device):
    """A tensor parameter moved to ``device`` (its graph kept); a Python
    number as it is."""
    return p.to(device) if isinstance(p, torch.Tensor) else p


def _has_tangent(x):
    return isinstance(x, torch.Tensor) and fwad.unpack_dual(x).tangent is not None


def _replay_graphs(rays):
    """Whether an unrecorded march replays CUDA graphs: a CUDA batch,
    ``integrate._CUDA_GRAPHS`` on, and no ``torch.func`` transform active
    (its wrapped tensors are not captured)."""
    return (rays.r.is_cuda and integrate._CUDA_GRAPHS
            and not torch._C._are_functorch_transforms_active())


def _flat(st, step, rates):
    """The march's carry as flat tensors: the batch's fields, the step and
    the RK45 rates (none for Euler and RK4)."""
    return (*(getattr(st, f) for f in _FIELDS), step, *(rates or ()))


def _unflat(flat):
    n = len(_FIELDS)
    return RayBatch(**dict(zip(_FIELDS, flat))), flat[n], tuple(flat[n + 1:]) or None


def _replayed(advance, flat, n_steps, params):
    """``n_steps`` iterations of ``advance`` on a CUDA batch with nothing
    recorded: the first eager, the rest replays of it captured as a CUDA
    graph (``integrate._capture``; the same kernels, so the same bits,
    without the host's dispatch of each operation). In forward mode (a
    tangent on any input, ``torch.autograd.forward_ad``) every float input
    is given a tangent, zero where it had none, before the capture, so that
    the graph carries each one's tangent from iteration to iteration."""
    if any(_has_tangent(x) for x in flat + params):
        flat = tuple(fwad.make_dual(x, torch.zeros_like(x))
                     if x.is_floating_point() and not _has_tangent(x) else x for x in flat)
    carry, graph = integrate._capture(advance, *advance(*_unflat(flat)))
    for _ in range(n_steps - 1):
        graph.replay()
    return _flat(*carry)


def trace_scan(
    rays: RayBatch,
    spin,
    *,
    method: str = "rk4",
    dest=None,
    r_max=1000.0,
    n_steps: int = 2048,
    ctrl: StepControl = StepControl(),
    boundary=None,
    checkpoint_every: int = 64,
    refine_crossing: bool = True,
) -> RayBatch:
    """Fixed-iteration differentiable twin of ``trace``.

    Runs ``n_chunks * checkpoint_every`` lock-step iterations of the plain
    march's step body over every lane (ended lanes frozen), with
    ``n_chunks = ceil(n_steps / checkpoint_every)`` whole chunks, as the
    JAX function does: ``n_steps`` itself where ``checkpoint_every``
    divides it (every default). Where a gradient is being recorded, each
    chunk runs under
    ``torch.utils.checkpoint``: the forward pass keeps only the chunk
    boundaries (the batch's fields, the step and the RK45 rates as flat
    tensors) and the backward pass recomputes one chunk at a time, so the
    memory is O(n_steps / checkpoint_every) states plus one chunk's
    residuals. Forward mode records no graph and keeps no residuals; it
    runs the iterations as they are. On a CUDA batch with nothing recorded
    (a value alone, or forward mode through ``torch.autograd.forward_ad``)
    the iterations after the first replay it as a CUDA graph
    (``_replayed``); under ``torch.func`` they run eagerly.

    The per-ray step budget is ``n_steps + 1``, so STEPLIM cannot trigger
    within ``n_steps`` iterations: where the chunks run past ``n_steps``, a
    ray that needs more than ``n_steps + 1`` steps ends STEPLIM, its count
    negated, as in JAX; otherwise a ray still going is just unfinished.
    """
    if method not in ("euler", "rk4", "rk45"):
        raise ValueError(f"unknown method {method!r}")
    if dest is None:
        dest = ThetaLimit(math.pi / 2)
    horizon = horizon_radius(spin) if boundary is None else boundary
    steplim = n_steps + 1
    r_max = float(r_max)
    capture = _capture_radius(horizon, ctrl.horizon_eps, rays.r)

    rays = _fresh_propagation_state(rays, spin, horizon, method, ctrl)
    rates = _seed_rk45_rates(rays, rays.active, spin) if method == "rk45" else None

    def advance(st, step, rates):
        if method == "rk45":
            return _rk45_body(st, spin, horizon, capture, dest, r_max, steplim, ctrl,
                              st.active, step, rates)
        return (_euler_rk4_body(st, spin, horizon, capture, dest, r_max, steplim, ctrl,
                                method, st.active), step, rates)

    def run(n, *flat):
        carry = _unflat(flat)
        for _ in range(n):
            carry = advance(*carry)
        return _flat(*carry)

    flat = _flat(rays, rays.dt, rates)
    params = (spin, horizon, capture)
    n_chunks = -(-n_steps // checkpoint_every)
    recording = torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in flat + params)
    if recording:
        for _ in range(n_chunks):
            flat = checkpoint(functools.partial(run, checkpoint_every), *flat,
                              use_reentrant=False)
    elif n_chunks * checkpoint_every > 1 and _replay_graphs(rays):
        flat = _replayed(advance, flat, n_chunks * checkpoint_every, params)
    else:
        flat = run(n_chunks * checkpoint_every, *flat)

    final, step, _ = _unflat(flat)
    final = final.replace(dt=step)
    # stuck rays get their (positive) step count negated (raytracer.cpp:336-337)
    stuck = ((final.status & (RAY_STATUS_STEPLIM | RAY_STATUS_NUMERIC)) != 0) & (final.steps > 0)
    final = final.replace(steps=torch.where(stuck, -final.steps, final.steps))
    if refine_crossing:
        final = _refine_theta_crossing(final, dest, spin)
    return final


def separatrix_score(k, h, Q, spin, n_grid=64):
    """Smooth per-ray distance to the Kerr photon-shell separatrix: the
    minimum over a log grid of r in [1, 4.5] (every spherical photon orbit
    for |a| <= 1) of Carter's radial potential R(r), normalised by the size
    of its cancelling terms. Rays near 0 are the chaotic photon-sphere
    skimmers; the score depends on the initial constants alone. See the
    JAX function."""
    k_safe = torch.where(torch.abs(k) > 1e-30, k, torch.ones_like(k))
    xi = (h / k_safe)[..., None]
    eta = (Q / (k_safe * k_safe))[..., None]
    r = torch.logspace(0.0, math.log10(4.5), n_grid, dtype=k.dtype, device=k.device)
    delta = r * r - 2.0 * r + spin * spin
    A = (r * r + spin * spin) - spin * xi
    B = eta + (xi - spin) ** 2
    R = A * A - delta * B
    norm = A * A + torch.abs(delta) * B + 1.0
    return torch.amin(R / norm, dim=-1)


def launch_turning_scores(r0, theta0, k, h, Q, spin):
    """Normalised radial and polar potentials at the launch point: rays
    launched exactly at a turning point (cos alpha = 0, sin beta = 0) take
    the sign of their first move from rounding. See the JAX function."""
    k_safe = torch.where(torch.abs(k) > 1e-30, k, torch.ones_like(k))
    xi = h / k_safe
    eta = Q / (k_safe * k_safe)
    delta = r0 * r0 - 2.0 * r0 + spin * spin
    A = r0 * r0 + spin * spin - spin * xi
    B = eta + (xi - spin) ** 2
    r_score = (A * A - delta * B) / (A * A + torch.abs(delta) * B + 1.0)
    sin2 = torch.clamp_min(mathfn.sin(theta0) ** 2, 1e-30)
    cos2 = mathfn.cos(theta0) ** 2
    barrier = xi * xi / sin2
    th_score = (eta + cos2 * (spin * spin - barrier)) / (eta + spin * spin + barrier + 1.0)
    return r_score, th_score


def chaos_weight(sep_score, launch_scores=(), sep_margin=0.05, launch_margin=0.02):
    """Smooth membership weight, one factor 1 - exp(-(s/margin)^2) for the
    separatrix score and one for each launch turning score: it takes the
    rounding-sensitive ray sets out of an observable's value, not only of
    its gradient. See the JAX function."""
    xs = sep_score / sep_margin
    w = -torch.expm1(-(xs * xs))
    for s in launch_scores:
        x = s / launch_margin
        w = w * -torch.expm1(-(x * x))
    return w


def smooth_radial_observable(out: RayBatch, mask, weights, r0, sigma_ln=0.25):
    """The weights of masked rays summed under a log-normal radial window
    centred on ``r0`` (a Python float): the smooth analogue of a radial bin."""
    r_safe = torch.where(mask, out.r, r0)
    w_safe = torch.where(mask, weights, 0.0)
    w = torch.exp(-0.5 * ((torch.log(r_safe) - math.log(r0)) / sigma_ln) ** 2)
    return torch.sum(torch.where(mask, w * w_safe, 0.0))


def emissivity_observable_from_angles(spin, h_source, gamma, cosalpha, beta, dead, *,
                                      n_steps=3072, r0=5.0, sigma_ln=0.3, r_max=500.0):
    """Differentiable emissivity observable for an explicit angle set:
    lamppost constants -> RK4 ``trace_scan`` -> redshift -> smooth radial
    observable. The angle tensors are fixed geometry (their dtype and
    device are the march's); spin, h_source and gamma may be tensors that
    carry gradients."""
    spin, h_source, gamma = (_on(p, cosalpha.device) for p in (spin, h_source, gamma))
    rays = point_source_from_angles((0.0, h_source, 1e-3, 0.0), 0.0, spin, cosalpha, beta, dead)
    rays = redshift_start(rays, spin, V=0.0)
    out = trace_scan(rays, spin, method="rk4", r_max=r_max, n_steps=n_steps)
    out = apply_redshift(out, spin, V=-1.0)
    # the mask is piecewise constant in the parameters (JAX: stop_gradient)
    hit = (out.ok & ((out.status & RAY_STATUS_DEST) != 0) & (out.redshift > 0)
           & (out.r >= isco_radius(spin))).detach()
    # near-separatrix and launch-turning-point rays are weighted out of the
    # value smoothly, by a function of the pre-march constants alone
    w_stable = chaos_weight(
        separatrix_score(rays.k, rays.h, rays.Q, spin),
        launch_turning_scores(rays.r, rays.theta, rays.k, rays.h, rays.Q, spin),
    )
    g_safe = torch.where(hit, out.redshift, 1.0)
    return smooth_radial_observable(out, hit, w_stable / g_safe**gamma, r0, sigma_ln)


def _line_profile_fold(out, spin, a_trace, r_disc, q, e_rest, energies, sigma_e):
    """The post-march fold both line-profile observables share: disc-hit
    mask, chaos weight, flux epsilon(r)/g^3 under a Gaussian energy kernel
    at e_rest/g."""
    g = out.redshift
    _, _, z = bl_to_cartesian(out.r, out.theta, out.phi, spin)
    hit = (out.ok & (z < 1e-2) & (out.r >= isco_radius(spin)) & (out.r < r_disc)
           & (g > 0)).detach()
    w = chaos_weight(separatrix_score(out.k, out.h, out.Q, a_trace))
    g_safe = torch.where(hit, g, 1.0)
    r_safe = torch.where(hit, out.r, 1.0)
    flux = torch.where(hit, w * r_safe ** (-q) / g_safe**3, 0.0)
    e_obs = e_rest / g_safe
    kern = torch.exp(-0.5 * ((energies[None, :] - e_obs[:, None]) / sigma_e) ** 2)
    return torch.sum(flux[:, None] * kern, dim=0)


def _energies(energies, e_rest, like):
    """The profile's energies on ``like``'s device (default: 48 points over
    0.3..1.3 e_rest)."""
    if energies is None:
        return torch.linspace(0.3 * e_rest, 1.3 * e_rest, 48, dtype=like.dtype,
                              device=like.device)
    return torch.as_tensor(energies, device=like.device)


def line_profile_observable(spin, incl_deg, grid, *, dist=500.0, r_disc=50.0, q=3.0,
                            e_rest=1.0, energies=None, sigma_e=0.035, n_steps=2048,
                            checkpoint_every=64, device="cuda", dtype=torch.float64):
    """Differentiable relativistic line profile P(E; spin, incl): an image
    plane traced backwards through ``trace_scan`` (RK4) and folded into a
    smooth observed line profile (``_line_profile_fold``). A tensor
    ``spin`` or ``incl_deg`` takes ``image_plane``'s all-traced
    construction, through which both are differentiable; Python floats
    keep its float64 seeding. Returns the profile at ``energies``."""
    device = require_device(device)
    spin = _on(spin, device)
    a_trace = -spin
    rays = image_plane(dist, incl_deg, grid, spin, device=device, dtype=dtype)
    rays = redshift_start(rays, a_trace, V=0.0, reverse=True)
    out = trace_scan(rays, a_trace, method="rk4", r_max=1.1 * dist, n_steps=n_steps,
                     checkpoint_every=checkpoint_every)
    out = apply_redshift(out, a_trace, V=-1.0, reverse=True)
    return _line_profile_fold(out, spin, a_trace, r_disc, q, e_rest,
                              _energies(energies, e_rest, out.r), sigma_e)


def line_profile_from_xy(spin, incl_deg, x, y, dead=None, *, dist=500.0, r_disc=50.0, q=3.0,
                         e_rest=1.0, energies=None, sigma_e=0.035, n_steps=2048,
                         checkpoint_every=64):
    """``line_profile_observable`` over explicit plane coordinates ``x``,
    ``y`` (their dtype and device are the march's): the rays are built by
    the all-traced construction, so gradients flow through spin and incl;
    ``dead`` marks padding rows, left out of the profile."""
    spin = _on(spin, x.device)
    a_trace = -spin
    rays = _traced_batch(x, y, dist, incl_deg, spin, 0.0)
    if dead is not None:
        rays = rays.replace(steps=torch.where(dead, -1, rays.steps).to(torch.int32))
    rays = redshift_start(rays, a_trace, V=0.0, reverse=True)
    out = trace_scan(rays, a_trace, method="rk4", r_max=1.1 * dist, n_steps=n_steps,
                     checkpoint_every=checkpoint_every)
    out = apply_redshift(out, a_trace, V=-1.0, reverse=True)
    return _line_profile_fold(out, spin, a_trace, r_disc, q, e_rest,
                              _energies(energies, e_rest, x), sigma_e)


def emissivity_binned_profile(spin, h_source, gamma, grid, *, r_min=None, r_disc=500.0,
                              n_r=100, logbin_r=True, n_steps=6144, r_max=1000.0,
                              method="rk4", checkpoint_every=64, device="cuda",
                              dtype=torch.float64):
    """Differentiable twin of ``apps.emissivity.compute``'s binned output:
    the same bins, hit criterion (``apps.emissivity.disc_hit_mask``),
    emissivity weight 1/g^gamma and rest-frame areas, marched with
    ``trace_scan``. The hit mask and the bin of each ray are held fixed
    (JAX: stop_gradient). Returns (emis, counts) over the ``n_r`` bins."""
    from raytrace_tpu_torch.apps.emissivity import disc_hit_mask

    device = require_device(device)
    spin, h_source, gamma = (_on(p, device) for p in (spin, h_source, gamma))
    rmin = isco_radius(spin) if r_min is None else r_min
    disc_r, disc_width, dr = bin_edges(rmin, r_disc, n_r, logbin_r, device=device, dtype=dtype)
    areas = integrate_disc_area_bins(disc_r, disc_r + disc_width, spin)

    cosalpha, beta, dead = grid_angles(grid, device=device, dtype=dtype)
    rays = point_source_from_angles((0.0, h_source, 1e-3, 0.0), 0.0, spin, cosalpha, beta, dead)
    rays = redshift_start(rays, spin, V=0.0)
    out = trace_scan(rays, spin, method=method, r_max=r_max, n_steps=n_steps,
                     checkpoint_every=checkpoint_every)
    out = apply_redshift(out, spin, V=-1.0)
    mask = disc_hit_mask(out, spin).detach()
    g = torch.where(mask, out.redshift, 1.0)
    counts, sums = radial_bin_profile(out.r.detach(), mask, {"emis": 1.0 / g**gamma},
                                      rmin, dr, n_r, logbin_r)
    return sums["emis"] / areas, counts


def emissivity_gradient_pipeline(spin, h_source, gamma, grid, *, n_steps=3072, r0=5.0,
                                 sigma_ln=0.3, r_max=500.0, device="cuda",
                                 dtype=torch.float64):
    """End-to-end differentiable emissivity observable E(spin, h, gamma) on
    the lamppost grid ``grid``: ``emissivity_observable_from_angles`` over
    its angles, built in ``dtype`` on ``device``. Pass tensors that require
    grad and call ``.backward()`` on the result, or take forward-mode
    derivatives with ``torch.func.jvp`` / ``jacfwd``."""
    cosalpha, beta, dead = grid_angles(grid, device=require_device(device), dtype=dtype)
    return emissivity_observable_from_angles(spin, h_source, gamma, cosalpha, beta, dead,
                                             n_steps=n_steps, r0=r0, sigma_ln=sigma_ln,
                                             r_max=r_max)
