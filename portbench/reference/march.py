"""Batched null-geodesic integration in the Kerr spacetime — plain PyTorch.

Counterpart of ``raytrace_tpu/ops/integrate.py`` and the plain version of
the CUDA march kernel (``ops/march_kernel.py``): the whole batch marches in
lock-step, one masked step body per iteration, until no ray is active or
``max_iters`` is reached. Finished rays are frozen. RK4 and the adaptive
Dormand-Prince DOPRI5 (``rk45``) with its FSAL carry, and Euler, are
ported. Works in f32 or f64 on whatever device the batch lives on.

Retired lanes are dropped every ``_COMPACT_EVERY`` iterations (gather the
active rays, march them, scatter back): a retired lane is frozen, so this
leaves every result unchanged and only cuts the cost of the long tail. On
a CUDA batch the iteration of each compaction epoch is captured once as a
CUDA graph and replayed (``_capture``): the same kernels, so the same bits,
at a fraction of the host's cost per iteration.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import mathfn
from .destinations import ThetaLimit
from .kerr import (
    GeodesicRates,
    geodesic_rates,
    horizon_radius,
    momentum_from_consts,
)
from .rays import (
    RAY_STATUS_DEST,
    RAY_STATUS_ERGO,
    RAY_STATUS_HORIZON,
    RAY_STATUS_NEG_ENERGY,
    RAY_STATUS_NUMERIC,
    RAY_STATUS_RLIM,
    RAY_STATUS_STEPLIM,
    RayBatch,
)

# Reference step limits (raytracer.h:30-39).
STEPLIM = 10_000_000
RK45_STEPLIM = 100_000

_PI = math.pi
_HALF_PI = math.pi / 2
_CHECK_EVERY = 16
_COMPACT_EVERY = 256
_CUDA_GRAPHS = True  # replay each compaction epoch's iteration as a CUDA graph
# Lock-step iterations so far: one for each iteration ``_march`` runs (eager
# or replayed) and each z-plane of ``apps.pcyg.compute``; read for measurement.
iterations = 0


@dataclasses.dataclass(frozen=True)
class StepControl:
    """Step-size tuning constants (raytracer.h:18-46); see the JAX
    ``StepControl`` for the rationale of each."""

    precision: float = 100.0
    theta_precision: float = 50.0
    max_tstep: float = 1.0  # MAXDT: cap on coordinate-time step ...
    maxtstep_rlim: float = 100.0  # ... applied only inside this radius
    max_phistep: float = 0.1  # MAXDPHI
    min_step: float = 1e-3  # MIN_STEP
    rk45_tol: float = 1e-8  # DOPRI5 mixed abs/rel error tolerance
    horizon_eps: float = 1e-6  # relative thickness of the horizon-capture shell
    safety: float = 0.9  # Hairer-Wanner controller constants
    fac_min: float = 0.1
    fac_max: float = 5.0


# DOPRI5 Butcher tableau (Dormand & Prince 1980); b2 = 0, e_i = b_i - b*_i.
_A21 = 1 / 5
_A31, _A32 = 3 / 40, 9 / 40
_A41, _A42, _A43 = 44 / 45, -56 / 15, 32 / 9
_A51, _A52, _A53, _A54 = 19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729
_A61, _A62, _A63, _A64, _A65 = 9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656
_B1, _B3, _B4, _B5, _B6 = 35 / 384, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84
_E1, _E3, _E4, _E5, _E6, _E7 = (
    71 / 57600,
    -71 / 16695,
    71 / 1920,
    -17253 / 339200,
    22 / 525,
    -1 / 40,
)


def _flag(mask, flag):
    return torch.where(mask, flag, 0).to(torch.int32)


def _safe_div(num, den):
    """num / den with |den| floored at the dtype's smallest normal (never
    changes a nonzero denominator). A Python-float numerator is made a
    tensor first, so the division is a true one (torch computes
    ``float / tensor`` as a reciprocal times the float)."""
    t = torch.full_like(den, torch.finfo(den.dtype).tiny)
    safe = torch.where(torch.abs(den) < t, torch.where(den < 0, -t, t), den)
    if not isinstance(num, torch.Tensor):
        num = torch.full_like(den, num)
    if torch.is_grad_enabled() and (num.requires_grad or safe.requires_grad):
        return _Quotient.apply(num, safe)
    return num / safe


class _Quotient(torch.autograd.Function):
    """``num / den`` whose backward gives a lane with a zero cotangent a
    zero gradient. Where ``den`` is the floor (a ray launched at a turning
    point has a rate of exactly 0), ``num / den`` overflows, and the
    branch of a ``torch.where`` that does not take it still sends it a
    zero cotangent: torch's division backward multiplies that zero by the
    infinite derivative and returns NaN, which then reaches the parameter
    gradients. Elsewhere the gradients are torch's division's, bit for
    bit. Forward mode (``jvp``) and ``torch.func`` (``setup_context``, vmap
    rule) take the same rule: a lane whose tangents are both zero has a
    zero tangent."""

    generate_vmap_rule = True

    @staticmethod
    def forward(num, den):
        return num / den

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        num, den = ctx.saved_tensors
        live = grad != 0
        zero = torch.zeros_like(grad)
        d_num = torch.where(live, grad / den, zero) if ctx.needs_input_grad[0] else None
        d_den = (torch.where(live, -grad * ((num / den) / den), zero)
                 if ctx.needs_input_grad[1] else None)
        return d_num, d_den

    @staticmethod
    def jvp(ctx, num_t, den_t):
        num, den = ctx.saved_tensors
        num_t = torch.zeros_like(num) if num_t is None else num_t
        den_t = torch.zeros_like(den) if den_t is None else den_t
        tangent = num_t / den - den_t * ((num / den) / den)
        return torch.where((num_t != 0) | (den_t != 0), tangent, torch.zeros_like(tangent))


def _div(num: float, den):
    """True division of a Python float by a tensor."""
    return torch.full_like(den, num) / den


def _sdiv(x, den: float):
    """True division of a tensor by a Python float. On a CUDA tensor torch
    computes ``x / float`` as ``x * (1 / float)``, which rounds differently
    from the division the JAX march and the CUDA kernel take."""
    return x / torch.full((), den, dtype=x.dtype, device=x.device)


def _k1_stage(st: RayBatch, spin, rates=None):
    """First-stage momenta with the turning-point sign bookkeeping.

    A lane whose polar rate went negative while its gate was open flips its
    theta sign and skips this step (raytracer.cpp:196-201). ``rates`` is the
    optional FSAL carry: rates already evaluated at the current position,
    re-signed here against the current polar sign.
    """
    if rates is None:
        rates = geodesic_rates(st.r, st.theta, st.k, st.h, st.Q, st.rdot_sign,
                               st.thetadot_sign, spin)
    else:
        rates = rates._replace(ptheta=torch.abs(rates.ptheta) * st.thetadot_sign)

    theta_flip = (rates.thetadot_sq < 0) & st.theta_was_positive
    thetadot_sign = torch.where(theta_flip, -st.thetadot_sign, st.thetadot_sign)
    theta_was_positive = ~theta_flip & (rates.thetadot_sq >= 0)

    r_flip = (rates.rdot_sq <= 0) & st.r_was_positive & ~theta_flip
    rdot_sign = torch.where(r_flip, -st.rdot_sign, st.rdot_sign)
    r_was_positive = torch.where(theta_flip, st.r_was_positive, rates.rdot_sq > 0)

    # pr takes the *new* radial sign (raytracer.cpp:211-222)
    pr1 = torch.abs(rates.pr) * rdot_sign
    return (theta_flip, r_flip, rdot_sign, thetadot_sign, r_was_positive,
            theta_was_positive, rates.pt, pr1, rates.ptheta, rates.pphi, rates)


def _nonphysical_status(st, spin, pt1, pphi1, active, rates):
    """ERGO (p^t <= 0) and negative-Killing-energy flags (raytracer.cpp:263-273)."""
    sin_t, inv_rhosq = rates.sin_t, rates.inv_rhosq
    killing = (1.0 - 2.0 * st.r * inv_rhosq) * pt1 + (
        2.0 * spin * st.r * sin_t * sin_t * inv_rhosq
    ) * pphi1
    status = st.status | _flag(active & (pt1 <= 0), RAY_STATUS_ERGO)
    return status | _flag(active & (killing < 0), RAY_STATUS_NEG_ENERGY)


def _base_step_size(st, horizon, pt1, pr1, ptheta1, pphi1, rlim, ctrl: StepControl):
    """Fixed-step heuristic of Euler and RK4 (raytracer.cpp:224-243)."""
    step = _sdiv(torch.abs(_safe_div(st.r - horizon, pr1)), ctrl.precision)
    theta_cap = torch.abs(_safe_div(st.theta, ptheta1))
    step = torch.where(step > _sdiv(theta_cap, ctrl.precision),
                       _sdiv(theta_cap, ctrl.theta_precision), step)
    if ctrl.max_tstep > 0:
        t_cap = torch.abs(_safe_div(ctrl.max_tstep, pt1))
        step = torch.where((st.r < ctrl.maxtstep_rlim) & (step > t_cap), t_cap, step)
    if ctrl.max_phistep > 0:
        phi_cap = torch.abs(_safe_div(ctrl.max_phistep, pphi1))
        step = torch.where(step > phi_cap, phi_cap, step)
    step = torch.clamp_min(step, ctrl.min_step)
    if rlim > 0:
        step = torch.where(st.r + pr1 * step > rlim,
                           torch.abs(_safe_div(rlim - st.r, pr1)), step)
    return step


def _polar_reflect(theta, phi, thetadot_sign):
    """Reflect at the polar axes: theta into [0, pi], phi rotated by pi
    (raytracer.cpp:281-283)."""
    low = theta < 0
    high = theta > _PI
    theta = torch.where(low, -theta, torch.where(high, 2 * _PI - theta, theta))
    flip = low | high
    phi = torch.where(flip, phi + _PI, phi)
    thetadot_sign = torch.where(flip, -thetadot_sign, thetadot_sign)
    return theta, phi, thetadot_sign


def _capture_radius(horizon, horizon_eps, like):
    """Horizon-capture radius as a 0-d tensor of ``like``'s dtype on its
    device: the shell floored at 200 ulp of the working dtype (see the JAX
    _commit: in f32 the RK45 horizon cap stalls outside the 1e-6 shell).
    ``trace`` makes it once, so the march copies nothing from the host per
    iteration."""
    eps_eff = torch.clamp_min(torch.tensor(horizon_eps, dtype=like.dtype),
                              200 * torch.finfo(like.dtype).eps)
    return horizon * (1.0 + eps_eff).to(like.device)


def _commit(st: RayBatch, dest, rlim, capture, steplim, commit_mask,
            new_pos, new_mom, signs, counters):
    """Apply an accepted step for the lanes in commit_mask and update status.

    Termination priority is horizon (``r <= capture``, see
    ``_capture_radius``), then rlim, then destination
    (raytracer.cpp:287-320); the step-limit test follows the step count.
    """
    t_n, r_n, th_n, ph_n = new_pos
    pt_n, pr_n, pth_n, pph_n = new_mom
    rdot_sign, thetadot_sign, rwp, twp = signs
    counted, r_flip = counters

    prev_theta = st.theta
    sel = lambda new, old: torch.where(commit_mask, new, old)
    t = sel(t_n, st.t)
    r = sel(r_n, st.r)
    theta = sel(th_n, st.theta)
    phi = sel(ph_n, st.phi)

    crossed_eq = commit_mask & (
        ((prev_theta < _HALF_PI) & (theta >= _HALF_PI))
        | ((prev_theta > _HALF_PI) & (theta <= _HALF_PI))
    )
    steps = st.steps + counted.to(torch.int32)
    rdot_flips = st.rdot_flips + (r_flip & counted).to(torch.int32)
    eq_cross = st.equatorial_crossings + crossed_eq.to(torch.int32)

    hit_horizon = commit_mask & (r <= capture)
    hit_rlim = commit_mask & ~hit_horizon & (r >= rlim) if rlim > 0 else torch.zeros_like(hit_horizon)
    hit_dest = commit_mask & ~hit_horizon & ~hit_rlim & dest.reached(r, theta, phi, prev_theta)
    status = (st.status | _flag(hit_horizon, RAY_STATUS_HORIZON)
              | _flag(hit_rlim, RAY_STATUS_RLIM) | _flag(hit_dest, RAY_STATUS_DEST))

    active_after = (steps >= 0) & (
        (status & (RAY_STATUS_DEST | RAY_STATUS_HORIZON | RAY_STATUS_RLIM)) == 0
    )
    status = status | _flag(active_after & (steps >= steplim), RAY_STATUS_STEPLIM)

    return st.replace(
        t=t, r=r, theta=theta, phi=phi,
        pt=sel(pt_n, st.pt), pr=sel(pr_n, st.pr),
        ptheta=sel(pth_n, st.ptheta), pphi=sel(pph_n, st.pphi),
        rdot_sign=rdot_sign, thetadot_sign=thetadot_sign,
        r_was_positive=rwp, theta_was_positive=twp,
        steps=steps, status=status, rdot_flips=rdot_flips,
        equatorial_crossings=eq_cross,
    )


def _k1_finite(pt1, pr1, ptheta1, pphi1):
    """Lanes whose first-stage rates are finite; the others can never
    advance and are flagged RAY_STATUS_NUMERIC."""
    return (torch.isfinite(pt1) & torch.isfinite(pr1)
            & torch.isfinite(ptheta1) & torch.isfinite(pphi1))


def _safe_eval_state(st: RayBatch, active):
    """Give inactive lanes a benign evaluation point (their results are
    never committed; this keeps them free of inf/NaN)."""
    one = torch.ones_like(st.k)
    return st.replace(
        r=torch.where(active, st.r, 10.0 * one),
        theta=torch.where(active, st.theta, one),
        k=torch.where(active, st.k, one),
        h=torch.where(active, st.h, 0.0 * one),
        Q=torch.where(active, st.Q, one),
    )


def _signs(active, st, rdot_sign, thetadot_sign, rwp, twp):
    """Sign/gate updates apply to every active lane, advancing or not."""
    return (
        torch.where(active, rdot_sign, st.rdot_sign),
        torch.where(active, thetadot_sign, st.thetadot_sign),
        torch.where(active, rwp, st.r_was_positive),
        torch.where(active, twp, st.theta_was_positive),
    )


def _euler_rk4_body(st: RayBatch, spin, horizon, capture, dest, rlim, steplim, ctrl, method,
                    active):
    """One lock-step Euler or RK4 iteration."""
    st_eval = _safe_eval_state(st, active)
    (theta_flip, r_flip, rdot_sign, thetadot_sign, rwp, twp,
     pt1, pr1, ptheta1, pphi1, rates1) = _k1_stage(st_eval, spin)

    advance = active & ~theta_flip
    status = _nonphysical_status(st_eval, spin, pt1, pphi1, advance, rates1)
    k1_bad = advance & ~_k1_finite(pt1, pr1, ptheta1, pphi1)
    advance = advance & ~k1_bad
    st = st.replace(status=status | _flag(k1_bad, RAY_STATUS_NUMERIC))

    step = _base_step_size(st_eval, horizon, pt1, pr1, ptheta1, pphi1, rlim, ctrl)
    # the plain thetalim mode clamps the final step onto the disc plane
    # (raytracer.cpp:243); destination mode does not
    if isinstance(dest, ThetaLimit):
        lim = dest.step_limit(st_eval.r, st_eval.theta, st_eval.phi, pr1, ptheta1, pphi1)
        step = torch.minimum(step, lim)

    r0, th0 = st_eval.r, st_eval.theta
    if method == "euler":  # the step is the k1 rates; they are the new momentum
        t_n = st.t + pt1 * step
        r_n = r0 + pr1 * step
        th_raw = th0 + ptheta1 * step
        ph_n = st.phi + pphi1 * step
        mom = (pt1, pr1, ptheta1, pphi1)
    else:
        k, h, Q = st.k, st.h, st.Q
        half = step / 2
        pt2, pr2, pth2, pph2 = momentum_from_consts(
            r0 + half * pr1, th0 + half * ptheta1, k, h, Q, rdot_sign, thetadot_sign, spin)
        pt3, pr3, pth3, pph3 = momentum_from_consts(
            r0 + half * pr2, th0 + half * pth2, k, h, Q, rdot_sign, thetadot_sign, spin)
        pt4, pr4, pth4, pph4 = momentum_from_consts(
            r0 + step * pr3, th0 + step * pth3, k, h, Q, rdot_sign, thetadot_sign, spin)
        w = _sdiv(step, 6)
        t_n = st.t + w * (pt1 + 2 * pt2 + 2 * pt3 + pt4)
        r_n = r0 + w * (pr1 + 2 * pr2 + 2 * pr3 + pr4)
        th_raw = th0 + w * (ptheta1 + 2 * pth2 + 2 * pth3 + pth4)
        ph_n = st.phi + w * (pphi1 + 2 * pph2 + 2 * pph3 + pph4)
        mom = (pt4, pr4, pth4, pph4)

    th_n, ph_n, thetadot_sign_r = _polar_reflect(th_raw, ph_n, thetadot_sign)
    thetadot_sign = torch.where(advance, thetadot_sign_r, thetadot_sign)

    return _commit(
        st, dest, rlim, capture, steplim, advance,
        (t_n, r_n, th_n, ph_n), mom,
        _signs(active, st, rdot_sign, thetadot_sign, rwp, twp),
        (active, r_flip),
    )


def _rk45_body(st: RayBatch, spin, horizon, capture, dest, rlim, steplim, ctrl, active, step,
               rates):
    """One lock-step DOPRI5 iteration; ``rates`` is the packed FSAL carry.
    Returns (st, step, rates_next)."""
    st_eval = _safe_eval_state(st, active)
    (theta_flip, r_flip, rdot_sign, thetadot_sign, rwp, twp,
     pt1, pr1, ptheta1, pphi1, rates1) = _k1_stage(st_eval, spin, _unpack_rates(rates))

    advance = active & ~theta_flip
    status = _nonphysical_status(st_eval, spin, pt1, pphi1, advance, rates1)
    k1_bad = advance & ~_k1_finite(pt1, pr1, ptheta1, pphi1)
    advance = advance & ~k1_bad
    st = st.replace(status=status | _flag(k1_bad, RAY_STATUS_NUMERIC))

    # horizon step-cap on the carried step (raytracer.cpp:1412-1434)
    step_max = _sdiv(torch.abs(_safe_div(st_eval.r - horizon, pr1)), ctrl.precision)
    if ctrl.max_phistep > 0:
        step_max = torch.minimum(step_max, torch.abs(_safe_div(ctrl.max_phistep, pphi1)))
    if ctrl.max_tstep > 0:
        step_max = torch.where(
            st_eval.r < ctrl.maxtstep_rlim,
            torch.minimum(step_max, torch.abs(_safe_div(ctrl.max_tstep, pt1))),
            step_max,
        )
    step = torch.where(advance & (step > step_max), step_max, step)

    # destination clamp; a clamped accepted step keeps the old step size
    # (raytracer.cpp:1442-1453, 1752-1755)
    lim = dest.step_limit(st_eval.r, st_eval.theta, st_eval.phi, pr1, ptheta1, pphi1)
    clamped = lim < step
    h_try = torch.where(clamped, lim, step)

    k, h, Q = st.k, st.h, st.Q
    r0, th0 = st_eval.r, st_eval.theta

    def at(dr, dth):
        return momentum_from_consts(r0 + h_try * dr, th0 + h_try * dth,
                                    k, h, Q, rdot_sign, thetadot_sign, spin)

    pt2, pr2, pth2, pph2 = at(_A21 * pr1, _A21 * ptheta1)
    pt3, pr3, pth3, pph3 = at(_A31 * pr1 + _A32 * pr2, _A31 * ptheta1 + _A32 * pth2)
    pt4, pr4, pth4, pph4 = at(
        _A41 * pr1 + _A42 * pr2 + _A43 * pr3,
        _A41 * ptheta1 + _A42 * pth2 + _A43 * pth3,
    )
    pt5, pr5, pth5, pph5 = at(
        _A51 * pr1 + _A52 * pr2 + _A53 * pr3 + _A54 * pr4,
        _A51 * ptheta1 + _A52 * pth2 + _A53 * pth3 + _A54 * pth4,
    )
    pt6, pr6, pth6, pph6 = at(
        _A61 * pr1 + _A62 * pr2 + _A63 * pr3 + _A64 * pr4 + _A65 * pr5,
        _A61 * ptheta1 + _A62 * pth2 + _A63 * pth3 + _A64 * pth4 + _A65 * pth5,
    )

    r_new = r0 + h_try * (_B1 * pr1 + _B3 * pr3 + _B4 * pr4 + _B5 * pr5 + _B6 * pr6)
    th_new_raw = th0 + h_try * (
        _B1 * ptheta1 + _B3 * pth3 + _B4 * pth4 + _B5 * pth5 + _B6 * pth6
    )
    t_new = st.t + h_try * (_B1 * pt1 + _B3 * pt3 + _B4 * pt4 + _B5 * pt5 + _B6 * pt6)
    phi_new = st.phi + h_try * (
        _B1 * pphi1 + _B3 * pph3 + _B4 * pph4 + _B5 * pph5 + _B6 * pph6
    )
    th_new, phi_new, thetadot_sign_r = _polar_reflect(th_new_raw, phi_new, thetadot_sign)

    # FSAL stage k7 at the new point (pre-reflection polar sign)
    rates7 = geodesic_rates(r_new, th_new, k, h, Q, rdot_sign, thetadot_sign, spin)
    pt7, pr7, pth7, pph7 = rates7.pt, rates7.pr, rates7.ptheta, rates7.pphi

    err_r = h_try * (_E1 * pr1 + _E3 * pr3 + _E4 * pr4 + _E5 * pr5 + _E6 * pr6 + _E7 * pr7)
    err_th = h_try * (
        _E1 * ptheta1 + _E3 * pth3 + _E4 * pth4 + _E5 * pth5 + _E6 * pth6 + _E7 * pth7
    )
    sc_r = ctrl.rk45_tol * (1.0 + torch.maximum(torch.abs(r0), torch.abs(r_new)))
    sc_th = ctrl.rk45_tol * (1.0 + torch.maximum(torch.abs(th0), torch.abs(th_new)))
    e_r = err_r / sc_r
    e_th = err_th / sc_th
    err_norm = mathfn.sqrt(0.5 * (e_r * e_r + e_th * e_th))

    # a non-finite trial is a maximal-error reject; still non-finite at the
    # MIN_STEP floor, the lane is numerically dead
    trial_ok = (torch.isfinite(err_norm) & torch.isfinite(r_new) & torch.isfinite(th_new)
                & torch.isfinite(t_new) & torch.isfinite(phi_new))
    err_eff = torch.where(trial_ok, err_norm, torch.full_like(err_norm, 1e30))
    numeric_stuck = advance & ~trial_ok & (h_try <= ctrl.min_step)
    st = st.replace(status=st.status | _flag(numeric_stuck, RAY_STATUS_NUMERIC))

    fac = ctrl.safety * torch.pow(1.0 / torch.clamp_min(err_eff, 1e-10), 0.2)
    fac = torch.clamp(fac, ctrl.fac_min, ctrl.fac_max)
    step_new = torch.clamp_min(h_try * fac, ctrl.min_step)

    accept_err = err_eff <= 1.0
    force = ~accept_err & (step_new <= ctrl.min_step)
    accept = advance & (accept_err | force) & trial_ok

    # carried step (raytracer.cpp:1521-1539): accepted unclamped steps adopt
    # the controller prediction, accepted clamped steps keep the old step,
    # rejected lanes shrink
    new_step = torch.where(advance, torch.where(accept_err & clamped, step, step_new), step)

    thetadot_sign = torch.where(accept, thetadot_sign_r, thetadot_sign)
    counted = active & (theta_flip | accept)
    st = _commit(
        st, dest, rlim, capture, steplim, accept,
        (t_new, r_new, th_new, phi_new), (pt7, pr7, pth7, pph7),
        _signs(active, st, rdot_sign, thetadot_sign, rwp, twp),
        (counted, r_flip),
    )
    # FSAL carry: accepted lanes' k7 is the next k1; every other lane keeps
    # its current-position rates. Non-finite rates of lanes that just went
    # inactive are zeroed (a no-op on every live lane).
    alive = st.active
    rates_next = tuple(
        torch.where(alive | torch.isfinite(x), x, torch.zeros_like(x))
        for x in (torch.where(accept, a, b)
                  for a, b in zip(_pack_rates(rates7), _pack_rates(rates1)))
    )
    return st, new_step, rates_next


def _pack_rates(r):
    """FSAL carry layout: the GeodesicRates fields the next k1 stage and the
    status flags read."""
    return (r.pt, r.pr, r.ptheta, r.pphi, r.thetadot_sq, r.rdot_sq, r.sin_t, r.inv_rhosq)


def _unpack_rates(c):
    pt, pr, ptheta, pphi, thetadot_sq, rdot_sq, sin_t, inv_rhosq = c
    # cos_t/rhosq are never read on the k1/status path
    return GeodesicRates(pt, pr, ptheta, pphi, thetadot_sq, rdot_sq,
                         sin_t, sin_t, sin_t, inv_rhosq)


def _fresh_propagation_state(rays: RayBatch, spin, horizon, method, ctrl: StepControl) -> RayBatch:
    """Reset the per-propagation sign gates (raytracer.cpp:137-138) and, for
    rk45, seed the adaptive step."""
    rays = rays.replace(
        r_was_positive=torch.zeros_like(rays.r_was_positive),
        theta_was_positive=torch.ones_like(rays.theta_was_positive),
    )
    if method == "rk45":
        rays = rays.replace(dt=_seed_rk45_step(rays, spin, horizon, ctrl))
    return rays


def _seed_rk45_rates(st: RayBatch, active, spin):
    """Seed the DOPRI5 FSAL carry: rates at each lane's current position."""
    se = _safe_eval_state(st, active)
    return _pack_rates(geodesic_rates(se.r, se.theta, se.k, se.h, se.Q,
                                      se.rdot_sign, se.thetadot_sign, spin))


def _seed_rk45_step(st: RayBatch, spin, horizon, ctrl):
    """Initial adaptive step from the fixed-step heuristic (raytracer.cpp:1339-1359)."""
    rates = geodesic_rates(st.r, st.theta, st.k, st.h, st.Q, st.rdot_sign,
                           st.thetadot_sign, spin)
    step = _sdiv(torch.abs((st.r - horizon) / rates.pr), ctrl.precision)
    theta_cap = torch.abs(st.theta / rates.ptheta)
    step = torch.where(
        (torch.abs(rates.ptheta) > 0) & (step > _sdiv(theta_cap, ctrl.theta_precision)),
        _sdiv(theta_cap, ctrl.theta_precision),
        step,
    )
    if ctrl.max_tstep > 0:
        t_cap = torch.abs(_div(ctrl.max_tstep, rates.pt))
        step = torch.where((st.r < ctrl.maxtstep_rlim) & (step > t_cap), t_cap, step)
    if ctrl.max_phistep > 0:
        phi_cap = torch.abs(_div(ctrl.max_phistep, rates.pphi))
        step = torch.where(step > phi_cap, phi_cap, step)
    return torch.clamp_min(step, ctrl.min_step)


def _scatter(full: RayBatch, idx, part: RayBatch) -> RayBatch:
    upd = {}
    for f in dataclasses.fields(full):
        v = getattr(full, f.name).clone()
        v[idx] = getattr(part, f.name)
        upd[f.name] = v
    return full.replace(**upd)


def trace(
    rays: RayBatch,
    spin,
    *,
    method: str = "rk45",
    dest=None,
    r_max=1000.0,
    steplim: int | None = None,
    ctrl: StepControl = StepControl(),
    boundary=None,
    max_iters: int | None = None,
    resume: bool = False,
    refine_crossing: bool = True,
) -> RayBatch:
    """Propagate every ray to its destination / the horizon / the radial limit.

    Args:
      rays: the ray batch; rays with steps < 0 are dead padding.
      spin: black-hole spin a (Python float or 0-d tensor).
      method: "euler" | "rk4" | "rk45".
      dest: termination surface (default ThetaLimit(pi/2), the disc plane);
        ThetaLimit/FlatDisc, DiscWithISCO, FlatPlane or SphericalShell. RK4
        and Euler clamp their step onto ThetaLimit only; RK45 caps every
        trial step at ``dest.step_limit`` (+inf for FlatPlane).
      r_max: outer radial limit (RAY_STATUS_RLIM); <= 0 disables.
      steplim: per-ray step budget; defaults to RK45_STEPLIM / STEPLIM.
      ctrl: step-size tuning constants.
      boundary: inner absorbing radius (defaults to the event horizon).
      max_iters: bound on lock-step iterations (default steplim + steplim
        // 4 + 16: 25% headroom for RK45 rejected trials).
      resume: continue a batch an earlier ``trace`` left unfinished (after
        ``max_iters``, or from ``utils.checkpoint.load_rays``): the sign
        gates are kept, not reset, and RK45 takes its step from ``rays.dt``
        and its rates afresh from each ray's position.
    """
    if method not in ("euler", "rk4", "rk45"):
        raise ValueError(f"unknown method {method!r}")
    if dest is None:
        dest = ThetaLimit(math.pi / 2)
    if steplim is None:
        steplim = RK45_STEPLIM if method == "rk45" else STEPLIM
    if max_iters is None:
        max_iters = march_budget(steplim)
    horizon = horizon_radius(spin) if boundary is None else boundary
    r_max = float(r_max)
    capture = _capture_radius(horizon, ctrl.horizon_eps, rays.r)

    if not resume:
        rays = _fresh_propagation_state(rays, spin, horizon, method, ctrl)
    rates = _seed_rk45_rates(rays, rays.active, spin) if method == "rk45" else None

    def advance(st, step, rates):
        if method == "rk45":
            return _rk45_body(st, spin, horizon, capture, dest, r_max, steplim, ctrl,
                              st.active, step, rates)
        return (_euler_rk4_body(st, spin, horizon, capture, dest, r_max, steplim, ctrl,
                                method, st.active), step, rates)

    final, _ = _march(rays, rays.dt, rates, advance, max_iters)

    # stuck rays get their step count negated (raytracer.cpp:336-337); only
    # a positive count, so a resumed batch's stuck rays stay as they were
    stuck = ((final.status & (RAY_STATUS_STEPLIM | RAY_STATUS_NUMERIC)) != 0) & (final.steps > 0)
    final = final.replace(steps=torch.where(stuck, -final.steps, final.steps))

    if refine_crossing:
        final = _refine_theta_crossing(final, dest, spin)
    return final


def march_budget(steplim: int) -> int:
    """Lock-step iterations a whole march may take: steplim plus 25%
    headroom for RK45 rejected trials, plus 16."""
    return steplim + steplim // 4 + 16


def _march(rays: RayBatch, step, carry, advance, max_iters: int):
    """The lock-step loop: ``st, step, carry = advance(st, step, carry)``
    over the batch's active rays until none is active or ``max_iters``
    iterations have run. ``step`` is the per-ray step tensor and ``carry``
    a tuple of per-ray tensors (their first axis the rays) or None; rays
    that are not active at the start are never marched, and every advance
    must leave a retired ray as it is. Returns the batch, whose marched
    rays hold their last ``step`` in ``dt``, and the carry, both at full
    size.

    Retired rays are dropped every ``_COMPACT_EVERY`` iterations (gather
    the active rays, march them, scatter back): a retired ray is frozen, so
    this changes no result and only cuts the cost of the long tail. On a
    CUDA batch the first iteration of each compaction epoch runs eagerly
    and the rest replay it as a CUDA graph (``_capture``). ``advance`` may
    also add into buffers of its own in place (a histogram): the graph
    replays those additions too. Each iteration run adds one to
    ``iterations``.
    """
    global iterations
    out = rays
    out_carry = tuple(v.clone() for v in carry) if carry is not None else None
    idx = torch.nonzero(rays.active).squeeze(1)
    st, step = rays[idx], step[idx]
    carry = tuple(v[idx] for v in carry) if carry is not None else None

    def scatter_back():
        for full, part in zip(out_carry or (), carry or ()):
            full[idx] = part
        return _scatter(out, idx, st.replace(dt=step))

    it = 0
    replay = None
    while it < max_iters and st.n_rays > 0:
        # an iteration with no active lane changes nothing, so the exit
        # test need not run every iteration (it costs a device sync)
        if it % _CHECK_EVERY == 0 and not bool(st.active.any()):
            break
        if it % _COMPACT_EVERY == 0 and it > 0:
            keep = torch.nonzero(st.active).squeeze(1)
            if keep.numel() < st.n_rays:
                out = scatter_back()
                idx, st, step = idx[keep], st[keep], step[keep]
                carry = tuple(v[keep] for v in carry) if carry is not None else None
                replay = None
        if replay is not None:
            replay.replay()
        else:
            st, step, carry = advance(st, step, carry)
            if st.r.is_cuda and _CUDA_GRAPHS:
                (st, step, carry), replay = _capture(advance, st, step, carry)
        it += 1
        iterations += 1
    return scatter_back(), out_carry


def _graph(fn):
    """Capture ``fn()`` on the current CUDA device as a graph. Capturing
    runs nothing: each ``replay()`` runs the captured kernels on the
    buffers they were captured on."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def _capture(advance, st: RayBatch, step, rates):
    """Capture one lock-step iteration on CUDA as a graph that updates its
    carry in place. Returns the carry (fresh buffers holding the current
    state) and the graph: each ``replay()`` is one iteration, the same
    kernels on the same shapes as the eager call, so the same bits, without
    the host's per-operation dispatch that bounds a small batch's eager
    iteration. The caller runs an eager iteration first (loading every
    kernel) and drops the graph when compaction changes the shapes."""
    names = [f.name for f in dataclasses.fields(st)]
    st = st.replace(**{n: getattr(st, n).clone() for n in names})
    step = step.clone()
    rates = tuple(v.clone() for v in rates) if rates is not None else None
    bufs = [getattr(st, n) for n in names] + [step] + list(rates or ())

    def iteration():
        st_n, step_n, rates_n = advance(st, step, rates)
        new = [getattr(st_n, n) for n in names] + [step_n] + list(rates_n or ())
        for buf, v in zip(bufs, new):
            buf.copy_(v)

    return (st, step, rates), _graph(iteration)


def _refine_theta_crossing(st: RayBatch, dest, spin) -> RayBatch:
    """Back-interpolate destination hits onto the theta_lim surface along the
    final momentum (position error O(step) -> O(step^2)). Surfaces without a
    ``theta_lim`` (FlatPlane, SphericalShell) are left alone."""
    theta_lim = getattr(dest, "theta_lim", None)
    if theta_lim is None:
        return st
    lim = theta_lim if theta_lim > 0 else -theta_lim
    hit = (st.status & RAY_STATUS_DEST) != 0
    pt, pr, pth, pph = momentum_from_consts(
        st.r, st.theta, st.k, st.h, st.Q, st.rdot_sign, st.thetadot_sign, spin
    )
    safe_pth = torch.where(pth == 0, torch.ones_like(pth), pth)
    delta = (st.theta - lim) / safe_pth
    ok = hit & (pth != 0) & (torch.abs(delta) < 1.0)
    apply = lambda q, dq: torch.where(ok, q - dq * delta, q)
    return st.replace(
        t=apply(st.t, pt),
        r=apply(st.r, pr),
        theta=torch.where(ok, torch.full_like(st.theta, lim), st.theta),
        phi=apply(st.phi, pph),
    )
