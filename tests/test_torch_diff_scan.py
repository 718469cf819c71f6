"""The port's differentiable march (ops/diff.py::trace_scan) against the
plain march and against the JAX package: the forward march ray for ray, and
single-ray gradients through it in reverse and forward mode against
jax.grad of the same pipeline (tests/test_diff.py:27-45).

The single ray (alpha 2.0, beta 1.0 from h = 5) lands after 319 RK4 steps
and 89 DOPRI5 steps (in more iterations: a rejected trial takes one and
counts no step); the marches here stop at 384 and 128 iterations, past its
landing, where it is frozen, so the values are those of the JAX test's
2048 and 1200 iterations. The RK45 case is in tests/test_torch_diff_rk45.py,
to keep each file near a minute on one worker. Tolerances stand beside
what was measured.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.geometry import constants_from_angles  # noqa: E402
from raytrace_tpu_torch.ops import trace  # noqa: E402
from raytrace_tpu_torch.ops.diff import trace_scan  # noqa: E402
from raytrace_tpu_torch.ops.redshift import apply_redshift  # noqa: E402
from raytrace_tpu_torch.rays import blank_batch  # noqa: E402
from raytrace_tpu_torch.sources import PointSourceGrid, point_source  # noqa: E402

SPIN = 0.9
F64 = torch.float64
# method -> lock-step iterations past the single ray's landing
SINGLE_STEPS = {"rk4": 384, "rk45": 128}


def _same(a, b):
    """Equal bit for bit, NaN equal to NaN."""
    if a.is_floating_point():
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(a[~a.isnan()], b[~b.isnan()])
    return torch.equal(a, b)


def test_trace_scan_matches_trace_and_jax():
    """tests/test_diff.py:48-55 for the port: on the 0.25 grid (200 rays),
    trace_scan's 3072 iterations against the plain trace at steplim 3073,
    every field bit for bit; against JAX's trace_scan, statuses equal on
    every ray, steps on every ray but those launched at sin(beta) = 0, at
    the polar turning point, whose first polar sign is a rounding coin flip
    (ROADMAP Queue 3; 1 of the 8 here takes one more step in JAX), and r
    to rtol 1e-11 off them (measured 2.9e-12: libm sin/cos ulps along ~330
    steps; JAX's own trace and trace_scan share one compiler and agree to
    1e-12)."""
    from raytrace_tpu.ops.diff import trace_scan as jscan
    from raytrace_tpu.sources import PointSourceGrid as JGrid
    from raytrace_tpu.sources import point_source as jpoint_source

    steps = (0.25, 0.25, -0.9, 0.9, -3.0, 3.0)
    rays = point_source((0.0, 5.0, 1e-3, 0.0), 0.0, SPIN, PointSourceGrid.from_steps(*steps),
                        device="cpu")
    scan = trace_scan(rays, SPIN, method="rk4", r_max=500.0, n_steps=3072)
    plain = trace(rays, SPIN, method="rk4", r_max=500.0, steplim=3073)
    for f in plain.__dataclass_fields__:
        assert _same(getattr(scan, f), getattr(plain, f)), f

    jrays = jpoint_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=SPIN, grid=JGrid.from_steps(*steps))
    ref = jscan(jrays, SPIN, method="rk4", r_max=500.0, n_steps=3072)
    edge = rays.beta.numpy() == 0.0
    assert edge.sum() == 8
    np.testing.assert_array_equal(scan.status.numpy(), np.asarray(ref.status))
    same_steps = scan.steps.numpy() == np.asarray(ref.steps)
    assert same_steps[~edge].all() and (~same_steps[edge]).sum() <= 1
    np.testing.assert_allclose(scan.r.numpy()[~edge], np.asarray(ref.r)[~edge], rtol=1e-11)


def test_trace_scan_runs_whole_chunks_as_jax():
    """Where checkpoint_every does not divide n_steps, trace_scan runs
    ceil(n_steps / checkpoint_every) whole chunks, as JAX's: at n_steps 96
    and checkpoint_every 64, 128 iterations under the per-ray steplim 97,
    so every ray that needs more than 97 steps (all 48 live rays of the
    0.5 grid need ~330) ends STEPLIM with its count negated. Statuses equal
    JAX's trace_scan on every ray, unrecorded and with a gradient recorded
    (the checkpointed chunks); steps on every ray but the sin(beta) = 0
    ones (tests/test_torch_diff_scan.py's first test)."""
    from raytrace_tpu.ops.diff import trace_scan as jscan
    from raytrace_tpu.sources import PointSourceGrid as JGrid
    from raytrace_tpu.sources import point_source as jpoint_source

    steps = (0.5, 0.5, -0.9, 0.9, -3.0, 3.0)
    kw = dict(method="rk4", r_max=500.0, n_steps=96, checkpoint_every=64)
    rays = point_source((0.0, 5.0, 1e-3, 0.0), 0.0, SPIN, PointSourceGrid.from_steps(*steps),
                        device="cpu")
    jrays = jpoint_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=SPIN, grid=JGrid.from_steps(*steps))
    ref = jscan(jrays, SPIN, **kw)
    live = rays.steps.numpy() == 0
    edge = rays.beta.numpy() == 0.0
    assert live.sum() == 48
    assert ((np.asarray(ref.status) == 8) == live).all()
    spin = torch.tensor(SPIN, dtype=F64, requires_grad=True)
    for out in (trace_scan(rays, SPIN, **kw), trace_scan(rays, spin, **kw)):
        np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
        np.testing.assert_array_equal(out.steps.numpy()[live & ~edge], -97)
        np.testing.assert_array_equal(out.steps.numpy()[~edge], np.asarray(ref.steps)[~edge])


def _single_ray(spin, h, method, checkpoint_every=64, alpha=2.0, beta=1.0, n_steps=None):
    """Landing radius and redshift of one robust disc-hitting lamppost ray
    (tests/test_diff.py::_single_ray_pipeline); with ``n_steps`` fewer than
    SINGLE_STEPS, its radius and redshift that many iterations out."""
    n = 8
    full = lambda v: torch.full((n,), v, dtype=F64)
    r0 = h * torch.ones(n, dtype=F64)
    th0 = full(1e-3)
    c = constants_from_angles(r0, th0, full(alpha), full(beta), 0.0, spin)
    rays = blank_batch(n, device="cpu").replace(
        r=r0, theta=th0, k=c.k, h=c.h, Q=c.Q, rdot_sign=c.rdot_sign,
        thetadot_sign=c.thetadot_sign, steps=torch.zeros(n, dtype=torch.int32), emit=full(1.0))
    out = trace_scan(rays, spin, method=method, r_max=500.0,
                     n_steps=n_steps or SINGLE_STEPS[method], checkpoint_every=checkpoint_every)
    out = apply_redshift(out, spin, V=-1.0)
    return torch.stack([out.r[0], out.redshift[0]])


def _jax_single_ray(spin, h, method):
    import jax.numpy as jnp

    from raytrace_tpu.geometry import constants_from_angles as jconstants
    from raytrace_tpu.ops.diff import trace_scan as jscan
    from raytrace_tpu.ops.redshift import apply_redshift as japply
    from raytrace_tpu.rays import blank_batch as jblank

    n = 8
    r0, th0 = jnp.full((n,), h), jnp.full((n,), 1e-3)
    c = jconstants(r0, th0, jnp.full((n,), 2.0), jnp.full((n,), 1.0), 0.0, spin)
    rays = jblank(n).replace(
        r=r0, theta=th0, phi=jnp.zeros(n), t=jnp.zeros(n), k=c.k, h=c.h, Q=c.Q,
        rdot_sign=c.rdot_sign, thetadot_sign=c.thetadot_sign,
        steps=jnp.zeros(n, jnp.int32), emit=jnp.ones(n))
    out = japply(jscan(rays, spin, method=method, r_max=500.0, n_steps=SINGLE_STEPS[method]),
                 spin, V=-1.0)
    return jnp.stack([out.r[0], out.redshift[0]])


# method -> rtol of (value, Jacobian) against JAX, and of forward against
# reverse mode, each over what was measured
SINGLE_TOLS = {
    # value 7.5e-14, Jacobian 4.0e-11, forward/reverse 3.5e-13
    "rk4": (1e-12, 1e-9, 1e-11),
    # value 7.5e-11; Jacobian 2.9e-6, forward/reverse 1.8e-9: the DOPRI5
    # controller's derivative runs through pow(err, -1/5) of an error
    # estimate at rounding level, which the two libraries (and the two
    # modes' association) round apart
    "rk45": (1e-9, 1e-5, 1e-8),
}


def check_single_ray_gradients(method):
    """d(landing r, redshift)/d(spin, h) of the single ray: reverse mode
    (one batched backward through the checkpointed chunks) against
    jax.jacrev, forward mode (torch.func.jacfwd) against reverse, with the
    tolerances of SINGLE_TOLS; checkpoint_every 16 gives the value and the
    Jacobian of checkpoint_every 64 bit for bit."""
    import jax

    v_tol, j_tol, fr_tol = SINGLE_TOLS[method]
    ref_jac, ref = jax.jacrev(lambda s, h: (_jax_single_ray(s, h, method),) * 2,
                              argnums=(0, 1), has_aux=True)(SPIN, 5.0)
    ref, ref_jac = np.asarray(ref), np.stack([np.asarray(x) for x in ref_jac], axis=1)

    def reverse(checkpoint_every):
        p = [torch.tensor(x, dtype=F64, requires_grad=True) for x in (SPIN, 5.0)]
        out = _single_ray(*p, method, checkpoint_every)
        jac = torch.autograd.grad(out, p, torch.eye(2, dtype=F64), is_grads_batched=True)
        return out.detach(), torch.stack(jac, dim=1)

    value, jac = reverse(64)
    np.testing.assert_allclose(value.numpy(), ref, rtol=v_tol)
    np.testing.assert_allclose(jac.numpy(), ref_jac, rtol=j_tol)
    assert torch.isfinite(jac).all() and float(jac[0, 1]) > 0  # a higher source lands further out

    value16, jac16 = reverse(16)
    assert torch.equal(value16, value) and torch.equal(jac16, jac)

    fwd = torch.func.jacfwd(lambda p: _single_ray(p[0], p[1], method))(
        torch.tensor([SPIN, 5.0], dtype=F64))
    np.testing.assert_allclose(fwd.numpy(), jac.numpy(), rtol=fr_tol)


def test_single_ray_gradients_match_jax_rk4():
    check_single_ray_gradients("rk4")


def test_forward_mode_beside_a_recorded_gradient():
    """Forward mode through trace_scan while another input records a
    gradient, so that the march divides through integrate._Quotient (the
    division whose backward keeps a zero cotangent from meeting an
    overflowed derivative). d(r, redshift)/d(spin) of the single RK4 ray
    64 iterations out (four checkpointed chunks of 16), by
    torch.autograd.forward_ad and by torch.func.jacfwd with h recording a
    gradient, equals the tangent of the same march with nothing recorded
    bit for bit; and h's gradient, taken by backward inside the same dual
    level, equals the one taken without a tangent bit for bit."""
    from torch.autograd import forward_ad as fwad

    kw = dict(checkpoint_every=16, n_steps=64)

    def dual_run(h):
        with fwad.dual_level():
            s = fwad.make_dual(torch.tensor(SPIN, dtype=F64), torch.tensor(1.0, dtype=F64))
            value, tangent = fwad.unpack_dual(_single_ray(s, h, "rk4", **kw))
            d_h = torch.autograd.grad(value[0], h) if h.requires_grad else None
            return value.detach(), tangent.detach(), d_h

    value, tangent, _ = dual_run(torch.tensor(5.0, dtype=F64))
    assert torch.isfinite(tangent).all() and float(tangent.abs().min()) > 0
    h = torch.tensor(5.0, dtype=F64, requires_grad=True)
    value_h, tangent_h, (d_h,) = dual_run(h)
    assert torch.equal(value_h, value) and torch.equal(tangent_h, tangent)
    jac = torch.func.jacfwd(lambda s: _single_ray(s, h, "rk4", **kw))(
        torch.tensor(SPIN, dtype=F64))
    assert torch.equal(jac.detach(), tangent)

    h_alone = torch.tensor(5.0, dtype=F64, requires_grad=True)
    (d_h_alone,) = torch.autograd.grad(_single_ray(SPIN, h_alone, "rk4", **kw)[0], h_alone)
    assert torch.equal(d_h, d_h_alone) and float(d_h) > 0
