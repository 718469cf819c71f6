"""The tensor-parameter routes of the port's differentiable pipeline against
the JAX package: ``isco_radius`` with its custom derivative, the disc areas,
``bin_edges``, the lamppost and image-plane sources with tensor parameters,
a march step under a 0-d tensor spin, the ensemble scores of ops/diff.py,
and the entry points' device default.

Inputs come from seeds with numpy. Tolerances stand beside each check with
what was measured; the float routes are compared bit for bit.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.autograd import forward_ad as fwad  # noqa: E402

import raytrace_tpu_torch.geometry.kerr as pk  # noqa: E402
from raytrace_tpu_torch.geometry import integrate_disc_area_bins  # noqa: E402
from raytrace_tpu_torch.ops import diff  # noqa: E402
from raytrace_tpu_torch.ops.reductions import bin_edges  # noqa: E402
from raytrace_tpu_torch.sources import (  # noqa: E402
    ImagePlaneGrid,
    PointSourceGrid,
    grid_angles,
    image_plane,
    point_source_from_angles,
)

F64 = torch.float64
ISCO_SPINS = [0.0, 1e-9, 1e-6, 0.1, 0.5, 0.9, 0.998]


def _t(x, dtype=F64, grad=False):
    return torch.tensor(x, dtype=dtype, requires_grad=grad)


def _forward(fn, x):
    """Forward-mode derivative of fn at the 0-d tensor x."""
    with fwad.dual_level():
        out = fn(fwad.make_dual(x.detach(), torch.ones_like(x)))
        return fwad.unpack_dual(out).tangent


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("a", ISCO_SPINS)
def test_isco_radius_and_its_derivative_match_jax(a, dtype):
    """Value and d r_isco / da of a tensor spin, by backward, forward AD and
    jacfwd, against JAX's isco_radius and jax.grad (its custom JVP), both
    orbit senses. f64: value equal to the bit, derivative rtol 1e-14
    (measured 1.4e-15 at worst); f32: value 1e-6 (1.9e-7), derivative 1e-6
    (2.5e-7). At a = 0 the derivative is 0 exactly, and below eps^(1/4)
    the series branch gives 4 sqrt(2/3) = 3.266 in magnitude, as in JAX."""
    import jax
    import jax.numpy as jnp

    import raytrace_tpu.geometry.kerr as jk

    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rtol = 1e-14 if dtype == "float64" else 1e-6
    for sign in (1, -1):
        ref = float(jk.isco_radius(jnp.asarray(a, jdt), sign))
        ref_d = float(jax.grad(lambda x: jk.isco_radius(x, sign))(jnp.asarray(a, jdt)))
        x = _t(a, tdt, grad=True)
        r = pk.isco_radius(x, sign)
        r.backward()
        assert r.dtype == tdt
        fwd = _forward(lambda s: pk.isco_radius(s, sign), x)
        jac = torch.func.jacfwd(lambda s: pk.isco_radius(s, sign))(x.detach())
        if dtype == "float64":
            assert float(r) == ref
        np.testing.assert_allclose(float(r), ref, rtol=rtol)
        for d in (x.grad, fwd, jac):
            assert torch.isfinite(d)
            np.testing.assert_allclose(float(d), ref_d, rtol=rtol, atol=0.0)
        if a == 0.0:
            assert float(x.grad) == 0.0
        elif a < 1e-4:
            np.testing.assert_allclose(abs(float(x.grad)), 4 * math.sqrt(2 / 3), rtol=1e-5)


@pytest.mark.parametrize("a", ISCO_SPINS)
def test_isco_radius_float_route_is_unchanged(a):
    """A Python-float spin keeps the float route: a float, bit for bit the
    formula with numpy's cbrt, and the tensor route's f64 value to the bit."""
    cbrt = lambda v: float(np.cbrt(v))
    for sign in (1, -1):
        z1 = 1.0 + cbrt(1.0 - a * a) * (cbrt(1.0 + a) + cbrt(1.0 - a))
        z2 = math.sqrt(3.0 * a * a + z1 * z1)
        want = 3.0 + z2 - sign * math.sqrt((3.0 - z1) * (3.0 + z1 + 2.0 * z2))
        got = pk.isco_radius(a, sign)
        assert type(got) is float and got == want
        assert float(pk.isco_radius(_t(a), sign)) == got


def _total_area(a, lib="torch"):
    if lib == "jax":
        import jax.numpy as jnp

        from raytrace_tpu.geometry import integrate_disc_area_bins as jbins
        from raytrace_tpu.ops.reductions import bin_edges as jedges

        edges, width, _ = jedges(1.1, 500.0, 60, True)
        return jnp.sum(jbins(edges, edges + width, a))
    edges, width, _ = bin_edges(1.1, 500.0, 60, True, device="cpu")
    return torch.sum(integrate_disc_area_bins(edges, edges + width, a))


@pytest.mark.parametrize("a", [0.0, 0.1, 0.9, 0.998])
def test_disc_area_gradient_finite_and_matches_jax(a):
    """Port of tests/test_diff.py::test_disc_area_gradient_finite: d(bin
    areas)/d(spin) is finite for bins on both sides of the ISCO (the dead
    branch of the Keplerian/plunge switch is clamped), and matches the
    central difference to rtol 1e-2 at a > 0 (as the JAX test; measured
    3.4e-7 at worst). Against jax.grad: rtol 1e-10 (measured 8.2e-12 at
    a = 0.9, the sum over 60 bins cancels); forward mode against reverse
    1e-10 (2.2e-11). The tensor route's total area is the float route's to
    rtol 1e-14 (measured one ulp)."""
    import jax

    x = _t(a, grad=True)
    total = _total_area(x)
    total.backward()
    g = float(x.grad)
    assert np.isfinite(g), f"area gradient not finite at spin {a}"
    np.testing.assert_allclose(float(_forward(_total_area, x)), g, rtol=1e-10)
    np.testing.assert_allclose(g, float(jax.grad(lambda s: _total_area(s, "jax"))(a)),
                               rtol=1e-10)
    np.testing.assert_allclose(float(total), float(_total_area(a)), rtol=1e-14)
    if a > 0:
        v1, v2 = float(_total_area(a - 1e-6)), float(_total_area(a + 1e-6))
        np.testing.assert_allclose(g, (v2 - v1) / 2e-6, rtol=1e-2)


def test_bin_edges_with_tensor_r_min():
    """bin_edges with a tensor r_min equals the float route bit for bit
    (log and linear bins), and its derivative in r_min matches JAX's
    jacfwd to rtol 1e-13 (measured 2e-16)."""
    import jax
    import jax.numpy as jnp

    from raytrace_tpu.ops.reductions import bin_edges as jedges

    rng = np.random.default_rng(8)
    r_mins = [pk.isco_radius(0.998), pk.isco_radius(0.9), 2.5] + list(rng.uniform(1.1, 6.0, 5))
    for r_min in r_mins:
        for logbin in (True, False):
            want = bin_edges(float(r_min), 500.0, 100, logbin, device="cpu")
            got = bin_edges(_t(r_min), 500.0, 100, logbin, device="cpu")
            for w, v in zip(want, got):
                assert torch.equal(torch.as_tensor(w, dtype=F64), torch.as_tensor(v, dtype=F64))
    x = _t(2.5)
    d = torch.func.jacfwd(lambda m: bin_edges(m, 500.0, 100, True, device="cpu")[0])(x)
    dj = jax.jacfwd(lambda m: jedges(m, 500.0, 100, True)[0])(jnp.asarray(2.5))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-13)


def test_point_source_with_tensor_height():
    """Tensor entries of ``pos`` give the float route's batch bit for bit,
    and carry the gradient: d r / d h = 1 on every ray."""
    cosalpha, beta, dead = grid_angles(PointSourceGrid.from_steps(0.3, 0.3), device="cpu")
    want = point_source_from_angles((0.0, 5.0, 1e-3, 0.0), 0.0, 0.9, cosalpha, beta, dead)
    h = _t(5.0, grad=True)
    got = point_source_from_angles((0.0, h, _t(1e-3), 0.0), 0.0, _t(0.9), cosalpha, beta, dead)
    for f in ("t", "r", "theta", "phi", "k", "h", "Q", "rdot_sign", "thetadot_sign", "steps"):
        assert torch.equal(getattr(want, f), getattr(got, f).detach()), f
    got.r.sum().backward()
    assert float(h.grad) == cosalpha.shape[0]


def test_image_plane_all_traced_construction():
    """A tensor spin or inclination takes the all-traced construction: in
    float64 on the CPU every field equals the float64 seeding bit for bit;
    its gradients in spin and incl match JAX's all-traced image_plane under
    jax.jacfwd to rtol 1e-12 (measured 4e-15)."""
    import jax
    import jax.numpy as jnp

    from raytrace_tpu.sources import ImagePlaneGrid as JGrid
    from raytrace_tpu.sources import image_plane as jimage

    grid = ImagePlaneGrid.from_steps(-10.5, 11.5, 1.5, -10.5, 11.5, 1.5)
    jgrid = JGrid.from_steps(-10.5, 11.5, 1.5, -10.5, 11.5, 1.5)
    want = image_plane(100.0, 55.0, grid, 0.9, device="cpu")
    fields = ("t", "r", "theta", "phi", "pt", "pr", "ptheta", "pphi", "k", "h", "Q",
              "rdot_sign", "thetadot_sign", "steps", "alpha", "beta")
    for spin, incl in ((_t(0.9), 55.0), (0.9, _t(55.0)), (_t(0.9), _t(55.0))):
        got = image_plane(100.0, incl, grid, spin, device="cpu")
        for f in fields:
            assert torch.equal(getattr(want, f), getattr(got, f)), f
    for f in ("r", "theta", "phi", "pt", "pphi", "h", "Q"):
        d = torch.func.jacfwd(
            lambda p: getattr(image_plane(100.0, p[1], grid, p[0], device="cpu"), f))(
            torch.tensor([0.9, 55.0], dtype=F64))
        dj = jax.jacfwd(lambda p: getattr(jimage(100.0, p[1], jgrid, p[0]), f))(
            jnp.asarray([0.9, 55.0]))
        np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("method", ["rk4", "rk45"])
def test_march_under_a_tensor_spin_keeps_the_float_bits(method):
    """trace_scan (and so the step bodies, the capture radius, the RK45 seed
    and the crossing refinement) and the redshifts (redshift_start,
    apply_redshift with its Keplerian observer) under a 0-d float64 tensor
    spin give the float spin's bits in every field."""
    from raytrace_tpu_torch.ops.redshift import apply_redshift, redshift_start
    from raytrace_tpu_torch.sources import point_source

    grid = PointSourceGrid.from_steps(0.25, 0.25, -0.9, 0.9, -3.0, 3.0)
    rays = point_source((0.0, 5.0, 1e-3, 0.0), 0.0, 0.9, grid, device="cpu")

    def march(spin):
        out = diff.trace_scan(redshift_start(rays, spin, 0.0), spin, method=method,
                              r_max=500.0, n_steps=400)
        return apply_redshift(out, spin, V=-1.0)

    want, got = march(0.9), march(_t(0.9))
    assert ((want.status & 1) != 0).sum() > 10  # some rays reach the disc
    for f in want.__dataclass_fields__:
        a, b = getattr(want, f), getattr(got, f)
        assert torch.equal(a, b) or (a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
                                     and torch.equal(a[~a.isnan()], b[~b.isnan()])), f


def _constants(n=256, seed=31):
    rng = np.random.default_rng(seed)
    return dict(
        k=rng.uniform(0.5, 1.5, n), h=rng.uniform(-6.0, 6.0, n), Q=rng.uniform(0.0, 40.0, n),
        r0=rng.uniform(2.0, 10.0, n), theta0=rng.uniform(1e-3, math.pi - 1e-3, n),
    )


@pytest.mark.parametrize("spin", [0.0, 0.5, 0.9, 0.998])
def test_ensemble_scores_match_jax(spin):
    """separatrix_score, launch_turning_scores and chaos_weight against JAX
    on constants from a seed (a few of them near the separatrix): values
    rtol 1e-10 (measured 6e-15 at worst, torch.logspace against
    jnp.logspace), the spin gradient of the summed weight by autograd
    against jax.grad rtol 1e-9 (measured 4e-14)."""
    import jax
    import jax.numpy as jnp

    from raytrace_tpu.ops import diff as jdiff

    c = _constants()
    tc = {k: torch.from_numpy(v) for k, v in c.items()}
    jc = {k: jnp.asarray(v) for k, v in c.items()}

    def port(s):
        sep = diff.separatrix_score(tc["k"], tc["h"], tc["Q"], s)
        launch = diff.launch_turning_scores(tc["r0"], tc["theta0"], tc["k"], tc["h"], tc["Q"], s)
        return sep, launch, diff.chaos_weight(sep, launch)

    def ref(s):
        sep = jdiff.separatrix_score(jc["k"], jc["h"], jc["Q"], s)
        launch = jdiff.launch_turning_scores(jc["r0"], jc["theta0"], jc["k"], jc["h"], jc["Q"], s)
        return sep, launch, jdiff.chaos_weight(sep, launch)

    sep, launch, w = port(spin)
    jsep, jlaunch, jw = ref(spin)
    for a, b in ((sep, jsep), (launch[0], jlaunch[0]), (launch[1], jlaunch[1]), (w, jw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-14)
    assert (np.abs(np.asarray(jsep)) < 0.05).any()  # the weight's cut-off is exercised
    x = _t(spin, grad=True)
    port(x)[2].sum().backward()
    np.testing.assert_allclose(float(x.grad), float(jax.grad(lambda s: ref(s)[2].sum())(spin)),
                               rtol=1e-9)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    """The entry points that build their own rays run on the card by
    default and raise without one, through apps.require_device; they never
    carry on on the CPU by themselves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pgrid = PointSourceGrid.from_steps(0.9, 0.9, -0.9, 0.9, -3.0, 3.0)
    igrid = ImagePlaneGrid.from_steps(-3.0, 3.0, 3.0, -3.0, 3.0, 3.0)
    calls = [
        lambda **kw: diff.emissivity_gradient_pipeline(0.9, 5.0, 2.0, pgrid, n_steps=2, **kw),
        lambda **kw: diff.emissivity_binned_profile(0.9, 5.0, 2.0, pgrid, n_steps=2, **kw),
        lambda **kw: diff.line_profile_observable(0.9, 55.0, igrid, n_steps=2, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        out = call(device="cpu")
        out = out[0] if isinstance(out, tuple) else out
        assert out.device.type == "cpu"


class _EagerGraph:
    """Stand-in for a captured CUDA graph on the CPU: each replay runs the
    captured function again."""

    def __init__(self, fn):
        self.replay = fn


def _forward_march(spin, h, method, n_steps, device="cpu"):
    """trace_scan of a lamppost batch with tangents on spin and h
    (torch.autograd.forward_ad); returns every field's value and tangent."""
    grid = PointSourceGrid.from_steps(0.3, 0.3, -0.9, 0.9, -3.0, 3.0)
    with fwad.dual_level():
        s = fwad.make_dual(torch.tensor(spin, dtype=F64, device=device),
                           torch.tensor(1.0, dtype=F64, device=device))
        hh = fwad.make_dual(torch.tensor(h, dtype=F64, device=device),
                            torch.tensor(0.5, dtype=F64, device=device))
        cosalpha, beta, dead = grid_angles(grid, device=device)
        rays = point_source_from_angles((0.0, hh, 1e-3, 0.0), 0.0, s, cosalpha, beta, dead)
        out = diff.trace_scan(rays, s, method=method, r_max=500.0, n_steps=n_steps)
        res = {}
        for f in out.__dataclass_fields__:
            value, tangent = fwad.unpack_dual(getattr(out, f))
            res[f] = (value.clone(), None if tangent is None else tangent.clone())
        return res


def _same_march(a, b):
    """Every field's value and tangent equal bit for bit (no tangent equal
    to a zero one)."""
    for f, (va, ta) in a.items():
        vb, tb = b[f]
        assert torch.equal(va, vb), f
        if va.is_floating_point():
            za = torch.zeros_like(va) if ta is None else ta
            zb = torch.zeros_like(vb) if tb is None else tb
            assert torch.equal(za, zb), f


@pytest.mark.parametrize("method", ["rk4", "rk45"])
def test_replayed_march_matches_eager_in_forward_mode(monkeypatch, method):
    """The unrecorded march's replay path (diff._replayed: first iteration
    eager, then replays of one captured iteration that updates the carry in
    place), run on the CPU with an eager stand-in for the CUDA graph, gives
    the eager march's values and forward-mode tangents bit for bit: every
    float input gets a tangent before the capture, so the in-place copies
    carry each one's tangent from iteration to iteration. The card's own
    graph is held to the eager march by the cuda test below."""
    from raytrace_tpu_torch.ops import integrate

    eager = _forward_march(0.9, 5.0, method, 160)
    monkeypatch.setattr(diff, "_replay_graphs", lambda rays: True)
    monkeypatch.setattr(integrate, "_graph", _EagerGraph)
    replayed = _forward_march(0.9, 5.0, method, 160)
    _same_march(eager, replayed)
    assert replayed["r"][1].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["rk4", "rk45"])
def test_graph_replayed_march_matches_eager_on_cuda(monkeypatch, method):
    """On the card, trace_scan with nothing recorded replays a captured CUDA
    graph: its values and forward-mode tangents equal the eager march's
    (integrate._CUDA_GRAPHS off) bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU version")
    from raytrace_tpu_torch.ops import integrate

    replayed = _forward_march(0.9, 5.0, method, 400, device="cuda")
    monkeypatch.setattr(integrate, "_CUDA_GRAPHS", False)
    _same_march(_forward_march(0.9, 5.0, method, 400, device="cuda"), replayed)
