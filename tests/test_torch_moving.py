"""The port's moving sources, the Kerr additions they stand on, the
radially moving redshift observer and the RadialVelocityField route,
against the JAX package.

Configuration of tests/test_capabilities.py::TestMovingSources: spin 0.9,
sources at r = 5 (jets) and r = 6 (orbits), the direction grid
PointSourceGrid.from_steps(0.25, 0.5, -0.9, 0.9, -3, 3) (8 x 13 rays).
Everything is float64 on the CPU, where both packages compute the same
formulas in the same order: the gates are 1e-12, relative to each field's
scale.

The JAX package is imported inside the tests that use it, so that the card
tests run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_moving.py
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch import geometry as pg  # noqa: E402
from raytrace_tpu_torch import ops  # noqa: E402
from raytrace_tpu_torch.destinations import (  # noqa: E402
    DiscWithISCO,
    FlatPlane,
    RadialVelocityField,
    SphericalShell,
    ThetaLimit,
)
from raytrace_tpu_torch.ops import march_kernel, trace, trace_auto  # noqa: E402
from raytrace_tpu_torch.sources import (  # noqa: E402
    PointSourceGrid,
    jet_point_source,
    point_source,
    point_source_vel,
)

SPIN = 0.9
TOL = 1e-12
FIELDS = ("k", "h", "Q", "rdot_sign", "thetadot_sign", "alpha", "beta", "steps",
          "t", "r", "theta", "phi")


def _grid():
    return PointSourceGrid.from_steps(0.25, 0.5, -0.9, 0.9, -3.0, 3.0)


def _jgrid():
    from raytrace_tpu.sources import PointSourceGrid as JGrid

    return JGrid.from_steps(0.25, 0.5, -0.9, 0.9, -3.0, 3.0)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _close(mine, ref, what, tol=TOL):
    mine = mine.numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    ref = np.asarray(ref)
    scale = max(float(np.nanmax(np.abs(ref))), 1.0) if ref.size else 1.0
    np.testing.assert_allclose(mine, ref, rtol=0, atol=tol * scale, err_msg=what)


def _probe_points():
    rng = np.random.default_rng(7)
    r = rng.uniform(2.5, 40.0, 64)
    theta = rng.uniform(0.05, math.pi - 0.05, 64)
    return r, theta, rng


def test_constants_from_frame_and_p_match_jax():
    """constants_from_frame on a Gram-Schmidt frame of random unit
    directions, and constants_from_p on random momenta, to 1e-12."""
    from raytrace_tpu.geometry import kerr as jk
    from raytrace_tpu.geometry.gramschmidt import gram_schmidt_tetrad as jgs

    r, theta, rng = _probe_points()
    u4 = (1.3, 0.2, 0.01, 0.03)
    v = rng.normal(size=(3, 64))
    v /= np.linalg.norm(v, axis=0)
    jt = jgs(r, theta, tuple(np.full(64, c) for c in u4), SPIN)
    pt = pg.gram_schmidt_tetrad(_t(r), _t(theta), tuple(_t(np.full(64, c)) for c in u4), SPIN)
    a = pg.constants_from_frame(_t(r), _t(theta), pt, *(_t(x) for x in v), SPIN, 1.5)
    b = jk.constants_from_frame(r, theta, jt, *v, SPIN, 1.5)
    for f in a._fields:
        _close(getattr(a, f), getattr(b, f), f)

    p = rng.normal(size=(4, 64))
    a = pg.constants_from_p(_t(r), _t(theta), *(_t(x) for x in p), SPIN)
    b = jk.constants_from_p(r, theta, *p, SPIN)
    for f in a._fields:
        _close(getattr(a, f), getattr(b, f), f)


@pytest.mark.parametrize("sign", [1, -1])
def test_circular_orbit_velocity_and_lorentz_factor_match_jax(sign):
    from raytrace_tpu.geometry import kerr as jk

    r, theta, _ = _probe_points()
    r = r + 8.0  # outside the retrograde photon orbit
    (ut, ur, uth, uph), om = pg.circular_orbit_velocity(_t(r), SPIN, sign)
    (jut, jur, juth, juph), jom = jk.circular_orbit_velocity(r, SPIN, sign)
    for a, b, f in ((ut, jut, "ut"), (ur, jur, "ur"), (uth, juth, "uth"), (uph, juph, "uph"),
                    (om, jom, "Omega")):
        _close(a, b, f)
    eq = np.full_like(r, math.pi / 2)
    gam, vel = pg.lorentz_factor(_t(r), _t(eq), (ut, ur, uth, uph), SPIN)
    jgam, jvel = jk.lorentz_factor(r, eq, (jut, jur, juth, juph), SPIN)
    _close(gam, jgam, "gamma")
    for a, b in zip(vel, jvel):
        _close(a, b, "v")
    assert (gam.numpy() >= 1.0).all()


def _jax_source(kind):
    import jax.numpy as jnp
    from raytrace_tpu.geometry.disc import plunge_velocity
    from raytrace_tpu.sources import jet_point_source as jjet
    from raytrace_tpu.sources import point_source_vel as jvel

    if kind == "jet":
        return jjet((0.0, 5.0, 1e-3, 0.0), 0.5, SPIN, _jgrid())
    if kind == "vel":
        return jvel((0.0, 5.0, 1.0, 0.3), (1.4, 0.1, 0.02, 0.05), SPIN, _jgrid())
    pos = (0.0, 1.7, math.pi / 2 - 1e-3, 0.0)
    return jvel(pos, plunge_velocity(jnp.asarray(1.7), SPIN), SPIN, _jgrid())


def _port_source(kind):
    if kind == "jet":
        return jet_point_source((0.0, 5.0, 1e-3, 0.0), 0.5, SPIN, _grid(), device="cpu")
    if kind == "vel":
        return point_source_vel((0.0, 5.0, 1.0, 0.3), (1.4, 0.1, 0.02, 0.05), SPIN, _grid(),
                                device="cpu")
    u4 = pg.plunge_velocity(torch.tensor(1.7, dtype=torch.float64), SPIN)
    return point_source_vel((0.0, 1.7, math.pi / 2 - 1e-3, 0.0), u4, SPIN, _grid(), device="cpu")


@pytest.mark.parametrize("kind", ["jet", "vel", "plunge"])
def test_moving_sources_match_jax(kind):
    """Jet (v = 0.5 at r = 5), arbitrary 4-velocity and ISCO-plunge sources,
    field by field, to 1e-12 of each field's scale."""
    a, b = _port_source(kind), _jax_source(kind)
    assert a.r.dtype == torch.float64
    for f in FIELDS:
        _close(getattr(a, f), getattr(b, f), f"{kind} {f}")


def test_jet_rays_are_null():
    """tests/test_capabilities.py:43: g(p, p) / pt^2 vanishes to 1e-12."""
    rays = jet_point_source((0.0, 5.0, 1e-3, 0.0), 0.5, SPIN, _grid(), device="cpu")
    p = pg.momentum_from_consts(rays.r, rays.theta, rays.k, rays.h, rays.Q, rays.rdot_sign,
                                rays.thetadot_sign, SPIN)
    g = pg.metric_coeffs(rays.r, rays.theta, SPIN)
    norm = pg.metric_dot(g, p, p) / (p[0] * p[0])
    assert norm.abs().max() < 1e-12


def test_vel_source_reduces_to_orbit_source():
    """tests/test_capabilities.py:53-64: a source moving on the circular
    orbit's 4-velocity gives the orbiting lamppost's constants (rtol 1e-8,
    atol 1e-10, the gates there)."""
    u4, V = pg.circular_orbit_velocity(torch.tensor(6.0, dtype=torch.float64), SPIN)
    pos = (0.0, 6.0, math.pi / 2 - 1e-3, 0.0)
    pv = point_source_vel(pos, u4, SPIN, _grid(), device="cpu")
    ps = point_source(pos, float(V), SPIN, _grid(), device="cpu")
    live = ps.steps == 0
    for f in ("k", "h", "Q", "rdot_sign", "thetadot_sign"):
        torch.testing.assert_close(getattr(pv, f)[live], getattr(ps, f)[live], rtol=1e-8,
                                   atol=1e-10, msg=f)


def test_jet_beaming_boosts_forward_energy():
    """tests/test_capabilities.py:66-77: forward over backward Killing
    energy near the Doppler factor (1 + v) / (1 - v) = 4."""
    rays = jet_point_source((0.0, 50.0, 1e-3, 0.0), 0.6, SPIN, _grid(), device="cpu")
    live = rays.steps == 0
    cosa, k = rays.alpha[live], rays.k[live]
    assert 3.0 < float(k[cosa > 0.8].mean() / k[cosa < -0.8].mean()) < 4.5


def _marched_pair(projradius):
    """The same lamppost batch through both packages' redshift_start (the
    port's batch rebuilt from JAX's source state, bit for bit), then JAX's
    traced batch and the port's copy of it."""
    from raytrace_tpu.ops import trace as jtrace
    from raytrace_tpu.ops.redshift import redshift_start as jstart
    from raytrace_tpu.sources import point_source as jps

    from raytrace_tpu_torch.ops.redshift import redshift_start
    from raytrace_tpu_torch.rays import from_numpy

    numpy_batch = lambda b: {f: np.asarray(getattr(b, f)) for f in b.__dataclass_fields__}
    j = jps((0.0, 5.0, 0.4, 0.0), 0.0, SPIN, _jgrid())
    p_start = redshift_start(from_numpy(numpy_batch(j), device="cpu"), SPIN, V=-1.0,
                             projradius=projradius)
    j = jstart(j, SPIN, V=-1.0, projradius=projradius)
    j = jtrace(j, SPIN, method="rk4", r_max=60.0, steplim=3000)
    return j, from_numpy(numpy_batch(j), device="cpu"), p_start


@pytest.mark.parametrize("kw", [dict(projradius=True), dict(motion=1, V=0.3),
                                dict(motion=1, V=-0.5), dict(projradius=True, reverse=True),
                                dict(motion=1, V=-0.2, reverse=True)])
def test_projradius_and_radial_motion_redshifts_match_jax(kw):
    """redshift_start with projradius, and ray_redshift / apply_redshift
    with projradius and with the radially moving receiver (motion = 1,
    V > 0 a coordinate speed, V < 0 a fraction of the local light speed),
    forward and reversed, to 1e-12 relative."""
    from raytrace_tpu.ops.redshift import apply_redshift as japply
    from raytrace_tpu.ops.redshift import ray_redshift as jray

    from raytrace_tpu_torch.ops.redshift import apply_redshift, ray_redshift

    j, p, p_start = _marched_pair(kw.get("projradius", False))
    live = torch.as_tensor(np.asarray(j.steps) != -1)
    _close(p_start.emit[live], np.asarray(j.emit)[live.numpy()], "emit")
    kw = dict(kw)
    V = kw.pop("V", -1.0)
    a = ray_redshift(p, SPIN, V, **kw)
    b = jray(j, SPIN, V, **kw)
    ok = np.isfinite(np.asarray(b))
    assert ok.sum() > 50
    _close(a[torch.as_tensor(ok)], np.asarray(b)[ok], "redshift")
    _close(apply_redshift(p, SPIN, V, **kw).redshift[torch.as_tensor(ok)],
           np.asarray(japply(j, SPIN, V, **kw).redshift)[ok], "apply_redshift")


@pytest.mark.parametrize("v", [0.3, -0.5])
def test_radial_velocity_field_matches_jax(v):
    """RadialVelocityField's 4-velocity (the reference's ``spin + spin``
    scaling for v < 0 kept) and the destination redshift against it."""
    import jax.numpy as jnp
    from raytrace_tpu.destinations import RadialVelocityField as JField

    r, theta, _ = _probe_points()
    a = RadialVelocityField(v).four_velocity(_t(r), _t(theta), _t(theta), SPIN)
    b = JField(v=jnp.asarray(v)).four_velocity(r, theta, theta, SPIN)
    for x, y, f in zip(a, b, ("ut", "ur", "uth", "uph")):
        _close(x, y, f)
    assert not RadialVelocityField(v).reached(_t(r), _t(theta), _t(theta), _t(theta)).any()


def test_trace_auto_routes_by_destination_type():
    """The kernel takes euler / rk4 / rk45 towards ThetaLimit (the default),
    DiscWithISCO, FlatPlane and SphericalShell; RadialVelocityField, which
    never stops a ray, is not among them, as JAX's pallas_supported."""
    for method in ("euler", "rk4", "rk45"):
        assert ops.kernel_supported(method)
        for dest in (ThetaLimit(), DiscWithISCO(1.2), FlatPlane(0.5), SphericalShell(40.0)):
            assert ops.kernel_supported(method, dest)
        assert not ops.kernel_supported(method, RadialVelocityField(0.3))
    assert not ops.kernel_supported("dopri")


def test_radial_velocity_field_marches_on_the_plain_route():
    """trace_auto with RadialVelocityField runs the plain march (counted in
    ``ops.routes``), equal to ``trace``; no ray stops on the destination,
    so every live ray ends at the horizon or r_max, and the kernel is not
    launched."""
    rays = jet_point_source((0.0, 5.0, 1e-3, 0.0), 0.3, SPIN, _grid(), device="cpu")
    dest = RadialVelocityField(0.3)
    before, plain = march_kernel.launches, ops.routes["plain"]
    a = trace_auto(rays, SPIN, method="rk4", dest=dest, r_max=60.0, steplim=3000)
    assert ops.routes["plain"] == plain + 1 and march_kernel.launches == before
    b = trace(rays, SPIN, method="rk4", dest=dest, r_max=60.0, steplim=3000)
    for f in ("r", "theta", "steps", "status"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    live = rays.steps == 0
    assert ((a.status[live] & (2 | 4)) != 0).all() and ((a.status & 1) == 0).all()


@pytest.mark.cuda
def test_radial_velocity_field_stays_on_cuda_without_a_launch():
    """On the card trace_auto marches a RadialVelocityField batch with the
    plain march on the card, in the batch's dtype: no kernel launch, the
    result on cuda and equal to ``trace`` there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the route under test is the card's")
    rays = jet_point_source((0.0, 5.0, 1e-3, 0.0), 0.3, SPIN, _grid(), device="cuda")
    dest = RadialVelocityField(0.3)
    before, plain = march_kernel.launches, ops.routes["plain"]
    a = trace_auto(rays, SPIN, method="rk45", dest=dest, r_max=60.0, steplim=3000)
    torch.cuda.synchronize()
    assert march_kernel.launches == before and ops.routes["plain"] == plain + 1
    assert a.r.is_cuda and a.r.dtype == torch.float64
    b = trace(rays, SPIN, method="rk45", dest=dest, r_max=60.0, steplim=3000)
    assert torch.equal(a.r, b.r) and torch.equal(a.status, b.status)
