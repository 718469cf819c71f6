"""The port's Kerr geometry, tetrads and disc areas against the JAX package.

Same formulas in the same op order, in f64: agreement to rtol 1e-12 (sin,
cos, sqrt and pow of the two libraries may differ by an ulp).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import raytrace_tpu.destinations as jdest  # noqa: E402
import raytrace_tpu.geometry.disc as jdisc  # noqa: E402
import raytrace_tpu.geometry.gramschmidt as jgs  # noqa: E402
import raytrace_tpu.geometry.kerr as jk  # noqa: E402
import raytrace_tpu_torch.destinations as pdest  # noqa: E402
import raytrace_tpu_torch.geometry.disc as pdisc  # noqa: E402
import raytrace_tpu_torch.geometry.gramschmidt as pgs  # noqa: E402
import raytrace_tpu_torch.geometry.kerr as pk  # noqa: E402

RTOL = 1e-12
SPINS = [0.0, 0.5, 0.9, 0.998]


def _close(port, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


def _pair(x):
    return torch.from_numpy(x), jnp.asarray(x)


@pytest.fixture(scope="module")
def points():
    """Off-axis points outside the horizon and photon constants, from a seed."""
    rng = np.random.default_rng(20)
    n = 512
    return dict(
        r=rng.uniform(2.2, 60.0, n),
        theta=rng.uniform(0.05, np.pi - 0.05, n),
        phi=rng.uniform(-np.pi, np.pi, n),
        k=np.ones(n),
        h=rng.uniform(-4.0, 4.0, n),
        Q=rng.uniform(0.0, 30.0, n),
        rs=np.where(rng.random(n) < 0.5, -1.0, 1.0),
        ts=np.where(rng.random(n) < 0.5, -1.0, 1.0),
        alpha=rng.uniform(0.05, np.pi - 0.05, n),
        beta=rng.uniform(-np.pi, np.pi, n),
    )


@pytest.mark.parametrize("a", SPINS)
def test_scalar_radii(a):
    _close(pk.horizon_radius(a), jk.horizon_radius(a))
    _close(pk.isco_radius(a), jk.isco_radius(a))
    _close(pk.isco_radius(a, -1), jk.isco_radius(a, -1))
    _close(pk.horizon_radius(torch.tensor(a, dtype=torch.float64)), jk.horizon_radius(a))


@pytest.mark.parametrize("a", SPINS)
def test_geodesic_rates(points, a):
    args = [points[k] for k in ("r", "theta", "k", "h", "Q", "rs", "ts")]
    port = pk.geodesic_rates(*(torch.from_numpy(x) for x in args), a)
    ref = jk.geodesic_rates(*(jnp.asarray(x) for x in args), a)
    for field in ref._fields:
        _close(getattr(port, field), getattr(ref, field))


@pytest.mark.parametrize("a", SPINS)
def test_metric_tetrad_and_frame_maps(points, a):
    (r, jr), (th, jth), (ph, jph) = (_pair(points[k]) for k in ("r", "theta", "phi"))
    g, jg = pk.metric_coeffs(r, th, a), jk.metric_coeffs(jr, jth, a)
    for field in jg._fields:
        _close(getattr(g, field), getattr(jg, field))
    V = 0.3 * pk.keplerian_omega(r, a)
    _close(V, 0.3 * jk.keplerian_omega(jr, a))
    tet, jtet = pk.orbit_tetrad(r, th, a, V, g), jk.orbit_tetrad(jr, jth, a, jnp.asarray(V.numpy()), jg)
    for leg in jtet._fields:
        for c, jc in zip(getattr(tet, leg), getattr(jtet, leg)):
            _close(c, jc, atol=1e-300)
    _close(pk.metric_dot(g, tet.et, tet.ephi), jk.metric_dot(jg, jtet.et, jtet.ephi), atol=1e-14)
    for c, jc in zip(pk.bl_to_cartesian(r, th, ph, a), jk.bl_to_cartesian(jr, jth, jph, a)):
        _close(c, jc)
    u, ju = (pdest._keplerian_four_velocity(r, th, a),
             jdest._keplerian_four_velocity(jr, jth, a))
    for c, jc in zip(u, ju):
        _close(c, jc, atol=1e-300)


@pytest.mark.parametrize("a", SPINS)
@pytest.mark.parametrize("V", [0.0, 0.02])
def test_constants_from_angles(points, a, V):
    (r, jr), (th, jth), (al, jal), (be, jbe) = (
        _pair(points[k]) for k in ("r", "theta", "alpha", "beta"))
    port = pk.constants_from_angles(r, th, al, be, V, a)
    ref = jk.constants_from_angles(jr, jth, jal, jbe, V, a)
    for field in ("k", "h", "rdot_sign", "thetadot_sign"):
        _close(getattr(port, field), getattr(ref, field))
    # Q is a difference of O(r^4) terms: compare on its own scale
    scale = np.nanmax(np.abs(np.asarray(ref.Q)))
    _close(port.Q, ref.Q, atol=RTOL * scale)


@pytest.mark.parametrize("a", SPINS)
def test_gram_schmidt_tetrad_of_plunge_flow(a):
    r_isco = float(jk.isco_radius(a))
    r_h = float(jk.horizon_radius(a))
    # u^r is a square root of a cancellation that vanishes at the ISCO, so
    # stay clear of it (there both packages carry only sqrt(eps) of u^r)
    r_np = np.linspace(r_h + 0.05 * (r_isco - r_h), r_h + 0.9 * (r_isco - r_h), 40)
    r, jr = _pair(r_np)
    th, jth = _pair(np.full_like(r_np, np.pi / 2))
    u, ju = pdisc.plunge_velocity(r, a), jdisc.plunge_velocity(jr, a)
    for c, jc in zip(u, ju):
        _close(c, jc, atol=1e-12)
    tet = pgs.gram_schmidt_tetrad(r, th, u, a)
    jtet = jgs.gram_schmidt_tetrad(jr, jth, ju, a)
    for leg in jtet._fields:
        for c, jc in zip(getattr(tet, leg), getattr(jtet, leg)):
            _close(c, jc, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("a", SPINS)
@pytest.mark.parametrize("logbin", [True, False])
def test_integrate_disc_area_bins(a, logbin):
    """Bins straddling the ISCO exercise both the Keplerian and the plunge frame."""
    r_h = float(jk.horizon_radius(a))
    edges = np.geomspace(r_h * 1.01, 500.0, 31)
    lo, hi = edges[:-1], edges[1:]
    port = pdisc.integrate_disc_area_bins(torch.from_numpy(lo), torch.from_numpy(hi), a,
                                          logbin=logbin)
    ref = jdisc.integrate_disc_area_bins(jnp.asarray(lo), jnp.asarray(hi), a, logbin=logbin)
    _close(port, ref, rtol=1e-11)
    kep = pdisc.integrate_disc_area_bins(torch.from_numpy(lo), torch.from_numpy(hi), a,
                                         force_keplerian=True)
    jkep = jdisc.integrate_disc_area_bins(jnp.asarray(lo), jnp.asarray(hi), a,
                                          force_keplerian=True)
    _close(kep, jkep, rtol=1e-11)


def test_theta_limit_destination(points):
    (r, _), (th, jth) = _pair(points["r"]), _pair(points["theta"])
    pth_np = np.random.default_rng(3).standard_normal(th.shape[0])
    pth, jpth = _pair(pth_np)
    for tl in (np.pi / 2, -1.2, 0.0):
        d, jd = pdest.ThetaLimit(tl), jdest.ThetaLimit(tl)
        np.testing.assert_array_equal(d.reached(r, th, th, th).numpy(),
                                      np.asarray(jd.reached(None, jth, None, None)))
        _close(d.step_limit(r, th, th, pth, pth, pth), jd.step_limit(None, jth, None, None, jpth, None))
    assert pdest.FlatDisc is pdest.ThetaLimit
