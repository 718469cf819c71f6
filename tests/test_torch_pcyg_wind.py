"""The port's flat-space P-Cygni model (apps/pcyg.py) and Sobolev wind
profiles (apps/sobolev_wind.py) against the JAX package, and pcyg against
the reference binary's golden.

pcyg is compared on grids whose sightlines avoid the knife edges: no grid
point (x, y) of the default 60 x 60 grid has x^2 + y^2 = r_star^2 exactly
once r_min = r_star = 4.9. At r_star = 5 eight sightlines (the 3-4-5
points) sit exactly on the stellar limb, and XLA's CPU build contracts
x*x + y*y into a fused multiply-add there, so the JAX function moves them
across the limb: measured at nx = 60, n_en = 100, dz = 0.05, 34 of 100
emission bins differ by up to 12.9% and every continuum bin by up to 1.25%.
The port rounds as the reference binary does and meets TestPcyg's golden
gates with a wide margin (median 1.1e-9, p99 4.3e-4, max 7.0e-4; continuum
1.1e-4).

The JAX package is imported inside the tests that use it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.apps import pcyg as port_pcyg  # noqa: E402
from raytrace_tpu_torch.apps import sobolev_wind as port_sw  # noqa: E402

PCYG_SMALL = dict(nx=60, n_en=100, dz=0.05, r_min=4.9, r_star=4.9)


def _jax_pcyg(**kw):
    from raytrace_tpu.apps.pcyg import compute

    return [np.asarray(o) for o in compute(**kw)]


def _port_pcyg(**kw):
    return [o.numpy() for o in port_pcyg.compute(**kw, device="cpu")]


@pytest.mark.parametrize("kw, flips", [
    (PCYG_SMALL, 1),
    (dict(PCYG_SMALL, logbin_en=True, tau=3.0), 1),
    (dict(PCYG_SMALL, r_sph=9.9), 0),
])
def test_pcyg_matches_jax(kw, flips):
    """Energy grid exact (linear bins; log bins to 1e-15, the bin ratio
    comes from another exp/log); obs_emis and obs_continuum to rtol 1e-10
    on every bin but ``flips`` emission bins (measured: one bin, 3.4e-5,
    fed by the sightline sample at r = r_sph = 10 exactly, none at r_sph =
    9.9); obs_total to rtol 1e-9 (normalised by the emission's sum, which
    that bin moves: measured 4.7e-11)."""
    a, b = _jax_pcyg(**kw), _port_pcyg(**kw)
    if kw.get("logbin_en"):
        np.testing.assert_allclose(b[0], a[0], rtol=1e-15)
    else:
        np.testing.assert_array_equal(b[0], a[0])

    def rel(i):  # empty bins must be empty in both
        assert ((a[i] == 0) == (b[i] == 0)).all()
        nz = a[i] != 0
        return np.abs(b[i][nz] - a[i][nz]) / np.abs(a[i][nz])

    assert a[1].sum() > 0 and a[2].sum() > 0
    assert (rel(1) > 1e-10).sum() <= flips, rel(1).max()
    assert rel(1).max() < 1e-4
    assert rel(2).max() < 1e-10
    assert rel(3).max() < 1e-9


def test_pcyg_against_reference_binary_golden():
    """tests/test_capabilities.py::TestPcyg's golden and gates, at Nx = 200,
    Nen = 400 and the reference's other hard-coded parameters (rsph 10,
    rmin/rstar 5, V 0.2, dz 0.01, dens0 10, tau 1.5); column 4 is not
    compared (the reference normalises inside its loop)."""
    ref = np.loadtxt("tests/golden/pcyg_nx200_nen400.dat")
    en, emis, cont, _ = _port_pcyg(nx=200, n_en=400)
    np.testing.assert_allclose(en, ref[:, 0], rtol=1e-8)
    nz = ref[:, 1] > 0
    assert ((emis > 0) == nz).all()
    rel = np.abs(emis[nz] / ref[nz, 1] - 1)
    assert np.median(rel) < 1e-6
    assert np.percentile(rel, 99) < 5e-3
    assert rel.max() < 0.05
    relc = np.abs(cont / ref[:, 2] - 1)
    assert relc.max() < 2e-3


@pytest.mark.parametrize("kw, n_z", [(dict(dz=0.5), 40), (dict(dz=0.3), 66), (dict(n_z=7), 7)])
def test_pcyg_counts_its_planes(kw, n_z):
    """Each z-plane adds one to the lock-step iteration count: int(2 r_sph
    / dz) planes in Python floats (2 * 10 / 0.3 = 66.67), or n_z given."""
    from raytrace_tpu_torch.ops import integrate

    integrate.iterations = 0
    _port_pcyg(nx=10, n_en=20, **kw)
    assert integrate.iterations == n_z


def test_pcyg_blue_trough():
    """The P-Cygni shape: continuum absorption blueward (E > 1)."""
    en, em, cont, _ = _port_pcyg(nx=60, n_en=100)
    c = cont / cont.sum()
    assert em.sum() > 0
    assert c[(en > 1.05) & (en < 1.19)].mean() < c[(en > 0.85) & (en < 0.95)].mean()


V41 = np.linspace(-1.5, 1.5, 41)
WIND_CASES = [
    dict(tau_tot=0.5),
    dict(tau_tot=4.0),
    dict(tau_tot=3.0, incl=0.0, wind_angle=0.2),  # narrow cone, pole on
    dict(tau_tot=3.0, incl=0.0, wind_angle=2.0),  # wide cone
    dict(incl=0.7, beta=1.5, turb=0.05, alpha1=0.5, w0=0.05, rout=8.0),
]


@pytest.mark.parametrize("kw", WIND_CASES)
def test_disc_wind_profile_matches_jax(kw):
    """disc_wind_profile at n_p = 80, n_phi = 16 on 41 velocities, rtol
    1e-12 (measured 5e-15), the narrow and wide wind cones of
    tests/test_capabilities.py:315-326 among them."""
    import jax.numpy as jnp

    from raytrace_tpu.apps import sobolev_wind as jsw

    a = np.asarray(jsw.disc_wind_profile(jnp.asarray(V41), jsw.WindParams(**kw), n_p=80,
                                         n_phi=16))
    b = port_sw.disc_wind_profile(torch.tensor(V41), port_sw.WindParams(**kw), n_p=80,
                                  n_phi=16).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-12)


def test_wind_cone_gates_absorption():
    v = torch.tensor(V41)
    narrow = port_sw.disc_wind_profile(v, port_sw.WindParams(tau_tot=3.0, incl=0.0,
                                                             wind_angle=0.2), n_p=80, n_phi=16)
    wide = port_sw.disc_wind_profile(v, port_sw.WindParams(tau_tot=3.0, incl=0.0,
                                                           wind_angle=2.0), n_p=80, n_phi=16)
    assert wide.min() < narrow.min()


def test_pcyg_sei_profile_matches_jax():
    """pcyg_sei_profile on 61 velocities (tau_tot 2, turb 0.05, n_p 80),
    rtol 1e-12 (measured 2.7e-15), and its morphology (TestSobolevWind)."""
    from raytrace_tpu.apps.sobolev_wind import pcyg_sei_profile

    v = np.linspace(-1.5, 1.5, 61)
    a = np.asarray(pcyg_sei_profile(v, tau_tot=2.0, turb=0.05, n_p=80))
    b = port_sw.pcyg_sei_profile(v, tau_tot=2.0, turb=0.05, n_p=80, device="cpu").numpy()
    np.testing.assert_allclose(b, a, rtol=1e-12)
    np.testing.assert_allclose(b[[0, -1]], 1.0, atol=0.05)
    i = b.argmin()
    assert b[i] < 0.6 and -1.1 < v[i] < -0.1
    assert b[np.abs(v).argmin()] > b[i]


@pytest.mark.parametrize("field, value", [
    ("tau_tot", 1.0), ("turb", 0.1), ("beta", 1.0), ("w0", 0.01), ("alpha1", 1.0), ("rout", 10.0),
])
def test_disc_wind_gradient_matches_jax(field, value):
    """d(sum of the profile)/d(field) at incl = 0.7 by torch autograd
    against jax.grad, rtol 1e-8 (measured 3e-14 at worst): the branches
    that torch.where does not take carry NaN or inf, and the gradient must
    follow JAX's. Both are NaN with respect to rout (the square root of
    rout^2 - p^2 at p = rout, the last impact parameter)."""
    import jax
    import jax.numpy as jnp

    from raytrace_tpu.apps import sobolev_wind as jsw

    vj = jnp.asarray(V41)
    g = float(jax.grad(lambda t: jsw.disc_wind_profile(
        vj, jsw.WindParams(**{field: t}, incl=0.7), n_p=80, n_phi=16).sum())(value))
    t = torch.tensor(value, dtype=torch.float64, requires_grad=True)
    port_sw.disc_wind_profile(torch.tensor(V41), port_sw.WindParams(**{field: t}, incl=0.7),
                              n_p=80, n_phi=16).sum().backward()
    if field == "rout":
        assert np.isnan(g) and torch.isnan(t.grad)
        return
    assert np.isfinite(g) and g != 0.0
    np.testing.assert_allclose(float(t.grad), g, rtol=1e-8)


@pytest.mark.cuda
def test_pcyg_and_wind_on_the_card_match_cpu():
    """pcyg on the card (the first z-plane eager, the rest one replayed CUDA
    graph) against the CPU, nx = 60, n_en = 100, dz = 0.05: the same bins
    populated, each to rtol 1e-9; the disc-wind profile to rtol 1e-12."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = _port_pcyg(**PCYG_SMALL)
    b = [o.cpu().numpy() for o in port_pcyg.compute(**PCYG_SMALL, device="cuda")]
    for x, y in zip(b, a):
        np.testing.assert_array_equal(x != 0, y != 0)
        np.testing.assert_allclose(x, y, rtol=1e-9, atol=0.0)
    p = port_sw.WindParams(incl=0.7, tau_tot=2.0)
    c = port_sw.disc_wind_profile(torch.tensor(V41), p, n_p=80, n_phi=16).numpy()
    g = port_sw.disc_wind_profile(torch.tensor(V41, device="cuda"), p, n_p=80, n_phi=16)
    np.testing.assert_allclose(g.cpu().numpy(), c, rtol=1e-12)
