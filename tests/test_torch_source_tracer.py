"""The port's wind radiative transfer (ops/source_tracer.py) against the JAX
package.

``run_source_trace`` runs at the CLI sweep's outflow sizes
(tests/test_cli_sweep.py:290-295): an 8 x 8 image plane at dist 200, incl
60, spin 0.9 marched backwards with -spin, the wind v0 0.2 in 10 < r < 50,
40 log energy bins from 0.5 to 2, the source sphere r < 2, steplim 4000,
Euler (the default) and RK4, float64 on the CPU. No image-plane ray of
this grid sits on a knife edge, and the two packages agree to rounding.

The JAX package is imported inside the tests that use it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.ops import source_tracer as port_st  # noqa: E402
from raytrace_tpu_torch.ops.redshift import redshift_start  # noqa: E402
from raytrace_tpu_torch.rays import RAY_STATUS_DEST  # noqa: E402
from raytrace_tpu_torch.sources import ImagePlaneGrid, image_plane  # noqa: E402

SPIN, DIST, INCL = 0.9, 200.0, 60.0
PLANE = dict(nx=8, ny=8, x0=-40.0, y0=-40.0, dx=80.0 / 7, dy=80.0 / 7)
# a close-in plane whose central rays run into the source sphere
NEAR = dict(nx=6, ny=6, x0=-6.0, y0=-6.0, dx=2.4, dy=2.4)
BINS = dict(en0=0.5, en_max=2.0, n_en=40, n_t=4, t0=0.0, dt=200.0)


def _jax_run(method, plane):
    from raytrace_tpu.ops import source_tracer as jst
    from raytrace_tpu.ops.redshift import redshift_start as jrs
    from raytrace_tpu.sources import ImagePlaneGrid as JGrid
    from raytrace_tpu.sources import image_plane as jip

    rays = jrs(jip(DIST, INCL, JGrid(**plane), SPIN), -SPIN, V=0.0, reverse=True)
    out = jst.run_source_trace(rays, -SPIN, jst.WindModel(v0=0.2), jst.EnergyTimeBins(**BINS),
                               stop=jst.SphericalStop(2.0), method=method, r_lim=1.5 * DIST,
                               steplim=4000)
    return [np.asarray(out[0].status), np.asarray(out[0].steps)] + [np.asarray(o)
                                                                     for o in out[1:]]


def _port_run(method, plane):
    rays = image_plane(DIST, INCL, ImagePlaneGrid(**plane), SPIN, device="cpu")
    rays = redshift_start(rays, -SPIN, V=0.0, reverse=True)
    out = port_st.run_source_trace(rays, -SPIN, port_st.WindModel(v0=0.2),
                                   port_st.EnergyTimeBins(**BINS), stop=port_st.SphericalStop(2.0),
                                   method=method, r_lim=1.5 * DIST, steplim=4000)
    return [out[0].status.numpy(), out[0].steps.numpy()] + [o.numpy() for o in out[1:]]


@pytest.mark.parametrize("method, plane", [("euler", PLANE), ("rk4", PLANE), ("euler", NEAR)])
def test_run_source_trace_matches_jax(method, plane):
    """Final statuses and steps equal on every ray (on the close-in plane
    the SphericalStop status of the rays that run into the source sphere
    among them); per-ray emis and absorb and the (energy, time) response:
    the same bins populated, each value to rtol 1e-10 (measured 8e-14)."""
    a, b = _jax_run(method, plane), _port_run(method, plane)
    np.testing.assert_array_equal(b[0], a[0])
    np.testing.assert_array_equal(b[1], a[1])
    stopped = ((b[0] & RAY_STATUS_DEST) != 0) & (b[1] > 0)
    if plane is NEAR:
        assert 0 < stopped.sum() < len(b[0])
    n = plane["nx"] * plane["ny"]
    for x, y, shape in zip(b[2:], a[2:], [(n, 40), (n, 40), (40, 4)]):
        assert x.shape == y.shape == shape
        np.testing.assert_array_equal(x != 0, y != 0)
        np.testing.assert_allclose(x, y, rtol=1e-10, atol=0.0)
    assert (b[2].sum(axis=1) > 0).sum() > 10 and b[4].sum() > 0


def test_max_iters_leaves_rays_active():
    """A caller's max_iters bounds the march: at 50 iterations no ray has
    taken more than 50 steps and rays are still active."""
    rays = image_plane(DIST, INCL, ImagePlaneGrid(**PLANE), SPIN, device="cpu")
    rays = redshift_start(rays, -SPIN, V=0.0, reverse=True)
    final, *_ = port_st.run_source_trace(rays, -SPIN, port_st.WindModel(v0=0.2),
                                         port_st.EnergyTimeBins(**BINS), max_iters=50,
                                         r_lim=1.5 * DIST, steplim=4000)
    assert int(final.steps.max()) <= 50 and bool(final.active.any())


def test_march_counts_its_iterations():
    """The march loop counts the iterations it runs: exactly max_iters when
    rays are left active, and on a run to the end the longest ray's steps
    rounded up to the loop's exit test (every _CHECK_EVERY iterations)."""
    from raytrace_tpu_torch.ops import integrate

    rays = image_plane(DIST, INCL, ImagePlaneGrid(**PLANE), SPIN, device="cpu")
    rays = redshift_start(rays, -SPIN, V=0.0, reverse=True)
    args = (-SPIN, port_st.WindModel(v0=0.2), port_st.EnergyTimeBins(**BINS))
    integrate.iterations = 0
    port_st.run_source_trace(rays, *args, max_iters=50, r_lim=1.5 * DIST, steplim=4000)
    assert integrate.iterations == 50
    integrate.iterations = 0
    final, *_ = port_st.run_source_trace(rays, *args, r_lim=1.5 * DIST, steplim=4000)
    longest = int(final.steps.abs().max())
    every = integrate._CHECK_EVERY
    assert integrate.iterations == -(-longest // every) * every


def test_energy_bins_match_jax():
    """EnergyTimeBins: energies and bin indices (log and linear) equal to
    JAX's on 5,000 random energies spanning the grid."""
    import jax.numpy as jnp

    from raytrace_tpu.ops import source_tracer as jst

    e = np.random.default_rng(5).uniform(0.3, 12.0, 5000)
    for logbin in (True, False):
        kw = dict(en0=0.5, en_max=10.0, n_en=57, logbin_en=logbin)
        jb, pb = jst.EnergyTimeBins(**kw), port_st.EnergyTimeBins(**kw)
        np.testing.assert_array_equal(pb.energies(), jb.energies())
        np.testing.assert_array_equal(pb.energy_index(torch.tensor(e)).numpy(),
                                      np.asarray(jb.energy_index(jnp.asarray(e))))


@pytest.mark.cuda
def test_run_source_trace_on_the_card_matches_cpu():
    """On the card (CUDA-graph epochs, atomic additions into the response):
    statuses, steps equal; emis and absorb to rtol 1e-12, the response to
    rtol 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from raytrace_tpu_torch.rays import to_numpy

    rays = image_plane(DIST, INCL, ImagePlaneGrid(**PLANE), SPIN, device="cpu")
    rays = redshift_start(rays, -SPIN, V=0.0, reverse=True)
    args = (-SPIN, port_st.WindModel(v0=0.2), port_st.EnergyTimeBins(**BINS))
    kw = dict(stop=port_st.SphericalStop(2.0), r_lim=1.5 * DIST, steplim=4000)
    c = port_st.run_source_trace(rays, *args, **kw)
    g = port_st.run_source_trace(rays.to(device="cuda"), *args, **kw)
    for f in ("status", "steps"):
        np.testing.assert_array_equal(to_numpy(g[0])[f], to_numpy(c[0])[f])
    for x, y, rtol in zip(g[1:], c[1:], (1e-12, 1e-12, 1e-9)):
        np.testing.assert_allclose(x.cpu().numpy(), y.numpy(), rtol=rtol, atol=0.0)
