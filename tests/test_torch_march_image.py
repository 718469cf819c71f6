"""The image-plane slice's variants of the march against the JAX package.

DiscWithISCO with rk4 and rk45, and Euler with ThetaLimit, on
backward-traced image-plane rays (dist 500, incl 60, marched with the spin
-0.998): the port's plain lock-step march against JAX ``trace`` in f64, and
against the Pallas TPU kernel ``trace_pallas`` run in interpret mode in f32.
The CUDA kernel's instantiations are held against the plain march on the
card only.

Gates are count-based, as tests/test_native.py:22-36. The JAX package is
imported inside the tests that use it, so that the card test runs where JAX
is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_march_image.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.destinations import DiscWithISCO, ThetaLimit  # noqa: E402
from raytrace_tpu_torch.geometry import isco_radius  # noqa: E402
from raytrace_tpu_torch.ops import march_kernel, trace  # noqa: E402
from raytrace_tpu_torch.rays import from_numpy  # noqa: E402
from raytrace_tpu_torch.sources import ImagePlaneGrid  # noqa: E402
from raytrace_tpu_torch.sources import image_plane as port_image_plane  # noqa: E402

SPIN = 0.998
STEPLIM = 3000
R_DISC = 20.0
# the slice's new kernel variants: (method, destination kind)
NEW_VARIANTS = [("rk4", "isco"), ("rk45", "isco"), ("euler", "theta")]


def _numpy_batch(rays):
    return {f: np.asarray(getattr(rays, f)) for f in rays.__dataclass_fields__}


def _assert_agree(live, a, b, med_dr=1e-10, status_rate=0.99, steps_rate=0.99,
                  relative=False):
    """As tests/test_torch_march.py: statuses equal on > status_rate of live
    rays, step counts on > steps_rate of the equal-status ones, median |dr|
    (or |dr|/r) over them below med_dr."""
    sa, sb = np.asarray(a["status"]), np.asarray(b["status"])
    assert (sa == sb)[live].mean() > status_rate
    same = (sa == sb) & live
    dr = np.abs(np.asarray(a["r"], np.float64) - np.asarray(b["r"], np.float64))[same]
    if relative:
        dr = dr / np.abs(np.asarray(a["r"], np.float64))[same]
    assert np.median(dr) < med_dr
    assert (np.asarray(a["steps"])[same] == np.asarray(b["steps"])[same]).mean() > steps_rate


def _port_dest(kind):
    return DiscWithISCO(isco_radius(SPIN), R_DISC) if kind == "isco" else ThetaLimit()


def _jax_dest(kind):
    from raytrace_tpu import destinations as jd

    return jd.DiscWithISCO(isco_radius(SPIN), R_DISC) if kind == "isco" else jd.ThetaLimit()


def _jax_image_plane(step):
    """JAX image-plane batch (dist 500, incl 60), backward-traced with -SPIN."""
    from raytrace_tpu.sources import ImagePlaneGrid as JGrid
    from raytrace_tpu.sources import image_plane

    return image_plane(500.0, 60.0, JGrid.from_steps(-20.0, 20.0, step, -20.0, 20.0, step), SPIN)


@pytest.fixture(scope="module")
def image_grid():
    rays = _jax_image_plane(1.0)
    return rays, _numpy_batch(rays)


@pytest.mark.parametrize("method, kind", NEW_VARIANTS)
def test_plain_march_new_variants_match_jax_f64(image_grid, method, kind):
    """DiscWithISCO (rk4, rk45) and Euler (ThetaLimit) on 1,681 image-plane
    rays, f64, under the tests/test_native.py gates.

    With rk45 the rays that pass the annulus and escape to r_max (status
    RLIM, about half of them) end where the controller's last step crosses
    r_max. At rk45_tol = 1e-8 the error estimate of these large far-field
    steps is rounding noise, which differs between XLA's and torch's libm,
    so the two step sequences part and the end points agree only to the
    tolerance: median |dr|/r ~ 3e-9 (a ThetaLimit(0) march of the same
    rays gives the same spread). Their end point is no observable of
    any app; the 1e-10 gate holds for the disc and horizon rays, and the
    escaped ones are held to 1e-7 relative."""
    from raytrace_tpu.ops import trace as jax_trace

    jrays, d = image_grid
    kw = dict(method=method, steplim=STEPLIM, r_max=550.0)
    a = _numpy_batch(jax_trace(jrays, -SPIN, dest=_jax_dest(kind), **kw))
    b = trace(from_numpy(d, device="cpu"), -SPIN, dest=_port_dest(kind), **kw)
    b = {f: getattr(b, f).numpy() for f in ("status", "r", "steps", "theta")}
    live = d["steps"] == 0
    sa, sb = a["status"], b["status"]
    if method == "rk45":
        assert (sa == sb)[live].mean() > 0.99
        assert (a["steps"] == b["steps"])[live & (sa == sb)].mean() > 0.99
        esc = live & (sa == 4) & (sb == 4)
        assert np.median(np.abs(a["r"] - b["r"])[esc] / a["r"][esc]) < 1e-7
        live = live & (sa != 4)
    _assert_agree(live, a, b)
    hit = (sa & 1) != 0
    assert hit.sum() > 500
    if kind == "isco":  # every disc hit lies on the plane, in the annulus
        # (tested before the crossing refinement moves r by a fraction of a step)
        r = b["r"][hit]
        assert (r >= 0.99 * isco_radius(SPIN)).all() and (r <= 1.01 * R_DISC).all()
        np.testing.assert_allclose(b["theta"][hit], np.pi / 2, rtol=0, atol=1e-12)


@pytest.fixture
def _interpret_pallas(monkeypatch):
    """Run the Pallas kernel in interpret mode, as tests/test_pallas.py does."""
    import raytrace_tpu.ops.pallas_kernel as pk

    real_call = pk.pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return real_call(*args, **kw)

    monkeypatch.setattr(pk.pl, "pallas_call", interp)


@pytest.mark.parametrize("method, kind", NEW_VARIANTS)
def test_plain_march_new_variants_match_pallas_kernel_f32(_interpret_pallas, method, kind):
    """The Pallas kernel in interpret mode against the port's plain march,
    both in f32 (batch and spin rounded to f32 once for both), on 841
    image-plane rays. Gates as test_plain_march_matches_pallas_kernel_f32:
    the fixed-step methods keep statuses on > 99% and step counts on > 98%
    of live rays, median |dr| < 1e-4; RK45 keeps statuses on > 99% and
    lands no further from the Pallas kernel than the Pallas kernel lands
    from the f64 march (twice its median |dr|)."""
    import jax.numpy as jnp

    import raytrace_tpu.ops.pallas_kernel as pk
    from raytrace_tpu.ops import trace as jax_trace

    rays = _jax_image_plane(40.0 / 29)
    d = _numpy_batch(rays)
    assert len(d["r"]) == 29 * 29
    d32 = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in d.items()}
    spin32 = float(np.float32(-SPIN))
    jdest = _jax_dest(kind)
    jdest32 = type(jdest)(**{k: jnp.float32(v) for k, v in vars(jdest).items()})
    jr = type(rays)(**{k: jnp.asarray(v) for k, v in d32.items()})
    kw = dict(method=method, steplim=STEPLIM, r_max=550.0)
    a = _numpy_batch(pk.trace_pallas(jr, jnp.float32(spin32), dest=jdest32, **kw))
    b = trace(from_numpy(d32, device="cpu", dtype=torch.float32), spin32,
              dest=_port_dest(kind), **kw)
    assert b.r.dtype == torch.float32
    b = {f: getattr(b, f).numpy() for f in ("status", "r", "steps")}
    live = d["steps"] == 0
    if method != "rk45":
        _assert_agree(live, a, b, med_dr=1e-4, steps_rate=0.98)
        return
    ref = _numpy_batch(jax_trace(rays, -SPIN, dest=_jax_dest(kind), **kw))
    assert (a["status"] == b["status"])[live].mean() > 0.99
    same = (a["status"] == b["status"]) & (a["status"] == ref["status"]) & live
    noise = np.median(np.abs(a["r"] - ref["r"])[same])
    assert np.median(np.abs(a["r"] - b["r"])[same]) < 2 * noise


@pytest.mark.cuda
@pytest.mark.parametrize("method, kind", NEW_VARIANTS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_trace_kernel_new_variants_match_plain_march_on_cuda(method, kind, dtype):
    """The DiscWithISCO and Euler instantiations against the plain march on
    the card, image-plane rays marched with the negative spin."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the march kernel has no CPU build")
    dt = getattr(torch, dtype)
    grid = ImagePlaneGrid.from_steps(-20.0, 20.0, 1.0, -20.0, 20.0, 1.0)
    rays = port_image_plane(500.0, 60.0, grid, SPIN, device="cuda", dtype=dt)
    kw = dict(method=method, dest=_port_dest(kind), steplim=STEPLIM, r_max=550.0)
    before = march_kernel.launches
    a = march_kernel.trace_kernel(rays, -SPIN, march_dtype=dt, **kw)
    torch.cuda.synchronize()
    assert march_kernel.launches == before + 1
    b = trace(rays, -SPIN, **kw)
    a = {f: getattr(a, f).cpu().numpy() for f in ("status", "r", "steps")}
    b = {f: getattr(b, f).cpu().numpy() for f in ("status", "r", "steps")}
    live = np.ones(grid.n_rays, dtype=bool)
    if dt == torch.float64:
        _assert_agree(live, a, b)
    else:
        _assert_agree(live, a, b, med_dr=1e-5, status_rate=0.98, steps_rate=0.98,
                      relative=True)
