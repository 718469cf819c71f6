"""The caustics slice's surfaces in the march, against the JAX package.

FlatPlane (the source plane of the caustic plane app) on backward-traced
image-plane rays, marched with the spin -0.998, and SphericalShell with the
inner-boundary override (a neutron-star surface at r = 2.5, spin 0.3) on a
lamppost grid, as tests/test_pallas.py:121-171 does: the port's plain
lock-step march against JAX ``trace`` in f64, and against the Pallas TPU
kernel ``trace_pallas`` run in interpret mode in f32. The CUDA kernel's
instantiations are held against the plain march on the card only.

Gates are count-based, as tests/test_native.py:22-36. The JAX package is
imported inside the tests that use it, so that the card tests run where JAX
is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_march_plane.py
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.destinations import DiscWithISCO, FlatPlane, SphericalShell  # noqa: E402
from raytrace_tpu_torch.geometry import isco_radius  # noqa: E402
from raytrace_tpu_torch.ops import march_kernel, trace, trace_auto  # noqa: E402
from raytrace_tpu_torch.ops.redshift import redshift_start  # noqa: E402
from raytrace_tpu_torch.rays import RAY_STATUS_HORIZON, from_numpy  # noqa: E402
from raytrace_tpu_torch.sources import ImagePlaneGrid, PointSourceGrid  # noqa: E402
from raytrace_tpu_torch.sources import image_plane_bundles, point_source  # noqa: E402

SPIN = 0.998
SHELL_SPIN = 0.3
STEPLIM = 3000
# the plane of the caustic plane golden's geometry (incl 30), nearer the hole
PLANE = dict(incl=math.radians(30.0), phi0=0.2, z_s=200.0)
PLANE_R_MAX = 800.0
SHELL_R, BOUNDARY = 40.0, 2.5
METHODS = ["euler", "rk4", "rk45"]


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


def _jax_plane_rays(step):
    """JAX image-plane batch (dist 500, incl 30), backward-traced with -SPIN."""
    from raytrace_tpu.sources import ImagePlaneGrid as JGrid
    from raytrace_tpu.sources import image_plane

    return image_plane(500.0, 30.0, JGrid.from_steps(-10.0, 10.0, step, -10.0, 10.0, step), SPIN)


def _jax_shell_rays(step):
    """JAX lamppost batch (h = 5, on the axis) around a spin-0.3 hole, over
    cos(alpha) in [-0.9, 0.9] at ``step`` and beta in [-3, 3] at 2 ``step``."""
    from raytrace_tpu.sources import PointSourceGrid as JGrid
    from raytrace_tpu.sources import point_source

    return point_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=SHELL_SPIN,
                        grid=JGrid.from_steps(step, 2 * step, -0.9, 0.9, -3.0, 3.0))


def _case(kind, coarse=False):
    """(JAX rays: 441 (coarse: 196) image-plane rays for FlatPlane, 589
    (coarse: 260) lamppost rays for SphericalShell; spin of the march, port
    destination, JAX destination class name, march keywords) of one
    surface."""
    if kind == "plane":
        return (_jax_plane_rays(1.5 if coarse else 1.0), -SPIN, FlatPlane(**PLANE), "FlatPlane",
                dict(r_max=PLANE_R_MAX))
    return (_jax_shell_rays(0.15 if coarse else 0.1), SHELL_SPIN, SphericalShell(SHELL_R),
            "SphericalShell", dict(r_max=300.0, boundary=BOUNDARY))


def _jax_f64(kind, method, coarse=False):
    """The JAX f64 march of one surface's rays."""
    from raytrace_tpu import destinations as jd
    from raytrace_tpu.ops import trace as jax_trace

    rays, spin, dest, jname, kw = _case(kind, coarse)
    jdest = getattr(jd, jname)(**vars(dest))
    return _numpy_batch(jax_trace(rays, spin, method=method, dest=jdest, steplim=STEPLIM, **kw))


@pytest.mark.parametrize("kind", ["plane", "shell"])
@pytest.mark.parametrize("method", METHODS)
def test_plain_march_matches_jax_f64(kind, method):
    """FlatPlane on 441 image-plane rays and SphericalShell (boundary 2.5)
    on 589 lamppost rays, f64, under the tests/test_native.py gates.

    With rk45 the rays that end in the far field — on FlatPlane (no step
    cap: a ray stops where its last step crossed the plane, at r ~ 240) or
    at r_max (RLIM) — end where the controller's large steps put them. At
    rk45_tol = 1e-8 the error estimate of those steps is rounding noise,
    which differs between XLA's and torch's libm, so the step sequences
    part (measured: median |dr|/r 6e-9, step counts equal on 99.0%), as for
    the escaped rays of tests/test_torch_march_image.py. They are held to
    1e-7 relative in r and steps on > 98%; the 1e-10 gate holds for the
    others."""
    jrays, spin, dest, _, kw = _case(kind)
    d = _numpy_batch(jrays)
    a = _jax_f64(kind, method)
    b = trace(from_numpy(d, device="cpu"), spin, method=method, dest=dest, steplim=STEPLIM, **kw)
    b = {f: getattr(b, f).numpy() for f in ("status", "r", "steps")}
    live = d["steps"] == 0
    sa, sb = a["status"], b["status"]
    assert ((sa & 1) != 0)[live].sum() > 50
    if method == "rk45":
        far = live & ((sa == 4) | ((sa == 1) & (kind == "plane")))
        if far.any():
            _assert_agree(far, a, b, med_dr=1e-7, steps_rate=0.98, relative=True)
        live = live & ~far
    _assert_agree(live, a, b)
    if kind == "shell":
        hit = (sb & 1) != 0
        assert hit.sum() > 100 and (b["r"][hit] >= SHELL_R).all()


@pytest.fixture
def _interpret_pallas(monkeypatch):
    """Run the Pallas kernel in interpret mode, as tests/test_pallas.py does."""
    import raytrace_tpu.ops.pallas_kernel as pk

    real_call = pk.pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return real_call(*args, **kw)

    monkeypatch.setattr(pk.pl, "pallas_call", interp)


@pytest.mark.parametrize("kind, method", [("plane", "rk4"), ("shell", "rk45"), ("shell", "rk4")])
def test_plain_march_matches_pallas_kernel_f32(_interpret_pallas, kind, method):
    """The Pallas kernel in interpret mode against the port's plain march,
    both in f32 (batch, spin and surface rounded to f32 once for both), on
    196 image-plane rays (FlatPlane) and 260 lamppost rays (SphericalShell).

    Both surfaces put a band of rays where f32 rounding decides the
    outcome: FlatPlane has no step cap, so the step that crosses it and
    the landing point (r ~ 240) follow f32 noise; at spin 0.3 the boundary
    at r = 2.5 lies among the photon orbits, so capture or escape turns on
    rounding. The port's f32 march is held to the noise floor of the
    Pallas kernel against the f64 march: it disagrees with the Pallas
    kernel on no more statuses than the Pallas kernel does with the f64
    march (measured 0 of 196 plane, 9 / 12 of 260 shell RK4 / RK45 against
    11 / 16), and lands no further from it than twice the Pallas kernel's
    median |dr| from the f64 march. RK4 keeps the step count on > 95% of
    the rays whose statuses agree (measured 97.96% plane, 95.1% shell);
    RK45's f32 controller decides on rounding noise (tests/test_torch_march.py).
    RK4 captures rays at r ~ 2.5, outside the spin-0.3 horizon (1.954), as
    tests/test_pallas.py:156-171 checks."""
    import jax.numpy as jnp

    import raytrace_tpu.ops.pallas_kernel as pk
    from raytrace_tpu import destinations as jd

    rays, spin, dest, jname, kw = _case(kind, coarse=True)
    d = _numpy_batch(rays)
    d32 = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in d.items()}
    spin32 = float(np.float32(spin))
    jdest32 = getattr(jd, jname)(**{k: jnp.float32(v) for k, v in vars(dest).items()})
    jr = type(rays)(**{k: jnp.asarray(v) for k, v in d32.items()})
    jkw = {k: jnp.float32(v) if k == "boundary" else v for k, v in kw.items()}
    a = _numpy_batch(pk.trace_pallas(jr, jnp.float32(spin32), method=method, dest=jdest32,
                                     steplim=STEPLIM, **jkw))
    b = trace(from_numpy(d32, device="cpu", dtype=torch.float32), spin32, method=method,
              dest=dest, steplim=STEPLIM, **kw)
    assert b.r.dtype == torch.float32
    b = {f: getattr(b, f).numpy() for f in ("status", "r", "steps")}
    ref = _jax_f64(kind, method, coarse=True)
    live = d["steps"] == 0
    sa, sb, sr = a["status"], b["status"], ref["status"]
    assert (sa != sb)[live].sum() <= (sa != sr)[live].sum()
    same = (sa == sb) & (sa == sr) & live
    assert same.sum() > 150
    noise = np.median(np.abs(a["r"] - ref["r"])[same])
    assert np.median(np.abs(a["r"] - b["r"])[same]) <= 2 * noise
    if method == "rk4":
        assert (a["steps"] == b["steps"])[(sa == sb) & live].mean() > 0.95
    if kind == "shell" and method == "rk4":
        cap = live & ((sb & RAY_STATUS_HORIZON) != 0)
        assert cap.sum() > 20
        # f32 capture shell is 200 ulp-floored (integrate.py::_capture_radius)
        assert (b["r"][cap] <= BOUNDARY * (1 + 1e-4)).all() and (b["r"][cap] > 2.2).all()


def test_trace_auto_takes_the_batch_dtype_on_the_cpu():
    """On a CPU batch ``march_dtype`` may be None or the batch's own dtype
    (the plain march works in it); anything else raises."""
    rays = point_source((0.0, 5.0, 1e-3, 1.5707), 0.0, SPIN, PointSourceGrid.from_steps(0.4, 0.8),
                        device="cpu")
    kw = dict(method="rk4", steplim=500, dest=SphericalShell(40.0))
    a = trace_auto(rays, SPIN, march_dtype=torch.float64, **kw)
    b = trace_auto(rays, SPIN, **kw)
    assert torch.equal(a.r, b.r) and torch.equal(a.status, b.status)
    with pytest.raises(ValueError, match="march_dtype"):
        trace_auto(rays, SPIN, march_dtype=torch.float32, **kw)
    with pytest.raises(ValueError, match="march_dtype"):
        trace_auto(rays.to(dtype=torch.float32), SPIN, march_dtype=torch.float64, **kw)


def _card_batch(kind, dtype):
    """The card's batch of one surface: caustic bundles (the plane golden's
    geometry, 21 x 21 pixels) for FlatPlane and DiscWithISCO, the lamppost
    for SphericalShell."""
    if kind == "shell":
        rays = point_source((0.0, 5.0, 1e-3, 0.0), 0.0, SHELL_SPIN,
                            PointSourceGrid.from_steps(0.1, 0.2, -0.9, 0.9, -3.0, 3.0),
                            device="cuda")
        return rays.to(dtype=dtype), SHELL_SPIN, SphericalShell(SHELL_R), dict(r_max=300.0,
                                                                               boundary=BOUNDARY)
    incl = 30.0 if kind == "plane" else 60.0
    grid = ImagePlaneGrid.from_steps(-10.0, 10.0, 1.0, -10.0, 10.0, 1.0)
    rays, _ = image_plane_bundles(500.0, incl, grid, SPIN, device="cuda", dtype=dtype)
    rays = redshift_start(rays, -SPIN, 0.0, reverse=True)
    if kind == "plane":
        return rays, -SPIN, FlatPlane(math.radians(30.0), 0.0, 500.0), dict(r_max=2000.0)
    return rays, -SPIN, DiscWithISCO(isco_radius(SPIN), 20.0), dict(r_max=550.0)


@pytest.mark.cuda
@pytest.mark.parametrize("method, kind", [("euler", "isco")]
                         + [(m, k) for k in ("plane", "shell") for m in METHODS])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_trace_kernel_caustic_variants_match_plain_march_on_cuda(method, kind, dtype):
    """The slice's 14 new instantiations against the plain march on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the march kernel has no CPU build")
    dt = getattr(torch, dtype)
    rays, spin, dest, kw = _card_batch(kind, dt)
    before = march_kernel.launches
    a = march_kernel.trace_kernel(rays, spin, method=method, dest=dest, steplim=STEPLIM,
                                  march_dtype=dt, **kw)
    torch.cuda.synchronize()
    assert march_kernel.launches == before + 1
    b = trace(rays, spin, method=method, dest=dest, steplim=STEPLIM, **kw)
    a = {f: getattr(a, f).cpu().numpy() for f in ("status", "r", "steps")}
    b = {f: getattr(b, f).cpu().numpy() for f in ("status", "r", "steps")}
    live = (rays.steps == 0).cpu().numpy()
    if dt == torch.float64:
        _assert_agree(live, a, b)
    else:
        _assert_agree(live, a, b, med_dr=1e-5, status_rate=0.98, steps_rate=0.98, relative=True)
