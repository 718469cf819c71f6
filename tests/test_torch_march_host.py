"""The CUDA kernel's step logic, compiled for the host with g++.

``raytrace_tpu_torch/csrc/march.cuh`` holds the per-ray march that the CUDA
kernel runs per thread; ``csrc/march_host.cpp`` runs the same function ray
after ray. Built here with g++ (no FMA contraction) and driven through the
kernel wrapper's own argument packing, it must agree with the plain torch
march in f64 under the tests/test_native.py gates: ThetaLimit with rk4 and
rk45 on the golden 0.05 lamppost grid, the image-plane slice's variants
(DiscWithISCO with rk4 and rk45, Euler with ThetaLimit) on 1,681
backward-traced image-plane rays, and the caustics slice's (Euler with
DiscWithISCO; FlatPlane and SphericalShell with every method). Each
destination's ``reached`` is also checked point by point against the plain
one in float32 (``rt_reached_host``). The lane-refill schedule of the
kernel, emulated warp by warp on the same lane state machine, is held
bitwise to the ray-after-ray march for every instantiation. The guarded
trig the step takes sin and cos through (``m_sincos``, ``m_cos``) gives the
C library's sin and cos bit for bit on both sides of its guard
(``rt_trig_host``).
"""

import dataclasses

import ctypes
import ctypes.util
import math
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch import mathfn  # noqa: E402
from raytrace_tpu_torch.destinations import DiscWithISCO, FlatPlane, SphericalShell  # noqa: E402
from raytrace_tpu_torch.destinations import ThetaLimit  # noqa: E402
from raytrace_tpu_torch.geometry import isco_radius  # noqa: E402
from raytrace_tpu_torch.ops import march_kernel, trace  # noqa: E402
from raytrace_tpu_torch.ops.integrate import StepControl  # noqa: E402
from raytrace_tpu_torch.sources import ImagePlaneGrid, PointSourceGrid, image_plane  # noqa: E402
from raytrace_tpu_torch.sources import point_source  # noqa: E402

SPIN = 0.998
SOURCE = (0.0, 5.0, 1e-3, 1.5707)
STEPLIM = 3000
R_DISC = 20.0
NEW_VARIANTS = [("rk4", "isco"), ("rk45", "isco"), ("euler", "theta")]


def _build_host_lib(src_dir, out_dir):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the host march")
    out = out_dir / "libmarch_host.so"
    cmd = [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
           "-o", str(out), str(src_dir / "march_host.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out))
    lib.rt_march_host.argtypes = march_kernel.argtypes(host=True)
    lib.rt_march_host.restype = ctypes.c_int
    lib.rt_reached_host.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int]
                                    + [ctypes.c_double] * 4 + [ctypes.c_int, ctypes.c_void_p])
    lib.rt_reached_host.restype = ctypes.c_int
    lib.rt_trig_host.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.rt_trig_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build_host_lib(march_kernel.CSRC, tmp_path_factory.mktemp("march_host"))



def host_reached(lib, dest, r, theta, phi, prev):
    """``dest_reached`` of the host build on float32 or float64 numpy points,
    with the destination's arguments as the kernel wrapper packs them."""
    code, *params = march_kernel._dest_args(dest)
    pts = [np.ascontiguousarray(v) for v in (r, theta, phi, prev)]
    out = np.zeros(len(r), dtype=np.bool_)
    dtype = {np.float32: 0, np.float64: 1}[pts[0].dtype.type]
    assert lib.rt_reached_host(*(v.ctypes.data for v in pts), len(r), code, *params, dtype,
                               out.ctypes.data) == 0
    return out


def host_trace(lib, rays, spin, method, steplim, dtype=torch.float64, dest=None, r_max=1000.0,
               boundary=None):
    """trace_kernel's path with the host build in place of the launch."""
    prepared, dest, buf, scalars = march_kernel.prepare(
        rays, spin, method=method, dest=dest, r_max=r_max, steplim=steplim,
        ctrl=StepControl(), boundary=boundary, march_dtype=dtype)
    assert lib.rt_march_host(*march_kernel.pointers(buf), *scalars, 0) == 0
    return march_kernel.finish(prepared, buf, dest, spin, refine_crossing=True)


@pytest.fixture(scope="module")
def golden_rays():
    return point_source(SOURCE, 0.0, SPIN, PointSourceGrid.from_steps(0.05, 0.05), device="cpu")


def _dest(kind):
    return DiscWithISCO(isco_radius(SPIN), R_DISC) if kind == "isco" else ThetaLimit()


@pytest.fixture(scope="module")
def image_rays():
    """Image-plane rays (dist 500, incl 60), marched with the spin -SPIN."""
    grid = ImagePlaneGrid.from_steps(-20.0, 20.0, 1.0, -20.0, 20.0, 1.0)
    return image_plane(500.0, 60.0, grid, SPIN, device="cpu")


@pytest.mark.parametrize("method", ["rk4", "rk45"])
def test_host_march_matches_plain_march_f64(host_lib, golden_rays, method):
    a = host_trace(host_lib, golden_rays, SPIN, method, STEPLIM)
    b = trace(golden_rays, SPIN, method=method, steplim=STEPLIM)
    live = (golden_rays.steps == 0).numpy()
    sa, sb = a.status.numpy(), b.status.numpy()
    assert (sa == sb)[live].mean() > 0.99
    same = (sa == sb) & live
    assert np.median(np.abs(a.r.numpy() - b.r.numpy())[same]) < 1e-10
    assert (a.steps.numpy() == b.steps.numpy())[same].mean() > 0.99
    for f in ("rdot_flips", "equatorial_crossings"):
        assert (getattr(a, f).numpy() == getattr(b, f).numpy())[same].mean() > 0.99
    if method == "rk45":
        assert np.median(np.abs(a.dt.numpy() - b.dt.numpy())[same]) < 1e-10


@pytest.mark.parametrize("method", ["rk4", "rk45"])
def test_host_march_f32_template(host_lib, method):
    """The float instantiation on the 0.1 grid: statuses as the f64 march's
    on > 98% of live rays (f32 noise moves a few separatrix rays)."""
    rays = point_source(SOURCE, 0.0, SPIN, PointSourceGrid.from_steps(0.1, 0.1), device="cpu")
    a = host_trace(host_lib, rays, SPIN, method, STEPLIM, dtype=torch.float32)
    b = host_trace(host_lib, rays, SPIN, method, STEPLIM)
    live = (rays.steps == 0).numpy()
    assert (a.status.numpy() == b.status.numpy())[live].mean() > 0.98
    hit = live & ((a.status.numpy() & 1) != 0) & ((b.status.numpy() & 1) != 0)
    rel = np.abs(a.r.numpy() / b.r.numpy() - 1)[hit]
    assert np.median(rel) < 1e-3


def test_host_march_leaves_dead_rays_alone(host_lib):
    rays = point_source(SOURCE, 0.0, SPIN, PointSourceGrid.from_steps(0.4, 0.8), device="cpu")
    dead = np.arange(rays.n_rays) % 3 == 0
    rays = rays.replace(steps=torch.where(torch.from_numpy(dead), -1, rays.steps).to(torch.int32))
    out = host_trace(host_lib, rays, SPIN, "rk4", 500)
    np.testing.assert_array_equal(out.steps.numpy()[dead], -1)
    np.testing.assert_array_equal(out.status.numpy()[dead], 0)
    np.testing.assert_array_equal(out.r.numpy()[dead], rays.r.numpy()[dead])


@pytest.mark.parametrize("method, kind", NEW_VARIANTS)
def test_host_march_new_variants_match_plain_march_f64(host_lib, image_rays, method, kind):
    """The DiscWithISCO and Euler instantiations against the plain march, f64,
    under the tests/test_native.py gates, counters included. With rk45 the
    rays that pass the annulus and escape (RLIM) are held to 1e-7 relative
    in r: their end point follows DOPRI5 step sequences that part on libm
    rounding noise (glibc here, torch's vectorised sin/cos there), as in
    tests/test_torch_march.py."""
    kw = dict(dest=_dest(kind), r_max=550.0)
    a = host_trace(host_lib, image_rays, -SPIN, method, STEPLIM, **kw)
    b = trace(image_rays, -SPIN, method=method, steplim=STEPLIM, **kw)
    sa, sb = a.status.numpy(), b.status.numpy()
    assert (sa == sb).mean() > 0.99
    same = sa == sb
    dr = np.abs(a.r.numpy() - b.r.numpy())
    if method == "rk45":
        esc = same & (sa == 4)
        assert np.median(dr[esc] / b.r.numpy()[esc]) < 1e-7
        assert np.median(dr[same & (sa != 4)]) < 1e-10
    else:
        assert np.median(dr[same]) < 1e-10
    assert (a.steps.numpy() == b.steps.numpy())[same].mean() > 0.99
    for f in ("rdot_flips", "equatorial_crossings"):
        assert (getattr(a, f).numpy() == getattr(b, f).numpy())[same].mean() > 0.99
    hit = (sa & 1) != 0
    assert hit.sum() > 500
    if kind == "isco":  # rays crossing inside the ISCO or beyond r_out march on
        assert ((sa & 4) != 0).sum() > 500 and ((sa & 2) != 0).sum() > 0


@pytest.mark.parametrize("method, kind", NEW_VARIANTS)
def test_host_march_new_variants_f32_template(host_lib, method, kind):
    """The float instantiations on 441 image-plane rays: statuses as the f64
    march's on > 98%, disc hits within 1e-3 in r (median)."""
    grid = ImagePlaneGrid.from_steps(-20.0, 20.0, 2.0, -20.0, 20.0, 2.0)
    rays = image_plane(500.0, 60.0, grid, SPIN, device="cpu", work_dtype=torch.float32)
    kw = dict(dest=_dest(kind), r_max=550.0)
    a = host_trace(host_lib, rays, -SPIN, method, STEPLIM, dtype=torch.float32, **kw)
    b = host_trace(host_lib, rays, -SPIN, method, STEPLIM, **kw)
    assert (a.status.numpy() == b.status.numpy()).mean() > 0.98
    hit = ((a.status.numpy() & 1) != 0) & ((b.status.numpy() & 1) != 0)
    assert hit.sum() > 100
    assert np.median(np.abs(a.r.numpy() / b.r.numpy() - 1)[hit]) < 1e-3


def _f32_off(x, ulps):
    """A double ``ulps`` float32 ulps away from the float32 nearest x."""
    x32 = np.float32(x)
    return float(x32) + ulps * float(np.spacing(x32))


def test_host_march_isco_edges_round_like_the_plain_march(host_lib):
    """DiscWithISCO's parameters reach the kernel as doubles and are rounded
    once to float, as torch rounds the Python floats the plain march
    compares a float32 r with. ``dest_reached`` on float32 points at and one
    ulp either side of each edge, for edges that float32 rounds down and up,
    answers exactly as the plain ``reached`` (a comparison in double would
    not); and an annulus whose edges are not float32 numbers stops the same
    rays in both f32 marches."""
    half_pi = np.float32(np.pi / 2)
    # crossing upwards, downwards, and no crossing
    thetas = [(half_pi - np.float32(1e-3), half_pi + np.float32(1e-3)),
              (half_pi + np.float32(1e-3), half_pi),
              (half_pi - np.float32(2e-3), half_pi - np.float32(1e-3))]
    disagree_in_double = 0
    for r_isco in (isco_radius(SPIN), _f32_off(1.25, 0.25), _f32_off(1.25, -0.25)):
        for r_out in (-1.0, _f32_off(9.0, 0.25), _f32_off(9.0, -0.25)):
            edges = [r_isco] + ([r_out] if r_out > 0 else [])
            r32 = np.array([np.nextafter(np.float32(e), np.float32(d), dtype=np.float32)
                            for e in edges for d in (0.0, np.inf)]
                           + [np.float32(e) for e in edges] + [np.float32(4.0)], np.float32)
            r32 = np.repeat(r32, len(thetas))
            prev, theta = (np.tile(np.array(c, np.float32), len(r32) // len(thetas))
                           for c in zip(*thetas))
            dest = DiscWithISCO(r_isco, r_out)
            want = dest.reached(torch.from_numpy(r32), torch.from_numpy(theta), None,
                                torch.from_numpy(prev)).numpy()
            got = host_reached(host_lib, dest, r32, theta, np.zeros_like(r32), prev)
            np.testing.assert_array_equal(got, want)
            crossed = ((prev < half_pi) & (theta >= half_pi)) | ((prev > half_pi) & (theta <= half_pi))
            r64 = r32.astype(np.float64)
            in_double = crossed & (r64 >= r_isco) & ((r_out <= 0) | (r64 <= r_out))
            disagree_in_double += int((in_double != want).sum())
            assert want.sum() > 0
    assert disagree_in_double > 0

    grid = ImagePlaneGrid.from_steps(-12.0, 12.0, 1.5, -12.0, 12.0, 1.5)
    rays = image_plane(500.0, 60.0, grid, SPIN, device="cpu", work_dtype=torch.float32)
    rays32 = rays.to(dtype=torch.float32)
    dest = DiscWithISCO(isco_radius(SPIN) + 1e-9, 9.0 + 1e-9)
    a = host_trace(host_lib, rays32, -SPIN, "rk4", STEPLIM, dtype=torch.float32, dest=dest,
                   r_max=550.0)
    b = trace(rays32, -SPIN, method="rk4", steplim=STEPLIM, dest=dest, r_max=550.0)
    assert (a.status.numpy() == b.status.numpy()).mean() > 0.98
    assert ((a.status.numpy() & 1) != 0).sum() > 50


# the caustics slice's new instantiations: (method, destination kind)
CAUSTIC_VARIANTS = [("euler", "isco")] + [(m, k) for k in ("plane", "shell")
                                          for m in ("euler", "rk4", "rk45")]


def _caustic_case(kind, dtype=torch.float64):
    """(rays, march spin, destination, march keywords) of one surface:
    image-plane rays (dist 500) marched with -SPIN for DiscWithISCO and
    FlatPlane, a spin-0.3 lamppost with the boundary at r = 2.5 for
    SphericalShell."""
    if kind == "shell":
        rays = point_source((0.0, 5.0, 1e-3, 0.0), 0.0, 0.3,
                            PointSourceGrid.from_steps(0.1, 0.2, -0.9, 0.9, -3.0, 3.0), device="cpu")
        return rays, 0.3, SphericalShell(40.0), dict(r_max=300.0, boundary=2.5)
    grid = ImagePlaneGrid.from_steps(-10.0, 10.0, 1.0, -10.0, 10.0, 1.0)
    if kind == "plane":
        rays = image_plane(500.0, 30.0, grid, SPIN, device="cpu", work_dtype=dtype)
        return rays, -SPIN, FlatPlane(math.radians(30.0), 0.2, 200.0), dict(r_max=800.0)
    rays = image_plane(500.0, 60.0, grid, SPIN, device="cpu", work_dtype=dtype)
    return rays, -SPIN, _dest("isco"), dict(r_max=550.0)


@pytest.mark.parametrize("method, kind", CAUSTIC_VARIANTS)
def test_host_march_caustic_variants_match_plain_march_f64(host_lib, method, kind):
    """The caustics slice's instantiations against the plain march, f64,
    under the tests/test_native.py gates, counters included. With rk45 the
    rays that end in the far field (on FlatPlane, which caps no step, or at
    r_max) are held to 1e-7 relative in r: their DOPRI5 step sequences part
    on libm rounding noise (glibc here, torch's vectorised sin/cos there),
    as in tests/test_torch_march_plane.py."""
    rays, spin, dest, kw = _caustic_case(kind)
    a = host_trace(host_lib, rays, spin, method, STEPLIM, dest=dest, **kw)
    b = trace(rays, spin, method=method, steplim=STEPLIM, dest=dest, **kw)
    live = (rays.steps == 0).numpy()
    sa, sb = a.status.numpy(), b.status.numpy()
    assert (sa == sb)[live].mean() > 0.99
    same = (sa == sb) & live
    dr = np.abs(a.r.numpy() - b.r.numpy())
    far = same & ((sa == 4) | ((sa == 1) & (kind == "plane"))) if method == "rk45" else same & False
    if far.any():
        assert np.median(dr[far] / b.r.numpy()[far]) < 1e-7
    assert np.median(dr[same & ~far]) < 1e-10
    assert (a.steps.numpy() == b.steps.numpy())[same].mean() > 0.98
    for f in ("rdot_flips", "equatorial_crossings"):
        assert (getattr(a, f).numpy() == getattr(b, f).numpy())[same].mean() > 0.99
    hit = (sa & 1) != 0
    assert hit.sum() > 100
    if kind == "shell":
        assert (a.r.numpy()[hit] >= 40.0).all() and ((sa & 2) != 0).sum() > 20
    if kind == "plane":  # every hit lies on or past the plane
        proj = dest.projection(a.r, a.theta, a.phi).numpy()
        assert (proj[hit] <= -dest.z_s).all()


@pytest.mark.parametrize("method, kind", CAUSTIC_VARIANTS)
def test_host_march_caustic_variants_f32_template(host_lib, method, kind):
    """The float instantiations of the caustics slice against the double
    ones: statuses equal on > 95% of live rays (the shell's boundary lies
    among the spin-0.3 photon orbits, where f32 rounding decides capture or
    escape for a band of rays), surface hits within 1e-3 in r (median) —
    1e-2 for RK45 on FlatPlane, whose f32 controller (rk45_tol = 1e-8 below
    f32's resolution) picks the steps that land at r ~ 240 on rounding
    noise (measured 3.3e-3)."""
    rays, spin, dest, kw = _caustic_case(kind, torch.float32)
    a = host_trace(host_lib, rays, spin, method, STEPLIM, dtype=torch.float32, dest=dest, **kw)
    b = host_trace(host_lib, rays, spin, method, STEPLIM, dest=dest, **kw)
    live = (rays.steps == 0).numpy()
    sa, sb = a.status.numpy(), b.status.numpy()
    assert (sa == sb)[live].mean() > 0.95
    hit = live & ((sa & 1) != 0) & ((sb & 1) != 0)
    assert hit.sum() > 100
    tol = 1e-2 if (method, kind) == ("rk45", "plane") else 1e-3
    assert np.median(np.abs(a.r.numpy() / b.r.numpy() - 1)[hit]) < tol


def _libm_agrees(fn, x32):
    """Where the plain march's float32 ``fn`` (``mathfn``: taken in float64
    and rounded once) equals the C library's (which the host build calls):
    a 1-ulp libm difference at a point near the plane would flip the answer
    whatever the operand order."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    c_fn = getattr(libm, fn + "f")
    c_fn.argtypes, c_fn.restype = [ctypes.c_float], ctypes.c_float
    mine = getattr(mathfn, fn)(torch.from_numpy(x32)).numpy()
    return mine == np.array([c_fn(float(v)) for v in x32], dtype=np.float32)


@pytest.mark.parametrize("incl_deg, phi0, z_s", [(80.0, 0.0, 1e4), (30.0, 0.2, 500.0),
                                                 (60.0, -1.1, 200.0)])
def test_host_plane_reached_rounds_like_the_plain_march(host_lib, incl_deg, phi0, z_s):
    """FlatPlane's projection test on float32 points within a few ulp of
    the plane answers exactly as the plain ``reached`` on float32 tensors:
    the kernel takes sin and cos of the inclination made in double and
    rounded once, and keeps torch's operand order. The points straddle the
    plane, so both answers occur. Compared where torch's float32 sin and cos
    agree with the C library's on each point (on the card both marches call
    one libm); SphericalShell likewise at its radius."""
    rng = np.random.default_rng(int(incl_deg))
    dest = FlatPlane(math.radians(incl_deg), phi0, z_s)
    n = 20_000
    theta = rng.uniform(0.05, np.pi - 0.05, n)
    phi = rng.uniform(-np.pi, 3 * np.pi, n)
    proj_dir = (np.sin(theta) * dest.sin_incl * np.cos(phi - phi0)
                + np.cos(theta) * dest.cos_incl)
    keep = proj_dir < -0.05
    r = z_s / -proj_dir[keep] * (1.0 + rng.normal(0.0, 3e-7, keep.sum()))
    pts = [v.astype(np.float32) for v in (r, theta[keep], phi[keep])]
    want = dest.reached(*(torch.from_numpy(v) for v in pts), None).numpy()
    got = host_reached(host_lib, dest, *pts, np.zeros_like(pts[0]))
    dphi = (torch.from_numpy(pts[2]) - phi0).numpy()
    same_libm = (_libm_agrees("sin", pts[1]) & _libm_agrees("cos", pts[1])
                 & _libm_agrees("cos", dphi))
    assert same_libm.mean() > 0.7 and 0.2 < want[same_libm].mean() < 0.8
    np.testing.assert_array_equal(got[same_libm], want[same_libm])

    shell = SphericalShell(40.0 + 1e-6)
    r32 = np.nextafter(np.float32(shell.r_shell), np.float32([0.0, np.inf, 40.0]).repeat(1))
    r32 = np.concatenate([r32, np.float32([40.0, 41.0, 39.0])]).astype(np.float32)
    zeros = np.zeros_like(r32)
    want = shell.reached(torch.from_numpy(r32), None, None, None).numpy()
    np.testing.assert_array_equal(host_reached(host_lib, shell, r32, zeros, zeros, zeros), want)


def _refill_case(kind, dtype):
    """(rays, spin, destination, march keywords) for the refill tests: the
    caustic cases' batches, and the 0.1 lamppost grid with ThetaLimit."""
    if kind != "theta":
        return _caustic_case(kind, dtype)
    rays = point_source(SOURCE, 0.0, SPIN, PointSourceGrid.from_steps(0.1, 0.2), device="cpu")
    return rays, SPIN, ThetaLimit(), dict(r_max=1000.0)


def _take(rays, idx):
    return rays.replace(**{f.name: getattr(rays, f.name)[idx] for f in dataclasses.fields(rays)})


def _host_buffers(lib, rays, spin, method, dtype, dest, kw, ctrl, steplim, max_iters, warps):
    """The 21 marched buffers after the host build's march with ``warps``
    emulated warps (0: ray after ray), at the given steplim and max_iters."""
    _, _, buf, scalars = march_kernel.prepare(
        rays, spin, method=method, dest=dest, steplim=steplim, ctrl=ctrl,
        march_dtype=dtype, r_max=kw["r_max"], boundary=kw.get("boundary"))
    scalars[10] = max_iters
    assert lib.rt_march_host(*march_kernel.pointers(buf), *scalars, warps) == 0
    return buf


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["theta", "isco", "plane", "shell"])
@pytest.mark.parametrize("method", ["euler", "rk4", "rk45"])
def test_host_refill_schedule_matches_per_ray_march(host_lib, method, kind, dtype):
    """The lane-refill schedule (rt_march_host with emulated warps sharing
    one counter, 32 rays a take) gives every one of the 21 fields bit for
    bit as the march ray after ray: 203 rays on 3 warps (lanes that take
    several rays; n not a multiple of 32) and 13 on 2 (a warp with no ray
    at all), with dead rays (steps -1),
    finished ones and a stuck one (STEPLIM with positive steps, negated on
    the way out) among them; cut by steplim, and by a max_iters below it
    that leaves rays active — at 3 iterations, with the step caps opened
    up, RK45 rays whose last trial was rejected, so a lane's step and FSAL
    carry must not leak into the next ray it takes."""
    _check_refill_schedule(host_lib, method, kind, dtype)


def _check_refill_schedule(host_lib, method, kind, dtype):
    rays, spin, dest, kw = _refill_case(kind, dtype)
    rng = np.random.default_rng(7)
    rays = _take(rays, torch.from_numpy(rng.permutation(rays.n_rays)[:203]))
    k = torch.arange(rays.n_rays)
    steps = torch.where(k % 9 == 4, -1, rays.steps)
    steps = torch.where(k % 31 == 6, 5, steps)
    status = torch.where(k % 11 == 3, 1, rays.status)
    status = torch.where(k % 31 == 6, 8, status)
    rays = rays.replace(steps=steps.to(torch.int32), status=status.to(torch.int32))
    names = march_kernel.F_FIELDS + march_kernel.I_FIELDS + march_kernel.B_FIELDS
    loose = StepControl(precision=1.0, theta_precision=1.0, max_tstep=0.0, max_phistep=0.0,
                        min_step=1e-9)
    for ctrl, steplim, max_iters in ((StepControl(), 300, 330), (StepControl(), 10_000, 250),
                                     (loose, 10_000, 3)):
        for n, warps in ((203, 3), (13, 2)):
            sub = _take(rays, slice(n))
            args = (host_lib, sub, spin, method, dtype, dest, kw, ctrl, steplim)
            want = _host_buffers(*args, max_iters, 0)
            got = _host_buffers(*args, max_iters, warps)
            for f in names:
                same = np.array_equal(got[f].numpy().view(np.uint8), want[f].numpy().view(np.uint8))
                assert same, f"{f} (n {n}, {warps} warps, steplim {steplim}, max_iters {max_iters})"
            if max_iters > steplim or n < 32 * warps:
                continue
            # rays of the first lanes the cut leaves active: their lanes take new rays
            live = ((want["steps"] >= 0) & ((want["status"] & 0x4F) == 0))[:32 * warps]
            if ctrl is not loose:
                assert int(live.sum()) > 0
            elif method == "rk45":
                before = _host_buffers(*args, max_iters - 1, 0)
                rejected = (before["steps"] == want["steps"]) & (before["dt"] != want["dt"])
                assert int((live & rejected[:32 * warps]).sum()) > 0
    dead = (rays.steps < 0).numpy()[:13]
    np.testing.assert_array_equal(want["steps"].numpy()[dead], -1)
    assert (want["steps"].numpy()[(k[:13] % 31 == 6).numpy()] == -5).all()


def _libm(name, dtype):
    """The C library's sin or cos of one working type, as ctypes calls it."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    ctype = ctypes.c_float if dtype == np.float32 else ctypes.c_double
    fn = getattr(libm, name + ("f" if dtype == np.float32 else ""))
    fn.argtypes, fn.restype = [ctype], ctype
    return fn


@pytest.mark.parametrize("dtype, fast", [(np.float32, 105615.0), (np.float64, 2.0**31)])
def test_host_guarded_trig_is_the_c_library_trig(host_lib, dtype, fast):
    """m_sincos and m_cos (csrc/march.cuh) give the C library's sin and cos
    bit for bit: at the guard's threshold (the largest |x| the CUDA math
    library reduces with its fast path, TRIG_FAST_F32 / TRIG_FAST_F64) and
    8 representable numbers either side of it, at +-0, NaN and +-inf, at
    multiples of pi/4, and on a seeded sweep of magnitudes from 1e-30 to
    1e10 of either sign. Both sides of the guard call the same functions;
    this holds the host build's wiring of them."""
    rng = np.random.default_rng(11)
    edge = np.array([fast], dtype)
    near = [edge]
    for direction in (np.inf, 0.0):
        x = edge.copy()
        for _ in range(8):
            x = np.nextafter(x, dtype(direction))
            near.append(x)
    near = np.concatenate(near)
    special = np.array([0.0, -0.0, np.nan, np.inf, -np.inf], dtype)
    quarter = (np.arange(-1273, 1274) * (np.pi / 4)).astype(dtype)
    sweep = (rng.choice([-1.0, 1.0], 20_000) * 10.0 ** rng.uniform(-30, 10, 20_000)).astype(dtype)
    x = np.ascontiguousarray(np.concatenate([near, -near, special, quarter, sweep]))
    s, c, cc = (np.empty_like(x) for _ in range(3))
    code = 0 if dtype == np.float32 else 1
    assert host_lib.rt_trig_host(x.ctypes.data, len(x), code, s.ctypes.data, c.ctypes.data,
                                 cc.ctypes.data) == 0
    view = np.uint32 if dtype == np.float32 else np.uint64
    libm_sin, libm_cos = _libm("sin", dtype), _libm("cos", dtype)
    want_s = np.array([libm_sin(float(v)) for v in x], dtype)
    want_c = np.array([libm_cos(float(v)) for v in x], dtype)
    for got, want in ((s, want_s), (c, want_c), (cc, want_c)):
        np.testing.assert_array_equal(got.view(view), want.view(view))
    assert (np.abs(x) >= fast).sum() >= 20 and (np.abs(x[np.isfinite(x)]) < fast).sum() > 1000
