"""The CUDA kernel's step logic, compiled for the host with g++.

``raytrace_tpu_torch/csrc/march.cuh`` holds the per-ray march that the CUDA
kernel runs per thread; ``csrc/march_host.cpp`` runs the same function ray
after ray. Built here with g++ (no FMA contraction) and driven through the
kernel wrapper's own argument packing, it must agree with the plain torch
march in f64 under the tests/test_native.py gates: ThetaLimit with rk4 and
rk45 on the golden 0.05 lamppost grid, and the image-plane slice's variants
(DiscWithISCO with rk4 and rk45, Euler with ThetaLimit) on 1,681
backward-traced image-plane rays.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.destinations import DiscWithISCO, ThetaLimit  # noqa: E402
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


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the host march")
    out = tmp_path_factory.mktemp("march_host") / "libmarch_host.so"
    cmd = [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
           "-o", str(out), str(march_kernel.CSRC / "march_host.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out))
    lib.rt_march_host.argtypes = march_kernel.argtypes(stream=False)
    lib.rt_march_host.restype = ctypes.c_int
    return lib


def host_trace(lib, rays, spin, method, steplim, dtype=torch.float64, dest=None, r_max=1000.0):
    """trace_kernel's path with the host build in place of the launch."""
    prepared, dest, buf, scalars = march_kernel.prepare(
        rays, spin, method=method, dest=dest, r_max=r_max, steplim=steplim,
        ctrl=StepControl(), boundary=None, march_dtype=dtype)
    assert lib.rt_march_host(*march_kernel.pointers(buf), *scalars) == 0
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
    lib = host_lib
    lib.rt_isco_reached_host.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_void_p]
    lib.rt_isco_reached_host.restype = ctypes.c_int
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
            got = np.zeros(len(r32), dtype=np.bool_)
            assert lib.rt_isco_reached_host(
                r32.ctypes.data, theta.ctypes.data, prev.ctypes.data, len(r32), r_isco, r_out,
                dest.theta_lim, 0, got.ctypes.data) == 0
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
