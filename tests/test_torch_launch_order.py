"""Launch order: the march kernel's result does not depend on where a ray
sits in its batch, and the long-first order, tried and not taken.

The launcher marches every batch in its natural order (slot i holds ray
i) and has no order of its own. A long-first order, which put the rays
nearest the photon shell by their separatrix score (``ops.diff.
separatrix_score``) at the head of the launch, was measured on the card
and dropped: the score does not find the rays that march longest. What
stays is held here on the CPU: the score agrees with JAX's near the
photon shell to the tolerance of tests/test_torch_diff_kerr.py; on a
camera strip across the critical curve of the disc-image geometry the
score's head misses the rays that march longest (the finding that stopped
the order); and a batch gathered into another order, marched by the host
build of the kernel's march (``march_host.cpp``, as
tests/test_torch_march_host.py builds it) and gathered back gives the
natural order's bits in all 21 fields, towards each kind of destination,
in float32 and float64. The caustic map's pixel ranges rely on that: on
a card they lay the batch out range after range
(``apps.caustics._range_major``). The card's test (the launcher's one
launch, and the launch-trace side build of csrc/march.cu, bitwise the
launcher) is marked ``cuda``:

    python -m pytest --noconftest -m cuda tests/test_torch_launch_order.py
"""

import ctypes
import math
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from raytrace_tpu_torch.apps import caustics  # noqa: E402
from raytrace_tpu_torch.destinations import DiscWithISCO, FlatPlane, SphericalShell  # noqa: E402
from raytrace_tpu_torch.destinations import ThetaLimit  # noqa: E402
from raytrace_tpu_torch.geometry import isco_radius  # noqa: E402
from raytrace_tpu_torch.ops import diff, march_kernel, trace  # noqa: E402
from raytrace_tpu_torch.ops.integrate import StepControl  # noqa: E402
from raytrace_tpu_torch.ops.redshift import redshift_start  # noqa: E402
from raytrace_tpu_torch.sources import ImagePlaneGrid, PointSourceGrid, image_plane  # noqa: E402
from raytrace_tpu_torch.sources import point_source  # noqa: E402

SPIN = 0.998
SOURCE = (0.0, 5.0, 1e-3, 1.5707)
FIELDS = march_kernel.F_FIELDS + march_kernel.I_FIELDS + march_kernel.B_FIELDS


def _photon_shell_constants(spin, n, rng):
    """Constants (k, h, Q) of n spherical photon orbits of the Kerr hole
    (Teo 2003: xi and eta as functions of the orbit's radius; at a = 0 the
    sphere xi^2 + eta = 27), each with k in [0.5, 1.5]."""
    if spin == 0.0:
        xi = rng.uniform(-5.0, 5.0, n)
        eta = 27.0 - xi * xi
    else:
        a = abs(spin)
        r = rng.uniform(1.001, 4.5, 8 * n)
        xi = -(r ** 3 - 3.0 * r * r + a * a * r + a * a) / (a * (r - 1.0))
        eta = -r ** 3 * (r ** 3 - 6.0 * r * r + 9.0 * r - 4.0 * a * a) / (a * a * (r - 1.0) ** 2)
        keep = eta > 0
        xi, eta = np.sign(spin) * xi[keep][:n], eta[keep][:n]
    k = rng.uniform(0.5, 1.5, len(xi))
    return k, k * xi, k * k * eta


def _constants(spin, n=512, seed=5):
    """Constants from a seed: half uniform as tests/test_torch_diff_kerr.py
    draws them, half on the photon shell moved by a relative 1e-9 to 1e-3."""
    rng = np.random.default_rng(seed)
    k = rng.uniform(0.5, 1.5, n // 2)
    h = rng.uniform(-6.0, 6.0, n // 2)
    Q = rng.uniform(0.0, 40.0, n // 2)
    ks, hs, Qs = _photon_shell_constants(spin, n - n // 2, rng)
    nudge = 1.0 + rng.choice([-1.0, 1.0], len(hs)) * 10.0 ** rng.uniform(-9.0, -3.0, len(hs))
    return (np.concatenate([k, ks]), np.concatenate([h, hs * nudge]),
            np.concatenate([Q, Qs]))


@pytest.mark.parametrize("spin", [0.0, 0.5, -0.9, 0.998])
def test_separatrix_score_matches_jax_near_the_shell(spin):
    """The score the order ranks by, ``ops.diff.separatrix_score`` in
    float64, agrees with JAX's ``separatrix_score`` to rtol 1e-10, atol
    1e-14 (tests/test_torch_diff_kerr.py's tolerance) on constants from a
    seed, half of them within a relative 1e-3 of the photon shell, where
    it is near 0."""
    from raytrace_tpu.ops import diff as jdiff

    k, h, Q = (torch.from_numpy(x) for x in _constants(spin))
    got = diff.separatrix_score(k, h, Q, spin)
    ref = np.asarray(jdiff.separatrix_score(k.numpy(), h.numpy(), Q.numpy(), spin))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-14)
    near = np.abs(got.numpy()[len(got) // 2:])
    assert np.median(near) < 1e-3 < np.median(np.abs(got.numpy()[:len(got) // 2]))


def _build_host_lib(out_dir):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the host march")
    out = out_dir / "libmarch_host.so"
    cmd = [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
           "-o", str(out), str(march_kernel.CSRC / "march_host.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out))
    lib.rt_march_host.argtypes = march_kernel.argtypes(host=True)
    lib.rt_march_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build_host_lib(tmp_path_factory.mktemp("launch_order_host"))


def _case(kind, dtype):
    """(rays, spin, destination, march keywords), the batch cut to a
    multiple of 5 rays: the 0.1 x 0.2 lamppost grid (630 rays) towards
    ThetaLimit; image-plane rays (dist 500, incl 60, 41 x 41) towards
    DiscWithISCO, and at incl 30 (21 x 21) towards FlatPlane, marched with
    the spin -SPIN; and a spin-0.3 lamppost towards SphericalShell with the
    boundary at r = 2.5 (tests/test_torch_march_host.py's caustic cases)."""
    if kind == "theta":
        grid = PointSourceGrid.from_steps(0.1, 0.2)
        rays, spin, dest, kw = (point_source(SOURCE, 0.0, SPIN, grid, device="cpu"), SPIN,
                                ThetaLimit(), dict(r_max=1000.0))
    elif kind == "isco":
        grid = ImagePlaneGrid.from_steps(-20.0, 20.0, 1.0, -20.0, 20.0, 1.0)
        rays, spin, dest, kw = (image_plane(500.0, 60.0, grid, SPIN, device="cpu", dtype=dtype),
                                -SPIN, DiscWithISCO(isco_radius(SPIN), 20.0), dict(r_max=550.0))
    elif kind == "plane":
        grid = ImagePlaneGrid.from_steps(-10.0, 10.0, 1.0, -10.0, 10.0, 1.0)
        rays, spin, dest, kw = (image_plane(500.0, 30.0, grid, SPIN, device="cpu", dtype=dtype),
                                -SPIN, FlatPlane(math.radians(30.0), 0.2, 200.0),
                                dict(r_max=800.0))
    else:
        grid = PointSourceGrid.from_steps(0.1, 0.2, -0.9, 0.9, -3.0, 3.0)
        rays, spin, dest, kw = (point_source((0.0, 5.0, 1e-3, 0.0), 0.0, 0.3, grid, device="cpu"),
                                0.3, SphericalShell(40.0), dict(r_max=300.0, boundary=2.5))
    return rays[:rays.n_rays // 5 * 5].to(dtype=dtype), spin, dest, kw


def _host_march(lib, rays, spin, dest, dtype, r_max, boundary=None):
    """trace_kernel's path (prepare, one launch, finish) with the host
    build in place of the launch."""
    prepared, dest, buf, scalars = march_kernel.prepare(
        rays, spin, method="rk45", dest=dest, r_max=r_max, steplim=3000, ctrl=StepControl(),
        boundary=boundary, march_dtype=dtype)
    assert lib.rt_march_host(*march_kernel.pointers(buf), *scalars, 0, None) == 0
    return march_kernel.finish(prepared, buf, dest, spin, refine_crossing=True)


def _assert_same_bits(a, b):
    for f in FIELDS:
        x, y = getattr(a, f).numpy(), getattr(b, f).numpy()
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), f


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["theta", "isco", "plane", "shell"])
def test_ordered_host_march_equals_natural(host_lib, kind, dtype):
    """A RK45 batch gathered into the caustic map's range-major order (the
    batch read as 5-slot bundles, split into 7 pixel ranges), marched by
    the host build of the kernel's step as trace_kernel marches it and
    gathered back gives the natural order's result in all 21 fields, bit
    for bit; so does the order's inverse."""
    rays, spin, dest, kw = _case(kind, dtype)
    bounds = caustics._range_bounds(rays.n_rays // 5, 7)
    perm = caustics._range_major(bounds, 5, "cpu")
    assert not torch.equal(perm, torch.arange(rays.n_rays))
    natural = _host_march(host_lib, rays, spin, dest, dtype, **kw)
    assert int((natural.status & 1).sum()) > 100
    inverse = torch.argsort(perm)
    for order, back in ((perm, inverse), (inverse, perm)):
        _assert_same_bits(_host_march(host_lib, rays[order], spin, dest, dtype, **kw)[back],
                          natural)


def test_score_recall_on_a_shadow_edge_grid():
    """The score against the rays that march longest, on a camera grid
    across the shadow edge of the disc-image geometry (dist 1e4, incl 80,
    DiscWithISCO(r_isco, 30), r_max 1.1e4, spin -0.998 marched; 23 x 18
    rays at 0.7 over x in [-7.7, 7.7], y in [-5.95, 5.95]): the plain
    float64 RK45 march at steplim 1e4. The 5% of the grid that marches
    longest are rays inside the shadow that fall through the horizon,
    slowed by the shrinking step near it, not those nearest the critical
    curve: the 20% of the grid with the smallest |score| holds under half
    of them (none, measured: recall 0.0), as on the card's full-width
    batches (PERF.md)."""
    grid = ImagePlaneGrid.from_steps(-7.7, 7.7, 0.7, -5.95, 5.95, 0.7)
    rays = redshift_start(image_plane(1e4, 80.0, grid, SPIN, device="cpu"), -SPIN, 0.0,
                          reverse=True)
    out = trace(rays, -SPIN, method="rk45", dest=DiscWithISCO(isco_radius(SPIN), 30.0),
                r_max=1.1e4, steplim=10_000)
    steps = out.steps.abs().numpy()
    n = rays.n_rays
    tail = steps > np.sort(steps)[math.ceil(0.95 * n) - 1]
    assert tail.sum() > 0
    a = diff.separatrix_score(rays.k, rays.h, rays.Q, -SPIN).abs().numpy()
    top = np.argsort(a, kind="stable")[:math.ceil(0.2 * n)]
    assert tail[top].sum() / tail.sum() < 0.5


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the march kernel has no CPU build")


@pytest.fixture(scope="module")
def trace_lib(tmp_path_factory):
    """The launch-trace side build of csrc/march.cu, as chip_smoke.py
    phase 1 makes it."""
    _need_card()
    out = tmp_path_factory.mktemp("launch_trace") / chip_smoke.TRACE_LIB
    cmd = march_kernel.nvcc_command(march_kernel.CSRC / "march.cu", out,
                                    defines=("RT_LAUNCH_TRACE",))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return chip_smoke.open_trace_library(out)


@pytest.mark.cuda
def test_launcher_keeps_the_natural_order_on_cuda(trace_lib):
    """The long-first order was tried and not taken (its score does not
    find the rays that outlive the bulk): ``trace_kernel`` launches the
    float32 RK45 kernel once, on the batch as it comes, here the bench
    workload's lamppost (0.01 grid, 125,800 rays). The launch-trace side
    build marches it to the same bits in all 21 fields, recording a start
    and a store time for every ray."""
    rays = point_source(SOURCE, 0.0, SPIN, PointSourceGrid.from_steps(0.01, 0.01),
                        device="cuda").to(dtype=torch.float32)
    kw = dict(method="rk45", steplim=3000, march_dtype=torch.float32)
    before = march_kernel.launches
    out = march_kernel.trace_kernel(rays, SPIN, **kw)
    assert march_kernel.launches == before + 1
    longest = torch.argsort(out.steps.abs(), descending=True, stable=True)[:64]
    tables, _, traced = chip_smoke.launch_trace(trace_lib, rays, SPIN, kw, longest, torch)
    assert march_kernel.launches == before + 1
    assert not chip_smoke.same_bits(traced, out, torch)
    assert (tables["start"] > 0).all() and (tables["stop"] >= tables["start"]).all()
