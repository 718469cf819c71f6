"""The long-first launch order of the float32 RK45 march kernels, tried
and not taken.

The launcher marches every batch in its natural order (slot i holds ray
i) and has no order of its own. chip_smoke.py phase 13 measures the
long-first one beside it: ``chip_smoke.long_first_order`` puts the rays
nearest the photon shell by their separatrix score (``ops.diff.
separatrix_score``; on the card the score kernel of the launch-trace
build, ``chip_smoke.separatrix_scores``) at lane 0 of the first blocks
(or warps), one each, and the rest in the other slots in their natural
order; the batch is gathered into that order, marched, and gathered
back. Held here on the CPU: the order is a permutation of that shape;
the score agrees with JAX's near the photon shell to the tolerance of
tests/test_torch_diff_kerr.py; a batch gathered into the order, marched
by the host build of the kernel's march (``march_host.cpp``, as
tests/test_torch_march_host.py builds it) and gathered back gives the
natural order's bits in all 21 fields; and on a camera strip across the
critical curve of the disc-image geometry the score's head misses the
rays that march longest (the finding that stopped the order). The
card's tests (the score kernel against its plain version, the long-first
launch against the natural one, the launcher's library without the
score) are marked ``cuda``:

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
from raytrace_tpu_torch.destinations import DiscWithISCO, ThetaLimit  # noqa: E402
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


@pytest.mark.parametrize("placement", ["warp", "block"])
@pytest.mark.parametrize("n_long", [0, 1, 7, 40, 10_000])
def test_long_first_order_is_a_permutation_with_the_head_it_names(placement, n_long):
    """``chip_smoke.long_first_order`` is a permutation, and ``inverse``
    undoes it. Its head is the min(n_long, ceil(n / stride)) live rays of
    smallest |score| (stride 32 a warp, 128 a block; so never more than
    n / 32), one a slot at 0, stride, 2 stride, ..., in their natural
    order; no dead ray and no NaN score is in it, and every other ray
    fills the other slots in its natural order."""
    n = 1237
    k, h, Q = (torch.from_numpy(x) for x in _constants(SPIN, n, seed=11))
    k[5] = float("nan")  # a NaN score
    live = torch.ones(n, dtype=torch.bool)
    live[::9] = False
    score = diff.separatrix_score(k, h, Q, SPIN)
    perm = chip_smoke.long_first_order(score, live, n_long, placement, torch)
    assert perm.dtype == torch.int64 and torch.equal(torch.sort(perm).values, torch.arange(n))
    x = torch.arange(n, dtype=torch.float64) * 3.0
    assert torch.equal(x[perm][chip_smoke.inverse(perm, torch)], x)

    stride = chip_smoke.PLACEMENT_STRIDE[placement]
    head_len = min(n_long, -(-n // stride))
    assert head_len <= -(-n // 32)
    a = torch.where(live & ~torch.isnan(score), score.abs(), math.inf)
    want = torch.sort(torch.argsort(a, stable=True)[:head_len]).values
    head_slots = torch.arange(head_len) * stride
    assert torch.equal(perm[head_slots], want)
    assert not bool((~live[perm[head_slots]]).any()) and 5 not in perm[head_slots].tolist()
    rest = torch.ones(n, dtype=torch.bool)
    rest[head_slots] = False
    assert bool((torch.diff(perm[rest]) > 0).all())


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
    """(rays, spin, destination, r_max): the 0.1 x 0.2 lamppost grid (630
    rays) towards ThetaLimit, and image-plane rays (dist 500, incl 60, 41 x
    41) towards DiscWithISCO, marched with the spin -SPIN."""
    if kind == "theta":
        rays = point_source(SOURCE, 0.0, SPIN, PointSourceGrid.from_steps(0.1, 0.2), device="cpu")
        return rays.to(dtype=dtype), SPIN, ThetaLimit(), 1000.0
    grid = ImagePlaneGrid.from_steps(-20.0, 20.0, 1.0, -20.0, 20.0, 1.0)
    rays = image_plane(500.0, 60.0, grid, SPIN, device="cpu", dtype=dtype)
    return rays, -SPIN, DiscWithISCO(isco_radius(SPIN), 20.0), 550.0


def _host_march(lib, rays, spin, dest, r_max, dtype):
    """trace_kernel's path (prepare, one launch, finish) with the host
    build in place of the launch."""
    prepared, dest, buf, scalars = march_kernel.prepare(
        rays, spin, method="rk45", dest=dest, r_max=r_max, steplim=3000, ctrl=StepControl(),
        boundary=None, march_dtype=dtype)
    assert lib.rt_march_host(*march_kernel.pointers(buf), *scalars, 0, None) == 0
    return march_kernel.finish(prepared, buf, dest, spin, refine_crossing=True)


def _assert_same_bits(a, b):
    for f in FIELDS:
        x, y = getattr(a, f).numpy(), getattr(b, f).numpy()
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), f


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["theta", "isco"])
def test_ordered_host_march_equals_natural(host_lib, kind, dtype):
    """A RK45 batch gathered into a long-first order (a head of n / 40
    rays, one a warp), marched by the host build of the kernel's step as
    trace_kernel marches it and gathered back gives the natural order's
    result in all 21 fields, bit for bit; so does the order's inverse.
    This is what phase 13's turns hold on the card."""
    rays, spin, dest, r_max = _case(kind, dtype)
    score = diff.separatrix_score(rays.k.double(), rays.h.double(), rays.Q.double(), spin)
    perm = chip_smoke.long_first_order(score, rays.active, rays.n_rays // 40, "warp", torch)
    assert not torch.equal(perm, torch.arange(rays.n_rays))
    natural = _host_march(host_lib, rays, spin, dest, r_max, dtype)
    assert int((natural.status & 1).sum()) > 100
    inverse = chip_smoke.inverse(perm, torch)
    for order, back in ((perm, inverse), (inverse, perm)):
        _assert_same_bits(_host_march(host_lib, rays[order], spin, dest, r_max, dtype)[back],
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
        pytest.skip("needs an NVIDIA GPU: the score kernel and the march kernel have no CPU build")


@pytest.fixture(scope="module")
def trace_lib(tmp_path_factory):
    """The launch-trace side build of csrc/march.cu, as chip_smoke.py
    phase 1 makes it, with the score kernel."""
    _need_card()
    out = tmp_path_factory.mktemp("launch_trace") / chip_smoke.TRACE_LIB
    cmd = march_kernel.nvcc_command(march_kernel.CSRC / "march.cu", out,
                                    defines=("RT_LAUNCH_TRACE",))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return chip_smoke.open_trace_library(out)


def _bench_rays(dtype):
    """The bench workload's lamppost (0.01 grid, 125,800 rays) on the card."""
    return point_source(SOURCE, 0.0, SPIN, PointSourceGrid.from_steps(0.01, 0.01),
                        device="cuda").to(dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_score_kernel_matches_plain_on_cuda(trace_lib, dtype):
    """The score kernel of the trace build gives the plain version's bits
    (``ops.diff.separatrix_score`` in float64 on the card) on the bench
    grid's constants, float32 and float64, one launch counted."""
    rays = _bench_rays(dtype)
    before = chip_smoke.SCORE["launches"]
    got = chip_smoke.separatrix_scores(trace_lib, rays.k, rays.h, rays.Q, SPIN, torch)
    assert chip_smoke.SCORE["launches"] == before + 1
    want = diff.separatrix_score(rays.k.double(), rays.h.double(), rays.Q.double(), SPIN)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


def _assert_same_bits_cuda(a, b):
    for f in FIELDS:
        x, y = getattr(a, f).cpu().numpy(), getattr(b, f).cpu().numpy()
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), f


def _orders_agree(rays, spin, kw):
    """The batch gathered into the long-first order (a head of 0.1% of it,
    one a block), marched by trace_kernel (one launch) and gathered back,
    against the natural launch: all 21 fields bit for bit. Returns the
    natural result."""
    kw = dict(kw, method="rk45", march_dtype=torch.float32)
    natural = march_kernel.trace_kernel(rays, spin, **kw)
    score = diff.separatrix_score(rays.k.double(), rays.h.double(), rays.Q.double(), spin)
    perm = chip_smoke.long_first_order(score, rays.active, math.ceil(1e-3 * rays.n_rays),
                                       "block", torch)
    before = march_kernel.launches
    long_first = march_kernel.trace_kernel(rays[perm], spin, **kw)
    assert march_kernel.launches == before + 1
    _assert_same_bits_cuda(long_first[chip_smoke.inverse(perm, torch)], natural)
    return natural


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["theta", "isco"])
def test_long_first_launch_matches_natural_on_cuda(kind):
    """Both float32 RK45 kernels (ThetaLimit, DiscWithISCO) give the
    natural launch's result in all 21 fields, bit for bit, in the
    long-first order: on the bench grid (125,800 rays, steplim 40,000), and
    on a crop of the disc-image batch (par_example/imageplane_disc_image.par:
    1001 x 1001 rays over +-30 at dist 1e4, incl 80) holding its rays that
    stick at steplim 1e5 and their neighbours two rows and columns about."""
    _need_card()
    dest = DiscWithISCO(isco_radius(SPIN), 20.0) if kind == "isco" else ThetaLimit()
    _orders_agree(_bench_rays(torch.float32), SPIN, dict(dest=dest, r_max=1000.0,
                                                          steplim=40_000))
    n = 1001
    grid = ImagePlaneGrid.from_steps(-30.0, 30.0, 60.0 / 1000, -30.0, 30.0, 60.0 / 1000)
    rays = image_plane(1e4, 80.0, grid, SPIN, device="cuda", work_dtype=torch.float32)
    rays = redshift_start(rays, -SPIN, 0.0, reverse=True).to(dtype=torch.float32)
    kw = dict(dest=DiscWithISCO(isco_radius(SPIN), 30.0) if kind == "isco" else ThetaLimit(),
              r_max=1.1e4, steplim=100_000)
    full = march_kernel.trace_kernel(rays, -SPIN, method="rk45", march_dtype=torch.float32, **kw)
    stuck = torch.nonzero((full.status & 8) != 0).flatten()
    assert len(stuck) > 0
    near = (stuck[:, None] + (torch.arange(-2, 3, device=stuck.device)[:, None] * n
                              + torch.arange(-2, 3, device=stuck.device)).flatten()).flatten()
    crop = torch.unique(near.clamp(0, n * n - 1))
    out = _orders_agree(rays[crop], -SPIN, kw)
    assert int(((out.status & 8) != 0).sum()) == len(stuck)


@pytest.mark.cuda
def test_launcher_keeps_the_natural_order_on_cuda(trace_lib):
    """The long-first order was tried and not taken (its score does not
    find the rays that outlive the bulk): ``trace_kernel`` launches the
    float32 RK45 kernel once, and the launcher's library has no score
    kernel; only the trace build has it."""
    rays = _bench_rays(torch.float32)
    before = march_kernel.launches
    march_kernel.trace_kernel(rays, SPIN, method="rk45", steplim=3000)
    assert march_kernel.launches == before + 1
    assert not hasattr(march_kernel.load(), "rt_separatrix_score")
    assert hasattr(trace_lib, "rt_separatrix_score")
