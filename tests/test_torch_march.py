"""The port's geodesic march against the JAX package.

The plain lock-step march (ops/integrate.py::trace) is held against JAX
``trace`` in f64 on the golden 0.05 grid (5,040 rays), and against the
Pallas TPU kernel ``trace_pallas`` run in interpret mode in f32 on the 0.1
grid (1,260 rays, one 4,096-ray block); the image-plane slice's variants
are held the same way in tests/test_torch_march_image.py. The CUDA kernel
(trace_kernel) is held against the plain march on the card only.

Gates are count-based, as tests/test_native.py:22-36: photon-sphere
separatrix rays are chaotic, so an ulp of difference in sin/cos between two
libraries changes the path of a few of them.

The JAX package is imported inside the tests that use it, so that the card
test runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_march.py
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.destinations import Destination, DiscWithISCO, FlatPlane  # noqa: E402
from raytrace_tpu_torch.destinations import SphericalShell, ThetaLimit  # noqa: E402
from raytrace_tpu_torch.geometry import isco_radius  # noqa: E402
from raytrace_tpu_torch.ops import march_kernel, trace  # noqa: E402
from raytrace_tpu_torch.rays import from_numpy, to_numpy  # noqa: E402
from raytrace_tpu_torch.sources import PointSourceGrid as PortGrid  # noqa: E402
from raytrace_tpu_torch.sources import point_source as port_point_source  # noqa: E402

SPIN = 0.998
SOURCE = (0.0, 5.0, 1e-3, 1.5707)
STEPLIM = 3000
R_DISC = 20.0


def _numpy_batch(rays):
    return {f: np.asarray(getattr(rays, f)) for f in rays.__dataclass_fields__}


def _assert_agree(live, a, b, med_dr=1e-10, status_rate=0.99, steps_rate=0.99,
                  relative=False):
    """Statuses equal on > status_rate of live rays, step counts equal on
    > steps_rate of the equal-status ones, and the median |dr| (or |dr|/r)
    over them below med_dr."""
    sa, sb = np.asarray(a["status"]), np.asarray(b["status"])
    assert (sa == sb)[live].mean() > status_rate
    same = (sa == sb) & live
    dr = np.abs(np.asarray(a["r"], np.float64) - np.asarray(b["r"], np.float64))[same]
    if relative:
        dr = dr / np.abs(np.asarray(a["r"], np.float64))[same]
    assert np.median(dr) < med_dr
    assert (np.asarray(a["steps"])[same] == np.asarray(b["steps"])[same]).mean() > steps_rate


def _jax_source(step):
    from raytrace_tpu.sources import PointSourceGrid, point_source

    return point_source(SOURCE, V=0.0, spin=SPIN, grid=PointSourceGrid.from_steps(step, step))


def _port_source(step, spin=SPIN):
    return port_point_source(SOURCE, 0.0, spin, PortGrid.from_steps(step, step), device="cpu")


@pytest.fixture(scope="module")
def golden_grid():
    rays = _jax_source(0.05)
    return rays, _numpy_batch(rays)


@pytest.mark.parametrize("method", ["rk4", "rk45"])
def test_plain_march_matches_jax_f64(golden_grid, method):
    from raytrace_tpu.ops import trace as jax_trace

    jrays, d = golden_grid
    a = _numpy_batch(jax_trace(jrays, SPIN, method=method, steplim=STEPLIM))
    b = trace(from_numpy(d, device="cpu"), SPIN, method=method, steplim=STEPLIM)
    b = {f: getattr(b, f).numpy() for f in ("status", "r", "steps", "dt")}
    live = d["steps"] == 0
    _assert_agree(live, a, b)
    if method == "rk45":  # the carried adaptive step is resume state
        same = (a["status"] == b["status"]) & live
        assert np.median(np.abs(a["dt"] - b["dt"])[same]) < 1e-10


@pytest.fixture
def _interpret_pallas(monkeypatch):
    """Run the Pallas kernel in interpret mode, as tests/test_pallas.py does."""
    import raytrace_tpu.ops.pallas_kernel as pk

    real_call = pk.pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return real_call(*args, **kw)

    monkeypatch.setattr(pk.pl, "pallas_call", interp)


@pytest.mark.parametrize("method", ["rk4", "rk45"])
def test_plain_march_matches_pallas_kernel_f32(_interpret_pallas, method):
    """f32 on both sides, the spin rounded to f32 once for both.

    XLA's compiled f32 code does not round like op-by-op evaluation (on
    this grid jitted and eager ``geodesic_rates`` differ bitwise in about
    half of all evaluations, in JAX itself), so the two f32 marches agree
    only to f32 noise. RK4: statuses equal on > 99% of live rays, steps on
    > 98% (measured 98.97%), median |dr| < 1e-4 (measured 3.6e-7). RK45 at
    rk45_tol = 1e-8, below f32's resolution, takes its accept/reject
    decisions on rounding noise: the Pallas kernel's own f32 march keeps
    the f64 step count on only ~56% of rays. There the gate is statuses
    equal on > 99% and positions no further from the Pallas kernel than
    the Pallas kernel is from the f64 march (twice its median |dr|).
    """
    import jax.numpy as jnp

    import raytrace_tpu.ops.pallas_kernel as pk
    from raytrace_tpu.ops import trace as jax_trace

    rays = _jax_source(0.1)
    d = _numpy_batch(rays)
    d32 = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in d.items()}
    spin32 = np.float32(SPIN)
    jr = type(rays)(**{k: jnp.asarray(v) for k, v in d32.items()})
    a = _numpy_batch(pk.trace_pallas(jr, jnp.float32(spin32), method=method, steplim=STEPLIM))
    b = trace(from_numpy(d32, device="cpu", dtype=torch.float32), float(spin32),
              method=method, steplim=STEPLIM)
    assert b.r.dtype == torch.float32
    b = {f: getattr(b, f).numpy() for f in ("status", "r", "steps")}
    live = d["steps"] == 0
    if method == "rk4":
        _assert_agree(live, a, b, med_dr=1e-4, steps_rate=0.98)
        return
    ref = _numpy_batch(jax_trace(rays, SPIN, method=method, steplim=STEPLIM))
    assert (a["status"] == b["status"])[live].mean() > 0.99
    same = (a["status"] == b["status"]) & (a["status"] == ref["status"]) & live
    noise = np.median(np.abs(a["r"] - ref["r"])[same])
    assert np.median(np.abs(a["r"] - b["r"])[same]) < 2 * noise


def test_trace_kernel_refuses_cpu_tensors():
    rays = _port_source(0.4)
    before = march_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        march_kernel.trace_kernel(rays, SPIN)
    assert march_kernel.launches == before


@pytest.mark.parametrize(
    "kw, exc",
    [
        (dict(method="euler", dest=Destination()), NotImplementedError),
        (dict(dest=object()), NotImplementedError),
        (dict(march_dtype=torch.float16), TypeError),
        (dict(method="dopri"), NotImplementedError),
        (dict(dest=DiscWithISCO(1.2), march_dtype=torch.int32), TypeError),
    ],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(kw, exc):
    rays = _port_source(0.4)
    args = dict(method="rk4", dest=None, r_max=1000.0, steplim=100,
                ctrl=march_kernel.StepControl(), boundary=None, march_dtype=torch.float32)
    args.update(kw)
    with pytest.raises(exc):
        march_kernel.prepare(rays, SPIN, **args)


def test_kernel_wrapper_buffers_follow_launch_order():
    """prepare() hands the kernel fresh contiguous buffers in the order of
    rt_march_launch's arguments, in the march dtype, and leaves the caller's
    batch untouched."""
    rays = _port_source(0.4)
    r_before = rays.r.clone()
    _, dest, buf, scalars = march_kernel.prepare(
        rays, SPIN, method="rk45", dest=None, r_max=1000.0, steplim=100,
        ctrl=march_kernel.StepControl(), boundary=None, march_dtype=torch.float32)
    names = march_kernel.F_FIELDS + march_kernel.I_FIELDS + march_kernel.B_FIELDS
    assert len(names) == 21 and list(buf) == list(names)
    assert all(buf[f].is_contiguous() for f in names)
    assert all(buf[f].dtype == torch.float32 for f in march_kernel.F_FIELDS)
    assert all(buf[f].dtype == torch.int32 for f in march_kernel.I_FIELDS)
    assert all(buf[f].dtype == torch.bool for f in march_kernel.B_FIELDS)
    # then the schedule, the counter and the stream
    assert len(scalars) + 21 + 3 == len(march_kernel.argtypes())
    assert isinstance(dest, ThetaLimit) and scalars[4:9] == [0, np.pi / 2, 0.0, 0.0, 0.0]
    assert scalars[10] == 100 + 25 + 16
    assert torch.equal(rays.r, r_before)
    assert (buf["dt"] > 0).all()  # rk45 step seeded


@pytest.mark.parametrize("method", ["euler", "rk4", "rk45"])
def test_kernel_wrapper_destination_arguments(method):
    """The destination code and its four parameters, in the launch order
    (r_isco, r_out, theta_lim for DiscWithISCO; sin incl, cos incl, phi0,
    z_s for FlatPlane; r_shell for SphericalShell), as Python floats that
    the kernel rounds once to the march dtype; every method takes every
    destination."""
    rays = _port_source(0.4)
    kw = dict(method=method, r_max=1000.0, steplim=100, ctrl=march_kernel.StepControl(),
              boundary=None, march_dtype=torch.float32)
    _, _, _, scalars = march_kernel.prepare(rays, SPIN, dest=ThetaLimit(-1.4), **kw)
    assert scalars[4:9] == [0, -1.4, 0.0, 0.0, 0.0]
    assert scalars[-2] == {"rk4": 1, "rk45": 2, "euler": 3}[method]
    isco = DiscWithISCO(isco_radius(SPIN), R_DISC)
    _, dest, _, scalars = march_kernel.prepare(rays, SPIN, dest=isco, **kw)
    assert dest is isco and scalars[4:9] == [1, isco_radius(SPIN), R_DISC, np.pi / 2, 0.0]
    plane = FlatPlane(1.3, 0.2, 500.0)
    _, _, _, scalars = march_kernel.prepare(rays, SPIN, dest=plane, **kw)
    assert scalars[4:9] == [2, plane.sin_incl, plane.cos_incl, 0.2, 500.0]
    assert plane.sin_incl == math.sin(1.3) and plane.cos_incl == math.cos(1.3)
    _, _, _, scalars = march_kernel.prepare(rays, SPIN, dest=SphericalShell(40.0), **kw)
    assert scalars[4:9] == [3, 40.0, 0.0, 0.0, 0.0]


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["rk4", "rk45"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_trace_kernel_matches_plain_march_on_cuda(method, dtype):
    """The CUDA kernel against the plain march, both on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the march kernel has no CPU build")
    dt = getattr(torch, dtype)
    spin = float(np.float32(SPIN)) if dt == torch.float32 else SPIN
    d = to_numpy(_port_source(0.05, spin))
    rays = from_numpy(d, device="cuda", dtype=dt)
    before = march_kernel.launches
    a = march_kernel.trace_kernel(rays, spin, method=method, steplim=STEPLIM, march_dtype=dt)
    torch.cuda.synchronize()
    assert march_kernel.launches == before + 1
    b = trace(rays, spin, method=method, steplim=STEPLIM)
    a = {f: getattr(a, f).cpu().numpy() for f in ("status", "r", "steps")}
    b = {f: getattr(b, f).cpu().numpy() for f in ("status", "r", "steps")}
    live = d["steps"] == 0
    if dt == torch.float64:
        _assert_agree(live, a, b)
    else:
        _assert_agree(live, a, b, med_dr=1e-5, status_rate=0.98, steps_rate=0.98,
                      relative=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", ["euler", "rk4", "rk45"])
def test_kernel_schedules(method, dtype):
    """The float64 RK45 DiscWithISCO kernel runs the lane-refill schedule,
    every other instantiation the grid launch."""
    for dest in (ThetaLimit(), DiscWithISCO(1.2, R_DISC), FlatPlane(0.5, 0.0, 500.0),
                 SphericalShell(40.0)):
        refilled = (method == "rk45" and dtype == torch.float64
                    and isinstance(dest, DiscWithISCO))
        assert march_kernel.schedule_of(method, dest, dtype) == (
            "refill" if refilled else "grid")


@pytest.mark.cuda
def test_refill_schedule_matches_grid_launch_on_cuda():
    """The float64 RK45 DiscWithISCO kernel under the lane-refill schedule
    gives every field of the grid launch's result bit for bit on the bench
    grid (125,800 rays against the 67,584 lanes resident at 4 blocks of 128
    an SM, so warps take rays more than once), launch after launch, with
    the counter fresh for every launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the march kernel has no CPU build")
    rays = from_numpy(to_numpy(_port_source(0.01)), device="cuda")
    kw = dict(dest=DiscWithISCO(isco_radius(SPIN), R_DISC), method="rk45", steplim=STEPLIM,
              march_dtype=torch.float64, refine_crossing=False, ctrl=march_kernel.StepControl(),
              boundary=None, r_max=1000.0)
    grid = march_kernel._trace(rays, SPIN, "grid", **kw)
    assert int((grid.status & 1).sum()) > 100
    for launch in range(2):
        refill = march_kernel._trace(rays, SPIN, "refill", **kw)
        for f in march_kernel.F_FIELDS + march_kernel.I_FIELDS + march_kernel.B_FIELDS:
            a, b = getattr(refill, f).cpu().numpy(), getattr(grid, f).cpu().numpy()
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (f, launch)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["euler", "rk4", "rk45"])
def test_plain_march_graph_replay_matches_eager_on_cuda(monkeypatch, method):
    """The plain march replaying each compaction epoch's iteration as a CUDA
    graph gives every field of the eager march's result bitwise, over three
    epochs (steplim 600, compaction every 256 iterations)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU version")
    from raytrace_tpu_torch.ops import integrate

    rays = from_numpy(to_numpy(_port_source(0.05)), device="cuda", dtype=torch.float32)
    graphed = trace(rays, SPIN, method=method, steplim=600)
    monkeypatch.setattr(integrate, "_CUDA_GRAPHS", False)
    eager = trace(rays, SPIN, method=method, steplim=600)
    assert int((graphed.steps.abs() > 256).sum()) > 100
    for f in rays.__dataclass_fields__:
        a, b = getattr(graphed, f).cpu().numpy(), getattr(eager, f).cpu().numpy()
        np.testing.assert_array_equal(a, b, err_msg=f)


POW_PROBE = r"""
#include <cuda_runtime.h>
#include <math.h>
__global__ void pow_kernel(const double* x, double* out, long n) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = pow(x[i], 0.2);
}
extern "C" int pow_launch(const double* x, double* out, long n) {
  pow_kernel<<<(n + 255) / 256, 256>>>(x, out, n);
  return (int)cudaDeviceSynchronize();
}
"""


@pytest.mark.cuda
def test_double_pow_rounding_follows_fma_contraction_on_cuda(tmp_path):
    """Why about one float64 RK45 ray in 10^6 ends near, not on, the plain
    march's bits: the CUDA math library's double pow(x, 0.2), taken once a
    DOPRI5 step, is inlined into its caller and compiled under the caller's
    flags. Built with nvcc's default contraction, as torch builds its
    kernels, it gives torch.pow's bits on every one of 2e7 log-uniform
    inputs; built as the march kernel is built (--fmad=false) it may be an
    ulp apart on a few in a million."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    import ctypes
    import subprocess

    n = 20_000_000
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.exp(torch.empty(n, dtype=torch.float64, device="cuda").uniform_(-23.0, 23.0,
                                                                            generator=gen))
    want = torch.pow(x, 0.2)
    src = tmp_path / "pow_probe.cu"
    src.write_text(POW_PROBE)
    differ = {}
    for fmad in ("true", "false"):
        lib_path = tmp_path / f"pow_{fmad}.so"
        subprocess.run([march_kernel._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        f"--fmad={fmad}", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path),
                        str(src)], check=True)
        lib = ctypes.CDLL(str(lib_path))
        lib.pow_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
        out = torch.empty_like(x)
        assert lib.pow_launch(x.data_ptr(), out.data_ptr(), n) == 0
        differ[fmad] = int((out != want).sum())
    print(f"double pow(x, 0.2) against torch.pow, {n} inputs: {differ['true']} differ built "
          f"with --fmad=true, {differ['false']} with --fmad=false")
    assert differ["true"] == 0
    assert differ["false"] <= 1e-5 * n
