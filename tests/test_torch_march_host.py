"""The CUDA kernel's step logic, compiled for the host with g++.

``raytrace_tpu_torch/csrc/march.cuh`` holds the per-ray march that the CUDA
kernel runs per thread; ``csrc/march_host.cpp`` runs the same function ray
after ray. Built here with g++ (no FMA contraction) and driven through the
kernel wrapper's own argument packing, it must agree with the plain torch
march in f64 under the tests/test_native.py gates on the golden 0.05 grid.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.ops import march_kernel, trace  # noqa: E402
from raytrace_tpu_torch.ops.integrate import StepControl  # noqa: E402
from raytrace_tpu_torch.sources import PointSourceGrid, point_source  # noqa: E402

SPIN = 0.998
SOURCE = (0.0, 5.0, 1e-3, 1.5707)
STEPLIM = 3000


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


def host_trace(lib, rays, spin, method, steplim, dtype=torch.float64):
    """trace_kernel's path with the host build in place of the launch."""
    prepared, dest, buf, scalars = march_kernel.prepare(
        rays, spin, method=method, dest=None, r_max=1000.0, steplim=steplim,
        ctrl=StepControl(), boundary=None, march_dtype=dtype)
    assert lib.rt_march_host(*march_kernel.pointers(buf), *scalars) == 0
    return march_kernel.finish(prepared, buf, dest, spin, refine_crossing=True)


@pytest.fixture(scope="module")
def golden_rays():
    return point_source(SOURCE, 0.0, SPIN, PointSourceGrid.from_steps(0.05, 0.05), device="cpu")


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
