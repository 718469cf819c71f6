"""The resumable march of the port: ``trace(max_iters=..., resume=True)``
against the JAX package's, the suspended-and-resumed march against the
uninterrupted one, the phased march with its progress bar
(``trace_compacted(progress=True)``) and ``trace_auto``'s phased routes.

The rays are tests/test_capabilities.py's ``TestCheckpoint`` batch: the
lamppost at h 5 on the 0.4 x 0.8 grid (40 rays), RK4, r_max 200, steplim
8000, suspended after 150 iterations. On the CPU the plain march marches;
the march kernel's counterparts are the cuda-marked tests at the end, run
on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_resume.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch import ops  # noqa: E402
from raytrace_tpu_torch.ops import march_kernel, trace, trace_auto, trace_compacted  # noqa: E402
from raytrace_tpu_torch.rays import from_numpy, to_numpy  # noqa: E402
from raytrace_tpu_torch.sources import PointSourceGrid, point_source  # noqa: E402

SPIN = 0.998
SOURCE = (0.0, 5.0, 1e-3, 0.0)
KW = dict(r_max=200.0, steplim=8000)
SUSPEND = 150


def _rays(step=(0.4, 0.8), device="cpu", source=SOURCE):
    return point_source(source, 0.0, SPIN, PointSourceGrid.from_steps(*step), device=device)


def _bits(a, b):
    """The fields in which two batches differ bit for bit (NaN equal to
    NaN)."""
    bad = []
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if x.is_floating_point():
            same = torch.equal(x.isnan(), y.isnan()) and torch.equal(x[~x.isnan()], y[~y.isnan()])
        else:
            same = torch.equal(x, y)
        if not same:
            bad.append(f)
    return bad


def test_resumed_march_matches_jax():
    """tests/test_capabilities.py::TestCheckpoint for the port: 150
    iterations, then resumed to the end, against JAX's trace(max_iters=150)
    and trace(resume=True) on the same rays. Off the knife edge, statuses
    and step counts are equal on every ray, and r meets the port's rk4
    float64 parity gate against JAX (tests/test_torch_march.py: median
    |dr| < 1e-10; measured median 4.4e-16, max 4.1e-12 over r up to 200,
    the libraries' sin/cos ulps). The 5 rays at beta = -pi start at the
    polar turning point (ROADMAP Queue 3, knife-edge rays): one of them
    ends at the horizon in the port and at r_max in JAX, resumed or not,
    so there each package's resumed status is its own uninterrupted one."""
    from raytrace_tpu.ops import trace as jtrace
    from raytrace_tpu.sources import PointSourceGrid as JGrid
    from raytrace_tpu.sources import point_source as jpoint_source

    jrays = jpoint_source(SOURCE, V=0.0, spin=SPIN, grid=JGrid.from_steps(0.4, 0.8))
    jpart = jtrace(jrays, SPIN, method="rk4", max_iters=SUSPEND, **KW)
    jout = jtrace(jpart, SPIN, method="rk4", resume=True, **KW)
    jfull = jtrace(jrays, SPIN, method="rk4", **KW)

    rays = from_numpy({f: np.asarray(getattr(jrays, f)) for f in jrays.__dataclass_fields__},
                      device="cpu")
    part = trace(rays, SPIN, method="rk4", max_iters=SUSPEND, **KW)
    assert bool(part.active.any()), "nothing left to resume after 150 iterations"
    assert int(part.steps.max()) <= SUSPEND
    out = trace(part, SPIN, method="rk4", resume=True, **KW)
    full = trace(rays, SPIN, method="rk4", **KW)

    edge = np.asarray(jrays.beta) == -np.pi
    assert edge.sum() == 5
    np.testing.assert_array_equal(out.status.numpy()[~edge], np.asarray(jout.status)[~edge])
    np.testing.assert_array_equal(out.steps.numpy()[~edge], np.asarray(jout.steps)[~edge])
    dr = np.abs(out.r.numpy() - np.asarray(jout.r))[~edge]
    assert np.median(dr) < 1e-10 and dr.max() < 1e-11
    np.testing.assert_array_equal(out.status.numpy(), full.status.numpy())
    np.testing.assert_array_equal(np.asarray(jout.status), np.asarray(jfull.status))


# each method's steplim here: RK45 at 2000 keeps its photon-sphere rays
# from holding the lock-step march for 1e4 iterations
STEPLIM = {"euler": 2000, "rk4": 8000, "rk45": 2000}


@pytest.mark.parametrize("method", ["euler", "rk4", "rk45"])
def test_suspended_and_resumed_equals_uninterrupted(method):
    """On the port alone, 150 iterations and a resume give the
    uninterrupted march bit for bit, every field, for Euler, RK4 and RK45:
    the RK45 resume takes its rates afresh from the stored position, and
    they come out the carried rates' bits (measured: no field differs). A
    batch resumed once more, with nothing active, is unchanged."""
    rays = _rays()
    kw = dict(KW, method=method, steplim=STEPLIM[method])
    full = trace(rays, SPIN, **kw)
    part = trace(rays, SPIN, max_iters=SUSPEND, **kw)
    assert bool(part.active.any())
    out = trace(part, SPIN, resume=True, **kw)
    assert _bits(out, full) == []
    assert _bits(trace(out, SPIN, resume=True, **kw), out) == []


def test_stuck_counts_stay_negated_on_resume():
    """A ray stuck at its steplim has its count negated once; resuming the
    batch leaves it so (only a positive count is negated), as JAX."""
    rays = _rays()
    part = trace(rays, SPIN, method="rk4", r_max=200.0, steplim=40)
    stuck = (part.status & 8) != 0
    assert bool(stuck.any()) and bool((part.steps[stuck] == -40).all())
    again = trace(part, SPIN, method="rk4", r_max=200.0, steplim=40, resume=True)
    assert _bits(again, part) == []


@pytest.mark.parametrize("method", ["rk4", "rk45"])
def test_trace_compacted_progress_equals_trace(method, capsys):
    """trace_compacted(progress=True) marches in phases of phase_iters
    resumed iterations with a bar between them and gives trace's bits;
    progress=False is trace itself."""
    rays = _rays()
    kw = dict(KW, method=method, steplim=STEPLIM[method])
    ref = trace(rays, SPIN, **kw)
    capsys.readouterr()
    out = trace_compacted(rays, SPIN, progress=True, phase_iters=100, **kw)
    err = capsys.readouterr().err
    assert _bits(out, ref) == []
    lines = [ln for ln in err.splitlines() if ln.startswith(f"march[{method}] 40 rays:")]
    live = [ln for ln in lines if ln.endswith(" live]")]
    assert len(live) >= 2 and live[-1].endswith("[0 live]") and "100.0%" in lines[-1]
    assert _bits(trace_compacted(rays, SPIN, **kw), ref) == []
    assert capsys.readouterr().err == ""


def test_trace_auto_takes_the_phased_route_under_rt_progress(monkeypatch, capsys):
    """RT_PROGRESS=1 (or progress=True) sends trace_auto's plain route
    through the phased march, counted as "plain_phased"; progress=False
    overrides the environment."""
    rays = _rays()
    ref = trace(rays, SPIN, method="rk4", **KW)
    monkeypatch.setenv("RT_PROGRESS", "1")
    before = dict(ops.routes)
    out = trace_auto(rays, SPIN, method="rk4", **KW)
    assert ops.routes["plain_phased"] == before["plain_phased"] + 1
    assert ops.routes["plain"] == before["plain"]
    assert _bits(out, ref) == []
    assert "march[rk4] 40 rays:" in capsys.readouterr().err
    trace_auto(rays, SPIN, method="rk4", progress=False, **KW)
    assert ops.routes["plain"] == before["plain"] + 1
    monkeypatch.delenv("RT_PROGRESS")
    trace_auto(rays, SPIN, method="rk4", progress=True, **KW)
    assert ops.routes["plain_phased"] == before["plain_phased"] + 2


def test_kernel_wrapper_resume_arguments():
    """prepare keeps the batch's gates and RK45 step with resume=True,
    resets and seeds them otherwise, and puts max_iters (default the
    budget steplim + steplim // 4 + 16) where the launch reads it."""
    rays = _rays()
    part = trace(rays, SPIN, method="rk45", max_iters=SUSPEND, **KW)
    kw = dict(method="rk45", dest=None, r_max=200.0, steplim=8000,
              ctrl=ops.StepControl(), boundary=None, march_dtype=torch.float64)
    fresh, _, buf, scalars = march_kernel.prepare(part, SPIN, **kw)
    assert scalars[march_kernel._MAX_ITERS] == 8000 + 2000 + 16
    assert not bool(fresh.r_was_positive.any()) and bool(fresh.theta_was_positive.all())
    assert not torch.equal(buf["dt"], part.dt)
    resumed, _, buf, scalars = march_kernel.prepare(part, SPIN, resume=True, max_iters=77, **kw)
    assert scalars[march_kernel._MAX_ITERS] == 77
    for f in march_kernel.F_FIELDS + march_kernel.I_FIELDS + march_kernel.B_FIELDS:
        assert torch.equal(buf[f], getattr(part, f)), f


@pytest.mark.parametrize("fn", [march_kernel.trace_kernel, march_kernel.trace_kernel_phased])
def test_kernel_routes_refuse_cpu_tensors(fn):
    with pytest.raises(ValueError, match="CUDA"):
        fn(_rays(), SPIN, method="rk4")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the march kernel has no CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["rk4", "rk45"])
def test_phased_kernel_matches_one_launch_on_cuda(method, capsys):
    """trace_kernel_phased against one trace_kernel launch on the golden
    0.05 grid (5,040 rays, float32 march): RK4 bit for bit in every field;
    RK45 reseeds its rates from the stored position at each boundary,
    where one launch carries them, and must still agree with the phased
    plain march (trace(max_iters, resume=True) over the same boundaries)
    bit for bit. The phased route is counted and launches once a phase."""
    _cuda()
    rays = _rays((0.05, 0.05), device="cuda").to(dtype=torch.float32)
    kw = dict(method=method, steplim=3000)
    one = march_kernel.trace_kernel(rays, SPIN, **kw)
    before = march_kernel.launches
    phased = march_kernel.trace_kernel_phased(rays, SPIN, phase_iters=256, **kw)
    torch.cuda.synchronize()
    n_launch = march_kernel.launches - before
    assert 2 <= n_launch <= -(-(3000 + 750 + 16) // 256)
    assert "live" in capsys.readouterr().err
    if method == "rk4":
        assert _bits(phased, one) == []
    plain = trace_compacted(rays, SPIN, progress=True, phase_iters=256, **kw)
    assert _bits(phased, plain) == []
    before = dict(ops.routes)
    auto = trace_auto(rays, SPIN, progress=True, **kw)
    assert ops.routes["kernel_phased"] == before["kernel_phased"] + 1
    assert _bits(auto, phased) == []


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_resumed_kernel_matches_uninterrupted_on_cuda(method):
    """trace_kernel(max_iters=150), then trace_kernel(resume=True) on the
    float64 batch it returned (float32 march: the casts between are
    exact), gives the uninterrupted launch bit for bit, on the 0.05 grid."""
    _cuda()
    rays = from_numpy(to_numpy(_rays((0.05, 0.05))), device="cuda")
    kw = dict(method=method, steplim=3000)
    full = march_kernel.trace_kernel(rays, SPIN, **kw)
    part = march_kernel.trace_kernel(rays, SPIN, max_iters=SUSPEND, refine_crossing=False, **kw)
    assert bool(part.active.any())
    out = march_kernel.trace_kernel(part, SPIN, resume=True, **kw)
    assert _bits(out, full) == []
