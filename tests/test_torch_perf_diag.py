"""The port's perf harness (apps/perf_test.py) and RK45 reject accounting
(ops/diagnostics.py) against the JAX package.

TestPerfHarness's batch (tests/test_capabilities.py:328): a lamppost at r =
5 on the axis, spin 0.9, the 0.35 x 0.7 direction grid (54 live rays),
r_max 100, float64 on the CPU. Its beta = -pi column (6 rays) launches on
the polar turning point, where the two packages' marches split at machine
epsilon (tests/test_torch_lamppost.py): every other ray must agree exactly,
and those are counted. The reject statistics are compared whole on the
same grid from beta = -3.0, off the knife edge.

The JAX package is imported inside the tests that use it.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.apps import perf_test as port_app  # noqa: E402
from raytrace_tpu_torch.ops import StepControl  # noqa: E402
from raytrace_tpu_torch.ops import diagnostics as port_diag  # noqa: E402
from raytrace_tpu_torch.sources import PointSourceGrid, point_source  # noqa: E402

SPIN = 0.9
SOURCE = (0.0, 5.0, 1e-3, 0.0)


def _batches(*grid):
    from raytrace_tpu.sources import PointSourceGrid as JGrid
    from raytrace_tpu.sources import point_source as jps

    j = jps(SOURCE, 0.0, SPIN, JGrid.from_steps(*grid))
    p = point_source(SOURCE, 0.0, SPIN, PointSourceGrid.from_steps(*grid), device="cpu")
    return j, p


def _knife_edge(p):
    return (p.beta.numpy() == -math.pi) & (p.steps.numpy() == 0)


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_run_method_matches_jax(method):
    """run_method at steplim 5000: ray and stuck counts equal, per-ray step
    counts equal on every ray off the beta = -pi knife edge (and differing
    on at most its 6 rays: measured 5), the step histogram of the same
    steps line for line JAX's, and the statistics ordered."""
    from raytrace_tpu.apps.perf_test import run_method, step_histogram
    from raytrace_tpu.ops import StepControl as JCtrl

    j, p = _batches(0.35, 0.7)
    a = run_method(j, SPIN, method, r_max=100.0, steplim=5000, ctrl=JCtrl())
    b = port_app.run_method(p, SPIN, method, r_max=100.0, steplim=5000, ctrl=StepControl())
    for k in ("method", "n_rays", "n_stuck"):
        assert b[k] == a[k], k
    edge = _knife_edge(p)[p.steps.numpy() >= 0]
    assert edge.sum() == 6
    np.testing.assert_array_equal(b["steps"][~edge], a["steps"][~edge])
    assert (b["steps"][edge] != a["steps"][edge]).sum() <= 6
    assert port_app.step_histogram(a["steps"]) == step_histogram(a["steps"])
    assert b["median"] <= b["p90"] <= b["p99"] <= b["max"]
    assert b["steps_total"] == b["steps"].sum() and b["fevals"] == b["steps_total"] * {
        "euler": 1, "rk4": 4}[method]
    assert b["wall_s"] > 0


def test_step_histogram_matches_jax():
    """The ASCII histogram of random step counts (and of none): equal."""
    from raytrace_tpu.apps.perf_test import step_histogram

    steps = np.random.default_rng(11).integers(0, 40_000, 3000)
    assert port_app.step_histogram(steps) == step_histogram(steps)
    assert port_app.step_histogram(np.zeros(3, np.int64)) == step_histogram(np.zeros(3, np.int64))


def test_march_with_trials_matches_jax():
    """Per-lane trial counts and final steps over 256 lock-step DOPRI5
    iterations (float64): equal on every lane off the beta = -pi knife edge
    (48 of 54; measured: 2 knife-edge lanes differ)."""
    import jax.numpy as jnp

    from raytrace_tpu.ops.diagnostics import _march_with_trials
    from raytrace_tpu.ops.integrate import StepControl as JCtrl

    j, p = _batches(0.35, 0.7)
    jf, jt = _march_with_trials(j, SPIN, jnp.asarray(100.0), 256, JCtrl())
    pf, pt = port_diag._march_with_trials(p, SPIN, 100.0, 256, StepControl())
    edge = _knife_edge(p)
    np.testing.assert_array_equal(pt.numpy()[~edge], np.asarray(jt)[~edge])
    np.testing.assert_array_equal(pf.steps.numpy()[~edge], np.asarray(jf.steps)[~edge])
    np.testing.assert_array_equal(pf.status.numpy()[~edge], np.asarray(jf.status)[~edge])
    assert pt.numpy().max() == 256 and (pt.numpy()[p.steps.numpy() < 0] == 0).all()


@pytest.mark.parametrize("n_steps", [256, 1024])
def test_rk45_reject_stats_match_jax(n_steps):
    """rk45_reject_stats on the grid from beta = -3.0 (no knife edge): the
    same dict as JAX's, lanes, finished lanes, trials and rejects exactly
    and the reject fractions to 1e-4 (they are rounded to 4 places); rejects
    occur."""
    from raytrace_tpu.ops.diagnostics import rk45_reject_stats

    j, p = _batches(0.35, 0.7, -0.995, 0.995, -3.0, 3.4)
    a = rk45_reject_stats(j, SPIN, r_max=100.0, n_steps=n_steps)
    b = port_diag.rk45_reject_stats(p, SPIN, r_max=100.0, n_steps=n_steps)
    assert set(b) == set(a)
    for k in ("n_lanes", "n_finished", "n_unfinished", "trials_total", "rejects_total"):
        assert b[k] == a[k], (k, a, b)
    for k in ("reject_frac_p50", "reject_frac_p90", "reject_frac_p99", "reject_frac_mean"):
        np.testing.assert_allclose(b[k], a[k], atol=1e-4)
    assert b["n_finished"] > 0 and b["rejects_total"] > 0


def test_reject_stats_count_no_trials_for_dead_lanes():
    """Dead (steps = -1) lanes take no trials; a budget too small for any
    lane to finish reports every lane unfinished and NaN fractions."""
    _, p = _batches(0.35, 0.7)
    st = port_diag.rk45_reject_stats(p, SPIN, r_max=100.0, n_steps=16)
    assert st["n_lanes"] == int((p.steps == 0).sum()) and st["n_finished"] == 0
    assert st["trials_total"] == 0 and math.isnan(st["reject_frac_mean"])


@pytest.mark.cuda
def test_plain_float32_trials_march_follows_the_kernel():
    """The reject accounting counts the kernel's own trials on the card: on
    a float32 batch the plain DOPRI5 march of ``_march_with_trials`` ends
    every lane that finishes within its budget with the kernel's status and
    step count (the kernel marches as the plain float32 march does, bit for
    bit), and the harness's run_method goes through the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from raytrace_tpu_torch.ops import march_kernel

    rays = point_source(SOURCE, 0.0, 0.998, PointSourceGrid.from_steps(0.05, 0.05),
                        device="cuda").to(dtype=torch.float32)
    final, trials = port_diag._march_with_trials(rays, 0.998, 1000.0, 8192, StepControl())
    out = march_kernel.trace_kernel(rays, 0.998, method="rk45", steplim=8193)
    live = (rays.steps == 0).cpu().numpy()
    done = ~final.active.cpu().numpy() & live
    assert done.sum() > 0.99 * live.sum()
    for f in ("status", "steps"):
        np.testing.assert_array_equal(getattr(final, f).cpu().numpy()[done],
                                      getattr(out, f).cpu().numpy()[done])
    assert int(trials.max()) <= 8192
    before = march_kernel.launches
    st = port_app.run_method(rays, 0.998, "rk45", r_max=1000.0, steplim=30_000,
                             ctrl=StepControl(), repeats=1)
    assert march_kernel.launches == before + 2 and st["n_rays"] == int(live.sum())
