"""The port's sharded gradient and fitting steps on the CPU: 2 gloo ranks
(``multiprocess_check.launch``, one thread each) against one process
running them alone, and against the JAX package's sharded steps on the 8
virtual devices of tests/conftest.py. The marches are cut to 384
iterations (n_steps; tests/test_parallel.py runs 1024), where every
lamppost ray has landed (the observable is 35.917 at 384 and at 1024), to
keep the file near a minute: a recorded iteration costs ~17 ms forward and
~30 backward here. Inputs are tests/test_parallel.py's (the 0.3 lamppost
grid at spin 0.998, h 5, gamma 2, r0 4; the 12 x 12 camera at dist 100,
r_disc 15, target at spin 0.9, incl 55, step at 0.85, 57), in
tests/torch_parallel_cases.py. The 0.3 grid holds rays launched at the
radial turning point (cos alpha = -1.1e-16, a radial rate of exactly 0).
The multi-process check runs as its CLI does, at 128 iterations.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_parallel_cases as cases  # noqa: E402

from raytrace_tpu_torch.parallel import make_ray_mesh  # noqa: E402
from raytrace_tpu_torch.parallel.multiprocess_check import launch  # noqa: E402

TESTS = Path(__file__).resolve().parent
N_STEPS = 384


@pytest.fixture(scope="module")
def runs():
    """cases.gradients on 2 gloo ranks (launched in the background) and on
    a world of one in this process meanwhile."""
    saved = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(filter(None, [str(TESTS), saved]))
    try:
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(launch, "torch_parallel_cases:gradients", 2, device="cpu",
                                args={"n_steps": N_STEPS})
            one = cases.gradients(make_ray_mesh(device="cpu"), N_STEPS)
            ranks = ranks.result()
    finally:
        os.environ.pop("PYTHONPATH")
        if saved is not None:
            os.environ["PYTHONPATH"] = saved
    return ranks, one


def test_sharded_gradient_two_ranks_match_one(runs):
    """sharded_emissivity_gradient on 2 ranks: every rank holds the same
    value and d/d(spin, h, gamma), equal to one process's to rtol 1e-12
    (the ranks march the same rays; only the sums over rays reassociate).
    The gradients are finite: the safe division's backward gives the rays
    launched at a turning point a zero gradient where their cotangent is
    zero (ops/integrate.py::_Quotient), where torch's division gave NaN."""
    ranks, one = runs
    assert one["value"] > 0 and np.all(one["grads"] != 0) and np.isfinite(one["grads"]).all()
    for r in ranks:
        np.testing.assert_allclose(r["value"], one["value"], rtol=1e-12)
        np.testing.assert_allclose(r["grads"], one["grads"], rtol=1e-12)


def test_sharded_fit_step_two_ranks_match_one(runs):
    """sharded_line_profile_fit_step on 2 ranks: the loss and d/d(spin,
    incl) equal one process's differentiation of the same composition to
    rtol 1e-12, so the gradients are not divided by the rank count (a
    division would put them off by a factor of 2)."""
    ranks, one = runs
    assert one["loss"] > 0 and np.all(one["fit_grads"] != 0)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-12)
        np.testing.assert_allclose(r["fit_grads"], one["fit_grads"], rtol=1e-12)


def test_sharded_steps_match_jax(runs):
    """Against JAX's sharded_emissivity_gradient and
    sharded_line_profile_fit_step on 8 devices at the same 384 iterations:
    value to rtol 1e-10 and gradients to rtol 2e-3, the tolerances
    tests/test_parallel.py holds JAX's own sharded gradient to (the
    ensemble gradient's noise floor); the fit's loss and gradients to rtol
    1e-8, as tests/test_parallel.py holds JAX's sharded fit to its single
    device."""
    import jax.numpy as jnp

    from raytrace_tpu.ops.diff import line_profile_from_xy
    from raytrace_tpu.parallel import make_ray_mesh as jmesh
    from raytrace_tpu.parallel import sharded_emissivity_gradient as jgrad
    from raytrace_tpu.parallel import sharded_line_profile_fit_step as jfit
    from raytrace_tpu.sources import ImagePlaneGrid, PointSourceGrid

    _, one = runs
    mesh = jmesh()
    value, grads = jgrad(cases.SPIN, 5.0, 2.0, PointSourceGrid.from_steps(*cases.GRAD_GRID), mesh,
                         n_steps=N_STEPS, r0=4.0)
    grid = ImagePlaneGrid.from_steps(*cases.FIT_GRID)
    x, y = grid.xy()
    target = line_profile_from_xy(0.9, 55.0, x, y, energies=jnp.linspace(0.3, 1.3, 48),
                                  n_steps=N_STEPS, **cases.FIT_KW)
    loss, fit = jfit(0.85, 57.0, grid, target, mesh, n_steps=N_STEPS, **cases.FIT_KW)
    np.testing.assert_allclose(one["value"], float(value), rtol=1e-10)
    np.testing.assert_allclose(one["grads"], [float(g) for g in grads], rtol=2e-3)
    np.testing.assert_allclose(one["loss"], float(loss), rtol=1e-8)
    np.testing.assert_allclose(one["fit_grads"], [float(g) for g in fit], rtol=1e-8)


def test_multiprocess_check_cli(tmp_path):
    """python -m raytrace_tpu_torch.parallel.multiprocess_check
    --device=cpu --procs 2 (128 iterations) writes a record with "ok":
    true: the 2-rank gradient and fit steps equal the single process's to
    its rtol 1e-10."""
    import subprocess
    import sys

    out = tmp_path / "mpc.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(TESTS.parent), os.environ.get("PYTHONPATH")])))
    proc = subprocess.run(
        [sys.executable, "-m", "raytrace_tpu_torch.parallel.multiprocess_check", str(out),
         "--device=cpu", "--procs", "2", "--n_steps", "128"],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    record = json.loads(out.read_text())
    assert record["ok"] is True and record["n_processes"] == 2 and record["backend"] == "gloo"
    assert record["ranks_agree"] and record["grad_steps"] == record["fit_steps"] == 128
