"""The port's differentiable emissivity observable (ops/diff.py::
emissivity_gradient_pipeline) against the JAX package: value and its
gradient in (spin, h, gamma), reverse and forward mode, on the 0.3 grid
with r0 = 4 (tests/test_parallel.py:84-91, tests/test_diff.py:58-78).

The JAX tests march 1024 or 2048 iterations; every ray that reaches the
observable's window has landed by 512 here (all 140 live rays end by 702),
so 512 gives their values. Tolerances stand beside what was measured.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.ops.diff import emissivity_gradient_pipeline  # noqa: E402
from raytrace_tpu_torch.sources import PointSourceGrid  # noqa: E402

STEPS = (0.3, 0.3, -0.9, 0.9, -3.0, 3.0)
PARAMS = (0.9, 5.0, 2.0)
N_STEPS = 512


def _port(*p):
    return emissivity_gradient_pipeline(*p, PointSourceGrid.from_steps(*STEPS), n_steps=N_STEPS,
                                        r0=4.0, device="cpu")


def test_emissivity_gradient_pipeline_matches_jax():
    """Value rtol 1e-13 (measured 2.0e-15); the reverse-mode gradient
    against jax.grad rtol 1e-9 in spin and h (3.8e-11: rays that pass near
    turning points carry large transient cotangents through sqrt(max(|x|,
    tiny)) whose cancellation the two libraries round apart, as
    tests/test_parallel.py says of the sharded gradient) and 1e-13 in gamma
    (9e-16, a smooth analytic weight); forward mode (torch.func.jacfwd, the
    three tangents at once) against reverse rtol 1e-12 (4.0e-14). The
    gradient is finite and the value positive."""
    import jax

    from raytrace_tpu.ops.diff import emissivity_gradient_pipeline as jpipeline
    from raytrace_tpu.sources import PointSourceGrid as JGrid

    jgrid = JGrid.from_steps(*STEPS)
    ref, ref_g = jax.value_and_grad(
        lambda s, h, g: jpipeline(s, h, g, jgrid, n_steps=N_STEPS, r0=4.0),
        argnums=(0, 1, 2))(*PARAMS)
    ref_g = np.array([float(x) for x in ref_g])

    p = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in PARAMS]
    value = _port(*p)
    grad = torch.stack(torch.autograd.grad(value, p)).numpy()
    assert float(value) > 0 and np.isfinite(grad).all()
    np.testing.assert_allclose(float(value), float(ref), rtol=1e-13)
    np.testing.assert_allclose(grad[:2], ref_g[:2], rtol=1e-9)
    np.testing.assert_allclose(grad[2], ref_g[2], rtol=1e-13)

    fwd = torch.func.jacfwd(lambda q: _port(q[0], q[1], q[2]))(
        torch.tensor(PARAMS, dtype=torch.float64))
    np.testing.assert_allclose(fwd.numpy(), grad, rtol=1e-12)
