"""The port's differentiable march in float32 (the port of
tests/test_f32.py:157-181): the emissivity observable's gradients stay
finite and track the float64 ones to the ensemble noise of a float32 march.

The JAX test's float32 parameters meet float64 angle arrays, so its march
runs in float64; here the whole pipeline runs in float32 (``dtype``). Its
gates are kept: value rtol 0.02 (measured 4.6e-5), each gradient of the
same sign and rtol 0.15 (measured 2.0% in spin, 1.7% in h, 2.5e-5 in
gamma). With r_max = 50 every ray has ended by 512 iterations, so 512
gives the JAX test's 1024-iteration values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.ops.diff import emissivity_gradient_pipeline  # noqa: E402
from raytrace_tpu_torch.sources import PointSourceGrid  # noqa: E402


def _value_and_grad(dtype):
    grid = PointSourceGrid.from_steps(0.3, 0.3, -0.9, 0.9, -3.0, 3.0)
    p = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in (0.9, 5.0, 2.0)]
    value = emissivity_gradient_pipeline(*p, grid, n_steps=512, r0=4.0, r_max=50.0,
                                         device="cpu", dtype=dtype)
    assert value.dtype == dtype
    return float(value), [float(g) for g in torch.autograd.grad(value, p)]


def test_f32_gradients_finite_and_track_f64():
    v64, g64 = _value_and_grad(torch.float64)
    v32, g32 = _value_and_grad(torch.float32)
    assert np.isfinite(v32)
    np.testing.assert_allclose(v32, v64, rtol=0.02)
    for a, b in zip(g32, g64):
        assert np.isfinite(a)
        assert np.sign(a) == np.sign(b)
        np.testing.assert_allclose(a, b, rtol=0.15)
