"""The single-ray gradients of tests/test_torch_diff_scan.py through the
port's DOPRI5 march (trace_scan, method rk45): reverse mode against
jax.jacrev, forward against reverse mode, and checkpoint_every 16 against
64 bit for bit. The adaptive controller's per-lane step is part of the
differentiated computation (tests/test_diff.py:96-121)."""

import pytest

pytest.importorskip("torch")

from test_torch_diff_scan import check_single_ray_gradients  # noqa: E402


def test_single_ray_gradients_match_jax_rk45():
    check_single_ray_gradients("rk45")
