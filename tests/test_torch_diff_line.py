"""The port's differentiable line profile (ops/diff.py::
line_profile_observable, line_profile_from_xy) against the JAX package on
the 1.5 grid at dist 100, incl 55, r_disc 15 (tests/test_diff.py:269-287):
the value, the gradient of the profile's sum in (spin, incl) by reverse
mode against jax.grad, and forward against reverse mode.

The JAX test marches 1024 iterations; the profile is the same at 512 and
768 here (one long-path ray lands later), so 512 is compared with JAX at
512. Tolerances stand beside what was measured.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.ops.diff import line_profile_from_xy, line_profile_observable  # noqa: E402
from raytrace_tpu_torch.sources import ImagePlaneGrid  # noqa: E402

STEPS = (-10.5, 11.5, 1.5, -10.5, 11.5, 1.5)
KW = dict(dist=100.0, r_disc=15.0, n_steps=512)
F64 = torch.float64


def test_line_profile_matches_jax():
    """Float parameters (the float64-seeded image plane): the profile
    against JAX's to 1e-11 of its peak (measured 1.2e-12). Tensor parameters
    (the all-traced construction): the same profile bit for bit in float64;
    the gradient of its sum against jax.grad rtol 1e-9 in spin and incl
    (measured 1.7e-11 and 3.3e-10); forward mode (jacfwd) against reverse
    rtol 1e-10 in spin (the JAX test's gate; measured 4.0e-12) and 1e-9 in
    incl (1.9e-10: the inclination enters through sin and cos of a degree
    angle, and its small derivative is a sum of cancelling terms)."""
    import jax

    from raytrace_tpu.ops.diff import line_profile_observable as jline
    from raytrace_tpu.sources import ImagePlaneGrid as JGrid

    grid, jgrid = ImagePlaneGrid.from_steps(*STEPS), JGrid.from_steps(*STEPS)
    seeded = line_profile_observable(0.9, 55.0, grid, device="cpu", **KW)
    ref = np.asarray(jline(0.9, 55.0, jgrid, **KW))
    assert ref.sum() > 0
    np.testing.assert_allclose(seeded.numpy(), ref, rtol=0, atol=1e-11 * ref.max())

    p = [torch.tensor(x, dtype=F64, requires_grad=True) for x in (0.9, 55.0)]
    traced = line_profile_observable(*p, grid, device="cpu", **KW)
    assert torch.equal(traced.detach(), seeded)
    grad = torch.stack(torch.autograd.grad(traced.sum(), p)).numpy()
    ref_g = np.array([float(g) for g in jax.grad(
        lambda a, i: jline(a, i, jgrid, **KW).sum(), argnums=(0, 1))(0.9, 55.0)])
    assert np.isfinite(grad).all()
    np.testing.assert_allclose(grad, ref_g, rtol=1e-9)

    fwd = torch.func.jacfwd(lambda q: line_profile_observable(q[0], q[1], grid, device="cpu",
                                                              **KW).sum())(
        torch.tensor([0.9, 55.0], dtype=F64)).numpy()
    np.testing.assert_allclose(fwd[0], grad[0], rtol=1e-10)
    np.testing.assert_allclose(fwd[1], grad[1], rtol=1e-9)


def test_line_profile_from_xy_matches_jax():
    """Over the grid's own plane coordinates, line_profile_from_xy gives the
    all-traced line_profile_observable bit for bit, and JAX's
    line_profile_from_xy to 1e-11 of its peak (measured 1.2e-12); dead rows
    leave the profile."""
    import jax.numpy as jnp

    from raytrace_tpu.ops.diff import line_profile_from_xy as jline_xy

    grid = ImagePlaneGrid.from_steps(*STEPS)
    x, y = grid.xy(dtype=F64)
    spin, incl = torch.tensor(0.9, dtype=F64), torch.tensor(55.0, dtype=F64)
    prof = line_profile_from_xy(spin, incl, x, y, **KW)
    assert torch.equal(prof, line_profile_observable(spin, incl, grid, device="cpu", **KW))
    ref = np.asarray(jline_xy(0.9, 55.0, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), **KW))
    np.testing.assert_allclose(prof.numpy(), ref, rtol=0, atol=1e-11 * ref.max())

    dead = torch.zeros_like(x, dtype=torch.bool)
    dead[::2] = True
    half = line_profile_from_xy(spin, incl, x, y, dead, **KW)
    rest = line_profile_from_xy(spin, incl, x[1::2], y[1::2], **KW)
    np.testing.assert_allclose(half.numpy(), rest.numpy(), rtol=1e-12, atol=1e-300)
