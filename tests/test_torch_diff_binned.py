"""The port's differentiable binned emissivity profile (ops/diff.py::
emissivity_binned_profile) against the JAX package on a small grid, and on
the card against the reference binary's perturbed-parameter goldens with
the gates of tests/test_diff.py:134-214 (cuda-marked: on the CPU the
6144-iteration marches of the 0.05 grid would take minutes).

The CPU grid is offset off the knife edges (no ray at cos alpha = 0 or
sin beta = 0, launched at a turning point, where the first move's sign is a
rounding coin flip): on the 0.3 grid through zero 3 of 147 rays change bins
between the two libraries. Every ray has ended by 702 iterations; 768 are
marched. Tolerances stand beside what was measured.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.ops.diff import emissivity_binned_profile  # noqa: E402
from raytrace_tpu_torch.sources import PointSourceGrid  # noqa: E402

STEPS = (0.3, 0.3, -0.95, 0.95, -3.05, 3.05)
KW = dict(n_r=20, n_steps=768)
F64 = torch.float64


def test_binned_profile_matches_jax():
    """With r_min = None the bins start at the ISCO of the spin, a tensor
    on the tensor route: the profile equals the float route's bit for bit;
    against JAX the counts are equal and the emissivity within rtol 1e-12
    (measured 1.2e-13); d(emis)/d(spin) by forward mode (torch.func.jacfwd)
    against jax.jacfwd rtol 1e-9 (measured 1.2e-10), zero in the same bins."""
    import jax

    from raytrace_tpu.ops.diff import emissivity_binned_profile as jbinned
    from raytrace_tpu.sources import PointSourceGrid as JGrid

    grid, jgrid = PointSourceGrid.from_steps(*STEPS), JGrid.from_steps(*STEPS)
    emis, counts = emissivity_binned_profile(0.9, 5.0, 2.0, grid, device="cpu", **KW)
    t_emis, t_counts = emissivity_binned_profile(torch.tensor(0.9, dtype=F64), 5.0, 2.0, grid,
                                                 device="cpu", **KW)
    assert torch.equal(t_counts, counts) and torch.equal(t_emis, emis)
    ref_emis, ref_counts = jbinned(0.9, 5.0, 2.0, jgrid, **KW)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    assert counts.sum() > 50
    np.testing.assert_allclose(emis.numpy(), np.asarray(ref_emis), rtol=1e-12)

    d = torch.func.jacfwd(lambda s: emissivity_binned_profile(s, 5.0, 2.0, grid, device="cpu",
                                                              **KW)[0])(
        torch.tensor(0.9, dtype=F64)).numpy()
    ref_d = np.asarray(jax.jacfwd(lambda s: jbinned(s, 5.0, 2.0, jgrid, **KW)[0])(0.9))
    assert np.isfinite(d).all() and (d != 0).sum() >= 5
    np.testing.assert_allclose(d, ref_d, rtol=1e-9)


def _golden(tag):
    cols = ["r", "area", "rays", "flux", "emis", "g", "t"]
    return dict(zip(cols, np.loadtxt(f"tests/golden/emissivity_{tag}_g0.05.dat").T))


@pytest.mark.cuda
def test_reference_binary_gates_on_cuda():
    """The reference-FD gates of tests/test_diff.py:134-214 on the card (as
    chip_smoke phase 19c): d(emis)/d(spin) at a = 0.9 by forward mode
    against (ref(a=0.91) - ref(a=0.89)) / 0.02 on >= 3 count-gated bins,
    each within 10%; the height secant (h 4.5 to 5.5 at a = 0.998) against
    the reference's on >= 5 gated bins, median < 0.15, max < 0.25."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: 6144-iteration marches of the 0.05 grid")
    from torch.autograd import forward_ad as fwad

    grid = PointSourceGrid.from_steps(0.05, 0.05, -0.995, 0.995, -math.pi, math.pi)
    A, B = _golden("a0.89_h5_rmin2.5"), _golden("a0.91_h5_rmin2.5")
    fd = (B["emis"] - A["emis"]) / 0.02
    with np.errstate(divide="ignore", invalid="ignore"):
        signal = np.abs(B["emis"] / np.where(A["emis"] == 0, 1, A["emis"]) - 1)
    gate = (A["rays"] >= 100) & (A["rays"] == B["rays"]) & (signal > 0.004)
    assert gate.sum() >= 3
    with fwad.dual_level():
        spin = torch.tensor(0.9, dtype=F64, device="cuda")
        emis, counts = emissivity_binned_profile(fwad.make_dual(spin, torch.ones_like(spin)),
                                                 5.0, 2.0, grid, r_min=2.5, n_steps=6144)
        d_emis = fwad.unpack_dual(emis).tangent.cpu().numpy()
        counts = counts.cpu().numpy()
    assert (np.abs(counts[gate] - A["rays"][gate]) <= 0.10 * A["rays"][gate]).all()
    rel = np.abs(d_emis[gate] / fd[gate] - 1.0)
    assert rel.max() < 0.10, rel

    A, B = _golden("a0.998_h4.5"), _golden("a0.998_h5.5")
    (e45, c45), (e55, c55) = (
        (x.cpu().numpy() for x in emissivity_binned_profile(0.998, h, 2.0, grid, n_steps=6144))
        for h in (4.5, 5.5))
    gate = ((A["rays"] >= 100) & (B["rays"] >= 100)
            & (np.abs(A["rays"] - B["rays"]) < 0.10 * A["rays"])
            & (np.abs(c45 - A["rays"]) < 0.10 * A["rays"])
            & (np.abs(c55 - B["rays"]) < 0.10 * B["rays"]))
    assert gate.sum() >= 5
    rel = np.abs((e55 - e45)[gate] / (B["emis"] - A["emis"])[gate] - 1.0)
    assert np.median(rel) < 0.15 and rel.max() < 0.25, rel
