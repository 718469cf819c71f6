"""Weak-field oracles of tests/test_weakfield.py on the port's mapper and
source tracer.

In the r >> M limit the Kerr machinery must reproduce flat-space
kinematics: outward radial photons enter the mapper's radial cells at the
Schwarzschild flight time (tests/test_weakfield.py:48-77), and the source
tracer's absorption columns through a wind shell at r ~ 1e5 M reduce to
the straight-line pcyg model (:128-183). Same gates as the JAX tests,
float64 plain march on the CPU (the flat-limit run takes ~40 s on one
thread).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.ops import mapper as port_mapper  # noqa: E402
from raytrace_tpu_torch.ops import source_tracer as port_st  # noqa: E402
from raytrace_tpu_torch.ops.integrate import StepControl  # noqa: E402
from raytrace_tpu_torch.rays import blank_batch  # noqa: E402
from raytrace_tpu_torch.sources import ImagePlaneGrid, image_plane  # noqa: E402


def test_mapper_times_match_schwarzschild_radial_flight():
    """tests/test_weakfield.py:48-77 on the port: cell-entry times of
    outward radial photons at r = 1000-1500 against the Schwarzschild flight
    time t(r) = r - r0 + 2 ln((r-2)/(r0-2)), within one step (2.5 r_g)."""
    r0, r_max = 1000.0, 1500.0
    grid = port_mapper.MapperGrid(r0=r0, r_max=r_max, n_r=10, n_theta=4, n_phi=4, logbin_r=False)
    n = 4
    full = lambda v: torch.full((n,), v, dtype=torch.float64)
    rays = blank_batch(n, device="cpu").replace(
        r=full(r0 + 1e-6), theta=full(math.pi / 2), phi=full(0.0), t=full(0.0), k=full(1.0),
        h=full(0.0), Q=full(0.0), rdot_sign=full(1.0), thetadot_sign=full(1.0),
        steps=torch.zeros(n, dtype=torch.int32), emit=full(1.0))
    _, maps = port_mapper.map_rays(rays, 0.0, grid, method="rk4", r_lim=r_max * 1.05,
                                   steplim=200_000, ctrl=StepControl(precision=1000.0))
    t_map = port_mapper.average_maps(maps)["time"]
    count = maps["count"].numpy()
    assert (count.sum(axis=(1, 2)) > 0)[1:].all()
    r_entry = r0 + np.arange(grid.n_r) * (r_max - r0) / grid.n_r
    t_exact = r_entry - r0 + 2.0 * np.log((r_entry - 2.0) / (r0 - 2.0))
    t_mean = np.array([t_map[i][count[i] > 0].mean() for i in range(grid.n_r)])
    assert (np.abs(t_mean[1:] - t_exact[1:]) < 2.5).all(), (t_mean, t_exact)
    assert np.allclose(t_mean[1:], r_entry[1:] - r0, atol=2.5)


def _pcyg_columns(b, wind, bins, z_lim, dz=5.0):
    """tests/test_weakfield.py:_pcyg_reference_columns with the port's wind
    and bins: the straight-line absorption column per energy bin."""
    z = np.arange(-z_lim, z_lim, dz)
    r = torch.tensor(np.sqrt(b * b + z * z))
    v, rho = wind.velocity(r).numpy(), wind.density(r).numpy()
    costh = z / r.numpy()
    e_loc = 1.0 / ((1.0 / np.sqrt(1.0 - v * v)) * (1.0 - v * costh))
    ien = bins.energy_index(torch.tensor(e_loc)).numpy()
    good = (r.numpy() > wind.r_in) & (r.numpy() < wind.r_out) & (ien >= 0) & (ien < bins.n_en)
    absorb = np.zeros(bins.n_en)
    np.add.at(absorb, ien[good], dz * rho[good])
    return absorb


def test_source_tracer_reduces_to_pcyg_in_flat_limit():
    """tests/test_weakfield.py:128-183 on the port: a wind shell at r ~ 1e5
    M traced with RK4 (precision 2000, max_phistep 0.005): the per-bin
    absorption columns of three rays against a dense straight-line
    integration, totals to 2%, the well-populated core median to 10% and
    every core bin to 35%."""
    scale = 1e5
    wind = port_st.WindModel(v0=0.2, r_in=0.5 * scale, r_out=1.0 * scale, theta_min=0.0,
                             theta_max=math.pi, motion=1)
    bins = port_st.EnergyTimeBins(en0=0.75, en_max=1.30, n_en=25, logbin_en=False, t0=0.0,
                                  dt=1e8, n_t=1)
    dist = 20.0 * scale
    impacts = [0.55 * scale, 0.7 * scale, 0.85 * scale]
    grid = ImagePlaneGrid(nx=3, ny=1, x0=impacts[0], y0=0.0, dx=0.15 * scale, dy=1.0)
    rays = image_plane(dist, 90.0, grid, 0.0, device="cpu")
    _, _, absorb, _ = port_st.run_source_trace(
        rays, 0.0, wind, bins, stop=port_st.SphericalStop(0.0), method="rk4",
        r_lim=dist * 1.05, reverse=True, steplim=400_000,
        ctrl=StepControl(precision=2000.0, max_phistep=0.005))
    absorb = absorb.numpy()
    for i, b in enumerate(impacts):
        ref = _pcyg_columns(b, wind, bins, z_lim=1.2 * scale)
        got = absorb[i]
        assert ref.sum() > 0 and got.sum() > 0
        np.testing.assert_allclose(got.sum(), ref.sum(), rtol=0.02, err_msg=f"b={b}")
        core = ref > 0.2 * ref.max()
        assert core.sum() >= 5
        rel = np.abs(got[core] / ref[core] - 1.0)
        assert np.median(rel) < 0.1 and rel.max() < 0.35, (b, rel)
