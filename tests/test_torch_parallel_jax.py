"""The port's sharded functions against the JAX package's on the 8 virtual
devices of tests/conftest.py: sharded_emissivity_bins and
sharded_caustic_trace, and the caustic maps over a mesh, on
tests/test_parallel.py's rays, bins and bundles (tests/torch_parallel_cases.py).
The port runs as a world of one here; tests/test_torch_parallel.py holds 2
ranks to it. Tolerances are the port's float64 parity with JAX, stated
beside what was measured.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_parallel_cases as cases  # noqa: E402

from raytrace_tpu_torch.parallel import (make_ray_mesh, pad_rays, shard_rays,  # noqa: E402
                                         sharded_caustic_trace, sharded_emissivity_bins)


def _bin_kw(edges):
    return dict(r_min=cases.BINS["r_min"], dr=float(edges(cases.BINS["r_min"],
                                                          cases.BINS["r_disc"],
                                                          cases.BINS["n_r"], True)[2]),
                n_r=cases.BINS["n_r"])


def test_sharded_emissivity_bins_match_jax():
    """tests/test_parallel.py::test_sharded_bins_merge_with_psum's bins (rk4,
    r_max 200, steplim 3000, 24 log bins from r 1.3 to 100) against JAX's
    psum-merged bins on 8 devices, under count gates as
    tests/test_torch_emissivity.py holds the port's emissivity to JAX's:
    the grid has knife-edge rays (cos alpha ~ 1e-16, launched at the radial
    turning point, and beta = 0), which land elsewhere in the two
    libraries. At most one ray moves between bins (measured: one, 56
    against 57) and the sums of bins with equal counts agree to rtol 1e-3
    (measured 2.6e-4)."""
    from raytrace_tpu.ops.reductions import bin_edges as jedges
    from raytrace_tpu.parallel import make_ray_mesh as jmesh
    from raytrace_tpu.parallel import pad_rays as jpad
    from raytrace_tpu.parallel import shard_rays as jshard
    from raytrace_tpu.parallel import sharded_emissivity_bins as jbins
    from raytrace_tpu.sources import PointSourceGrid as JGrid
    from raytrace_tpu.sources import point_source as jpoint

    from raytrace_tpu_torch.ops.reductions import bin_edges

    grid, rays = cases.lamppost()
    mesh = make_ray_mesh(device="cpu")
    kw = dict(n_primary=float(grid.n_rays), **cases.TRACE_KW)
    counts, sums = sharded_emissivity_bins(
        shard_rays(pad_rays(rays, 1), mesh), cases.SPIN, mesh,
        **_bin_kw(lambda *a: bin_edges(*a, device="cpu")), **kw)
    jm = jmesh()
    jrays = jshard(jpad(jpoint(cases.SOURCE, V=0.0, spin=cases.SPIN,
                               grid=JGrid.from_steps(*cases.TRACE_GRID)), 8), jm)
    jcounts, jsums = jbins(jrays, cases.SPIN, jm, **_bin_kw(jedges), **kw)
    c, jc = counts.numpy(), np.asarray(jcounts)
    assert c.sum() > 200 and np.abs(c - jc).sum() <= 2 and np.abs(c - jc).max() <= 1
    same = (c == jc) & (c > 0)
    assert same.sum() >= 6
    for k in sums:
        np.testing.assert_allclose(sums[k].numpy()[same], np.asarray(jsums[k])[same], rtol=1e-3,
                                   err_msg=k)


def test_sharded_caustic_trace_and_maps_match_jax():
    """tests/test_parallel.py's bundle caustic (spin 0.9, dist 100, incl
    60, 11 x 11 pixels x 5 rays, rk45): sharded_caustic_trace's full-width
    batch against JAX's on 8 devices, statuses and steps equal on every
    ray, r to rtol 1e-5 (measured 2.5e-6 at most: the grid's axis rays
    x = 0 and y = 0 skim the pole, where the two libraries' sin/cos ulps
    grow); the maps of apps.caustics.compute over a mesh against JAX's:
    hit and order on all but 1% of the pixels, as tests/test_torch_caustics.py
    holds the unsharded app, and det_j on the pixels where both agree with
    a median relative gap under 1e-10 (measured 1.7e-13), at most 10% of
    them over 1e-6 and none over 1e-3 (measured: 5 of 88, the largest
    6.2e-4; a difference quotient of r's gaps over landing points 0.02
    apart)."""
    from raytrace_tpu.apps.caustics import compute as jcompute
    from raytrace_tpu.destinations import DiscWithISCO as JDisc
    from raytrace_tpu.geometry import isco_radius as jisco
    from raytrace_tpu.ops.redshift import redshift_start as jredshift
    from raytrace_tpu.parallel import make_ray_mesh as jmesh
    from raytrace_tpu.parallel import sharded_caustic_trace as jcaustic
    from raytrace_tpu.sources import ImagePlaneGrid as JImage
    from raytrace_tpu.sources import image_plane_bundles as jbundles

    from raytrace_tpu_torch.apps import caustics
    from raytrace_tpu_torch.sources import ImagePlaneGrid

    mesh, jm = make_ray_mesh(device="cpu"), jmesh()
    bundles, spin, dest = cases.caustic_bundles()
    out = sharded_caustic_trace(bundles, spin, mesh, dest=dest, r_max=110.0, method="rk45",
                                steplim=20000)
    jgrid = JImage.from_steps(*cases.CAUSTIC_GRID)
    b, _ = jbundles(100.0, 60.0, jgrid, 0.9, 0.0, eps_frac=0.01)
    jout = jcaustic(jredshift(b, -0.9, V=0.0, reverse=True), -0.9, jm,
                    dest=JDisc(r_isco=jisco(0.9), r_out=15.0), r_max=110.0, method="rk45",
                    steplim=20000)
    assert out.n_rays == jout.n_rays == 605
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(jout.status))
    np.testing.assert_array_equal(out.steps.numpy(), np.asarray(jout.steps))
    np.testing.assert_allclose(out.r.numpy(), np.asarray(jout.r), rtol=1e-5)

    maps = caustics.compute(0.9, 100.0, 60.0, ImagePlaneGrid.from_steps(*cases.CAUSTIC_GRID),
                            device="cpu", mesh=mesh, **cases.CAUSTIC_KW)
    jmaps = jcompute(0.9, 100.0, 60.0, jgrid, mesh=jm, **cases.CAUSTIC_KW)
    assert (maps["hit"] != jmaps["hit"]).mean() <= 0.01
    assert (maps["order"] != jmaps["order"]).mean() <= 0.01
    good = (maps["hit"] == jmaps["hit"]) & (maps["order"] == jmaps["order"])
    assert (good & (jmaps["hit"] > 0)).sum() > 20
    d1, d2 = maps["det_j"][good], np.asarray(jmaps["det_j"])[good]
    fin = np.isfinite(d2) & (d2 != caustics.SENTINEL)
    np.testing.assert_array_equal(fin, np.isfinite(d1) & (d1 != caustics.SENTINEL))
    rel = np.abs(d1[fin] / d2[fin] - 1)
    assert np.median(rel) < 1e-10 and (rel > 1e-6).mean() <= 0.1 and rel.max() < 1e-3
