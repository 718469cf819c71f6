"""The port's volumetric mapper (ops/mapper.py) against the JAX package.

``map_rays`` runs on TestMapper's batch (tests/test_capabilities.py:112):
a lamppost at r = 5 on the axis, spin 0.9, the (cos alpha, beta) grid
from_steps(0.25, 0.5, -0.9, 0.9, -3.0, 3.0) (104 rays, none on the beta =
-pi knife edge), MapperGrid(1.5, 50, 12, 8, 8), steplim 8000, Euler and
RK4, float64 on the CPU. The two packages' float64 marches agree to
rounding, not bit for bit (XLA contracts multiply-adds): one ray of the 104
ends one step later, and a cell-entry event that lands one step apart
moves that event's time and redshift. The gates count that.

The JAX package is imported inside the tests that use it.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.ops import mapper as port_mapper  # noqa: E402
from raytrace_tpu_torch.ops.redshift import redshift_start  # noqa: E402
from raytrace_tpu_torch.sources import PointSourceGrid, point_source  # noqa: E402

SPIN = 0.9
GRID = (0.25, 0.5, -0.9, 0.9, -3.0, 3.0)
MAP = (1.5, 50.0, 12, 8, 8)


def _jax_batch():
    from raytrace_tpu.ops.redshift import redshift_start as jrs
    from raytrace_tpu.sources import PointSourceGrid as JGrid
    from raytrace_tpu.sources import point_source as jps

    return jrs(jps((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=SPIN, grid=JGrid.from_steps(*GRID)),
               SPIN, V=0.0)


def _port_batch():
    rays = point_source((0.0, 5.0, 1e-3, 0.0), 0.0, SPIN, PointSourceGrid.from_steps(*GRID),
                        device="cpu")
    return redshift_start(rays, SPIN, 0.0)


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_map_rays_matches_jax(method):
    """Final statuses equal on every ray, steps on all but at most 1
    (measured 1, one step apart); per-cell counts equal outside at most 2
    cells (measured 0); time and redshift sums: at least 80% of the
    populated cells to 1e-9 relative (measured 85-87%), every cell to 0.25
    (measured 0.19 in time, a step's dt in a sparsely hit cell; 1.5e-3 in
    redshift) and the map totals to 1e-4 (measured 4.7e-5)."""
    from raytrace_tpu.ops import mapper as jax_mapper

    kw = dict(method=method, r_lim=50.0, theta_lim=math.pi / 2, steplim=8000)
    jf, jm = jax_mapper.map_rays(_jax_batch(), SPIN, jax_mapper.MapperGrid(*MAP), **kw)
    pf, pm = port_mapper.map_rays(_port_batch(), SPIN, port_mapper.MapperGrid(*MAP), **kw)
    np.testing.assert_array_equal(pf.status.numpy(), np.asarray(jf.status))
    assert (pf.steps.numpy() != np.asarray(jf.steps)).sum() <= 1
    a_n, b_n = np.asarray(jm["count"]), pm["count"].numpy()
    assert a_n.shape == b_n.shape == (12, 8, 8)
    assert a_n.sum() > 200
    assert (a_n != b_n).sum() <= 2
    hit = a_n > 0
    for k in ("time", "redshift"):
        a, b = np.asarray(jm[k]), pm[k].numpy()
        rel = np.abs(a - b)[hit] / np.abs(a[hit])
        assert (rel < 1e-9).mean() >= 0.8, (k, (rel < 1e-9).mean())
        assert rel.max() < 0.25, (k, rel.max())
        assert abs(b.sum() / a.sum() - 1) < 1e-4
    avg = port_mapper.average_maps(pm)
    g = avg["redshift"][hit]
    assert np.isfinite(g).all() and (g > 0.05).all() and (g < 3).all()


def test_cell_index_matches_jax():
    """Flattened cell indices and in-range flags, log and linear radial
    bins, on 4,000 random points (r from 0.5 to 120, theta in [-0.1, pi +
    0.1], phi over several turns): equal on every point."""
    import jax.numpy as jnp

    from raytrace_tpu.ops import mapper as jax_mapper

    rng = np.random.default_rng(7)
    r = np.exp(rng.uniform(np.log(0.5), np.log(120.0), 4000))
    theta = rng.uniform(-0.1, math.pi + 0.1, 4000)
    phi = rng.uniform(-12.0, 12.0, 4000)
    for logbin in (True, False):
        args = (1.5, 100.0, 50, 25, 50, logbin)
        ja, jok = jax_mapper.MapperGrid(*args).cell_index(jnp.asarray(r), jnp.asarray(theta),
                                                          jnp.asarray(phi))
        pa, pok = port_mapper.MapperGrid(*args).cell_index(
            torch.tensor(r), torch.tensor(theta), torch.tensor(phi))
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
        assert 0.2 < pok.numpy().mean() < 0.95


@pytest.mark.parametrize("args, spin", [
    ((1.5, 50.0, 12, 8, 8), 0.9), ((2.0, 50.0, 10, 8, 8, False), 0.5),
    ((1000.0, 2000.0, 8, 6, 5, False), 0.0), ((1.5, 100.0, 50, 25, 50), 0.998),
])
def test_cell_volumes_match_jax(args, spin):
    """Proper cell volumes to rtol 1e-12, zero on the theta = 0 row in both."""
    from raytrace_tpu.ops import mapper as jax_mapper

    a = np.asarray(jax_mapper.cell_volumes(jax_mapper.MapperGrid(*args), spin))
    b = port_mapper.cell_volumes(port_mapper.MapperGrid(*args), spin).numpy()
    assert b.shape == a.shape
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=0.0)
    assert (b[:, 1:, :] > 0).all()


def test_average_maps_matches_jax():
    """Count averages of random maps with empty cells: equal, not finite
    where the count is 0 in both."""
    from raytrace_tpu.ops import mapper as jax_mapper

    rng = np.random.default_rng(3)
    shape = (6, 4, 5)
    maps = {"time": rng.random(shape) * 50, "redshift": rng.random(shape),
            "count": rng.integers(0, 4, shape).astype(float)}
    a = jax_mapper.average_maps(maps)
    b = port_mapper.average_maps({k: torch.tensor(v) for k, v in maps.items()})
    for k in ("time", "redshift", "count"):
        np.testing.assert_array_equal(b[k], a[k])
    assert not np.isfinite(b["time"][maps["count"] == 0]).any()


def test_hdf5_roundtrip_reference_layout(tmp_path):
    """save_hdf writes the reference's HDF5 layout (mapper.h:75-107) and
    load_hdf restores it losslessly; the file the JAX package writes from
    the same maps holds the same datasets and attributes."""
    h5py = pytest.importorskip("h5py")
    from raytrace_tpu.ops import mapper as jax_mapper

    mg = port_mapper.MapperGrid(r0=1.5, r_max=40.0, n_r=6, n_theta=4, n_phi=5, logbin_r=True)
    rng = np.random.default_rng(3)
    shape = (6, 4, 5)
    avg = {"time": rng.random(shape), "redshift": rng.random(shape),
           "count": rng.integers(0, 9, shape).astype(float)}
    vol = port_mapper.cell_volumes(mg, SPIN).numpy()
    path = tmp_path / "map.h5"
    port_mapper.save_hdf(path, mg, avg, vol, n_rays=123)
    jpath = tmp_path / "jax.h5"
    jax_mapper.save_hdf(jpath, jax_mapper.MapperGrid(1.5, 40.0, 6, 4, 5, True), avg, vol,
                        n_rays=123)
    with h5py.File(path) as f, h5py.File(jpath) as g:
        assert set(f.keys()) == set(g.keys()) == {"time", "redshift", "Nrays", "volume"}
        assert dict(f.attrs) == dict(g.attrs)
        for k in f.keys():
            np.testing.assert_array_equal(f[k][()], g[k][()])
        assert f.attrs["Nr"] == 6 and f.attrs["n_rays"] == 123
    mg2, avg2, vol2 = port_mapper.load_hdf(path)
    assert mg2 == mg
    for k in ("time", "count"):
        np.testing.assert_array_equal(avg2[k], avg[k])
    np.testing.assert_array_equal(vol2, vol)


@pytest.mark.cuda
def test_map_rays_on_the_card_matches_cpu():
    """On the card (a CUDA graph replayed per compaction epoch, atomic
    float64 additions): statuses and steps equal to the CPU run's, counts
    equal, time and redshift sums to rtol 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = dict(method="euler", r_lim=50.0, theta_lim=math.pi / 2, steplim=8000)
    grid = port_mapper.MapperGrid(*MAP)
    cf, cm = port_mapper.map_rays(_port_batch(), SPIN, grid, **kw)
    gf, gm = port_mapper.map_rays(_port_batch().to(device="cuda"), SPIN, grid, **kw)
    np.testing.assert_array_equal(gf.status.cpu().numpy(), cf.status.numpy())
    np.testing.assert_array_equal(gf.steps.cpu().numpy(), cf.steps.numpy())
    np.testing.assert_array_equal(gm["count"].cpu().numpy(), cm["count"].numpy())
    for k in ("time", "redshift"):
        np.testing.assert_allclose(gm[k].cpu().numpy(), cm[k].numpy(), rtol=1e-9)
