"""The port's ray batch and lamppost source against the JAX package: the
numpy <-> torch round trip carries a JAX batch across unchanged, and the
port's own point_source builds the same batch field by field."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu.rays import blank_batch as jax_blank  # noqa: E402
from raytrace_tpu.sources import PointSourceGrid as JaxGrid  # noqa: E402
from raytrace_tpu.sources import point_source as jax_point_source  # noqa: E402
from raytrace_tpu_torch import rays as prays  # noqa: E402
from raytrace_tpu_torch.sources import PointSourceGrid, point_source  # noqa: E402
from raytrace_tpu_torch.sources.pointsource import grid_angles  # noqa: E402

SPIN = 0.998
SOURCE = (0.0, 5.0, 1e-3, 1.5707)


def _jax_numpy(b):
    return {f: np.asarray(getattr(b, f)) for f in b.__dataclass_fields__}


@pytest.fixture(scope="module")
def jax_batch():
    return jax_point_source(SOURCE, V=0.0, spin=SPIN, grid=JaxGrid.from_steps(0.1, 0.1))


def test_same_fields_and_status_bits():
    from raytrace_tpu import rays as jrays

    port_fields = [f.name for f in dataclasses.fields(prays.RayBatch)]
    assert port_fields == list(jrays.RayBatch.__dataclass_fields__)
    assert len(port_fields) == 24
    assert sorted(prays.FLOAT_FIELDS + prays.INT_FIELDS + prays.BOOL_FIELDS) == sorted(port_fields)
    for name in dir(jrays):
        if name.startswith("RAY_STATUS_"):
            assert getattr(prays, name) == getattr(jrays, name)


def test_numpy_round_trip_is_exact(jax_batch):
    d = _jax_numpy(jax_batch)
    back = prays.to_numpy(prays.from_numpy(d, device="cpu"))
    assert set(back) == set(d)
    for f, v in d.items():
        assert back[f].dtype == v.dtype, f
        np.testing.assert_array_equal(back[f], v, err_msg=f)


@pytest.mark.parametrize(
    "steps",
    [(0.1, 0.1), (0.05, 0.05), (0.25, 0.5, -0.5, 0.5, -1.0, 1.0)],
    ids=["0.1", "0.05", "dead-edges"],
)
def test_point_source_matches_jax(steps):
    """Every field: constants to rtol 1e-12, ints, gates and the dead
    top-edge rows exactly (the last grid's ranges are whole multiples of
    its steps, so its top rows are dead)."""
    ref = _jax_numpy(jax_point_source(SOURCE, V=0.0, spin=SPIN, grid=JaxGrid.from_steps(*steps)))
    grid = PointSourceGrid.from_steps(*steps)
    assert grid == PointSourceGrid(**dataclasses.asdict(JaxGrid.from_steps(*steps)))
    mine = prays.to_numpy(point_source(SOURCE, 0.0, SPIN, grid, device="cpu"))
    for f, v in ref.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(mine[f], v, rtol=1e-12, atol=1e-300, err_msg=f)
        else:
            np.testing.assert_array_equal(mine[f], v, err_msg=f)
    assert (ref["steps"] == -1).any() == (len(steps) > 2)


def test_moving_source_matches_jax():
    grid = JaxGrid.from_steps(0.2, 0.2)
    ref = _jax_numpy(jax_point_source(SOURCE, V=0.05, spin=0.9, grid=grid))
    mine = prays.to_numpy(point_source(SOURCE, 0.05, 0.9, PointSourceGrid.from_steps(0.2, 0.2),
                                       device="cpu"))
    for f in ("k", "h", "rdot_sign", "thetadot_sign", "alpha", "beta"):
        np.testing.assert_allclose(mine[f], ref[f], rtol=1e-12, err_msg=f)
    np.testing.assert_allclose(mine["Q"], ref["Q"], rtol=1e-12, atol=1e-12 * np.abs(ref["Q"]).max())


def test_grid_counts_truncate_like_the_reference():
    for steps in [(0.05, 0.05), (0.01, 0.01), (0.005, 0.001), (0.3, 0.7)]:
        assert PointSourceGrid.from_steps(*steps) == PointSourceGrid(
            **dataclasses.asdict(JaxGrid.from_steps(*steps)))
    assert PointSourceGrid.from_steps(0.01, 0.01).n_rays == 125_800
    ca, be, dead = grid_angles(PointSourceGrid.from_steps(0.05, 0.05), device="cpu",
                               dtype=torch.float32)
    assert ca.dtype == be.dtype == torch.float32 and dead.dtype == torch.bool


def test_blank_batch_and_masks():
    ref = _jax_numpy(jax_blank(7))
    mine = prays.to_numpy(prays.blank_batch(7, device="cpu"))
    for f, v in ref.items():
        np.testing.assert_array_equal(mine[f], v, err_msg=f)
    b = prays.blank_batch(5, device="cpu")
    b = b.replace(steps=torch.tensor([-1, 0, 3, 4, 7], dtype=torch.int32),
                  status=torch.tensor([0, 0, 1, 8, 64], dtype=torch.int32))
    assert b.active.tolist() == [False, True, False, False, False]
    assert b.ok.tolist() == [False, False, True, True, True]
    b32 = b.to(dtype=torch.float32)
    assert b32.r.dtype == torch.float32 and b32.steps.dtype == torch.int32
    assert b32.r_was_positive.dtype == torch.bool
