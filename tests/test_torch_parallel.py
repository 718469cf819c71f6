"""The port's sharding over torch.distributed (``raytrace_tpu_torch.parallel``)
on the CPU: 2 gloo ranks, spawned by ``multiprocess_check.launch`` (one
thread each), against one process running the same functions alone; a
world of one is held against the JAX package's sharded functions on the 8
virtual devices of
tests/conftest.py (tests/test_torch_parallel_jax.py). The rays, bins,
bundles and camera are tests/test_parallel.py's (tests/torch_parallel_cases.py).
The multi-process check runs as a CLI in tests/test_torch_parallel_grad.py.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_parallel_cases as cases  # noqa: E402

from raytrace_tpu_torch.ops import trace  # noqa: E402
from raytrace_tpu_torch.parallel import (RayMesh, auto_mesh, make_ray_mesh,  # noqa: E402
                                         pad_rays, shard_rays)
from raytrace_tpu_torch.parallel.multiprocess_check import launch  # noqa: E402

TESTS = Path(__file__).resolve().parent
RANKS = 2


@pytest.fixture(scope="module")
def two_ranks():
    """cases.marches on 2 gloo ranks (each rank's dict), and the apps'
    compute without a mesh in this process."""
    saved = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(filter(None, [str(TESTS), saved]))
    try:
        ranks = launch("torch_parallel_cases:marches", RANKS, device="cpu")
    finally:
        os.environ.pop("PYTHONPATH")
        if saved is not None:
            os.environ["PYTHONPATH"] = saved
    return ranks, cases.apps("cpu")


def test_mesh_of_one_process():
    """Without torch.distributed a process is a world of one; the CPU is
    named, the card is the default; auto_mesh shards nothing."""
    mesh = make_ray_mesh(device="cpu")
    assert mesh == RayMesh(group=None, rank=0, size=1, device=torch.device("cpu"))
    assert auto_mesh("cpu") is None
    with pytest.raises(ValueError, match="rank"):
        make_ray_mesh(2, device="cpu")


def test_pad_and_shard_follow_jax():
    """pad_rays pads as JAX's pad_rays (the same length, every field's tail
    zeros but steps -1), and shard_rays gives each rank the rows that
    P("rays") gives device ``rank`` of JAX's 8-device mesh."""
    import jax
    import jax.numpy as jnp

    from raytrace_tpu.parallel import make_ray_mesh as jmesh
    from raytrace_tpu.parallel import pad_rays as jpad
    from raytrace_tpu.sources import PointSourceGrid, point_source

    _, rays = cases.lamppost()
    jrays = point_source(cases.SOURCE, V=0.0, spin=cases.SPIN,
                         grid=PointSourceGrid.from_steps(*cases.TRACE_GRID))
    n = rays.n_rays
    assert n % 8 and jrays.n_rays == n
    padded, jpadded = pad_rays(rays, 8), jpad(jrays, 8)
    assert padded.n_rays == jpadded.n_rays
    for f in rays.__dataclass_fields__:
        head, tail = getattr(padded, f)[:n], getattr(padded, f)[n:].numpy()
        assert torch.equal(head, getattr(rays, f)), f
        np.testing.assert_array_equal(tail, np.asarray(getattr(jpadded, f))[n:], err_msg=f)
    assert (padded.steps[n:] == -1).all() and (padded.r[n:] == 0).all()
    index = jax.device_put(jnp.arange(padded.n_rays), jax.sharding.NamedSharding(
        jmesh(8), jax.sharding.PartitionSpec("rays")))
    padded = padded.replace(alpha=torch.arange(padded.n_rays, dtype=torch.float64))
    for shard in index.addressable_shards:
        mine = shard_rays(padded, RayMesh(None, shard.device.id, 8, torch.device("cpu")))
        np.testing.assert_array_equal(mine.alpha.numpy(), np.asarray(shard.data))


def test_sharded_trace_two_ranks_bitwise(two_ranks):
    """sharded_trace on 2 ranks: each rank's shard, laid end to end, is the
    single-process march of the padded batch bit for bit in every field,
    and the padding stays dead."""
    ranks, _ = two_ranks
    _, rays = cases.lamppost()
    padded = pad_rays(rays, RANKS)
    ref = trace(padded, cases.SPIN, **cases.TRACE_KW)
    for f in ref.__dataclass_fields__:
        got = np.concatenate([r[f"trace_{f}"] for r in ranks])
        np.testing.assert_array_equal(got, getattr(ref, f).numpy(), err_msg=f)
    assert (np.concatenate([r["trace_steps"] for r in ranks])[rays.n_rays:] == -1).all()


def test_apps_over_two_ranks_match_one_process(two_ranks):
    """The apps' mesh branches on 2 ranks against the same compute alone:
    every rank returns the same output. Emissivity (sharded_emissivity_bins:
    one all_reduce of the bins): ray counts and radii exactly, the sums to
    rtol 1e-12 for their reassociation (measured bit for bit). Caustic maps
    (sharded_caustic_trace: the bundles gathered back to full width): hit
    and order exactly, det_j to rtol 1e-6, since on the CPU a float can
    move by an ulp with the batch's length, where torch leaves the tail of
    a vectorised loop to the scalar libm (measured: the gathered bundles'
    r within 3.4e-11 of the whole batch's march, statuses and steps
    equal), which the bundles' differences amplify; the card computes each
    element alike. Disc image (sharded_disc_image): counts exactly, the
    maps to rtol 1e-9."""
    ranks, one = two_ranks
    for r in ranks:
        for k in ("r", "area", "rays"):
            np.testing.assert_array_equal(r[f"emis_{k}"], one[f"emis_{k}"], err_msg=k)
        for k in ("flux", "emis", "redshift", "time"):
            np.testing.assert_allclose(r[f"emis_{k}"], one[f"emis_{k}"], rtol=1e-12, err_msg=k)
        for k in ("hit", "order"):
            np.testing.assert_array_equal(r[f"caustic_{k}"], one[f"caustic_{k}"], err_msg=k)
        np.testing.assert_allclose(r["caustic_det_j"], one["caustic_det_j"], rtol=1e-6)
        np.testing.assert_array_equal(r["image_counts"], one["image_counts"])
        for k in ("flux", "r", "phi", "enshift", "time", "emis"):
            np.testing.assert_allclose(r[f"image_{k}"], one[f"image_{k}"], rtol=1e-9, err_msg=k)
    assert one["emis_rays"].sum() > 50 and one["caustic_hit"].sum() > 20
    assert one["image_counts"].sum() > 100


def test_scaling_bench_on_gloo_ranks(capsys):
    """scaling_bench.run on the CPU (gloo ranks sharing the host: the
    mechanics only): worlds 1 and 2, the weak-scaling batch growing with the
    ranks, each world's record a JSON line with its efficiency against
    world 1; on one world it says that world 1 is all it measured."""
    from raytrace_tpu_torch.parallel import scaling_bench

    recs = scaling_bench.run("cpu", max_world=2, rays_per_shard=64, steplim=300)
    assert [r["world"] for r in recs] == [1, 2]
    assert recs[1]["rays"] > recs[0]["rays"] >= 64 and all(r["binned"] > 0 for r in recs)
    assert recs[1]["weak_scaling_efficiency"] > 0 and "weak_scaling_efficiency" not in recs[0]
    out = capsys.readouterr().out.splitlines()
    assert [json.loads(ln)["world"] for ln in out] == [1, 2]
    scaling_bench.run("cpu", max_world=1, rays_per_shard=64, steplim=300)
    assert "measured world 1 alone" in capsys.readouterr().out
