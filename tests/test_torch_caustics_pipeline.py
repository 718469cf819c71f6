"""The caustic map's one post-march path (``apps.caustics.compute``).

The march comes back in pieces, each a run of pixel ranges, and the host
maps each piece as it comes. On a card with no mesh the map splits into
pixel ranges, each marched by a launch of its own on its own stream under
the grid launch (``ops.trace_in_ranges``, ``ops.trace_kernel_ranges``);
on the CPU and over a mesh the map is one range and the batch one piece.
The CPU tests hold the host's half of that path: maps assembled range by
range (``_pixel_maps`` on each range's rays, laid out as the card lays
them, ``_assemble``, then ``_whole_maps``) are bitwise the maps of one
range, for the flat source plane with bundles and for the source sphere's
grid neighbours, whatever the number of ranges; the range-major ray
order, the rule for the number of ranges, ``trace_in_ranges``'s one piece
of a batch marched whole, and the maps over a world of one (a mesh)
bitwise those without a mesh. The ``cuda`` test holds the path itself on
the card: the plane's reduced map that holds a stuck ray, the disc under
both schedules and the sphere, each in seven ranges bitwise in one range
and marched whole over a world of one, with every range's span inside
``rt.compute``.

    python -m pytest --noconftest -m cuda tests/test_torch_caustics_pipeline.py
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch import ops  # noqa: E402
from raytrace_tpu_torch.apps import caustics  # noqa: E402
from raytrace_tpu_torch.destinations import ThetaLimit  # noqa: E402
from raytrace_tpu_torch.ops import StepControl  # noqa: E402
from raytrace_tpu_torch.parallel import RayMesh  # noqa: E402
from raytrace_tpu_torch.rays import RAY_STATUS_STEPLIM  # noqa: E402
from raytrace_tpu_torch.sources import ImagePlaneGrid, image_plane  # noqa: E402
from raytrace_tpu_torch.utils import profiling  # noqa: E402

# par_example/caustic_plane.par at incl 80 on 21 x 21 pixels, and the source
# sphere at the same camera; a step limit the CPU march reaches in seconds
GRID = ImagePlaneGrid.from_steps(-30.0, 30.0, 3.0, -30.0, 30.0, 3.0)
TARGETS = {
    "plane": dict(target="plane", z_s=1e4, r_lim=4e4),
    "sphere": dict(target="sphere"),
}


def _cpu_compute(target, **kw):
    return caustics.compute(0.998, 1e4, 80.0, GRID, steplim=3000,
                            ctrl=StepControl(rk45_tol=1e-8), device="cpu", **TARGETS[target], **kw)


def _assert_bitwise(a, b):
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
        else:
            assert a[k] == b[k], k


@functools.cache
def _no_mesh(target):
    """A CPU run with no mesh: the host fields it mapped (slot-major,
    (slots, pixels)), ``_pixel_maps``'s keywords and the maps."""
    seen = {}
    pixel_maps = caustics._pixel_maps

    def spy(fields, **kw):
        seen.update(fields=fields, kw=kw)
        return pixel_maps(fields, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(caustics, "_pixel_maps", spy)
        maps = _cpu_compute(target)
    return seen["fields"], seen["kw"], maps


@pytest.fixture(scope="module", params=sorted(TARGETS))
def marched(request):
    """The target and ``_no_mesh``'s run of it."""
    return request.param, *_no_mesh(request.param)


@pytest.mark.parametrize("ranges", [1, 2, 7, 64])
def test_maps_assembled_range_by_range_are_the_whole_maps(marched, ranges):
    """Each range's rays as the route copies them (one contiguous
    (slots, m) block a field), mapped and assembled, then the passes over
    the whole map: every map bitwise the single batch's, NaN for NaN and
    SENTINEL for SENTINEL, and the suppressed count and diagnostics equal.
    64 ranges are more than the map's 21 rows; 2 and 64 cut inside a row."""
    target, fields, kw, whole = marched
    n_pixels = GRID.nx * GRID.ny
    bounds = caustics._range_bounds(n_pixels, ranges)
    assert len(bounds) == ranges + 1 and bounds[0] == 0 and bounds[-1] == n_pixels
    assert all(p0 < p1 for p0, p1 in zip(bounds, bounds[1:]))
    if ranges in (2, 64):
        assert any(p % GRID.ny for p in bounds[1:-1])

    pix = {}
    for p0, p1 in zip(bounds, bounds[1:]):
        part = {f: np.ascontiguousarray(v[:, p0:p1]) for f, v in fields.items()}
        caustics._assemble(pix, p0, p1, caustics._pixel_maps(part, **kw), n_pixels)
    got = caustics._whole_maps(pix, target=target, grid=GRID)

    _assert_bitwise(got, whole)
    assert whole["diag"]["hits"] > 0 and np.isnan(whole["det_j"]).any()
    if target == "plane":
        assert (whole["det_j"] == caustics.SENTINEL).any() and whole["n_suppressed"] > 0


@pytest.mark.parametrize("n_slots", [1, 5])
@pytest.mark.parametrize("ranges", [1, 7, 64])
def test_range_major_order_makes_each_range_one_block(n_slots, ranges):
    """``_range_major``: a permutation of the slot-major batch in which
    range k's rays are the contiguous block [slots * p0, slots * p1), slot
    after slot, each slot's pixels in order."""
    n_pixels = GRID.nx * GRID.ny
    bounds = caustics._range_bounds(n_pixels, ranges)
    order = caustics._range_major(bounds, n_slots, "cpu").numpy()
    assert sorted(order.tolist()) == list(range(n_slots * n_pixels))
    for p0, p1 in zip(bounds, bounds[1:]):
        block = order[n_slots * p0:n_slots * p1].reshape(n_slots, p1 - p0)
        want = np.arange(n_slots)[:, None] * n_pixels + np.arange(p0, p1)[None, :]
        np.testing.assert_array_equal(block, want)


@pytest.mark.parametrize("n_pixels, ranges", [(1, 1), (4095, 1), (8192, 2), (61_439, 14),
                                              (251_001, 16), (10 ** 7, 16)])
def test_ranges_follow_the_pixel_count(n_pixels, ranges):
    """One range a 4,096 pixels, at least one and at most 16."""
    assert caustics.ranges_for(n_pixels) == ranges


@pytest.mark.parametrize("cuts", [[0, 441], [0, 5, 6, 200, 441]])
def test_trace_auto_gives_a_whole_march_as_one_piece(cuts):
    """Off the card's grid launch (here the plain march on the CPU),
    ``trace_in_ranges`` marches the batch whole with ``trace_auto``,
    counted once as its route, and gives it as one piece over every range:
    bitwise ``trace_auto``'s batch, with no stream."""
    rays = image_plane(1e4, 80.0, GRID, 0.998, device="cpu", dtype=torch.float64)
    kw = dict(method="rk4", r_max=1.5e4, steplim=400, dest=ThetaLimit(0.0))
    whole = ops.trace_auto(rays, -0.998, **kw)
    plain = ops.routes["plain"]
    landed = list(ops.trace_in_ranges(rays, -0.998, cuts, **kw))
    assert ops.routes["plain"] == plain + 1
    assert len(landed) == 1
    k0, k1, part, stream = landed[0]
    assert (k0, k1, stream) == (0, len(cuts) - 1, None) and part.n_rays == rays.n_rays
    for f in ("r", "theta", "phi", "steps", "status", "rdot_flips"):
        assert getattr(part, f).numpy().tobytes() == getattr(whole, f).numpy().tobytes()


# the disc of the card's cases below on a 9 x 9 camera, marched on the CPU
CPU_DISC = dict(spin=0.998, dist=500.0, incl_deg=60.0, target="disc", r_disc=20.0,
                steplim=1000, grid=ImagePlaneGrid.from_steps(-12.0, 12.0, 3.0, -12.0, 12.0, 3.0))


@pytest.mark.parametrize("target", ["disc", "plane", "sphere"])
def test_maps_over_a_world_of_one_are_the_maps_without_a_mesh(target):
    """On the CPU the maps over a world of one (``sharded_caustic_trace``,
    its piece with no stream) are bitwise those with no mesh
    (``trace_in_ranges``'s piece): every map, the diagnostics and the
    suppressed count; for the disc, whose redshift runs on the piece, and
    for the plane and the sphere."""
    world = RayMesh(group=None, rank=0, size=1, device=torch.device("cpu"))
    if target == "disc":
        alone = caustics.compute(**CPU_DISC, device="cpu")
        meshed = caustics.compute(**CPU_DISC, device="cpu", mesh=world)
    else:
        alone, meshed = _no_mesh(target)[2], _cpu_compute(target, mesh=world)
    _assert_bitwise(meshed, alone)
    assert alone["diag"]["hits"] > 0


# The benchmark's map (portbench/configs/caustic_plane.json: pixels
# -30 + i * DX) cut to 31 x 31 pixels around pixel (250, 214), whose east
# satellite reaches the RK45 step limit at incl 80; the cut grid's centre
# pixel has that pixel's coordinates bit for bit, so the same rays.
DX = 60.0 / 500
CARD = {
    "plane": dict(spin=0.998, dist=1e4, incl_deg=80.0, target="plane", z_s=1e4, r_lim=4e4,
                  ctrl=StepControl(rk45_tol=1e-8),
                  grid=ImagePlaneGrid(31, 31, -15 * DX, -30.0 + 214 * DX - 15 * DX, DX, DX)),
    # the disc under the grid launch (rk4 x isco f64) and under the refill
    # schedule (rk45 x isco f64), whose batch marches whole and lands in order
    "disc_rk4": dict(spin=0.998, dist=500.0, incl_deg=60.0, target="disc", r_disc=20.0,
                     method="rk4", grid=ImagePlaneGrid.from_steps(-12.0, 12.0, 0.6, -12.0, 12.0,
                                                                  0.6)),
    "disc_rk45": dict(spin=0.998, dist=500.0, incl_deg=60.0, target="disc", r_disc=20.0,
                      grid=ImagePlaneGrid.from_steps(-12.0, 12.0, 0.6, -12.0, 12.0, 0.6)),
    "sphere": dict(spin=0.998, dist=1e4, incl_deg=80.0, target="sphere", grid=GRID),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD))
def test_maps_in_ranges_are_one_batchs_on_cuda(case, monkeypatch):
    """On the card, with no mesh, each map in seven ranges is bitwise the
    map in one range and the map of the batch marched whole (a world of
    one passed as the mesh), all its maps: the plane's with a stuck ray,
    the disc's under the grid launch and under the refill schedule (whose
    redshifts run on each landed piece), and the sphere's. The ranges
    count one route; under the grid launch a launch a range, each range
    mapped once, and the ranges that land together copied as one piece;
    under the refill schedule one launch and one piece. Every span of the
    run lies inside ``rt.compute``: a ``rt.march.finish`` (under the grid
    launch), a ``rt.to_host`` and a ``rt.maps`` a piece, then the last
    ``rt.maps``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the march kernel has no CPU build")
    kw = CARD[case]
    grid_launch = case != "disc_rk45"
    stuck = []
    pixel_maps = caustics._pixel_maps

    def spy(fields, **kw):
        stuck.append(int(((fields["status"] & RAY_STATUS_STEPLIM) != 0).sum()))
        return pixel_maps(fields, **kw)

    monkeypatch.setattr(caustics, "_pixel_maps", spy)
    monkeypatch.setattr(caustics, "ranges_for", lambda n_pixels: 7)
    routes, launches = ops.routes["kernel"], ops.march_kernel.launches
    profiling.start()
    try:
        seven = caustics.compute(**kw, device="cuda")
    finally:
        rec = profiling.stop()
    assert ops.routes["kernel"] - routes == 1
    assert ops.march_kernel.launches - launches == (7 if grid_launch else 1)
    assert len(rec.launches) == (7 if grid_launch else 1) and rec.uncounted == 0
    assert len(stuck) == 7 and seven["diag"]["hits"] > 0
    if case == "plane":
        assert sum(stuck) >= 1
    monkeypatch.setattr(caustics, "ranges_for", lambda n_pixels: 1)
    one = caustics.compute(**kw, device="cuda")
    world = RayMesh(group=None, rank=0, size=1, device=torch.device("cuda"))
    whole = caustics.compute(**kw, device="cuda", mesh=world)
    _assert_bitwise(seven, one)
    _assert_bitwise(seven, whole)

    spans = rec.spans
    assert spans[0][0] == "rt.compute" and spans[0][1] == -1
    for name, parent, s, e in spans[1:]:
        assert parent >= 0 and spans[0][2] <= s <= e <= spans[0][3], name
        assert spans[parent][2] <= s and e <= spans[parent][3], name
    top = [name for name, parent, *_ in spans if parent == 0]
    each = ["rt.march.finish"] * grid_launch + ["rt.to_host", "rt.maps"]
    pieces = (len(top) - 4) // len(each)
    assert 1 <= pieces <= (7 if grid_launch else 1)
    assert top == ["rt.source", "rt.redshift", "rt.march"] + each * pieces + ["rt.maps"]
