"""The caustic_plane configuration of the port's benchmark, at test sizes.

On the CPU the port marches in float64 (the plain route) and so does the
plain reference (``portbench/reference/caustic.py``): the port's job and
the reference's map agree bit for bit on every pixel, and the reference
sampled at a few pixels (with their grid neighbours, the map's edge
included) is the whole-map reference there. The reference one precision
lower (``control --kind all``) fails the cell's limit. The reference's
``FlatPlane`` is the port's, bit for bit; ``host_tail_ms`` reads a
hand-built window; the cell's table and readers resolve. The test marked
``cuda`` holds the reference's card-seeded bundle starts to the port's at
the cell's full width. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_portbench_caustic_plane.py
"""

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from portbench import harness  # noqa: E402
from portbench.reference import caustic  # noqa: E402

CELL = "caustic_plane_incl"
# a small geometry: dist and z_s 500, a 9 x 9 map of bundles, a bounded march
SMALL = {"dist": 500.0, "z_s": 500.0, "r_max": 2000.0, "Nx": 8, "x0": -15.0, "xmax": 15.0,
         "steplim": 3000}


def small_par(incl):
    cell = harness.load_cell(harness.load_spec(), CELL)
    return dict(cell.config["par"], **SMALL, incl=incl), cell.config


@pytest.fixture(scope="module")
def entry():
    return harness.load_driver("caustic_plane")


@pytest.fixture(scope="module")
def whole_map(entry):
    """Per inclination: the par values, the configuration, the port's job
    on the CPU and the reference's whole map."""
    done = {}

    def get(incl):
        if incl not in done:
            par, config = small_par(incl)
            grid, _ = caustic.camera(par)
            pixels = np.arange(grid.n_rays)
            done[incl] = (par, config, entry.run(par, device="cpu"),
                          entry.reference(par, pixels, config, device="cpu"))
        return done[incl]

    return get


@pytest.mark.parametrize("incl", [30.0, 80.0])
def test_job_is_the_reference_on_every_pixel(entry, whole_map, incl):
    par, _, out, ref = whole_map(incl)
    pixels = np.arange(caustic.camera(par)[0].n_rays)
    assert entry.compare(out, ref, pixels) == {"pixel_gap": 0, "class_gap": 0,
                                                "coord_gap": 0.0}
    for k in caustic.MAPS:
        assert out[k].shape == (9, 9), k
    # the maps hold something: hits and misses, signs of det J, SENTINEL
    # at order boundaries and pixels the suppression pass turned
    assert 0 < out["hit"].sum() < 81
    assert (out["sign_j"] != 0).any() and (out["det_j"] == caustic.SENTINEL).any()
    assert out["n_suppressed"] > 0


@pytest.mark.parametrize("incl", [30.0, 80.0])
def test_sampled_reference_is_the_whole_map_at_its_pixels(whole_map, incl):
    par, config, _, ref = whole_map(incl)
    # corners, edges and the middle, and a pixel beside each
    pixels = np.array([0, 1, 4, 8, 9, 36, 40, 41, 44, 72, 76, 80])
    part = caustic.caustic_plane_pixels(par, pixels, device="cpu", march_dtype=torch.float64)
    for k in caustic.MAPS:
        np.testing.assert_array_equal(part[k], ref[k][pixels], err_msg=k)


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import portbench.reference.caustic; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('raytrace_tpu_torch', 'raytrace_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = Path(harness.__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_neighbourhood_of_edge_pixels():
    """The pixels (0, 0), (1, 1) and (2, 3) of a 3 x 4 map: their
    neighbours inside the map, in the order (ix - 1), (ix + 1), (iy - 1),
    (iy + 1), -1 outside it."""
    need, around = caustic.neighbourhood(np.array([0, 5, 11]), 3, 4)
    assert need.tolist() == [0, 1, 4, 5, 6, 7, 9, 10, 11]
    assert [f.tolist() for f in around] == [[-1, 1, 7], [4, 9, -1], [-1, 4, 10], [1, 6, -1]]


def test_control_in_lower_precision_is_not_correct(entry, whole_map):
    par, config, _, ref = whole_map(80.0)
    pixels = np.arange(caustic.camera(par)[0].n_rays)
    control = entry.control(par, pixels, config, device="cpu", kind="all")
    ok, checks = harness.verdict(entry.compare(control, ref, pixels), config["limits"])
    assert not ok, checks
    # most pixels differ, and some in how they are classified
    assert checks["pixel_gap"]["value"] > len(pixels) / 2
    assert checks["class_gap"]["value"] > config["limits"]["class_gap"]
    with pytest.raises(ValueError, match="sums"):
        entry.control(par, pixels, config, device="cpu", kind="sums")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("incl_deg, phi0, z_s", [(80.0, 0.0, 1e4), (30.0, 0.4, 500.0)])
def test_flat_plane_is_the_ports(incl_deg, phi0, z_s, dtype):
    from raytrace_tpu_torch.destinations import FlatPlane

    gen = torch.Generator().manual_seed(11)
    n = 4000
    r = (1.5 + 3e4 * torch.rand(n, generator=gen, dtype=torch.float64)).to(dtype)
    theta = (math.pi * torch.rand(n, generator=gen, dtype=torch.float64)).to(dtype)
    phi = (14.0 * torch.rand(n, generator=gen, dtype=torch.float64) - 7.0).to(dtype)
    incl = math.radians(incl_deg)
    ref, port = caustic.FlatPlane(incl, phi0, z_s), FlatPlane(incl=incl, phi0=phi0, z_s=z_s)
    assert torch.equal(ref.projection(r, theta, phi), port.projection(r, theta, phi))
    assert torch.equal(ref.reached(r, theta, phi, theta), port.reached(r, theta, phi, theta))
    assert ref.reached(r, theta, phi, theta).any()
    for a, b in zip(ref.source_coords(r, theta, phi), port.source_coords(r, theta, phi)):
        assert torch.equal(a, b)
    assert torch.equal(ref.step_limit(r, theta, phi, r, r, r), port.step_limit(r, theta, phi,
                                                                                r, r, r))


def test_host_tail_ms_on_a_hand_built_window():
    reader = harness.load_metric("host_tail_ms")
    events = [("march_kernel", "kernel", 0.10, 0.60), ("copy", "memcpy", 0.50, 0.70),
              ("late", "kernel", 0.95, 1.30),  # starts in job 0, ends in job 1
              ("march_kernel", "kernel", 1.20, 2.00), ("copy", "memcpy", 2.00, 2.10)]
    spans = [("job:3", 0.0, 1.0), ("source", 0.05, 0.08), ("job:1", 1.0, 2.5),
             ("job:0", 2.6, 3.0)]  # a job with nothing on the card counts no tail
    window = harness.Window(events, spans, 3, 3.0)
    assert reader.read(window) == pytest.approx(1e3 * ((1.0 - 1.30) + (2.5 - 2.10)) / 2)
    assert reader.read(harness.Window([], spans, 3, 3.0)) is None
    assert reader.read(harness.Window(events, [("source", 0.0, 1.0)], 0, 3.0)) is None


def test_cell_table_and_readers():
    spec = harness.load_spec()
    cell = harness.load_cell(spec, CELL)
    rows = harness.job_rows(cell.traffic)
    assert [r["incl"] for r in rows] == [30.0, 45.0, 60.0, 75.0, 80.0]
    entry = harness.load_driver(cell.config["driver"])
    assert {entry.rays(harness.job_params(cell.config, r)) for r in rows} == {1_255_005}
    assert cell.chips == 1 and cell.config["reduced"] == []
    assert [m["name"] for m in cell.end_to_end] == ["rays_per_s.image", "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    assert names == [f"{q}.caustic" for q in ("source_ms", "march_ms", "other_device_ms",
                                              "launches_per_job", "device_idle_share",
                                              "host_tail_ms")]
    for m in cell.per_layer:
        assert callable(harness.load_metric(harness.quantity(m["name"])).read)
        assert m["moves"] == "rays_per_s.image"
    # the entry's keyword arguments are compute_args' own, at the par file's widths
    kw = entry.compute_kwargs(harness.job_params(cell.config, rows[-1]), "cpu")
    assert (kw["grid"].nx, kw["grid"].ny, kw["target"], kw["use_bundles"]) == (501, 501,
                                                                               "plane", True)
    assert (kw["dist"], kw["z_s"], kw["r_lim"], kw["method"], kw["steplim"]) == (
        1e4, 1e4, 4e4, "rk45", None)
    assert kw["ctrl"].rk45_tol == 1e-8 and kw["bundle_eps_frac"] == 0.01


@pytest.mark.cuda
def test_card_bundle_starts_are_the_ports():
    """At the cell's 501 x 501 map, incl 80: the reference's bundles seeded
    on the card are the port's, bit for bit, in all 15 marched float
    fields after ``redshift_start`` and the kernel's ``prepare``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card camera runs CUDA's libdevice")
    from portbench.reference.kerr import horizon_radius
    from portbench.reference.march import _fresh_propagation_state
    from portbench.reference.redshift import redshift_start as ref_redshift_start
    from raytrace_tpu_torch.destinations import FlatPlane
    from raytrace_tpu_torch.ops import march_kernel
    from raytrace_tpu_torch.ops.redshift import redshift_start
    from raytrace_tpu_torch.sources import image_plane_bundles

    card = torch.device("cuda")
    cell = harness.load_cell(harness.load_spec(), CELL)
    par = harness.job_params(cell.config, {"incl": 80.0})
    entry = harness.load_driver("caustic_plane")
    kw = entry.compute_kwargs(par, "cuda")
    a_trace = -kw["spin"]
    rays, eps = image_plane_bundles(kw["dist"], kw["incl_deg"], kw["grid"], kw["spin"],
                                    kw["phi0"], eps_frac=kw["bundle_eps_frac"], device=card)
    assert rays.n_rays == 1_255_005 and eps == caustic.camera(par)[1]
    rays = redshift_start(rays, a_trace, V=0.0, reverse=True)
    dest = FlatPlane(incl=math.radians(kw["incl_deg"]), phi0=kw["phi0"], z_s=kw["z_s"])
    _, _, buf, _ = march_kernel.prepare(rays, a_trace, method="rk45", dest=dest,
                                        r_max=kw["r_lim"], steplim=100_000, ctrl=kw["ctrl"],
                                        boundary=None, march_dtype=torch.float64)

    pixels = np.arange(kw["grid"].n_rays)
    ref = caustic.bundle_rays(par, pixels, device=card, dtype=torch.float64,
                              work_dtype=torch.float64)
    ref = ref_redshift_start(ref, a_trace, V=0.0, reverse=True)
    ref = _fresh_propagation_state(ref, a_trace, horizon_radius(a_trace), "rk45",
                                   caustic.step_control(par))
    assert len(march_kernel.F_FIELDS) == 15
    for f in march_kernel.F_FIELDS:
        a, b = buf[f], getattr(ref, f)
        assert a.dtype == b.dtype == torch.float64, f
        assert torch.equal(a.view(torch.int64), b.view(torch.int64)), f
