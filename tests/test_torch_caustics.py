"""The port's caustics slice against the JAX package.

The source plane and far sphere (``FlatPlane``, ``SphericalShell``), the
5-ray bundles of ``image_plane_bundles``, the numpy Jacobian helpers and the
checkerboard suppression are held against the JAX functions on the same
numpy-made inputs; ``apps/caustics.compute`` for the three targets against
the JAX ``compute`` on a 21 x 21 grid; the three CLIs and the apps' device
default. On the CPU the port marches with its plain lock-step version. The
reference-binary goldens are in tests/test_torch_caustics_golden.py.

The JAX package is imported inside the tests that use it.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.apps import caustics as port_app  # noqa: E402
from raytrace_tpu_torch.config import Config  # noqa: E402
from raytrace_tpu_torch.destinations import Destination, FlatPlane, SphericalShell  # noqa: E402
from raytrace_tpu_torch.io import read_fits  # noqa: E402
from raytrace_tpu_torch.sources import ImagePlaneGrid, image_plane_bundles  # noqa: E402

SPIN = 0.998
PLANE_FIELDS = ("t", "r", "theta", "phi", "pt", "pr", "ptheta", "pphi", "k", "h", "Q",
                "rdot_sign", "thetadot_sign", "alpha", "beta")


def _points(n=4000, seed=17):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1.5, 3e4, n), rng.uniform(0.0, np.pi, n), rng.uniform(-7.0, 7.0, n),
            rng.normal(0.0, 1.0, n))


@pytest.mark.parametrize("incl_deg, phi0, z_s", [(80.0, 0.0, 1e4), (30.0, 0.4, 500.0)])
def test_flat_plane_matches_jax(incl_deg, phi0, z_s):
    """projection, reached, step_limit (+inf: no cap) and source_coords on
    seeded points, f64. The port takes sin/cos of the inclination from
    ``math``, JAX from XLA: the projection agrees to 1e-14 of r, and
    reached exactly on these points."""
    import jax.numpy as jnp

    from raytrace_tpu import destinations as jd

    r, theta, phi, pr = _points()
    incl = math.radians(incl_deg)
    mine, ref = FlatPlane(incl, phi0, z_s), jd.FlatPlane(incl, phi0, z_s)
    t = [torch.from_numpy(v) for v in (r, theta, phi, pr)]
    j = [jnp.asarray(v) for v in (r, theta, phi, pr)]
    np.testing.assert_allclose(mine.projection(*t[:3]).numpy(),
                               np.asarray(ref.projection(*j[:3])), rtol=0, atol=1e-14 * r.max())
    reached = mine.reached(*t[:3], None).numpy()
    np.testing.assert_array_equal(reached, np.asarray(ref.reached(*j[:3], None)))
    assert 0.05 < reached.mean() < 0.95
    np.testing.assert_array_equal(mine.step_limit(t[0], t[1], t[2], t[3], None, None).numpy(),
                                  np.asarray(ref.step_limit(j[0], j[1], j[2], j[3], None, None)))
    for a, b in zip(mine.source_coords(*t[:3]), ref.source_coords(*j[:3])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-14 * r.max())


def test_spherical_shell_matches_jax():
    """reached and the step cap along pr, exactly; the base Destination caps
    nothing."""
    import jax.numpy as jnp

    from raytrace_tpu import destinations as jd

    r, theta, phi, pr = _points()
    r = r / 300.0
    pr[::40] = 0.0
    mine, ref = SphericalShell(40.0), jd.SphericalShell(40.0)
    t = [torch.from_numpy(v) for v in (r, theta, phi, pr)]
    j = [jnp.asarray(v) for v in (r, theta, phi, pr)]
    np.testing.assert_array_equal(mine.reached(*t[:3], None).numpy(),
                                  np.asarray(ref.reached(*j[:3], None)))
    lim = mine.step_limit(t[0], t[1], t[2], t[3], None, None).numpy()
    np.testing.assert_array_equal(lim, np.asarray(ref.step_limit(j[0], j[1], j[2], j[3], None,
                                                                 None)))
    assert np.isfinite(lim).sum() > 500 and np.isinf(lim).sum() > 500
    assert torch.isinf(Destination().step_limit(t[0], None, None, None, None, None)).all()


GEOMETRIES = {  # (dist, incl, phi0, half-width, spacing)
    "d500_i60": (500.0, 60.0, 0.3, 12.0, 1.2),
    "d1e4_i80": (1e4, 80.0, 0.0, 30.0, 3.0),
}


@pytest.mark.parametrize("work", ["float32", "float64"])
@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_image_plane_bundles_matches_jax(geom, work):
    """The five slots of every pixel, seeded in f64 with the knife-edge
    floor of the batch (and march) dtype and rounded once to it, against
    JAX's f64 seeding of the same plane points with the same floor, with
    the tolerance of tests/test_torch_image.py (test_image_plane_matches_jax)
    in f64 and to an ulp in f32; eps exactly. In f32 also against JAX's
    float32 bundles, to an ulp."""
    import jax.numpy as jnp

    from raytrace_tpu.sources import imageplane as jip

    dist, incl, phi0, w, d = GEOMETRIES[geom]
    grid = ImagePlaneGrid.from_steps(-w, w, d, -w, w, d)
    jgrid = jip.ImagePlaneGrid.from_steps(-w, w, d, -w, w, d)
    mine, eps = image_plane_bundles(dist, incl, grid, SPIN, phi0, device="cpu",
                                    dtype=getattr(torch, work))
    ref, jeps = jip.image_plane_bundles(dist, incl, jgrid, SPIN, phi0)
    assert eps == jeps == 0.01 * d
    x, y = np.asarray(ref.alpha), np.asarray(ref.beta)
    parts, _, _ = jip._seed_f64(jgrid, dist, incl, phi0, -SPIN, xy=(x, y),
                                work_dtype=getattr(jnp, work))
    t, r, theta, phi, mom, consts, rdot_sign, thetadot_sign = parts
    want = dict(zip(PLANE_FIELDS, (t, r, theta, phi, *mom, *consts, rdot_sign, thetadot_sign,
                                   x, y)))
    assert mine.n_rays == 5 * grid.n_rays
    n = grid.n_rays
    if work == "float64":  # in float32 the rounded alpha is held to JAX's below
        np.testing.assert_allclose(mine.alpha.numpy()[n:2 * n] - mine.alpha.numpy()[:n], eps,
                                   rtol=1e-12)
    th, h = np.asarray(theta), np.asarray(consts[1])
    q_scale = np.abs(np.asarray(consts[2])) + (SPIN * np.cos(th)) ** 2 + (h / np.tan(th)) ** 2
    rtol = 1e-14 if work == "float64" else 1.2e-7
    for f in PLANE_FIELDS:
        a, b = getattr(mine, f).numpy(), np.asarray(want[f]).astype(work)
        assert a.dtype == np.dtype(work)
        if f in ("rdot_sign", "thetadot_sign", "alpha", "beta", "t", "k"):
            np.testing.assert_array_equal(a, b, err_msg=f)
        elif f == "Q":
            assert (np.abs(a - b) <= 1e-14 * q_scale + np.spacing(np.abs(b))).all()
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=f)
    assert (mine.steps == 0).all()
    if work == "float32":
        ref32, _ = jip.image_plane_bundles(dist, incl, jgrid, SPIN, phi0, dtype=jnp.float32)
        for f in PLANE_FIELDS:
            np.testing.assert_allclose(getattr(mine, f).numpy(), np.asarray(getattr(ref32, f)),
                                       rtol=1.2e-7, atol=0, err_msg=f)


def _jacobian_inputs(seed=3, nx=23, ny=19):
    """Seeded bundle/grid arrays with invalid rays, order changes and
    branch-cut phases, as the maps hold them."""
    rng = np.random.default_rng(seed)
    shape = (5, nx, ny)
    xd = rng.normal(0.0, 10.0, shape)
    yd = rng.normal(0.0, 10.0, shape)
    valid = rng.random(shape) < 0.85
    phi_acc = rng.normal(0.0, 4.0, shape)
    phi_acc[1:] = phi_acc[0] + rng.normal(0.0, 0.9, shape[1:])
    flips = rng.integers(0, 3, shape)
    flips[1:] = np.where(rng.random((4, nx, ny)) < 0.8, flips[0], flips[1:])
    return xd, yd, valid, phi_acc, flips


def test_jacobian_helpers_match_jax():
    """_jacobian_bundle, _jacobian_grid, _jacobian_grid_sphere, the order
    maps and suppress_checkerboard against the JAX copies, exactly (NaN
    where JAX has NaN)."""
    from raytrace_tpu.apps import caustics as jc

    xd, yd, valid, phi_acc, flips = _jacobian_inputs()
    hit = valid[0]
    eq = lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(port_app._jacobian_bundle((xd, yd), valid, phi_acc, flips, 0.012, hit),
                    jc._jacobian_bundle((xd, yd), valid, phi_acc, flips, 0.012, hit)):
        eq(a, b)
    gx, gy = np.where(hit, xd[0], np.nan), np.where(hit, yd[0], np.nan)
    grid_args = (gx, gy, hit, phi_acc[0], flips[0], 1.2, 0.9)
    det_g, sign_g = port_app._jacobian_grid(*grid_args)
    for a, b in zip((det_g, sign_g), jc._jacobian_grid(*grid_args)):
        eq(a, b)
    order = np.where(hit, port_app._order_map_sphere(phi_acc[0]), -1)
    eq(order, np.where(hit, jc._order_map_sphere(phi_acc[0]), -1))
    eq(port_app._order_map(phi_acc[0], flips[0]), jc._order_map(phi_acc[0], flips[0]))
    sphere_args = (gx, np.mod(gy, 2 * np.pi) - np.pi, hit, order, 0.3, 0.3)
    for a, b in zip(port_app._jacobian_grid_sphere(*sphere_args),
                    jc._jacobian_grid_sphere(*sphere_args)):
        eq(a, b)
    for a, b in zip(port_app.suppress_checkerboard(det_g, sign_g),
                    jc.suppress_checkerboard(det_g, sign_g)):
        eq(a, b)
    assert (det_g == port_app.SENTINEL).sum() > 10 and np.isfinite(det_g).sum() > 10
    assert port_app.SENTINEL == jc.SENTINEL


COMPUTE_CASES = {  # target, use_bundles, keywords
    "disc-bundles": ("disc", True, dict(r_disc=15.0)),
    "disc-grid": ("disc", False, dict(r_disc=15.0)),
    "plane-bundles": ("plane", True, dict(z_s=200.0, r_lim=900.0)),
    "plane-grid": ("plane", False, dict(z_s=200.0, r_lim=900.0)),
    "sphere": ("sphere", False, dict(r_lim=750.0)),
}


@pytest.mark.parametrize("case", list(COMPUTE_CASES))
def test_compute_matches_jax(case):
    """The slice against JAX ``compute`` on a 21 x 21 grid (dist 500, incl
    60, rk4, f64): the hit and order maps differ on at most 1% of pixels
    (a chaotic ray that a libm ulp sends elsewhere). Where both agree, every
    map agrees to 1e-9, SENTINEL and NaN in the same places — det J to
    1e-6 relative (1e-7 absolute): it is a difference quotient over
    landing points 2 eps = 0.02 apart (bundles) or a pixel apart, so the
    ~1e-12 landing noise of two libms becomes ~1e-9 in each derivative and
    more near a critical curve, where |det J| reaches 1e5 here (measured:
    8.4e-9 absolute on the disc, 7.7e-8 relative on the plane)."""
    from raytrace_tpu.apps.caustics import compute as jcompute
    from raytrace_tpu.sources import ImagePlaneGrid as JGrid

    target, bundles, kw = COMPUTE_CASES[case]
    kw = dict(kw, target=target, use_bundles=bundles, method="rk4", steplim=6000)
    grid = ImagePlaneGrid.from_steps(-10.0, 10.0, 1.0, -10.0, 10.0, 1.0)
    mine = port_app.compute(SPIN, 500.0, 60.0, grid, device="cpu", **kw)
    ref = jcompute(SPIN, 500.0, 60.0, JGrid.from_steps(-10.0, 10.0, 1.0, -10.0, 10.0, 1.0), **kw)
    assert set(mine) == set(ref)
    assert (mine["hit"] != ref["hit"]).mean() <= 0.01
    assert (mine["order"] != ref["order"]).mean() <= 0.01
    good = (mine["hit"] == ref["hit"]) & (mine["order"] == ref["order"])
    assert (good & (ref["hit"] > 0)).sum() > 200
    for k, v in ref.items():
        if k in ("diag", "n_suppressed"):
            continue
        a, b = np.asarray(mine[k], np.float64)[good], np.asarray(v, np.float64)[good]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        np.testing.assert_array_equal(a == port_app.SENTINEL, b == port_app.SENTINEL, err_msg=k)
        finite = np.isfinite(b) & (b != port_app.SENTINEL)
        tol = dict(rtol=1e-6, atol=1e-7) if k == "det_j" else dict(rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(a[finite], b[finite], err_msg=k, **tol)
    for k in ("horizon", "rlim", "hits"):
        assert abs(mine["diag"][k] - ref["diag"][k]) <= 0.01 * grid.n_rays


_PARFILES = {"disc": "caustic_discplane.par", "plane": "caustic_plane.par",
             "sphere": "caustic_sourceplane.par"}
_MAINS = {"disc": "main_discplane", "plane": "main_plane", "sphere": "main_sourceplane"}


def _par(target):
    from pathlib import Path

    return Path(__file__).resolve().parent.parent / "par_example" / _PARFILES[target]


@pytest.mark.parametrize("target", ["disc", "plane", "sphere"])
def test_app_cli(tmp_path, target):
    """Each CLI on its par file cut to a 9 x 9 grid at dist 500 (--device=cpu):
    the FITS file carries the target's extensions with the axis keywords,
    finite, and hits."""
    out = tmp_path / "c.fits"
    argv = [f"--parfile={_par(target)}", f"--outfile={out}", "--device=cpu", "--Nx=8",
            "--dist=500", "--z_s=300", "--r_lim=800", "--integrator=rk4", "--steplim=6000"]
    assert getattr(port_app, _MAINS[target])(argv) == 0
    fits = read_fits(str(out))
    hdr = fits["_headers"]
    for ext, key in port_app._EXTENSIONS[target]:
        assert fits[ext].shape == (9, 9) and np.isfinite(fits[ext]).all()
        assert int(hdr[ext]["NX"]) == 9
    hit = {"disc": "HIT", "plane": "HIT_PLANE", "sphere": "ESCAPED"}[target]
    assert fits[hit].sum() > 0
    assert hdr["PRIMARY"]["GENERATO"].strip("' ") == f"caustic_{target}"


def test_compute_args_of_shipped_par_files():
    """The CLIs' reading of par_example/caustic_*.par: the full-width runs
    that chip_smoke drives on the card, float64 march."""
    sizes = {}
    for target in ("disc", "plane", "sphere"):
        kw, axes = port_app.compute_args(Config([f"--parfile={_par(target)}"]), target)
        n_slots = 5 if kw["use_bundles"] else 1
        sizes[target] = n_slots * kw["grid"].n_rays
        assert (kw["dist"], kw["incl_deg"], kw["spin"], kw["method"]) == (1e4, 80.0, 0.998, "rk45")
        assert dict(axes)["NX"] == 501
    assert sizes == {"disc": 1_255_005, "plane": 1_255_005, "sphere": 251_001}
    kw, _ = port_app.compute_args(Config([f"--parfile={_par('plane')}"]), "plane")
    assert (kw["z_s"], kw["r_lim"]) == (1e4, 4e4)


def test_apps_run_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """Without --device every app picks cuda; with no card visible it
    raises rather than carry on on the CPU."""
    from raytrace_tpu_torch.apps import emissivity, imageplane_disc_image

    par = tmp_path / "e.par"
    par.write_text("spin = 0.998\nsource = 0 5 1E-3 1.5707\ndcosalpha = 0.5\ndbeta = 1.0\n")
    assert emissivity.compute_args(Config([f"--parfile={par}"]))["device"] == torch.device("cuda")
    kw, _ = port_app.compute_args(Config([f"--parfile={_par('disc')}"]), "disc")
    assert kw["device"] == torch.device("cuda")
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the apps would run on it")
    img = tmp_path / "i.par"
    img.write_text("dist = 500\nincl = 60\nspin = 0.998\nr_disc = 15\nNx = 4\n")
    mains = [(emissivity.main, par), (imageplane_disc_image.main_isco, img),
             (port_app.main_plane, _par("plane"))]
    for main, p in mains:
        with pytest.raises(RuntimeError, match="--device=cpu"):
            main([f"--parfile={p}", f"--outfile={tmp_path / 'x'}", "--Nx=4"])
