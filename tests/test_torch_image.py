"""The port's image-plane disc-image slice against the JAX package and the
reference binary's goldens.

Sources, redshifts, pixel binning and FITS output are held against the JAX
functions on the same numpy-made inputs; the three variants of
``apps/imageplane_disc_image.compute`` (plain, rd, isco) against the JAX
``compute`` on a small grid and, for plain and isco, against the reference
binary's accumulation arrays with the gates of tests/test_images.py. On the
CPU the port marches with its plain lock-step version in f64.

The JAX package is imported inside the tests that use it.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.apps import imageplane_disc_image as port_app  # noqa: E402
from raytrace_tpu_torch.destinations import DiscWithISCO, FlatDisc, ThetaLimit  # noqa: E402
from raytrace_tpu_torch.geometry import isco_radius  # noqa: E402
from raytrace_tpu_torch.io import read_fits  # noqa: E402
from raytrace_tpu_torch.rays import from_numpy  # noqa: E402
from raytrace_tpu_torch.sources import ImagePlaneGrid, image_plane  # noqa: E402

SPIN = 0.998
PLANE_FIELDS = ("t", "r", "theta", "phi", "pt", "pr", "ptheta", "pphi", "k", "h", "Q",
                "rdot_sign", "thetadot_sign", "alpha", "beta")
MAPS = ("flux", "r", "phi", "enshift", "time", "emis")


def _numpy_batch(rays):
    return {f: np.asarray(getattr(rays, f)) for f in rays.__dataclass_fields__}


# (dist, incl, phi0, half-width, spacing): the golden geometry and the
# par_example's far field; both grids hold the knife-edge row y = 0
GEOMETRIES = {
    "d500_i60": (500.0, 60.0, 0.3, 20.0, 0.5),
    "d1e4_i80": (1e4, 80.0, -0.7, 30.0, 1.0),
}


@pytest.mark.parametrize("work", ["float32", "float64"])
@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_image_plane_matches_jax(geom, work):
    """Every field to 1e-14 relative, signs and plane coordinates equal.
    With a float32 march the knife-edge floor takes float32's epsilon:
    JAX's f64 seeding with ``work_dtype=float32`` is the reference."""
    import jax.numpy as jnp

    from raytrace_tpu.sources import imageplane as jip

    dist, incl, phi0, w, d = GEOMETRIES[geom]
    grid = ImagePlaneGrid.from_steps(-w, w, d, -w, w, d)
    jgrid = jip.ImagePlaneGrid.from_steps(-w, w, d, -w, w, d)
    mine = image_plane(dist, incl, grid, SPIN, phi0, device="cpu",
                       work_dtype=getattr(torch, work))
    parts, x, y = jip._seed_f64(jgrid, dist, incl, phi0, -SPIN,
                                work_dtype=getattr(jnp, work))
    t, r, theta, phi, mom, consts, rdot_sign, thetadot_sign = parts
    ref = dict(zip(PLANE_FIELDS, (t, r, theta, phi, *mom, *consts, rdot_sign, thetadot_sign,
                                  x, y)))
    assert 0.0 in y  # the knife edge is on the grid
    # Q = l_theta^2 - (a cos theta)^2 + (h / tan theta)^2 cancels: its
    # relative difference is taken against the size of its terms
    th, h = np.asarray(theta), np.asarray(consts[1])
    q_scale = np.abs(np.asarray(consts[2])) + (SPIN * np.cos(th)) ** 2 + (h / np.tan(th)) ** 2
    for f in PLANE_FIELDS:
        a, b = getattr(mine, f).numpy(), np.asarray(ref[f])
        assert a.dtype == np.float64 and a.shape == b.shape == (grid.n_rays,)
        if f in ("rdot_sign", "thetadot_sign", "alpha", "beta", "t", "k"):
            np.testing.assert_array_equal(a, b, err_msg=f)
        elif f == "Q":
            assert (np.abs(a - b) <= 1e-14 * q_scale).all()
        else:
            np.testing.assert_allclose(a, b, rtol=1e-14, atol=0, err_msg=f)
    assert (mine.steps == 0).all()
    if work == "float64":  # the JAX batch itself, rounded from the same seed
        jb = jip.image_plane(dist, incl, jgrid, SPIN, phi0)
        for f in PLANE_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(jb, f)), np.asarray(ref[f]),
                                          err_msg=f)


def test_image_plane_knife_edge_floor_follows_the_march_dtype():
    """The y = 0 row gets a polar impact parameter above 1e-4 r_g when the
    march runs in float32, and exactly 1e-4 r_g in float64."""
    grid = ImagePlaneGrid.from_steps(-2.0, 2.0, 1.0, -2.0, 2.0, 1.0)
    b32 = image_plane(500.0, 60.0, grid, SPIN, device="cpu", work_dtype=torch.float32)
    b64 = image_plane(500.0, 60.0, grid, SPIN, device="cpu")
    edge = (b64.beta == 0).numpy()
    assert (b32.Q.numpy()[edge] > b64.Q.numpy()[edge]).all()
    np.testing.assert_array_equal(b32.Q.numpy()[~edge], b64.Q.numpy()[~edge])


@pytest.fixture(scope="module")
def traced_pair():
    """One image-plane batch traced backwards by the JAX march (rk4, f64),
    in both packages from identical state."""
    from raytrace_tpu.ops import trace as jtrace
    from raytrace_tpu.ops.redshift import redshift_start as jstart
    from raytrace_tpu.sources import ImagePlaneGrid as JGrid
    from raytrace_tpu.sources import image_plane as jplane

    jg = JGrid.from_steps(-15.0, 15.0, 1.5, -15.0, 15.0, 1.5)
    jr = jstart(jplane(500.0, 60.0, jg, SPIN), -SPIN, V=0.0, reverse=True)
    jr = jtrace(jr, -SPIN, method="rk4", steplim=4000, r_max=550.0)
    return jr, from_numpy(_numpy_batch(jr), device="cpu")


def test_redshift_start_reverse_matches_jax():
    from raytrace_tpu.ops.redshift import redshift_start as jstart
    from raytrace_tpu.sources import ImagePlaneGrid as JGrid
    from raytrace_tpu.sources import image_plane as jplane
    from raytrace_tpu_torch.ops.redshift import redshift_start

    jg = JGrid.from_steps(-15.0, 15.0, 1.5, -15.0, 15.0, 1.5)
    jr = jplane(500.0, 60.0, jg, SPIN)
    pr = from_numpy(_numpy_batch(jr), device="cpu")
    for V, reverse in ((0.0, True), (-1.0, True), (0.0, False)):
        np.testing.assert_allclose(
            redshift_start(pr, -SPIN, V, reverse=reverse).emit.numpy(),
            np.asarray(jstart(jr, -SPIN, V, reverse=reverse).emit), rtol=1e-12, atol=0)


@pytest.mark.parametrize("reverse", [True, False])
def test_apply_redshift_matches_jax(traced_pair, reverse):
    from raytrace_tpu.ops import redshift as jrs
    from raytrace_tpu_torch.ops import redshift as prs

    jr, pr = traced_pair
    a = prs.apply_redshift(pr, -SPIN, V=-1.0, reverse=reverse).redshift.numpy()
    b = np.asarray(jrs.apply_redshift(jr, -SPIN, V=-1.0, reverse=reverse).redshift)
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    assert np.isfinite(a).sum() > 0.5 * a.size


@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize("kind", ["flatdisc", "isco"])
def test_apply_redshift_dest_matches_jax(traced_pair, kind, reverse):
    from raytrace_tpu import destinations as jd
    from raytrace_tpu.ops import redshift as jrs
    from raytrace_tpu_torch.ops import redshift as prs

    jr, pr = traced_pair
    r_isco = isco_radius(SPIN)
    mine = FlatDisc(1.5) if kind == "flatdisc" else DiscWithISCO(r_isco, 15.0)
    ref = jd.FlatDisc(1.5) if kind == "flatdisc" else jd.DiscWithISCO(r_isco, 15.0)
    a = prs.apply_redshift_dest(pr, -SPIN, mine, reverse=reverse).redshift.numpy()
    b = np.asarray(jrs.apply_redshift_dest(jr, -SPIN, ref, reverse=reverse).redshift)
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


def test_pixel_accumulate_matches_jax():
    """Counts exactly, sums to rounding; rays off the grid or masked out go
    to the scrap bin."""
    import jax.numpy as jnp

    from raytrace_tpu.ops.reductions import pixel_accumulate as jpix
    from raytrace_tpu_torch.ops.reductions import pixel_accumulate

    rng = np.random.default_rng(11)
    n, nx, ny = 20_000, 37, 23
    ix = rng.integers(-3, nx + 3, n)
    iy = rng.integers(-3, ny + 3, n)
    mask = rng.random(n) < 0.7
    w = {"a": rng.standard_normal(n), "b": rng.uniform(0.1, 5.0, n)}
    jc, jw = jpix(jnp.asarray(ix, jnp.int32), jnp.asarray(iy, jnp.int32), jnp.asarray(mask),
                  {k: jnp.asarray(v) for k, v in w.items()}, nx, ny)
    pc, pw = pixel_accumulate(torch.from_numpy(ix), torch.from_numpy(iy), torch.from_numpy(mask),
                              {k: torch.from_numpy(v) for k, v in w.items()}, nx, ny)
    assert pc.shape == (nx, ny) and pc.dtype == torch.float64
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    for k in w:
        np.testing.assert_allclose(pw[k].numpy(), np.asarray(jw[k]), rtol=1e-12, atol=1e-12)
    inside = mask & (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    assert pc.sum().item() == inside.sum()


def test_disc_with_isco_matches_jax():
    """reached (crossing-aware, annulus-gated) and step_limit (clamp only
    inside the annulus) on random states, for the destination the isco app
    builds and for an annulus without an outer edge."""
    import jax.numpy as jnp

    from raytrace_tpu import destinations as jd

    rng = np.random.default_rng(5)
    n = 5000
    r = rng.uniform(0.5, 30.0, n)
    theta = rng.uniform(1.4, 1.75, n)
    prev = theta + rng.normal(0.0, 0.05, n)
    ptheta = rng.normal(0.0, 0.01, n)
    ptheta[::50] = 0.0
    for r_out in (20.0, -1.0):
        mine = DiscWithISCO(isco_radius(SPIN), r_out)
        ref = jd.DiscWithISCO(isco_radius(SPIN), r_out)
        t = [torch.from_numpy(v) for v in (r, theta, prev, ptheta)]
        j = [jnp.asarray(v) for v in (r, theta, prev, ptheta)]
        np.testing.assert_array_equal(mine.reached(t[0], t[1], None, t[2]).numpy(),
                                      np.asarray(ref.reached(j[0], j[1], None, j[2])))
        np.testing.assert_array_equal(
            mine.step_limit(t[0], t[1], None, None, t[3], None).numpy(),
            np.asarray(ref.step_limit(j[0], j[1], None, None, j[3], None)))
    never = DiscWithISCO(1.0, theta_lim=0.0).reached(t[0], t[1], None, t[2])
    assert not never.any()


def test_fits_output_writes_the_same_bytes_as_jax(tmp_path):
    from raytrace_tpu.io import FITSOutput as JFITS

    from raytrace_tpu_torch.io import FITSOutput

    rng = np.random.default_rng(3)
    maps = {"FLUX": rng.random((7, 5)), "NRAYS": rng.integers(0, 9, (7, 5)).astype(np.float64)}
    paths = []
    for cls, name in ((FITSOutput, "port.fits"), (JFITS, "jax.fits")):
        f = cls(str(tmp_path / name))
        f.write_comment("Raytraced images of accretion disc")
        f.set_keyword("GENERATOR", "imageplane_disc_image_isco")
        f.set_keyword("DIST", 500.0, "Distance to image plane")
        f.set_keyword("NRAYS", 6724, "Number of rays")
        for ext, img in maps.items():
            f.write_image(img, extname=ext)
            f.set_keyword("XMAX", 20.0, "End of X axis")
        f.write_table({"r": np.arange(4.0), "n": np.arange(4)}, extname="TAB")
        f.close()
        paths.append(tmp_path / name)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    back = read_fits(str(paths[0]))
    for ext, img in maps.items():
        np.testing.assert_array_equal(back[ext], img)
    assert back["_headers"]["PRIMARY"]["DIST"] == f"{500.0:.13E}"


def test_powerlaw3_continuity():
    r = torch.tensor([3.999999, 4.000001, 9.999999, 10.000001], dtype=torch.float64)
    v = port_app.powerlaw3(r, 3.0, 4.0, 2.0, 10.0, 3.5).numpy()
    assert abs(v[0] / v[1] - 1) < 1e-4
    assert abs(v[2] / v[3] - 1) < 1e-4


@pytest.mark.parametrize("variant", ["plain", "rd", "isco"])
def test_compute_matches_jax(variant):
    """The whole slice against JAX ``compute`` on a 21 x 21 grid (rk4, f64):
    the two marches agree ray for ray (here: every count equal), so pixels
    with equal counts agree to 1e-9. A chaotic ray that a libm ulp sends
    elsewhere may move between pixels: at most 1% of the disc rays."""
    from raytrace_tpu.apps.imageplane_disc_image import compute as jcompute
    from raytrace_tpu.sources import ImagePlaneGrid as JGrid

    kw = dict(r_disc=15.0, img_nx=10, img_ny=10, variant=variant, method="rk4", steplim=6000)
    mine = port_app.compute(SPIN, 500.0, 60.0, ImagePlaneGrid.from_steps(-15, 15, 1.5, -15, 15, 1.5),
                            device="cpu", **kw)
    ref = jcompute(SPIN, 500.0, 60.0, JGrid.from_steps(-15, 15, 1.5, -15, 15, 1.5), **kw)
    assert np.abs(mine["counts"] - ref["counts"]).sum() <= 0.01 * ref["counts"].sum()
    full = (ref["counts"] > 0) & (mine["counts"] == ref["counts"])
    assert full.sum() > 20
    for k in MAPS:
        np.testing.assert_allclose(mine[k][full], ref[k][full], rtol=1e-9, atol=0, err_msg=k)


def test_isco_variant_refuses_euler():
    grid = ImagePlaneGrid.from_steps(-2.0, 2.0, 1.0, -2.0, 2.0, 1.0)
    with pytest.raises(ValueError, match="Euler"):
        port_app.compute(SPIN, 500.0, 60.0, grid, r_disc=15.0, variant="isco", method="euler",
                         device="cpu")


@pytest.mark.parametrize("variant", ["plain", "rd", "isco"])
def test_app_cli(tmp_path, variant):
    """main / main_rd / main_isco on a 9 x 9 grid: the FITS file carries the
    seven maps, the run's keywords and DISCRAYS = the count map's sum."""
    par = tmp_path / "img.par"
    par.write_text(f"""
outfile = {tmp_path}/img.fits
dist = 500
incl = 60
spin = 0.998
r_disc = 15
x0 = -12
xmax = 12
Nx = 8
integrator = rk4
steplim = 6000
""")
    main = {"plain": port_app.main, "rd": port_app.main_rd, "isco": port_app.main_isco}[variant]
    assert main([f"--parfile={par}", "--device=cpu"]) == 0
    out = read_fits(str(tmp_path / "img.fits"))
    hdr = out["_headers"]
    for ext in ("FLUX", "RADIUS", "PHI", "ENSHIFT", "TIME", "EMIS", "NRAYS"):
        assert out[ext].shape == (8, 8)
        assert np.isfinite(out[ext]).all()
    assert hdr["PRIMARY"]["GENERATO"].strip("' ") == f"imageplane_disc_image_{variant}"
    assert int(hdr["PRIMARY"]["NRAYS"]) == 81
    n_disc = int(hdr["PRIMARY"]["DISCRAYS"])
    assert n_disc == int(out["NRAYS"].sum()) > 0
    assert float(hdr["PRIMARY"]["ISCO"]) == pytest.approx(isco_radius(SPIN), rel=1e-12)


def _read_image_golden(path, img_n=40):
    raw = open(path, "rb").read()
    n = img_n * img_n
    maps = {name: np.frombuffer(raw, dtype="<f8", count=n, offset=i * n * 8).reshape(img_n, img_n)
            for i, name in enumerate(MAPS)}
    counts = np.fromfile(path + ".counts", dtype="<i4").reshape(img_n, img_n)
    return maps, counts


def test_plain_image_matches_reference_binary():
    """tests/test_images.py:97-116 on the port: dist 500, incl 60, spin
    0.998, r_disc 20, 81 x 81 rays -> 40 x 40 image, RK4, steplim 30000."""
    grid = ImagePlaneGrid.from_steps(-20.0, 20.0, 0.5, -20.0, 20.0, 0.5)
    out = port_app.compute(SPIN, 500.0, 60.0, grid, r_disc=20.0, img_nx=40, img_ny=40,
                           method="rk4", steplim=30000, device="cpu")
    maps, counts = _read_image_golden("tests/golden/disc_image_a0.998_i60_rk4.bin")
    mine_c = out["counts"]
    assert abs(int(mine_c.sum()) - int(counts.sum())) / counts.sum() < 0.05
    good = (counts >= 3) & (mine_c >= 3)
    assert good.sum() > 500
    for name, tol in [("r", 0.005), ("enshift", 0.005), ("flux", 0.01), ("time", 0.005),
                      ("emis", 0.01)]:
        rel = np.abs(out[name][good] / maps[name][good] - 1)
        assert np.median(rel) < tol, f"{name}: median dev {np.median(rel):.5f}"


def test_isco_image_matches_reference_binary():
    """tests/test_images.py:122-145 on the port: 82 x 82 rays, RK45 tol
    1e-8, DiscWithISCO. The disc-ray count equals the reference's exactly."""
    maps, counts = _read_image_golden("tests/golden/disc_image_isco_a0.998_i60_rk45.bin")
    dx = 40.0 / 81
    grid = ImagePlaneGrid.from_steps(-20.0, 20.0, dx, -20.0, 20.0, dx)
    out = port_app.compute(SPIN, 500.0, 60.0, grid, r_disc=20.0, img_nx=40, img_ny=40,
                           variant="isco", method="rk45", steplim=100000, device="cpu")
    mine_c = out["counts"]
    assert int(mine_c.sum()) == int(counts.sum())
    good = (counts >= 3) & (mine_c >= 3)
    assert good.sum() > 500
    for name, tol in [("r", 1e-4), ("enshift", 1e-4), ("flux", 1e-3), ("time", 1e-4),
                      ("emis", 1e-3)]:
        rel = np.abs(out[name][good] / maps[name][good] - 1)
        assert np.median(rel) < tol, f"{name}: median dev {np.median(rel):.2e}"


def test_destination_classes():
    """ThetaLimit and DiscWithISCO are distinct: the RK4/Euler clamp onto
    the surface is for ThetaLimit only (ops/integrate.py)."""
    assert not isinstance(DiscWithISCO(1.2), ThetaLimit)
    assert FlatDisc is ThetaLimit
    assert DiscWithISCO(1.2).theta_lim == math.pi / 2
