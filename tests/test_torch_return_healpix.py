"""The port's returning-radiation and HEALPix apps, the HEALPix geometry
and source, and the progress bar, against the JAX package.

Spin 0.9 (0.998 for the lamppost cross-check), RK45, as
tests/test_lamppost.py and tests/test_capabilities.py run them. On the CPU
the port marches with its plain lock-step version in float64; grids and
steplims are cut so that the plain march's per-iteration cost stays within
the file's time. The two cross-checks of tests/test_lamppost.py:216-292 run
at HEALPix order 4 under their own gates, at steplims 1000 and 1500 in place
of 8000.

The JAX package is imported inside the tests that use it:

    python -m pytest --noconftest -m cuda tests/test_torch_return_healpix.py
"""

import io
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.apps import healpix_apps as port_hp  # noqa: E402
from raytrace_tpu_torch.apps import return_radiation as port_rr  # noqa: E402
from raytrace_tpu_torch.geometry import healpix as port_geom  # noqa: E402
from raytrace_tpu_torch.ops import march_kernel, trace  # noqa: E402
from raytrace_tpu_torch.sources import PointSourceGrid, healpix_point_source  # noqa: E402

SPIN = 0.9
RR_ARGS = ["--spin=0.9", "--dcosalpha=0.2", "--dbeta=0.4", "--r_esc=100", "--steplim=1000"]


def test_photon_fractions_match_jax():
    """photon_fractions at r = 6 on the 0.2 x 0.4 grid (160 live rays): the
    same counts and the same returning rays. Their landing radius and
    redshift: at least 90% of the rays to 1e-9 relative and all to 1e-3
    (measured 76 of 82 to 1e-9, worst 1.6e-4 in r). The RK45 step sequence
    of a long path splits on libm rounding noise in the error estimate
    (ROADMAP Queue 3); the step counts stay equal, but the last step lands
    at another distance from the plane and the crossing is back-interpolated
    from there."""
    from raytrace_tpu.apps.return_radiation import photon_fractions as jfrac
    from raytrace_tpu.sources import PointSourceGrid as JGrid

    kw = dict(r_esc=100.0, r_disc=100.0, steplim=1000)
    a = jfrac(6.0, SPIN, JGrid.from_steps(0.2, 0.4), **kw)
    b = port_rr.photon_fractions(6.0, SPIN, PointSourceGrid.from_steps(0.2, 0.4), device="cpu",
                                 **kw)
    for k in ("n_live", "n_return", "n_escape", "n_horizon"):
        assert a[k] == b[k], k
    assert b["n_return"] > 40
    np.testing.assert_array_equal(b["return_mask"], a["return_mask"])
    m = a["return_mask"]
    np.testing.assert_array_equal(b["out"].steps.numpy()[m], np.asarray(a["out"].steps)[m])
    for f in ("r", "redshift"):
        x, y = getattr(b["out"], f).numpy()[m], np.asarray(getattr(a["out"], f))[m]
        rel = np.abs(x / y - 1)
        assert rel.max() < 1e-3 and (rel < 1e-9).mean() >= 0.9, (f, rel.max())


def _run_both(jax_app, port_app, entry, tmp_path, args):
    j, p = tmp_path / "jax.dat", tmp_path / "port.dat"
    assert getattr(jax_app, entry)([f"--outfile={j}"] + args) == 0
    assert getattr(port_app, entry)([f"--outfile={p}", "--device=cpu"] + args) == 0
    return np.atleast_2d(np.loadtxt(j)), np.atleast_2d(np.loadtxt(p))


@pytest.mark.parametrize("entry, extra", [
    ("main_photonfrac_r", ["--Nr=12", "--r_disc=60"]),
    ("main_return_angdist", ["--Nang=10"]),
    ("main_photonfrac", ["--Nr=1"]),
])
def test_return_radiation_apps_match_jax(tmp_path, entry, extra):
    """The three apps' text columns against JAX's on the 0.2 x 0.4 grid:
    counts and fractions equal, NaN (empty bins) in the same places, the
    per-bin flux, redshift and time sums to 1e-3 relative (the RK45
    landing noise of test_photon_fractions_match_jax; measured 1.5e-4)."""
    from raytrace_tpu.apps import return_radiation as jax_app

    a, b = _run_both(jax_app, port_rr, entry, tmp_path, RR_ARGS + extra)
    assert a.shape == b.shape and np.isfinite(a).any()
    exact = {"main_photonfrac_r": [0, 1], "main_return_angdist": [0, 1, 2, 3],
             "main_photonfrac": [0, 1, 2, 3, 4]}[entry]
    np.testing.assert_array_equal(b[:, exact], a[:, exact])
    np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-12)


@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
def test_healpix_geometry_equals_jax(order):
    """ring_to_xyf and pixel_vectors exactly equal to JAX's (the port keeps
    its own numpy copy)."""
    from raytrace_tpu.geometry import healpix as jax_geom

    assert port_geom.n_pixels(order) == jax_geom.n_pixels(order) == 12 * 4**order
    pix = np.arange(port_geom.n_pixels(order))
    for a, b in zip(port_geom.ring_to_xyf(order, pix), jax_geom.ring_to_xyf(order, pix)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port_geom.pixel_vectors(order), jax_geom.pixel_vectors(order)):
        np.testing.assert_array_equal(a, b)
    corners, _ = port_geom.pixel_vectors(order)
    np.testing.assert_allclose(np.linalg.norm(corners.reshape(-1, 3), axis=1), 1.0, atol=1e-12)


@pytest.mark.parametrize("kw", [dict(), dict(V=0.05), dict(v_radial=0.3),
                                dict(disc_source=True, V=0.06), dict(basis=1)],
                         ids=["static", "orbit", "radial", "disc_source", "basis1"])
def test_healpix_point_source_matches_jax(kw):
    """healpix_point_source at order 2, slot-major: every field to 1e-12 of
    its scale; the disc source kills about half the rays."""
    from raytrace_tpu.sources import healpix_point_source as jhp

    pos = (0.0, 6.0, math.pi / 2 - 1e-3, 0.0) if kw.get("disc_source") else (0.0, 5.0, 1e-3, 0.0)
    a, npix = healpix_point_source(pos, SPIN, order=2, device="cpu", **kw)
    b, jnpix = jhp(pos, SPIN, order=2, **kw)
    assert npix == jnpix == 192 and a.n_rays == 5 * 192
    for f in ("k", "h", "Q", "rdot_sign", "thetadot_sign", "alpha", "beta", "steps", "r",
              "theta", "t", "phi"):
        ref = np.asarray(getattr(b, f))
        np.testing.assert_allclose(getattr(a, f).numpy(), ref, rtol=0,
                                   atol=1e-12 * max(np.abs(ref).max(), 1.0), err_msg=f)
    if kw.get("disc_source"):
        assert 0.45 < float((a.steps == -1).double().mean()) < 0.55


@pytest.mark.parametrize("entry, args", [
    ("main_to_disc", ["--source=0 5 1e-3 0", "--Nr=10", "--r_disc=40"]),
    ("main_disc_photonfrac", ["--r_source=6"]),
])
def test_healpix_apps_match_jax(tmp_path, entry, args):
    """Both HEALPix apps at order 2 (960 rays) against JAX's text output,
    every column to 1e-6 relative."""
    from raytrace_tpu.apps import healpix_apps as jax_app

    a, b = _run_both(jax_app, port_hp, entry, tmp_path,
                     ["--spin=0.9", "--order=2", "--r_esc=100", "--steplim=1000"] + args)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-12)


def test_healpix_to_disc_matches_port_emissivity(tmp_path):
    """tests/test_lamppost.py:216-265 on the port: the HEALPix lamppost
    (order 4, 4 pi / npix a pixel) and the port's emissivity on the 0.02 x
    0.1 grid (dcosalpha dbeta a cell) integrate to the same cumulative flux
    and emissivity within 10%, and the mean redshift of bins with >= 60 rays
    in both agrees to 5%. Spin 0.998, h = 5, steplim 1000."""
    from raytrace_tpu_torch.apps.emissivity import compute

    spin, h = 0.998, 5.0
    r_min, r_disc, n_r = 2.0, 50.0, 10
    out = tmp_path / "healpix.dat"
    assert port_hp.main_to_disc([
        f"--outfile={out}", f"--spin={spin}", f"--source=0 {h} 1e-3 0", "--order=4",
        "--r_esc=100", f"--rmin={r_min}", f"--r_disc={r_disc}", f"--Nr={n_r}",
        "--steplim=1000", "--device=cpu",
    ]) == 0
    hp = np.loadtxt(out)
    grid = PointSourceGrid.from_steps(0.02, 0.1)
    emis = compute(spin, [0.0, h, 1e-3, 0.0], V=0.0, grid=grid, r_max=100.0, r_min=r_min,
                   r_disc=r_disc, n_r=n_r, gamma=2.0, steplim=1000, device="cpu")
    cell = 0.02 * 0.1
    n_cells = ((grid.cosalphamax - grid.cosalpha0) / grid.dcosalpha) * (
        (grid.betamax - grid.beta0) / grid.dbeta)
    ratio = np.cumsum(hp[:, 2])[2:] / np.cumsum(cell * n_cells * emis["area"] * emis["flux"])[2:]
    assert np.all(np.abs(ratio - 1.0) < 0.1), ratio
    ratio_e = np.cumsum(hp[:, 3])[2:] / np.cumsum(cell * emis["area"] * emis["emis"])[2:]
    assert np.all(np.abs(ratio_e - 1.0) < 0.1), ratio_e
    gate = (hp[:, 1] >= 60) & (emis["rays"] >= 60)
    assert gate.sum() >= 5
    np.testing.assert_allclose(hp[gate, 4], emis["redshift"][gate], rtol=0.05)


def test_healpix_disc_fractions_match_port_return_radiation(tmp_path):
    """tests/test_lamppost.py:268-292 on the port: the HEALPix disc source
    (upper hemisphere, order 4) against photon_fractions on the 0.05 x 0.1
    grid (the full sphere, whose lower half returns at once): grid return
    (1 + hp) / 2, escape and capture hp / 2, each within 0.04."""
    out = tmp_path / "hp_frac.dat"
    assert port_hp.main_disc_photonfrac([
        f"--outfile={out}", "--spin=0.9", "--order=4", "--r_source=6", "--r_esc=100",
        "--steplim=1500", "--device=cpu",
    ]) == 0
    row = np.loadtxt(out)
    res = port_rr.photon_fractions(6.0, 0.9, PointSourceGrid.from_steps(0.05, 0.1), r_esc=100.0,
                                   r_disc=100.0, steplim=1500, device="cpu")
    n = res["n_live"]
    assert abs(res["n_return"] / n - 0.5 * (1.0 + row[1])) < 0.04
    assert abs(res["n_escape"] / n - 0.5 * row[2]) < 0.04
    assert abs(res["n_horizon"] / n - 0.5 * row[3]) < 0.04


def test_progress_bar_on_a_plain_stream(monkeypatch):
    """Off a TTY the bar writes one line per update, the same text as JAX's
    (elapsed seconds aside), and done() adds no second 100% line; disabled,
    it writes nothing."""
    from raytrace_tpu.utils.progress import ProgressBar as JBar

    from raytrace_tpu_torch.utils.progress import ProgressBar

    def drive(cls, enabled=True):
        buf = io.StringIO()
        monkeypatch.setattr("sys.stderr", buf)
        bar = cls(3, label="launch radii", enabled=enabled)
        for i in range(3):
            bar.show(i + 1, extra=f"r={i}")
        bar.done()
        monkeypatch.undo()
        return re.sub(r"\(\d+\.\ds\)", "(Ts)", buf.getvalue())

    text = drive(ProgressBar)
    assert text == drive(JBar)
    assert text.splitlines() == [f"launch radii: {p} (Ts) [r={i}]"
                                 for i, p in enumerate([" 33.3%", " 66.7%", "100.0%"])]
    assert drive(ProgressBar, enabled=False) == ""


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["euler", "rk4", "rk45"])
def test_kernel_matches_plain_march_on_the_disc_source_on_cuda(method):
    """The disc-source batch (r = 6, theta = pi/2 - 1e-3, Keplerian, the
    0.05 grid: half the rays cross the plane in their first step) through
    the float32 kernel against the plain march on the card: statuses and
    step counts equal on > 98% of live rays, median |dr|/r < 1e-5 (the
    float32 gates of tests/test_torch_march.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the march kernel has no CPU build")
    from raytrace_tpu_torch.ops.redshift import redshift_start

    rays = port_rr.disc_source_rays(6.0, SPIN, PointSourceGrid.from_steps(0.05, 0.05),
                                    device="cuda")
    rays = redshift_start(rays, SPIN, port_rr.keplerian_omega(6.0, SPIN)).to(dtype=torch.float32)
    kw = dict(method=method, r_max=500.0, steplim=3000)
    a = march_kernel.trace_kernel(rays, SPIN, march_dtype=torch.float32, **kw)
    b = trace(rays, SPIN, **kw)
    live = rays.steps == 0
    same = (a.status == b.status) & live
    assert float(same.sum()) / float(live.sum()) > 0.98
    assert float(((a.steps == b.steps) & same).sum()) / float(same.sum()) > 0.98
    dr = ((a.r - b.r).abs() / b.r.abs())[same]
    assert float(dr.median()) < 1e-5
    assert int(((b.status & 1) != 0).sum()) > 1000


@pytest.mark.cuda
def test_healpix_to_disc_launches_the_kernel_once(tmp_path):
    """healpix_apps.main_to_disc on the card marches its whole 5 x npix
    batch with one kernel launch and writes finite bins."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the app runs on the card")
    out = tmp_path / "hp.dat"
    before = march_kernel.launches
    assert port_hp.main_to_disc([f"--outfile={out}", "--spin=0.998", "--source=0 5 1e-3 0",
                                 "--order=5", "--r_esc=100", "--Nr=20"]) == 0
    assert march_kernel.launches == before + 1
    hp = np.loadtxt(out)
    assert hp.shape == (20, 5) and hp[:, 1].sum() > 1000
