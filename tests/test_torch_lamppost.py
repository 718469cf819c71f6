"""The port's lamppost family (apps/lamppost.py) against the JAX package.

Spin 0.9, a lamppost at r = 5 on the axis (theta = 1e-3), RK45, r_esc = 50,
as tests/test_lamppost.py runs them. On the CPU the port marches with its
plain lock-step version in float64; the steplims are cut so that the plain
march's per-iteration cost stays within the file's time.

The beta = -pi column of a (cos alpha, beta) grid launches exactly at the
polar turning point sin(beta) = 0, where the two packages' tiny-floored
square roots split at machine epsilon (tests/test_capabilities.py:392-396):
those rays are counted and bounded, every other ray's fate is equal. The
app outputs are compared on grids that start at beta = -3.0, so no ray sits
on that knife edge.

The JAX package is imported inside the tests that use it:

    python -m pytest --noconftest -m cuda tests/test_torch_lamppost.py
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.apps import lamppost as port_app  # noqa: E402
from raytrace_tpu_torch.config import Config  # noqa: E402
from raytrace_tpu_torch.ops import march_kernel  # noqa: E402
from raytrace_tpu_torch.sources import PointSourceGrid  # noqa: E402

SPIN = 0.9
FATE_ARGS = ["--spin=0.9", "--source=0 5 1e-3 0", "--dcosalpha=0.1", "--dbeta=0.2",
             "--r_esc=50", "--steplim=1000"]
APP_ARGS = ["--spin=0.9", "--source=0 5 1e-3 0", "--dcosalpha=0.4", "--dbeta=0.8",
            "--beta0=-3.0", "--betamax=3.3", "--r_esc=50", "--steplim=1000"]


def _jax_fates(argv, grid_steps):
    from raytrace_tpu.apps import lamppost as jax_app
    from raytrace_tpu.config import Config as JConfig
    from raytrace_tpu.sources import PointSourceGrid as JGrid

    cfg = JConfig(argv)
    grid = JGrid.from_steps(*grid_steps)
    rays, spin, _ = jax_app._build_source(cfg, grid)
    return jax_app._trace_fates(cfg, rays, spin, grid)


def _port_fates(argv, grid_steps, device="cpu"):
    cfg = Config(argv + [f"--device={device}"])
    grid = PointSourceGrid.from_steps(*grid_steps)
    rays, spin, _ = port_app._build_source(cfg, grid)
    return port_app._trace_fates(cfg, rays, spin, grid)


@pytest.mark.parametrize("extra", [[], ["--v_jet=0.3"]], ids=["static", "jet"])
def test_fates_match_jax(extra):
    """_trace_fates on the 0.1 x 0.2 grid (640 rays): fates equal but on the
    beta = -pi column, where at most 5 of its 20 rays differ (measured 4 at
    this steplim, 2 at steplim 8000);
    on the rays of equal fate the landing radius, redshift and time of disc
    rays to 1e-6 relative (RK45 escapes: ROADMAP Queue 3), with at most 2% of
    them off (RK45 step sequences that split on rounding noise)."""
    steps = (0.1, 0.2)
    jout, jfate, jlive = _jax_fates(FATE_ARGS + extra, steps)
    pout, pfate, plive = _port_fates(FATE_ARGS + extra, steps)
    np.testing.assert_array_equal(plive, jlive)
    n_beta = PointSourceGrid.from_steps(*steps).n_beta
    knife = (np.arange(pfate.size) % n_beta) == 0
    assert (pfate != jfate)[~knife].sum() == 0
    assert (pfate != jfate)[knife].sum() <= 5
    disc = (pfate == 1) & (jfate == 1)
    assert disc.sum() > 150
    for f in ("r", "redshift", "t"):
        a, b = getattr(pout, f).numpy()[disc], np.asarray(getattr(jout, f))[disc]
        off = np.abs(a / b - 1) > 1e-6
        assert off.mean() <= 0.02, (f, off.sum())


def test_superluminal_jet_has_no_real_fate():
    """tests/test_lamppost.py:163-178: a v_jet = 0.6 source at r = 4 is
    superluminal (g_tt + g_rr v^2 < 0), its constants are NaN and the plain
    march flags every live ray NUMERIC: no ray carries a real fate."""
    argv = ["--spin=0.9", "--source=0 4 1e-3 0", "--v_jet=0.6", "--dcosalpha=0.4",
            "--dbeta=0.8", "--r_esc=50", "--steplim=2000"]
    out, fate, live = _port_fates(argv, (0.4, 0.8))
    assert live.sum() > 30 and (fate[live] == -1).all()
    st = out.status.numpy()[live]
    assert ((st & 64) != 0).all() and ((st & 7) == 0).all()


@pytest.mark.cuda
def test_superluminal_jet_has_no_real_fate_on_the_kernel():
    """The same superluminal batch on the card goes through the march kernel
    (one launch), which ends every live ray NUMERIC with no DEST, HORIZON or
    RLIM bit, without marching it to the step limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the march kernel has no CPU build")
    argv = ["--spin=0.9", "--source=0 4 1e-3 0", "--v_jet=0.6", "--dcosalpha=0.4",
            "--dbeta=0.8", "--r_esc=50", "--steplim=2000"]
    before = march_kernel.launches
    out, fate, live = _port_fates(argv, (0.4, 0.8), device="cuda")
    assert march_kernel.launches == before + 1
    assert live.sum() > 30 and (fate[live] == -1).all()
    st = out.status.cpu().numpy()[live]
    assert ((st & 64) != 0).all() and ((st & (1 | 2 | 4 | 8)) == 0).all()
    assert (out.steps.cpu().numpy()[live] <= 1).all()


def test_solid_angle_closure():
    """tests/test_lamppost.py:36-58: the app's own 2% exit gate, and the
    live cells of the 0.01 x 0.02 grid times the cell solid angle against
    the analytic coverage (2%, about 0.995 of 4 pi)."""
    assert port_app.main_solid_angle(["--spin=0.9", "--dcosalpha=0.05", "--dbeta=0.05",
                                      "--device=cpu"]) == 0
    grid = PointSourceGrid.from_steps(0.01, 0.02)
    rays = port_app.point_source((0.0, 5.0, 1e-3, 0.0), 0.0, SPIN, grid, device="cpu")
    measured = int((rays.steps == 0).sum()) * grid.dcosalpha * grid.dbeta
    expected = (grid.cosalphamax - grid.cosalpha0) * (grid.betamax - grid.beta0)
    assert abs(measured / expected - 1.0) < 0.02
    assert abs(measured / (4 * math.pi) - 0.995) < 0.02


@pytest.mark.parametrize("extra", [["--plunge=1", f"--source=0 1.7 {math.pi / 2 - 1e-3} 0"],
                                   ["--u_r=0.1", "--u_theta=0.01", "--u_phi=0.02"]],
                         ids=["plunge", "vel"])
def test_build_source_matches_jax(extra):
    """The plunge and arbitrary-velocity source modes (u^t solved from the
    normalisation) field by field against JAX's, to 1e-12 of each field's
    scale, and the same mode line."""
    from raytrace_tpu.apps import lamppost as jax_app
    from raytrace_tpu.config import Config as JConfig
    from raytrace_tpu.sources import PointSourceGrid as JGrid

    argv = ["--spin=0.9", "--source=0 5 0.3 0"] + extra
    p, _, pmode = port_app._build_source(Config(argv + ["--device=cpu"]),
                                         PointSourceGrid.from_steps(0.2, 0.4))
    j, _, jmode = jax_app._build_source(JConfig(argv), JGrid.from_steps(0.2, 0.4))
    assert pmode == jmode
    for f in ("k", "h", "Q", "rdot_sign", "thetadot_sign", "alpha", "beta", "steps", "r"):
        b = np.asarray(getattr(j, f))
        np.testing.assert_allclose(getattr(p, f).numpy(), b, rtol=0,
                                   atol=1e-12 * max(np.abs(b).max(), 1.0), err_msg=f)


def test_velocity_mode_reduces_to_orbit_mode():
    """tests/test_lamppost.py:181-214: a pure azimuthal velocity at the
    Keplerian angular velocity gives the orbit-mode source's constants
    (rtol 1e-10, atol 1e-12)."""
    from raytrace_tpu_torch.geometry import keplerian_omega, metric_coeffs

    r_s, th = 6.0, math.pi / 2 - 1e-3
    omega = keplerian_omega(r_s, SPIN)
    g = metric_coeffs(torch.tensor(r_s, dtype=torch.float64),
                      torch.tensor(th, dtype=torch.float64), SPIN)
    ut = 1.0 / math.sqrt(float(g.g_tt) + 2 * float(g.g_tphi) * omega + float(g.g_phph) * omega**2)
    grid = PointSourceGrid.from_steps(0.2, 0.4)
    base = [f"--source=0 {r_s} {th} 0", "--spin=0.9", "--device=cpu"]
    vel, _, mode_v = port_app._build_source(Config(base + [f"--u_phi={omega * ut}", "--u_r=0"]),
                                            grid)
    orb, _, mode_o = port_app._build_source(Config(base + [f"--V={omega}"]), grid)
    assert "vel" in mode_v and "orbit" in mode_o
    for f in ("k", "h", "Q"):
        torch.testing.assert_close(getattr(vel, f), getattr(orb, f), rtol=1e-10, atol=1e-12)


def _run_both(entry, tmp_path, args, suffix=".dat"):
    from raytrace_tpu.apps import lamppost as jax_app

    j, p = tmp_path / f"jax{suffix}", tmp_path / f"port{suffix}"
    assert getattr(jax_app, entry)([f"--outfile={j}"] + args) == 0
    assert getattr(port_app, entry)([f"--outfile={p}", "--device=cpu"] + args) == 0
    return j, p


@pytest.mark.parametrize("extra", [[], ["--v_jet=0.3"]], ids=["static", "jet"])
def test_sky_map_matches_jax(tmp_path, extra):
    """main_sky's FITS maps on the 0.4 x 0.8 grid from beta = -3.0 (40
    rays): FATE equal, LAND_R, REDSHIFT and TIME to 1e-6 relative, the
    same headers."""
    from raytrace_tpu_torch.io import read_fits

    j, p = _run_both("main_sky", tmp_path, APP_ARGS + extra, ".fits")
    a, b = read_fits(str(j)), read_fits(str(p))
    np.testing.assert_array_equal(b["FATE"], a["FATE"])
    assert (a["FATE"] == 1).sum() > 5
    for ext in ("LAND_R", "REDSHIFT", "TIME"):
        np.testing.assert_allclose(b[ext], a[ext], rtol=1e-6, atol=1e-12, err_msg=ext)
    assert b["_headers"] == a["_headers"]


@pytest.mark.parametrize("entry, extra", [
    ("main_sky_discfrac", []),
    ("main_angdist", ["--Nang=8"]),
    ("main_raystart", ["--v_jet=0.4"]),
    ("main_to_disc", ["--Nr=10", "--r_disc=30"]),
])
def test_text_apps_match_jax(tmp_path, entry, extra):
    """The text apps on the same 40 rays: every column to 1e-6 relative
    (the counts and fractions exactly where their rays' fates agree, which
    they all do on this grid)."""
    j, p = _run_both(entry, tmp_path, APP_ARGS + extra)
    a, b = np.atleast_2d(np.loadtxt(j)), np.atleast_2d(np.loadtxt(p))
    assert a.shape == b.shape and a.size > 0
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-12)


def test_slice_apps_run_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """Without --device every app of the slice picks cuda and, with no card
    visible, raises rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the apps would run on it")
    from raytrace_tpu_torch.apps import healpix_apps, lamppost, return_radiation, trace_rays

    base = ["--spin=0.9", "--source=0 5 1e-3 0", "--dcosalpha=0.4", "--dbeta=0.8", "--order=1",
            f"--outfile={tmp_path / 'x'}", "--dist=100", "--incl=60", "--x0=-1", "--xmax=1",
            "--Nx=2", "--y0=-1", "--ymax=1", "--Ny=2"]
    mains = [getattr(lamppost, m) for m in ("main_sky", "main_sky_discfrac", "main_angdist",
                                            "main_raystart", "main_solid_angle", "main_to_disc")]
    mains += [getattr(return_radiation, m) for m in ("main_photonfrac", "main_photonfrac_r",
                                                     "main_return_angdist")]
    mains += [healpix_apps.main_to_disc, healpix_apps.main_disc_photonfrac]
    mains += [getattr(trace_rays, m) for m in ("main", "main_imageplane", "main_jetpoint",
                                               "main_vel")]
    for main in mains:
        with pytest.raises(RuntimeError, match="--device=cpu"):
            main(base)
