"""The port's outflow, wind, P-Cygni, line-profile and perf-harness apps
against the JAX package's console scripts, and the host pieces they use:
``io.read_spectrum``, ``geometry.disc.coordinate_disc_area`` /
``integrate_disc_area`` and ``Config.positional`` / ``default_parfile``.

Every entry point runs with ``--device=cpu`` and the argv of the
tests/test_cli_sweep.py spec of its JAX console script, and its output
files are read back against the JAX script's. Text outputs carry ~6
significant digits (TextOutput). The mapper CLI's spec grid starts at beta
= -pi, where the lamppost rays launch on the polar turning point and the
two packages' marches split at machine epsilon (tests/test_torch_lamppost.py
says more): its maps are compared under gates that count those rays, and
again on the grid from beta = -3.0, off the knife edge.

The JAX package is imported inside the tests that use it.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.config import Config  # noqa: E402
from raytrace_tpu_torch.io import read_fits, read_spectrum  # noqa: E402

OUTFLOW = [
    "--dist=200", "--incl=60", "--spin=0.9", "--x0=-40", "--xmax=40", "--Nx=8",
    "--source_vel=0.2", "--wind_rin=10", "--wind_rout=50", "--en0=0.5", "--enmax=2.0",
    "--Nen=40", "--source_radius=2", "--steplim=4000",
]
MAPPER_PAR = """source = 0 5 1E-3 0
V = 0
spin = 0.998
dcosalpha = 0.2
dbeta = 0.4
map_r0 = 1.5
map_rmax = 50
map_Nr = 10
map_Ntheta = 5
map_Nphi = 8
steplim = 4000
"""
PERF_PAR = """spin = 0.998
source = 0 5 1E-3 0
dcosalpha = 0.5
dbeta = 0.5
r_max = 100
steplim = 3000
methods = euler
repeats = 1
"""
LINE = ["--dist=500", "--incl=60", "--spin=0.9", "--r_disc=15", "--Nx=24", "--Nen=30",
        "--steplim=20000"]


def _both(tmp_path, mod, entry, argv, name):
    """Run the JAX app and the port's (``--device=cpu``) with ``argv``,
    where ``{out}`` stands for each one's output path; returns the paths."""
    paths = []
    for pkg, extra in (("raytrace_tpu", []), ("raytrace_tpu_torch", ["--device=cpu"])):
        out = tmp_path / f"{pkg}_{name}"
        main = getattr(importlib.import_module(f"{pkg}.apps.{mod}"), entry)
        assert main([a.replace("{out}", str(out)) for a in argv] + extra) == 0
        paths.append(out)
    return paths


def _text(path):
    return np.atleast_2d(np.loadtxt(path))


@pytest.mark.parametrize("mod, entry, argv, cols", [
    ("outflow", "main", ["--outfile={out}"] + OUTFLOW, 4),
    ("outflow", "main_ent", ["--outfile={out}", "--Nt=4", "--t0=0", "--dt=200"] + OUTFLOW, 2),
    ("pcyg", "main", ["--outfile={out}", "--Nx=40", "--Nen=50", "--dz=0.05"], 4),
    ("sobolev_wind", "main_disc_wind", ["--outfile={out}", "--Nen=40", "--incl=45",
                                        "--tau_tot=1.0"], 3),
    ("sobolev_wind", "main_pcyg_sei", ["--outfile={out}", "--Nen=40"], 3),
])
def test_text_apps_match_jax(tmp_path, mod, entry, argv, cols):
    """The same rows and columns as JAX's; every value to rtol 1e-5 of the
    largest (measured: equal as written)."""
    j, p = _both(tmp_path, mod, entry, argv, "out.dat")
    a, b = _text(j), _text(p)
    assert b.shape == a.shape and a.shape[1] == cols
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * np.abs(a).max(axis=0).max())
    if entry == "main_ent":
        ra, rb = (np.load(f"{x}.ent.npz") for x in (j, p))
        np.testing.assert_array_equal(rb["energies"], ra["energies"])
        assert rb["response"].shape == ra["response"].shape == (40, 4)
        np.testing.assert_allclose(rb["response"], ra["response"], rtol=1e-9, atol=0.0)
    if mod == "outflow" and entry == "main":
        assert (b[:, 2] >= 0).all()


def test_outflow_spectrum_matches_jax(tmp_path):
    """main_spectrum folds the wind profile through a three-line spectrum:
    equal to JAX's as written."""
    spec = tmp_path / "lines.dat"
    spec.write_text("0.9 0.5\n1.0 1.0\n1.1 0.25\n")
    j, p = _both(tmp_path, "outflow", "main_spectrum",
                 ["--outfile={out}", f"--spectrum={spec}"] + OUTFLOW, "spec.dat")
    a, b = _text(j), _text(p)
    assert b.shape == a.shape == (40, 2)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * np.abs(a[:, 1]).max())


def test_outflow_emis_bin_matches_jax(tmp_path):
    """main_emis_bin's NPZ: shapes (8, 4, 8), counts equal, volumes to
    1e-12, emissivity, time and redshift finite in the same cells and there
    to rtol 1e-9 (measured 2.8e-13)."""
    argv = ["--outfile={out}", "--map_Nr=8", "--map_Ntheta=4", "--map_Nphi=8",
            "--map_rmax=60"] + OUTFLOW
    j, p = _both(tmp_path, "outflow", "main_emis_bin", argv, "emis_bin")
    a, b = np.load(f"{j}.npz"), np.load(f"{p}.npz")
    assert set(b.files) == set(a.files)
    assert b["emissivity"].shape == (8, 4, 8)
    np.testing.assert_array_equal(b["count"], a["count"])
    assert b["count"].sum() > 0
    np.testing.assert_allclose(b["volume"], a["volume"], rtol=1e-12)
    for k in ("emissivity", "time", "redshift"):
        fin = np.isfinite(a[k])
        np.testing.assert_array_equal(np.isfinite(b[k]), fin)
        np.testing.assert_allclose(b[k][fin], a[k][fin], rtol=1e-9)


@pytest.mark.parametrize("beta0", [None, -3.0])
def test_pointsource_mapper_matches_jax(tmp_path, beta0):
    """main_pointsource_mapper at the spec's spin 0.998 and 0.2 x 0.4 grid:
    the FITS extensions TIME, REDSHIFT, NRAYS, VOLUME as the NPZ holds
    them, the NPZ against JAX's. From beta = -pi the beta = -pi rays split
    (measured: 5 of 1,272 cell entries, 51 of 218 populated cells): volumes
    to 1e-12, total counts to 1%, time and redshift to 1e-9 on at least 60%
    of the cells populated in both (measured 68.5%). From beta = -3.0 (no
    knife edge): counts equal in every cell, time and redshift to 1e-9 on at
    least 90% of them."""
    par = tmp_path / "mapper.par"
    par.write_text(MAPPER_PAR)
    extra = [] if beta0 is None else [f"--beta0={beta0}", "--betamax=3.3"]
    j, p = _both(tmp_path, "outflow", "main_pointsource_mapper",
                 ["--outfile={out}", f"--parfile={par}"] + extra, "psmap.fits")
    a, b = np.load(f"{j}.npz"), np.load(f"{p}.npz")
    assert set(b.files) == set(a.files) and b["count"].shape == (10, 5, 8)
    fits = read_fits(str(p))
    for ext, key in (("TIME", "time"), ("REDSHIFT", "redshift"), ("NRAYS", "count"),
                     ("VOLUME", "volume")):
        np.testing.assert_array_equal(fits[ext], np.nan_to_num(b[key], nan=0.0))
    assert fits["NRAYS"].sum() > 0
    np.testing.assert_allclose(b["volume"], a["volume"], rtol=1e-12)
    for k in ("r0", "r_max", "logbin_r", "n_rays"):
        assert b[k] == a[k]
    if beta0 is None:
        assert abs(b["count"].sum() / a["count"].sum() - 1) < 0.01
    else:
        np.testing.assert_array_equal(b["count"], a["count"])
    both = (a["count"] > 0) & (b["count"] > 0)
    for k in ("time", "redshift"):
        rel = np.abs(b[k] - a[k])[both] / np.abs(a[k][both])
        assert (rel < 1e-9).mean() >= (0.6 if beta0 is None else 0.9), (k, (rel < 1e-9).mean())
    if importlib.util.find_spec("h5py"):
        from raytrace_tpu_torch.ops.mapper import load_hdf

        _, avg, vol = load_hdf(f"{p}.h5")
        np.testing.assert_array_equal(avg["count"], b["count"])


def test_perf_test_matches_jax(tmp_path, capsys):
    """rt-perf-test on the spec's par file (euler, 0.5 grid from beta = -pi,
    steplim 3000): the same ray and stuck counts as JAX's report; the steps
    total and the median / p90 / p99 / max to 2% (the beta = -pi rays split
    between the packages at machine epsilon: measured median 432 against
    430, p90 629 against 628, p99 and max equal)."""
    import re

    par = tmp_path / "perf.par"
    par.write_text(PERF_PAR)
    reports = []
    for pkg, extra in (("raytrace_tpu", []), ("raytrace_tpu_torch", ["--device=cpu"])):
        main = importlib.import_module(f"{pkg}.apps.perf_test").main
        assert main([f"--parfile={par}"] + extra) == 0
        out = capsys.readouterr().out
        rays = re.search(r"\((\d+) rays, (\d+) stuck\)", out).groups()
        total = re.search(r"steps total / per s\s+(\d+)", out).group(1)
        stats = re.search(r"median/p90/p99/max\s+([\d.]+) / ([\d.]+) / ([\d.]+) / (\d+)",
                          out).groups()
        reports.append((rays, [float(total)] + [float(x) for x in stats]))
    (ra, a), (rb, b) = reports
    assert rb == ra and int(rb[0]) > 0
    np.testing.assert_allclose(b, a, rtol=0.02)
    assert b[1] <= b[2] <= b[3] <= b[4]


SPECTRA = {
    "two_column": ("6.4 1.0\n7.06 0.12\n", [6.4, 7.06], [1.0, 0.12]),
    "comments_and_blanks": ("# iron K lines\n\n6.4 1.0\n   \n7.06 0.12\n", [6.4, 7.06],
                            [1.0, 0.12]),
    "qdp": ("READ SERR 1\n! comment line\n6.4 0.05 1.0\n6.7 0.05 0.5\n7.06 0.05 0.12\n",
            [6.4, 6.7, 7.06], [1.0, 0.5, 0.12]),
    "qdp_malformed": ("READ SERR 1 2\nLABEL X Energy\n6.4 0.05 1.0\nNO NO NO\n6.7 0.05 0.5\n"
                      "skip on\n7.06 0.05 0.12\n", [6.4, 6.7, 7.06], [1.0, 0.5, 0.12]),
    "ragged": ("6.4 0.05 1.0\n6.55 0.7\n6.7 0.05 0.5\n", [6.4, 6.7], [1.0, 0.5]),
}


@pytest.mark.parametrize("case", sorted(SPECTRA))
def test_read_spectrum_matches_jax(tmp_path, case):
    """The cases of tests/test_spectrum.py: equal to JAX's reader."""
    from raytrace_tpu.io.spectrum import read_spectrum as jax_read

    text, en, cts = SPECTRA[case]
    f = tmp_path / "spec.dat"
    f.write_text(text)
    a, b = jax_read(str(f)), read_spectrum(str(f))
    for x, y, want in zip(b, a, (en, cts)):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(x, want)


def test_read_spectrum_refuses_missing_and_empty(tmp_path):
    with pytest.raises(OSError):
        read_spectrum(str(tmp_path / "nope.dat"))
    f = tmp_path / "empty.dat"
    f.write_text("# nothing here\nREAD SERR 1\n")
    with pytest.raises(ValueError):
        read_spectrum(str(f))


@pytest.mark.parametrize("kw", [{}, {"logbin": False}, {"force_keplerian": True}])
def test_disc_areas_match_jax(kw):
    """integrate_disc_area over three discs and coordinate_disc_area on
    annuli at spin 0.9, rtol 1e-12 (measured 2.2e-16)."""
    from raytrace_tpu.geometry.disc import coordinate_disc_area as jax_coord
    from raytrace_tpu.geometry.disc import integrate_disc_area as jax_int

    from raytrace_tpu_torch.geometry import coordinate_disc_area, integrate_disc_area

    for a, lo, hi in ((0.998, 1.3, 400.0), (0.5, 2.0, 30.0), (0.0, 6.0, 100.0)):
        np.testing.assert_allclose(float(integrate_disc_area(lo, hi, a, **kw)),
                                   float(jax_int(lo, hi, a, **kw)), rtol=1e-12)
    r = np.linspace(2.0, 50.0, 7)
    np.testing.assert_allclose(coordinate_disc_area(torch.tensor(r), 0.1, 0.9).numpy(),
                               np.asarray(jax_coord(r, 0.1, 0.9)), rtol=1e-12)


def test_config_positional_and_default_parfile(tmp_path):
    """Positional arguments are kept in order; default_parfile applies only
    without --parfile, as in the JAX Config."""
    from raytrace_tpu.config import Config as JConfig

    par = tmp_path / "a.par"
    par.write_text("spin = 0.5\nNx = 4\n")
    other = tmp_path / "b.par"
    other.write_text("spin = 0.7\n")
    argv = ["first", "--Nx=6", "second"]
    for cfg_cls in (Config, JConfig):
        cfg = cfg_cls(argv, default_parfile=str(par))
        assert cfg.args.positional == ["first", "second"]
        assert cfg.parfile == str(par)
        assert cfg.get("spin", float) == 0.5 and cfg.get("Nx", int) == 6
        cfg = cfg_cls(argv + [f"--parfile={other}"], default_parfile=str(par))
        assert cfg.parfile == str(other) and cfg.get("spin", float) == 0.7
        assert cfg_cls([]).parfile is None


NEW_APPS = [
    ("outflow", "main", OUTFLOW), ("outflow", "main_ent", OUTFLOW),
    ("outflow", "main_spectrum", OUTFLOW + ["--spectrum=lines.dat"]),
    ("outflow", "main_emis_bin", OUTFLOW), ("outflow", "main_pointsource_mapper", []),
    ("pcyg", "main", ["--Nx=4", "--Nen=5"]), ("sobolev_wind", "main_disc_wind", ["--Nen=5"]),
    ("sobolev_wind", "main_pcyg_sei", ["--Nen=5"]), ("line_profile", "main", LINE),
    ("perf_test", "main", []),
]


@pytest.mark.parametrize("mod, entry, argv", NEW_APPS)
def test_new_apps_run_on_the_card_unless_asked_for_the_cpu(tmp_path, mod, entry, argv):
    """Without --device every new app picks cuda; with no card visible it
    raises rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the apps would run on it")
    (tmp_path / "lines.dat").write_text("1.0 1.0\n")
    par = tmp_path / "mapper.par"
    par.write_text(MAPPER_PAR)
    main = getattr(importlib.import_module(f"raytrace_tpu_torch.apps.{mod}"), entry)
    extra = [f"--parfile={par}"] if entry == "main_pointsource_mapper" else []
    argv = [a.replace("lines.dat", str(tmp_path / "lines.dat")) for a in argv]
    with pytest.raises(RuntimeError, match="--device=cpu"):
        main([f"--outfile={tmp_path / 'x'}"] + argv + extra)
