"""The port's emissivity slice, end to end, against the reference binary's
golden run and against the JAX package.

Configuration of tests/test_emissivity.py: spin 0.998, lamppost at r = 5,
theta = 1e-3, V = 0, the 0.05 direction grid (5,040 rays), 100 log bins,
r_max = 1000, r_disc = 500, gamma = 2, rk45 with steplim 20000. On the CPU
the port marches with its plain lock-step version in f64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from raytrace_tpu_torch.apps import emissivity as port_app  # noqa: E402
from raytrace_tpu_torch.ops import march_kernel  # noqa: E402

GOLDEN = "tests/golden/emissivity_a0.998_h5_g0.05.dat"
SPIN = 0.998
SOURCE = (0.0, 5.0, 1e-3, 1.5707)
COLS = ["r", "area", "rays", "flux", "emis", "redshift", "time"]
KW = dict(V=0.0, r_max=1000.0, r_disc=500.0, n_r=100, logbin_r=True, gamma=2.0,
          steplim=20000)


@pytest.fixture(scope="module")
def golden():
    return dict(zip(COLS, np.loadtxt(GOLDEN).T))


@pytest.fixture(scope="module")
def mine():
    grid = port_app.PointSourceGrid.from_steps(0.05, 0.05)
    return port_app.compute(SPIN, SOURCE, grid=grid, device="cpu", **KW)


@pytest.fixture(scope="module")
def jax_out():
    from raytrace_tpu.apps.emissivity import compute
    from raytrace_tpu.sources import PointSourceGrid

    return compute(SPIN, SOURCE, grid=PointSourceGrid.from_steps(0.05, 0.05), **KW)


def _gated(ref, out, min_rays=100, count_tol=0.10):
    n_ref, n_out = ref["rays"], out["rays"]
    good = (n_ref >= min_rays) & (n_out >= min_rays)
    with np.errstate(divide="ignore", invalid="ignore"):
        return good & (np.abs(n_out - n_ref) / np.where(n_ref == 0, 1, n_ref) < count_tol)


def _max_dev(ref, out, field, ok):
    return np.abs(out[field][ok] / ref[field][ok] - 1).max()


def test_port_matches_golden(golden, mine):
    """The reference's count-gated methodology (tests/test_emissivity.py:46-77):
    bins with >= 100 rays in both runs and counts within 10%."""
    np.testing.assert_allclose(mine["r"], golden["r"], rtol=1e-6)
    np.testing.assert_allclose(mine["area"], golden["area"], rtol=1e-6)
    ok = _gated(golden, mine)
    assert ok.sum() >= 12
    assert _max_dev(golden, mine, "emis", ok) < 0.10
    assert _max_dev(golden, mine, "flux", ok) < 0.10
    assert _max_dev(golden, mine, "redshift", ok) < 0.005
    assert _max_dev(golden, mine, "time", ok) < 0.05


def test_port_matches_jax_compute(jax_out, mine):
    """Same count gates made tighter: the two f64 marches agree ray for ray
    except for the rare chaotic rays the test_native.py gates allow, so
    bins with >= 100 rays and counts within 1% agree to 1% in emissivity
    and flux, 1e-4 in redshift and 1e-3 in time."""
    np.testing.assert_allclose(mine["r"], jax_out["r"], rtol=1e-12)
    np.testing.assert_allclose(mine["area"], jax_out["area"], rtol=1e-12)
    ok = _gated(jax_out, mine, count_tol=0.01)
    assert ok.sum() >= 12
    assert _max_dev(jax_out, mine, "emis", ok) < 0.01
    assert _max_dev(jax_out, mine, "flux", ok) < 0.01
    assert _max_dev(jax_out, mine, "redshift", ok) < 1e-4
    assert _max_dev(jax_out, mine, "time", ok) < 1e-3


def test_app_cli(tmp_path):
    """The CLI entry point on a tiny par file, as tests/test_emissivity.py:110-132."""
    par = tmp_path / "emis.par"
    par.write_text(
        f"""
outfile = {tmp_path}/out.dat
source = 0 5 1E-3 1.5707
V = 0
spin = 0.998
dcosalpha = 0.2
dbeta = 0.2
Nr = 20
logbin_r = 1
steplim = 4000
"""
    )
    assert port_app.main([f"--parfile={par}", "--device=cpu"]) == 0
    out = np.loadtxt(tmp_path / "out.dat")
    assert out.shape == (20, 7)
    assert (out[:, 2] >= 0).all()
    assert np.nansum(out[:, 4]) > 0


def test_trace_auto_routes_cpu_to_plain_march():
    """A CPU batch goes to the plain march; the kernel is never launched."""
    from raytrace_tpu_torch.ops import trace, trace_auto

    grid = port_app.PointSourceGrid.from_steps(0.4, 0.8)
    rays = port_app.point_source(SOURCE, 0.0, SPIN, grid, device="cpu")
    before = march_kernel.launches
    a = trace_auto(rays, SPIN, method="rk4", steplim=2000)
    b = trace(rays, SPIN, method="rk4", steplim=2000)
    assert march_kernel.launches == before == 0
    torch.testing.assert_close(a.r, b.r, rtol=0, atol=0)
    assert torch.equal(a.steps, b.steps) and torch.equal(a.status, b.status)


@pytest.mark.parametrize("route", ["trace_auto", "trace_kernel"])
def test_march_routes_reject_unknown_keywords(route):
    """Both routes of trace_auto take trace's keywords and refuse others
    (a CPU batch: the keyword check comes before trace_kernel's device check)."""
    from raytrace_tpu_torch import ops

    grid = port_app.PointSourceGrid.from_steps(0.4, 0.8)
    rays = port_app.point_source(SOURCE, 0.0, SPIN, grid, device="cpu")
    with pytest.raises(TypeError, match="refine_crosing"):
        getattr(ops, route)(rays, SPIN, method="rk4", steplim=10, refine_crosing=False)


def test_compute_args_of_shipped_par_file():
    """The CLI's reading of par_example/emissivity.par: the 2.5 M-ray RK45
    run that chip_smoke drives on the card."""
    from pathlib import Path

    from raytrace_tpu_torch.config import Config

    par = Path(__file__).resolve().parent.parent / "par_example" / "emissivity.par"
    kw = port_app.compute_args(Config([f"--parfile={par}", "--device=cpu"]))
    assert kw["grid"].n_rays == 399 * 6284 == 2_507_316
    assert (kw["spin"], kw["method"], kw["steplim"], kw["n_r"]) == (0.998, "rk45", None, 100)
    assert kw["source"] == [0.0, 5.0, 1e-3, 1.5707]
    assert kw["r_max"] == 1000.0 and kw["r_disc"] == 500.0 and kw["r_min"] is None


def _jax_and_port_batches(step=0.2):
    """One traced lamppost batch in both packages, from identical state."""
    from raytrace_tpu.ops import trace as jtrace
    from raytrace_tpu.sources import PointSourceGrid, point_source
    from raytrace_tpu_torch.ops import trace
    from raytrace_tpu_torch.rays import from_numpy

    jr = point_source(SOURCE, V=0.0, spin=SPIN, grid=PointSourceGrid.from_steps(step, step))
    jr = jtrace(jr, SPIN, method="rk4", steplim=4000)
    d = {f: np.asarray(getattr(jr, f)) for f in jr.__dataclass_fields__}
    return jr, from_numpy(d, device="cpu")


def test_redshift_matches_jax():
    """redshift_start, apply_redshift (Keplerian receiver) and range_phi on
    the same traced batch, f64, to rounding."""
    from raytrace_tpu.ops import redshift as jrs
    from raytrace_tpu_torch.ops import redshift as prs

    jr, pr = _jax_and_port_batches()
    np.testing.assert_allclose(
        prs.redshift_start(pr, SPIN, 0.0).emit.numpy(),
        np.asarray(jrs.redshift_start(jr, SPIN, 0.0).emit), rtol=1e-12)
    np.testing.assert_allclose(
        prs.apply_redshift(pr, SPIN, V=-1.0).redshift.numpy(),
        np.asarray(jrs.apply_redshift(jr, SPIN, V=-1.0).redshift), rtol=1e-12)
    np.testing.assert_allclose(
        prs.range_phi(pr).phi.numpy(), np.asarray(jrs.range_phi(jr).phi), rtol=1e-12)


@pytest.mark.parametrize("logbin", [True, False])
def test_radial_bin_profile_matches_jax(logbin):
    """Counts exactly, sums to rounding (the scatter-adds run in another order)."""
    from raytrace_tpu.ops.reductions import bin_edges as jedges
    from raytrace_tpu.ops.reductions import radial_bin_profile as jprof
    from raytrace_tpu_torch.ops.reductions import bin_edges, radial_bin_profile

    rng = np.random.default_rng(7)
    r = rng.uniform(1.0, 600.0, 4000)
    w = rng.standard_normal(4000)
    mask = rng.random(4000) < 0.8
    r_min, r_max, n = 1.2, 500.0, 50
    je, jw, jdr = jedges(r_min, r_max, n, logbin)
    pe, pw, pdr = bin_edges(r_min, r_max, n, logbin, device="cpu")
    np.testing.assert_allclose(pe.numpy(), np.asarray(je), rtol=1e-12)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-12)
    jc, js = jprof(jnp.asarray(r), jnp.asarray(mask), {"w": jnp.asarray(w)}, r_min,
                   float(jdr), n, logbin)
    pc, ps = radial_bin_profile(torch.from_numpy(r), torch.from_numpy(mask),
                                {"w": torch.from_numpy(w)}, r_min, pdr, n, logbin)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ps["w"].numpy(), np.asarray(js["w"]), rtol=1e-12, atol=1e-12)
