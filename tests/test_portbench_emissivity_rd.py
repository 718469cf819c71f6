"""The emissivity_rd configuration of the port's benchmark, at test sizes.

On the CPU the port marches in float64 (the plain route) and so does the
plain reference (``portbench/reference/emissivity_rd.py``): at a small
grid and step budget the port's destination-API job and the reference's
table agree bit for bit. The reference's ``ray_redshift_dest`` is the
port's, bit for bit, on seeded float64 states; the reference one precision
lower (``control --kind all``, and the bins' sums alone, ``--kind sums``)
fails the cell's limits. Under the port's recorder the rd job records the
plain job's spans, under the same parents. The cell's table, driver and
readers resolve, at the par file's full width. The test marked ``cuda``
holds the rd job's spans on the card, where the march kernel and the
scatter kernel open their own. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_portbench_emissivity_rd.py
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from portbench import harness  # noqa: E402
from portbench.reference import emissivity_rd as ref_rd  # noqa: E402

CELL = "emis_rd_table"
ROOT = Path(harness.__file__).resolve().parent.parent
# a small grid (35 rays) and a bounded march
SMALL = {"dcosalpha": 0.4, "dbeta": 1.0, "steplim": 3000}
ROWS = [{"spin": 0.998, "source_h": 3.0}, {"spin": 0.5, "source_h": 20.0}]


def small_par(row, config="emissivity_rd"):
    path = {c["name"]: c["file"] for c in harness.load_spec()["configs"]}[config]
    with open(ROOT / path) as f:
        config = json.load(f)
    return dict(harness.job_params(config, row), **SMALL), config


@pytest.fixture(scope="module")
def entry():
    return harness.load_driver("emissivity_rd")


@pytest.fixture(scope="module")
def job(entry):
    """Per row of ``ROWS``: the par values, the configuration, the port's
    job on the CPU and the reference's table."""
    done = {}

    def get(i):
        if i not in done:
            par, config = small_par(ROWS[i])
            done[i] = (par, config, entry.run(par, device="cpu"),
                       entry.reference(par, None, config, device="cpu"))
        return done[i]

    return get


@pytest.mark.parametrize("i", range(len(ROWS)))
def test_job_is_the_reference_bit_for_bit(entry, job, i):
    par, _, out, ref = job(i)
    assert entry.rays(par) == 35
    assert entry.compare(out, ref, None) == {"rays_gap": 0, "col_gap": 0.0}
    # the table holds something: rays in some bins, none in others
    assert 0 < out["rays"].sum() < 35 and (out["rays"] == 0).any()
    for c in ("r", "area", "flux", "emis", "redshift", "time"):
        assert out[c].shape == (100,), c


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import portbench.reference.emissivity_rd; "
            "import portbench.drivers.emissivity_rd; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('raytrace_tpu_torch', 'raytrace_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _states(cls_blank, seed, n=4000):
    """A batch of ``cls_blank``'s class holding float64 ray ends drawn from
    ``seed``: positions, constants, signs, energies, step counts and
    statuses of every kind (stuck, dead and untraced rays among them)."""
    from portbench.reference.rays import (RAY_STATUS_DEST, RAY_STATUS_HORIZON,
                                          RAY_STATUS_RLIM, RAY_STATUS_STEPLIM)

    gen = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, dtype=torch.float64)

    def sign():
        return torch.where(torch.rand(n, generator=gen) < 0.5, -1.0, 1.0).double()

    kinds = torch.tensor([RAY_STATUS_DEST, RAY_STATUS_HORIZON, RAY_STATUS_RLIM,
                          RAY_STATUS_STEPLIM], dtype=torch.int32)
    steps = torch.randint(-3, 400, (n,), generator=gen, dtype=torch.int32)
    return cls_blank(n, device="cpu").replace(
        t=u(0.0, 3e3), r=u(1.3, 1200.0), theta=u(0.0, math.pi), phi=u(-7.0, 7.0),
        k=u(0.3, 2.0), h=u(-12.0, 12.0), Q=u(0.0, 60.0), rdot_sign=sign(),
        thetadot_sign=sign(), emit=u(0.2, 3.0), steps=steps,
        status=kinds[torch.randint(0, 4, (n,), generator=gen)])


@pytest.mark.parametrize("spin", [0.998, 0.5])
@pytest.mark.parametrize("reverse", [False, True])
def test_ray_redshift_dest_is_the_ports(spin, reverse):
    from portbench.reference.destinations import ThetaLimit as RefThetaLimit
    from portbench.reference.rays import blank_batch as ref_blank
    from raytrace_tpu_torch.destinations import FlatDisc
    from raytrace_tpu_torch.ops.redshift import ray_redshift_dest
    from raytrace_tpu_torch.rays import blank_batch

    ref = ref_rd.ray_redshift_dest(_states(ref_blank, 20), spin, RefThetaLimit(math.pi / 2),
                                   reverse)
    port = ray_redshift_dest(_states(blank_batch, 20), spin, FlatDisc(math.pi / 2), reverse)
    assert ref.dtype == port.dtype == torch.float64
    assert torch.equal(ref.view(torch.int64), port.view(torch.int64))
    # redshifts and blueshifts, all finite (the stuck and dead rays' ends
    # are evaluated at a benign point)
    assert torch.isfinite(ref).all() and (ref < 1).any() and (ref > 1).any()


@pytest.mark.parametrize("kind", ["all", "sums"])
def test_control_in_lower_precision_is_not_correct(entry, job, kind):
    par, config, _, ref = job(0)
    control = entry.control(par, None, config, device="cpu", kind=kind)
    ok, checks = harness.verdict(entry.compare(control, ref, None), config["limits"])
    assert not ok, checks
    assert checks["col_gap"]["value"] > 3 * config["limits"]["col_gap"], checks
    if kind == "all":  # the float32 march counts rays into other bins
        assert checks["rays_gap"]["value"] > 0, checks


def _span_tree(rec):
    """The recording's spans as (name, parent's name), in the order they open."""
    names = [s[0] for s in rec.spans]
    return [(name, names[parent] if parent >= 0 else None) for name, parent, _, _ in rec.spans]


def _recorded(par, device, variant, monkeypatch):
    """The span tree of the rd driver's job under the port's recorder, the
    app's ``compute`` called with ``variant`` in place of the driver's."""
    from raytrace_tpu_torch.apps import emissivity
    from raytrace_tpu_torch.utils import profiling

    compute = emissivity.compute
    monkeypatch.setattr(emissivity, "compute", lambda **kw: compute(**dict(kw, variant=variant)))
    profiling.start(device=device)
    try:
        out = harness.load_driver("emissivity_rd").run(par, device=device)
    finally:
        rec = profiling.stop()
        monkeypatch.undo()
    assert out["rays"].sum() > 0
    return _span_tree(rec), rec


def test_rd_job_records_the_plain_jobs_spans(monkeypatch):
    """Under the recorder, a CPU run of the rd driver's job records the
    spans of the same job through the plain variant: one ``rt.compute``
    root and under it ``rt.source``, ``rt.redshift`` twice, ``rt.march``,
    ``rt.bins`` (its scatter's route span beneath it), ``rt.areas`` and
    ``rt.to_host``, each under the same parent."""
    par, _ = small_par(ROWS[0])
    trees = {v: _recorded(par, "cpu", v, monkeypatch)[0] for v in ("rd", "plain")}
    assert trees["rd"] == trees["plain"]
    assert trees["rd"] == [
        ("rt.compute", None), ("rt.source", "rt.compute"), ("rt.redshift", "rt.compute"),
        ("rt.march", "rt.compute"), ("rt.redshift", "rt.compute"), ("rt.bins", "rt.compute"),
        ("rt.bins.index_add", "rt.bins"), ("rt.areas", "rt.compute"),
        ("rt.to_host", "rt.compute")]


def test_cell_table_and_readers():
    from raytrace_tpu_torch.config import Config
    from raytrace_tpu_torch.ops import kernel_steplim

    spec = harness.load_spec()
    cell = harness.load_cell(spec, CELL)
    rows = harness.job_rows(cell.traffic)
    assert [(r["spin"], r["source_h"]) for r in rows] == [
        (s, h) for s in (0.5, 0.998) for h in (3.0, 5.0, 10.0, 20.0)]
    entry = harness.load_driver(cell.config["driver"])
    assert {entry.rays(harness.job_params(cell.config, r)) for r in rows} == {2_507_316}
    assert cell.chips == 1 and cell.config["reduced"] == [] and cell.traffic["check_jobs"] == 1
    assert cell.config["host_threads"] == 1
    assert cell.config["limits"] == {"rays_gap": 0, "col_gap": 1e-8}
    assert [m["name"] for m in cell.end_to_end] == ["rays_per_s", "job_p95_ms", "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    assert names == [f"{q}.rd" for q in ("source_ms", "march_ms", "other_device_ms",
                                         "launches_per_job", "device_idle_share")]
    for m in cell.per_layer:
        assert callable(harness.load_metric(harness.quantity(m["name"])).read)
        assert m["moves"] == "rays_per_s" and m["workloads"] == [CELL]
    # the par values are the par file's, the app's defaults for the keys it
    # leaves out, and the card's RK4 cap stated
    par = cell.config["par"]
    cfg = Config([f"--parfile={ROOT / 'par_example' / 'emissivity_rd.par'}"])
    assert (cfg.get("spin", float), cfg.get("dcosalpha", float), cfg.get("dbeta", float),
            cfg.get("Nr", int), cfg.get("integrator", str)) == (
        par["spin"], par["dcosalpha"], par["dbeta"], par["Nr"], par["integrator"])
    np.testing.assert_array_equal(cfg.get_array("source", float, 4), par["source"])
    assert (par["r_max"], par["r_disc"], par["gamma"], par["theta_lim"], par["V"]) == (
        1000.0, 500.0, 2.0, math.pi / 2, 0.0)
    assert par["steplim"] == kernel_steplim("rk4") == 30_000


@pytest.mark.cuda
def test_card_rd_job_records_the_kernel_spans(monkeypatch):
    """At the cell's full width on the card, the rd job's spans are the
    plain variant's: under ``rt.march`` the kernel's ``rt.march.prepare``,
    ``rt.march.launch`` and ``rt.march.finish``, under ``rt.bins`` the
    scatter kernel's ``rt.bins.kernel``; its one launch counts lane
    iterations."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the march and the bins run CUDA kernels")
    cell = harness.load_cell(harness.load_spec(), CELL)
    par = harness.job_params(cell.config, {"spin": 0.998, "source_h": 5.0})
    harness.load_driver("emissivity_rd").load("cuda")
    trees = {}
    for variant in ("rd", "plain"):
        trees[variant], rec = _recorded(par, "cuda", variant, monkeypatch)
        assert len(rec.launches) == 1 and rec.launches[0][1] > 0 and rec.uncounted == 0
    assert trees["rd"] == trees["plain"]
    for name in ("rt.march.prepare", "rt.march.launch", "rt.march.finish"):
        assert (name, "rt.march") in trees["rd"], trees["rd"]
    assert ("rt.bins.kernel", "rt.bins") in trees["rd"]
    assert ("rt.bins.index_add", "rt.bins") not in trees["rd"]
