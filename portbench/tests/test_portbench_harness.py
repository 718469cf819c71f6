"""CPU tests of the benchmark's harness: job tables, the seeded order,
discovery by name, the per-layer readers on a synthetic trace, the import
check and the verdict.

    python -m pytest portbench/tests -q
"""

import json
import shutil
import statistics
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(harness.__file__).resolve().parent.parent


def test_job_rows_are_the_product_of_the_grid():
    traffic = {"grid": {"spin": [0.9], "a": [1, 2], "b": [3, 4, 5]}}
    rows = harness.job_rows(traffic)
    assert len(rows) == 6
    assert rows[0] == {"spin": 0.9, "a": 1, "b": 3}
    assert rows[-1] == {"spin": 0.9, "a": 2, "b": 5}
    assert harness.row_label(rows[-1], traffic) == "a=2,b=5"


@pytest.mark.parametrize("name,rows", [("emis_table", 8), ("image_isco_incl", 5)])
def test_cells_tables(name, rows):
    cell = harness.load_cell(harness.load_spec(), name)
    assert len(harness.job_rows(cell.traffic)) == rows
    driver = harness.load_driver(cell.config["driver"])
    rows = harness.job_rows(cell.traffic)
    sizes = {driver.rays(harness.job_params(cell.config, r)) for r in rows}
    assert sizes == {{"emis_table": 2_507_316, "image_isco_incl": 1_002_001}[name]}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3, -5])
def test_cycle_order_is_a_seeded_permutation(seed):
    for cycle in range(3):
        order = harness.cycle_order(8, seed, cycle)
        assert sorted(order) == list(range(8))
        assert order == harness.cycle_order(8, seed, cycle)
    orders = {tuple(harness.cycle_order(8, seed, c)) for c in range(20)}
    assert len(orders) > 1
    assert harness.cycle_order(8, seed, 0) != harness.cycle_order(8, seed + 1, 0) or \
        harness.cycle_order(8, seed, 1) != harness.cycle_order(8, seed + 1, 1)


def test_reservoir_keeps_a_seeded_uniform_sample():
    def kept(seed, n=50, k=3):
        r = harness.Reservoir(k, seed)
        for i in range(n):
            r.offer(i)
        return sorted(r.kept)

    assert kept(5) == kept(5)
    assert len(kept(5)) == 3 and kept(5, n=2) == [0, 1]
    hits = [0] * 50
    for seed in range(400):
        for i in kept(seed):
            hits[i] += 1
    assert statistics.mean(hits) == 24 and min(hits) > 5 and max(hits) < 50


def test_run_window_counts_the_job_in_flight_and_goes_on_after_a_failure():
    calls = []

    def run_job(i):
        calls.append(i)
        if len(calls) == 2:
            raise RuntimeError("boom")
        return {"i": i}, 10

    keep = harness.Reservoir(10**6, 1)
    jobs, errors = harness.run_window(run_job, [{}, {}, {}], 1, 0.05, keep=keep)
    assert errors == ["RuntimeError: boom"] and len(jobs) == len(calls) - 1 >= 2
    assert sorted(j.row for j in jobs) == sorted(i for n, i in enumerate(calls) if n != 1)
    assert len(keep.kept) == len(jobs)
    tp = harness.throughput(jobs)
    assert tp["rays_per_s"] > 0 and tp["job_p95_ms"] >= 0


def _window():
    # two jobs over 1.0 s: march kernels, other kernels and a copy, one overlap
    events = [
        ("void (anonymous namespace)::march_kernel<float, 2, 0>(rt::Params<float>, "
         "rt::Fields<float>, long, unsigned long long*)", "kernel", 0.10, 0.30),
        ("void at::native::index_add_kernel", "kernel", 0.30, 0.35),
        ("Memcpy DtoH (Device -> Pinned)", "memcpy", 0.34, 0.40),
        ("void march_refill_kernel<double, 2, 1>(...)", "kernel", 0.60, 0.80),
        ("void at::native::elementwise_kernel", "kernel", 0.85, 0.90),
    ]
    spans = [("job:0", 0.0, 0.45), ("source", 0.0, 0.08), ("job:3", 0.5, 0.95)]
    return harness.Window(events=events, spans=spans, jobs=2, window_s=1.0)


FAKE_DRIVER = """
import json
import pathlib

SOURCE = ("json", "dumps")
LOG = pathlib.Path(__file__).with_suffix(".log")


def log(*call):
    with open(LOG, "a") as f:
        f.write(json.dumps(call) + "\\n")


def load(device):
    log("load", device)
    return False


def rays(par):
    return par["n"]


def run(par, device):
    log("run", par["n"], par["x"])
    return {"v": par["x"]}


def sample(par, config, rng):
    return None


def reference(par, sample, config, *, device):
    return {"v": par["x"]}


def compare(out, ref, sample):
    return {"gap": abs(out["v"] - ref["v"])}
"""


def test_set_up_loads_the_port_and_warms_up_one_job_of_each_shape(tmp_path):
    (tmp_path / "portbench" / "drivers").mkdir(parents=True)
    (tmp_path / "portbench" / "drivers" / "fake.py").write_text(FAKE_DRIVER)
    cell = harness.Cell(name="fake", chips=1, root=tmp_path, end_to_end=[], per_layer=[],
                        config={"driver": "fake", "par": {}, "limits": {"gap": 0}},
                        traffic={"grid": {"n": [10, 20], "x": [1, 2, 3]}, "check_jobs": 1})
    logged = []
    res = harness.run_cell(cell, 2**31 + 5, 0.01, False, "cpu", log=logged.append)
    calls = [json.loads(line) for line in (tmp_path / "portbench" / "drivers" / "fake.log")
             .read_text().splitlines()]
    assert calls[:3] == [["load", "cpu"], ["run", 10, 1], ["run", 20, 1]]
    assert "2 warm-up job(s)" in logged[0] and res["correct"] and res["attempted"] > 0


def test_metric_readers_on_a_synthetic_trace():
    w = _window()
    read = lambda name: harness.load_metric(name).read(w)
    assert read("march_ms") == pytest.approx(1e3 * (0.2 + 0.2) / 2)
    assert read("other_device_ms") == pytest.approx(1e3 * (0.05 + 0.06 + 0.05) / 2)
    assert read("launches_per_job") == pytest.approx(2.5)
    assert read("device_idle_share") == pytest.approx(1.0 - (0.30 + 0.20 + 0.05))
    assert read("source_ms") == pytest.approx(80.0)
    assert harness.busy_seconds(w.events, w.window_s) == pytest.approx(0.55)


def test_metric_readers_find_nothing_in_an_empty_trace():
    empty = harness.Window(events=[], spans=[], jobs=0, window_s=1.0)
    for m in harness.load_spec()["per_layer"]:
        assert harness.load_metric(harness.quantity(m["name"])).read(empty) is None, m["name"]


def test_breakdown_names_the_top_operations_and_the_gaps_by_span():
    b = harness.breakdown(_window())
    assert {n for n, _ in b["device_ops"][:2]} == {_window().events[0][0], _window().events[3][0]}
    # gaps 0.40-0.60 (in job 3), 0.00-0.10 (in the source span inside job 0),
    # 0.90-1.00 (after job 3 ended), 0.80-0.85 (in job 3)
    gaps = [(n, round(t, 9)) for n, t in b["idle_gaps"]]
    assert gaps == [("job:3", 0.2), ("source", 0.1), ("between jobs", 0.1), ("job:3", 0.05)]


def test_every_spec_metric_has_a_reader_and_every_config_a_driver():
    spec = harness.load_spec()
    for m in spec["per_layer"]:
        assert callable(harness.load_metric(harness.quantity(m["name"])).read)
    for w in spec["workloads"]:
        cell = harness.load_cell(spec, w["name"])
        driver = harness.load_driver(cell.config["driver"])
        for attr in ("load", "rays", "run", "sample", "reference", "control", "compare",
                     "SOURCE"):
            assert hasattr(driver, attr), (w["name"], attr)
        assert set(cell.config["limits"]) and cell.config["reduced"] == []


def test_a_new_config_mix_and_metric_are_found_from_new_files_alone(tmp_path):
    """A later change adds files and BENCHMARK.json entries only: the
    harness finds them by name, and no existing file changes."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    config = json.loads((pb / "configs" / "emissivity_lamppost.json").read_text())
    config.update(name="emissivity_far", driver="emissivity_far")
    config["par"]["source"] = [0.0, 50.0, 0.001, 1.5707]
    (pb / "configs" / "emissivity_far.json").write_text(json.dumps(config))
    (pb / "drivers" / "emissivity_far.py").write_text(
        "from portbench.drivers.emissivity import *  # noqa: F401,F403\n"
        "from portbench.drivers.emissivity import SOURCE, rays  # noqa: F401\nFAR = True\n")
    (pb / "traffic" / "far_sweep.json").write_text(json.dumps({"grid": {"spin": [0.1, 0.2, 0.3]}}))
    (pb / "metrics" / "copies_per_job.py").write_text(
        "def read(window):\n"
        "    n = sum(1 for e in window.events if e[1] == 'memcpy')\n"
        "    return n / window.jobs if window.jobs else None\n")
    spec["configs"].append(dict(spec["configs"][0], name="emissivity_far",
                                file="portbench/configs/emissivity_far.json"))
    spec["workloads"].append({"name": "far_table", "config": "emissivity_far",
                              "traffic": "far_sweep", "chips": 1, "why": "far source"})
    spec["per_layer"].append({"name": "copies_per_job", "unit": "copies", "better": "lower",
                              "source": "device_trace", "layer": "host dispatch",
                              "moves": "rays_per_s", "workloads": ["far_table"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell(harness.load_spec(tmp_path), "far_table", root=tmp_path)
    assert cell.config["par"]["source"][1] == 50.0
    assert [r["spin"] for r in harness.job_rows(cell.traffic)] == [0.1, 0.2, 0.3]
    assert [m["name"] for m in cell.per_layer] == ["copies_per_job"]
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    assert harness.load_driver("emissivity_far", tmp_path).FAR
    reader = harness.load_metric("copies_per_job", tmp_path)
    assert reader.read(_window()) == pytest.approx(0.5)
    after = {p: p.read_bytes() for p in before}
    assert after == before
    old = harness.load_cell(harness.load_spec(tmp_path), "emis_table", root=tmp_path)
    assert len(harness.job_rows(old.traffic)) == 8


def test_a_quantity_split_into_groups_is_read_by_one_reader():
    assert harness.quantity("march_ms.image") == "march_ms" == harness.quantity("march_ms")
    w = _window()
    assert harness.load_metric(harness.quantity("march_ms.image")).read(w) == pytest.approx(200.0)


def test_import_check_compares_whole_top_level_names():
    ok = {"raytrace_tpu_torch": 1, "raytrace_tpu_torch.ops.integrate": 1, "numpy": 1,
          "jax_like": 1, "flaxen.x": 1, "portbench.reference": 1}
    assert harness.forbidden_modules(ok) == []
    bad = dict(ok, **{"raytrace_tpu": 1, "raytrace_tpu.apps.emissivity": 1, "jax.numpy": 1,
                      "jaxlib": 1, "flax.linen": 1})
    assert harness.forbidden_modules(bad) == ["flax.linen", "jax.numpy", "jaxlib", "raytrace_tpu",
                                             "raytrace_tpu.apps.emissivity"]


def test_verdict_puts_each_number_beside_its_limit():
    ok, checks = harness.verdict({"a": 0, "b": 1e-12}, {"a": 0, "b": 1e-10})
    assert ok and checks == {"a": {"value": 0.0, "limit": 0}, "b": {"value": 1e-12, "limit": 1e-10}}
    ok, checks = harness.verdict({"a": 1, "b": float("inf")}, {"a": 0, "b": 1e-10, "c": 1})
    assert not ok and checks["b"]["value"] == "inf" and checks["c"]["value"] == "inf"
    json.dumps(checks, allow_nan=False)


def test_spec_follows_the_contract_shape():
    spec = harness.load_spec()
    assert spec["command"] == ["python3", "portbench/run.py"] and spec["paths"] == ["portbench"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    cells = {w["name"] for w in spec["workloads"]}
    reported = {c: {m["name"] for m in spec["end_to_end"] if c in m.get("workloads", cells)}
                for c in cells}
    for m in spec["per_layer"]:
        assert set(m["workloads"]) <= cells
        assert all(m["moves"] in reported[c] for c in m["workloads"]), m["name"]
    for c in cells:
        assert "setup_s" in reported[c] and len(reported[c]) >= 2
        assert any(c in m["workloads"] for m in spec["per_layer"])
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in spec["configs"]:
        assert (ROOT / c["file"]).exists()
