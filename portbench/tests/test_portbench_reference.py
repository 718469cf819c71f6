"""The plain reference and what decides ``correct``, at test sizes.

On the CPU the port marches in float64 (the plain route), and so does the
reference: the two agree bit for bit. The control (the float64 stages one
precision lower) and each fault the cells can have, planted in the port
under a whole run of the harness, come out not correct. Tests marked
``cuda`` run the same on the card, where the port marches in float32
through the kernel.

    python -m pytest portbench/tests -q            # CPU
    python -m pytest portbench/tests -q -m cuda    # on the card
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness

ROOT = Path(harness.__file__).resolve().parent.parent
# test sizes: a coarse lamppost grid, a 21 x 21 camera into a 20 x 20 image
SMALL = {"emis_table": {"dcosalpha": 0.4, "dbeta": 1.0},
         "image_isco_incl": {"Nx": 20, "img_Nx": 20}}


def small_cell(name, rows=1):
    """``name`` at test size, its table cut to its last ``rows`` rows."""
    cell = harness.load_cell(harness.load_spec(), name)
    cell.config["par"].update(SMALL[name])
    if "check" in cell.config and "pixels" in cell.config["check"]:
        cell.config["check"]["pixels"] = 200
    cell.traffic["grid"] = {k: v[-rows:] for k, v in cell.traffic["grid"].items()}
    cell.traffic["check_jobs"] = 1
    return cell


def device_or_skip(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return device


def one_job(cell, seed=3):
    driver = harness.load_driver(cell.config["driver"])
    par = harness.job_params(cell.config, harness.job_rows(cell.traffic)[0])
    return driver, par, driver.sample(par, cell.config, harness.seed_rng(seed, 3, 0))


@pytest.mark.parametrize("name", ["emis_table", "image_isco_incl"])
def test_reference_is_the_ports_cpu_route_bit_for_bit(name):
    cell = small_cell(name)
    driver, par, sample = one_job(cell)
    out = driver.run(par, device="cpu")
    ref = driver.reference(par, sample, cell.config, device="cpu")
    nums = driver.compare(out, ref, sample)
    assert all(v == 0 for v in nums.values()), nums
    hits = ref["rays"] if "rays" in ref else ref["counts"]
    assert np.nansum(hits) > 0


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import portbench.reference.jobs, portbench.judge, portbench.harness; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('raytrace_tpu_torch', 'raytrace_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("kind", ["all", "sums"])
@pytest.mark.parametrize("name", ["emis_table", "image_isco_incl"])
def test_control_in_lower_precision_is_not_correct(name, kind, device):
    device = device_or_skip(device)
    cell = small_cell(name)
    driver, par, sample = one_job(cell)
    ref = driver.reference(par, sample, cell.config, device=device)
    control = driver.control(par, sample, cell.config, device=device, kind=kind)
    ok, checks = harness.verdict(driver.compare(control, ref, sample), cell.config["limits"])
    assert not ok, checks
    if device == "cuda":  # and the port itself, through the kernel, is
        ok, checks = harness.verdict(driver.compare(driver.run(par, device=device), ref, sample),
                                     cell.config["limits"])
        assert ok, checks


def _unchanged_march(rays, spin, *args, **kwargs):
    return rays


def _half_the_rays(original):
    def source(*args, **kwargs):
        rays = original(*args, **kwargs)
        return rays[: rays.n_rays // 2]
    return source


def _altered_answer(original, key):
    def produce(*args, **kwargs):
        counts, maps = original(*args, **kwargs)
        return counts, dict(maps, **{key: maps[key] * (1.0 + 1e-6)})
    return produce


# each cell's app module, its source entry, the call that produces its
# answer and the map of the answer a fault alters
APPS = {"emis_table": ("raytrace_tpu_torch.apps.emissivity", "point_source",
                       "sharded_emissivity_bins", "emis"),
        "image_isco_incl": ("raytrace_tpu_torch.apps.imageplane_disc_image", "image_plane",
                            "sharded_disc_image", "flux")}
FAULTS = ("march returns its state unchanged", "half of the batch left out", "an answer altered")


def plant(monkeypatch, name, fault):
    """Break the port where it produces what ``fault`` names."""
    import importlib

    module, source, producer, key = APPS[name]
    app = importlib.import_module(module)
    if fault == FAULTS[0]:
        monkeypatch.setattr("raytrace_tpu_torch.parallel.sharding.trace_auto", _unchanged_march)
    elif fault == FAULTS[1]:
        monkeypatch.setattr(app, source, _half_the_rays(getattr(app, source)))
    else:
        monkeypatch.setattr(app, producer, _altered_answer(getattr(app, producer), key))


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", ["emis_table", "image_isco_incl"])
def test_a_run_with_a_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    """A whole run of the harness but its look for a card, on the CPU, with
    the port broken underneath: ``correct`` comes out false."""
    cell = small_cell(name)
    clean = harness.run_cell(cell, 2**31 + 9, 0.01, False, "cpu", log=lambda *a: None)
    assert clean["correct"], clean["checks"]
    plant(monkeypatch, name, fault)
    res = harness.run_cell(cell, 2**31 + 9, 0.01, False, "cpu", log=lambda *a: None)
    assert not res["correct"], res["checks"]
