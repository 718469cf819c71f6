"""Checkpoints, the profiler and the apps' progress keys of the port.

``utils.checkpoint`` writes and reads the JAX package's NPZ layout, so a
checkpoint crosses between the packages both ways; ``utils.app_phase`` with
``RT_PROFILE`` records a profiler trace; an app run with ``show_progress``
writes the same file as without it. The rays are
tests/test_capabilities.py's ``TestCheckpoint`` batch (the lamppost at h 5
on the 0.4 x 0.8 grid, RK4, r_max 200, steplim 8000, suspended after 150
iterations).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.ops import trace  # noqa: E402
from raytrace_tpu_torch.rays import from_numpy  # noqa: E402
from raytrace_tpu_torch.utils import app_phase, load_rays, profile_trace, save_rays  # noqa: E402

SPIN = 0.998
SOURCE = (0.0, 5.0, 1e-3, 0.0)
KW = dict(method="rk4", r_max=200.0, steplim=8000)


@pytest.fixture(autouse=True)
def _no_env_leak():
    """The apps setdefault RT_PROGRESS into the process environment; start
    each case without it or RT_PROFILE and put back what was there."""
    saved = {k: os.environ.pop(k, None) for k in ("RT_PROGRESS", "RT_PROFILE")}
    yield
    for k, v in saved.items():
        os.environ.pop(k, None)
        if v is not None:
            os.environ[k] = v


def _jax_rays():
    from raytrace_tpu.sources import PointSourceGrid, point_source

    return point_source(SOURCE, V=0.0, spin=SPIN, grid=PointSourceGrid.from_steps(0.4, 0.8))


def _port(jrays):
    return from_numpy({f: np.asarray(getattr(jrays, f)) for f in jrays.__dataclass_fields__},
                      device="cpu")


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A batch JAX suspended after 150 iterations and saved loads in the
    port (every field bit for bit, in its dtype) and resumes to the port's
    uninterrupted march: statuses and steps equal and r within the port's
    rk4 float64 parity gate against JAX off the 5 knife-edge rays at beta =
    -pi (tests/test_torch_resume.py; measured max |dr| 4.1e-12 there)."""
    from raytrace_tpu.ops import trace as jtrace
    from raytrace_tpu.utils import save_rays as jsave

    jrays = _jax_rays()
    jpart = jtrace(jrays, SPIN, max_iters=150, **KW)
    path = str(tmp_path / "jax.npz")
    jsave(path, jpart, spin=SPIN)
    part, meta = load_rays(path, device="cpu")
    assert float(meta["spin"]) == SPIN
    for f in jpart.__dataclass_fields__:
        x, y = getattr(part, f), np.asarray(getattr(jpart, f))
        assert x.numpy().dtype == y.dtype and np.array_equal(x.numpy(), y, equal_nan=True), f
    out = trace(part, SPIN, resume=True, **KW)
    full = trace(_port(jrays), SPIN, **KW)
    edge = np.asarray(jrays.beta) == -np.pi
    np.testing.assert_array_equal(out.status.numpy()[~edge], full.status.numpy()[~edge])
    np.testing.assert_array_equal(out.steps.numpy()[~edge], full.steps.numpy()[~edge])
    dr = np.abs(out.r.numpy() - full.r.numpy())[~edge]
    assert np.median(dr) < 1e-10 and dr.max() < 1e-11


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A port checkpoint loads in JAX's load_rays with every field and the
    metadata as written, and JAX resumes it to its own end: the statuses
    JAX's uninterrupted march gives, off the knife edge."""
    from raytrace_tpu.ops import trace as jtrace
    from raytrace_tpu.utils import load_rays as jload

    jrays = _jax_rays()
    part = trace(_port(jrays), SPIN, max_iters=150, **KW)
    path = str(tmp_path / "port.npz")
    save_rays(path, part, spin=SPIN, label="suspended")
    jpart, meta = jload(path)
    assert float(meta["spin"]) == SPIN and str(meta["label"]) == "suspended"
    for f in part.__dataclass_fields__:
        x, y = getattr(part, f).numpy(), np.asarray(getattr(jpart, f))
        assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True), f
    out = jtrace(jpart, SPIN, resume=True, **KW)
    full = jtrace(jrays, SPIN, **KW)
    edge = np.asarray(jrays.beta) == -np.pi
    np.testing.assert_array_equal(np.asarray(out.status)[~edge], np.asarray(full.status)[~edge])


def test_checkpoint_metadata_and_version(tmp_path):
    """Metadata round-trips as numpy values; a checkpoint of another
    version raises, as JAX's."""
    from raytrace_tpu_torch.sources import PointSourceGrid, point_source

    rays = point_source(SOURCE, 0.0, SPIN, PointSourceGrid.from_steps(0.4, 0.8), device="cpu")
    path = str(tmp_path / "c.npz")
    save_rays(path, rays, spin=SPIN, steps=150, tag="x", edges=[1.0, 2.0])
    back, meta = load_rays(path, device="cpu")
    assert set(meta) == {"spin", "steps", "tag", "edges"}
    assert float(meta["spin"]) == SPIN and int(meta["steps"]) == 150 and str(meta["tag"]) == "x"
    np.testing.assert_array_equal(meta["edges"], [1.0, 2.0])
    for f in rays.__dataclass_fields__:
        assert torch.equal(getattr(back, f), getattr(rays, f)), f
    with np.load(path) as data:
        payload = dict(data)
    payload["checkpoint_version"] = np.asarray(2)
    np.savez(str(tmp_path / "v2.npz"), **payload)
    with pytest.raises(ValueError, match="version 2"):
        load_rays(str(tmp_path / "v2.npz"), device="cpu")


def test_app_phase_records_a_profile(tmp_path, monkeypatch, capsys):
    """app_phase announces the phase on stderr, times it on stdout and,
    with RT_PROFILE, writes a Chrome trace of it into
    <RT_PROFILE>/<label, spaces as _>/trace.json that holds the phase's
    operations; profile_trace without a directory only times."""
    monkeypatch.setenv("RT_PROFILE", str(tmp_path))
    with app_phase("toy march"):
        torch.ones(1000).cumsum(0)
    cap = capsys.readouterr()
    assert "[toy march] ..." in cap.err and "[profile] toy march:" in cap.out
    path = tmp_path / "toy_march" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("cumsum" in str(e.get("name", "")) for e in events)
    with profile_trace(label="bare"):
        pass
    assert capsys.readouterr().out.startswith("[profile] bare: ")
    assert sorted(os.listdir(tmp_path)) == ["toy_march"]


def test_show_progress_leaves_the_output_unchanged(tmp_path, capsys):
    """The disc-image CLI with tests/test_cli_sweep.py's argv for
    rt-disc-image (17 x 17 rays, RK45) on the CPU, with and without
    --show_progress=1: with it the march takes the phased route, its bar on
    stderr and RT_PROGRESS set for the process as JAX's app does, and the
    FITS file is byte for byte the one without it."""
    from test_cli_sweep import spec_disc_image

    from raytrace_tpu_torch.apps import imageplane_disc_image

    argv, _ = spec_disc_image(tmp_path)
    out_on, out_off = tmp_path / "on.fits", tmp_path / "off.fits"
    assert imageplane_disc_image.main(argv + ["--device=cpu", f"--outfile={out_off}"]) == 0
    err = capsys.readouterr().err
    assert "[disc_image plain march+accumulate] ..." in err and "march[rk45]" not in err
    assert "RT_PROGRESS" not in os.environ
    assert imageplane_disc_image.main(argv + ["--device=cpu", "--show_progress=1",
                                              f"--outfile={out_on}"]) == 0
    assert os.environ.get("RT_PROGRESS") == "1"
    assert "march[rk45] 289 rays:" in capsys.readouterr().err
    assert out_on.read_bytes() == out_off.read_bytes()
