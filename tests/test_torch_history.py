"""The port's trajectory recording and dumps against the JAX package and
the reference binary's goldens.

``trace_with_history`` is held against JAX's on the same rays in float64
on the CPU: a lamppost off the axis (r = 5, theta = 0.4, spin 0.9) on the
grid PointSourceGrid.from_steps(0.25, 0.5, -0.9, 0.9, -2.9, 3.1), 104 rays
of which 96 live, none launched at a polar turning point (sin(beta) = 0,
where the two packages' tiny-floored square roots split at machine
epsilon), write_step 20 and 96 snapshots, so that every ray stops before the
last snapshot and the padded tail is compared too. Errors are taken
relative to max(|x|, 1). The trajectory goldens are run through the port's
``main`` and ``main_imageplane`` under the gates of
tests/test_capabilities.py:346-440.

The JAX package is imported inside the tests that use it:

    python -m pytest --noconftest -m cuda tests/test_torch_history.py
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.destinations import ThetaLimit  # noqa: E402
from raytrace_tpu_torch.ops.history import dump_trajectories, trace_with_history  # noqa: E402
from raytrace_tpu_torch.rays import from_numpy  # noqa: E402
from raytrace_tpu_torch.sources import PointSourceGrid, point_source  # noqa: E402

SPIN = 0.9
SOURCE = (0.0, 5.0, 0.4, 0.0)
KW = dict(r_max=50.0, write_step=20, n_snapshots=96)


def _grid():
    return PointSourceGrid.from_steps(0.25, 0.5, -0.9, 0.9, -2.9, 3.1)


def _jax_case(method):
    """JAX's source and history, and the port's batch rebuilt from JAX's
    source state bit for bit."""
    from raytrace_tpu.destinations import ThetaLimit as JTheta
    from raytrace_tpu.ops.history import trace_with_history as jhistory
    from raytrace_tpu.sources import PointSourceGrid as JGrid
    from raytrace_tpu.sources import point_source as jps

    j = jps(SOURCE, 0.0, SPIN, JGrid.from_steps(0.25, 0.5, -0.9, 0.9, -2.9, 3.1))
    final, hist = jhistory(j, SPIN, method=method, dest=JTheta(math.pi / 2), **KW)
    d = {f: np.asarray(getattr(j, f)) for f in j.__dataclass_fields__}
    return j, final, np.asarray(hist), from_numpy(d, device="cpu")


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1.0)


@pytest.mark.parametrize("method", ["euler", "rk4", "rk45"])
def test_trace_with_history_matches_jax(method):
    """The [96, 5, 104] history against JAX's, padded tail included, and the
    final state. Euler and RK4: r and theta to 1e-10, t and phi to 1e-9
    (dt/dlambda and dphi/dlambda grow as 1/Delta towards the horizon, so the
    last snapshot of a captured ray carries its rounding amplified: measured
    worst 1.1e-10, in t). RK45: the DOPRI5 step
    sequence splits on libm rounding noise in the error estimate (ROADMAP
    Queue 3: f64 RK45 marches of the two packages agree to ~3e-9 relative
    on escapes), so every entry to 1e-4, the active flags and the final
    statuses equal, and at least 40% of the rays to 1e-10 over their whole
    history (measured 48%, worst ray 1.1e-5)."""
    _, jfinal, jhist, rays = _jax_case(method)
    final, hist = trace_with_history(rays, SPIN, method=method, dest=ThetaLimit(math.pi / 2),
                                     **KW)
    hist = hist.numpy()
    assert hist.shape == jhist.shape == (96, 5, 104)
    stopped = np.flatnonzero(jhist[:, 4].sum(axis=1) == 0)
    assert stopped.size and stopped[0] < 90  # a padded tail of frozen snapshots
    np.testing.assert_array_equal(hist[:, 4], jhist[:, 4])
    np.testing.assert_array_equal(final.status.numpy(), np.asarray(jfinal.status))
    rel = _rel(hist[:, :4], jhist[:, :4])
    if method == "rk45":
        assert rel.max() < 1e-4
        per_ray = rel.max(axis=(0, 1))
        assert (per_ray < 1e-10).mean() >= 0.4
    else:
        assert rel[:, 1:3].max() < 1e-10
        assert rel[:, [0, 3]].max() < 1e-9
        np.testing.assert_array_equal(final.steps.numpy(), np.asarray(jfinal.steps))
        assert _rel(final.r.numpy(), np.asarray(jfinal.r)).max() < 1e-10


@pytest.mark.parametrize("method", ["euler", "rk45"])
def test_finished_rays_stay_frozen(method):
    """A longer recording changes nothing once every ray has stopped: the
    final state is bitwise the shorter run's and the extra snapshots repeat
    it with the flag 0."""
    rays = point_source(SOURCE, 0.0, SPIN, _grid(), device="cpu")
    a_final, a = trace_with_history(rays, SPIN, method=method, dest=ThetaLimit(), **KW)
    b_final, b = trace_with_history(rays, SPIN, method=method, dest=ThetaLimit(),
                                    **dict(KW, n_snapshots=160))
    assert torch.equal(a, b[:96])
    assert (b[96:, 4] == 0).all() and torch.equal(b[96:, :4], b[95:96, :4].expand(64, -1, -1))
    for f in ("t", "r", "theta", "phi", "steps", "status", "dt", "rdot_sign", "thetadot_sign"):
        assert torch.equal(getattr(a_final, f), getattr(b_final, f)), f


@pytest.mark.parametrize("kw", [dict(), dict(cartesian=False),
                                dict(write_rmax=20.0, write_rmin=3.0)])
def test_dump_trajectories_writes_jax_bytes(tmp_path, kw):
    """On one shared history (JAX's RK4 recording) the port writes the very
    bytes JAX writes: Cartesian and Boyer-Lindquist rows, and a radius
    window that starts and stops recordings."""
    from raytrace_tpu.ops.history import dump_trajectories as jdump

    j, _, jhist, rays = _jax_case("rk4")
    jdump(str(tmp_path / "jax.dat"), j, jhist, SPIN, **kw)
    dump_trajectories(str(tmp_path / "port.dat"), rays, torch.tensor(jhist), SPIN, **kw)
    ref = (tmp_path / "jax.dat").read_bytes()
    assert len(ref) > 10_000
    assert (tmp_path / "port.dat").read_bytes() == ref


def _load(path):
    trajs, cur = [], []
    for line in open(path):
        s = line.split()
        if not s:
            if cur:
                trajs.append(np.array(cur))
                cur = []
            continue
        cur.append([float(v) for v in s])
    if cur:
        trajs.append(np.array(cur))
    return trajs


def test_lamppost_trajectories_match_reference(tmp_path):
    """tests/test_capabilities.py:373-404 through the port's ``main``: at
    least 34 of the 40 Euler trajectories (spin 0.998, r = 5, write_step 20)
    matched point by point to 1e-4 over their first 10 snapshots."""
    from raytrace_tpu_torch.apps.trace_rays import main

    out = tmp_path / "mine.dat"
    assert main([
        f"--outfile={out}", "--source=0 5 1E-3 0", "--V=0", "--spin=0.998",
        "--dcosalpha=0.4", "--dbeta=0.8", "--r_max=50", "--theta_max=1.5707963",
        "--write_step=20", "--integrator=euler", "--device=cpu",
    ]) == 0
    ref = _load("tests/golden/trace_rays_a0.998_r5_euler.dat")
    mine = _load(str(out))
    assert len(mine) == len(ref) == 40
    matched = 0
    for m in mine:
        d = [np.linalg.norm(m[0] - r[0]) for r in ref]
        j = int(np.argmin(d))
        if d[j] > 1e-5:
            continue
        n = min(len(m), len(ref[j]), 10)
        if np.abs(m[:n] - ref[j][:n]).max() < 1e-4:
            matched += 1
    assert matched >= 34, f"only {matched}/40 trajectories matched"


def test_imageplane_trajectories_match_reference(tmp_path):
    """tests/test_capabilities.py:408-440 through the port's
    ``main_imageplane``: 9 backward Euler trajectories (dist 100, incl 60,
    spin 0.9), the same snapshot count within one, the leading half of each
    at rtol 2e-5, atol 2e-4."""
    from raytrace_tpu_torch.apps.trace_rays import main_imageplane

    out = tmp_path / "mine.dat"
    assert main_imageplane([
        f"--outfile={out}", "--dist=100", "--incl=60", "--spin=0.9",
        "--x0=-6.5", "--xmax=5.5", "--Nx=3", "--y0=-6.5", "--ymax=5.5", "--Ny=3",
        "--write_step=50", "--n_snapshots=1024", "--integrator=euler", "--thetamax=0",
        "--device=cpu",
    ]) == 0
    ref = _load("tests/golden/trace_rays_imageplane_a0.9_d100_i60_euler.dat")
    mine = _load(str(out))
    assert len(mine) == len(ref) == 9
    for m, r in zip(mine, ref):
        assert abs(len(m) - len(r)) <= 1
        n = max(2, min(len(m), len(r)) // 2)
        np.testing.assert_allclose(m[:n], r[:n], rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("entry, extra", [("main_jetpoint", ["--v_jet=0.4"]),
                                          ("main_vel", ["--u_r=0.1", "--u_phi=0.02"])])
def test_moving_source_dumps_match_jax(tmp_path, entry, extra):
    """The jet and moving-source dumps (Euler, r = 5 on the axis, the 0.4 x
    1.5 grid from beta = -3.1, so no ray starts at a polar turning point)
    against JAX's: the same trajectories and rows, each value to the 6
    significant digits of the text within 2 units of the last."""
    from raytrace_tpu.apps import trace_rays as jax_app

    from raytrace_tpu_torch.apps import trace_rays as port_app

    args = ["--spin=0.9", "--r_max=40", "--write_step=10", "--n_snapshots=200",
            "--beta0=-3.1", "--betamax=3.2"] + extra
    assert getattr(jax_app, entry)([f"--outfile={tmp_path / 'jax.dat'}"] + args) == 0
    assert getattr(port_app, entry)([f"--outfile={tmp_path / 'port.dat'}", "--device=cpu"]
                                    + args) == 0
    ref, mine = _load(str(tmp_path / "jax.dat")), _load(str(tmp_path / "port.dat"))
    assert len(mine) == len(ref) >= 20
    for m, r in zip(mine, ref):
        assert m.shape == r.shape
        np.testing.assert_allclose(m, r, rtol=2e-6, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["euler", "rk45"])
def test_history_graph_replay_matches_eager_on_cuda(monkeypatch, method):
    """On the card the recording march replays one captured iteration as a
    CUDA graph: its history and final state are bitwise the eager march's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU version")
    from raytrace_tpu_torch.ops import integrate

    rays = point_source(SOURCE, 0.0, SPIN, _grid(), device="cuda")
    a_final, a = trace_with_history(rays, SPIN, method=method, dest=ThetaLimit(), **KW)
    monkeypatch.setattr(integrate, "_CUDA_GRAPHS", False)
    b_final, b = trace_with_history(rays, SPIN, method=method, dest=ThetaLimit(), **KW)
    assert torch.equal(a, b)
    for f in ("r", "steps", "status", "dt"):
        assert torch.equal(getattr(a_final, f), getattr(b_final, f)), f
