"""The emissivity's redshift chains as kernels (``csrc/redshift.cu`` on the
per-ray routines of ``csrc/redshift.cuh``; ``ops/redshift.py``).

``emit_kernel`` is ``redshift_start``; ``emis_weights_kernel`` is what the
app runs between the march and the bins' scatter: the redshift (the
Keplerian orbit's for the plain variant, the FlatDisc 4-velocity's for
rd), the variant's hit test, the bin ids and the four weights. The host
build of ``redshift.cuh`` (g++, no FMA contraction) is held here to the
torch chains on plain-march outputs of the 0.05 grid: masks and ids equal,
energies and weights within a few ulp (the C library's cos, log and pow
are not torch's CPU ones). The app routes a float64 batch on a card with
no derivative to the kernels, anything else to the torch chains; its
spans say which (``rt.redshift.kernel`` / ``rt.redshift.torch``). The
cases marked ``cuda`` hold both kernels bit for bit to the torch chains
on the benchmark's 2,507,316 rays at all eight rows of its table, both
variants, and show that neither variant synchronises between the march's
launch and the columns' copy to the host:
``python -m pytest --noconftest -m cuda tests/test_torch_redshift_kernel.py``.
"""

import ctypes
import functools
import math
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.apps import emissivity, imageplane_disc_image  # noqa: E402
from raytrace_tpu_torch.destinations import FlatDisc  # noqa: E402
from raytrace_tpu_torch.geometry import isco_radius  # noqa: E402
from raytrace_tpu_torch.ops import march_kernel, redshift, trace, trace_auto  # noqa: E402
from raytrace_tpu_torch.ops.reductions import bin_edges, radial_bin_index  # noqa: E402
from raytrace_tpu_torch.ops.redshift import (apply_redshift, apply_redshift_dest,  # noqa: E402
                                             range_phi, redshift_start)
from raytrace_tpu_torch.parallel import pad_rays  # noqa: E402
from raytrace_tpu_torch.rays import RAY_STATUS_HORIZON  # noqa: E402
from raytrace_tpu_torch.sources import ImagePlaneGrid, PointSourceGrid, point_source  # noqa: E402
from raytrace_tpu_torch.utils import profiling  # noqa: E402

R_DISC, N_R, GAMMA = 500.0, 100, 2.0
# the host build against torch's CPU chain: spin x source height
ROWS = [(0.5, 3.0), (0.5, 20.0), (0.998, 3.0), (0.998, 20.0)]
# the benchmark's table (portbench/traffic/emis_table.json)
TABLE = [(s, h) for s in (0.5, 0.998) for h in (3.0, 5.0, 10.0, 20.0)]
# torch's forms of a power with a scalar exponent (csrc/redshift.cuh,
# pow_scalar), then two for the library's pow
POW_FORMS = [0.0, 1.0, 0.5, -0.5, -1.0, 2.0, 3.0, -2.0]
GAMMAS = POW_FORMS + [2.5, -1.5]
# the most the host build's energies and weights may differ from torch's CPU
# chain (3 ulp measured: the C library's cos, log and pow against torch's)
ULPS = 16


def _source(h):
    return (0.0, h, 1e-3, 1.5707)


def _scalars(spin, grid, logbin=True, gamma=GAMMA):
    """``emis_weights_kernel``'s keyword scalars as ``compute`` makes them."""
    r_min = float(isco_radius(spin))
    _, _, dr = bin_edges(r_min, R_DISC, N_R, logbin, device="cpu")
    n_primary = (((grid.cosalphamax - grid.cosalpha0) / grid.dcosalpha)
                 * ((grid.betamax - grid.beta0) / grid.dbeta))
    return dict(r_isco=isco_radius(spin), theta_lim=math.pi / 2, r_min=r_min, dr=dr,
                n_bins=N_R, logbin=logbin, gamma=gamma, n_primary=n_primary)


def torch_chain(out, spin, variant, *, r_isco, theta_lim, r_min, dr, n_bins, logbin, gamma,
                n_primary):
    """The app's torch route before the bins: (ids, hits in a bin, the
    four weight columns)."""
    if variant == "plain":
        out = apply_redshift(range_phi(out), spin, V=-1.0)
        hit = emissivity.disc_hit_mask(out, spin)
    else:
        out = apply_redshift_dest(range_phi(out), spin, FlatDisc(theta_lim))
        hit = out.ok & (out.theta >= theta_lim - 1e-3) & (out.redshift > 0) & (out.r >= r_isco)
    weights = emissivity.emissivity_bin_weights(out, gamma, n_primary)
    ids, in_range = radial_bin_index(out.r, r_min, dr, n_bins, logbin)
    return ids, hit & in_range, [weights[k] for k in emissivity.WEIGHTS]


def _ulps(a, b):
    """The most ``a`` and ``b`` (float64) differ, in units in the last place
    of ``b``; NaN where the other is NaN."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    assert np.array_equal(np.isnan(a), np.isnan(b))
    same = (a == b) | np.isnan(a)
    with np.errstate(invalid="ignore"):
        return float(np.where(same, 0.0, np.abs(a - b) / np.spacing(np.abs(b))).max())


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    view = {torch.float64: torch.int64, torch.int64: torch.int64, torch.bool: torch.uint8}
    return torch.equal(a.contiguous().view(view[a.dtype]), b.contiguous().view(view[b.dtype]))


# ---- the host build (g++) against torch's CPU chain -----------------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the host redshift")
    out = tmp_path_factory.mktemp("redshift_host") / "libredshift_host.so"
    cmd = [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
           "-o", str(out), str(march_kernel.CSRC / "redshift_host.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out))
    c = ctypes
    lib.rt_emit_host.argtypes = [c.c_void_p, c.c_void_p, c.c_int64, c.c_double, c.c_double]
    lib.rt_emis_weights_host.argtypes = march_kernel.emis_weights_argtypes()
    lib.rt_emit_host.restype = lib.rt_emis_weights_host.restype = c.c_int
    return lib


GRID = PointSourceGrid.from_steps(0.05, 0.05)


@functools.lru_cache(maxsize=None)
def _sources(spin, h):
    """The 0.05 grid's 5,040 rays padded with 16 dead ones (steps -1)."""
    return pad_rays(point_source(_source(h), 0.0, spin, GRID, device="cpu"), 64)


@functools.lru_cache(maxsize=None)
def _marched(spin, h):
    """The plain march (RK4 to the disc plane, 1,000 steps) of the emitted
    rays: disc hits, escapes and horizon captures."""
    rays = redshift_start(_sources(spin, h), spin, 0.0)
    return trace(rays, spin, method="rk4", dest=FlatDisc(), steplim=1000)


@pytest.mark.parametrize("V", [0.0, -1.0, 0.01])
@pytest.mark.parametrize("spin,h", ROWS)
def test_host_emit_matches_redshift_start(host_lib, spin, h, V):
    """``emit_one`` ray after ray against ``redshift_start``: the emitted
    energy within ULPS, dead rays included."""
    rays = _sources(spin, h)
    fields, emit, args = redshift.emit_args(rays, spin, V)
    assert host_lib.rt_emit_host(*args) == 0
    want = redshift_start(rays, spin, V).emit
    assert torch.isfinite(want).all()
    assert _ulps(emit, want) <= ULPS


@pytest.mark.parametrize("variant", ["plain", "rd"])
@pytest.mark.parametrize("spin,h", ROWS)
def test_host_weights_match_the_torch_chain(host_lib, spin, h, variant):
    """``emis_weights`` ray after ray against the app's torch route on the
    marched batch: ids and masks equal, the flux, emis and redshift
    weights within ULPS, the times equal; disc hits, horizon captures and
    dead rays among them."""
    out = _marched(spin, h)
    assert (out.steps < 0).any() and ((out.status & RAY_STATUS_HORIZON) != 0).any()
    kw = _scalars(spin, GRID)
    fields, (ids, mask, columns), args = redshift.emis_weights_args(out, spin, variant, **kw)
    assert host_lib.rt_emis_weights_host(*args) == 0
    want_ids, want_mask, want_columns = torch_chain(out, spin, variant, **kw)
    assert mask.sum() > 1000
    assert torch.equal(mask, want_mask) and torch.equal(ids, want_ids)
    for name, got, want in zip(emissivity.WEIGHTS, columns, want_columns):
        assert _ulps(got, want) <= ULPS, name
    assert torch.equal(columns[3], want_columns[3])


@pytest.mark.parametrize("logbin", [True, False])
def test_host_weights_take_torchs_powers_and_both_bins(host_lib, logbin):
    """Every exponent form of ``pow_scalar`` (0, 1, 0.5, -0.5, -1, 2, 3, -2
    and the library's pow) and both bin spacings, on one row."""
    out = _marched(0.998, 3.0)
    for gamma in GAMMAS:
        kw = _scalars(0.998, GRID, logbin=logbin, gamma=gamma)
        fields, (ids, mask, columns), args = redshift.emis_weights_args(out, 0.998, "rd", **kw)
        assert host_lib.rt_emis_weights_host(*args) == 0
        want_ids, want_mask, want_columns = torch_chain(out, 0.998, "rd", **kw)
        assert torch.equal(mask, want_mask) and torch.equal(ids, want_ids)
        assert _ulps(columns[1], want_columns[1]) <= ULPS, gamma


# ---- routes -----------------------------------------------------------------

def _route_spans(rec):
    names = [s[0] for s in rec.spans]
    return [[s[0] for s in rec.spans if s[1] == i]
            for i, name in enumerate(names) if name == "rt.redshift"]


@pytest.mark.parametrize("variant", ["plain", "rd"])
def test_cpu_batches_take_the_torch_chains(variant):
    """On the CPU ``kernel_takes`` nothing: both of the emissivity's
    chains run in ``rt.redshift.torch`` and nothing is launched."""
    rays = _sources(0.998, 3.0)
    assert not redshift.kernel_takes(rays, 0.998, 0.0)
    before = redshift.launches
    profiling.start()
    try:
        out = emissivity.compute(0.998, _source(5.0), grid=PointSourceGrid.from_steps(0.2, 0.5),
                                 r_max=500.0, r_disc=100.0, n_r=20, steplim=3000,
                                 method="rk45" if variant == "plain" else "rk4",
                                 variant=variant, device="cpu")
    finally:
        rec = profiling.stop()
    assert out["rays"].sum() > 0
    assert _route_spans(rec) == [["rt.redshift.torch"]] * 2
    assert redshift.launches == before


@pytest.mark.parametrize("variant", ["plain", "rd"])
def test_chip_smoke_keeps_the_kernel_routes_inputs(monkeypatch, variant):
    """On the kernels' route, with the two kernels stood in for by the torch
    chains on the CPU, ``chip_smoke``'s ``redshift_inputs`` and
    ``scatter_inputs`` see the app's calls: emit, then weights, then one
    ``masked_bins`` on the weights' columns."""
    import sys
    from pathlib import Path

    from raytrace_tpu_torch.ops import reductions

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    monkeypatch.setattr(redshift, "kernel_takes", lambda *a: True)
    monkeypatch.setattr(redshift, "emit_kernel", lambda rays, spin, V: redshift_start(rays, spin, V))
    monkeypatch.setattr(redshift, "emis_weights_kernel",
                        lambda out, spin, variant, **kw: torch_chain(out, spin, variant, **kw))
    with chip_smoke.scatter_inputs(reductions) as seen, \
            chip_smoke.redshift_inputs(redshift) as calls:
        out = emissivity.compute(0.998, _source(5.0), grid=PointSourceGrid.from_steps(0.2, 0.5),
                                 r_max=500.0, r_disc=100.0, n_r=20, steplim=3000,
                                 method="rk45" if variant == "plain" else "rk4",
                                 variant=variant, device="cpu")
    assert [c[0] for c in calls] == ["emit", "weights"] and calls[1][3] == variant
    assert len(seen) == 1 and seen[0][3] == 20 and len(seen[0][0]) == 4
    assert out["rays"].sum() > 0


# ---- on the card ----------------------------------------------------------------

BENCH_GRID = PointSourceGrid.from_steps(0.005, 0.001)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _check_bitwise(got, want, what):
    ids, mask, columns = got
    want_ids, want_mask, want_columns = want
    assert _same_bits(mask, want_mask), f"{what}: {int((mask != want_mask).sum())} masks differ"
    assert _same_bits(ids, want_ids), f"{what}: {int((ids != want_ids).sum())} ids differ"
    for name, a, b in zip(emissivity.WEIGHTS, columns, want_columns):
        assert _same_bits(a, b), f"{what}: {name} differs, {_ulps(a, b)} ulp at most"


@pytest.mark.cuda
@pytest.mark.parametrize("spin,h", TABLE)
def test_kernels_match_the_torch_chains_bitwise_on_cuda(spin, h):
    """One row of the benchmark's table, 2,507,316 rays: ``emit_kernel``
    bit for bit ``redshift_start``; the plain variant's march (float32
    RK45 kernel) and the rd one's (RK4 to FlatDisc, 30,000 steps) through
    ``emis_weights_kernel`` bit for bit the torch chain: ids, masks and
    the four weights, every ray. One launch each."""
    _need_card()
    rays = point_source(_source(h), 0.0, spin, BENCH_GRID, device="cuda")
    assert rays.n_rays == 2_507_316
    before = redshift.launches
    start = redshift.emit_kernel(rays, spin, 0.0)
    assert redshift.launches == before + 1
    want = redshift_start(rays, spin, 0.0)
    assert _same_bits(start.emit, want.emit), f"emit: {_ulps(start.emit, want.emit)} ulp at most"
    kw = _scalars(spin, BENCH_GRID)
    for variant, march in (("plain", dict(method="rk45")),
                           ("rd", dict(method="rk4", dest=FlatDisc(), steplim=30000))):
        out = trace_auto(want, spin, **march)
        got = redshift.emis_weights_kernel(out, spin, variant, **kw)
        _check_bitwise(got, torch_chain(out, spin, variant, **kw), f"{variant} ({spin}, {h})")
        assert got[1].sum() > 100_000
    assert redshift.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("logbin", [True, False])
def test_kernel_takes_torchs_powers_and_both_bins_on_cuda(logbin):
    """Every exponent form of ``pow_scalar`` and both bin spacings, bit for
    bit the torch chain on the card (spin 0.998, h 3, both variants); an
    exponent torch's pow has no form for (2.5, -1.5) takes the library's
    pow, which misses torch's, built with FMA contraction, by an ulp or
    two: that emis column within ULPS, every other bit for bit."""
    _need_card()
    rays = redshift_start(point_source(_source(3.0), 0.0, 0.998, BENCH_GRID, device="cuda"),
                          0.998, 0.0)
    out = trace_auto(rays, 0.998, method="rk4", dest=FlatDisc(), steplim=30000)
    for gamma in GAMMAS:
        kw = _scalars(0.998, BENCH_GRID, logbin=logbin, gamma=gamma)
        for variant in ("plain", "rd"):
            what = f"{variant} gamma {gamma}"
            got = redshift.emis_weights_kernel(out, 0.998, variant, **kw)
            want = torch_chain(out, 0.998, variant, **kw)
            if gamma in POW_FORMS:
                _check_bitwise(got, want, what)
                continue
            emis, want_emis = got[2][1], want[2][1]
            got[2][1], want[2][1] = want_emis, want_emis
            _check_bitwise(got, want, what)
            assert _ulps(emis, want_emis) <= ULPS, what


def _bench_compute(variant, **kw):
    rd = variant == "rd"
    return emissivity.compute(0.998, _source(5.0), grid=BENCH_GRID, method="rk4" if rd else "rk45",
                              steplim=30000 if rd else None, variant=variant, device="cuda", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["plain", "rd"])
def test_compute_columns_are_the_torch_routes_on_cuda(monkeypatch, variant):
    """The benchmark's job (spin 0.998, h 5) through the kernels (two
    launches, each in ``rt.redshift.kernel``) gives the torch route's
    columns bit for bit."""
    _need_card()
    before = redshift.launches
    profiling.start()
    try:
        out = _bench_compute(variant)
    finally:
        rec = profiling.stop()
    assert redshift.launches == before + 2
    assert _route_spans(rec) == [["rt.redshift.kernel"]] * 2
    with monkeypatch.context() as mp:
        mp.setattr(redshift, "kernel_takes", lambda *a: False)
        ref = _bench_compute(variant)
    assert redshift.launches == before + 2
    assert out["rays"].sum() > 100_000
    for c in ("rays", "flux", "emis", "redshift", "time"):
        assert np.array_equal(out[c], ref[c], equal_nan=True), c


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["plain", "rd"])
def test_no_sync_between_the_march_and_the_columns_on_cuda(monkeypatch, variant):
    """From the march kernel's launch to the columns' copy to the host
    (``rt.to_host``) neither variant synchronises: under
    ``set_sync_debug_mode("error")`` a synchronising call would raise."""
    _need_card()
    launch, columns = march_kernel._launch, emissivity._columns
    seen = []

    def launch_then_watch(*a, **k):
        launch(*a, **k)
        torch.cuda.set_sync_debug_mode("error")
        seen.append("launch")

    def stop_watching(*a, **k):
        torch.cuda.set_sync_debug_mode(0)
        seen.append("columns")
        return columns(*a, **k)

    monkeypatch.setattr(march_kernel, "_launch", launch_then_watch)
    monkeypatch.setattr(emissivity, "_columns", stop_watching)
    try:
        out = _bench_compute(variant)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert seen == ["launch", "columns"] and out["rays"].sum() > 100_000


@pytest.mark.cuda
def test_other_batches_take_the_torch_chains_on_cuda():
    """On the card, a batch that carries a derivative and a spin that
    carries one take torch's chain (``rt.redshift.torch``, no launch); so
    does every redshift of the disc image, which is not the emissivity's."""
    _need_card()
    rays = point_source(_source(5.0), 0.0, 0.998, GRID, device="cuda")
    assert redshift.kernel_takes(rays, 0.998, 0.0)
    dual = rays.replace(k=rays.k.clone().requires_grad_())
    spin = torch.tensor(0.998, dtype=torch.float64, device="cuda", requires_grad=True)
    before = redshift.launches
    profiling.start()
    try:
        emissivity.start_redshift(dual, 0.998, 0.0)
        emissivity.start_redshift(rays, spin, 0.0)
        grid = ImagePlaneGrid.from_steps(-15.0, 15.0, 1.5, -15.0, 15.0, 1.5)
        imageplane_disc_image.compute(0.998, 1e4, 60.0, grid, r_disc=15.0, img_nx=20,
                                      img_ny=20, variant="isco", steplim=30000, device="cuda")
    finally:
        rec = profiling.stop()
    assert redshift.launches == before
    routes = _route_spans(rec)
    assert routes[:2] == [["rt.redshift.torch"]] * 2 and all(r == [] for r in routes[2:])
    assert len(routes) > 2


@pytest.mark.cuda
def test_kernels_refuse_float32_and_tensor_scalars_on_cuda():
    """On the card the kernels take a float64 batch and Python numbers
    alone: a float32 batch or a tensor scalar that carries no derivative
    raises, and nothing is launched."""
    _need_card()
    rays = point_source(_source(5.0), 0.0, 0.998, GRID, device="cuda")
    spin = torch.tensor(0.998, dtype=torch.float64, device="cuda")
    before = redshift.launches
    with pytest.raises(ValueError, match="float64"):
        emissivity.start_redshift(rays.to(dtype=torch.float32), 0.998, 0.0)
    with pytest.raises(TypeError, match="Python numbers"):
        emissivity.start_redshift(rays, spin, 0.0)
    out = redshift.emit_kernel(rays, 0.998, 0.0)
    with pytest.raises(TypeError, match="Python numbers"):
        emissivity.disc_bins(out, 0.998, "plain", r_min=spin, dr=1.1, n_r=10, logbin_r=True,
                             gamma=2.0, n_primary=1.0)
    assert redshift.launches == before + 1
