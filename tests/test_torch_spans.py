"""The port's span and launch-counter recorder (``utils.profiling``).

Off, a span is the shared no-op context and a launch passes no counter.
On, a CPU run of each benchmarked app's ``compute`` (the plain march)
records the layer spans with their parents, nested, on the
``time.time_ns`` clock. The march's lane-iteration counter is held on the
host build of the kernel (``csrc/march_host.cpp``, g++) against the plain
march: every RK4 iteration is a step, so the count is the steps the rays
took; an RK45 count is the DOPRI5 trials, accepted or rejected
(``ops/diagnostics.py::_march_with_trials``). A null counter leaves every
marched field bitwise as it was. The card's own counts are the tests
marked ``cuda``.
"""

import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_march_host import _build_host_lib, _dest, _take  # noqa: E402

from raytrace_tpu_torch.apps import emissivity, imageplane_disc_image  # noqa: E402
from raytrace_tpu_torch.destinations import ThetaLimit  # noqa: E402
from raytrace_tpu_torch.ops import march_kernel, trace  # noqa: E402
from raytrace_tpu_torch.ops.diagnostics import _march_with_trials  # noqa: E402
from raytrace_tpu_torch.ops.integrate import StepControl  # noqa: E402
from raytrace_tpu_torch.sources import ImagePlaneGrid, PointSourceGrid, image_plane  # noqa: E402
from raytrace_tpu_torch.sources import point_source  # noqa: E402
from raytrace_tpu_torch.utils import profiling  # noqa: E402
from raytrace_tpu_torch.utils import profile_trace  # noqa: E402

SPIN = 0.998
SPIN32 = float(np.float32(SPIN))
SOURCE = (0.0, 5.0, 1e-3, 1.5707)
FIELDS = march_kernel.F_FIELDS + march_kernel.I_FIELDS + march_kernel.B_FIELDS


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build_host_lib(march_kernel.CSRC, tmp_path_factory.mktemp("spans_host"))


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off."""
    assert not profiling.recording()
    yield
    if profiling.recording():
        profiling.stop()


def test_recorder_off_records_nothing():
    """Off (the default): every span is the one shared no-op context, a
    launch gets no counter, and there is nothing to stop."""
    a, b = profiling.span("rt.compute"), profiling.span("rt.march")
    assert a is b is profiling._OFF
    with a:
        with b:
            pass
    assert profiling.launch_slot(torch.device("cpu")) is None
    with pytest.raises(RuntimeError, match="not on"):
        profiling.stop()
    profiling.start()
    with pytest.raises(RuntimeError, match="already on"):
        profiling.start()
    assert profiling.stop() == profiling.Recording(spans=[], launches=[], uncounted=0)
    assert profiling.span("rt.compute") is profiling._OFF


def test_launch_slots_count_until_the_table_is_full(monkeypatch):
    """Each launch takes the next slot of the table, under the span it was
    taken in; past the table, or on another device than the table's, a
    launch gets no counter and is reported as uncounted."""
    monkeypatch.setattr(profiling, "SLOTS", 2)
    profiling.start(device="cpu")
    base = profiling._rec.table.data_ptr()
    with profiling.span("rt.march.launch"):
        assert profiling.launch_slot(torch.device("cpu")) == base
    with profiling.span("rt.march.launch"):
        assert profiling.launch_slot(torch.device("cpu")) == base + 8
        profiling._rec.table[:2] = torch.tensor([7, 11])
    assert profiling.launch_slot(torch.device("cpu")) is None
    assert profiling.launch_slot(torch.device("meta")) is None
    rec = profiling.stop()
    assert rec.launches == [(0, 7), (1, 11)] and rec.uncounted == 2


def _emissivity(variant):
    grid = PointSourceGrid.from_steps(0.2, 0.5)
    return emissivity.compute(SPIN, SOURCE, grid=grid, r_max=500.0, r_disc=100.0, n_r=20,
                              method="rk45" if variant == "plain" else "rk4", steplim=3000,
                              variant=variant, device="cpu")


def _image():
    grid = ImagePlaneGrid.from_steps(-10.0, 10.0, 2.5, -10.0, 10.0, 2.5)
    return imageplane_disc_image.compute(SPIN, 500.0, 60.0, grid, r_disc=10.0, variant="isco",
                                         steplim=3000, device="cpu")


# each run's spans under rt.compute, in the order they open
CHILDREN = {
    "emissivity plain": ["rt.source", "rt.redshift", "rt.march", "rt.redshift", "rt.bins",
                         "rt.areas", "rt.to_host"],
    "emissivity rd": ["rt.source", "rt.redshift", "rt.march", "rt.redshift", "rt.bins",
                      "rt.areas", "rt.to_host"],
    "image isco": ["rt.source", "rt.redshift", "rt.march", "rt.redshift", "rt.bins",
                   "rt.to_host"],
}


@pytest.mark.parametrize("run", list(CHILDREN))
def test_compute_records_the_layer_spans(run):
    """A CPU run of ``compute`` records one ``rt.compute`` root and, under
    it, the layers' spans in the order they run, under ``rt.bins`` its
    scatter's route span (``rt.bins.index_add`` on the CPU); every span
    lies inside its parent, stamped on the ``time.time_ns`` clock, and the
    plain march launches nothing."""
    profiling.start()
    t0 = time.time_ns()
    out = _image() if run == "image isco" else _emissivity(run.split()[1])
    t1 = time.time_ns()
    rec = profiling.stop()
    assert out["counts" if run == "image isco" else "rays"].sum() > 0
    assert rec.launches == [] and rec.uncounted == 0
    names = [s[0] for s in rec.spans]
    assert all(n.startswith("rt.") for n in names)
    assert names[0] == "rt.compute" and rec.spans[0][1] == -1
    assert [s[0] for s in rec.spans if s[1] == 0] == CHILDREN[run]
    # the bins' one scatter takes index_add_ on the CPU, in its route span
    bins = names.index("rt.bins")
    assert [s[0] for s in rec.spans if s[1] == bins] == ["rt.bins.index_add"]
    # the plain march opens no span of the kernel's
    assert len(rec.spans) == 2 + len(CHILDREN[run])
    for name, parent, s, e in rec.spans:
        assert t0 <= s <= e <= t1
        if parent >= 0:
            assert rec.spans[parent][2] <= s and e <= rec.spans[parent][3]


def test_profile_trace_writes_spans_beside_the_trace(tmp_path, capsys):
    """With a logdir, ``profile_trace`` records the port's spans over the
    section and writes them into ``spans.json``, a Chrome trace on the
    time axis of ``trace.json`` (its ``baseTimeNanoseconds``), with each
    span's parent; the recorder is off again afterwards."""
    t0 = time.time_ns()
    with profile_trace(str(tmp_path), label="spans"):
        _emissivity("rd")
    t1 = time.time_ns()
    trace_json = json.loads((tmp_path / "trace.json").read_text())
    spans = json.loads((tmp_path / "spans.json").read_text())
    base = trace_json["baseTimeNanoseconds"]
    assert spans["baseTimeNanoseconds"] == base and spans["uncounted_launches"] == 0
    events = spans["traceEvents"]
    assert events[0]["name"] == "rt.compute" and events[0]["args"]["parent"] == -1
    assert [e["name"] for e in events if e["args"]["parent"] == 0] == CHILDREN["emissivity rd"]
    for e in events:
        assert (t0 - base) / 1e3 <= e["ts"] <= e["ts"] + e["dur"] <= (t1 - base) / 1e3
    assert not profiling.recording()
    assert "[profile] spans:" in capsys.readouterr().out


def test_profile_trace_leaves_a_running_recorder_alone(tmp_path, capsys):
    """Under a recorder that is on already, ``profile_trace`` writes its
    trace but no spans: the spans stay with the recorder that holds them."""
    profiling.start()
    with profile_trace(str(tmp_path), label="nested"):
        with profiling.span("rt.compute"):
            pass
    rec = profiling.stop()
    assert [s[0] for s in rec.spans] == ["rt.compute"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["trace.json"]
    capsys.readouterr()


def _host_march(lib, rays, spin, method, dest, *, steplim, r_max=1000.0, max_iters=None,
                warps=0, count=True):
    """The host build's march of the float32 batch ``rays`` as trace_kernel
    prepares it: the 21 marched buffers and the lane iterations it counted
    (None with ``count`` off: a null slot)."""
    _, _, buf, scalars = march_kernel.prepare(
        rays, spin, method=method, dest=dest, r_max=r_max, steplim=steplim, ctrl=StepControl(),
        boundary=None, march_dtype=torch.float32)
    if max_iters is not None:
        scalars[march_kernel._MAX_ITERS] = max_iters
    slot = torch.zeros(1, dtype=torch.int64)
    ptr = slot.data_ptr() if count else None
    assert lib.rt_march_host(*march_kernel.pointers(buf), *scalars, warps, ptr) == 0
    return buf, (int(slot) if count else None)


def _lamppost32():
    return point_source(SOURCE, 0.0, SPIN32, PointSourceGrid.from_steps(0.1, 0.2), device="cpu",
                        dtype=torch.float32)


def _bits_equal(a, b):
    a, b = a.numpy(), b.numpy()
    return (a.view(np.uint8).reshape(len(a), -1) == b.view(np.uint8).reshape(len(b), -1)).all(1)


def test_host_count_is_the_rk45_trials(host_lib):
    """RK45 towards ThetaLimit in float32 (630 lamppost rays): the count
    is the DOPRI5 trials of the plain march, summed over the lanes. The
    host build's libm parts some rays' step sequences from the plain
    march's, so the count is held on the rays whose 21 fields the two
    marches give bit for bit, re-marched as a batch of their own; there the
    trials also exceed the accepted steps (rejected trials count)."""
    rays, n = _lamppost32(), 4000
    buf, _ = _host_march(host_lib, rays, SPIN32, "rk45", ThetaLimit(), steplim=n + 1,
                         max_iters=n)
    final, trials = _march_with_trials(rays, SPIN32, 1000.0, n, StepControl())
    same = torch.ones(rays.n_rays, dtype=torch.bool)
    for f in FIELDS:
        same &= torch.from_numpy(_bits_equal(buf[f], getattr(final, f).to(buf[f].dtype)))
    assert int(same.sum()) > rays.n_rays // 2
    idx = torch.nonzero(same).squeeze(1)
    _, count = _host_march(host_lib, _take(rays, idx), SPIN32, "rk45", ThetaLimit(),
                           steplim=n + 1, max_iters=n)
    assert count == int(trials[idx].sum())
    assert count > int(final.steps[idx].abs().sum() - rays.steps[idx].abs().sum())


@pytest.mark.parametrize("kind", ["theta", "isco"])
def test_host_count_is_the_rk4_steps(host_lib, kind):
    """RK4, where every iteration is a step (a theta flip included), in
    float32: the count is the steps the plain march's rays took, towards
    ThetaLimit (630 lamppost rays) and DiscWithISCO (441 image-plane
    rays, marched with the spin negated)."""
    if kind == "theta":
        rays, spin, dest, r_max = _lamppost32(), SPIN32, ThetaLimit(), 1000.0
    else:
        grid = ImagePlaneGrid.from_steps(-10.0, 10.0, 1.0, -10.0, 10.0, 1.0)
        rays = image_plane(500.0, 60.0, grid, SPIN, device="cpu", dtype=torch.float32)
        spin, dest, r_max = -SPIN32, _dest("isco"), 550.0
    buf, count = _host_march(host_lib, rays, spin, "rk4", dest, steplim=3000, r_max=r_max)
    plain = trace(rays, spin, method="rk4", steplim=3000, dest=dest, r_max=r_max)
    took = plain.steps.abs().sum() - rays.steps.abs().sum()
    assert count == int(took) > rays.n_rays
    assert count == int(buf["steps"].abs().sum() - rays.steps.abs().sum())


@pytest.mark.parametrize("warps", [0, 3])
@pytest.mark.parametrize("method", ["rk4", "rk45"])
def test_null_counter_leaves_the_march_bitwise(host_lib, method, warps):
    """With a counter or a null one, ray after ray or under the emulated
    refill schedule (3 warps), the host build gives all 21 fields bit for
    bit alike, and both schedules count the same iterations."""
    rays = _lamppost32()
    counted, count = _host_march(host_lib, rays, SPIN32, method, ThetaLimit(), steplim=3000,
                                 warps=warps)
    plain, none = _host_march(host_lib, rays, SPIN32, method, ThetaLimit(), steplim=3000,
                              warps=warps, count=False)
    assert none is None
    for f in FIELDS:
        assert _bits_equal(counted[f], plain[f]).all(), f
    _, per_ray = _host_march(host_lib, rays, SPIN32, method, ThetaLimit(), steplim=3000)
    assert count == per_ray > rays.n_rays


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the march kernel has no CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["rk4", "rk45"])
def test_kernel_counts_its_lane_iterations_on_cuda(method):
    """On the card, with the recorder on, a launch takes one slot under its
    ``rt.march.launch`` span and counts the iterations of the plain march
    (RK4: its steps; RK45: its DOPRI5 trials, the float32 kernel being
    bitwise the plain march); with it off the kernel gives the same bits."""
    _need_card()
    rays = point_source(SOURCE, 0.0, SPIN32, PointSourceGrid.from_steps(0.05, 0.05),
                        device="cuda", dtype=torch.float32)
    n = 4000  # iterations a ray; no ray reaches the step limit
    kw = dict(method=method, steplim=n + 1, max_iters=n, march_dtype=torch.float32)
    off = march_kernel.trace_kernel(rays, SPIN32, **kw)
    profiling.start()
    on = march_kernel.trace_kernel(rays, SPIN32, **kw)
    rec = profiling.stop()
    assert rec.uncounted == 0 and len(rec.launches) == 1
    span, count = rec.launches[0]
    assert [s[0] for s in rec.spans] == ["rt.march.prepare", "rt.march.launch",
                                         "rt.march.finish"]
    assert rec.spans[span][0] == "rt.march.launch"
    for f in FIELDS:
        assert _bits_equal(getattr(on, f).cpu(), getattr(off, f).cpu()).all(), f
    if method == "rk4":
        want = int(on.steps.abs().sum() - rays.steps.abs().sum())
    else:
        final, trials = _march_with_trials(rays, SPIN32, 1000.0, n, StepControl())
        assert torch.equal(final.steps, on.steps)
        want = int(trials.sum())
    assert count == want


@pytest.mark.cuda
def test_refill_kernel_counts_as_the_grid_launch_on_cuda():
    """The float64 RK45 DiscWithISCO kernel counts the same lane iterations
    under the refill schedule as under the grid launch, launch after
    launch, each in a slot of its own."""
    _need_card()
    rays = point_source(SOURCE, 0.0, SPIN, PointSourceGrid.from_steps(0.02, 0.02), device="cuda")
    kw = dict(dest=_dest("isco"), method="rk45", steplim=3000, march_dtype=torch.float64,
              refine_crossing=False, ctrl=StepControl(), boundary=None, r_max=1000.0)
    profiling.start()
    for schedule in ("grid", "refill", "refill"):
        march_kernel._trace(rays, SPIN, schedule, **kw)
    rec = profiling.stop()
    counts = [c for _, c in rec.launches]
    assert len(counts) == 3 and counts[0] == counts[1] == counts[2] > rays.n_rays


def test_span_window_report_on_a_hand_built_window():
    """``span_window.report``: on a window of two jobs with the program's
    spans beside the harness's, the idle time inside ``rt.compute``, the
    gaps labelled by the innermost span (a gap inside ``rt.areas`` as
    ``rt.areas``), the host time of ``rt.source``, each row's lane
    iterations and the march's device time over them."""
    import span_window
    from portbench import harness

    march = "void march_kernel<float, 2, 0>(rt::Params<float>)"
    events = [(march, "kernel", 0.0, 0.002), (march, "kernel", 0.1, 0.3),
              ("elementwise", "kernel", 0.35, 0.4), (march, "kernel", 0.6, 0.8)]
    spans = [("job:0", 0.0, 0.5), ("source", 0.3, 0.36), ("job:1", 0.5, 1.0)]
    program = [("rt.compute", -1, 0.001, 0.49), ("rt.areas", 0, 0.002, 0.098),
               ("rt.source", 0, 0.31, 0.35), ("rt.march.launch", 0, 0.099, 0.1),
               ("rt.compute", -1, 0.501, 0.99), ("rt.march.launch", 4, 0.55, 0.56)]
    window = harness.Window(events, spans, 2, 1.0)
    out = span_window.report(window, program, [(3, 100), (5, 300)], 1)
    # idle: [0.002, 0.1), [0.3, 0.35), [0.4, 0.6), [0.8, 1.0)
    assert out["idle_share"] == pytest.approx(0.548)
    within = 0.098 + 0.05 + 0.09 + 0.099 + 0.19
    assert out["compute_idle_ms"] == pytest.approx(1e3 * within / 2)
    assert out["compute_idle_share"] == pytest.approx(within / 0.548)
    assert out["idle_by_span"]["rt.areas"] == pytest.approx(1e3 * 0.096 / 2)
    assert out["idle_by_span"]["rt.source"] == pytest.approx(1e3 * 0.04 / 2)
    assert out["idle_by_span"]["source"] == pytest.approx(1e3 * 0.01 / 2)
    assert out["idle_by_span"]["job:1"] == pytest.approx(1e3 * 0.011 / 2)
    # the longest gaps first, each by the innermost span at its middle
    labels = [g[0] for g in out["breakdown"]["idle_gaps"]]
    assert labels == ["job:1", "rt.compute", "rt.areas", "rt.source"]
    assert out["source_host_ms"] == pytest.approx(20.0)
    assert out["iters_by_row"] == {"job:0": [100], "job:1": [300]}
    assert out["march_iters_per_job"] == 200
    assert out["march_ns_per_iter"] == pytest.approx(1e9 * 0.402 / 400)
    assert (out["launches_counted"], out["launches_uncounted"]) == (2, 1)


def test_span_window_maps_hidden_on_a_hand_built_window():
    """``span_window.maps_hidden``: of two jobs, one maps both its ranges
    before its last march kernel ends and one maps a range across that
    end; each job's last ``rt.maps`` is the pass over the whole map. The
    hidden share is the ``rt.maps`` time before each job's last march
    kernel ended over all its ``rt.maps`` time; the late ranges, those
    whose maps end after it."""
    import span_window
    from portbench import harness

    march = "void march_kernel<double, 2, 2>(rt::Params<double>)"
    events = [(march, "kernel", 0.0, 0.1), (march, "kernel", 0.05, 0.6),
              ("Memcpy DtoH (Device -> Pinned)", "memcpy", 0.15, 0.16),
              (march, "kernel", 1.0, 1.1), (march, "kernel", 1.05, 1.5)]
    spans = [("job:0", 0.0, 1.0), ("job:1", 1.0, 2.0)]
    program = [("rt.compute", -1, 0.0, 0.7), ("rt.maps", 0, 0.2, 0.3),
               ("rt.maps", 0, 0.35, 0.45), ("rt.maps", 0, 0.62, 0.65),
               ("rt.compute", -1, 1.0, 1.7), ("rt.maps", 4, 1.2, 1.3),
               ("rt.maps", 4, 1.45, 1.55), ("rt.maps", 4, 1.56, 1.6)]
    window = harness.Window(events, spans, 2, 2.0)
    out = span_window.report(window, program, [], 0)
    assert out["maps_hidden_share"] == pytest.approx((0.2 + 0.15) / (0.23 + 0.24))
    assert out["maps_hidden_by_row"] == {"job:0": pytest.approx(0.2 / 0.23),
                                         "job:1": pytest.approx(0.15 / 0.24)}
    assert out["late_ranges_per_job"] == 0.5
    assert out["late_ranges_by_row"] == {"job:0": [0], "job:1": [1]}
    # a single-batch job: its one rt.maps, after the march, is its one late range
    single = span_window.maps_hidden(
        harness.Window(events[:2], spans[:1], 1, 1.0), [("rt.maps", -1, 0.61, 0.8)])
    assert single["maps_hidden_share"] == 0.0 and single["late_ranges_per_job"] == 1


def test_span_window_bins_kernel_share_on_a_hand_built_window():
    """``span_window.bins_kernel``: the scatters that took the kernel
    (``rt.bins.kernel``) over all the window's scatters (and
    ``rt.bins.index_add``), overall and by the row of the ``job:<i>`` span
    each started in; a scatter outside every job counts only overall, and
    a window without a scatter reads None."""
    import span_window
    from portbench import harness

    spans = [("job:0", 0.0, 1.0), ("job:1", 1.0, 2.0), ("job:0", 2.0, 3.0)]
    program = [("rt.compute", -1, 0.0, 0.9), ("rt.bins", 0, 0.5, 0.6),
               ("rt.bins.kernel", 1, 0.51, 0.52), ("rt.compute", -1, 1.0, 1.9),
               ("rt.bins.index_add", 3, 1.5, 1.6), ("rt.bins.kernel", -1, 2.5, 2.6),
               ("rt.bins.kernel", -1, 3.5, 3.6)]
    window = harness.Window([], spans, 3, 4.0)
    out = span_window.report(window, program, [], 0)
    assert out["bins_kernel_share"] == 0.75
    assert out["bins_kernel_by_row"] == {"job:0": 1.0, "job:1": 0.0}
    none = span_window.bins_kernel(window, program[:2])
    assert none == {"bins_kernel_share": None, "bins_kernel_by_row": {}}
