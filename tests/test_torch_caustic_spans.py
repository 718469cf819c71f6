"""The caustic app's spans (``apps.caustics.compute``, ``utils.profiling``).

A CPU run of ``compute(target="plane")`` with the recorder on records one
``rt.compute`` root and, under it, the camera (``rt.source``), the start
redshift (``rt.redshift``), the march (``rt.march``), then for its one
piece the fields' copies to the host (``rt.to_host``) and the per-pixel
maps (``rt.maps``), and last the passes over the whole map (``rt.maps``),
in that order.
The spans change no output: the maps with the recorder on, off, and with
the app's spans taken out are bitwise one another.
"""

import contextlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.apps import caustics  # noqa: E402
from raytrace_tpu_torch.sources import ImagePlaneGrid  # noqa: E402
from raytrace_tpu_torch.utils import profiling  # noqa: E402

CHILDREN = ["rt.source", "rt.redshift", "rt.march", "rt.to_host", "rt.maps", "rt.maps"]


def _plane():
    grid = ImagePlaneGrid.from_steps(-12.0, 12.0, 6.0, -12.0, 12.0, 6.0)
    return caustics.compute(0.998, 500.0, 80.0, grid, target="plane", z_s=500.0, r_lim=2000.0,
                            steplim=3000, device="cpu")


def _assert_same_maps(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_plane_compute_records_its_spans_and_changes_nothing(monkeypatch):
    assert not profiling.recording()
    profiling.start()
    try:
        t0 = time.time_ns()
        recorded = _plane()
        t1 = time.time_ns()
    finally:
        rec = profiling.stop()
    assert recorded["hit"].sum() > 0
    assert rec.launches == [] and rec.uncounted == 0
    names = [s[0] for s in rec.spans]
    assert names[0] == "rt.compute" and rec.spans[0][1] == -1
    assert [s[0] for s in rec.spans if s[1] == 0] == CHILDREN
    assert len(rec.spans) == 1 + len(CHILDREN)
    for name, parent, s, e in rec.spans:
        assert t0 <= s <= e <= t1
        if parent >= 0:
            assert rec.spans[parent][2] <= s and e <= rec.spans[parent][3]

    off = _plane()
    monkeypatch.setattr(caustics, "span", lambda name: contextlib.nullcontext())
    removed = _plane()
    _assert_same_maps(off, removed)
    _assert_same_maps(recorded, removed)
