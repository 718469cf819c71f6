"""Timing, profiler traces, and the port's own spans and launch counters.

Counterpart of ``raytrace_tpu/utils/profiling.py``: ``torch.profiler``
takes the place of ``jax.profiler.trace``. The trace is a Chrome trace
(open it in Perfetto or ``chrome://tracing``), with the card's kernels,
copies and their times beside the host's operations when a card is in use.

The recorder (``start``, ``span``, ``stop``) keeps what the host was doing
at the port's layer boundaries: named spans (``rt.compute``, ``rt.source``,
``rt.march.launch`` ...), stamped with ``time.time_ns()``, the clock whose
values the profiler's device timestamps share, and for each march launch
the lane iterations its kernel counted. It is off by default; off, a span
is one flag test and a shared no-op context, and a launch passes the
kernel no counter. On, it adds no device operation, allocation or
synchronisation inside the section: the counters' table is allocated and
zeroed in ``start`` and read once in ``stop``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import time

import torch

# Launches a recorder window can count; later ones are reported as uncounted.
SLOTS = 1 << 16

_OFF = contextlib.nullcontext()
_rec = None  # the recorder while one is on


@dataclasses.dataclass
class Recording:
    """What a recorder window kept. ``spans``: (name, index of the
    enclosing span or -1, start ns, end ns) on the ``time.time_ns`` clock,
    in the order they opened. ``launches``: (index of the launch's
    ``rt.march.launch`` span, the lane iterations its kernel counted: every
    trial, accepted or rejected, of every ray), one a counted launch.
    ``uncounted``: launches whose iterations were not counted (past the
    table's ``SLOTS``, or on another device than the table's)."""

    spans: list
    launches: list
    uncounted: int


class _Recorder:
    def __init__(self, device):
        self.spans, self.stack, self.slots, self.uncounted = [], [], [], 0
        self.table = None if device is None else torch.zeros(SLOTS, dtype=torch.int64,
                                                             device=device)

    def slot(self, device):
        table = self.table
        if table is None or table.device != device or len(self.slots) == SLOTS:
            self.uncounted += 1
            return None
        self.slots.append(self.stack[-1] if self.stack else -1)
        return table.data_ptr() + 8 * (len(self.slots) - 1)


class _Span:
    __slots__ = ("rec", "name", "index")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.index = len(rec.spans)
        rec.spans.append([self.name, rec.stack[-1] if rec.stack else -1, time.time_ns(), 0])
        rec.stack.append(self.index)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.spans[self.index][3] = time.time_ns()
        rec.stack.pop()
        return False


def span(name: str):
    """A context that records the section as the span ``name`` while the
    recorder is on, and the shared no-op context while it is off. Host
    time: it never waits for the card."""
    rec = _rec
    return _OFF if rec is None else _Span(rec, name)


def recording() -> bool:
    return _rec is not None


def start(device=None) -> None:
    """Turn the recorder on. The launch counters' table is allocated and
    zeroed on ``device``: by default the current CUDA device where a card
    is visible, else none (no launch is counted)."""
    global _rec
    if _rec is not None:
        raise RuntimeError("the recorder is already on")
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    _rec = _Recorder(device)


def stop() -> Recording:
    """Turn the recorder off and return what it kept; reads the counters'
    table once, after the launches it counts (the current stream's)."""
    global _rec
    rec, _rec = _rec, None
    if rec is None:
        raise RuntimeError("the recorder is not on")
    counts = rec.table[:len(rec.slots)].tolist() if rec.slots else []
    return Recording(spans=[tuple(s) for s in rec.spans],
                     launches=list(zip(rec.slots, counts)), uncounted=rec.uncounted)


def launch_slot(device):
    """The address of the next launch counter on ``device`` for a march
    launch, taken inside its ``rt.march.launch`` span; None while the
    recorder is off, or where the launch cannot be counted."""
    rec = _rec
    return None if rec is None else rec.slot(device)


@contextlib.contextmanager
def profile_trace(logdir: str | None = None, label: str = "trace"):
    """Time the section and print ``[profile] label: X.XXXs``. With a
    ``logdir``, also record a ``torch.profiler`` trace of it (CPU activity,
    and CUDA activity when a card is visible) and write it into ``logdir``
    as ``trace.json``, a Chrome trace; and, unless a recorder is on
    already, record the port's spans and launch counters over the section
    and write them beside it as ``spans.json`` (``_write_spans``). Waits for
    the card's queued work at the end, so the time is the section's."""
    t0 = time.time()
    if logdir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        own = not recording()
        if own:
            start()
        try:
            with profile(activities=activities) as prof:
                yield
                _wait_for_card()
        finally:
            rec = stop() if own else None
        os.makedirs(logdir, exist_ok=True)
        trace = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(trace)
        if rec is not None:
            _write_spans(rec, os.path.join(logdir, "spans.json"), _trace_base_ns(trace))
    else:
        yield
        _wait_for_card()
    dt = time.time() - t0
    print(f"[profile] {label}: {dt:.3f}s" + (f" -> {logdir}" if logdir else ""))


def _write_spans(rec: Recording, path: str, base_ns: int = 0) -> None:
    """``rec`` as a Chrome trace: each span an "X" event, ``ts`` and
    ``dur`` in us from ``base_ns`` on the ``time.time_ns`` clock (with
    trace.json's ``baseTimeNanoseconds`` the two files share one time
    axis), its parent's index and its own, and a launch span's lane
    iterations in ``args``; the launches uncounted beside them."""
    iters = dict(rec.launches)
    events = []
    for i, (name, parent, s, e) in enumerate(rec.spans):
        args = {"index": i, "parent": parent}
        if i in iters:
            args["lane_iterations"] = iters[i]
        events.append({"ph": "X", "name": name, "pid": "rt spans", "tid": 0,
                       "ts": (s - base_ns) / 1e3, "dur": (e - s) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump({"baseTimeNanoseconds": base_ns, "clock": "time.time_ns",
                   "uncounted_launches": rec.uncounted, "traceEvents": events}, f)


def _trace_base_ns(path: str) -> int:
    """The ``baseTimeNanoseconds`` a Chrome trace from torch.profiler
    writes among its top-level keys, before or after its events (0 where
    it has none)."""
    key = re.compile(rb'"baseTimeNanoseconds":\s*(\d+)')
    with open(path, "rb") as f:
        found = key.search(f.read(1 << 16))
        if found is None:
            f.seek(max(os.path.getsize(path) - 4096, 0))
            found = key.search(f.read())
    return int(found.group(1)) if found else 0


def _wait_for_card():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
