"""Timing and profiler traces of a section.

Counterpart of ``raytrace_tpu/utils/profiling.py``: ``torch.profiler``
takes the place of ``jax.profiler.trace``. The trace is a Chrome trace
(open it in Perfetto or ``chrome://tracing``), with the card's kernels,
copies and their times beside the host's operations when a card is in use.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile_trace(logdir: str | None = None, label: str = "trace"):
    """Time the section and print ``[profile] label: X.XXXs``. With a
    ``logdir``, also record a ``torch.profiler`` trace of it (CPU activity,
    and CUDA activity when a card is visible) and write it into ``logdir``
    as ``trace.json``, a Chrome trace. Waits for the card's queued work at
    the end, so the time is the section's."""
    t0 = time.time()
    if logdir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            yield
            _wait_for_card()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    else:
        yield
        _wait_for_card()
    dt = time.time() - t0
    print(f"[profile] {label}: {dt:.3f}s" + (f" -> {logdir}" if logdir else ""))


def _wait_for_card():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
