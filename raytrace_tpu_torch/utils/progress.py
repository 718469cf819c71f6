"""Terminal progress reporting for multi-phase runs.

Counterpart of ``raytrace_tpu/utils/progress.py``. The reference draws a
per-ray bar inside its OpenMP loop (src/include/progress_bar.h:25-74); a
batch here completes as a unit, so progress is per phase or chunk: the
phased marches (``ops.trace_compacted(progress=True)``,
``trace_kernel_phased``), the apps' phases (``app_phase``) and apps looping
over launch radii (apps/return_radiation.py). Host only.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import time


class ProgressBar:
    """In-place bar on a TTY; plain progress lines otherwise (the
    reference's bar is TTY-only, but apps also run with stderr captured to
    a file, where silence would be no progress at all)."""

    def __init__(self, total: int, label: str = "", enabled: bool = True):
        self.total = max(total, 1)
        self.label = label
        self.enabled = enabled
        self.tty = sys.stderr.isatty()
        self.t0 = time.time()
        self._last = -1.0

    def show(self, done: int, extra: str = ""):
        if not self.enabled:
            return
        frac = min(done / self.total, 1.0)
        self._last = frac
        suffix = f" [{extra}]" if extra else ""
        if self.tty:
            width = max(shutil.get_terminal_size((80, 20)).columns - 34, 10)
            filled = int(frac * width)
            bar = "=" * filled + ">" + " " * (width - filled)
            sys.stderr.write(f"\r{self.label} [{bar}] {100 * frac:5.1f}% "
                             f"({time.time() - self.t0:.1f}s){suffix}")
        else:
            sys.stderr.write(f"{self.label}: {100 * frac:5.1f}% "
                             f"({time.time() - self.t0:.1f}s){suffix}\n")
        sys.stderr.flush()

    def done(self):
        if not self.enabled:
            return
        # no second 100% line on a non-TTY stream
        if self.tty or self._last < 1.0:
            self.show(self.total)
        if self.tty:
            sys.stderr.write("\n")
            sys.stderr.flush()


@contextlib.contextmanager
def app_phase(label: str):
    """Coarse progress for the apps: announce ``[label] ...`` on stderr and
    time the phase (``utils.profiling.profile_trace``); with
    ``RT_PROFILE=<dir>`` in the environment, also record a profiler trace
    of the phase into ``<dir>/<label, spaces as _>``."""
    from raytrace_tpu_torch.utils.profiling import profile_trace

    logdir = os.environ.get("RT_PROFILE")
    sys.stderr.write(f"[{label}] ...\n")
    sys.stderr.flush()
    with profile_trace(os.path.join(logdir, label.replace(" ", "_")) if logdir else None,
                       label=label):
        yield
