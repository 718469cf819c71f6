"""other_device_ms: the card's time in every kernel, copy and fill but the
march kernel (redshift, hits, bins, the kernel's prepare and finish,
elementwise torch) per job, from the profiler's trace."""

from portbench.metrics.march_ms import is_march


def read(window):
    times = [e - s for name, kind, s, e in window.events
             if not (kind == "kernel" and is_march(name))]
    if not times or not window.jobs:
        return None
    return 1e3 * sum(times) / window.jobs
