"""march_ms: the card's time in the march kernel (``march_kernel*`` and
``march_refill_kernel*`` of csrc/march.cu) per job, from the profiler's trace."""

import re

_MARCH = re.compile(r"\bmarch_(refill_)?kernel\b")


def is_march(name: str) -> bool:
    return bool(_MARCH.search(name))


def read(window):
    times = [e - s for name, kind, s, e in window.events if kind == "kernel" and is_march(name)]
    if not times or not window.jobs:
        return None
    return 1e3 * sum(times) / window.jobs
