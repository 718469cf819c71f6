"""source_ms: the source layer's wall time per job (the harness's span
around the driver's SOURCE entry, the card synchronised at both ends)."""


def read(window):
    times = [e - s for name, s, e in window.spans if name == "source"]
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
