"""One module per per-layer metric: ``read(window)`` (see ``harness.py``)."""
