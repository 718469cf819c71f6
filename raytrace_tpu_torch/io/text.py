"""Column-formatted scientific-notation text output.

Capability of the reference ``src/include/text_output.h``: fixed-width
scientific-notation columns, one row per record, used for emissivity
profiles and trajectory dumps. Output is byte-compatible enough for the
reference's own python plotting layer (whitespace-separated floats).
"""

from __future__ import annotations

import numpy as np


class TextOutput:
    """Row-oriented column writer (text_output.h:19-126)."""

    def __init__(self, filename: str, precision: int = 6, width: int = 15):
        self._f = open(filename, "w")
        self.precision = precision
        self.width = width

    def row(self, *values):
        parts = []
        for v in values:
            if isinstance(v, (int, np.integer)):
                parts.append(f"{v:>{self.width}d}")
            else:
                parts.append(f"{float(v):>{self.width}.{self.precision}e}")
        self._f.write(" ".join(parts) + "\n")

    def newline(self, n: int = 1):
        self._f.write("\n" * n)

    def write_columns(self, *columns):
        """Write aligned columns from equal-length arrays."""
        cols = [np.asarray(c) for c in columns]
        for row in zip(*cols):
            self.row(*row)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
