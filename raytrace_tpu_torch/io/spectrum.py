"""Input line-spectrum reader.

Counterpart of ``raytrace_tpu/io/spectrum.py`` (pure numpy, kept as the
port's own copy; reference ``src/include/spectrum.h``): read a spectrum as
(energy, counts) from 2-column whitespace text or 3-column QDP (energy,
half-bin-width, counts), skipping comment/command lines.
"""

from __future__ import annotations

import numpy as np


def read_spectrum(filename: str):
    """Returns (energy, counts) arrays.

    The first parseable data line fixes the column convention (2-col plain
    text vs 3-col QDP, mirroring the reference's qdp ctor flag,
    spectrum.h:143-160); later lines with a different column count are
    skipped like any other malformed line (spectrum.h:55-67 clears the
    stream and discards)."""
    rows = []
    ncols = None
    with open(filename) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith(("#", "!", "READ", "read", "@", "skip")):
                continue
            parts = s.split()
            try:
                vals = [float(p) for p in parts]
            except ValueError:
                continue
            if len(vals) < 2:
                continue
            if ncols is None:
                ncols = len(vals)
            if len(vals) != ncols:
                continue
            rows.append(vals)
    if not rows:
        raise ValueError(f"no spectrum rows parsed from {filename}")
    arr = np.asarray(rows)
    if arr.shape[1] >= 3:
        # QDP: energy, half width, counts
        return arr[:, 0], arr[:, 2]
    return arr[:, 0], arr[:, 1]
