"""What decides ``correct``: the numbers that hold a job's outputs against
the plain reference's, and the precisions each side computes in."""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def count_gap(prog, ref) -> int:
    """Rays counted into other bins or pixels: the sum of |prog - ref| over
    the entries (exact)."""
    return int(np.abs(np.asarray(prog, np.int64) - np.asarray(ref, np.int64)).sum())


def rel_gap(prog, ref) -> float:
    """The largest |prog - ref| / |ref| over the entries. Equal entries
    (NaN in both, for an empty bin, included) read 0; NaN in one of the two,
    or a difference from a reference of 0, reads infinity."""
    p = np.asarray(prog, np.float64).ravel()
    q = np.asarray(ref, np.float64).ravel()
    same = (p == q) | (np.isnan(p) & np.isnan(q))
    with np.errstate(divide="ignore", invalid="ignore"):
        gap = np.abs(p - q) / np.abs(q)
    gap = np.where(same, 0.0, np.where(np.isnan(gap), np.inf, gap))
    return float(gap.max()) if gap.size else 0.0


# the controls: the reference one precision lower than the configuration
# states, in the port's place. "all": every float64 stage (source, redshift,
# bins) in float32; "sums": only the bins' sums in float32, the step that
# would tempt a later PR (float32 atomics in place of float64 ones).
CONTROLS = ("all", "sums")
# a sound variant, not a control: the march in float64, one that rounds
# otherwise than the stated float32 march does (PERF.md: why the counts are
# compared exactly)
VARIANTS = ("march64",)


def precision(config: dict, device: str, lower: str | None = None) -> tuple:
    """(march dtype, dtype of the other stages, dtype of the bins' sums) of
    the reference on ``device``: on the card, what the configuration
    states; on the CPU, float64 throughout, as the port's CPU route
    marches. ``lower`` names a control (``CONTROLS``) or a variant
    (``VARIANTS``)."""
    if str(device).startswith("cuda"):
        p = config["precision"]
        march, work = DTYPES[p["march"]], DTYPES[p["work"]]
    else:
        march = work = torch.float64
    if lower == "all":
        return torch.float32, torch.float32, torch.float32
    if lower == "sums":
        return march, work, torch.float32
    if lower == "march64":
        return torch.float64, work, work
    if lower is not None:
        raise ValueError(f"unknown control {lower!r}; one of {CONTROLS + VARIANTS}")
    return march, work, work
