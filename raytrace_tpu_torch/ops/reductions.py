"""Binned reductions over the ray axis.

Counterpart of ``raytrace_tpu/ops/reductions.py``: masked segment sums —
radial bins and image pixels — with a scrap bin for the rays outside the
mask, as ``index_add_`` into an ``n_bins + 1`` buffer. On a CUDA tensor
``index_add_`` adds with atomics in an order that changes from run to run:
counts stay exact, float sums agree to rounding.
"""

from __future__ import annotations

import functools
import math

import torch

from raytrace_tpu_torch.utils.profiling import span


def radial_bin_index(r, r_min, dr, n_bins, logbin: bool):
    """Bin index under the reference convention (emissivity.cpp:59,105):
    log bins floor(log(r/r_min)/log(dr)), linear floor((r - r_min)/dr)."""
    if logbin:
        log_dr = torch.log(dr) if isinstance(dr, torch.Tensor) else math.log(dr)
        ir = torch.floor(torch.log(r / r_min) / log_dr)
    else:
        ir = torch.floor((r - r_min) / dr)
    in_range = (ir >= 0) & (ir < n_bins)
    return torch.where(in_range, ir, torch.zeros_like(ir)).to(torch.int64), in_range


def bin_edges(r_min, r_max, n_bins, logbin: bool, *, device, dtype=torch.float64):
    """Left edges, widths and step (emissivity.cpp:59,78): log bins
    r_i = r_min * dr^i with dr = exp(log(r_max/r_min)/Nr); linear
    r_i = r_min + i*dr. ``r_min`` may be a tensor (the ISCO of a spin that
    carries a gradient); then ``dr`` is one too."""
    i = torch.arange(n_bins, dtype=dtype, device=device)
    if logbin:
        if isinstance(r_min, torch.Tensor):
            dr = torch.exp(torch.log(torch.full_like(r_min, r_max) / r_min) / n_bins)
        else:
            dr = math.exp(math.log(r_max / r_min) / n_bins)
        r = r_min * dr**i
        width = r * dr - r
    else:
        dr = (r_max - r_min) / n_bins
        r = r_min + i * dr
        width = torch.full_like(r, dr) if not isinstance(dr, torch.Tensor) else dr.expand_as(r)
    return r, width, dr


def masked_segment_sum(values, seg_ids, mask, n_bins):
    """Sum ``values`` into n_bins segments, dropping rays where mask is False."""
    ids = torch.where(mask, seg_ids, n_bins)  # scrap bin
    out = torch.zeros(n_bins + 1, dtype=values.dtype, device=values.device)
    out.index_add_(0, ids, torch.where(mask, values, torch.zeros_like(values)))
    return out[:n_bins]


def radial_bin_profile(r, mask, weights: dict, r_min, dr, n_bins, logbin: bool):
    """Bin per-ray weights into radial bins; returns (counts, {name: sum}).
    Runs in the span ``rt.bins``."""
    with span("rt.bins"):
        ids, in_range = radial_bin_index(r, r_min, dr, n_bins, logbin)
        m = mask & in_range
        counts = masked_segment_sum(torch.ones_like(r), ids, m, n_bins)
        sums = {k: masked_segment_sum(v, ids, m, n_bins) for k, v in weights.items()}
        return counts, sums


def pixel_accumulate(ix, iy, mask, weights: dict, nx: int, ny: int):
    """Accumulate per-ray weights onto an (nx, ny) pixel grid; rays outside
    the mask or the grid go to the scrap bin (imageplane_disc_image.cpp:122-176).
    Returns (counts, {name: image}). Runs in the span ``rt.bins``."""
    with span("rt.bins"):
        m = mask & (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
        flat = ix.long() * ny + iy.long()

        def scatter(v):
            return masked_segment_sum(v, flat, m, nx * ny).reshape(nx, ny)

        dtypes = [v.dtype for v in weights.values()] or [torch.float64]
        dtype = functools.reduce(torch.promote_types, dtypes)
        counts = scatter(torch.ones(flat.shape, dtype=dtype, device=flat.device))
        return counts, {k: scatter(v) for k, v in weights.items()}
