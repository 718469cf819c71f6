"""Binned reductions over the ray axis.

Counterpart of ``raytrace_tpu/ops/reductions.py``: masked segment sums —
radial bins and image pixels — of a ray count and per-ray weights, through
``masked_bins``, which takes one of two routes (``bin_route``):

- on a card, the scatter kernel (``csrc/bins.cu``, ``bin_scatter``): one
  launch for the count and every float64 weight, the rays outside the
  mask skipped. For a few bins (radial profiles) each block sums into its
  warps' own copies of the bins in shared memory and a second small pass
  adds the blocks' partials in a fixed order, so the sums come out the
  same bits from run to run on one card; for many (image pixels) each ray
  in the mask adds with float64 atomics, in an order that changes from run
  to run. It raises on what it does not take (another dtype, more than
  MAX_COLUMNS weights, no bins);
- on the CPU, for a weight that carries a derivative (a gradient it
  records or a forward-mode tangent) and for an empty batch, torch's
  ``index_add_``, one pass a column into an ``n_bins + 1`` buffer with a
  scrap bin for the rays outside the mask (``masked_segment_sum``). On a
  CUDA tensor it too adds with atomics in an order that changes from run
  to run.

Counts stay exact on every route; float sums agree to rounding.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd import forward_ad as fwad

from raytrace_tpu_torch.utils.profiling import span

# The scatter kernel's limits (csrc/bins.cu): at most MAX_COLUMNS weights a
# launch; the block-local route while WARPS copies of the bins, (1 + weights)
# x n_bins float64, fit in BLOCK_BYTES of shared memory (fewer warps a block
# for more bins, down to one), the global route beyond. The block-local
# grid is the blocks resident at once (``blocks_per_sm``) on an H100 SM:
# 64 warps and 228 KB of shared memory, 1 KB of it reserved a block.
MAX_COLUMNS = 16
WARPS = 8
BLOCK_BYTES = 48 * 1024
SM_WARPS = 64
SM_SHARED_BYTES = 228 * 1024
BLOCK_RESERVED_BYTES = 1024

# Scatter kernel launches so far: counted where it is launched, nowhere else.
launches = 0


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
    """Sum ``values`` into n_bins segments, dropping rays where mask is
    False: torch's ``index_add_`` into a scrap bin (``masked_bins``'
    index_add route)."""
    ids = torch.where(mask, seg_ids, n_bins)  # scrap bin
    out = torch.zeros(n_bins + 1, dtype=values.dtype, device=values.device)
    out.index_add_(0, ids, torch.where(mask, values, torch.zeros_like(values)))
    return out[:n_bins]


def block_warps(n_bins: int, n_columns: int) -> int:
    """Warps a block of the block-local route for ``n_columns`` weights
    into ``n_bins`` bins: as many copies of the bins as fit in
    BLOCK_BYTES, at most WARPS; 0 where not one does (the global route)."""
    return min(WARPS, BLOCK_BYTES // ((1 + n_columns) * max(n_bins, 1) * 8))


def blocks_per_sm(warps: int, width: int) -> int:
    """Blocks of the block-local route, ``warps`` warps a block and
    ``width`` = (1 + weights) x n_bins float64 bins a warp, resident at
    once on one SM, by its warps and its shared memory (the kernel's 32
    registers a thread never bind), so that its grid is one wave."""
    return min(SM_WARPS // warps,
               SM_SHARED_BYTES // (warps * width * 8 + BLOCK_RESERVED_BYTES))


def bin_route(device, n: int, n_bins: int, n_columns: int, *, derivative: bool = False) -> str:
    """The route ``masked_bins`` takes for ``n`` rays and ``n_columns``
    weights into ``n_bins`` bins on ``device``: "index_add" (torch's
    ``index_add_``) on a CPU device, for no rays and where a value carries
    a ``derivative``; else the scatter kernel's "block" route where
    ``block_warps`` finds room, its "global" route where it does not."""
    if torch.device(device).type != "cuda" or n == 0 or derivative:
        return "index_add"
    return "block" if block_warps(n_bins, n_columns) else "global"


def carries_derivative(t) -> bool:
    """Whether autograd would see through ``t``: it records a gradient
    while grad mode is on, carries a forward-mode tangent, or is wrapped by
    a ``torch.func`` transform. The kernel reads raw memory, so such a
    tensor takes ``index_add_``."""
    return ((t.requires_grad and torch.is_grad_enabled())
            or fwad.unpack_dual(t).tangent is not None
            or torch._C._functorch.is_functorch_wrapped_tensor(t))


def masked_bins(columns, seg_ids, mask, n_bins: int, dtype):
    """The rays where ``mask`` holds, by bin ``seg_ids``: the rows [counts,
    *sums of ``columns``], each (n_bins,), the counts in ``dtype`` (on the
    kernel's route one (1 + len(columns), n_bins) float64 tensor, which
    refuses another ``dtype``). Each scatter runs in a span named for its
    route (``bin_route``): ``rt.bins.kernel`` or ``rt.bins.index_add``."""
    route = bin_route(seg_ids.device, seg_ids.numel(), n_bins, len(columns),
                      derivative=any(carries_derivative(t) for t in (seg_ids, mask, *columns)))
    if route == "index_add":
        with span("rt.bins.index_add"):
            ones = torch.ones(seg_ids.shape, dtype=dtype, device=seg_ids.device)
            return [masked_segment_sum(v, seg_ids, mask, n_bins) for v in (ones, *columns)]
    with span("rt.bins.kernel"):
        if dtype != torch.float64:
            raise ValueError(f"the scatter kernel counts in float64, not {dtype}")
        return bin_scatter(columns, seg_ids, mask, n_bins, block_warps(n_bins, len(columns)))


def bin_scatter(columns, seg_ids, mask, n_bins: int, warps: int):
    """The scatter kernel (``csrc/bins.cu``) on the current stream of the
    ids' card: a (1 + len(columns), n_bins) float64 tensor, row 0 the count
    of the rays where ``mask`` holds in each bin, row 1 + c the sum of
    ``columns[c]`` over them; the rays outside the mask read nothing, and
    ids outside [0, n_bins) add nothing. ``warps`` > 0: the
    block-local route with that many warps a block; 0: the global route.
    Counted in ``launches``; raises on what the kernel does not take and
    on a CUDA error."""
    global launches
    from raytrace_tpu_torch.ops import march_kernel

    device, n, k = seg_ids.device, seg_ids.numel(), len(columns)
    if (device.type != "cuda" or n == 0 or n_bins <= 0 or k > MAX_COLUMNS or seg_ids.dim() != 1
            or mask.shape != seg_ids.shape or mask.device != device
            or any(v.shape != seg_ids.shape or v.device != device or v.dtype != torch.float64
                   for v in columns)):
        raise ValueError("bin_scatter takes 1-D ids, a mask and at most "
                         f"{MAX_COLUMNS} float64 columns of one length on one card, into "
                         "one bin or more")
    ids = seg_ids.to(torch.int64).contiguous()
    m = mask.to(torch.bool).contiguous()
    cols = [v.contiguous() for v in columns]
    lib = march_kernel.load()
    with torch.cuda.device(device):
        if warps:
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            blocks = min(-(-n // (32 * warps)), blocks_per_sm(warps, (1 + k) * n_bins) * sms)
            out = torch.empty(1 + k, n_bins, dtype=torch.float64, device=device)
            partials = torch.empty(blocks, (1 + k) * n_bins, dtype=torch.float64, device=device)
        else:
            blocks, partials = 0, None
            out = torch.zeros(1 + k, n_bins, dtype=torch.float64, device=device)
        pointers = (ctypes.c_void_p * max(k, 1))(*(v.data_ptr() for v in cols))
        err = lib.rt_bin_scatter_launch(
            ids.data_ptr(), m.data_ptr(), pointers, k, n, n_bins, warps, blocks,
            None if partials is None else partials.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rt_bin_scatter_launch failed with CUDA error {err}")
    launches += 1
    return out


def radial_bin_profile(r, mask, weights: dict, r_min, dr, n_bins, logbin: bool):
    """Bin per-ray weights into radial bins; returns (counts, {name: sum}).
    Runs in the span ``rt.bins`` (``masked_bins``' route span inside)."""
    with span("rt.bins"):
        ids, in_range = radial_bin_index(r, r_min, dr, n_bins, logbin)
        counts, *sums = masked_bins(list(weights.values()), ids, mask & in_range, n_bins,
                                    r.dtype)
        return counts, dict(zip(weights, sums))


def pixel_accumulate(ix, iy, mask, weights: dict, nx: int, ny: int):
    """Accumulate per-ray weights onto an (nx, ny) pixel grid; rays outside
    the mask or the grid are dropped (imageplane_disc_image.cpp:122-176).
    Returns (counts, {name: image}). Runs in the span ``rt.bins``
    (``masked_bins``' route span inside)."""
    with span("rt.bins"):
        m = mask & (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
        flat = ix.long() * ny + iy.long()
        dtypes = [v.dtype for v in weights.values()] or [torch.float64]
        dtype = functools.reduce(torch.promote_types, dtypes)
        counts, *images = masked_bins(list(weights.values()), flat, m, nx * ny, dtype)
        return counts.reshape(nx, ny), {k: v.reshape(nx, ny) for k, v in zip(weights, images)}
