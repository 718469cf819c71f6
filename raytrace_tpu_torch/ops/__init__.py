"""Integrator cores and reductions (torch), the route between the CUDA
march kernel and its plain version, and the differentiable march and
observables (``ops/diff.py``)."""

import math
import os

import torch

from raytrace_tpu_torch.destinations import KERNEL_DESTINATIONS, ThetaLimit
from raytrace_tpu_torch.ops.diff import (
    chaos_weight,
    emissivity_binned_profile,
    emissivity_gradient_pipeline,
    emissivity_observable_from_angles,
    launch_turning_scores,
    line_profile_from_xy,
    line_profile_observable,
    separatrix_score,
    smooth_radial_observable,
    trace_scan,
)
from raytrace_tpu_torch.ops.integrate import (
    RK45_STEPLIM,
    STEPLIM,
    StepControl,
    trace,
    trace_compacted,
)
from raytrace_tpu_torch.ops.march_kernel import (
    schedule_of,
    trace_kernel,
    trace_kernel_phased,
    trace_kernel_ranges,
)
from raytrace_tpu_torch.ops.reductions import pixel_accumulate, radial_bin_profile
from raytrace_tpu_torch.utils.profiling import span

# trace_auto's routes so far, by name ("kernel" or "plain", and
# "kernel_phased" or "plain_phased" when the march shows its progress):
# counted where the route is taken, so a caller can see which engine
# marched a batch.
routes = {"kernel": 0, "kernel_phased": 0, "plain": 0, "plain_phased": 0}


def kernel_supported(method="rk45", dest=None) -> bool:
    """Whether the march kernel implements ``method`` towards ``dest``:
    euler, rk4 or rk45 to ThetaLimit (the default), DiscWithISCO, FlatPlane
    or SphericalShell. The counterpart of the JAX ``pallas_supported``
    without its backend test: ``trace_auto`` takes the batch's device."""
    return method in ("euler", "rk4", "rk45") and (
        dest is None or type(dest) in KERNEL_DESTINATIONS)


def kernel_steplim(method, steplim=None) -> int:
    """Stuck-ray cap for the march kernel when the caller gave none: RK4 at
    30k, RK45 at the reference's RK45_STEPLIM = 1e5 (raytracer.h:33-39)."""
    if steplim is None or steplim <= 0:
        return 100_000 if method == "rk45" else 30_000
    return steplim


def trace_auto(rays, spin, march_dtype=None, progress=None, **kw):
    """March on the batch's device: a CUDA batch towards a destination the
    kernel implements (``kernel_supported``) goes to the march kernel (with
    ``kernel_steplim``); any other batch, and a CUDA batch towards any
    other destination (``RadialVelocityField``), to the plain lock-step
    march on its own device. The route follows the destination's type
    alone and is counted in ``routes``. Every other keyword is passed on,
    so both routes take ``trace``'s keywords and reject unknown ones; the
    method defaults to ``trace``'s rk45 on both.

    ``march_dtype`` is the kernel's working precision on a CUDA batch:
    float32 when None (as the TPU kernel marches), or float64. The plain
    march works in the batch's own dtype, so on its route it must be None
    or that dtype.

    ``progress=True`` (or, when it is None, ``RT_PROGRESS=1`` in the
    environment) marches in phases with a progress bar on stderr between
    them: ``trace_kernel_phased`` on the kernel route (counted as
    "kernel_phased"), ``trace_compacted(progress=True)`` on the plain one
    ("plain_phased"); the compiled analogue of the reference's in-loop bar
    (raytracer.cpp:107-115).

    Either route runs in the span ``rt.march`` (``utils.profiling``)."""
    progress = _progress(progress)
    method = kw.pop("method", "rk45")
    with span("rt.march"):
        if rays.r.is_cuda and kernel_supported(method, kw.get("dest")):
            steplim = kernel_steplim(method, kw.pop("steplim", None))
            dtype = torch.float32 if march_dtype is None else march_dtype
            route, run = (("kernel_phased", trace_kernel_phased) if progress
                          else ("kernel", trace_kernel))
            routes[route] += 1
            return run(rays, spin, method=method, steplim=steplim, march_dtype=dtype, **kw)
        if march_dtype not in (None, rays.r.dtype):
            raise ValueError(f"the plain march works in the batch's dtype {rays.r.dtype}, "
                             f"not march_dtype={march_dtype}")
        if progress:
            routes["plain_phased"] += 1
            return trace_compacted(rays, spin, method=method, progress=True, **kw)
        routes["plain"] += 1
        return trace(rays, spin, method=method, **kw)


def trace_in_ranges(rays, spin, cuts, march_dtype=None, progress=None, **kw):
    """``trace_auto`` for a caller that works on each range of the batch
    while the others still march: range k is the rays [cuts[k], cuts[k +
    1]) (``cuts`` from 0 to the batch's count, no range empty). Returns an
    iterator of (k0, k1, out, stream): ``out`` the marched rays [cuts[k0],
    cuts[k1]) of the ranges k0 up to k1, and ``stream`` the CUDA stream
    their work is queued on (None on the CPU). On the kernel route under
    the grid launch with no progress bar each range marches on its own
    stream and the ranges come as they land (``trace_kernel_ranges``,
    counted as "kernel", launched in the span ``rt.march``); otherwise the
    batch marches whole (``trace_auto``) and comes as one piece."""
    progress = _progress(progress)
    method = kw.pop("method", "rk45")
    dest = kw.get("dest")
    dtype = torch.float32 if march_dtype is None else march_dtype
    if (rays.r.is_cuda and not progress and kernel_supported(method, dest)
            and schedule_of(method, dest or ThetaLimit(math.pi / 2), dtype) == "grid"):
        steplim = kernel_steplim(method, kw.pop("steplim", None))
        with span("rt.march"):
            routes["kernel"] += 1
            return trace_kernel_ranges(rays, spin, cuts, method=method, steplim=steplim,
                                       march_dtype=dtype, **kw)
    out = trace_auto(rays, spin, march_dtype=march_dtype, progress=progress, method=method, **kw)
    stream = torch.cuda.current_stream(out.r.device) if out.r.is_cuda else None
    return iter([(0, len(cuts) - 1, out, stream)])


def _progress(progress) -> bool:
    """``progress``, or when it is None whether ``RT_PROGRESS=1`` is set."""
    if progress is None:
        return os.environ.get("RT_PROGRESS", "0") == "1"
    return progress


__all__ = [
    "RK45_STEPLIM",
    "STEPLIM",
    "StepControl",
    "chaos_weight",
    "emissivity_binned_profile",
    "emissivity_gradient_pipeline",
    "emissivity_observable_from_angles",
    "kernel_steplim",
    "kernel_supported",
    "launch_turning_scores",
    "line_profile_from_xy",
    "line_profile_observable",
    "pixel_accumulate",
    "radial_bin_profile",
    "routes",
    "separatrix_score",
    "smooth_radial_observable",
    "trace",
    "trace_auto",
    "trace_compacted",
    "trace_in_ranges",
    "trace_kernel",
    "trace_kernel_phased",
    "trace_kernel_ranges",
    "trace_scan",
]
