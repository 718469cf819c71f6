"""Integrator cores and reductions (torch), and the route between the
CUDA march kernel and its plain version."""

from raytrace_tpu_torch.ops.integrate import RK45_STEPLIM, STEPLIM, StepControl, trace
from raytrace_tpu_torch.ops.march_kernel import trace_kernel
from raytrace_tpu_torch.ops.reductions import radial_bin_profile


def kernel_steplim(method, steplim=None) -> int:
    """Stuck-ray cap for the march kernel when the caller gave none: RK4 at
    30k, RK45 at the reference's RK45_STEPLIM = 1e5 (raytracer.h:33-39)."""
    if steplim is None or steplim <= 0:
        return 100_000 if method == "rk45" else 30_000
    return steplim


def trace_auto(rays, spin, **kw):
    """March on the batch's device: a CUDA batch goes to the march kernel
    (float32, with ``kernel_steplim``), a CPU batch to the plain lock-step
    ``trace``. Every keyword is passed on, so both routes take ``trace``'s
    keywords and reject unknown ones; the method defaults to ``trace``'s
    rk45 on both."""
    if rays.r.is_cuda:
        method = kw.pop("method", "rk45")
        steplim = kernel_steplim(method, kw.pop("steplim", None))
        return trace_kernel(rays, spin, method=method, steplim=steplim, **kw)
    return trace(rays, spin, **kw)


__all__ = [
    "RK45_STEPLIM",
    "STEPLIM",
    "StepControl",
    "kernel_steplim",
    "radial_bin_profile",
    "trace",
    "trace_auto",
    "trace_kernel",
]
