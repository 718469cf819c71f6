"""The geodesic march as a hand-written CUDA kernel for Hopper.

Counterpart of ``raytrace_tpu/ops/pallas_kernel.py::trace_pallas`` and of
the compaction schedule ``trace_pallas_fused`` runs it under: the kernel
(``csrc/march.cu`` on the per-ray step of ``csrc/march.cuh``) marches every
ray to termination in registers for ``euler``, ``rk4`` and ``rk45`` with
each of the ``ThetaLimit``/``FlatDisc``, ``DiscWithISCO``, ``FlatPlane`` and
``SphericalShell`` destinations, in float32 (the default, as on the TPU) or
float64. Each instantiation runs under the schedule ``schedule_of`` gives
it: the grid launch (one thread per ray) or the lane-refill schedule (as
many blocks as are resident, each warp taking the next 32 rays from a
counter once all its lanes are done), both bitwise alike. The plain version is
``ops/integrate.py::trace``; ``ops.trace_auto`` picks one of the two by the
device of the batch.

The kernel is compiled on first use with nvcc into ``_build/`` next to the
package (rebuilt when a source is newer than the library) and loaded with
ctypes. A missing nvcc or a failed build raises; nothing here falls back to
the plain version. The same library holds the bins' scatter kernel
(``csrc/bins.cu``), which ``ops/reductions.py::bin_scatter`` launches, and
the emissivity's redshift kernels (``csrc/redshift.cu``), which
``ops/redshift.py::emit_kernel`` and ``emis_weights_kernel`` launch.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from raytrace_tpu_torch.destinations import DiscWithISCO, FlatPlane, SphericalShell, ThetaLimit
from raytrace_tpu_torch.geometry.kerr import horizon_radius
from raytrace_tpu_torch.ops.integrate import (
    StepControl,
    _fresh_propagation_state,
    _refine_theta_crossing,
    march_budget,
    run_phases,
)
from raytrace_tpu_torch.rays import RAY_STATUS_TERMINAL, RayBatch
from raytrace_tpu_torch.utils.profiling import launch_slot, span

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_LIB = BUILD_DIR / "libraytrace_march.so"
_LIB_SOURCES = (CSRC / "march.cu", CSRC / "bins.cu", CSRC / "redshift.cu")
_SOURCES = (*_LIB_SOURCES, CSRC / "march.cuh", CSRC / "redshift.cuh")

# The 21 arrays the kernel marches, in the order of rt_march_launch.
F_FIELDS = (
    "t", "r", "theta", "phi", "pt", "pr", "ptheta", "pphi",
    "k", "h", "Q", "rdot_sign", "thetadot_sign", "dt", "emit",
)
I_FIELDS = ("steps", "status", "rdot_flips", "equatorial_crossings")
B_FIELDS = ("r_was_positive", "theta_was_positive")

_METHOD_CODE = {"rk4": 1, "rk45": 2, "euler": 3}
_DEST_THETA, _DEST_ISCO, _DEST_PLANE, _DEST_SHELL = 0, 1, 2, 3
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_SCHEDULE_CODE = {"grid": 0, "refill": 1}

# The instantiations that run the lane-refill schedule, by (method,
# destination code, march dtype): the float64 RK45 isco kernel of the
# discplane caustics, the one where it measured faster than the grid
# launch (PERF.md; csrc/march.cu builds a refill kernel for it alone,
# refilled()). Every other one runs the grid launch.
_REFILLED = {("rk45", _DEST_ISCO, torch.float64)}

# Kernel launches so far: counted where the kernel is launched, nowhere else.
launches = 0

_lib = None


def argtypes(host: bool = False):
    """ctypes argument list of rt_march_launch: 21 pointers, n, spin,
    r_max, horizon, the destination code and its four parameters, steplim,
    max_iters, the 11 StepControl values, method and dtype, then the
    schedule, the ray counter, the lane-iteration slot (null: not counted)
    and the stream; with ``host``, that of the host build's rt_march_host,
    whose dtype is followed by the number of emulated warps (0: ray after
    ray) and the lane-iteration slot."""
    c = ctypes
    types = [c.c_void_p] * 21 + [c.c_int64] + [c.c_double] * 3 + [c.c_int]
    types += [c.c_double] * 4 + [c.c_int] * 2 + [c.c_double] * 11 + [c.c_int, c.c_int]
    if host:
        return types + [c.c_int, c.c_void_p]
    return types + [c.c_int, c.c_void_p, c.c_void_p, c.c_void_p]


def schedule_of(method: str, dest, march_dtype) -> str:
    """The schedule the kernel runs ``method`` towards ``dest`` in
    ``march_dtype`` under: "refill" or "grid"."""
    return "refill" if (method, _dest_args(dest)[0], march_dtype) in _REFILLED else "grid"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: cannot build the march kernel")


def nvcc_command(source, out, defines=()) -> list:
    """nvcc's command line for a march library from ``source`` (a path, or
    several): sm_90a, no FMA contraction (``--fmad=false``), so the kernel
    rounds like the plain march (see the note in march.cu), and ``-Xptxas
    -v`` (registers, stack and spills per kernel); ``defines`` adds ``-D``
    flags (``RT_LAUNCH_TRACE``: the launch-trace side build, which
    chip_smoke.py makes)."""
    sources = [source] if isinstance(source, (str, os.PathLike)) else list(source)
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        *(f"-D{d}" for d in defines), "-o", str(out), *map(str, sources),
    ]


def build(force: bool = False) -> str:
    """Compile ``csrc/march.cu``, ``csrc/bins.cu`` and ``csrc/redshift.cu`` into
    ``_build/libraytrace_march.so`` (``nvcc_command``) unless the library
    is newer than its sources. Returns nvcc's output, empty when the
    library was up to date."""
    if not force and _LIB.exists():
        if _LIB.stat().st_mtime >= max(s.stat().st_mtime for s in _SOURCES):
            return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{_LIB.name}.{os.getpid()}.tmp"
    proc = subprocess.run(nvcc_command(_LIB_SOURCES, tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, _LIB)
    return proc.stdout + proc.stderr


def open_library(path):
    """A built march library, its entry points declared (the bins' and the
    redshift's where it has them: the launch-trace side build has not)."""
    lib = ctypes.CDLL(str(path))
    lib.rt_march_launch.argtypes = argtypes()
    lib.rt_march_launch.restype = ctypes.c_int
    lib.rt_march_kernel_info.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.rt_march_kernel_info.restype = ctypes.c_int
    if hasattr(lib, "rt_bin_scatter_launch"):
        c = ctypes
        lib.rt_bin_scatter_launch.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p, c.c_int,
                                              c.c_int64, c.c_int64, c.c_int, c.c_int64,
                                              c.c_void_p, c.c_void_p, c.c_void_p]
        lib.rt_bin_scatter_launch.restype = c.c_int
    if hasattr(lib, "rt_emit_launch"):
        c = ctypes
        lib.rt_emit_launch.argtypes = [c.c_void_p, c.c_void_p, c.c_int64, c.c_double,
                                       c.c_double, c.c_void_p]
        lib.rt_emit_launch.restype = c.c_int
        lib.rt_emis_weights_launch.argtypes = emis_weights_argtypes() + [c.c_void_p]
        lib.rt_emis_weights_launch.restype = c.c_int
    return lib


def emis_weights_argtypes() -> list:
    """ctypes argument list of rt_emis_weights_launch without its stream
    (that of the host build's rt_emis_weights_host): the 11 ray pointers
    as one array, the ids, mask and columns, n, spin, the route, r_isco,
    theta_lim, log bins, r_min, the step, n_bins, gamma and n_primary."""
    c = ctypes
    return ([c.c_void_p] * 4 + [c.c_int64, c.c_double, c.c_int, c.c_double, c.c_double, c.c_int,
                                c.c_double, c.c_double, c.c_int64, c.c_double, c.c_double])


def load():
    """The kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        _lib = open_library(_LIB)
    return _lib


def kernel_info(method: str, dest, march_dtype, schedule: str) -> dict:
    """What the card makes of one built kernel, ``schedule`` "grid" or
    "refill": blocks resident on an SM, SMs, registers and local-memory
    bytes (stack and spills) a thread."""
    out = (ctypes.c_int * 4)()
    err = load().rt_march_kernel_info(_METHOD_CODE[method], _dest_args(dest)[0],
                                      _DTYPE_CODE[march_dtype], _SCHEDULE_CODE[schedule], out)
    if err != 0:
        raise RuntimeError(f"rt_march_kernel_info failed with CUDA error {err}")
    return dict(blocks_per_sm=out[0], sms=out[1], registers=out[2], local_bytes=out[3])


def _dest_args(dest) -> list:
    """The destination's kernel code and its four parameters p0..p3 as
    Python floats (csrc/march.cuh, DEST_*); the kernel rounds each once to
    the march dtype, as torch rounds the Python floats the plain march
    computes with. FlatPlane passes the sin and cos of its inclination that
    the plain ``FlatPlane`` multiplies by."""
    kind = type(dest)
    if kind is ThetaLimit:
        return [_DEST_THETA, float(dest.theta_lim), 0.0, 0.0, 0.0]
    if kind is DiscWithISCO:
        return [_DEST_ISCO, float(dest.r_isco), float(dest.r_out), float(dest.theta_lim), 0.0]
    if kind is FlatPlane:
        return [_DEST_PLANE, dest.sin_incl, dest.cos_incl, float(dest.phi0), float(dest.z_s)]
    if kind is SphericalShell:
        return [_DEST_SHELL, float(dest.r_shell), 0.0, 0.0, 0.0]
    raise NotImplementedError(
        "march kernel supports ThetaLimit, DiscWithISCO, FlatPlane and SphericalShell, "
        f"got {kind.__name__}")


def prepare(rays: RayBatch, spin, *, method, dest, r_max, steplim, ctrl: StepControl,
            boundary, march_dtype, resume=False, max_iters=None):
    """Fresh-propagation setup (skipped with ``resume``), then the 21
    marched fields as fresh contiguous buffers (floats in ``march_dtype``,
    counters int32, gates bool) and the scalar arguments of the launch,
    ``max_iters`` (default ``march_budget(steplim)``) at index
    ``_MAX_ITERS``. Raises on anything the kernel does not take.

    A resumed launch loads what the last one stored: its buffers are
    copied from the batch that launch returned. A float32 march of a
    float64 batch casts the float32 results to float64 in ``finish`` and
    back here; both casts are exact (every float32 is a float64), so a
    march resumed through ``trace_kernel(..., resume=True)`` starts from
    the very bits the last launch stored."""
    if method not in _METHOD_CODE:
        raise NotImplementedError(f"march kernel supports euler, rk4 and rk45, got {method!r}")
    if dest is None:
        dest = ThetaLimit(math.pi / 2)
    dest_args = _dest_args(dest)
    if march_dtype not in _DTYPE_CODE:
        raise TypeError(f"march_dtype must be float32 or float64, got {march_dtype}")
    if rays.r.dtype not in _DTYPE_CODE:
        raise TypeError(f"ray batch must be float32 or float64, got {rays.r.dtype}")
    n = rays.n_rays
    device = rays.r.device
    for f in F_FIELDS + I_FIELDS + B_FIELDS:
        x = getattr(rays, f)
        if x.shape != (n,) or x.device != device:
            raise ValueError(f"field {f}: expected shape ({n},) on {device}, got {tuple(x.shape)} on {x.device}")

    horizon = horizon_radius(spin) if boundary is None else boundary
    if not resume:
        rays = _fresh_propagation_state(rays, spin, horizon, method, ctrl)
    if max_iters is None:
        max_iters = march_budget(steplim)

    def fresh(x, dtype):
        return torch.empty(n, dtype=dtype, device=device).copy_(x)

    buf = {f: fresh(getattr(rays, f), march_dtype) for f in F_FIELDS}
    buf.update({f: fresh(getattr(rays, f), torch.int32) for f in I_FIELDS})
    buf.update({f: fresh(getattr(rays, f), torch.bool) for f in B_FIELDS})
    c = ctrl
    scalars = [
        n, float(spin), float(r_max), float(horizon), *dest_args,
        int(steplim), int(max_iters),
        c.precision, c.theta_precision, c.max_tstep, c.maxtstep_rlim, c.max_phistep,
        c.min_step, c.rk45_tol, c.horizon_eps, c.safety, c.fac_min, c.fac_max,
        _METHOD_CODE[method], _DTYPE_CODE[march_dtype],
    ]
    return rays, dest, buf, scalars


# the index of max_iters among prepare's scalars
_MAX_ITERS = 10


def pointers(buf: dict) -> list:
    """Data pointers of the 21 buffers, in launch order."""
    return [buf[f].data_ptr() for f in F_FIELDS + I_FIELDS + B_FIELDS]


def finish(rays: RayBatch, buf: dict, dest, spin, refine_crossing: bool) -> RayBatch:
    """Cast the marched buffers back into the batch's dtype and run the
    theta-crossing refinement in plain torch."""
    upd = {f: buf[f].to(rays.r.dtype) for f in F_FIELDS}
    upd.update({f: buf[f] for f in I_FIELDS + B_FIELDS})
    out = rays.replace(**upd)
    return _refine_theta_crossing(out, dest, spin) if refine_crossing else out


def trace_kernel(
    rays: RayBatch,
    spin,
    *,
    method: str = "rk4",
    dest=None,
    r_max=1000.0,
    steplim: int = 30_000,
    ctrl: StepControl = StepControl(),
    boundary=None,
    max_iters: int | None = None,
    resume: bool = False,
    refine_crossing: bool = True,
    march_dtype=torch.float32,
) -> RayBatch:
    """CUDA-kernel twin of ``ops.integrate.trace`` (euler/rk4/rk45 with
    ThetaLimit, DiscWithISCO, FlatPlane or SphericalShell), with the same
    ``max_iters`` (here each ray's own iterations, default
    ``march_budget(steplim)``) and ``resume``.

    The batch must live on a CUDA device. Launches once on the current
    stream, under the instantiation's schedule (``schedule_of``), and does
    not synchronise; returns the same RayBatch contract as ``trace``, with
    the final theta-crossing back-interpolation.
    """
    return _trace(rays, spin, None, method=method, dest=dest, r_max=r_max, steplim=steplim,
                  ctrl=ctrl, boundary=boundary, max_iters=max_iters, resume=resume,
                  refine_crossing=refine_crossing, march_dtype=march_dtype)


def _trace(rays: RayBatch, spin, schedule, *, method, dest, r_max, steplim, ctrl, boundary,
           refine_crossing, march_dtype, max_iters=None, resume=False) -> RayBatch:
    """``trace_kernel`` under ``schedule``: None for the instantiation's
    own, else "grid" or "refill". chip_smoke.py and a cuda test pass one
    to hold the two schedules against each other; nothing else does."""
    _need_cuda(rays, "trace_kernel")
    with span("rt.march.prepare"):
        rays, dest, buf, scalars = prepare(
            rays, spin, method=method, dest=dest, r_max=r_max, steplim=steplim, ctrl=ctrl,
            boundary=boundary, march_dtype=march_dtype, resume=resume, max_iters=max_iters,
        )
    if rays.n_rays > 0:
        _launch(buf, scalars, schedule or schedule_of(method, dest, march_dtype))
    with span("rt.march.finish"):
        return finish(rays, buf, dest, spin, refine_crossing)


# the host's pause between two looks at the ranges still marching
_POLL_S = 1e-4

# ``trace_kernel_ranges``'s streams, by device: one a range, kept for the process
_STREAMS = {}


def _side_streams(device, k: int) -> list:
    """``k`` streams of ``device`` from the process's pool (``_STREAMS``)."""
    pool = _STREAMS.setdefault(device, [])
    pool.extend(torch.cuda.Stream(device) for _ in range(k - len(pool)))
    return pool[:k]


def trace_kernel_ranges(
    rays: RayBatch,
    spin,
    cuts,
    *,
    method: str = "rk4",
    dest=None,
    r_max=1000.0,
    steplim: int = 30_000,
    ctrl: StepControl = StepControl(),
    boundary=None,
    march_dtype=torch.float32,
):
    """``trace_kernel`` in ranges that land one at a time, so that the host
    can work on each range while the others still march: range k is the
    contiguous run ``rays[cuts[k]:cuts[k + 1]]`` (``cuts`` from 0 to the
    batch's ray count, no range empty), and the instantiation must run
    under the grid launch (``schedule_of``).

    The fresh-propagation set-up runs once on the whole batch
    (``prepare``); each range is then one launch on a slice of the buffers,
    on a stream of its own (``_side_streams``), followed there by an event
    and nothing else. Thread i of a launch marches its slice's ray i as the
    whole batch's launch marches it, so every ray has the single launch's
    bits. The launches are queued before this returns.

    Returns an iterator of (k0, k1, out, stream) in the order the ranges
    land, not in launch order: ranges k0 up to k1 landed together (their
    events fired by the same look), and ``out`` is their rays
    [cuts[k0], cuts[k1]) finished (``finish``, in the span
    ``rt.march.finish``), queued on ``stream``, where the caller queues
    what reads it; so ranges that land at once cost the host one step.
    Work queued behind a launch waits on it and holds up what is queued
    after it on the same host connection (CUDA_DEVICE_MAX_CONNECTIONS, 8
    by default, shared by the streams), so nothing is queued on a range's
    stream before it has landed. The iterator synchronises every stream
    when it ends or is closed, before the buffers are freed."""
    _need_cuda(rays, "trace_kernel_ranges")
    cuts = list(cuts)
    if cuts[0] != 0 or cuts[-1] != rays.n_rays or any(a >= b for a, b in zip(cuts, cuts[1:])):
        raise ValueError(f"ranges must run from 0 to {rays.n_rays} rays, none empty")
    if dest is None:
        dest = ThetaLimit(math.pi / 2)
    if schedule_of(method, dest, march_dtype) != "grid":
        raise ValueError(f"{method} towards {type(dest).__name__} in {march_dtype} runs under "
                         "the refill schedule; trace_kernel_ranges takes grid launches only")
    landed = _landing(rays, spin, cuts, method=method, dest=dest, r_max=r_max,
                      steplim=steplim, ctrl=ctrl, boundary=boundary, march_dtype=march_dtype)
    next(landed)  # prepares and launches every range
    return landed


def _landing(rays, spin, cuts, *, method, dest, r_max, steplim, ctrl, boundary, march_dtype):
    """``trace_kernel_ranges``: yields None once every range is launched,
    then each run of ranges as it lands."""
    with span("rt.march.prepare"):
        rays, dest, buf, scalars = prepare(
            rays, spin, method=method, dest=dest, r_max=r_max, steplim=steplim, ctrl=ctrl,
            boundary=boundary, march_dtype=march_dtype)
    device = rays.r.device
    streams = _side_streams(device, len(cuts) - 1)
    try:
        prepared = torch.cuda.Event()
        prepared.record(torch.cuda.current_stream(device))
        events = [torch.cuda.Event() for _ in streams]
        for s, event, a, b in zip(streams, events, cuts, cuts[1:]):
            s.wait_event(prepared)
            with torch.cuda.stream(s):
                _launch({f: v[a:b] for f, v in buf.items()}, [b - a] + scalars[1:], "grid")
            event.record(s)
        yield None

        pending = list(range(len(streams)))
        while pending:
            done = [k for k in pending if events[k].query()]
            if not done:
                time.sleep(_POLL_S)
                continue
            pending = [k for k in pending if k not in done]
            # the runs of adjacent ranges among those landed, each one slice
            firsts = [k for k in done if k - 1 not in done]
            for k0 in firsts:
                k1 = k0 + 1
                while k1 in done:
                    k1 += 1
                s, a, b = streams[k0], cuts[k0], cuts[k1]
                with torch.cuda.stream(s), span("rt.march.finish"):
                    out = finish(rays[a:b], {f: v[a:b] for f, v in buf.items()}, dest, spin,
                                 True)
                yield k0, k1, out, s
    finally:
        for s in streams:
            s.synchronize()


def _need_cuda(rays: RayBatch, name: str) -> None:
    if not rays.r.is_cuda:
        raise ValueError(f"{name} needs a batch on a CUDA device; "
                         "ops.integrate.trace is the plain version")


def trace_kernel_phased(
    rays: RayBatch,
    spin,
    *,
    method: str = "rk4",
    dest=None,
    r_max=1000.0,
    steplim: int = 30_000,
    ctrl: StepControl = StepControl(),
    boundary=None,
    phase_iters: int = 2048,
    march_dtype=torch.float32,
) -> RayBatch:
    """``trace_kernel`` with progress: the counterpart of the JAX
    ``trace_pallas_phased``.

    The fresh-propagation set-up runs once on the whole batch; then the
    kernel is launched in resume mode, ``phase_iters`` iterations a ray at
    a time (``ops.integrate.run_phases``), on the same buffers, which stay
    in the march dtype between launches, until no ray is active or the
    budget ``march_budget(steplim)`` is spent. Between launches the live
    rays are counted (one device sync) and a progress bar on stderr shows
    the iterations used and the live count. The theta crossing is refined
    once, at the end. A launch stops a ray where one launch of the budget
    would carry it on, so Euler and RK4 give that launch's bits; an RK45
    ray takes its rates afresh from its stored position at each boundary.
    The lanes run their own rays, so no survivor gather is needed.
    """
    _need_cuda(rays, "trace_kernel_phased")
    with span("rt.march.prepare"):
        rays, dest, buf, scalars = prepare(
            rays, spin, method=method, dest=dest, r_max=r_max, steplim=steplim, ctrl=ctrl,
            boundary=boundary, march_dtype=march_dtype,
        )
    schedule = schedule_of(method, dest, march_dtype)

    def phase(buf, iters):
        _launch(buf, scalars[:_MAX_ITERS] + [iters] + scalars[_MAX_ITERS + 1:], schedule)
        live = (buf["steps"] >= 0) & ((buf["status"] & RAY_STATUS_TERMINAL) == 0)
        return buf, int(live.sum())

    if rays.n_rays > 0:
        run_phases(buf, march_budget(steplim), phase_iters, phase,
                   label=f"march[{method}] {rays.n_rays} rays")
    with span("rt.march.finish"):
        return finish(rays, buf, dest, spin, refine_crossing=True)


def _launch(buf: dict, scalars: list, schedule: str) -> None:
    """One launch of the kernel on ``prepare``'s buffers and scalars under
    ``schedule`` ("grid" or "refill"), on the current stream of their
    device, counted in ``launches``, in the span ``rt.march.launch``
    (whose lane iterations the kernel counts while the recorder is on,
    ``utils.profiling``); raises on a CUDA error."""
    global launches
    with span("rt.march.launch"):
        lib = load()
        device = buf["r"].device
        # the refill schedule's ray counter, zero for every launch
        counter = (torch.zeros(1, dtype=torch.int64, device=device) if schedule == "refill"
                   else None)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.rt_march_launch(*pointers(buf), *scalars, _SCHEDULE_CODE[schedule],
                                      None if counter is None else counter.data_ptr(),
                                      launch_slot(device), stream)
    if err != 0:
        raise RuntimeError(f"rt_march_launch failed with CUDA error {err}")
    launches += 1
