"""The geodesic march as a hand-written CUDA kernel for Hopper.

Counterpart of ``raytrace_tpu/ops/pallas_kernel.py::trace_pallas``: the
kernel (``csrc/march.cu`` on the per-ray step of ``csrc/march.cuh``)
marches every ray to termination in registers, one thread per ray, for
``euler``, ``rk4`` and ``rk45`` with the ``ThetaLimit``/``FlatDisc``
destination and ``rk4`` and ``rk45`` with ``DiscWithISCO``, in float32 (the
default, as on the TPU) or float64. The plain version is
``ops/integrate.py::trace``; ``ops.trace_auto`` picks one of the two by the
device of the batch.

The kernel is compiled on first use with nvcc into ``_build/`` next to the
package (rebuilt when a source is newer than the library) and loaded with
ctypes. A missing nvcc or a failed build raises; nothing here falls back to
the plain version.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

from raytrace_tpu_torch.destinations import DiscWithISCO, ThetaLimit
from raytrace_tpu_torch.geometry.kerr import horizon_radius
from raytrace_tpu_torch.ops.integrate import (
    StepControl,
    _fresh_propagation_state,
    _refine_theta_crossing,
)
from raytrace_tpu_torch.rays import RayBatch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_LIB = BUILD_DIR / "libraytrace_march.so"
_SOURCES = (CSRC / "march.cu", CSRC / "march.cuh")

# The 21 arrays the kernel marches, in the order of rt_march_launch.
F_FIELDS = (
    "t", "r", "theta", "phi", "pt", "pr", "ptheta", "pphi",
    "k", "h", "Q", "rdot_sign", "thetadot_sign", "dt", "emit",
)
I_FIELDS = ("steps", "status", "rdot_flips", "equatorial_crossings")
B_FIELDS = ("r_was_positive", "theta_was_positive")

_METHOD_CODE = {"rk4": 1, "rk45": 2, "euler": 3}
_DEST_THETA, _DEST_ISCO = 0, 1
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

# Kernel launches so far: counted where the kernel is launched, nowhere else.
launches = 0

_lib = None


def argtypes(stream: bool = True):
    """ctypes argument list of rt_march_launch (without the trailing stream
    for the host build's rt_march_host): 21 pointers, n, spin, r_max,
    horizon, the destination code and its three parameters, steplim,
    max_iters, the 11 StepControl values, method and dtype."""
    c = ctypes
    types = [c.c_void_p] * 21 + [c.c_int64] + [c.c_double] * 3 + [c.c_int]
    types += [c.c_double] * 3 + [c.c_int] * 2 + [c.c_double] * 11 + [c.c_int, c.c_int]
    return types + [c.c_void_p] if stream else types


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: cannot build the march kernel")


def build(force: bool = False) -> str:
    """Compile ``csrc/march.cu`` for sm_90a into ``_build/libraytrace_march.so``
    unless the library is newer than its sources. No FMA contraction
    (``--fmad=false``), so the kernel rounds like the plain march; see the
    note in march.cu. Returns nvcc's output
    (``-Xptxas -v``: registers and spills per kernel), empty when the
    library was up to date."""
    if not force and _LIB.exists():
        if _LIB.stat().st_mtime >= max(s.stat().st_mtime for s in _SOURCES):
            return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{_LIB.name}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(tmp), str(CSRC / "march.cu"),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, _LIB)
    return proc.stdout + proc.stderr


def load():
    """The kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(_LIB))
        lib.rt_march_launch.argtypes = argtypes(stream=True)
        lib.rt_march_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def prepare(rays: RayBatch, spin, *, method, dest, r_max, steplim, ctrl: StepControl,
            boundary, march_dtype):
    """Fresh-propagation setup, then the 21 marched fields as fresh
    contiguous buffers (floats in ``march_dtype``, counters int32, gates
    bool) and the scalar arguments of the launch. Raises on anything the
    kernel does not take."""
    if method not in _METHOD_CODE:
        raise NotImplementedError(f"march kernel supports euler, rk4 and rk45, got {method!r}")
    if dest is None:
        dest = ThetaLimit(math.pi / 2)
    if type(dest) is ThetaLimit:
        dest_args = [_DEST_THETA, float(dest.theta_lim), 0.0, 0.0]
    elif type(dest) is DiscWithISCO and method != "euler":
        dest_args = [_DEST_ISCO, float(dest.r_isco), float(dest.r_out), float(dest.theta_lim)]
    else:
        raise NotImplementedError(
            "march kernel supports ThetaLimit with euler/rk4/rk45 and DiscWithISCO with "
            f"rk4/rk45, got {type(dest).__name__} with {method}")
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
    rays = _fresh_propagation_state(rays, spin, horizon, method, ctrl)
    max_iters = steplim + steplim // 4 + 16

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
    refine_crossing: bool = True,
    march_dtype=torch.float32,
) -> RayBatch:
    """CUDA-kernel twin of ``ops.integrate.trace`` (euler/rk4/rk45 with
    ThetaLimit, rk4/rk45 with DiscWithISCO).

    The batch must live on a CUDA device. Launches once on the current
    stream and does not synchronise; returns the same RayBatch contract as
    ``trace``, with the final theta-crossing back-interpolation.
    """
    global launches
    if not rays.r.is_cuda:
        raise ValueError("trace_kernel needs a batch on a CUDA device; "
                         "ops.integrate.trace is the plain version")
    rays, dest, buf, scalars = prepare(
        rays, spin, method=method, dest=dest, r_max=r_max, steplim=steplim, ctrl=ctrl,
        boundary=boundary, march_dtype=march_dtype,
    )
    if rays.n_rays > 0:
        lib = load()
        device = rays.r.device
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.rt_march_launch(*pointers(buf), *scalars, stream)
        if err != 0:
            raise RuntimeError(f"rt_march_launch failed with CUDA error {err}")
        launches += 1
    return finish(rays, buf, dest, spin, refine_crossing)
