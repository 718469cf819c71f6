"""Struct-of-arrays ray batch, in PyTorch.

Counterpart of ``raytrace_tpu/rays.py``: the same 24 per-ray fields, status
bits and ``active``/``ok`` semantics, as a dataclass of ``[N]`` tensors.
Floating fields share one dtype; ``steps``/``status``/counters are int32 and
the two sign-flip gates are bool. Every constructor takes an explicit
``device`` and ``dtype``; nothing here changes torch's global defaults.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Ray status bit flags (raytracer.h:57-63). Combinable with bitwise OR.
RAY_STATUS_DEST = 1 << 0  # reached destination surface / polar-angle limit
RAY_STATUS_HORIZON = 1 << 1  # fell through the event horizon
RAY_STATUS_RLIM = 1 << 2  # reached the outer radial limit
RAY_STATUS_STEPLIM = 1 << 3  # exceeded the maximum step count (stuck)
RAY_STATUS_ERGO = 1 << 4  # p^t <= 0 inside the ergosphere (non-physical)
RAY_STATUS_NEG_ENERGY = 1 << 5  # negative Killing energy (non-physical)
RAY_STATUS_NUMERIC = 1 << 6  # rates over/underflowed the working dtype

RAY_STATUS_TERMINAL = (
    RAY_STATUS_DEST
    | RAY_STATUS_HORIZON
    | RAY_STATUS_RLIM
    | RAY_STATUS_STEPLIM
    | RAY_STATUS_NUMERIC
)

FLOAT_FIELDS = (
    "t", "r", "theta", "phi", "pt", "pr", "ptheta", "pphi", "k", "h", "Q",
    "rdot_sign", "thetadot_sign", "dt", "emit", "redshift", "alpha", "beta",
)
INT_FIELDS = ("steps", "status", "rdot_flips", "equatorial_crossings")
BOOL_FIELDS = ("r_was_positive", "theta_was_positive")


@dataclasses.dataclass
class RayBatch:
    """Batched ray state: every field is a ``[N]`` tensor.

    ``steps`` keeps the reference conventions: -1 marks a dead/padding ray
    that is never traced (pointsource.cpp:42), and rays that hit the step
    limit have their count negated so ``steps > 0`` filters drop them
    (raytracer.cpp:336-337).
    """

    # position
    t: torch.Tensor
    r: torch.Tensor
    theta: torch.Tensor
    phi: torch.Tensor
    # contravariant momentum (last evaluated)
    pt: torch.Tensor
    pr: torch.Tensor
    ptheta: torch.Tensor
    pphi: torch.Tensor
    # constants of motion
    k: torch.Tensor
    h: torch.Tensor
    Q: torch.Tensor
    # signed square-root bookkeeping (+-1, in the float dtype)
    rdot_sign: torch.Tensor
    thetadot_sign: torch.Tensor
    # sign-flip gates (raytracer.cpp:137-138,196-220)
    r_was_positive: torch.Tensor  # bool
    theta_was_positive: torch.Tensor  # bool
    # adaptive integrator step size (DOPRI5 controller state)
    dt: torch.Tensor
    # diagnostics
    steps: torch.Tensor  # int32
    status: torch.Tensor  # int32 bitmask
    rdot_flips: torch.Tensor  # int32
    equatorial_crossings: torch.Tensor  # int32
    # energies for redshift
    emit: torch.Tensor
    redshift: torch.Tensor
    # source-grid coordinates (cos(alpha)/beta for point sources)
    alpha: torch.Tensor
    beta: torch.Tensor

    def replace(self, **kw) -> "RayBatch":
        return dataclasses.replace(self, **kw)

    @property
    def n_rays(self) -> int:
        return self.r.shape[-1]

    @property
    def active(self) -> torch.Tensor:
        """Rays eligible for (further) propagation: steps >= 0 and no
        terminal status bit set."""
        return (self.steps >= 0) & ((self.status & RAY_STATUS_TERMINAL) == 0)

    @property
    def ok(self) -> torch.Tensor:
        """Rays that completed normally (the reference's ``steps > 0`` filter)."""
        return self.steps > 0

    def to(self, device=None, dtype=None) -> "RayBatch":
        """Move every field to ``device`` and cast the float fields to ``dtype``."""
        upd = {}
        for f in FLOAT_FIELDS:
            upd[f] = getattr(self, f).to(device=device, dtype=dtype)
        for f in INT_FIELDS + BOOL_FIELDS:
            upd[f] = getattr(self, f).to(device=device)
        return self.replace(**upd)


def blank_batch(n: int, *, device, dtype=torch.float64) -> RayBatch:
    """An all-dead batch of n rays (steps = -1), to be filled by a source."""
    zeros = lambda: torch.zeros(n, dtype=dtype, device=device)
    ones = lambda: torch.ones(n, dtype=dtype, device=device)
    izeros = lambda: torch.zeros(n, dtype=torch.int32, device=device)
    return RayBatch(
        t=zeros(), r=zeros(), theta=zeros(), phi=zeros(),
        pt=zeros(), pr=zeros(), ptheta=zeros(), pphi=zeros(),
        k=zeros(), h=zeros(), Q=zeros(),
        rdot_sign=ones(), thetadot_sign=ones(),
        r_was_positive=torch.zeros(n, dtype=torch.bool, device=device),
        theta_was_positive=torch.ones(n, dtype=torch.bool, device=device),
        dt=zeros(),
        steps=izeros() - 1, status=izeros(), rdot_flips=izeros(),
        equatorial_crossings=izeros(),
        emit=ones(), redshift=ones(), alpha=zeros(), beta=zeros(),
    )


def from_numpy(arrays: dict, *, device, dtype=torch.float64) -> RayBatch:
    """Build a batch from a ``{field: array}`` mapping holding all 24 fields.

    Float fields are cast to ``dtype``, counters to int32, gates to bool —
    so a batch exported from the JAX package (``{f: np.asarray(getattr(b,
    f))}``) marches from bit-identical state.
    """
    upd = {}
    for f in FLOAT_FIELDS:
        upd[f] = torch.as_tensor(np.array(arrays[f]), device=device).to(dtype)
    for f in INT_FIELDS:
        upd[f] = torch.as_tensor(np.asarray(arrays[f]).astype(np.int32), device=device)
    for f in BOOL_FIELDS:
        upd[f] = torch.as_tensor(np.asarray(arrays[f]).astype(bool), device=device)
    return RayBatch(**upd)


def to_numpy(batch: RayBatch) -> dict:
    """The batch as a ``{field: numpy array}`` mapping (host copies)."""
    return {
        f.name: getattr(batch, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(batch)
    }
