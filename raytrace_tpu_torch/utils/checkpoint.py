"""Checkpoint and resume of a ray batch in flight.

Counterpart of ``raytrace_tpu/utils/checkpoint.py``, in its NPZ layout: one
array ``field_<name>`` for each of the batch's 24 fields, ``meta_<name>``
for each metadata value and ``checkpoint_version`` = 1. A checkpoint
written by either package loads in the other. With ``trace(...,
resume=True)`` (or ``trace_kernel``'s) a march can be suspended and resumed
in another process or on another device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytrace_tpu_torch.rays import RayBatch

_VERSION = 1


def save_rays(path: str, rays: RayBatch, **metadata):
    """Write the batch, and any scalar metadata, to an NPZ at ``path``."""
    payload = {f"field_{f.name}": getattr(rays, f.name).detach().cpu().numpy()
               for f in dataclasses.fields(rays)}
    payload["checkpoint_version"] = np.asarray(_VERSION)
    for k, v in metadata.items():
        payload[f"meta_{k}"] = np.asarray(v)
    np.savez_compressed(path, **payload)


def load_rays(path: str, *, device) -> tuple[RayBatch, dict]:
    """Read a checkpoint onto ``device``; returns (rays, metadata), the
    fields in the dtypes they were written in and the metadata as numpy
    values. Raises ``ValueError`` on another checkpoint version."""
    with np.load(path) as data:
        version = int(data["checkpoint_version"])
        if version != _VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        fields, meta = {}, {}
        for key in data.files:
            if key.startswith("field_"):
                fields[key[len("field_"):]] = torch.as_tensor(data[key], device=device)
            elif key.startswith("meta_"):
                meta[key[len("meta_"):]] = data[key]
    return RayBatch(**fields), meta
