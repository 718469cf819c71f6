"""Data parallelism over the ray batch (the workload's only parallel axis),
over ``torch.distributed``."""

from raytrace_tpu_torch.parallel.sharding import (
    RayMesh,
    auto_mesh,
    make_ray_mesh,
    pad_rays,
    shard_rays,
    sharded_caustic_trace,
    sharded_disc_image,
    sharded_emissivity_bins,
    sharded_emissivity_gradient,
    sharded_line_profile_fit_step,
    sharded_trace,
)

__all__ = [
    "RayMesh",
    "make_ray_mesh",
    "auto_mesh",
    "pad_rays",
    "shard_rays",
    "sharded_trace",
    "sharded_disc_image",
    "sharded_caustic_trace",
    "sharded_emissivity_bins",
    "sharded_emissivity_gradient",
    "sharded_line_profile_fit_step",
]
