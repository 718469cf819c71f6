"""Ray sources (torch)."""

from raytrace_tpu_torch.sources.healpix_source import healpix_point_source
from raytrace_tpu_torch.sources.imageplane import ImagePlaneGrid, image_plane, image_plane_bundles
from raytrace_tpu_torch.sources.moving import (
    jet_point_source,
    point_source_vel,
    radial_four_velocity,
)
from raytrace_tpu_torch.sources.pointsource import (
    PointSourceGrid,
    grid_angles,
    point_source,
    point_source_from_angles,
)

__all__ = ["ImagePlaneGrid", "PointSourceGrid", "grid_angles", "healpix_point_source",
           "image_plane", "image_plane_bundles", "jet_point_source", "point_source",
           "point_source_from_angles", "point_source_vel", "radial_four_velocity"]
