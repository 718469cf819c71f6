"""Ray sources (torch)."""

from raytrace_tpu_torch.sources.imageplane import ImagePlaneGrid, image_plane, image_plane_bundles
from raytrace_tpu_torch.sources.pointsource import PointSourceGrid, point_source

__all__ = ["ImagePlaneGrid", "PointSourceGrid", "image_plane", "image_plane_bundles",
           "point_source"]
