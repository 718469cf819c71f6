"""Ray sources (torch)."""

from raytrace_tpu_torch.sources.imageplane import ImagePlaneGrid, image_plane
from raytrace_tpu_torch.sources.pointsource import PointSourceGrid, point_source

__all__ = ["ImagePlaneGrid", "PointSourceGrid", "image_plane", "point_source"]
