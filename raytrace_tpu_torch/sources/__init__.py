"""Ray sources (torch)."""

from raytrace_tpu_torch.sources.pointsource import PointSourceGrid, point_source

__all__ = ["PointSourceGrid", "point_source"]
