"""Kerr geometry, tetrads and disc areas (torch)."""

from raytrace_tpu_torch.geometry.disc import integrate_disc_area_bins
from raytrace_tpu_torch.geometry.kerr import horizon_radius, isco_radius

__all__ = ["horizon_radius", "integrate_disc_area_bins", "isco_radius"]
