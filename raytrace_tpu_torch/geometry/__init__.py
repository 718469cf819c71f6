"""Kerr geometry, tetrads and disc areas (torch)."""

from raytrace_tpu_torch.geometry.disc import (
    coordinate_disc_area,
    integrate_disc_area,
    integrate_disc_area_bins,
    plunge_velocity,
)
from raytrace_tpu_torch.geometry.gramschmidt import gram_schmidt_tetrad
from raytrace_tpu_torch.geometry.kerr import (
    bl_to_cartesian,
    circular_orbit_velocity,
    constants_from_angles,
    constants_from_frame,
    constants_from_p,
    geodesic_rates,
    horizon_radius,
    isco_radius,
    keplerian_omega,
    lorentz_factor,
    metric_coeffs,
    metric_dot,
    momentum_from_consts,
    orbit_tetrad,
)

__all__ = [
    "bl_to_cartesian",
    "circular_orbit_velocity",
    "constants_from_angles",
    "constants_from_frame",
    "constants_from_p",
    "coordinate_disc_area",
    "geodesic_rates",
    "gram_schmidt_tetrad",
    "horizon_radius",
    "integrate_disc_area",
    "integrate_disc_area_bins",
    "isco_radius",
    "keplerian_omega",
    "lorentz_factor",
    "metric_coeffs",
    "metric_dot",
    "momentum_from_consts",
    "orbit_tetrad",
    "plunge_velocity",
]
