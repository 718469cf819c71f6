"""HEALPix point source: solid-angle-uniform emission with corner bundles.

Counterpart of ``raytrace_tpu/sources/healpix_source.py`` (the reference's
HealpixPointSource, healpix_pointsource.cpp): 5 rays a HEALPix pixel, its
centre and 4 corners, so each pixel carries an exactly equal solid angle.
The source frame is static, azimuthally orbiting or radially moving; the
disc-source mode keeps the hemisphere above the disc only
(healpix_pointsource.h:39-43).
"""

from __future__ import annotations

import numpy as np
import torch

from raytrace_tpu_torch.geometry.gramschmidt import gram_schmidt_tetrad
from raytrace_tpu_torch.geometry.healpix import n_pixels, pixel_vectors
from raytrace_tpu_torch.geometry.kerr import Tetrad, constants_from_frame, orbit_tetrad
from raytrace_tpu_torch.rays import RayBatch, blank_batch
from raytrace_tpu_torch.sources.moving import radial_four_velocity


def healpix_point_source(pos, spin, order: int = 3, V=0.0, v_radial=None,
                         disc_source: bool = False, basis: int = 0, E=1.0, *, device,
                         dtype=torch.float64) -> tuple[RayBatch, int]:
    """The 5 x npix ray batch and npix.

    Rays are slot-major, [centre, c0, c1, c2, c3] x pixels (ray slot * npix
    + pix), as the image-plane bundles are laid out.

    Args:
      V: azimuthal angular velocity of the source (ignored when v_radial
        is given).
      v_radial: the source moves radially at dr/dt = v_radial.
      disc_source: emit only into the hemisphere above the disc; the rays
        of the lower half are dead (steps = -1).
      basis: 1 for the reference's alternate frame orientation (local y
        drives the negated radial leg, local z the theta leg).
    """
    npix = n_pixels(order)
    corners, centres = pixel_vectors(order)  # numpy [npix, 4, 3], [npix, 3]
    vecs = np.concatenate([centres[None, :, :], np.moveaxis(corners, 1, 0)], axis=0)
    vecs = torch.as_tensor(vecs.reshape(-1, 3), device=device).to(dtype)  # [5 npix, 3]
    vx, vy, vz = vecs[:, 0], vecs[:, 1], vecs[:, 2]
    if basis == 1:
        vx, vy, vz = vx, vz, -vy

    t0, r0, th0, ph0 = (float(p) for p in pos)
    r0_t = torch.tensor(r0, dtype=dtype, device=device)
    th0_t = torch.tensor(th0, dtype=dtype, device=device)
    if v_radial is not None:
        v = torch.tensor(float(v_radial), dtype=dtype, device=device)
        tet = gram_schmidt_tetrad(r0_t, th0_t, radial_four_velocity(r0_t, th0_t, v, spin), spin)
    else:
        tet = orbit_tetrad(r0_t, th0_t, spin, torch.tensor(float(V), dtype=dtype, device=device))
        # the reference's negative-theta e2 orientation
        tet = Tetrad(et=tet.et, ephi=tet.ephi, etheta=tuple(-c for c in tet.etheta), er=tet.er)

    full = lambda x: torch.full_like(vx, x)
    r = full(r0)
    theta = full(th0)
    c = constants_from_frame(r, theta, tet, vx, vy, vz, spin, E)

    # local (x, y, z) -> (phi leg, theta leg, r leg); the theta leg points
    # to smaller theta, so vy > 0 is up, away from the disc plane
    dead = vy < 0 if disc_source else torch.zeros_like(vx, dtype=torch.bool)
    base = blank_batch(5 * npix, device=device, dtype=dtype)
    return base.replace(
        t=full(t0), r=r, theta=theta, phi=full(ph0),
        k=c.k, h=c.h, Q=c.Q, rdot_sign=c.rdot_sign, thetadot_sign=c.thetadot_sign,
        steps=torch.where(dead, -1, 0).to(torch.int32),
        alpha=vz,  # the local polar direction cosine
        beta=torch.atan2(vy, vx),
    ), npix
