"""Minimal HEALPix (RING order) pixel geometry, no external dependency.

The port's own copy of ``raytrace_tpu/geometry/healpix.py`` (numpy, host
side; the port imports nothing of the JAX package). Capability of the
reference ``src/include/healpix.h``: RING pixel index ->
face coordinates -> unit direction vector, with the reference's +0.05 rad
azimuthal twist that stops pixel boundaries aligning with the coordinate
axes, and the 4-corner + centre bundle per pixel used for solid-angle
transport. Implemented vectorised in numpy (host-side source setup; the
pixelisation is standard HEALPix, Gorski et al. 2005).
"""

from __future__ import annotations

import numpy as np

_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4])
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7])

PHI_TWIST = 0.05  # rad; healpix.h:37-39


def n_pixels(order: int) -> int:
    nside = 1 << order
    return 12 * nside * nside


def ring_to_xyf(order: int, pix):
    """RING pixel indices -> (x, y, face) face coordinates (healpix.h:45-104)."""
    pix = np.asarray(pix, dtype=np.int64)
    nside = 1 << order
    nl2 = 2 * nside
    npface = nside << order
    ncap = (npface - nside) << 1
    npix = 12 * npface

    ix = np.zeros(pix.shape, dtype=np.int64)
    iy = np.zeros(pix.shape, dtype=np.int64)
    face = np.zeros(pix.shape, dtype=np.int64)

    isqrt = lambda v: np.sqrt(v + 0.5).astype(np.int64)

    north = pix < ncap
    equa = (pix >= ncap) & (pix < npix - ncap)
    south = pix >= npix - ncap

    iring = np.zeros_like(pix)
    iphi = np.zeros_like(pix)
    kshift = np.zeros_like(pix)
    nr = np.zeros_like(pix)

    # North polar cap
    p = pix[north]
    ir = (1 + isqrt(1 + 2 * p)) >> 1
    iring[north] = ir
    iphi[north] = (p + 1) - 2 * ir * (ir - 1)
    nr[north] = ir
    face[north] = (iphi[north] - 1) // ir

    # Equatorial region
    p = pix[equa] - ncap
    tmp = p >> (order + 2)
    ir = tmp + nside
    ip = p - tmp * 4 * nside + 1
    iring[equa] = ir
    iphi[equa] = ip
    kshift[equa] = (ir + nside) & 1
    nr[equa] = nside
    ire = ir - nside + 1
    irm = nl2 + 2 - ire
    ifm = (ip - ire // 2 + nside - 1) >> order
    ifp = (ip - irm // 2 + nside - 1) >> order
    face[equa] = np.where(ifp == ifm, ifp | 4, np.where(ifp < ifm, ifp, ifm + 8))

    # South polar cap
    p = npix - pix[south]
    ir = (1 + isqrt(2 * p - 1)) >> 1
    iphi[south] = 4 * ir + 1 - (p - 2 * ir * (ir - 1))
    nr[south] = ir
    face[south] = 8 + (iphi[south] - 1) // ir
    iring[south] = 2 * nl2 - ir

    irt = iring - _JRLL[face] * nside
    ipt = 2 * iphi - _JPLL[face] * nr - kshift - 1
    ipt = np.where(ipt >= nl2, ipt - 8 * nside, ipt)

    ix = (ipt - irt) >> 1
    iy = (-ipt - irt) >> 1
    return ix, iy, face


def xyf_to_vec(x, y, face):
    """Face coordinates -> unit vectors with the phi twist (healpix.h:11-42)."""
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    face = np.asarray(face, dtype=np.int64)

    jr = _JRLL[face] - x - y
    nr = np.where(jr < 1, jr, np.where(jr > 3, 4 - jr, 1.0))
    z = np.where(
        jr < 1,
        1.0 - jr * jr / 3.0,
        np.where(jr > 3, (4 - jr) ** 2 / 3.0 - 1.0, (2.0 - jr) * 2.0 / 3.0),
    )
    tmp = _JPLL[face] * nr + x - y
    tmp = np.where(tmp < 0, tmp + 8, tmp)
    tmp = np.where(tmp >= 8, tmp - 8, tmp)
    phi = np.where(nr < 1e-15, 0.0, (0.25 * np.pi * tmp) / np.where(nr == 0, 1, nr))

    sin_theta = np.sqrt((1.0 - z) * (1.0 + z))
    return np.stack(
        [
            sin_theta * np.cos(phi + PHI_TWIST),
            sin_theta * np.sin(phi + PHI_TWIST),
            z,
        ],
        axis=-1,
    )


def pixel_vectors(order: int):
    """Corner and centre unit vectors of every RING pixel.

    Returns (corners[npix, 4, 3], centres[npix, 3]); the centre is the
    corner average as in the reference (healpix.h:130-133).
    """
    pix = np.arange(n_pixels(order))
    ix, iy, face = ring_to_xyf(order, pix)
    nside = 1 << order
    dc = 0.5 / nside
    xc = (ix + 0.5) / nside
    yc = (iy + 0.5) / nside
    corners = np.stack(
        [
            xyf_to_vec(xc + dc, yc + dc, face),
            xyf_to_vec(xc - dc, yc + dc, face),
            xyf_to_vec(xc - dc, yc - dc, face),
            xyf_to_vec(xc + dc, yc - dc, face),
        ],
        axis=1,
    )
    centres = corners.mean(axis=1)
    return corners, centres
