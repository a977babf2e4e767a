"""
Synthetic observation files for ``chip_smoke.py``, the card tests and the
timing scripts: a cube of frames with a bright disc on noise, written with
the port's own FITS writer under a header that names the target, the time
and the observer, and a celestial WCS that puts the target's centre, size
and rotation on a given disc; and a reader of the files they save.
"""

from __future__ import annotations

import numpy as np

from .. import BodyXY
from ..io import fits

#: Added to each frame inside the disc, so that the disc fits find it
DISC_BRIGHTNESS = 5.0


def disc_cube(cube: np.ndarray, disc) -> np.ndarray:
    """``cube`` (frames of noise) with :data:`DISC_BRIGHTNESS` added inside
    the circle of radius r0 about (x0, y0) of ``disc``."""
    yy, xx = np.mgrid[0:cube.shape[-2], 0:cube.shape[-1]]
    inside = np.hypot(xx - disc[0], yy - disc[1]) < disc[2]
    return cube + DISC_BRIGHTNESS * inside


def wcs_cards(body: BodyXY, projection: str = 'TAN') -> list[tuple]:
    """
    WCS cards of a ``projection`` celestial WCS (CRPIX, CRVAL, CD) whose
    reference pixel is ``body``'s disc centre at the target's RA/Dec, and
    whose CD matrix is the body's RA/Dec step per pixel there (RA scaled by
    cos Dec): the WCS puts the disc where the body has it.
    """
    x0, y0 = body.get_x0(), body.get_y0()
    ra0, dec0 = body.target_ra, body.target_dec
    cd = np.empty((2, 2))
    for j, (dx, dy) in enumerate(((1.0, 0.0), (0.0, 1.0))):
        ra, dec = body.xy2radec(x0 + dx, y0 + dy)
        cd[0, j] = (ra - ra0) * np.cos(np.radians(dec0))
        cd[1, j] = dec - dec0
    return [
        ('CTYPE1', f'RA---{projection}'), ('CTYPE2', f'DEC--{projection}'),
        ('CUNIT1', 'deg'), ('CUNIT2', 'deg'),
        ('CRPIX1', x0 + 1), ('CRPIX2', y0 + 1),
        ('CRVAL1', float(ra0)), ('CRVAL2', float(dec0)),
        ('CD1_1', float(cd[0, 0])), ('CD1_2', float(cd[0, 1])),
        ('CD2_1', float(cd[1, 0])), ('CD2_2', float(cd[1, 1])),
    ]


def write_observation(path, cube: np.ndarray, disc, utc: str,
                      target: str = 'JUPITER',
                      observer: str = 'EARTH') -> None:
    """Write ``cube`` to ``path`` as a FITS observation of ``target`` at
    ``utc`` seen from ``observer``, with a TAN WCS that puts the target on
    ``disc`` (a CPU BodyXY computes the cards)."""
    ny, nx = cube.shape[-2:]
    body = BodyXY(target, utc=utc, observer=observer, nx=nx, ny=ny,
                  device='cpu')
    body.set_disc_params(*disc)
    header = fits.Header([('OBJECT', target), ('DATE-OBS', utc),
                          ('TELESCOP', observer)] + wcs_cards(body))
    fits.HDUList([fits.PrimaryHDU(cube, header)]).writeto(path,
                                                           overwrite=True)


def read_fits(path) -> tuple[list, list, list]:
    """``(names, headers, data)`` of every HDU of a file, read with the
    port's reader."""
    with fits.open(path) as hdul:
        return ([h.name for h in hdul], [h.header for h in hdul],
                [h.data for h in hdul])
