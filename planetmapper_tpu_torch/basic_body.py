"""
Point-source body (port of planetmapper_tpu.basic_body; parity with
planetmapper/basic_body.py).
"""

from __future__ import annotations

import datetime
from typing import Any

from .base import BodyBase


class BasicBody(BodyBase):
    """
    Astronomical body treated as a point source (e.g. minor satellites
    without radii data in the loaded kernels). Returned by
    :func:`Body.create_other_body` when a full :class:`Body` cannot be
    constructed; only position attributes (``target_ra``/``target_dec``/
    ``target_distance``/``target_light_time``) are available.
    """

    def __init__(
        self,
        target: str | int,
        utc: str | datetime.datetime | float | None = None,
        observer: str | int = 'EARTH',
        *,
        aberration_correction: str = 'CN',
        observer_frame: str = 'J2000',
        **kwargs,
    ) -> None:
        # Accept and discard Body-only arguments so the signature is
        # interchangeable with Body (matching the reference behaviour).
        for k in ('illumination_source', 'subpoint_method', 'surface_method'):
            kwargs.pop(k, None)
        super().__init__(
            target=target,
            utc=utc,
            observer=observer,
            aberration_correction=aberration_correction,
            observer_frame=observer_frame,
            **kwargs,
        )

    def __repr__(self) -> str:
        return self._generate_repr('target', 'utc', kwarg_keys=['observer'])

    def _get_equality_tuple(self) -> tuple:
        return (super()._get_equality_tuple(),)

    @classmethod
    def _get_default_init_kwargs(cls) -> dict[str, Any]:
        return dict(
            observer='EARTH',
            aberration_correction='CN',
            observer_frame='J2000',
            **super()._get_default_init_kwargs(),
        )
