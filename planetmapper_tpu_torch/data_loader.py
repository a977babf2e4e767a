"""
Static data loading (planetary ring radii from the NASA planetary
factsheets). API parity with the reference's ``planetmapper/data_loader.py``.
"""

from __future__ import annotations

import copy
import functools
import json
import os


def make_data_path(filename: str) -> str:
    """Absolute path of a static data file shipped with the package."""
    return os.path.join(os.path.dirname(__file__), 'data', filename)


def get_ring_radii() -> dict[str, dict[str, list[float]]]:
    """
    Planetary ring radii in km, keyed by planet name then ring name. A
    two-element list gives inner and outer radii; a one-element list a
    single radius. Values sourced from
    https://nssdc.gsfc.nasa.gov/planetary/planetfact.html.
    """
    return copy.deepcopy(_get_ring_radii_data())


@functools.cache
def _get_ring_radii_data() -> dict[str, dict[str, list[float]]]:
    with open(make_data_path('rings.json'), encoding='utf-8') as f:
        return json.load(f)


def get_ring_aliases() -> dict[str, str]:
    """
    ASCII aliases for accented ring names (lower case), e.g. ``liberte`` ->
    ``liberté``.
    """
    return copy.deepcopy(_get_ring_aliases_data())


@functools.cache
def _get_ring_aliases_data() -> dict[str, str]:
    with open(make_data_path('ring_aliases.json'), encoding='utf-8') as f:
        return json.load(f)
