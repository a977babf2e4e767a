"""Warnings and exceptions (parity with planetmapper/exceptions.py)."""

from __future__ import annotations

import os
import sys
import warnings


class PlanetmapperWarning(Warning):
    """Base class for all warnings raised by planetmapper_tpu_torch."""


def warn(message: str, *, category: type[Warning] = PlanetmapperWarning) -> None:
    """
    Emit a warning attributed to the calling user code (frames inside this
    package are skipped where the Python version supports it).
    """
    if sys.version_info >= (3, 12):
        warnings.warn(
            message,
            category=category,
            skip_file_prefixes=(os.path.dirname(__file__),),
        )
    else:  # pragma: no cover - depends on interpreter version
        warnings.warn(message, category=category, stacklevel=2)
