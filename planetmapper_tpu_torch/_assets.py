"""Static asset paths (GUI icon etc.)."""

from __future__ import annotations

import os


def make_asset_path(filename: str) -> str:
    """Absolute path of a static asset file shipped with the package."""
    return os.path.join(os.path.dirname(__file__), 'assets', filename)


def get_gui_icon_path() -> str:
    """Path of the GUI window icon image."""
    return make_asset_path('gui_icon.png')
