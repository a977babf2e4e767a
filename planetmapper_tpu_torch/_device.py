"""
Device choice for the port.

The pixel pipeline runs on ``cuda`` when a card is present and on ``cpu``
otherwise. The choice is made once, where a :class:`BodyXY` is built (or
where the caller passes ``device=``), and travels with the object: no
module reads a global device. Scene work (ephemerides, frame rotations,
anchors) is a chain of scalar programs and always runs on CPU tensors,
where each step costs no kernel launch.
"""

from __future__ import annotations

import torch

#: Device of every scene-level tensor (see the module docstring).
SCENE_DEVICE = torch.device('cpu')


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` picks cuda if present."""
    if device is None:
        return torch.device('cuda' if torch.cuda.is_available() else 'cpu')
    return torch.device(device)


def f64(x, device: torch.device = SCENE_DEVICE) -> torch.Tensor:
    """``x`` (number, numpy array or tensor) as a float64 tensor."""
    return torch.as_tensor(x, dtype=torch.float64, device=device)
