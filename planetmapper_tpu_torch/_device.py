"""
Device choice for the port.

The pixel pipeline runs on ``cuda`` unless the caller asks for the CPU
with ``device='cpu'``; without a card and without ``device=``, building a
:class:`BodyXY` raises rather than carrying on on the CPU. The choice is
made once, where a :class:`BodyXY` is built, and travels with the object:
no module reads a global device. Scene work (ephemerides, frame rotations,
anchors) is a chain of scalar programs and always runs on CPU tensors,
where each step costs no kernel launch.
"""

from __future__ import annotations

import torch

#: Device of every scene-level tensor (see the module docstring).
SCENE_DEVICE = torch.device('cpu')


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """
    ``device`` as a :class:`torch.device`. ``None`` means ``cuda`` and raises
    when no CUDA device is present: the CPU is taken only when asked for.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available: the port runs on the card by '
                "default; pass device='cpu' to run on the CPU"
            )
        return torch.device('cuda')
    return torch.device(device)


def f64(x, device: torch.device = SCENE_DEVICE) -> torch.Tensor:
    """``x`` (number, numpy array or tensor) as a float64 tensor."""
    return torch.as_tensor(x, dtype=torch.float64, device=device)
