"""
Device choice for the port.

The pixel pipeline and the map reprojection run on ``cuda`` unless the
caller asks for the CPU with ``device='cpu'``; without a card and without
``device=``, building a :class:`BodyXY` raises rather than carrying on on
the CPU. The choice is made once, where a :class:`BodyXY` is built, and
travels with the object: no module reads a global device.

Scene work (ephemerides, frame rotations, light-time loops) follows one
rule, :func:`scene_device`, the JAX package's (``planetmapper_tpu/core/
scene.py`` dispatch, ``_SMALL_CALL_ELEMENTS``): a call with any argument of
more than :data:`BULK_ELEMENTS` elements (a map or pixel grid) runs in
float64 on the device of its tensor arguments; smaller calls (the scalar
API, scene constants, anchors) run on CPU tensors, where each step costs no
kernel launch.
"""

from __future__ import annotations

import numpy as np
import torch

#: Device of scalar-sized scene calls (see :func:`scene_device`).
HOST = torch.device('cpu')

#: Largest argument, in elements, of a scene call that stays on the host
#: (the JAX package's ``_SMALL_CALL_ELEMENTS``).
BULK_ELEMENTS = 4096


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


def scene_device(n_elements: int, device: torch.device) -> torch.device:
    """
    The device of a scene call whose largest argument holds ``n_elements``
    elements, given its arguments' ``device``: ``device`` for a bulk call
    (more than :data:`BULK_ELEMENTS`), :data:`HOST` otherwise.
    """
    return torch.device(device) if n_elements > BULK_ELEMENTS else HOST


def call_device(*args) -> torch.device:
    """
    :func:`scene_device` of one call on ``args`` (numbers, numpy arrays or
    tensors): the device of its first tensor argument when any argument is
    bulk, else the host.
    """
    sizes = [a.numel() if isinstance(a, torch.Tensor) else np.size(a)
             for a in args]
    device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                  HOST)
    return scene_device(max(sizes, default=0), device)


def f64(x, device: torch.device = HOST) -> torch.Tensor:
    """``x`` (number, numpy array or tensor) as a float64 tensor."""
    return torch.as_tensor(x, dtype=torch.float64, device=device)
