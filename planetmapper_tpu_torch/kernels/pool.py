"""
Kernel pool: loading, precedence, and lookup of SPICE kernel data.

API-parity replacement for the reference's kernel management layer
(planetmapper/base.py:909-1079): ``load_kernels``, ``sort_kernel_paths``,
``set_kernel_path``/``get_kernel_path`` (with the ``PLANETMAPPER_KERNEL_PATH``
environment variable and ``~/spice_kernels/`` default), ``clear_kernels`` and
``prevent_kernel_loading`` - plus the pool itself, which the reference keeps
inside CSPICE (``spice.furnsh``/``bodvar``/``pdpool``).
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import Collection

import numpy as np

from . import naif_ids
from .spk import SpkError, SpkSegment, parse_spk_file
from .textkernel import TextKernelPool, load_text_kernel

DEFAULT_KERNEL_PATH = '~/spice_kernels/'

_KERNEL_DATA = {
    'kernel_path': None,
    'kernel_patterns': ('**/*.bsp', '**/*.tpc', '**/*.tls'),
    'kernels_loaded': False,
}


class KernelPool:
    """
    In-process store of loaded kernel data: text-kernel variables plus SPK
    segments (in load order - later loads take precedence, like the SPICE
    kernel pool).
    """

    def __init__(self) -> None:
        self.text: TextKernelPool = {}
        self.spk_segments: list[SpkSegment] = []
        self.loaded_files: list[str] = []
        # runtime overrides (pdpool equivalent, e.g. altitude-adjusted radii)
        self._overrides: dict[str, list[float]] = {}

    # -- loading ------------------------------------------------------------
    def furnsh(self, path: str) -> None:
        lower = path.lower()
        if lower.endswith('.bsp'):
            self.spk_segments.extend(parse_spk_file(path))
        elif lower.endswith(('.tpc', '.tls', '.tf', '.ti', '.tsc')):
            load_text_kernel(path, self.text)
        else:
            # Try binary magic then fall back to text kernel parsing
            with open(path, 'rb') as f:
                magic = f.read(8)
            if magic.startswith(b'DAF/SPK') or magic.startswith(b'NAIF/DAF'):
                self.spk_segments.extend(parse_spk_file(path))
            elif magic.startswith((b'DAF/', b'DAS/', b'NAIF/DAS')):
                # a binary kernel of an unsupported architecture (binary
                # PCK, CK, DSK...): parsing it as text would silently
                # load nothing while reporting success
                raise SpkError(
                    f'Cannot load binary kernel {path!r} (magic '
                    f'{magic.decode("ascii", "replace").strip()!r}): only '
                    'SPK binaries and text kernels are supported'
                )
            else:
                load_text_kernel(path, self.text)
        self.loaded_files.append(path)

    def clear(self) -> None:
        self.text.clear()
        self.spk_segments.clear()
        self.loaded_files.clear()
        self._overrides.clear()

    # -- variable access ----------------------------------------------------
    def pdpool(self, name: str, values) -> None:
        """Override a pool variable at runtime (``spice.pdpool`` equivalent)."""
        self._overrides[name] = [float(v) for v in np.atleast_1d(values)]

    def clear_override(self, name: str) -> None:
        self._overrides.pop(name, None)

    def get(self, name: str, default=None):
        if name in self._overrides:
            return self._overrides[name]
        return self.text.get(name, default)

    def __contains__(self, name: str) -> bool:
        return name in self._overrides or name in self.text

    def bodvar(self, body_id: int, item: str, expected: int | None = None):
        """``spice.bodvar``/``bodvrd`` equivalent: body constants lookup."""
        name = f'BODY{body_id}_{item}'
        values = self.get(name)
        if values is None:
            raise KernelVarNotFoundError(
                f'Kernel pool variable {name!r} not found. '
                'Check a suitable PCK kernel is loaded.'
            )
        arr = np.array([float(v) for v in values])
        if expected is not None and arr.size < expected:
            raise KernelVarNotFoundError(
                f'Kernel pool variable {name!r} has {arr.size} values, '
                f'expected {expected}'
            )
        return arr

    # -- body name extensions from the pool ----------------------------------
    def extra_body_names(self) -> tuple[dict[str, int], dict[int, str]]:
        names = self.get('NAIF_BODY_NAME') or []
        codes = self.get('NAIF_BODY_CODE') or []
        name_to_id = {
            naif_ids._normalise(str(n)): int(c) for n, c in zip(names, codes)
        }
        id_to_name = {int(c): str(n) for n, c in zip(names, codes)}
        return name_to_id, id_to_name


class KernelVarNotFoundError(Exception):
    """Raised when a kernel pool variable is missing (SpiceKERNELVARNOTFOUND)."""


# Module-level pool used by default (mirrors CSPICE's single global pool)
_pool = KernelPool()


def get_pool() -> KernelPool:
    return _pool


def load_kernels(*paths: str, clear_before: bool = False) -> list[str]:
    """
    Load kernels matching glob patterns, sorted by :func:`sort_kernel_paths`.
    API parity with the reference's ``load_kernels`` (base.py:909-936).
    """
    if clear_before:
        _pool.clear()
    kernels = set()
    for pattern in paths:
        kernels.update(glob.glob(os.path.expanduser(pattern), recursive=True))
    for kernel in sort_kernel_paths(kernels):
        _pool.furnsh(kernel)
    return list(kernels)


def sort_kernel_paths(kernels: Collection[str]) -> list[str]:
    """
    Sort kernel paths by depth (deepest first) then alphabetically, so that
    later-loaded (shallower/later-alphabet) kernels take precedence.
    Behaviour parity with the reference (base.py:939-977).
    """
    return sorted(
        kernels,
        key=lambda p: (
            -len(Path(p).resolve().parts),
            os.path.dirname(p),
            os.path.basename(p),
            os.path.normpath(p),
            p,
        ),
    )


def load_spice_kernels(
    kernel_path: str | None = None,
    manual_kernels: None | list[str] = None,
    only_if_needed: bool = True,
) -> None:
    """Auto-load kernels once per session (base.py:553-611 parity)."""
    if only_if_needed and _KERNEL_DATA['kernels_loaded']:
        return
    if manual_kernels:
        kernels = manual_kernels
    else:
        if kernel_path is None:
            kernel_path = get_kernel_path()
        kernel_path = os.path.expanduser(kernel_path)
        kernels = [
            os.path.join(kernel_path, pattern)
            for pattern in _KERNEL_DATA['kernel_patterns']
        ]
    kernel_paths = load_kernels(*kernels)
    if len(kernel_paths) == 0:
        print()
        print(f'WARNING: no SPICE kernels found in directory {kernel_path!r}')
        print(
            'Try running planetmapper_tpu_torch.set_kernel_path to change where '
            'kernels are searched for'
        )
        print()
    else:
        _KERNEL_DATA['kernels_loaded'] = True


def prevent_kernel_loading() -> None:
    """Disable automatic kernel loading (base.py:980-1004 parity)."""
    _KERNEL_DATA['kernels_loaded'] = True


def clear_kernels() -> None:
    """Clear the kernel pool and re-enable auto loading (base.py:1007)."""
    _pool.clear()
    _KERNEL_DATA['kernels_loaded'] = False


def set_kernel_path(path: str | os.PathLike | None) -> None:
    """Set the kernel directory (base.py:1018-1029 parity)."""
    if path is not None:
        path = os.fspath(path)
    _KERNEL_DATA['kernel_path'] = path
    # Changing the path invalidates the loaded-once latch so the new
    # directory actually gets loaded by the next object construction.
    if _pool.loaded_files:
        clear_kernels()


def get_kernel_path(return_source: bool = False):
    """Resolve the kernel directory (base.py:1040-1079 parity)."""
    path = _KERNEL_DATA['kernel_path']
    if path is not None:
        return (path, 'set_kernel_path()') if return_source else path
    env = os.environ.get('PLANETMAPPER_KERNEL_PATH')
    if env:
        return (env, 'PLANETMAPPER_KERNEL_PATH') if return_source else env
    if return_source:
        return DEFAULT_KERNEL_PATH, 'default'
    return DEFAULT_KERNEL_PATH
