"""
ctypes bindings for the native C++ DAF reader (``native/daf_reader.cpp``
in this package).

The shared library is built on demand with the system's C++ compiler into
``build/`` at the repository root (beside the CUDA kernel libraries), named
by the hash of its source and flags; without a compiler
:func:`read_daf_native` returns None. :func:`.daf.read_daf` takes this
reader only with ``PLANETMAPPER_TPU_NATIVE=1`` (see :mod:`.daf` for why)
and falls back to its pure-Python parser. The test suite holds the two
parsers to each other word for word.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LIB_FAILED = False

SOURCE = Path(__file__).resolve().parent.parent / 'native' / 'daf_reader.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
FLAGS = ('-O2', '-shared', '-fPIC', '-std=c++17')
COMPILERS = ('g++', 'clang++', 'c++')


def native_requested() -> bool:
    """Whether ``PLANETMAPPER_TPU_NATIVE=1`` asks :func:`.daf.read_daf`
    for this reader."""
    return os.environ.get('PLANETMAPPER_TPU_NATIVE', '0') == '1'


def library_path() -> Path:
    """Where the library for this source and :data:`FLAGS` is built."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + ' '.join(FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f'libdafreader-{digest}.so'


def build_library() -> Path | None:
    """Compile the source unless built already; None without a compiler."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f'{lib.name}.{os.getpid()}.tmp')
    for compiler in COMPILERS:
        try:
            subprocess.run(
                [compiler, *FLAGS, '-o', str(tmp), str(SOURCE)],
                check=True, capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, lib)
        return lib
    return None


def _get_lib() -> ctypes.CDLL | None:
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        path = build_library()
        if path is None:
            _LIB_FAILED = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _LIB_FAILED = True
            return None
        lib.daf_open.restype = ctypes.c_void_p
        lib.daf_open.argtypes = [ctypes.c_char_p]
        lib.daf_nd.argtypes = [ctypes.c_void_p]
        lib.daf_ni.argtypes = [ctypes.c_void_p]
        lib.daf_num_segments.argtypes = [ctypes.c_void_p]
        lib.daf_num_words.restype = ctypes.c_long
        lib.daf_num_words.argtypes = [ctypes.c_void_p]
        lib.daf_segment.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ]
        lib.daf_read_words.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.daf_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def read_daf_native(path: str):
    """
    Parse a DAF file with the native reader. Returns a
    :class:`planetmapper_tpu_torch.kernels.daf.DAFFile` or None if the
    native library is unavailable or parsing fails.
    """
    from .daf import DAFFile, DAFSummary

    lib = _get_lib()
    if lib is None:
        return None
    handle = lib.daf_open(os.fsencode(path))
    if not handle:
        return None
    try:
        nd = lib.daf_nd(handle)
        ni = lib.daf_ni(handle)
        n_seg = lib.daf_num_segments(handle)
        n_words = lib.daf_num_words(handle)

        summaries = []
        dbl_buf = (ctypes.c_double * nd)()
        int_buf = (ctypes.c_int * ni)()
        for i in range(n_seg):
            if lib.daf_segment(handle, i, dbl_buf, int_buf) != 0:
                return None
            summaries.append(
                DAFSummary(tuple(dbl_buf), tuple(int_buf))
            )

        data = np.empty(n_words, dtype=np.float64)
        if lib.daf_read_words(
            handle, 1, n_words,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ) != 0:
            return None
        with open(path, 'rb') as f:
            idword = f.read(8).decode('ascii', errors='replace')
        return DAFFile(
            path=path, idword=idword, nd=nd, ni=ni,
            summaries=summaries, _data=data,
        )
    finally:
        lib.daf_close(handle)
