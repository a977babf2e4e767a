"""
Reader for NAIF DAF (Double-precision Array File) binary files, the container
format of SPK ephemeris kernels.

From-scratch implementation of the DAF layout (per the NAIF "DAF Required
Reading" document): 1024-byte records, a file record holding ND/NI and the
summary-record linked list, and packed segment summaries. This replaces the
CSPICE file layer behind ``spice.furnsh``/``spkezr`` in the reference
(planetmapper/base.py:828).

This module's pure-Python parser reads every DAF by default. The JAX
package's C++ reader (``native/daf_reader.cpp`` of this package, built and
bound by :mod:`.daf_native`) gives the same words but is opt-in here
(``PLANETMAPPER_TPU_NATIVE=1``): it copies the file twice where the parser
views one read in place, and was the slower of the two on the 1.3 MB
synthetic SPK and on a 32 MiB one (``chip_smoke.py``'s ``[tle]`` phase).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

RECORD_SIZE = 1024
WORDS_PER_RECORD = 128


class DAFError(ValueError):
    pass


@dataclass(frozen=True)
class DAFSummary:
    doubles: tuple[float, ...]
    integers: tuple[int, ...]


@dataclass
class DAFFile:
    """Parsed DAF file: summaries plus raw access to the double-word array."""

    path: str
    idword: str
    nd: int
    ni: int
    summaries: list[DAFSummary]
    _data: np.ndarray  # all file bytes viewed as little/big-endian float64

    def words(self, start: int, end: int) -> np.ndarray:
        """Double-precision words ``start``..``end`` (1-indexed, inclusive)."""
        return self._data[start - 1 : end]


def read_daf(path: str) -> DAFFile:
    """
    Read a DAF file with the pure-Python parser, or with
    ``PLANETMAPPER_TPU_NATIVE=1`` the native C++ reader when it builds (see
    :mod:`.daf_native`).
    """
    from . import daf_native

    if daf_native.native_requested():
        native = daf_native.read_daf_native(path)
        if native is not None:
            return native
    return read_daf_python(path)


def read_daf_python(path: str) -> DAFFile:
    """Pure-Python DAF parser (reference implementation for parity tests)."""
    with open(path, 'rb') as f:
        raw = f.read()
    if len(raw) < RECORD_SIZE:
        raise DAFError(f'File too small to be a DAF: {path!r}')
    idword = raw[0:8].decode('ascii', errors='replace')
    if not idword.startswith('DAF/') and idword != 'NAIF/DAF':
        raise DAFError(f'Not a DAF file (ID word {idword!r}): {path!r}')

    locfmt = raw[88:96].decode('ascii', errors='replace')
    if 'LTL' in locfmt:
        endian = '<'
    elif 'BIG' in locfmt:
        endian = '>'
    else:
        # Pre-N0050 files don't have LOCFMT; sniff from ND plausibility
        nd_le = struct.unpack('<i', raw[8:12])[0]
        endian = '<' if 0 < nd_le < 125 else '>'

    nd, ni = struct.unpack(endian + 'ii', raw[8:16])
    fward, bward, free = struct.unpack(endian + 'iii', raw[76:88])
    if not (0 < nd < 125 and 0 < ni < 251):
        raise DAFError(f'Implausible DAF ND/NI ({nd}, {ni}) in {path!r}')

    n_words = len(raw) // 8
    data = np.frombuffer(raw[: n_words * 8], dtype=endian + 'f8')

    ss = nd + (ni + 1) // 2  # summary size in double words
    summaries: list[DAFSummary] = []
    record = fward
    int_dtype = endian + 'i4'
    while record > 0:
        rec_words = data[(record - 1) * WORDS_PER_RECORD : record * WORDS_PER_RECORD]
        next_rec = int(rec_words[0])
        nsum = int(rec_words[2])
        for i in range(nsum):
            s = rec_words[3 + i * ss : 3 + (i + 1) * ss]
            doubles = tuple(float(v) for v in s[:nd])
            ints = tuple(
                int(v) for v in s[nd:].view(int_dtype)[:ni]
            )
            summaries.append(DAFSummary(doubles, ints))
        record = next_rec

    return DAFFile(
        path=path, idword=idword, nd=nd, ni=ni, summaries=summaries, _data=data
    )
