"""
Parser for NAIF text kernels (LSK ``*.tls``, text PCK ``*.tpc``).

This is a from-scratch implementation of the subset of the SPICE text-kernel
grammar needed to ingest leap-second kernels and planetary-constant kernels
into plain Python/numpy data (which the scene builder turns into f64
tensors).

Replaces the kernel-pool behaviour the reference gets from CSPICE ``furnsh``
(reference: planetmapper/base.py:909-936).

Grammar notes (from the NAIF "Kernel Required Reading" document):

- A file is alternating text and data blocks, delimited by ``\\begindata`` and
  ``\\begintext`` markers on their own lines. Only data blocks are parsed.
- Assignments are ``NAME = ( value value ... )`` or ``NAME = value``. The
  ``+=`` operator appends to an existing variable.
- Numeric values may use Fortran ``D`` exponents (``1.657D-3``).
- ``@<date>`` tokens are parsed as calendar epochs and converted to seconds
  past the J2000 epoch **without** leap second adjustment (matching SPICE,
  which stores ``@...`` dates in the pool as TDB-like second counts computed
  by a plain calendar conversion).
- String values are enclosed in single quotes.
"""

from __future__ import annotations

import re

from ..core.timebase import calendar_to_j2000_seconds

_BEGIN_DATA = '\\begindata'
_BEGIN_TEXT = '\\begintext'

_MONTHS = {
    'JAN': 1, 'FEB': 2, 'MAR': 3, 'APR': 4, 'MAY': 5, 'JUN': 6,
    'JUL': 7, 'AUG': 8, 'SEP': 9, 'OCT': 10, 'NOV': 11, 'DEC': 12,
}

TextKernelValue = float | int | str
TextKernelPool = dict[str, list[TextKernelValue]]


def _parse_at_date(token: str) -> float:
    """
    Parse an ``@``-prefixed epoch token (e.g. ``@1972-JAN-1``) into seconds
    past J2000 (no leap second handling, by definition of the pool format).
    """
    s = token[1:].strip()
    # Accept formats like 1972-JAN-1, 1972-JAN-1-12:00:00.000
    m = re.match(
        r'^(\d{4})-([A-Za-z]{3})-(\d{1,2})'
        r'(?:[-T/ ](\d{1,2}):(\d{2})(?::(\d{2}(?:\.\d*)?))?)?$',
        s,
    )
    if not m:
        raise ValueError(f'Cannot parse text kernel date token {token!r}')
    year = int(m.group(1))
    month = _MONTHS[m.group(2).upper()]
    day = int(m.group(3))
    hour = int(m.group(4) or 0)
    minute = int(m.group(5) or 0)
    sec = float(m.group(6) or 0.0)
    return calendar_to_j2000_seconds(year, month, day, hour, minute, sec)


def _parse_value(token: str) -> TextKernelValue:
    token = token.strip()
    if not token:
        raise ValueError('Empty token in text kernel')
    if token.startswith('@'):
        return _parse_at_date(token)
    if token.startswith("'") and token.endswith("'") and len(token) >= 2:
        # strip exactly the surrounding quotes and un-escape SPICE's
        # doubled single quotes ('IT''S' -> IT'S)
        return token[1:-1].replace("''", "'")
    t = token.upper().replace('D', 'E')
    try:
        f = float(t)
    except ValueError as exc:
        raise ValueError(f'Cannot parse text kernel token {token!r}') from exc
    return f


# quoted strings may contain doubled-quote escapes: consume pairs greedily
_TOKEN_RE = re.compile(r"'(?:[^']|'')*'|[^\s,()]+")


def _tokenise_values(value_text: str) -> list[TextKernelValue]:
    return [_parse_value(t) for t in _TOKEN_RE.findall(value_text)]


_ASSIGNMENT_RE = re.compile(r'^\s*([\w/.\-]+)\s*(\+?=)\s*(.*)$', re.DOTALL)
_ASSIGNMENT_START_RE = re.compile(r'^\s*[\w/.\-]+\s*\+?=')
_QUOTED_RE = re.compile(r"'(?:[^']|'')*'")


def parse_text_kernel(text: str, pool: TextKernelPool | None = None) -> TextKernelPool:
    """
    Parse text kernel contents into (or into an existing) pool dictionary.

    Later assignments to the same variable replace earlier ones (matching the
    precedence rules of the SPICE kernel pool); ``+=`` appends.
    """
    if pool is None:
        pool = {}
    in_data = False
    data_lines: list[str] = []
    for raw_line in text.splitlines():
        line = raw_line.strip()
        if line == _BEGIN_DATA:
            in_data = True
            continue
        if line == _BEGIN_TEXT:
            in_data = False
            continue
        if in_data and line:
            data_lines.append(line)

    # Join continuation lines: an assignment may span multiple lines (the
    # value may even START on the line after the '='), so a statement
    # ends only where the NEXT assignment begins at paren depth 0.
    # Parentheses inside quoted strings don't affect the depth.
    def paren_depth(s: str) -> int:
        return (
            _QUOTED_RE.sub('', s).count('(')
            - _QUOTED_RE.sub('', s).count(')')
        )

    statements: list[str] = []
    buffer = ''
    depth = 0
    for line in data_lines:
        if buffer and depth <= 0 and _ASSIGNMENT_START_RE.match(line):
            statements.append(buffer)
            buffer = ''
        buffer = f'{buffer} {line}'.strip() if buffer else line
        depth = paren_depth(buffer)
    if buffer.strip():
        statements.append(buffer)

    for statement in statements:
        m = _ASSIGNMENT_RE.match(statement)
        if not m:
            continue
        name, op, value_text = m.group(1), m.group(2), m.group(3)
        values = _tokenise_values(value_text)
        if op == '+=' and name in pool:
            pool[name] = list(pool[name]) + values
        else:
            pool[name] = values
    return pool


def load_text_kernel(path: str, pool: TextKernelPool | None = None) -> TextKernelPool:
    with open(path, 'r', encoding='utf-8', errors='replace') as f:
        return parse_text_kernel(f.read(), pool)
