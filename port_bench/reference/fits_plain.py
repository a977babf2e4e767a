"""
A plain FITS writer and reader, written from the FITS standard (4.0) for
the benchmark alone: 2880-byte blocks of 80-character cards, ``HIERARCH``
cards for keywords longer than 8 characters or with spaces, ``CONTINUE``
cards of long strings on reading, and image HDUs of big-endian
``BITPIX`` 8, 16, 32, 64, -32 or -64 data, addressed by ``EXTNAME``. No
scaling: a file whose header asks for ``BSCALE`` or ``BZERO`` is refused.

The drivers write their input files with it, and the checks read the
program's saved files back with it. Imports numpy only.
"""

from __future__ import annotations

import numpy as np

BLOCK = 2880
CARD = 80
#: ``BITPIX`` of each stored type, and back
BITPIX = {np.dtype('uint8'): 8, np.dtype('int16'): 16, np.dtype('int32'): 32,
          np.dtype('int64'): 64, np.dtype('float32'): -32,
          np.dtype('float64'): -64}
STORED = {v: k.newbyteorder('>') for k, v in BITPIX.items()}
#: Cards that the writer makes from the data and the reader keeps apart
STRUCTURAL = ('SIMPLE', 'XTENSION', 'BITPIX', 'NAXIS', 'EXTEND', 'PCOUNT',
              'GCOUNT', 'END')


class HDU:
    """One HDU: its cards ``[(keyword, value, comment)]`` in file order
    (structural cards left out), its data (native byte order, or None) and
    the raw structural values (``BITPIX``, ``NAXIS``...)."""

    def __init__(self, cards, data=None, structure=None):
        self.cards = list(cards)
        self.data = data
        self.structure = dict(structure or {})

    @property
    def name(self) -> str:
        return str(self.get('EXTNAME', '') or '').strip()

    def get(self, keyword: str, default=None):
        """The value of the first card ``keyword`` (a ``HIERARCH`` keyword
        without its prefix)."""
        for key, value, _ in self.cards:
            if key == keyword:
                return value
        return default

    def count(self, keyword: str) -> int:
        return sum(key == keyword for key, _, _ in self.cards)


# -- cards -----------------------------------------------------------------

def format_value(value) -> str:
    """A value as the standard's fixed format writes it."""
    if isinstance(value, (bool, np.bool_)):
        return 'T' if value else 'F'
    if isinstance(value, str):
        return "'" + value.replace("'", "''").ljust(8) + "'"
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        text = repr(float(value)).upper()
        if '.' not in text and 'E' not in text and 'N' not in text:
            text += '.'
        return text
    raise TypeError(f'no FITS value for {value!r}')


def format_card(keyword: str, value, comment: str | None = None) -> bytes:
    """One 80-character card; a keyword over 8 characters or with a space
    takes the ``HIERARCH`` convention."""
    text = format_value(value)
    if len(keyword) > 8 or ' ' in keyword:
        image = f'HIERARCH {keyword} = {text}'
    else:
        if not isinstance(value, str):
            text = text.rjust(20)
        image = f'{keyword:<8}= {text}'
    if len(image) > CARD:
        raise ValueError(f'the card {keyword} is longer than 80 characters')
    if comment:
        image = (image + f' / {comment}')[:CARD]
    return image.ljust(CARD).encode('ascii')


def _parse_string(text: str) -> tuple[str, str]:
    """A quoted string at the start of ``text`` and what follows it."""
    out, i = [], 1
    while i < len(text):
        if text[i] == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return ''.join(out).rstrip(), text[i + 1:]
        out.append(text[i])
        i += 1
    raise ValueError(f'an unclosed string: {text!r}')


def parse_value(text: str):
    """A card's value field, and its comment (None without one)."""
    text = text.strip()
    if text.startswith("'"):
        value, rest = _parse_string(text)
        rest = rest.strip()
        return value, rest[1:].strip() if rest.startswith('/') else None
    field, slash, comment = text.partition('/')
    field = field.strip()
    comment = comment.strip() if slash else None
    if field == 'T':
        return True, comment
    if field == 'F':
        return False, comment
    if field == '':
        return None, comment
    try:
        return int(field), comment
    except ValueError:
        return float(field.replace('D', 'E')), comment


def parse_card(image: str):
    """``(keyword, value, comment)`` of one card image; None for a blank
    card; the value of ``COMMENT``, ``HISTORY`` and ``CONTINUE`` cards is
    their text after column 8."""
    keyword = image[:8].rstrip()
    if keyword in ('COMMENT', 'HISTORY', 'CONTINUE'):
        return keyword, image[8:].rstrip(), None
    if keyword == 'HIERARCH':
        name, sep, rest = image[9:].partition('=')
        if not sep:
            raise ValueError(f'a HIERARCH card without "=": {image!r}')
        return (name.strip(), *parse_value(rest))
    if not keyword and not image.strip():
        return None
    if image[8:10] != '= ':
        return keyword, None, image[8:].rstrip() or None
    return (keyword, *parse_value(image[10:]))


# -- writing ---------------------------------------------------------------

def _padded(raw: bytes, fill: bytes) -> bytes:
    return raw + fill * ((-len(raw)) % BLOCK)


def encode_hdu(cards, data, primary: bool) -> bytes:
    """One HDU's header and data blocks."""
    head = [format_card('SIMPLE', True) if primary
            else format_card('XTENSION', 'IMAGE')]
    if data is None:
        head += [format_card('BITPIX', 8), format_card('NAXIS', 0)]
    else:
        data = np.asarray(data)
        head += [format_card('BITPIX', BITPIX[data.dtype.newbyteorder('=')]),
                 format_card('NAXIS', data.ndim)]
        head += [format_card(f'NAXIS{i + 1}', int(n))
                 for i, n in enumerate(reversed(data.shape))]
    head += ([format_card('EXTEND', True)] if primary
             else [format_card('PCOUNT', 0), format_card('GCOUNT', 1)])
    head += [format_card(*card) for card in cards]
    head.append(b'END'.ljust(CARD))
    out = _padded(b''.join(head), b' ')
    if data is not None:
        stored = STORED[BITPIX[data.dtype.newbyteorder('=')]]
        out += _padded(np.ascontiguousarray(data, dtype=stored).tobytes(),
                       b'\0')
    return out


def write(path, hdus) -> int:
    """Write ``hdus`` (``[(cards, data)]``, the primary first; an image
    extension's cards give its ``EXTNAME``); returns the bytes written."""
    n = 0
    with open(path, 'wb') as f:
        for i, (cards, data) in enumerate(hdus):
            n += f.write(encode_hdu(cards, data, primary=(i == 0)))
    return n


# -- reading ---------------------------------------------------------------

def read(path) -> list[HDU]:
    """Every HDU of a file, its data in native byte order."""
    with open(path, 'rb') as f:
        raw = f.read()
    hdus, pos = [], 0
    while pos < len(raw):
        cards, structure = [], {}
        end = False
        while not end:
            block = raw[pos:pos + BLOCK]
            if len(block) < BLOCK:
                raise ValueError(f'{path}: a header runs past the file')
            pos += BLOCK
            for i in range(0, BLOCK, CARD):
                image = block[i:i + CARD].decode('ascii')
                if image[:8].rstrip() == 'END':
                    end = True
                    break
                card = parse_card(image)
                if card is None:
                    continue
                key, value, comment = card
                if key == 'CONTINUE' and cards and \
                        isinstance(cards[-1][1], str) and \
                        cards[-1][1].endswith('&'):
                    more, _ = parse_value(value)
                    last = cards[-1]
                    cards[-1] = (last[0], last[1][:-1] + (more or ''),
                                 last[2])
                elif key in STRUCTURAL or key.startswith('NAXIS'):
                    structure[key] = value
                else:
                    cards.append(card)
        if any(key in ('BSCALE', 'BZERO') for key, _, _ in cards):
            raise ValueError(f'{path}: scaled data is not read')
        naxis = int(structure.get('NAXIS', 0))
        shape = tuple(int(structure[f'NAXIS{i}'])
                      for i in range(naxis, 0, -1))
        data = None
        if naxis:
            dtype = STORED[int(structure['BITPIX'])]
            size = int(np.prod(shape)) * dtype.itemsize
            if pos + size > len(raw):
                raise ValueError(f'{path}: data run past the file')
            data = np.frombuffer(raw, dtype, int(np.prod(shape)), pos)
            data = data.reshape(shape).astype(dtype.newbyteorder('='))
            pos += size + (-size) % BLOCK
        hdus.append(HDU(cards, data, structure))
    return hdus
