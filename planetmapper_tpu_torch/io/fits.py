"""
Minimal self-contained FITS implementation (reader + writer).

astropy is not a dependency of this framework, so the subset of
``astropy.io.fits`` used by the observation layer is implemented here from
the FITS standard: 2880-byte header/data blocks, 80-character cards,
HIERARCH long-keyword convention, CONTINUE long-string convention, image
HDUs with BITPIX 8/16/32/64/-32/-64 big-endian data, and BSCALE/BZERO
scaling. The API mirrors the astropy names the reference uses (``Header``,
``Card``, ``PrimaryHDU``, ``ImageHDU``, ``HDUList``, ``open``) so the
observation layer reads the same files and writes files astropy can read.

This is the port's own copy of ``planetmapper_tpu/io/fits.py``, so that
the two packages write the same bytes for the same HDUs. Its one addition:
:meth:`HDUList.writeto` names each HDU's encoding and write as the spans
``pm.fits.encode`` and ``pm.fits.write`` and counts ``fits.hdus_written``
and ``fits.bytes_written`` (the bytes handed to the file; :mod:`..tracing`).
"""

from __future__ import annotations

import gzip
import os
import re
from builtins import open as _builtins_open
from typing import Any, Iterator

import numpy as np

from .. import tracing

BLOCK = 2880
CARD_LEN = 80

_BITPIX_DTYPES = {
    8: np.dtype('>u1'),
    16: np.dtype('>i2'),
    32: np.dtype('>i4'),
    64: np.dtype('>i8'),
    -32: np.dtype('>f4'),
    -64: np.dtype('>f8'),
}
_DTYPE_BITPIX = {
    'uint8': 8, 'int8': 8, 'bool': 8,
    'int16': 16, 'uint16': 16,
    'int32': 32, 'uint32': 32,
    'int64': 64, 'uint64': 64,
    'float32': -32,
    'float64': -64,
}


class Undefined:
    """FITS undefined card value."""

    def __repr__(self) -> str:  # pragma: no cover
        return 'Undefined'


UNDEFINED = Undefined()


class Card:
    """One FITS header card: ``(keyword, value, comment)``."""

    def __init__(self, keyword: str = '', value: Any = None,
                 comment: str | None = None) -> None:
        self.keyword = _normalise_keyword(keyword)
        self.value = value
        self.comment = comment

    def __repr__(self) -> str:
        return f'Card({self.keyword!r}, {self.value!r}, {self.comment!r})'

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Card)
            and self.keyword == other.keyword
            and _values_equal(self.value, other.value)
        )

    # -- formatting ---------------------------------------------------------
    def format(self) -> list[str]:
        """Format as one or more 80-character card images."""
        kw = self.keyword
        if kw in ('COMMENT', 'HISTORY', ''):
            text = '' if self.value is None else str(self.value)
            images = []
            for i in range(0, max(len(text), 1), 72):
                images.append(f'{kw:<8}{text[i:i + 72]:<72}'[:80])
            return images
        if ' ' in kw or len(kw) > 8:
            prefix = f'HIERARCH {kw} = '
        else:
            prefix = f'{kw:<8}= '
        if (
            isinstance(self.value, str)
            and len(prefix) + len(_format_value(self.value)) > 80
        ):
            return self._format_long_string(prefix)
        value_str = _format_value(self.value)
        # Right-justify simple values to column 30 where possible
        if not isinstance(self.value, str) and len(prefix) == 10:
            value_str = value_str.rjust(20)
        card = prefix + value_str
        if self.comment:
            room = 80 - len(card) - 3
            if room > 0:
                card += ' / ' + self.comment[:room]
        if len(card) > 80:
            # Truncate (long strings should be pre-truncated by callers)
            card = card[:80]
        return [f'{card:<80}']

    def _format_long_string(self, prefix: str) -> list[str]:
        """FITS long-string convention: the value spans several cards,
        each ending in ``'&'`` with the remainder on CONTINUE cards (the
        same convention :meth:`Header.fromstring` reassembles)."""
        escaped = str(self.value).replace("'", "''")
        images = []
        first = True
        while True:
            head = prefix if first else 'CONTINUE  '
            room = 80 - len(head) - 2  # quotes
            if len(escaped) <= room:
                images.append(f"{head}'{escaped}'".ljust(80))
                break
            # never split an escaped quote pair across cards
            cut = room - 1  # leave room for the '&' continuation marker
            if escaped[cut - 1] == "'" and escaped[cut] == "'":
                cut -= 1
            images.append(f"{head}'{escaped[:cut]}&'".ljust(80))
            escaped = escaped[cut:]
            first = False
        if self.comment:
            room = 80 - 13
            images.append(
                f"CONTINUE  '' / {self.comment[:room - 3]}".ljust(80)
            )
        return images


def _normalise_keyword(keyword: str) -> str:
    kw = str(keyword).strip()
    if kw.upper().startswith('HIERARCH '):
        kw = kw[9:]
    if len(kw) <= 8:
        kw = kw.upper()
    return kw


def _values_equal(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        try:
            return float(a) == float(b)
        except (TypeError, ValueError):
            return False
    return a == b


def _format_value(value: Any) -> str:
    if value is None or isinstance(value, Undefined):
        return ''
    if isinstance(value, bool) or isinstance(value, np.bool_):
        return 'T' if value else 'F'
    if isinstance(value, str):
        escaped = value.replace("'", "''")
        s = f"'{escaped}'"
        if len(s) < 10:
            s = f"'{escaped:<8}'"
        return s
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        s = repr(float(value))
        if 'e' in s:
            s = s.replace('e', 'E')
        elif '.' not in s and 'n' not in s and 'N' not in s:
            s += '.0'
        return s
    if isinstance(value, complex):
        return f'({value.real}, {value.imag})'
    return str(value)


_NUMERIC_RE = re.compile(r'^[+-]?(\d+\.?\d*|\.\d+)([EeDd][+-]?\d+)?$')


def _parse_value(raw: str):
    raw = raw.strip()
    if raw == '':
        return UNDEFINED
    if raw.startswith("'"):
        # String: find closing quote handling '' escapes
        out = []
        i = 1
        while i < len(raw):
            c = raw[i]
            if c == "'":
                if i + 1 < len(raw) and raw[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(c)
            i += 1
        return ''.join(out).rstrip()
    if raw == 'T':
        return True
    if raw == 'F':
        return False
    if _NUMERIC_RE.match(raw):
        if re.match(r'^[+-]?\d+$', raw):
            try:
                return int(raw)
            except ValueError:  # pragma: no cover
                pass
        return float(raw.replace('D', 'E').replace('d', 'e'))
    return raw


def _split_value_comment(rest: str) -> tuple[str, str | None]:
    """Split the post-'=' part of a card into value and comment strings."""
    rest = rest.rstrip()
    if rest.lstrip().startswith("'"):
        # Find end of quoted string first
        s = rest.lstrip()
        offset = len(rest) - len(s)
        i = 1
        while i < len(s):
            if s[i] == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    i += 2
                    continue
                break
            i += 1
        value_part = rest[: offset + i + 1]
        tail = rest[offset + i + 1:]
        if '/' in tail:
            comment = tail.split('/', 1)[1].strip()
        else:
            comment = None
        return value_part, comment
    if '/' in rest:
        value_part, comment = rest.split('/', 1)
        return value_part, comment.strip()
    return rest, None


class Header:
    """
    Ordered FITS header with dict-style access by keyword (HIERARCH
    keywords included transparently, with or without the ``HIERARCH``
    prefix in the lookup key).
    """

    def __init__(self, cards: Any = None) -> None:
        self._cards: list[Card] = []
        if cards is None:
            return
        if isinstance(cards, Header):
            self._cards = [Card(c.keyword, c.value, c.comment)
                           for c in cards._cards]
        elif isinstance(cards, dict):
            for k, v in cards.items():
                self.append(Card(k, v))
        else:
            for item in cards:
                if isinstance(item, Card):
                    self.append(Card(item.keyword, item.value, item.comment))
                else:
                    self.append(Card(*item))

    # -- basic container protocol ------------------------------------------
    @staticmethod
    def _match_key(key: str) -> str:
        return _normalise_keyword(key)

    def _find(self, key: str) -> int:
        key = self._match_key(key)
        for i, card in enumerate(self._cards):
            if card.keyword == key:
                return i
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        try:
            self._find(key)
            return True
        except KeyError:
            return False

    def __getitem__(self, key):
        if isinstance(key, int):
            return self._cards[key].value
        return self._cards[self._find(key)].value

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, tuple) and len(value) == 2:
            value, comment = value
        else:
            comment = None
        try:
            card = self._cards[self._find(key)]
            card.value = value
            if comment is not None:
                card.comment = comment
        except KeyError:
            self.append(Card(key, value, comment))

    def __delitem__(self, key: str) -> None:
        del self._cards[self._find(key)]

    def __len__(self) -> int:
        return len(self._cards)

    def __iter__(self) -> Iterator[str]:
        return (card.keyword for card in self._cards)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Header):
            return NotImplemented
        return self._cards == other._cards

    def __repr__(self) -> str:
        return '\n'.join(
            image for card in self._cards for image in card.format()
        )

    def get(self, key: str, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def keys(self):
        return list(self)

    def values(self):
        return [card.value for card in self._cards]

    def items(self):
        return [(card.keyword, card.value) for card in self._cards]

    def copy(self) -> 'Header':
        return Header(self)

    def update(self, other) -> None:
        if isinstance(other, Header):
            for card in other._cards:
                if card.keyword in ('COMMENT', 'HISTORY', ''):
                    self.append(Card(card.keyword, card.value, card.comment))
                else:
                    self[card.keyword] = card.value
                    self._cards[self._find(card.keyword)].comment = card.comment
        else:
            for k, v in dict(other).items():
                self[k] = v

    def append(self, card) -> None:
        if isinstance(card, tuple):
            card = Card(*card)
        self._cards.append(card)

    def remove(
        self, keyword: str, ignore_missing: bool = False,
        remove_all: bool = False,
    ) -> None:
        key = self._match_key(keyword)
        found = False
        while True:
            try:
                idx = self._find(key)
            except KeyError:
                break
            del self._cards[idx]
            found = True
            if not remove_all:
                break
        if not found and not ignore_missing:
            raise KeyError(keyword)

    def add_comment(self, comment: str) -> None:
        self.append(Card('COMMENT', comment))

    def add_history(self, history: str) -> None:
        self.append(Card('HISTORY', history))

    @property
    def cards(self) -> list[Card]:
        return self._cards

    def comments(self, key: str) -> str | None:
        return self._cards[self._find(key)].comment

    # -- serialisation ------------------------------------------------------
    def tostring(self) -> bytes:
        images: list[str] = []
        for card in self._cards:
            if card.keyword in (
                'SIMPLE', 'XTENSION', 'BITPIX', 'END', 'EXTEND', 'PCOUNT',
                'GCOUNT',
            ) or card.keyword.startswith('NAXIS'):
                continue  # structural cards are regenerated at write time
            images.extend(card.format())
        return ''.join(images).encode('ascii', errors='replace')

    @classmethod
    def fromstring(cls, raw: bytes | str) -> 'Header':
        if isinstance(raw, bytes):
            raw = raw.decode('ascii', errors='replace')
        header = cls()
        pending_string: str | None = None
        pending_card: Card | None = None
        for i in range(0, len(raw), CARD_LEN):
            image = raw[i:i + CARD_LEN]
            if not image.strip():
                continue
            kw8 = image[:8]
            if kw8.rstrip() == 'END':
                break
            if kw8.rstrip() in ('COMMENT', 'HISTORY'):
                header.append(Card(kw8.rstrip(), image[8:].rstrip()))
                continue
            if kw8.rstrip() == 'CONTINUE' and pending_card is not None:
                value, comment = _split_value_comment(image[8:])
                more = _parse_value(value)
                if isinstance(more, str) and isinstance(pending_string, str):
                    if pending_string.endswith('&'):
                        pending_string = pending_string[:-1] + more
                        pending_card.value = pending_string
                continue
            if '=' not in image:
                if kw8.strip() and not image[8:].strip():
                    header.append(Card(kw8.rstrip(), None))
                continue
            if kw8.rstrip() == 'HIERARCH':
                body = image[9:]
                eq = body.find('=')
                keyword = body[:eq].strip()
                rest = body[eq + 1:]
            elif image[8] == '=':
                keyword = kw8.rstrip()
                rest = image[9:]
            else:
                # Possibly HIERARCH-style without leading keyword match
                eq = image.find('=')
                keyword = image[:eq].strip()
                if keyword.upper().startswith('HIERARCH '):
                    keyword = keyword[9:]
                rest = image[eq + 1:]
            value_str, comment = _split_value_comment(rest)
            value = _parse_value(value_str)
            card = Card(keyword, value, comment)
            header.append(card)
            pending_card = card
            pending_string = value if isinstance(value, str) else None
        return header


class _BaseHDU:
    def __init__(self, data: np.ndarray | None = None,
                 header: Header | None = None, name: str | None = None) -> None:
        self.data = data
        self.header = Header(header) if header is not None else Header()
        if name is not None:
            self.header['EXTNAME'] = name

    @property
    def name(self) -> str:
        return str(self.header.get('EXTNAME', '') or '')

    def _structural_cards(self, primary: bool) -> list[Card]:
        cards: list[Card] = []
        data = self.data
        if primary:
            cards.append(Card('SIMPLE', True, 'conforms to FITS standard'))
        else:
            cards.append(Card('XTENSION', 'IMAGE', 'Image extension'))
        if data is None:
            cards.append(Card('BITPIX', 8, 'array data type'))
            cards.append(Card('NAXIS', 0, 'number of array dimensions'))
        else:
            bitpix, bzero, _stored = _encode_data(data)
            cards.append(Card('BITPIX', bitpix, 'array data type'))
            cards.append(Card('NAXIS', data.ndim, 'number of array dimensions'))
            for i, n in enumerate(reversed(data.shape)):
                cards.append(Card(f'NAXIS{i + 1}', int(n)))
        if primary:
            cards.append(Card('EXTEND', True))
        else:
            cards.append(Card('PCOUNT', 0, 'number of parameters'))
            cards.append(Card('GCOUNT', 1, 'number of groups'))
        return cards

    def _serialise(self, primary: bool) -> bytes:
        cards_bytes = b''.join(
            ''.join(card.format()).encode('ascii', errors='replace')
            for card in self._structural_cards(primary)
        )
        data = self.data
        bzero = 0
        stored = None
        if data is not None:
            _bitpix, bzero, stored = _encode_data(data)
            if bzero != 0:
                # unsigned-integer convention (astropy does the same)
                cards_bytes += ''.join(
                    Card('BZERO', bzero, 'offset data range').format()
                    + Card('BSCALE', 1, 'default scaling factor').format()
                ).encode('ascii')
        cards_bytes += self.header.tostring()
        cards_bytes += b'END' + b' ' * 77
        pad = (-len(cards_bytes)) % BLOCK
        out = cards_bytes + b' ' * pad

        if stored is not None:
            raw = stored.tobytes()
            pad = (-len(raw)) % BLOCK
            out += raw + b'\x00' * pad
        return out


class PrimaryHDU(_BaseHDU):
    """Primary HDU."""


class ImageHDU(_BaseHDU):
    """Image extension HDU."""


class HDUList(list):
    """List of HDUs with FITS file writing."""

    def writeto(self, path: str | os.PathLike, overwrite: bool = False,
                output_verify: str = 'warn', checksum: bool = False) -> None:
        path = os.fspath(path)
        if os.path.exists(path) and not overwrite:
            raise OSError(f'File {path!r} already exists')
        opener = gzip.open if str(path).endswith('.gz') else _builtins_open
        with opener(path, 'wb') as f:  # type: ignore[operator]
            for i, hdu in enumerate(self):
                with tracing.span('pm.fits.encode'):
                    raw = hdu._serialise(primary=(i == 0))
                with tracing.span('pm.fits.write'):
                    f.write(raw)
                tracing.count('fits.hdus_written')
                tracing.count('fits.bytes_written', len(raw))

    def close(self) -> None:
        pass

    def __enter__(self) -> 'HDUList':
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.close()

    def __getitem__(self, key):
        if isinstance(key, str):
            key_u = key.strip().upper()
            for hdu in self:
                if hdu.name.strip().upper() == key_u:
                    return hdu
            raise KeyError(key)
        return super().__getitem__(key)


def open(path: str | os.PathLike, memmap: bool = False, **kwargs) -> HDUList:  # noqa: A001
    """Read a FITS file into an :class:`HDUList`."""
    del memmap, kwargs
    path = os.fspath(path)
    if str(path).endswith('.gz'):
        with gzip.open(path, 'rb') as f:
            raw = f.read()
    else:
        with _builtins_open(path, 'rb') as f:
            raw = f.read()

    hdus = HDUList()
    pos = 0
    first = True
    while pos < len(raw):
        header_chunks = []
        end_found = False
        while pos < len(raw) and not end_found:
            block = raw[pos:pos + BLOCK]
            if len(block) < BLOCK:
                pos = len(raw)
                break
            pos += BLOCK
            header_chunks.append(block)
            for i in range(0, BLOCK, CARD_LEN):
                if block[i:i + 8].rstrip() == b'END':
                    end_found = True
                    break
        if not header_chunks:
            break
        header_raw = b''.join(header_chunks)
        if first and not header_raw.startswith(b'SIMPLE'):
            if not header_raw.strip():
                break
        header = Header.fromstring(header_raw)
        # Structural info must come from the raw header (tostring skips them)
        bitpix = int(_header_raw_value(header_raw, 'BITPIX', 8))
        naxis = int(_header_raw_value(header_raw, 'NAXIS', 0))
        shape = []
        for i in range(naxis, 0, -1):
            shape.append(int(_header_raw_value(header_raw, f'NAXIS{i}', 1)))
        data = None
        if naxis > 0 and all(n > 0 for n in shape):
            count = int(np.prod(shape))
            nbytes = count * abs(bitpix) // 8
            data_raw = raw[pos:pos + nbytes]
            pos += nbytes + ((-nbytes) % BLOCK)
            data = np.frombuffer(
                data_raw, dtype=_BITPIX_DTYPES[bitpix], count=count
            ).reshape(shape)
            data = data.astype(data.dtype.newbyteorder('='))
            bscale = header.get('BSCALE', 1)
            bzero = header.get('BZERO', 0)
            if bscale != 1 or bzero != 0:
                data = _apply_scaling(data, bscale, bzero)
                # the data now holds physical values: keeping the cards
                # would double-scale on the next read of a rewritten file
                for kw in ('BSCALE', 'BZERO'):
                    if kw in header:
                        del header[kw]
        cls = PrimaryHDU if first else ImageHDU
        hdu = cls(data=data, header=header)
        hdus.append(hdu)
        first = False
    return hdus


#: The FITS unsigned-integer convention: a signed stored type plus this
#: BZERO offset (with BSCALE=1) represents the unsigned type (and u1-128
#: represents int8). Applied losslessly: (stored + 2^(n-1)) mod 2^n is a
#: same-width reinterpretation, so wrapping unsigned addition implements
#: it without overflow.
_UNSIGNED_CONVENTION = {
    ('int16', 32768): np.uint16,
    ('int32', 2147483648): np.uint32,
    ('int64', 9223372036854775808): np.uint64,
    ('uint8', -128): np.int8,
}


def _encode_data(data: np.ndarray):
    """
    ``(bitpix, bzero, stored)`` for writing an array: FITS has no
    unsigned 16/32/64-bit or signed 8-bit types, so those use the BZERO
    offset convention (the exact inverse of :func:`_apply_scaling`'s
    integer branch - wrapping same-width arithmetic, lossless for every
    value). Unsupported dtypes fall back to float64.
    """
    name = data.dtype.name
    offsets = {
        'uint16': 32768, 'uint32': 2147483648,
        'uint64': 9223372036854775808, 'int8': -128,
    }
    bzero = offsets.get(name)
    if bzero is not None:
        signed = name != 'int8'
        stored_t = np.dtype(f'i{data.dtype.itemsize}' if signed
                            else f'u{data.dtype.itemsize}')
        offset = np.array(bzero).astype(data.dtype)  # wraps to 2^(n-1)
        stored = np.ascontiguousarray(
            (data - offset).view(stored_t),
            dtype=stored_t.newbyteorder('>'),
        )
        return _DTYPE_BITPIX[name], bzero, stored
    bitpix = _DTYPE_BITPIX.get(name)
    if bitpix is None:
        data = np.asarray(data, dtype=np.float64)
        bitpix = -64
    stored = np.ascontiguousarray(data, dtype=_BITPIX_DTYPES[bitpix])
    return bitpix, 0, stored


def _apply_scaling(data: np.ndarray, bscale, bzero) -> np.ndarray:
    """Physical values from stored values per BSCALE/BZERO."""
    target = _UNSIGNED_CONVENTION.get((data.dtype.name, bzero))
    if bscale == 1 and target is not None and data.dtype.kind in 'iu':
        unsigned = data.dtype.name != 'uint8'
        view_t = np.dtype(f'u{data.dtype.itemsize}' if unsigned
                          else f'i{data.dtype.itemsize}')
        offset = np.array(bzero).astype(view_t)  # wraps to 2^(n-1)
        return (data.view(view_t) + offset).view(target)
    # general case: physical values are real-valued; upcast BEFORE the
    # arithmetic (int16 + 32768 overflows the stored dtype on numpy 2)
    return data.astype(np.float64) * bscale + bzero


def _header_raw_value(header_raw: bytes, keyword: str, default):
    text = header_raw.decode('ascii', errors='replace')
    for i in range(0, len(text), CARD_LEN):
        image = text[i:i + CARD_LEN]
        if image[:8].rstrip() == keyword:
            value_str, _ = _split_value_comment(image[9:])
            return _parse_value(value_str)
        if image[:8].rstrip() == 'END':
            break
    return default
