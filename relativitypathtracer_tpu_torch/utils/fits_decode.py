"""FITS texture decoding in numpy and the standard library, as PIL 12.1.0's
FitsImagePlugin reads a file and `convert("RGB")` converts it, byte for
byte.

The header is read as PIL reads it: 80-byte cards, each keyword's value
the card's text after the keyword up to a '/', stripped, a leading '='
dropped (strings keep their quotes); the first card must be SIMPLE = T.
An END card ends a header, and the next one starts at the following
2880-byte block; every header's cards go into one table, so an extension
after an empty primary HDU overrides the primary's keywords. The first
header with an image sets it: NAXIS 1 is read as an image 1 wide and
NAXIS1 high, NAXIS 2 or more as NAXIS1 x NAXIS2 (later axes ignored);
BITPIX 8, 16, 32, -32 and -64 give PIL's modes L, I;16, I and F, F.

PIL reads the data with its raw decoder in rawmode = the mode, bottom row
first (`args = (mode, 0, -1)`), so FITS's big-endian samples are read as
PIL's little-endian I;16, I and F, and a BITPIX -64 image as 4-byte floats
(half of its data). A tile-compressed image (XTENSION 'BINTABLE', ZIMAGE
T, ZCMPTYPE 'GZIP_1  ') is PIL's FitsGzipDecoder: the bytes after the
table (NAXIS1 * NAXIS2 * BITPIX / 8 of them) to the end of the file
gunzipped, read as 4 bytes a sample of which the last BITPIX / 8 are kept
(none for BITPIX -32 and -64, where PIL fails), rows bottom first, in
rawmode = the mode. Then utils/pil_modes' to_rgb: I;16 and I clipped to
0-255, F truncated and clipped (PIL's F -> L -> RGB).

What PIL refuses raises DecodeError naming the cause.
"""

from __future__ import annotations

import gzip
import zlib

import numpy as np

from .image_decode import DecodeError, _check_size
from .pil_modes import to_rgb

_MODES = {8: ("L", "u1"), 16: ("I;16", "<u2"), 32: ("I", "<i4"), -32: ("F", "<f4"),
          -64: ("F", "<f4")}


def _int(headers: dict, key: bytes) -> int:
    if key not in headers:
        raise DecodeError(f"FITS: no {key.decode('latin-1')} keyword")
    try:
        return int(headers[key])
    except ValueError as e:
        raise DecodeError(f"FITS: {key.decode('latin-1')} is not an integer") from e


def _size(headers: dict, prefix: bytes):
    naxis = _int(headers, prefix + b"NAXIS")
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, _int(headers, prefix + b"NAXIS1")
    return _int(headers, prefix + b"NAXIS1"), _int(headers, prefix + b"NAXIS2")


def _parse(headers: dict):
    """FitsImageFile._parse_headers: (gzip, offset, size, BITPIX), or None
    where the header has no image."""
    prefix, gz, offset = b"", False, 0
    if headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T":
        if b"ZCMPTYPE" not in headers:
            raise DecodeError("FITS: ZIMAGE without ZCMPTYPE")
        if headers[b"ZCMPTYPE"] == b"'GZIP_1  '":
            table = _size(headers, prefix) or (0, 0)
            offset = table[0] * table[1] * (_int(headers, b"BITPIX") // 8)
            prefix, gz = b"Z", True
    size = _size(headers, prefix)
    if not size:
        return None
    return gz, offset, size, _int(headers, prefix + b"BITPIX")


def decode_fits(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a FITS file as PIL's `convert("RGB")` of
    it (module docstring)."""
    data = bytes(data)
    pos, headers, in_header, found = 0, {}, False, None
    while True:  # FitsImageFile._open
        card = data[pos:pos + 80]
        pos += len(card)
        if not card:
            raise DecodeError("FITS: truncated file (no data after the header)")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_header = True
        elif headers and not in_header:
            break
        elif keyword == b"END":
            pos = -(-pos // 2880) * 2880
            if found is None:
                found = _parse(headers)
            in_header = False
            continue
        if found is not None:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE") or value != b"T"):
            raise DecodeError("not a FITS file (no SIMPLE = T)")
        headers[keyword] = value
    if found is None:
        raise DecodeError("FITS: no image data")
    gz, offset, (width, height), bitpix = found
    if bitpix not in _MODES:
        raise DecodeError(f"FITS: BITPIX {bitpix} (PIL reads 8, 16, 32, -32 and -64)")
    if width <= 0 or height <= 0:
        raise DecodeError(f"FITS: an image of {width}x{height}")
    _check_size(width, height)
    mode, dtype = _MODES[bitpix]
    start = offset + pos - 80
    need = width * height * np.dtype(dtype).itemsize
    if gz:
        try:
            value = gzip.decompress(data[start:])
        except (OSError, EOFError, zlib.error) as e:
            raise DecodeError(f"FITS: bad GZIP_1 data: {e}") from e
        keep = min(bitpix // 8, 4)
        if keep <= 0:
            raise DecodeError(f"FITS: GZIP_1 data at BITPIX {bitpix} (PIL reads none of it)")
        if len(value) < 4 * width * height:
            raise DecodeError("FITS: truncated GZIP_1 data")
        words = np.frombuffer(value, np.uint8, 4 * width * height).reshape(-1, 4)
        raw = words[:, 4 - keep:].reshape(-1)
    else:
        raw = np.frombuffer(data[start:start + need], np.uint8)
    if raw.size < need:
        raise DecodeError("FITS: truncated image data")
    return to_rgb(mode, raw[:need].view(dtype).reshape(height, width)[::-1])
