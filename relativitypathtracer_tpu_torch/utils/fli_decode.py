"""FLI/FLC (Autodesk Animator) texture decoding in numpy and the standard
library: the first frame, as PIL 12.1.0's FliImagePlugin opens a file and
its C `fli` decoder (FliDecode.c) reads it, then `convert("RGB")`, byte
for byte.

The header is FliImageFile._open's: the 128-byte header (magic 0xAF11 or
0xAF12, flags 0 or 3, its reserved ranges zero), then the palette: in the
frame chunk (0xF1FA) after an optional prefix chunk (0xF100), the first
COLOR_256 (type 4, 8-bit values) or COLOR_64 (type 11, values shifted up
by 2, kept modulo 256) sub-chunk, over PIL's grey default. Whatever fails
there makes Image.open try its next plugin (`Unidentified`).

The decoder then reads the frame at byte 128, as PIL hands it over: the
file's bytes from there, as many as the frame's size says (a file short of
it is truncated; one byte short of an odd size is not), the frame chunk's
magic, and each sub-chunk in turn with FliDecode.c's bounds checks, which
test against the end of the frame, not of the sub-chunk:

  BLACK 13   the image to 0
  BRUN 15    every line: a packet count ignored, then packets until the
             line is full (a negative count copies, a positive one repeats)
  COPY 16    the image's bytes, row by row
  LC 12      a first line and a line count, then per line packets of a
             skip, then a copy (count below 128) or a run (256 - count)
  SS2 7      a line count, per line words: skip lines (0xC000), the last
             pixel of an odd line (0x8000), else the packet count; packets
             of a skip, then a copy of count word pairs or a run of 256 -
             count repeated pairs
  PSTAMP 18, COLOR 4 and 11  skipped

A packet that would run past the line's end ends the line and the chunk is
an error, as is an unknown sub-chunk, a zero or too long advance, and
data past the frame. The image starts black (index 0); P -> RGB through
the palette.
"""

from __future__ import annotations

import numpy as np

from .image_decode import DecodeError, Unidentified, _check_size


def _u16(d: bytes, p: int) -> int:
    return d[p] | d[p + 1] << 8


def _u32(d: bytes, p: int) -> int:
    return int.from_bytes(d[p:p + 4], "little")


def _s32(d: bytes, p: int) -> int:
    return int.from_bytes(d[p:p + 4], "little", signed=True)


def _need(d: bytes, p: int, n: int) -> None:
    """A read of n bytes at p, failing as PIL's struct reads do."""
    if p < 0 or p + n > len(d):
        raise Unidentified("FLI/FLC: truncated header")


def open_fli(d: bytes):
    """FliImageFile._open: (width, height, palette (256, 3) uint8), or
    Unidentified where PIL tries its next plugin."""
    s = d[:128]
    if not (len(s) == 128 and _u16(s, 4) in (0xAF11, 0xAF12) and _u16(s, 14) in (0, 3)
            and s[20:22] == b"\0\0" and not s[42:80].strip(b"\0") and not s[88:].strip(b"\0")):
        raise Unidentified("not an FLI/FLC file")
    width, height = _u16(s, 8), _u16(s, 10)
    pal = np.repeat(np.arange(256, dtype=np.int64)[:, None], 3, 1)
    pos = 128
    _need(d, pos, 6)
    if _u16(d, pos + 4) == 0xF100:  # a prefix chunk, skipped
        pos += _u32(d, pos)
        _need(d, pos, 6)
    if _u16(d, pos + 4) == 0xF1FA:
        chunks, pos, size = _u16(d, pos + 6), pos + 16, None
        for _ in range(chunks):
            if size is not None:
                pos += size - 6
            _need(d, pos, 6)
            kind = _u16(d, pos + 4)
            pos += 6
            if kind in (4, 11):
                _fli_palette(d, pos, pal, 2 if kind == 11 else 0)
                break
            size = _u32(d, pos - 6)
            if not size:
                break
    if width <= 0 or height <= 0:
        raise Unidentified("FLI/FLC: empty image")
    _check_size(width, height)
    return width, height, (pal & 255).astype(np.uint8)


def _fli_palette(d: bytes, pos: int, pal: np.ndarray, shift: int) -> None:
    """FliImageFile._palette: packets of a skip, a count (0: 256) and the
    count's colours, each index past 255 an error."""
    _need(d, pos, 2)
    i, pos = 0, pos
    packets, pos = _u16(d, pos), pos + 2
    for _ in range(packets):
        s = d[pos:pos + 2]
        pos += len(s)
        if len(s) < 2:
            raise Unidentified("FLI/FLC: truncated palette")
        i += s[0]
        n = s[1] or 256
        s = d[pos:pos + 3 * n]
        pos += len(s)
        if len(s) % 3 or i + len(s) // 3 > 256:
            raise Unidentified("FLI/FLC: palette past its end")
        if s:
            pal[i:i + len(s) // 3] = np.frombuffer(s, np.uint8).reshape(-1, 3).astype(
                np.int64) << shift
            i += len(s) // 3


class _Overrun(DecodeError):
    pass


def decode_fli(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of an FLI/FLC file's first frame, as PIL's
    `convert("RGB")` of it."""
    data = bytes(data)
    width, height, pal = open_fli(data)
    _need(data, 128, 4)
    size = _u32(data, 128)
    buf = data[128:128 + size]  # ImageFile.load reads decodermaxblock = the frame's size
    if not buf or len(buf) + len(buf) % 2 < size:
        raise DecodeError("FLI/FLC: image file is truncated")
    img = np.zeros((height, width), np.uint8)
    try:
        _frame(buf, img)
    except _Overrun as e:
        raise DecodeError(f"FLI/FLC: {e}") from None
    except IndexError:
        raise DecodeError("FLI/FLC: frame data past its end") from None
    return pal[img]


def _frame(b: bytes, img: np.ndarray) -> None:
    """FliDecode.c on the frame's bytes `b`, into the (h, w) index image."""
    end = len(b)
    h, w = img.shape
    if end < 8:
        raise _Overrun("frame header past the frame's end")
    if _u16(b, 4) != 0xF1FA:
        raise _Overrun(f"unknown frame chunk 0x{_u16(b, 4):04X}")
    chunks, ptr = _u16(b, 6), 16

    def oob(p, n):
        if p + n > end:
            raise _Overrun("chunk data past the frame's end")

    for _ in range(chunks):
        if end - ptr < 10:
            raise _Overrun("sub-chunk header past the frame's end")
        kind, p = _u16(b, ptr + 4), ptr + 6
        if kind == 7:
            _ss2(b, p, img, oob)
        elif kind == 12:
            _lc(b, p, img, oob)
        elif kind == 13:
            img[:] = 0
        elif kind == 15:
            _brun(b, p, img, oob)
        elif kind == 16:
            if p + w * h > end:
                raise _Overrun("COPY chunk past the frame's end")
            img[:] = np.frombuffer(b, np.uint8, w * h, p).reshape(h, w)
        elif kind not in (4, 11, 18):
            raise _Overrun(f"unknown sub-chunk type {kind}")
        advance = _s32(b, ptr)
        if advance == 0:
            raise _Overrun("a sub-chunk of size 0")
        if advance < 0 or advance > end - ptr:
            raise _Overrun("a sub-chunk past the frame's end")
        ptr += advance


def _ss2(b, p, img, oob) -> None:
    h, w = img.shape
    lines, p = _u16(b, p), p + 2
    y = line = 0
    while line < lines and y < h:
        row = img[y]
        oob(p, 2)
        packets, p = _u16(b, p), p + 2
        while packets & 0x8000:
            if packets & 0x4000:
                y += 65536 - packets
                if y >= h:
                    raise _Overrun("SS2 skips past the last line")
                row = img[y]
            else:
                row[w - 1] = packets & 255
            oob(p, 2)
            packets, p = _u16(b, p), p + 2
        x = k = 0
        while k < packets:
            oob(p, 2)
            x += b[p]
            if b[p + 1] >= 128:
                oob(p, 4)
                n = 256 - b[p + 1]
                if x + 2 * n > w:
                    break
                row[x:x + 2 * n] = np.tile(np.frombuffer(b, np.uint8, 2, p + 2), n)
                p, x = p + 4, x + 2 * n
            else:
                n = 2 * b[p + 1]
                if x + n > w:
                    break
                oob(p, 2 + n)
                row[x:x + n] = np.frombuffer(b, np.uint8, n, p + 2)
                p, x = p + 2 + n, x + n
            k += 1
        if k < packets:
            break
        line, y = line + 1, y + 1
    if line < lines:
        raise _Overrun("SS2 chunk ends before its lines")


def _lc(b, p, img, oob) -> None:
    h, w = img.shape
    y = _u16(b, p)
    ymax, p = y + _u16(b, p + 2), p + 4
    while y < ymax and y < h:
        row = img[y]
        oob(p, 1)
        packets, p = b[p], p + 1
        x = k = 0
        while k < packets:
            oob(p, 2)
            x += b[p]
            if b[p + 1] & 0x80:
                n = 256 - b[p + 1]
                if x + n > w:
                    break
                oob(p, 3)
                row[x:x + n] = b[p + 2]
                p += 3
            else:
                n = b[p + 1]
                if x + n > w:
                    break
                oob(p, 2 + n)
                row[x:x + n] = np.frombuffer(b, np.uint8, n, p + 2)
                p += 2 + n
            k, x = k + 1, x + n
        if k < packets:
            break
        y += 1
    if y < ymax:
        raise _Overrun("LC chunk ends before its lines")


def _brun(b, p, img, oob) -> None:
    h, w = img.shape
    for y in range(h):
        row = img[y]
        p += 1  # the packet count, ignored
        x = 0
        while x < w:
            oob(p, 2)
            if b[p] & 0x80:
                n = 256 - b[p]
                if x + n > w:
                    break
                oob(p, n + 1)
                row[x:x + n] = np.frombuffer(b, np.uint8, n, p + 1)
                p += n + 1
            else:
                n = b[p]
                if x + n > w:
                    break
                row[x:x + n] = b[p + 1]
                p += 2
            x += n
        if x != w:
            raise _Overrun("BRUN line not filled")
