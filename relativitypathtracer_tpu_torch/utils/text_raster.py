"""Texture decoding in numpy and the standard library of the X11 text
images: XBM bitmaps and XPM pixel maps.

Each decoder returns the (H, W, 3) uint8 pixels, top row first, that PIL's
`Image.open(f).convert("RGB")` gives for the same file, byte for byte,
reading it as XbmImagePlugin (and its C decoder) and XpmImagePlugin do.

  XBM   PIL's header expression over the first 512 bytes (width and height
        defines, an optional hotspot, then everything up to the last
        `_bits[]` within them); then each 'x' starts a byte of the two
        characters after it as hex digits (a non-digit counts 0), the next
        'x' looked for three bytes on; rows of whole bytes, the first pixel
        in the lowest bit, a set bit white (PIL's "1;R").
  XPM   the values line after the `/* XPM */` magic (width, height,
        colours, characters a pixel); each colour line's key and its "c"
        value: #rrggbb (any number of hex digits, the low 24 bits kept)
        or None (transparent, a key no pixel may use); any other colour
        name refused. Then the quoted parts of the lines after, one
        "/* pixels */" line skipped, key by key as one stream; up to 256
        colours a palette image, past that RGB.

What PIL refuses raises DecodeError naming the cause.
"""

from __future__ import annotations

import re

import numpy as np

from .image_decode import DecodeError, _check_size
from .pil_modes import palette256, to_rgb

XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]"
)
_HEX = np.zeros(256, np.uint8)
for _digits, _base in ((b"0123456789", 0), (b"abcdef", 10), (b"ABCDEF", 10)):
    _HEX[np.frombuffer(_digits, np.uint8)] = np.arange(len(_digits)) + _base


def decode_xbm(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of an XBM file, as PIL's `convert("RGB")` of
    it."""
    data = bytes(data)
    m = XBM_HEAD.match(data[:512])
    if not m:
        raise DecodeError("not an XBM file (PIL's header expression finds no match)")
    width, height = int(m.group("width")), int(m.group("height"))
    if width <= 0 or height <= 0:
        raise DecodeError(f"XBM: empty image {width}x{height}")
    _check_size(width, height)
    row_bytes = (width + 7) // 8
    need = row_bytes * height
    buf = np.frombuffer(data, np.uint8)
    xs = m.end() + np.flatnonzero(buf[m.end():] == ord("x"))
    if xs.size > 1 and (np.diff(xs) < 3).any():  # an 'x' inside a byte's digits is skipped
        kept, last = [], -3
        for x in xs.tolist():
            if x >= last + 3:
                kept.append(x)
                last = x
        xs = np.array(kept, np.int64)
    xs = xs[xs + 3 <= len(data)]  # a byte needs its two digits
    if xs.size < need:
        raise DecodeError("XBM: truncated image data")
    xs = xs[:need]
    values = (_HEX[buf[xs + 1]] << 4) + _HEX[buf[xs + 2]]
    bits = np.unpackbits(values.astype(np.uint8).reshape(height, row_bytes), axis=1,
                         bitorder="little")[:, :width]
    return to_rgb("1", bits * np.uint8(255))


_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


class _Lines:
    """readline() over the file's bytes, as PIL's file reads them."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def readline(self) -> bytes:
        end = self.data.find(b"\n", self.pos)
        end = len(self.data) if end < 0 else end + 1
        line = self.data[self.pos:end]
        self.pos = end
        return line


def decode_xpm(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of an XPM file, as PIL's `convert("RGB")` of
    it."""
    data = bytes(data)
    if data[:9] != b"/* XPM */":
        raise DecodeError("not an XPM file")
    f = _Lines(data, 9)
    while True:
        line = f.readline()
        if not line:
            raise DecodeError("XPM: broken file (no values line)")
        m = _XPM_HEAD.match(line)
        if m:
            break
    try:
        width, height, colours, cpp = (int(g) for g in m.groups())
    except ValueError as e:
        raise DecodeError("XPM: an empty field in the values line") from e
    palette = {}
    for _ in range(colours):
        line = f.readline().rstrip()
        key, fields = line[1:cpp + 1], line[cpp + 1:-2].split()
        for i in range(0, len(fields), 2):
            if fields[i] == b"c":
                value = fields[i + 1] if i + 1 < len(fields) else b""
                if value == b"None":
                    pass
                elif value.startswith(b"#"):
                    try:
                        rgb = int(value[1:], 16)
                    except ValueError as e:
                        raise DecodeError(f"XPM: bad colour {value!r}") from e
                    palette[key] = (rgb >> 16 & 255, rgb >> 8 & 255, rgb & 255)
                else:
                    raise DecodeError(f"XPM: colour name {value.decode('latin-1')!r} (only "
                                      "#rrggbb and None are read)")
                break
        else:
            raise DecodeError(f"XPM: no c colour for key {key!r}")
    if width <= 0 or height <= 0:
        raise DecodeError(f"XPM: empty image {width}x{height}")
    _check_size(width, height)
    keys = list(palette)
    want, got, pixel_header, stream = width * height, 0, False, []
    while got < want:  # a line at a time, as PIL reads them
        line = f.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not pixel_header:
            pixel_header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        full = len(line) - len(line) % cpp
        stream.append(line[:full])
        if full < len(line):  # a key cut short by the line's end
            stream.append(line[full:].ljust(cpp, b"\0"))
        got += -(-len(line) // cpp)
    if got < want:
        raise DecodeError("XPM: not enough image data")
    idx = _xpm_indices(b"".join(stream), cpp, keys)[:want].reshape(height, width)
    table = np.array([palette[k] for k in keys] or [(0, 0, 0)], np.uint8)
    if colours > 256:
        return table[idx]
    return to_rgb("P", idx.astype(np.uint8), palette256(table))


def _xpm_indices(stream: bytes, cpp: int, keys: list) -> np.ndarray:
    """The palette index of each cpp-byte key of the stream (keys shorter
    than cpp padded with zero bytes on both sides); a key not in the
    palette raises."""
    if cpp <= 0:
        raise DecodeError(f"XPM: {cpp} characters a pixel")
    pad = [k.ljust(cpp, b"\0")[:cpp] for k in keys]
    both = np.frombuffer(b"".join(pad) + stream, np.uint8).reshape(-1, cpp)
    uniq, inv = np.unique(both, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    lookup = np.full(uniq.shape[0], -1, np.int64)
    lookup[inv[:len(keys)][::-1]] = np.arange(len(keys))[::-1]
    idx = lookup[inv[len(keys):]]
    if (idx < 0).any():
        bad = bytes(both[len(keys) + int(np.flatnonzero(idx < 0)[0])])
        raise DecodeError(f"XPM: a pixel of no colour in the palette ({bad!r})")
    return idx
