"""Texture decoding in numpy and the standard library of the icon
containers: Windows ICO and CUR, Mac OS ICNS.

Each decoder returns the (H, W, 3) uint8 pixels, top row first, that PIL's
`Image.open(f).convert("RGB")` gives for the same file, byte for byte: it
picks the entry PIL's plugin picks (IcoImagePlugin, CurImagePlugin,
IcnsImagePlugin) and decodes it as PIL does, a PNG entry by
utils/image_decode, a BMP entry (a DIB whose height counts its mask too)
by utils/raster_decode.

  ICO   the directory's entries sorted by colour depth (the entry's bit
        count, else from its colour count, else 256), then by area
        descending, both stable: the first is opened, so among the
        largest entries the one of the lowest depth. A size byte of 0 is
        256. A DIB entry is its first half of rows; PIL also reads its
        32-bit alpha or its AND mask (the mask ends where the entry's size
        says), and fails where those bytes are missing, so this does too.
        The image is the entry's own size where that differs from the
        directory's.
  CUR   the first entry, replaced only by a later one whose width and
        height bytes are both larger; a DIB at half height.
  ICNS  the resources read block by block; the best size the largest of
        PIL's SIZES present (by (width, height, scale)); every resource of
        that size read as PIL reads it: PNG, JPEG 2000 (the resource's
        bytes alone, by utils/j2k_decode), it32/ih32/il32/is32 (raw if
        exactly 3 bytes a pixel, else three channel planes in an RLE where
        a byte >= 0x80 repeats the next byte (byte - 125) times and a byte
        < 0x80 copies byte + 1 bytes; it32 behind 4 zero bytes) and the
        8-bit masks, each failing as PIL's readers fail; a PNG or JPEG 2000
        resource is the image where present, else the RGB one. PIL then checks the image's size against the
        sizes present, as its size setter does.

What PIL refuses raises DecodeError naming the cause.
"""

from __future__ import annotations

import math

import numpy as np

from .image_decode import DecodeError, _check_size, decode_png
from .j2k_decode import decode_j2k
from .legacy_raster import expand
from .raster_decode import decode_bmp

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _le(data: bytes, pos: int, size: int) -> int:
    return int.from_bytes(data[pos:pos + size], "little")


def ico_entries(data: bytes) -> list:
    """IcoFile's directory: per entry a dict of its fields, in the order
    PIL sorts them (the first is the one it opens)."""
    entries = []
    for i in range(_le(data, 4, 2)):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise DecodeError("ICO: truncated directory")
        width, height, colors, bpp = s[0] or 256, s[1] or 256, s[2], _le(s, 6, 2)
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
        entries.append({"dim": (width, height), "bpp": bpp, "size": _le(s, 8, 4),
                        "offset": _le(s, 12, 4), "depth": depth, "square": width * height})
    entries = sorted(entries, key=lambda e: e["depth"])
    return sorted(entries, key=lambda e: e["square"], reverse=True)


def decode_ico(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of the entry of an ICO file PIL opens, as its
    `convert("RGB")`."""
    data = bytes(data)
    if data[:4] != b"\0\0\1\0":
        raise DecodeError("not an ICO file")
    entries = ico_entries(data)
    if not entries:
        raise DecodeError("ICO: no entries")
    e = entries[0]
    start = e["offset"]
    if data[start:start + 8] == _PNG_MAGIC:
        return decode_png(data[start:])
    if start + 4 > len(data):
        raise DecodeError("ICO: an entry past the end of the file")
    rgb = decode_bmp(data[start:], dib=True, halve=True)
    h, w = rgb.shape[:2]
    pixels = start + _dib_pixels(data, start)
    if e["bpp"] == 32:  # PIL reads the alpha bytes of the entry's pixels
        if len(data[pixels:pixels + 4 * w * h][3::4]) < w * h:
            raise DecodeError("ICO: truncated 32-bit entry")
    else:  # and the AND mask, at the end of the entry
        stride = (w + 31) // 32 * 4
        mask = e["offset"] + e["size"] - stride * h
        if mask < 0:
            raise DecodeError("ICO: an AND mask before the start of the file")
        got = len(data[mask:mask + stride * h])
        if got < (h - 1) * stride + (w + 7) // 8:
            raise DecodeError("ICO: truncated AND mask")
    return rgb


def _dib_pixels(data: bytes, start: int) -> int:
    """The offset, from a DIB's start, of its pixels as PIL's BmpImageFile
    finds them: after the header, the 40-byte header's three bitfield
    masks and the palette."""
    size = _le(data, start, 4)
    if size == 12:
        bits, colors, compression, entry = _le(data, start + 10, 2), 0, 0, 3
    else:
        bits, compression = _le(data, start + 14, 2), _le(data, start + 16, 4)
        colors, entry = _le(data, start + 32, 4), 4
    pos = size + (12 if compression == 3 and size == 40 else 0)
    if bits <= 8:
        pos += entry * (colors or 1 << bits)
    return pos


def decode_cur(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of the cursor of a CUR file PIL opens, as its
    `convert("RGB")`."""
    data = bytes(data)
    if data[:4] != b"\0\0\2\0":
        raise DecodeError("not a CUR file")
    best = None
    for i in range(_le(data, 4, 2)):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise DecodeError("CUR: truncated directory")
        if best is None or (s[0] > best[0] and s[1] > best[1]):
            best = s
    if best is None:
        raise DecodeError("CUR: no cursors")
    start = _le(best, 12, 4)
    if start + 4 > len(data):
        raise DecodeError("CUR: an entry past the end of the file")
    return decode_bmp(data[start:], dib=True, halve=True)


# ---------------------------------------------------------------------------
# ICNS

# (width, height, scale) -> the resources PIL reads for it (IcnsFile.SIZES)
SIZES = {(512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",), (256, 256, 2): (b"ic14",),
         (256, 256, 1): (b"ic08",), (128, 128, 2): (b"ic13",),
         (128, 128, 1): (b"ic07", b"it32", b"t8mk"), (64, 64, 1): (b"icp6",),
         (32, 32, 2): (b"ic12",), (48, 48, 1): (b"ih32", b"h8mk"),
         (32, 32, 1): (b"icp5", b"il32", b"l8mk"), (16, 16, 2): (b"ic11",),
         (16, 16, 1): (b"icp4", b"is32", b"s8mk")}
_JPEG2000 = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")


def icns_resources(data: bytes) -> dict:
    """IcnsFile's blocks: type -> (start, length) of its data."""
    if len(data) < 8 or data[:4] != b"icns":
        raise DecodeError("not an ICNS file")
    size, pos, blocks = int.from_bytes(data[4:8], "big"), 8, {}
    while pos < size:
        if pos + 8 > len(data):
            raise DecodeError("ICNS: truncated block header")
        kind, length = data[pos:pos + 4], int.from_bytes(data[pos + 4:pos + 8], "big")
        if length <= 0:
            raise DecodeError("ICNS: invalid block header")
        blocks[kind] = (pos + 8, length - 8)
        pos += length
    return blocks


def icns_sizes(blocks: dict) -> list:
    """IcnsFile.itersizes: the (width, height, scale) of SIZES with a
    resource present (its best size is the largest)."""
    return [size for size, kinds in SIZES.items() if any(k in blocks for k in kinds)]


def _icns_rgb(data: bytes, start: int, length: int, side: int) -> np.ndarray:
    """read_32: (side, side, 3) uint8 of an RGB resource."""
    count = side * side
    if length == 3 * count:
        raw = np.frombuffer(data[start:start + length], np.uint8)
        if raw.size < 3 * count:
            raise DecodeError("ICNS: truncated RGB resource")
        return raw.reshape(side, side, 3).copy()
    planes, pos = [], start
    for _ in range(3):
        starts, counts, literal, left = [], [], [], count
        while left > 0:
            if pos >= len(data):
                break
            head = data[pos]
            pos += 1
            if head & 0x80:
                n = head - 125
                starts.append(pos)
                counts.append(n if pos < len(data) else 0)
                literal.append(False)
                pos += 1
            else:
                n = head + 1
                got = min(n, len(data) - pos)
                starts.append(pos)
                counts.append(got)
                literal.append(True)
                pos += n
            left -= n
        if left != 0:
            raise DecodeError(f"ICNS: error reading a channel ({left} left)")
        plane = expand(data, starts, counts, literal)
        if plane.size < count:
            raise DecodeError("ICNS: truncated RGB resource")
        planes.append(plane[:count].reshape(side, side))
    return np.stack(planes, -1)


def decode_icns(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of the best image of an ICNS file, as PIL's
    `convert("RGB")` of it."""
    data = bytes(data)
    blocks = icns_resources(data)
    sizes = icns_sizes(blocks)
    if not sizes:
        raise DecodeError("ICNS: no 32-bit icon resources")
    best = max(sizes)
    side = best[0] * best[2]
    _check_size(side, side)
    png = rgb = None
    for kind in SIZES[best]:
        if kind not in blocks:
            continue
        start, length = blocks[kind]
        if kind.endswith(b"mk"):
            if len(data[start:start + side * side]) < side * side:
                raise DecodeError("ICNS: truncated mask")
        elif kind in (b"it32", b"ih32", b"il32", b"is32"):
            if kind == b"it32":
                if data[start:start + 4] != b"\0\0\0\0":
                    raise DecodeError("ICNS: it32 without its 4 zero bytes")
                start, length = start + 4, length - 4
            rgb = _icns_rgb(data, start, length, side)
        else:
            sig = data[start:start + 12]
            if sig[:8] == _PNG_MAGIC:
                png = decode_png(data[start:])
            elif sig.startswith(_JPEG2000[:2]) or sig == _JPEG2000[2]:
                # PIL opens the resource's bytes alone, converted to RGBA
                png = decode_j2k(data[start:start + length])
            else:
                raise DecodeError("ICNS: unsupported icon subimage format")
    if png is None and rgb is None:
        raise DecodeError("ICNS: the best size has a mask only")
    image = png if png is not None else rgb
    h, w = image.shape[:2]  # PIL's size setter checks it against the sizes present
    if not any(w and h and (s[1] * s[2]) / h == (s[0] * s[2]) // w for s in sizes):
        raise DecodeError(f"ICNS: an image of {w}x{h} is none of the file's sizes")
    return image
