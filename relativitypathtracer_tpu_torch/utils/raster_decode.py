"""Texture decoding in numpy and the standard library: the PNM family, BMP
(and its headerless DIB form), TGA and GIF.

Each decoder returns the (H, W, 3) uint8 pixels, top row first, that PIL's
`Image.open(f).convert("RGB")` gives for the same file, byte for byte:
it reads the file into the PIL mode PIL's plugin opens it as
(PpmImagePlugin, BmpImagePlugin, TgaImagePlugin, GifImagePlugin and their
C decoders), then converts it as PIL does (utils/pil_modes). The quirks of
those plugins are kept where a file can reach them: plain PNM comments are
cut out with the newline that ends them, a BMP RLE delta reads two bytes
it ignores before its offsets, RLE4 absolute runs of odd length drop their
last pixel, a GIF's first frame fills what its descriptor leaves out with
the transparent index.

  PNM   P1-P6, plain and binary, maxval 1-65535 (rescaled with Python's
        round, as PIL's decoders; 16-bit grey opens as PIL's mode I and so
        clips at 255), '#' comments; PIL's own kinds: P0CMYK and PyCMYK
        (CMYK, converted as PIL converts it), PyRGBA, PyP (P without a
        palette: black), and Pf (float32 rows bottom first, little-endian
        where the scale is negative, then F -> RGB; the scale's size is
        not applied, as in PIL);
  BMP   1/4/8/16/24/32 bits, RLE4, RLE8, BITFIELDS in PIL's layouts,
        bottom-up and top-down rows, the OS/2 (12-byte) and the
        40/52/56/64/108/124-byte headers;
  TGA   image types 1/2/3 and their RLE forms 9/10/11, 1/8/16/24/32 bits,
        colour maps of 16 or 24 bits, the orientation bits (PIL fails on
        RLE at 1 bit, 32-bit maps and maps beside true colour);
  GIF   the first frame: LZW, interlacing, local and global palettes, the
        transparent index, a frame larger than the screen.

The LZW and RLE loops are Python loops over codes and packets; every step
after them is vectorised. What PIL would not open, and corrupt or
truncated data, raises DecodeError; nothing returns a partial image.
"""

from __future__ import annotations

import re
import struct

import numpy as np

from .image_decode import DecodeError, _check_size
from .pil_modes import five_bits, palette256, to_rgb, unpack_bits


def _u16(data, pos: int) -> int:
    if pos + 2 > len(data):
        raise DecodeError("truncated file inside a header")
    return int.from_bytes(data[pos:pos + 2], "little")


def _u32(data, pos: int) -> int:
    if pos + 4 > len(data):
        raise DecodeError("truncated file inside a header")
    return int.from_bytes(data[pos:pos + 4], "little")


def _rows(data, pos: int, height: int, row_bytes: int, stride: int, bottom_up: bool):
    """(height, row_bytes) uint8: rows of `row_bytes` bytes every `stride`
    bytes from `pos`, in image order (PIL's raw decoder: the last row needs
    no padding after it)."""
    if height and pos + stride * (height - 1) + row_bytes > len(data):
        raise DecodeError("truncated image data")
    buf = np.frombuffer(data, np.uint8)
    rows = np.lib.stride_tricks.as_strided(buf[pos:], (height, row_bytes), (stride, 1))
    return rows[::-1] if bottom_up else rows


def _channels(rows, width: int, order: str) -> np.ndarray:
    """(h, width, 3) uint8 RGB of rows of bytes in a channel order such as
    "BGR", "BGRX" or "ABGR" (one byte each)."""
    px = rows[:, :width * len(order)].reshape(rows.shape[0], width, len(order))
    return px[..., [order.index(c) for c in "RGB"]]


def _fifteen(rows, width: int) -> np.ndarray:
    """16-bit little-endian pixels, 5 bits a channel (BGR;15) -> RGB."""
    p = rows[:, :2 * width].reshape(rows.shape[0], width, 2).astype(np.int64)
    p = p[..., 0] | (p[..., 1] << 8)
    return np.stack([five_bits(p >> 10), five_bits(p >> 5), five_bits(p)], -1)


# ---------------------------------------------------------------------------
# PNM

_PNM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
              b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_PNM_BANDS = {"RGB": 3, "RGBA": 4, "CMYK": 4}
_WHITESPACE = b" \t\n\x0b\x0c\r"
_SAFEBLOCK = 1 << 20  # PIL's ImageFile.SAFEBLOCK: the plain decoder reads blocks this size
_DIGITS = re.compile(rb"[0-9]+\Z")


def _pnm_field(data: bytes, pos: int):
    """PpmImageFile._read_token: the next header field's bytes and the
    offset after the whitespace byte that ends it. A '#' starts a comment up
    to CR or LF, wherever it falls, even inside a field."""
    token = b""
    while len(token) <= 10:
        c = data[pos:pos + 1]
        pos += len(c)
        if not c:
            break
        if c in _WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while True:
                c = data[pos:pos + 1]
                pos += len(c)
                if c in b"\r\n":  # b"" (the end) too
                    break
            continue
        token += c
    if not token:
        raise DecodeError("PNM: end of file inside the header")
    if len(token) > 10:
        raise DecodeError(f"PNM: header field too long: {token[:11]!r}")
    return token, pos


def _pnm_token(data: bytes, pos: int):
    """The next header field as an integer (int() of it, as PIL reads it)."""
    token, pos = _pnm_field(data, pos)
    try:
        return int(token), pos
    except ValueError as e:
        raise DecodeError(f"PNM: bad header field {token!r}") from e


class _PlainReader:
    """PpmPlainDecoder's reading: blocks of the data after the header
    (`read`), with comments ('#' to the next CR or LF, that byte included)
    cut out (`clean`); a comment may run on into the blocks after."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos, self.spans = data, pos, False

    def read(self) -> bytes:
        block = self.data[self.pos:self.pos + _SAFEBLOCK]
        self.pos += len(block)
        return block

    @staticmethod
    def _comment_end(block: bytes, start: int) -> int:
        a, b = block.find(b"\n", start), block.find(b"\r", start)
        return min(a, b) if a * b > 0 else max(a, b)

    def clean(self, block: bytes) -> bytes:
        if self.spans:  # finish a comment begun in an earlier block
            while block:
                end = self._comment_end(block, 0)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.read()
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                return block
            end = self._comment_end(block, start)
            if end == -1:
                self.spans = True
                return block[:start]
            block = block[:start] + block[end + 1:]


def _pnm_plain_bits(data: bytes, pos: int, count: int) -> np.ndarray:
    """P1's samples, True for white: each '0' or '1', whitespace optional;
    PIL checks every byte of each block it reads."""
    reader, out = _PlainReader(data, pos), b""
    while len(out) != count:
        block = reader.read()
        if not block:
            break
        tokens = b"".join(reader.clean(block).split())
        if tokens.translate(None, b"01"):
            raise DecodeError("PNM: a plain bitmap holds other than 0 and 1")
        out = (out + tokens)[:count]
    if len(out) < count:
        raise DecodeError("PNM: not enough image data")
    return np.frombuffer(out, np.uint8) == ord("0")


def _pnm_plain_values(data: bytes, pos: int, count: int, maxval: int, out_max: int):
    """P2/P3's samples, decimal fields, each rescaled to out_max as PIL does
    (round(value / maxval * out_max))."""
    reader, values, half, n = _PlainReader(data, pos), [], b"", 0
    while n != count:
        block = reader.read()
        if not block:
            if not half:
                break
            block = b" "
        block = reader.clean(block)
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()
            if len(half) > 10:
                raise DecodeError(f"PNM: field too long: {half[:11]!r}")
        take = tokens[:count - n]
        if any(len(t) > 10 for t in take):
            raise DecodeError("PNM: field too long")
        if all(_DIGITS.match(t) for t in take):
            v = np.array(take, dtype=np.bytes_).astype(np.int64) if take else np.zeros(0, np.int64)
        else:
            try:
                v = np.array([int(t) for t in take], np.int64)
            except ValueError as e:
                raise DecodeError("PNM: a field is not a number") from e
        if (v < 0).any() or (v > maxval).any():
            raise DecodeError(f"PNM: a sample outside 0-{maxval}")
        values.append(np.round(v / maxval * out_max).astype(np.int64))
        n += len(take)
    if n < count:
        raise DecodeError("PNM: not enough image data")
    return np.concatenate(values) if values else np.zeros(0, np.int64)


def decode_pnm(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a PBM, PGM or PPM file (P1-P6) or of one
    of PIL's own kinds (P0CMYK, Pf, PyP, PyRGBA, PyCMYK), as PIL's
    `convert("RGB")` of it."""
    data = bytes(data)
    magic, pos = b"", 0
    for _ in range(6):  # PpmImageFile._read_magic
        c = data[pos:pos + 1]
        pos += len(c)
        if not c or c in _WHITESPACE:
            break
        magic += c
    if magic not in _PNM_MODES:
        raise DecodeError(f"PNM kind {magic!r} is not one PIL reads (P1-P6, P0CMYK, Pf, PyP, "
                          "PyRGBA, PyCMYK are)")
    mode = _PNM_MODES[magic]
    width, pos = _pnm_token(data, pos)
    height, pos = _pnm_token(data, pos)
    maxval = 1
    if mode == "F":
        token, pos = _pnm_field(data, pos)
        try:
            scale = float(token)
        except ValueError as e:
            raise DecodeError(f"PNM: scale {token!r} is not a number") from e
        if scale == 0.0 or not np.isfinite(scale):
            raise DecodeError("PNM: scale must be finite and non-zero")
    elif mode != "1":
        maxval, pos = _pnm_token(data, pos)
        if not 0 < maxval < 65536:
            raise DecodeError(f"PNM: maxval {maxval} outside 1-65535")
        if maxval > 255 and mode == "L":
            mode = "I"
    if width <= 0 or height <= 0:
        raise DecodeError(f"PNM: empty image {width}x{height}")
    _check_size(width, height)
    if mode == "F":  # float32 rows, bottom first, little-endian where the scale is negative
        rows = _rows(data, pos, height, 4 * width, 4 * width, True)
        dtype = "<f4" if scale < 0 else ">f4"
        return to_rgb("F", np.ascontiguousarray(rows).view(dtype).reshape(height, width))
    bands = _PNM_BANDS.get(mode, 1)
    count = width * height * bands
    shape = (height, width, bands) if bands > 1 else (height, width)
    out_max = 65535 if mode == "I" else 255
    black = palette256([]) if mode == "P" else None  # PIL gives PyP no palette
    if magic == b"P1":
        return to_rgb("1", _pnm_plain_bits(data, pos, count).reshape(shape) * np.uint8(255))
    if magic in (b"P2", b"P3"):
        return to_rgb(mode, _pnm_plain_values(data, pos, count, maxval, out_max).reshape(shape))
    if magic == b"P4":  # rows of bits, 1 black
        rows = _rows(data, pos, height, -(-width // 8), -(-width // 8), False)
        return to_rgb("1", (1 - unpack_bits(rows, 1, width)) * np.uint8(255))
    if maxval == 255:
        return to_rgb(mode, _rows(data, pos, 1, count, count, False).reshape(shape), black)
    size = 1 if maxval < 256 else 2
    raw = _rows(data, pos, 1, count * size, count * size, False)[0]
    v = raw.astype(np.int64) if size == 1 else raw.view(">u2").astype(np.int64)
    if maxval == 65535 and mode == "I":  # PIL reads these raw (I;16B)
        return to_rgb(mode, v.reshape(shape))
    return to_rgb(mode, np.minimum(out_max, np.round(v / maxval * out_max)).astype(
        np.int64).reshape(shape), black)


# ---------------------------------------------------------------------------
# BMP

_BMP_HEADERS = (12, 40, 52, 56, 64, 108, 124)
_BMP_RAW = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}
# BITFIELDS layouts PIL reads: (bits, masks) -> raw mode (BmpImagePlugin MASK_MODES)
_BMP_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_RAW_BITS = {"1": 1, "P;1": 1, "P;4": 4, "P": 8, "L": 8, "BGR;15": 16, "BGR;16": 16, "BGR": 24}


def decode_bmp(data: bytes, dib: bool = False, halve: bool = False) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a BMP file, or of a DIB (a BMP without its
    14-byte file header, as PIL's DibImageFile), as PIL's
    `convert("RGB")` of it; `halve`: the first half of the rows in file
    order only (an icon's or cursor's image, its header's height counting
    the mask after it too)."""
    data = bytes(data)
    if dib:
        pos, offset = 0, 0
    else:
        if data[:2] != b"BM":
            raise DecodeError("not a BMP file")
        pos, offset = 14, _u32(data, 10)
    header_size = _u32(data, pos)
    if header_size not in _BMP_HEADERS:
        raise DecodeError(f"BMP header of {header_size} bytes is not supported")
    hd = data[pos + 4:pos + header_size]
    if len(hd) < header_size - 4:
        raise DecodeError("truncated file inside the BMP header")
    pos += header_size
    if header_size == 12:  # OS/2 1.x
        width, height, _, bits = struct.unpack("<4H", hd[:8])
        compression, colors, padding, bottom_up = 0, 0, 3, True
    else:
        top_down = hd[7] == 0xFF
        width, height = _u32(hd, 0), _u32(hd, 4)
        if top_down:
            height = 2 ** 32 - height
        bits, compression, colors = _u16(hd, 10), _u32(hd, 12), _u32(hd, 28)
        padding, bottom_up = 4, not top_down
        if compression == 3:  # BITFIELDS
            if len(hd) >= 48:
                masks = [_u32(hd, 36 + 4 * i) for i in range(4 if len(hd) >= 52 else 3)]
            else:  # after a 40-byte header
                masks = [_u32(data, pos + 4 * i) for i in range(3)]
                pos += 12
            masks += [0] * (4 - len(masks))
    colors = colors or 1 << bits
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in _BMP_RAW:
        raise DecodeError(f"BMP pixel depth {bits} is not supported")
    raw = _BMP_RAW[bits]
    if compression == 3:
        key = (bits, tuple(masks)) if bits == 32 else (bits, tuple(masks[:3]))
        if key not in _BMP_MASKS:
            raise DecodeError(f"BMP bitfields layout {bits} bits {[hex(m) for m in masks]} is "
                              "not one PIL reads")
        raw = _BMP_MASKS[key]
    elif compression not in (0, 1, 2):
        kind = {4: "JPEG", 5: "PNG"}.get(compression, str(compression))
        raise DecodeError(f"BMP compression {kind} is not supported")
    rle = compression in (1, 2)
    mode, palette = "RGB", None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise DecodeError(f"BMP palette of {colors} colours")
        pal = data[pos:pos + padding * colors]
        pos += len(pal)
        entries = [pal[i * padding:i * padding + 3] for i in range(colors)]
        want = (0, 255) if colors == 2 else range(colors)
        if all(e == bytes([v & 255]) * 3 for e, v in zip(entries, want)):
            mode = "1" if colors == 2 else "L"  # PIL drops a grey palette
            raw = mode
        else:
            mode = "P"
            table = np.frombuffer(pal[:len(pal) - len(pal) % padding], np.uint8)
            palette = palette256(table.reshape(-1, padding)[:, 2::-1])
    if halve:
        height //= 2
    if width <= 0 or height <= 0 or width >= 2 ** 31 or height >= 2 ** 31:
        raise DecodeError(f"BMP of {width}x{height} pixels")
    _check_size(width, height)
    start = offset or pos
    if rle:
        if mode not in ("P", "L"):  # PIL's RLE decoder writes P or L
            raise DecodeError(f"BMP: RLE at {bits} bits with a {mode} image")
        px = _bmp_rle(data, start, width, height, compression == 2)
        px = np.frombuffer(px, np.uint8, width * height).reshape(height, width)
        return to_rgb(mode, px[::-1] if bottom_up else px, palette)
    if raw in _RAW_BITS:
        row_bits = _RAW_BITS[raw]
    else:
        row_bits = 8 * len(raw)
    row_bytes = (width * row_bits + 7) // 8
    stride = ((width * bits + 31) >> 3) & ~3
    if stride < row_bytes:
        raise DecodeError(f"BMP: {raw} samples in {bits}-bit rows")
    rows = _rows(data, start, height, row_bytes, stride, bottom_up)
    return _bmp_pixels(rows, raw, mode, width, palette)


def _bmp_pixels(rows, raw: str, mode: str, width: int, palette):
    if raw == "1":
        return to_rgb("1", unpack_bits(rows, 1, width) * np.uint8(255))
    if raw in ("P;1", "P;4"):
        return to_rgb(mode, unpack_bits(rows, int(raw[2:]), width), palette)
    if raw in ("P", "L"):
        return to_rgb(mode, rows[:, :width], palette)
    if raw == "BGR;15":
        return _fifteen(rows, width)
    if raw == "BGR;16":
        p = rows[:, :2 * width].reshape(rows.shape[0], width, 2).astype(np.int64)
        p = p[..., 0] | (p[..., 1] << 8)
        return np.stack([five_bits(p >> 11), ((p >> 5) & 63) * 255 // 63, five_bits(p)],
                        -1).astype(np.uint8)
    return np.ascontiguousarray(_channels(rows, width, raw))


def _bmp_rle(data: bytes, pos: int, width: int, height: int, rle4: bool) -> bytes:
    """BmpRleDecoder: the pixels, a byte each, bottom row first as stored;
    its quirks kept (a delta skips two bytes before its offsets; an RLE4
    absolute run of odd length drops its last pixel; absolute runs align to
    an even file offset)."""
    out, x, total, n = bytearray(), 0, width * height, len(data)
    while len(out) < total:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:  # a run
            count = min(count, max(0, width - x))
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += pair * (count // 2) + pair[:count % 2]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:  # end of line
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta
            if pos + 2 > n:
                break
            pos += 2
            if pos + 2 > n:
                raise DecodeError("BMP: truncated RLE delta")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * width)
            x = len(out) % width
        else:  # an absolute run of `byte` pixels
            size = byte // 2 if rle4 else byte
            got = data[pos:pos + size]
            pos += len(got)
            if rle4:
                v = np.frombuffer(got, np.uint8)
                out += np.stack([v >> 4, v & 15], 1).tobytes()
            else:
                out += got
            if len(got) < size:
                break
            x += byte
            pos += pos % 2
    if len(out) < total:
        raise DecodeError("BMP: not enough RLE image data")
    return bytes(out)


# ---------------------------------------------------------------------------
# TGA

_TGA_RAW = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
            (2, 24): "BGR", (2, 32): "BGRA"}


def tga_header_ok(data: bytes) -> bool:
    """TgaImageFile._open's checks before it reads a palette: what makes
    PIL take a file with no magic number for a TGA."""
    if len(data) < 18:
        return False
    w, h = _u16(data, 12), _u16(data, 14)
    return (data[1] in (0, 1) and w > 0 and h > 0 and data[16] in (1, 8, 16, 24, 32)
            and data[2] in (1, 2, 3, 9, 10, 11))


def decode_tga(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a Targa file, as PIL's `convert("RGB")` of
    it."""
    data = bytes(data)
    if not tga_header_ok(data):
        raise DecodeError("not a TGA file")
    id_len, cmap, kind = data[0], data[1], data[2]
    width, height, depth, flags = _u16(data, 12), _u16(data, 14), data[16], data[17]
    if kind in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif kind in (1, 9):
        mode = "P" if cmap else "L"
    else:
        mode = "RGB" if depth == 24 else "RGBA"
    pos = 18 + id_len
    palette = None
    if cmap:
        start, size, map_depth = _u16(data, 3), _u16(data, 5), data[7]
        # PIL fails to load a map of 32 bits, or one beside true colour
        if map_depth not in (16, 24) or mode != "P":
            raise DecodeError(f"TGA colour map of {map_depth} bits on image type {kind}")
        k = map_depth // 8
        raw_pal = data[pos:pos + k * size]
        pos += len(raw_pal)
        raw_pal = bytes(k * start) + raw_pal
        entries = np.frombuffer(raw_pal[:len(raw_pal) - len(raw_pal) % k], np.uint8)
        entries = entries.reshape(-1, k)
        if k == 2:
            palette = palette256(_fifteen(entries.reshape(1, -1), entries.shape[0])[0])
        else:
            palette = palette256(entries[:, 2::-1])
    raw = _TGA_RAW.get((kind & 7, depth))
    if raw is None or (mode == "L" and raw == "P") or (kind & 8 and depth == 1):
        raise DecodeError(f"TGA image type {kind} at {depth} bits is not one PIL decodes")
    _check_size(width, height)
    row_bytes = (width * depth + 7) // 8
    bottom_up = flags & 0x20 == 0
    if kind & 8:
        buf = _tga_rle(data, pos, height * row_bytes, row_bytes, (depth + 7) // 8)
        rows = np.frombuffer(buf, np.uint8).reshape(height, row_bytes)
        rows = rows[::-1] if bottom_up else rows
    else:
        rows = _rows(data, pos, height, row_bytes, row_bytes, bottom_up)
    if raw == "1":
        px, mode = unpack_bits(rows, 1, width) * np.uint8(255), "1"
    elif raw in ("P", "L"):
        px = rows
    elif raw == "LA":
        px = rows.reshape(height, width, 2)
    elif raw == "BGRA;15Z":
        px, mode = _fifteen(rows, width), "RGB"
    else:
        px, mode = _channels(rows, width, raw), "RGB"
    rgb = to_rgb(mode, px, palette)
    return np.ascontiguousarray(rgb[:, ::-1]) if flags & 0x10 else rgb


def _tga_rle(data: bytes, pos: int, total: int, row_bytes: int, size: int) -> bytes:
    """TgaRleDecode.c: packets of (count & 0x7f) + 1 pixels of `size` bytes,
    a run (one pixel repeated) when the high bit is set; a literal packet
    may cross rows, a run may not."""
    out, n = bytearray(), len(data)
    while len(out) < total:
        if pos >= n:
            raise DecodeError("TGA: truncated RLE image data")
        head = data[pos]
        count = size * ((head & 0x7F) + 1)
        if head & 0x80:
            if pos + 1 + size > n:
                raise DecodeError("TGA: truncated RLE image data")
            if len(out) % row_bytes + count > row_bytes:
                raise DecodeError("TGA: an RLE run crosses a row")
            out += data[pos + 1:pos + 1 + size] * (count // size)
            pos += 1 + size
        else:
            if pos + 1 + count > n:
                raise DecodeError("TGA: truncated RLE image data")
            out += data[pos + 1:pos + 1 + count]
            pos += 1 + count
    return bytes(out[:total])


# ---------------------------------------------------------------------------
# GIF

def _gif_blocks(data: bytes, pos: int):
    """The bytes of a run of data sub-blocks and the offset past its
    terminator (or the end of the file)."""
    parts = []
    while pos < len(data) and data[pos]:
        parts.append(data[pos + 1:pos + 1 + data[pos]])
        pos += 1 + data[pos]
    return b"".join(parts), pos + 1


def _gif_palette(p: bytes):
    """An (n, 3) palette, or None where PIL drops it: p[i] == i in every
    channel (GifImageFile._is_palette_needed)."""
    if len(p) % 3:
        raise DecodeError("GIF: truncated colour table")
    entries = np.frombuffer(p, np.uint8).reshape(-1, 3)
    if (entries == np.arange(entries.shape[0])[:, None]).all():
        return None
    return entries


def decode_gif(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a GIF file's first frame, as PIL's
    `convert("RGB")` of it: a palette image (mode P), or grey (mode L)
    where neither table is needed."""
    data = bytes(data)
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise DecodeError("not a GIF file")
    width, height = _u16(data, 6), _u16(data, 8)
    flags, pos = data[10], 13
    palette = None
    if flags & 0x80:
        table = data[pos:pos + (3 << ((flags & 7) + 1))]
        pos += len(table)
        palette = _gif_palette(table)
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise DecodeError("GIF: no image in the file")
        kind = data[pos]
        pos += 1
        if kind == 0x21:  # an extension
            label = data[pos] if pos < len(data) else 0
            first = data[pos + 2:pos + 2 + data[pos + 1]] if pos + 1 < len(data) else b""
            if label == 0xF9 and pos + 1 < len(data) and data[pos + 1]:
                if len(first) < 4:
                    raise DecodeError("GIF: short graphic control extension")
                if first[0] & 1:
                    transparency = first[3]
            _, pos = _gif_blocks(data, pos + 1)
        elif kind == 0x2C:  # the image descriptor
            if pos + 10 > len(data):
                raise DecodeError("GIF: truncated image descriptor")
            x0, y0, w, h = struct.unpack("<4H", data[pos:pos + 8])
            local = data[pos + 8]
            pos += 9
            if local & 0x80:  # PIL keeps the global table where the local one is not needed
                table = data[pos:pos + (3 << ((local & 7) + 1))]
                pos += len(table)
                needed = _gif_palette(table)
                palette = palette if needed is None else needed
            break
    width, height = max(width, x0 + w), max(height, y0 + h)
    _check_size(width, height)
    if pos >= len(data):
        raise DecodeError("GIF: truncated image data")
    min_size = data[pos]
    stream, _ = _gif_blocks(data, pos + 1)
    interlaced = bool(local & 0x40)
    fill = transparency if transparency is not None else 0
    canvas = np.full((height, width), fill, np.uint8)
    if w and h:
        sub = np.frombuffer(_gif_lzw(stream, min_size, w * h), np.uint8).reshape(h, w)
        if interlaced:  # coding order: every 8th row from 0, from 4, every 4th from 2, 2nd from 1
            order = np.concatenate([np.arange(h)[s::d] for s, d in ((0, 8), (4, 8), (2, 4),
                                                                     (1, 2))])
            sub = sub[np.argsort(order)]
        canvas[y0:y0 + h, x0:x0 + w] = sub
    if palette is None:
        return to_rgb("L", canvas)
    return to_rgb("P", canvas, palette256(palette))


def _gif_lzw(stream: bytes, min_size: int, count: int) -> bytes:
    """GIF's LZW: `count` pixels of the code stream (codes LSB first, the
    width growing to 12 bits; a full table takes no more entries until a
    clear code)."""
    if not 1 <= min_size <= 11:
        raise DecodeError(f"GIF: LZW code size {min_size}")
    clear, end = 1 << min_size, (1 << min_size) + 1
    nbits = 8 * len(stream)
    buf = np.frombuffer(stream + bytes(4), np.uint8).astype(np.uint32)
    words = (buf[:-3] | (buf[1:-2] << 8) | (buf[2:-1] << 16)).tolist()
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table, size, prev = list(base), min_size + 1, None
    out, p = bytearray(), 0
    while len(out) < count:
        if p + size > nbits:
            raise DecodeError("GIF: the image data ends before the image")
        code = (words[p >> 3] >> (p & 7)) & ((1 << size) - 1)
        p += size
        if code == clear:
            table, size, prev = list(base), min_size + 1, None
            continue
        if code == end:
            raise DecodeError("GIF: the end code comes before the image's last pixel")
        if code < len(table) and code != clear and code != end:
            entry = table[code]
        elif code == len(table) and prev is not None:
            entry = prev + prev[:1]
        else:
            raise DecodeError(f"GIF: bad LZW code {code}")
        out += entry
        if prev is not None and len(table) < 4096:
            table.append(prev + entry[:1])
            if len(table) == 1 << size and size < 12:
                size += 1
        prev = entry
    return bytes(out[:count])
