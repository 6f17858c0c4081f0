"""TIFF decoding in numpy and the standard library: the first page of a
baseline TIFF and the common compressions, as PIL opens it.

`decode_tiff` returns the (H, W, 3) uint8 pixels, top row first, that PIL's
`Image.open(f).convert("RGB")` gives, byte for byte. PIL reads an
uncompressed file itself (TiffImagePlugin: one raw tile a strip or tile,
placed in turn, the predictor left as stored) and hands a compressed one to
libtiff, which undoes the compression, the fill order and the predictor;
both paths are kept here. The samples are then read into the PIL mode of
TiffImagePlugin's OPEN_INFO table and converted (utils/pil_modes), and an
orientation tag is applied as PIL's load does (ImageOps.exif_transpose).

  compression  none (1), LZW (5, libtiff's "new" codes: MSB first, the width
               growing a code early), Deflate (8 and 32946), PackBits
               (32773); predictor 2 (horizontal differencing, 8 and 16 bits);
               JPEG (7: each strip's or tile's stream by utils/image_decode,
               with the JPEGTables tag's tables, YCbCr converted to RGB by
               libjpeg as PIL asks; libtiff's checks of each stream's
               components, sampling and size) and old-style JPEG (6: the
               JPEGInterchangeFormat stream in one strip, or the tables in
               tags 519-521 in any number of strips; libjpeg's raw planes,
               then libtiff's YCbCr to RGB with chroma repeated)
  layout       strips and tiles, chunky and planar (PlanarConfiguration 2)
  photometric  bilevel and grey (0, 1) at 1, 2, 4, 8 and 16 bits, palette
               (3) at 1, 2, 4 and 8, RGB (2) and CMYK (5) at 8 and 16, with
               their extra samples (alpha, premultiplied alpha, unspecified);
               YCbCr (6) under JPEG

Anything else (CCITT, LZMA, ZSTD, WebP, old-style LZW, YCbCr under another
compression or planar, CIELab, floating point, BigTIFF, an old-style JPEG
interchange format in several strips or with other YCbCr coefficients or
reference values than the defaults) raises DecodeError naming it, as does
corrupt or truncated data; nothing returns a partial image.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .image import _segment
from .image_decode import (MAX_PIXELS, DecodeError, Tables, _check_size, decode_jpeg_planes,
                           decode_jpeg_samples, read_frame, read_tables)
from .pil_modes import cmyk_to_rgb, palette256, scale_bits, to_rgb, unpack_bits

# TiffImagePlugin.COMPRESSION_INFO: the ones decoded here, and the others' names
_COMPRESSIONS = {1: "none", 5: "LZW", 6: "old-style JPEG", 7: "JPEG", 8: "Deflate",
                 32946: "Deflate", 32773: "PackBits"}
_OTHER_COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                       32771: "RAW_16", 32809: "ThunderScan",
                       34676: "SGILog", 34677: "SGILog24", 34925: "LZMA", 50000: "ZSTD",
                       50001: "WebP"}
# tag -> (id, read as one value)
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_FILL_ORDER, _STRIP_OFFSETS, _ORIENTATION, _SAMPLES, _ROWS_PER_STRIP = 266, 273, 274, 277, 278
_STRIP_COUNTS, _PLANAR, _PREDICTOR, _COLORMAP = 279, 284, 317, 320
_TILE_WIDTH, _TILE_LENGTH, _TILE_OFFSETS, _TILE_COUNTS = 322, 323, 324, 325
_EXTRA, _SAMPLE_FORMAT = 338, 339
_JPEG_TABLES, _YCBCR_SUBSAMPLING = 347, 530
# old-style JPEG (TIFF 6.0 section 22): the interchange format's offset and
# length, the restart interval, the tables' offsets (libtiff ignores the
# process tag, 512); libtiff's YCbCr conversion (tif_getimage.c) reads the
# coefficients and reference values
_JIF, _JIF_LENGTH, _JPEG_RESTART = 513, 514, 515
_JPEG_QTABLES, _JPEG_DCTABLES, _JPEG_ACTABLES = 519, 520, 521
_YCBCR_COEFFICIENTS, _REFERENCE_BW = 529, 532
_YCBCR_DEFAULTS = {_YCBCR_COEFFICIENTS: (0.299, 0.587, 0.114),
                   _REFERENCE_BW: (0, 255, 128, 255, 128, 255)}
_SCALARS = {_WIDTH, _LENGTH, _COMPRESSION, _PHOTOMETRIC, _FILL_ORDER, _ORIENTATION, _SAMPLES,
            _ROWS_PER_STRIP, _PLANAR, _PREDICTOR, _TILE_WIDTH, _TILE_LENGTH}
# field type -> (struct code, bytes); the integer types (the others are skipped)
_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("L", 4), 6: ("b", 1), 8: ("h", 2), 9: ("l", 4),
          13: ("L", 4), 16: ("Q", 8)}
_TYPE_SIZES = {2: 1, 5: 8, 7: 1, 10: 8, 11: 4, 12: 8, 17: 8, 18: 8}

# OPEN_INFO's keys decoded here, without the byte order: (photometric,
# sample format, bits, extra samples) -> (PIL mode, how the samples read).
# "inv" samples are inverted (photometric 0), "pre" is premultiplied alpha.
_MODES = {}
for _photo in (0, 1):
    _MODES[(_photo, (1,), (1,), ())] = ("1", "inv" if _photo == 0 else "")
    for _b in (2, 4, 8):
        _MODES[(_photo, (1,), (_b,), ())] = ("L", "inv" if _photo == 0 else "")
_MODES[(1, (2,), (8,), ())] = ("L", "")
_MODES[(0, (1,), (16,), ())] = ("I;16", "")  # PIL reads it as I;16, not inverted
_MODES[(1, (1,), (16,), ())] = ("I;16", "")
_MODES[(1, (2,), (16,), ())] = ("I", "signed")
_MODES[(1, (1,), (8, 8), (2,))] = ("LA", "")
for _b in (8, 16):
    _MODES[(2, (1,), (_b,) * 3, ())] = ("RGB", "")
    _MODES[(2, (1,), (_b,) * 4, ())] = ("RGBA", "")
    _MODES[(2, (1,), (_b,) * 4, (0,))] = ("RGB", "")
    _MODES[(2, (1,), (_b,) * 4, (1,))] = ("RGBA", "pre")
    _MODES[(2, (1,), (_b,) * 4, (2,))] = ("RGBA", "")
    _MODES[(5, (1,), (_b,) * 4, ())] = ("CMYK", "")
for _extra in ((0, 0), (0, 0, 0), (2, 0), (2, 0, 0), (1, 0), (1, 0, 0)):
    _MODES[(2, (1,), (8,) * (3 + len(_extra)), _extra)] = (
        "RGBA" if _extra[0] else "RGB", "pre" if _extra[0] == 1 else "")
_MODES[(2, (1,), (8, 8, 8, 8), (999,))] = ("RGBA", "")
for _extra in ((0,), (0, 0)):
    _MODES[(5, (1,), (8,) * (4 + len(_extra)), _extra)] = ("CMYK", "")
for _b in (1, 2, 4, 8):
    _MODES[(3, (1,), (_b,), ())] = ("P", "")
_MODES[(3, (1,), (8, 8), (0,))] = ("P", "")
_MODES[(3, (1,), (8, 8), (2,))] = ("PA", "")
# the keys OPEN_INFO also holds at fill order 2 (PIL's ";R" raw modes; 16 bits
# only little-endian); a file of another key at fill order 2 fails to open
_REVERSED = {(p, (1,), (b,), ()) for p in (0, 1) for b in (1, 2, 4, 8)} | {
    (3, (1,), (b,), ()) for b in (1, 2, 4, 8)} | {(2, (1,), (8, 8, 8), ()), (1, (1,), (16,), ())}


_PHOTO_NAMES = {0: "min-is-white", 1: "min-is-black", 2: "RGB", 3: "palette", 5: "CMYK",
                6: "YCbCr", 8: "CIELab"}


def _ifd(data: bytes, pos: int, endian: str) -> dict:
    """The first IFD's fields: tag -> tuple of values (integers; other
    types as raw bytes). As PIL's ImageFileDirectory_v2.load, a field of a
    type it does not know is skipped, and a truncated directory ends the
    reading (keeping the fields read)."""
    if pos + 2 > len(data):
        raise DecodeError("TIFF: truncated file: no image directory")
    (count,) = struct.unpack_from(endian + "H", data, pos)
    tags, pos = {}, pos + 2
    for _ in range(count):
        if pos + 12 > len(data):
            break
        tag, kind, n, value = struct.unpack_from(endian + "HHL4s", data, pos)
        pos += 12
        if kind in _TYPES:
            code, size = _TYPES[kind]
        elif kind in _TYPE_SIZES:
            code, size = None, _TYPE_SIZES[kind]
        else:
            continue
        if n * size > 4:
            (at,) = struct.unpack(endian + "L", value)
            if at + n * size > len(data):
                break
            raw = data[at:at + n * size]
        else:
            raw = value[:n * size]
        if not raw:
            continue
        tags[tag] = struct.unpack(endian + code * n, raw) if code else raw
    return tags


def _get(tags: dict, tag: int, default=None):
    v = tags.get(tag)
    if v is None:
        return default
    if tag in _SCALARS:
        if isinstance(v, bytes) or len(v) != 1:
            raise DecodeError(f"TIFF: tag {tag} holds {len(v)} values where one is expected")
        return v[0]
    if isinstance(v, bytes):
        raise DecodeError(f"TIFF: tag {tag} is not integers")
    return v


_BIT_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _reverse_bits(buf: np.ndarray) -> np.ndarray:
    """Each byte with its bits in the other order (fill order 2)."""
    return _BIT_REVERSED[buf]


# ---------------------------------------------------------------------------
# the codecs: each turns one strip's or tile's bytes into `size` bytes

def _lzw(src: bytes, size: int) -> bytes:
    """libtiff's LZWDecode (new-style codes): MSB first, 9 to 12 bits, the
    width growing when the next entry is 511, 1023 or 2047; 256 clears, 257
    ends. Decodes `size` bytes; fewer is an error."""
    if len(src) >= 2 and src[0] == 0 and src[1] & 1:
        raise DecodeError("TIFF: old-style LZW codes are not supported")
    nbits = 8 * len(src)
    buf = np.frombuffer(bytes(src) + bytes(4), np.uint8).astype(np.uint32)
    words = ((buf[:-3] << 16) | (buf[1:-2] << 8) | buf[2:-1]).tolist()  # 24 bits at each byte
    base = [bytes([i]) for i in range(256)] + [b"", b""]
    table, width, prev = list(base), 9, None
    out, p = bytearray(), 0
    while len(out) < size and p + width <= nbits:
        code = (words[p >> 3] >> (24 - (p & 7) - width)) & ((1 << width) - 1)
        p += width
        if code == 256:
            table, width, prev = list(base), 9, None
            continue
        if code == 257:
            break
        if prev is None:
            if code > 255:
                raise DecodeError(f"TIFF: corrupt LZW data (code {code} after a clear)")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
        elif code == len(table):
            entry = prev + prev[:1]
        else:
            raise DecodeError(f"TIFF: corrupt LZW data (code {code})")
        out += entry
        if prev is not None and len(table) < 4096:
            table.append(prev + entry[:1])
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
        prev = entry
    if len(out) < size:
        raise DecodeError("TIFF: not enough LZW data for a strip")
    return bytes(out[:size])


def _packbits(src: bytes, size: int) -> bytes:
    """libtiff's PackBitsDecode: a header n < 128 copies n + 1 bytes, n > 128
    repeats the next byte 257 - n times, 128 is nothing."""
    out, pos, n = bytearray(), 0, len(src)
    while pos < n and len(out) < size:
        head = src[pos]
        pos += 1
        if head < 128:
            chunk = src[pos:pos + head + 1]
            pos += head + 1
            out += chunk
        elif head > 128:
            if pos >= n:
                break
            out += src[pos:pos + 1] * (257 - head)
            pos += 1
    if len(out) < size:
        raise DecodeError("TIFF: not enough PackBits data for a strip")
    return bytes(out[:size])


def _deflate(src: bytes, size: int) -> bytes:
    try:
        out = zlib.decompressobj().decompress(src, size)
    except zlib.error as e:
        raise DecodeError(f"TIFF: corrupt Deflate data: {e}") from e
    if len(out) < size:
        raise DecodeError("TIFF: not enough Deflate data for a strip")
    return out


_CODECS = {5: _lzw, 8: _deflate, 32946: _deflate, 32773: _packbits}


def _undo_predictor(block: np.ndarray, bits: int, spp: int, endian: str) -> np.ndarray:
    """Horizontal differencing undone on (rows, rowbytes) uint8: a running
    sum along each row, one per sample of a pixel, modulo the sample's
    range, as libtiff does on samples in the file's byte order."""
    dtype = np.uint8 if bits == 8 else np.dtype(endian + "u2")
    s = block.view(dtype).reshape(block.shape[0], -1, spp)
    return np.cumsum(s, 1, dtype=dtype).astype(dtype).view(np.uint8).reshape(block.shape)


# ---------------------------------------------------------------------------

def decode_tiff(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a TIFF file's first page, as PIL's
    `convert("RGB")` of it."""
    data = bytes(data)
    head = data[:4]
    if head in (b"MM\x00\x2b", b"II\x2b\x00"):
        raise DecodeError("BigTIFF is not supported")
    if head not in (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a") or len(data) < 8:
        raise DecodeError("not a TIFF file")
    endian = "<" if head[:2] == b"II" else ">"
    tags = _ifd(data, struct.unpack_from(endian + "L", data, 4)[0], endian)
    if 0xBC01 in tags:
        raise DecodeError("TIFF: Windows Media Photo data is not supported")
    comp = _get(tags, _COMPRESSION, 1)
    if comp not in _COMPRESSIONS:
        raise DecodeError(f"TIFF compression {_OTHER_COMPRESSIONS.get(comp, comp)} is not "
                          "supported")
    planar = _get(tags, _PLANAR, 1)
    # PIL reads an old-style JPEG file as YCbCr, whatever its photometric tag
    photo = 6 if comp == 6 else _get(tags, _PHOTOMETRIC, 0)
    fill = _get(tags, _FILL_ORDER, 1)
    if _WIDTH not in tags or _LENGTH not in tags:
        raise DecodeError("TIFF: missing dimensions")
    width, height = _get(tags, _WIDTH), _get(tags, _LENGTH)
    fmt = _get(tags, _SAMPLE_FORMAT, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bits = _get(tags, _BITS, (1,))
    extra = _get(tags, _EXTRA, ())
    spp = _get(tags, _SAMPLES, 3 if comp == 6 else 1)
    if spp > 6:
        raise DecodeError(f"TIFF: {spp} samples a pixel")
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) and len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp:
        raise DecodeError("TIFF: unknown data organisation")
    key = (photo, fmt, bits, extra)
    mode, how = _MODES.get(key, (None, None))
    if comp in (6, 7) and key == (6, (1,), (8, 8, 8), ()) and planar == 1:
        mode, how = "RGB", ""  # converted by libjpeg (JPEGCOLORMODE_RGB) or libtiff
    elif comp == 6 and key == (6, (1,), (8,), ()):
        mode, how = "L", ""
    # PIL has no P;1R, P;2R, P;4R or L;IR raw mode for an uncompressed file
    known = mode is not None and (fill == 1 or fill == 2 and key in _REVERSED and not (
        comp == 1 and (mode == "P" and bits[0] < 8 or photo == 0 and bits == (8,))))
    if endian == ">" and bits == (16,) and (photo == 0 or fill == 2):
        known = False  # OPEN_INFO holds these little-endian only
    if known and planar == 2 and len(bits) > 1:
        # the planar files PIL reads as stored: uncompressed, R, G, B, A and
        # C, M, Y, K planes (8-bit unpackers, whatever the depth); compressed,
        # a plane a band of the mode, or unused planes too in tiles
        if comp == 1:
            known = mode in ("RGB", "RGBA", "CMYK") and how != "pre" and len(bits) == len(mode)
        else:
            known = mode not in ("P", "PA") and not (mode == "RGBA" and extra == ()) and (
                len(bits) == len(mode) or _TILE_OFFSETS in tags)
    if not known:
        raise DecodeError(f"TIFF: {'planar ' if planar == 2 else ''}"
                          f"{_PHOTO_NAMES.get(photo, photo)} at {bits} bits (sample format "
                          f"{fmt}, extra samples {extra}, fill order {fill}, compression "
                          f"{_COMPRESSIONS[comp]}) is not supported")
    if width <= 0 or height <= 0:
        raise DecodeError(f"TIFF: empty image {width}x{height}")
    _check_size(width, height)
    bps, nbands = bits[0], len(bits)
    palette = None
    if mode in ("P", "PA"):
        cmap = _get(tags, _COLORMAP)
        if cmap is None:
            raise DecodeError("TIFF: palette image without a ColorMap")
        cmap = np.asarray(cmap, np.int64) // 256
        third = len(cmap) // 3
        palette = palette256(np.stack([cmap[:third], cmap[third:2 * third],
                                       cmap[2 * third:3 * third]], 1) if third else [])
    if comp == 1:
        samples = _raw_samples(data, tags, width, height, bits, photo, extra, planar, endian,
                               fill)
        if planar == 2:
            bps = 8
    elif comp == 7:
        samples = _jpeg_samples(data, tags, photo, width, height, bps, nbands, planar)
    elif comp == 6:
        samples = _ojpeg_samples(data, tags, width, height, nbands, endian)
    else:
        samples = _libtiff_samples(data, tags, comp, width, height, bps, nbands, planar,
                                   endian, fill)
        if how == "signed" and endian == ">":  # PIL reads libtiff's native order as I;16BS
            samples = samples.byteswap()
    rgb = _to_rgb(samples, mode, how, bps, palette)
    return _orient(rgb, _get(tags, _ORIENTATION, 1))


def _layout(tags, width: int, height: int):
    """(offsets, counts, tile width, tile height) of the strips or tiles."""
    if _STRIP_OFFSETS in tags:
        return (_get(tags, _STRIP_OFFSETS), tags.get(_STRIP_COUNTS), width,
                _get(tags, _ROWS_PER_STRIP, height))
    if _TILE_OFFSETS in tags:
        tw, th = _get(tags, _TILE_WIDTH), _get(tags, _TILE_LENGTH)
        if not tw or not th:
            raise DecodeError("TIFF: invalid tile dimensions")
        if tw * th > MAX_PIXELS:  # a tile is decoded whole before it is cropped
            raise DecodeError(f"TIFF: tiles of {tw}x{th} are more pixels than {MAX_PIXELS:,}")
        return _get(tags, _TILE_OFFSETS), tags.get(_TILE_COUNTS), tw, th
    raise DecodeError("TIFF: no strips or tiles")


def _unpack(rows: np.ndarray, width: int, bps: int, nbands: int, endian: str) -> np.ndarray:
    """(h, rowbytes) uint8 rows -> (h, width, nbands) sample values."""
    h = rows.shape[0]
    if bps == 16:
        return rows[:, :2 * width * nbands].copy().view(endian + "u2").reshape(h, width, nbands)
    if bps == 8:
        return rows[:, :width * nbands].reshape(h, width, nbands)
    return unpack_bits(rows, bps, width * nbands).reshape(h, width, nbands)


def _raw_samples(data, tags, width, height, bits, photo, extra, planar, endian, fill):
    """PIL's own path for an uncompressed file: one raw tile a strip or
    tile at its offset, placed left to right and top to bottom (then the
    next band, planar: 8-bit samples, whatever the depth), the image's zeros
    where no tile reaches, the predictor not undone."""
    offsets, _, tw, th = _layout(tags, width, height)
    nbands = len(bits)
    bps, per = (8, 1) if planar == 2 else (bits[0], nbands)
    if tw == width and th == height and planar != 2:
        offsets = offsets[-1:]
    # a tile past the right edge: PIL's row stride, a plane's share of the
    # pixel's bits (counting the bands the photometric names, plus extras)
    bands = {2: 3, 5: 4}.get(photo, 1) + len(extra)
    partial = int(tw * sum(bits) / 8 / (bands if planar == 2 else 1))
    out = np.zeros((height, width, nbands), np.uint16 if bps == 16 else np.uint8)
    x = y = layer = 0
    for off in offsets:
        x1, y1 = min(x + tw, width), min(y + th, height)
        w, h = x1 - x, y1 - y
        row_bytes = (w * bps * per + 7) // 8
        stride = partial if x + tw > width else row_bytes
        if stride < row_bytes or off + stride * (h - 1) + row_bytes > len(data):
            raise DecodeError("TIFF: truncated image data")
        buf = np.frombuffer(data, np.uint8, stride * (h - 1) + row_bytes, off)
        rows = np.lib.stride_tricks.as_strided(buf, (h, row_bytes), (stride, 1))
        if fill == 2:
            rows = _reverse_bits(rows)
        s = _unpack(rows, w, bps, per, endian)
        if layer < nbands:
            if planar == 2:
                out[y:y1, x:x1, layer] = s[..., 0]
            else:
                out[y:y1, x:x1] = s
        x += tw
        if x >= width:
            x, y = 0, y + th
            if y >= height:
                y, layer = 0, layer + 1
    return out


def _libtiff_samples(data, tags, comp, width, height, bps, nbands, planar, endian, fill):
    """libtiff's path for a compressed file: each strip or tile decoded
    (its bits reversed first under fill order 2), the predictor undone, the
    tiles cropped to the image."""
    offsets, counts, tw, th = _layout(tags, width, height)
    if counts is None or len(counts) < len(offsets):
        raise DecodeError("TIFF: missing strip or tile byte counts")
    # libtiff's LZW and Deflate codecs undo a predictor; PackBits leaves it
    predictor = _get(tags, _PREDICTOR, 1) if comp != 32773 else 1
    if predictor not in (1, 2) or predictor == 2 and bps not in (8, 16):
        raise DecodeError(f"TIFF: predictor {predictor} at {bps} bits is not supported")
    tiled = _TILE_OFFSETS in tags and _STRIP_OFFSETS not in tags
    per = 1 if planar == 2 else nbands
    planes = nbands if planar == 2 else 1
    across, down = -(-width // tw), -(-height // th)
    if len(offsets) < across * down * planes:
        raise DecodeError("TIFF: fewer strips or tiles than the image needs")
    row_bytes = (tw * bps * per + 7) // 8
    out = np.zeros((height, width, nbands), np.uint16 if bps == 16 else np.uint8)
    codec = _CODECS[comp]
    k = 0
    for plane in range(planes):
        for ty in range(down):
            for tx in range(across):
                rows = th if tiled else min(th, height - ty * th)
                src = data[offsets[k]:offsets[k] + counts[k]]
                k += 1
                if fill == 2:
                    src = _reverse_bits(np.frombuffer(src, np.uint8)).tobytes()
                block = np.frombuffer(codec(src, rows * row_bytes), np.uint8)
                block = block.reshape(rows, row_bytes)
                if predictor == 2:
                    block = _undo_predictor(block, bps, per, endian)
                s = _unpack(block, tw, bps, per, endian)
                x0, y0 = tx * tw, ty * th
                x1, y1 = min(x0 + tw, width), min(y0 + rows, height)
                if planar == 2:
                    out[y0:y1, x0:x1, plane] = s[:y1 - y0, :x1 - x0, 0]
                else:
                    out[y0:y1, x0:x1] = s[:y1 - y0, :x1 - x0]
    return out


def _jpeg_samples(data, tags, photo, width, height, bps, nbands, planar):
    """libtiff's JPEG codec (tif_jpeg.c) as PIL drives it: each strip's or
    tile's stream decoded by utils/image_decode with the tables of the
    JPEGTables tag (an abbreviated table-specification stream) and of the
    streams before it, YCbCr (photometric 6) converted to RGB by libjpeg
    (PIL sets JPEGCOLORMODE_RGB), the components of any other photometric
    as decoded (JCS_UNKNOWN). As JPEGPreDecode, a stream of another
    component count or precision, of sampling factors other than the
    YCbCrSubsampling tag's (photometric 6; without the tag, the first
    stream's, as libtiff's JPEGFixupTags reads them) or 1x1, or larger than
    its strip or tile is refused; a last strip coded at the full strip
    height is cut."""
    if bps != 8:
        raise DecodeError(f"TIFF: JPEG of {bps}-bit samples is not supported")
    offsets, counts, tw, th = _layout(tags, width, height)
    if counts is None or len(counts) < len(offsets):
        raise DecodeError("TIFF: missing strip or tile byte counts")
    tiled = _TILE_OFFSETS in tags and _STRIP_OFFSETS not in tags
    across, down = -(-width // tw), -(-height // th)
    planes = nbands if planar == 2 else 1
    if len(offsets) < across * down * planes:
        raise DecodeError("TIFF: fewer strips or tiles than the image needs")
    tables = Tables()
    if _JPEG_TABLES in tags:
        try:
            read_tables(bytes(tags[_JPEG_TABLES]), tables)
        except DecodeError as e:
            raise DecodeError(f"TIFF: bogus JPEGTables field: {e}") from e
    streams = [data[offsets[k]:offsets[k] + counts[k]] for k in range(across * down * planes)]
    sampling = (1, 1)
    if photo == 6:
        sampling = tuple(_get(tags, _YCBCR_SUBSAMPLING, ()))[:2]
        if not sampling:  # JPEGFixupTagsSubsampling: the first stream's, else the default
            first = read_frame(streams[0])
            ok = len(first.ids) == 3 and first.h[0] in (1, 2, 4) and first.v[0] in (1, 2, 4)
            sampling = (first.h[0], first.v[0]) if ok else (2, 2)
    out = np.zeros((height, width, nbands), np.uint8)
    for k, src in enumerate(streams):
        plane, at = divmod(k, across * down)
        band = out[..., plane:plane + 1] if planes > 1 else out
        try:
            _jpeg_place(band, at, src, tables, sampling, photo, tiled, across, tw, th)
        except DecodeError as e:
            raise DecodeError(f"TIFF: JPEG strip or tile {k}: {e}") from e
    return out


def _jpeg_place(out, k, src, tables, sampling, photo, tiled, across, tw, th) -> None:
    """Decode strip or tile k's stream (of a plane, planar) and place it
    in `out`, cropped."""
    height, width, nbands = out.shape
    ty, tx = divmod(k, across)
    x0, y0 = tx * tw, ty * th
    seg_w, seg_h = (tw, th) if tiled else (width, min(th, height - y0))
    frame = read_frame(src)
    if len(frame.ids) != nbands:
        raise DecodeError(f"improper JPEG component count {len(frame.ids)} (expected {nbands})")
    factors = list(zip(frame.h, frame.v))
    if factors[0] != sampling or any(f != (1, 1) for f in factors[1:]):
        raise DecodeError(f"improper JPEG sampling factors {factors} (expected {sampling} "
                          "then 1x1)")
    cut = not tiled and frame.width == seg_w and frame.height > seg_h and y0 + seg_h == height
    if (frame.width, frame.height) != (seg_w, seg_h) and not cut:
        raise DecodeError(f"{frame.width}x{frame.height} where {seg_w}x{seg_h} is expected")
    s, _ = decode_jpeg_samples(src, tables, "ycc" if photo == 6 else "raw")
    x1, y1 = min(x0 + tw, width), min(y0 + seg_h, height)
    out[y0:y1, x0:x1] = s[:y1 - y0, :x1 - x0]


def _ycbcr_constants():
    """tif_getimage.c TIFFYCbCrToRGBInit's D1-D4 for the default luma
    coefficients: float32 arithmetic, FIX(x) = (int)(x * 65536 + 0.5).
    Its Cb-to-green constant is one less than libjpeg's FIX(0.34414)."""
    red, green, blue = np.float32(0.299), np.float32(0.587), np.float32(0.114)
    two = np.float32(2)

    def fix(x) -> int:
        return int(float(x * np.float32(65536)) + 0.5)

    return (fix(two - two * red), -fix(red * (two - two * red) / green),
            fix(two - two * blue), -fix(blue * (two - two * blue) / green))


_D1, _D2, _D3, _D4 = _ycbcr_constants()


def _ycbcr_to_rgb(y, cb, cr) -> np.ndarray:
    """tif_getimage.c TIFFYCbCrtoRGB with the default coefficients and
    reference values (the only ones decoded here)."""
    y, cb, cr = (a.astype(np.int64) for a in (y, cb, cr))
    cb, cr = cb - 128, cr - 128
    rgb = np.stack([y + ((_D1 * cr + 32768) >> 16), y + ((_D4 * cb + 32768 + _D2 * cr) >> 16),
                    y + ((_D3 * cb + 32768) >> 16)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _ojpeg_tables_stream(data, tags, width, height, nbands, strip) -> bytes:
    """The JPEG stream libtiff's old-style codec makes of a strip of bare
    entropy-coded data and the tables in the tags: a DQT, a DC and an AC
    DHT a component (each its own table), the restart interval, a
    baseline SOF (component 0 sampled as YCbCrSubsampling says, 2x2 by
    default, the others 1x1) and an SOS of every component."""
    qt, dc, ac = (_get(tags, t, ()) for t in (_JPEG_QTABLES, _JPEG_DCTABLES, _JPEG_ACTABLES))
    if min(len(qt), len(dc), len(ac)) < nbands:
        raise DecodeError("TIFF: old-style JPEG with fewer tables than components")

    def table(at: int, size: int) -> bytes:
        if at + size > len(data):
            raise DecodeError("TIFF: an old-style JPEG table lies past the end of the file")
        return data[at:at + size]

    out = bytearray(b"\xff\xd8")
    for c in range(nbands):
        out += _segment(0xDB, bytes([c]) + table(qt[c], 64))
    for c in range(nbands):
        for kind, at in ((0x00, dc[c]), (0x10, ac[c])):
            counts = table(at, 16)
            out += _segment(0xC4, bytes([kind | c]) + counts + table(at + 16, sum(counts)))
    restart = _get(tags, _JPEG_RESTART, (0,))[0]
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    h, v = (tuple(_get(tags, _YCBCR_SUBSAMPLING, (2, 2)))[:2] if nbands == 3 else (1, 1))
    out += _segment(0xC0, struct.pack(">BHHB", 8, height, width, nbands) + b"".join(
        bytes([c + 1, (h << 4 | v) if c == 0 else 0x11, c]) for c in range(nbands)))
    out += _segment(0xDA, bytes([nbands]) + b"".join(bytes([c + 1, c << 4 | c])
                                                     for c in range(nbands)) + b"\x00\x3f\x00")
    return bytes(out) + strip + b"\xff\xd9"


def _ojpeg_samples(data, tags, width, height, nbands, endian):
    """libtiff's old-style JPEG codec (tif_ojpeg.c) and YCbCr conversion
    (tif_getimage.c) as PIL drives them. The JPEG stream is the
    JPEGInterchangeFormat's (one strip: its header, then the strip's
    entropy-coded data, unless the strip is a whole stream itself), or each
    strip's is made from the tables in the tags; libjpeg's raw output (no
    upsampling, no colour conversion), then for three components libtiff's
    YCbCr to RGB with each chroma sample repeated over its block of luma
    samples (the stream's own sampling, as OJPEGSubsamplingCorrect reads
    it)."""
    offsets, counts, _, rows = _layout(tags, width, height)
    if _TILE_OFFSETS in tags and _STRIP_OFFSETS not in tags:
        raise DecodeError("TIFF: tiled old-style JPEG is not supported")
    if counts is None or len(counts) < len(offsets):
        raise DecodeError("TIFF: missing strip byte counts")
    if nbands not in (1, 3):
        raise DecodeError(f"TIFF: old-style JPEG of {nbands} components is not supported")
    for tag, default in _YCBCR_DEFAULTS.items():
        raw = tags.get(tag)
        if raw is not None:
            v = np.frombuffer(raw, endian + "u4").reshape(-1, 2)
            if not np.allclose(v[:, 0] / np.maximum(v[:, 1], 1), default[:len(v)]):
                raise DecodeError(f"TIFF: old-style JPEG with tag {tag} other than the "
                                  f"default {default} is not supported")
    strips = -(-height // rows)
    if len(offsets) < strips:
        raise DecodeError("TIFF: fewer strips than the image needs")
    if _JIF in tags:
        if strips > 1:
            raise DecodeError("TIFF: old-style JPEG interchange format in more than one strip "
                              "is not supported")
        strip = data[offsets[0]:offsets[0] + counts[0]]
        at = _get(tags, _JIF)[0]
        jif = data[at:at + _get(tags, _JIF_LENGTH, (len(data),))[0]]
        if strip[:2] == b"\xff\xd8":
            streams = [strip]
        else:  # the interchange format's header up to its first scan, the strip's data
            sos = jif.find(b"\xff\xda")
            if sos < 0:
                raise DecodeError("TIFF: old-style JPEG interchange format without a scan")
            streams = [jif[:sos + 2 + int.from_bytes(jif[sos + 2:sos + 4], "big")] + strip +
                       b"\xff\xd9"]
    elif _JPEG_QTABLES in tags:
        streams = [_ojpeg_tables_stream(data, tags, width, min(rows, height - k * rows), nbands,
                                        data[offsets[k]:offsets[k] + counts[k]])
                   for k in range(strips)]
    else:
        raise DecodeError("TIFF: old-style JPEG with neither JPEGInterchangeFormat nor tables")
    out = np.zeros((height, width, nbands), np.uint8)
    for k, stream in enumerate(streams):
        y0 = k * rows
        h = min(rows, height - y0) if len(streams) > 1 else height
        frame = read_frame(stream)
        if frame.progressive or frame.arith:
            raise DecodeError("TIFF: old-style JPEG of a progressive or arithmetic-coded stream "
                              "is not supported")
        if len(frame.ids) != nbands or (frame.width, frame.height) != (width, h):
            raise DecodeError(f"TIFF: old-style JPEG stream of {len(frame.ids)} components, "
                              f"{frame.width}x{frame.height}, for {nbands} samples of "
                              f"{width}x{h}")
        frame, planes, _ = decode_jpeg_planes(stream)
        if nbands == 1:
            out[y0:y0 + h, :, 0] = planes[0][:h, :width]
            continue
        if any((fh, fv) != (1, 1) for fh, fv in zip(frame.h[1:], frame.v[1:])):
            raise DecodeError("TIFF: old-style JPEG with subsampled chroma components is not "
                              "supported")
        ys, xs = np.arange(h), np.arange(width)
        cb, cr = (p[(ys // frame.v[0])[:, None], xs // frame.h[0]] for p in planes[1:])
        out[y0:y0 + h] = _ycbcr_to_rgb(planes[0][:h, :width], cb, cr)
    return out


def _to_rgb(s: np.ndarray, mode: str, how: str, bps: int, palette) -> np.ndarray:
    """The samples, read as OPEN_INFO's raw mode reads them, converted."""
    if mode == "1":
        on = s[..., 0] == (0 if how == "inv" else 1)
        return to_rgb("1", on * np.uint8(255))
    if mode == "L":
        v = scale_bits(s[..., 0], bps)
        return to_rgb("L", 255 - v if how == "inv" else v)
    if mode in ("I;16", "I"):
        v = s[..., 0].astype(np.int64)
        return to_rgb(mode, v - 65536 * (v >= 32768) if how == "signed" else v)
    if mode in ("P", "PA"):
        return to_rgb("P", s[..., 0], palette)
    v = s.astype(np.int64) >> 8 if bps == 16 else s.astype(np.int64)
    if mode == "LA":
        return to_rgb("L", v[..., 0])
    if mode == "CMYK":
        return cmyk_to_rgb(v[..., :4])
    if how == "pre":  # premultiplied: PIL's RGBa unpacker divides by alpha
        a = v[..., 3:4]
        v = np.where(a == 0, 0, np.where(a == 255, v, np.minimum(v * 255 // np.maximum(a, 1),
                                                                  255)))
    return to_rgb("RGB", v[..., :3].astype(np.uint8))


def _orient(rgb: np.ndarray, orientation: int) -> np.ndarray:
    """ImageOps.exif_transpose's transform for an orientation tag."""
    t = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
         5: lambda a: a.transpose(1, 0, 2), 6: lambda a: np.rot90(a, -1),
         7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1], 8: lambda a: np.rot90(a, 1)}
    return np.ascontiguousarray(t[orientation](rgb)) if orientation in t else rgb
