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
               growing a code early; and the old-style codes, LSB first, the
               width growing a code later, where the first strip starts as
               they do), Deflate (8 and 32946), PackBits (32773), LZMA
               (34925, an xz stream), ZSTD (50000, utils/zstd_decode);
               predictor 2 (horizontal differencing, 8, 16 and 32 bits) and
               3 (libtiff's floating-point byte planes); the CCITT
               compressions RLE (2), Group 3 (3, 1D and 2D by T4Options) and
               Group 4 (4), as libtiff's fax decoders read them
               (utils/ccitt_decode); JPEG (7: each strip's or tile's stream
               by utils/image_decode, with the JPEGTables tag's tables, YCbCr
               converted to RGB by libjpeg as PIL asks; libtiff's checks of
               each stream's components, sampling and size) and old-style
               JPEG (6: the JPEGInterchangeFormat stream in one strip, or the
               tables in tags 519-521 in any number of strips; libjpeg's raw
               planes, then libtiff's YCbCr to RGB with chroma repeated)
  layout       strips and tiles, chunky and planar (PlanarConfiguration 2);
               BigTIFF (little-endian: PIL takes a big-endian BigTIFF header
               for a classic one, and fails)
  photometric  bilevel and grey (0, 1) at 1, 2, 4, 8 and 16 bits and 32-bit
               floats (sample format 3; compressed big-endian floats come from
               libtiff in the host's order, which PIL reads as big-endian
               again), palette (3) at 1, 2, 4 and 8 (planar: one plane), RGB
               (2) and CMYK (5) at 8 and 16, with their extra samples (alpha,
               premultiplied alpha, unspecified; compressed planar RGBA
               without ExtraSamples is libtiff's associated alpha), CIELab
               (8, PIL's LAB); YCbCr (6) under JPEG, uncompressed as PIL's raw
               mode RGBX reads it (4 bytes a pixel, unconverted), and under
               the other compressions through libtiff's RGBA reader
               (YCbCrSubsampling blocks, 2x2 by default, then libtiff's YCbCr
               to RGB)

Anything else (ThunderScan, CCITT RLEW, SGILog, WebP, YCbCr planar under a
compression, 4x4 YCbCr where libtiff's reader misreads its own layout, a
planar palette beside an extra plane, an old-style JPEG interchange format
in several strips or with other YCbCr coefficients or reference values
than the defaults) raises DecodeError naming it, as does corrupt or
truncated data; so does a CCITT or subsampled-YCbCr strip whose data ends
before its rows, where libtiff leaves the rest of its buffer as it was and
PIL shows that memory. Nothing returns a partial image.
"""

from __future__ import annotations

import lzma
import struct
import zlib

import numpy as np

from .ccitt_decode import decode_ccitt
from .image import _segment
from .image_decode import (MAX_PIXELS, DecodeError, Tables, _check_size, decode_jpeg_planes,
                           decode_jpeg_samples, read_frame, read_tables)
from .pil_modes import cmyk_to_rgb, palette256, scale_bits, to_rgb, unpack_bits
from . import zstd_decode

# TiffImagePlugin.COMPRESSION_INFO: the ones decoded here, and the others' names
_COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 5: "LZW",
                 6: "old-style JPEG", 7: "JPEG", 8: "Deflate", 32946: "Deflate",
                 32773: "PackBits", 34925: "LZMA", 50000: "ZSTD"}
_OTHER_COMPRESSIONS = {32771: "CCITT RLEW", 32809: "ThunderScan", 34676: "SGILog",
                       34677: "SGILog24", 50001: "WebP"}
_CCITT = (2, 3, 4)
_TIFF_HEADS = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
               b"II\x2b\x00")
_T4_OPTIONS = 292
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
for _photo in (0, 1):  # F;32F and F;32BF
    _MODES[(_photo, (3,), (32,), ())] = ("F", "")
_MODES[(8, (1,), (8, 8, 8), ())] = ("LAB", "")
_MODES[(6, (1,), (8, 8, 8), ())] = ("RGB", "ycc")  # under other compressions than JPEG
# the keys OPEN_INFO also holds at fill order 2 (PIL's ";R" raw modes; 16 bits
# only little-endian); a file of another key at fill order 2 fails to open
_REVERSED = {(p, (1,), (b,), ()) for p in (0, 1) for b in (1, 2, 4, 8)} | {
    (3, (1,), (b,), ()) for b in (1, 2, 4, 8)} | {(2, (1,), (8, 8, 8), ()), (1, (1,), (16,), ())}


_PHOTO_NAMES = {0: "min-is-white", 1: "min-is-black", 2: "RGB", 3: "palette", 5: "CMYK",
                6: "YCbCr", 8: "CIELab"}


def _ifd(data: bytes, pos: int, endian: str, big: bool = False) -> dict:
    """The first IFD's fields: tag -> tuple of values (integers; other
    types as raw bytes). As PIL's ImageFileDirectory_v2.load, a field of a
    type it does not know is skipped, and a truncated directory ends the
    reading (keeping the fields read). BigTIFF (`big`): an 8-byte count,
    20-byte entries, values of up to 8 bytes in the entry, 8-byte
    offsets."""
    count_fmt, entry_fmt, inline, at_fmt = ("Q", "HHQ8s", 8, "Q") if big else ("H", "HHL4s", 4,
                                                                                "L")
    entry = struct.calcsize("<" + entry_fmt)
    if pos + struct.calcsize(count_fmt) > len(data):
        raise DecodeError("TIFF: truncated file: no image directory")
    (count,) = struct.unpack_from(endian + count_fmt, data, pos)
    tags, pos = {}, pos + struct.calcsize(count_fmt)
    for _ in range(count):
        if pos + entry > len(data):
            break
        tag, kind, n, value = struct.unpack_from(endian + entry_fmt, data, pos)
        pos += entry
        if kind in _TYPES:
            code, size = _TYPES[kind]
        elif kind in _TYPE_SIZES:
            code, size = None, _TYPE_SIZES[kind]
        else:
            continue
        if n * size > inline:
            (at,) = struct.unpack(endian + at_fmt, value)
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


_DTYPES = {1: np.uint8, 2: np.uint8, 4: np.uint8, 8: np.uint8, 16: np.uint16, 32: np.uint32}
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


def _old_lzw(src: bytes) -> bool:
    """libtiff's test for old-style (bit-reversed) LZW codes."""
    return len(src) >= 2 and src[0] == 0 and bool(src[1] & 1)


def _lzw_compat(src: bytes, size: int) -> bytes:
    """libtiff's LZWDecodeCompat (old-style codes): LSB first, 9 to 12 bits,
    the width growing when the next entry is 512, 1024 or 2048; a code
    before the first clear, or one past the table, is an error; the data's
    end is an end code. Decodes `size` bytes; fewer is an error."""
    nbits_total = 8 * len(src)
    buf = np.frombuffer(bytes(src) + bytes(4), np.uint8).astype(np.uint32)
    words = (buf[:-3] | (buf[1:-2] << 8) | (buf[2:-1] << 16)).tolist()  # 24 bits at each byte
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out, p, width, prev = bytearray(), 0, 9, None
    while len(out) < size:
        if nbits_total - p < width:
            break
        code = (words[p >> 3] >> (p & 7)) & ((1 << width) - 1)
        p += width
        if code == 257:
            break
        if code == 256:
            while code == 256:
                table, width = table[:258], 9
                if nbits_total - p < width:
                    code = 257
                    break
                code = (words[p >> 3] >> (p & 7)) & ((1 << width) - 1)
                p += width
            if code == 257:
                break
            if code > 256:
                raise DecodeError("TIFF: corrupted LZW table (old-style codes)")
            out.append(code)
            prev = table[code]
            continue
        if prev is None or len(table) >= 5119:
            raise DecodeError("TIFF: corrupted LZW table (old-style codes)")
        if code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise DecodeError("TIFF: corrupt old-style LZW data (a code past the table)")
        if len(table) > (1 << width) - 1 and width < 12:
            width += 1
        out += entry
        prev = entry
    if len(out) < size:
        raise DecodeError("TIFF: not enough LZW data for a strip")
    return bytes(out[:size])


def _lzma(src: bytes, size: int) -> bytes:
    """libtiff's LZMA codec: an xz stream, `size` bytes of it."""
    try:
        out = lzma.LZMADecompressor(format=lzma.FORMAT_XZ).decompress(src, size)
    except lzma.LZMAError as e:
        raise DecodeError(f"TIFF: corrupt LZMA data: {e}") from e
    if len(out) < size:
        raise DecodeError("TIFF: not enough LZMA data for a strip")
    return out


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


_CODECS = {5: _lzw, 8: _deflate, 32946: _deflate, 32773: _packbits, 34925: _lzma,
           50000: zstd_decode.decompress}


def _undo_predictor(block: np.ndarray, bits: int, spp: int, endian: str) -> np.ndarray:
    """Horizontal differencing undone on (rows, rowbytes) uint8: a running
    sum along each row, one per sample of a pixel, modulo the sample's
    range, as libtiff does on samples in the file's byte order."""
    dtype = np.uint8 if bits == 8 else np.dtype(endian + ("u2" if bits == 16 else "u4"))
    s = block.view(dtype).reshape(block.shape[0], -1, spp)
    return np.cumsum(s, 1, dtype=dtype).astype(dtype).view(np.uint8).reshape(block.shape)


def _undo_float_predictor(block: np.ndarray, spp: int, endian: str) -> np.ndarray:
    """libtiff's fpAcc (predictor 3) on (rows, rowbytes) uint8 rows of
    32-bit floats: a running byte sum along each row, one per sample of a
    pixel, then each row's four byte planes (most significant first) put
    back together; returned in the file's byte order."""
    rows, n = block.shape
    acc = np.cumsum(block.reshape(rows, -1, spp), 1, dtype=np.uint8).reshape(rows, 4, n // 4)
    out = acc.transpose(0, 2, 1)  # big-endian bytes of each sample
    return np.ascontiguousarray(out if endian == ">" else out[..., ::-1]).reshape(rows, n)


# ---------------------------------------------------------------------------

def decode_tiff(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a TIFF file's first page, as PIL's
    `convert("RGB")` of it."""
    data = bytes(data)
    head = data[:4]
    # PIL takes a file for BigTIFF by its third byte, so a big-endian
    # BigTIFF header (MM 0 43) is read as a classic one, as here
    big = head == b"II\x2b\x00"
    if head not in _TIFF_HEADS or len(data) < (16 if big else 8):
        raise DecodeError("not a TIFF file" + (" (a truncated BigTIFF header)" if big else ""))
    endian = "<" if head[:2] == b"II" else ">"
    first = struct.unpack_from(endian + ("Q" if big else "L"), data, 8 if big else 4)[0]
    tags = _ifd(data, first, endian, big)
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
    if how == "ycc" and comp != 1 and planar == 2:
        known = False  # libtiff's RGBA reading has no planar YCbCr of PIL's
    if known and planar == 2 and len(bits) > 1:
        # the planar files PIL reads as stored: uncompressed, R, G, B, A and
        # C, M, Y, K planes (8-bit unpackers, whatever the depth); compressed,
        # a plane a band of the mode, or unused planes too in tiles
        if comp == 1:
            known = mode in ("RGB", "RGBA", "CMYK") and how != "pre" and len(bits) == len(mode)
            how = "" if how == "ycc" else how  # the planes read as R, G and B
        else:
            # (PIL unpacks a palette plane beside an extra one two bytes a
            # pixel)
            known = mode not in ("P", "PA", "LAB") and (len(bits) == len(mode) or
                                                       _TILE_OFFSETS in tags)
            if mode == "RGBA" and extra == ():  # libtiff's: an associated alpha
                how = "pre"
    if not known:
        raise DecodeError(f"TIFF: {'planar ' if planar == 2 else ''}"
                          f"{_PHOTO_NAMES.get(photo, photo)} at {bits} bits (sample format "
                          f"{fmt}, extra samples {extra}, fill order {fill}, compression "
                          f"{_COMPRESSIONS[comp]}) is not supported")
    if comp in _CCITT and bits != (1,):
        raise DecodeError(f"TIFF: {_COMPRESSIONS[comp]} of {bits}-bit samples (libtiff reads "
                          "1 bit)")
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
    if comp == 1 and how == "ycc":  # PIL's raw mode RGBX: 4 bytes a pixel
        samples = _raw_samples(data, tags, width, height, (8,) * 4, photo, extra, planar,
                               endian, fill, line_bits=24)
    elif comp == 1:
        samples = _raw_samples(data, tags, width, height, bits, photo, extra, planar, endian,
                               fill)
        if planar == 2:
            bps = 8
    elif how == "ycc":
        samples = _ycbcr_rgba(data, tags, comp, width, height, endian, fill)
    elif comp == 7:
        samples = _jpeg_samples(data, tags, photo, width, height, bps, nbands, planar)
    elif comp == 6:
        samples = _ojpeg_samples(data, tags, width, height, nbands, endian)
    else:
        samples = _libtiff_samples(data, tags, comp, width, height, bps, nbands, planar,
                                   endian, fill)
        if how == "signed" and endian == ">" or mode == "F" and endian == ">":
            samples = samples.byteswap()  # PIL reads libtiff's native order as I;16BS, F;32BF
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
    if bps in (16, 32):
        k = bps // 8
        return rows[:, :k * width * nbands].copy().view(endian + f"u{k}").reshape(
            h, width, nbands)
    if bps == 8:
        return rows[:, :width * nbands].reshape(h, width, nbands)
    return unpack_bits(rows, bps, width * nbands).reshape(h, width, nbands)


def _raw_samples(data, tags, width, height, bits, photo, extra, planar, endian, fill,
                 line_bits=None):
    """PIL's own path for an uncompressed file: one raw tile a strip or
    tile at its offset, placed left to right and top to bottom (then the
    next band, planar: 8-bit samples, whatever the depth), the image's zeros
    where no tile reaches, the predictor not undone. `line_bits`: the
    pixel's bits PIL's stride of a tile past the right edge counts, where
    its raw mode reads other than the file's samples."""
    offsets, _, tw, th = _layout(tags, width, height)
    nbands = len(bits)
    bps, per = (8, 1) if planar == 2 else (bits[0], nbands)
    if tw == width and th == height and planar != 2:
        offsets = offsets[-1:]
    # a tile past the right edge: PIL's row stride, a plane's share of the
    # pixel's bits (counting the bands the photometric names, plus extras)
    bands = {2: 3, 5: 4}.get(photo, 1) + len(extra)
    partial = int(tw * (line_bits or sum(bits)) / 8 / (bands if planar == 2 else 1))
    out = np.zeros((height, width, nbands), _DTYPES[bps])
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
    # libtiff's LZW, Deflate and LZMA codecs undo a predictor; the others
    # leave it
    predictor = _get(tags, _PREDICTOR, 1) if comp in (5, 8, 32946, 34925, 50000) else 1
    floats = _get(tags, _SAMPLE_FORMAT, (1,))[0] == 3
    if predictor not in (1, 2, 3) or predictor == 2 and bps not in (8, 16, 32) or (
            predictor == 3 and not (floats and bps == 32)):
        raise DecodeError(f"TIFF: predictor {predictor} at {bps} bits is not supported")
    tiled = _TILE_OFFSETS in tags and _STRIP_OFFSETS not in tags
    per = 1 if planar == 2 else nbands
    planes = nbands if planar == 2 else 1
    across, down = -(-width // tw), -(-height // th)
    if len(offsets) < across * down * planes:
        raise DecodeError("TIFF: fewer strips or tiles than the image needs")
    row_bytes = (tw * bps * per + 7) // 8
    out = np.zeros((height, width, nbands), _DTYPES[bps])
    if comp in _CCITT:
        options = _get(tags, _T4_OPTIONS, (0,))[0] if comp == 3 else 0

        def codec(src, size):
            bitrows = decode_ccitt(src, comp, tw, size // row_bytes, options)
            return np.packbits(bitrows, 1).tobytes()
    elif comp == 5 and _old_lzw(data[offsets[0]:offsets[0] + counts[0]]):
        codec = _lzw_compat  # libtiff keeps the first strip's kind of LZW for all
    else:
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
                elif predictor == 3:
                    block = _undo_float_predictor(block, per, endian)
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


_SUBSAMPLINGS = {(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)}


def _ycbcr_rgba(data, tags, comp, width, height, endian, fill):
    """libtiff's TIFFRGBAImage on a YCbCr file under a compression other
    than JPEG, as PIL reads one (chunky): each strip or tile decoded to
    its rows of sampling blocks (YCbCrSubsampling, 2x2 by default: the
    block's luma in raster order, then its Cb and Cr), every pixel of a
    block given the block's chroma, then libtiff's YCbCr to RGB."""
    for tag, default in _YCBCR_DEFAULTS.items():
        raw = tags.get(tag)
        if raw is not None:
            v = np.frombuffer(raw, endian + "u4").reshape(-1, 2)
            if not np.allclose(v[:, 0] / np.maximum(v[:, 1], 1), default[:len(v)]):
                raise DecodeError(f"TIFF: YCbCr with tag {tag} other than the default "
                                  f"{default} is not supported")
    hs, vs = (tuple(_get(tags, _YCBCR_SUBSAMPLING, (2, 2))) + (2, 2))[:2]
    if (hs, vs) not in _SUBSAMPLINGS:
        raise DecodeError(f"TIFF: YCbCr subsampling {hs}x{vs} (libtiff cannot handle it)")
    if _get(tags, _PREDICTOR, 1) != 1:
        raise DecodeError("TIFF: a predictor on subsampled YCbCr is not supported")
    offsets, counts, tw, th = _layout(tags, width, height)
    if counts is None or len(counts) < len(offsets):
        raise DecodeError("TIFF: missing strip or tile byte counts")
    tiled = _TILE_OFFSETS in tags and _STRIP_OFFSETS not in tags
    across, down = -(-width // tw), -(-height // th)
    if len(offsets) < across * down:
        raise DecodeError("TIFF: fewer strips or tiles than the image needs")
    block = hs * vs + 2
    wide = -(-tw // hs)
    if (hs, vs) == (4, 4) and (width % tw if tiled else wide % 2):
        # libtiff reads a strip short of its last block's chroma, or skips
        # 10 bytes a block past a tile's right edge (its 4x4 reader's count)
        raise DecodeError("TIFF: YCbCr 4x4 subsampling of an odd count of blocks a row, or "
                          "tiles past the right edge, is not supported (libtiff misreads it)")
    out = np.zeros((height, width, 3), np.uint8)
    for k in range(across * down):
        ty, tx = divmod(k, across)
        rows = th if tiled else min(th, height - ty * th)
        tall = -(-rows // vs)
        src = data[offsets[k]:offsets[k] + counts[k]]
        if fill == 2:
            src = _reverse_bits(np.frombuffer(src, np.uint8)).tobytes()
        b = np.frombuffer(_CODECS[comp](src, tall * wide * block), np.uint8)
        b = b.reshape(tall, wide, block)
        y = b[..., :hs * vs].reshape(tall, wide, vs, hs).transpose(0, 2, 1, 3).reshape(
            tall * vs, wide * hs)
        cb, cr = (np.repeat(np.repeat(b[..., i], vs, 0), hs, 1) for i in (-2, -1))
        x0, y0 = tx * tw, ty * th
        x1, y1 = min(x0 + tw, width), min(y0 + rows, height)
        out[y0:y1, x0:x1] = _ycbcr_to_rgb(y, cb, cr)[:y1 - y0, :x1 - x0]
    return out


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
    if mode == "F":
        return to_rgb("F", s[..., 0].view(np.float32))
    if mode == "LAB":
        return to_rgb("LAB", s)
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
