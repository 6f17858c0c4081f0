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
               compressions RLE (2), RLEW (32771), Group 3 (3, 1D and 2D by
               T4Options) and Group 4 (4), as libtiff's fax decoders read
               them (utils/ccitt_decode); ThunderScan (32809: 4-bit samples
               in strips, tif_thunder.c's codes); JPEG (7: each strip's or tile's stream
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

Anything else (SGILog, WebP, YCbCr planar under a compression, 4x4 YCbCr
where libtiff's reader misreads its own layout, a planar palette beside
an extra plane, an old-style JPEG interchange format in several strips or
with other YCbCr coefficients or reference values than the defaults)
raises DecodeError naming it, as does data on which PIL fails; so does a
Group 4 first strip that ends before its rows, where libtiff leaves the
rest of PIL's strip buffer unwritten and PIL shows that memory (in a
later strip those rows are the strip before's, as PIL shows them).
Damaged data is read as PIL and libtiff 4.7.1 read it: libtiff's own
reading of the directory beside PIL's (its checks that fail a file PIL
takes, a palette image's ColorMap, the strips, byte counts and fill order
where PIL's reading stops early or libtiff ignores a tag of another
count, its estimate of missing byte counts, its read errors past the
file's end; PIL's first value of a one-value tag that holds several); the
YCbCr route (TIFFRGBAImage, which PIL runs without stopping on errors)
taking what a failing Deflate, LZW or LZMA strip wrote over its buffer
(zeros, or the row's tile before); what liblzma writes before its error
(the chunk written up to its uncompressed size before its own checks
fail); the CCITT decoders' state carried from strip to strip
(utils/ccitt_decode); libzstd's fast Huffman loop (utils/zstd_decode);
the JPEG codecs as utils/image_decode reads libtiff's streams.
"""

from __future__ import annotations

import lzma
import struct
import zlib

import numpy as np

from .ccitt_decode import CcittState, decode_ccitt
from .image import _segment
from .image_decode import (MAX_PIXELS, DecodeError, Tables, _check_size, decode_jpeg_planes,
                           decode_jpeg_samples, read_frame, read_tables)
from .pil_modes import cmyk_to_rgb, palette256, scale_bits, to_rgb, unpack_bits
from . import zstd_decode

# TiffImagePlugin.COMPRESSION_INFO: the ones decoded here, and the others' names
_COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 5: "LZW",
                 6: "old-style JPEG", 7: "JPEG", 8: "Deflate", 32946: "Deflate",
                 32771: "CCITT RLEW", 32773: "PackBits", 32809: "ThunderScan", 34925: "LZMA",
                 50000: "ZSTD"}
_OTHER_COMPRESSIONS = {34676: "SGILog", 34677: "SGILog24", 50001: "WebP"}
_CCITT = (2, 3, 4, 32771)
_THUNDERSCAN = 32809
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
    if tag in _SCALARS:  # PIL keeps the first of several values (with a warning)
        if isinstance(v, bytes):
            raise DecodeError(f"TIFF: tag {tag} holds bytes where a number is expected")
        return v[0]
    if isinstance(v, bytes):
        raise DecodeError(f"TIFF: tag {tag} is not integers")
    return v


# libtiff's directory reading (tif_dirread.c TIFFReadDirectory): the tags
# whose damage fails the directory (their reading is not recovered from),
# and the field types its integer readers take
_FATAL_SHORT = {277, 259, 284}  # SamplesPerPixel, Compression, PlanarConfiguration
_FATAL_LONG = {_WIDTH, _LENGTH, _ROWS_PER_STRIP, _TILE_WIDTH, _TILE_LENGTH, 32997, 32998}
_INTEGER_TYPES = {1, 3, 4, 6, 8, 9, 16, 17}
_SIGNED_TYPES = {6, 8, 9, 17}
_LIBTIFF_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("L", 4), 5: ("Q", 8), 6: ("b", 1),
                  7: ("B", 1), 8: ("h", 2), 9: ("l", 4), 10: ("q", 8), 11: ("L", 4),
                  12: ("Q", 8), 13: ("L", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}


def _libtiff_directory(data: bytes, pos: int, endian: str, big: bool) -> dict:
    """The checks with which libtiff's TIFFReadDirectory fails a directory
    that PIL's own reading takes (PIL then fails in libtiff's decoder): a
    count past 4096 or entries past the file's end (TIFFFetchDirectory);
    SamplesPerPixel, Compression, the image's and tiles' sizes,
    PlanarConfiguration, RowsPerStrip and ExtraSamples each of a type
    other than an integer's, of another count than one, out of range or of
    a bad value. Returns {tag: (type, count, offset of the values)} of the
    entries, first of each tag."""
    count_fmt, entry_fmt, inline = ("Q", "HHQ", 8) if big else ("H", "HHL", 4)
    head = struct.calcsize("<" + count_fmt)
    size = 20 if big else 12
    if pos + head > len(data):
        raise DecodeError("TIFF: libtiff cannot read the directory's count")
    (n,) = struct.unpack_from(endian + count_fmt, data, pos)
    if n > 4096:
        raise DecodeError(f"TIFF: {n} directory entries (libtiff's sanity check: 4096)")
    if pos + head + n * size > len(data):
        raise DecodeError("TIFF: libtiff cannot read the directory: it runs past the file")
    entries = {}
    for k in range(n):
        at = pos + head + k * size
        tag, kind, count = struct.unpack_from(endian + entry_fmt, data, at)
        entries.setdefault(tag, (kind, count, at + struct.calcsize("<" + entry_fmt)))

    def values(tag):
        kind, count, at = entries[tag]
        code, width = _LIBTIFF_TYPES[kind]
        if count * width > inline:
            (at,) = struct.unpack_from(endian + ("Q" if big else "L"), data, at)
            if at + count * width > len(data):
                raise DecodeError(f"TIFF: tag {tag}'s values lie past the file's end (libtiff)")
        return struct.unpack_from(endian + code * count, data, at)

    def one(tag, top):
        kind, count, _ = entries[tag]
        if kind not in _INTEGER_TYPES:
            raise DecodeError(f"TIFF: incompatible type {kind} for tag {tag} (libtiff)")
        if count != 1:
            raise DecodeError(f"TIFF: incorrect count {count} for tag {tag} (libtiff)")
        (v,) = values(tag)
        if v < 0 or v > top:
            raise DecodeError(f"TIFF: tag {tag}'s value {v} is out of range (libtiff)")
        return v

    spp = one(277, 0xFFFF) if 277 in entries else 1
    if spp == 0:
        raise DecodeError("TIFF: SamplesPerPixel 0 (libtiff)")
    for tag in _FATAL_SHORT & entries.keys() - {277}:
        kind, count, _ = entries[tag]
        if tag == 259 and count != 1 and kind in _INTEGER_TYPES and count >= spp:
            got = values(tag)  # one value a sample, all the same (PersampleShort)
            if len(set(got)) != 1 or min(got) < 0 or max(got) > 0xFFFF:
                raise DecodeError("TIFF: a Compression value a sample, not all the same "
                                  "(libtiff)")
            continue
        v = one(tag, 0xFFFF)
        if tag == 284 and v not in (1, 2):
            raise DecodeError(f"TIFF: PlanarConfiguration {v} (libtiff)")
    for tag in _FATAL_LONG & entries.keys():
        v = one(tag, 0xFFFFFFFF)
        if tag == _ROWS_PER_STRIP and v == 0:
            raise DecodeError("TIFF: RowsPerStrip 0 (libtiff)")
    if _EXTRA in entries:
        kind, count, _ = entries[_EXTRA]
        if kind not in _INTEGER_TYPES:
            raise DecodeError(f"TIFF: incompatible type {kind} for ExtraSamples (libtiff)")
        got = values(_EXTRA)
        if count > spp or any(v < 0 or v > 2 and not (v == 999 and i == count - 1)
                              for i, v in enumerate(got)):
            raise DecodeError("TIFF: bad ExtraSamples (libtiff)")
    if _WIDTH not in entries and _LENGTH not in entries:
        raise DecodeError("TIFF: missing ImageLength (libtiff)")
    if _PHOTOMETRIC in entries and _BITS in entries:
        # a palette image's ColorMap: 3 << bits integers fitting 16 bits, or
        # (below 8 bits) the directory fails as missing it
        try:
            photo, bits = one(_PHOTOMETRIC, 0xFFFF), values(_BITS)[0]
        except DecodeError:
            photo, bits = None, 8
        if photo == 3 and bits < 8:
            kind, count, _ = entries.get(_COLORMAP, (0, 0, 0))
            if (kind not in _INTEGER_TYPES or count != 3 << bits
                    or not all(0 <= v <= 0xFFFF for v in values(_COLORMAP))):
                raise DecodeError("TIFF: a palette image without a ColorMap libtiff reads "
                                  "(3 << bits 16-bit values)")
    return entries


# the tags libtiff alone reads (the strips' and tiles' layout, the codecs'
# settings): where PIL's reading of the directory stops before them, libtiff
# still decodes with them
_LIBTIFF_SIDE = {_STRIP_OFFSETS, _STRIP_COUNTS, _ROWS_PER_STRIP, _TILE_WIDTH, _TILE_LENGTH,
                 _TILE_OFFSETS, _TILE_COUNTS, _PREDICTOR, _T4_OPTIONS, _JPEG_TABLES}


def _row_bytes(data: bytes, entries: dict, endian: str, big: bool, width: int) -> int:
    """TIFFScanlineSize of a chunky image by libtiff's reading of the
    directory: the samples and the first sample's bits."""
    got = []
    for tag in (_SAMPLES, _BITS):
        try:
            got.append(_libtiff_values(data, entries[tag], endian, big, 1)[0])
        except (KeyError, DecodeError):
            got.append(1)
    return (width * got[0] * got[1] + 7) // 8


def _libtiff_bytes(data: bytes, entry, endian: str, big: bool) -> bytes:
    """A directory entry's bytes (an UNDEFINED field's), past the file's
    end failing."""
    kind, count, at = entry
    width = _LIBTIFF_TYPES.get(kind, (None, 1))[1]
    if count * width > (8 if big else 4):
        (at,) = struct.unpack_from(endian + ("Q" if big else "L"), data, at)
    if at + count * width > len(data):
        raise DecodeError("TIFF: a field's bytes lie past the file's end")
    return data[at:at + count * width]


def _libtiff_values(data: bytes, entry, endian: str, big: bool, n: int) -> tuple:
    """The first n values of a directory entry of an unsigned integer type
    as libtiff reads them (the strip arrays: TIFFFetchStripThing); values
    past the file's end fail."""
    kind, count, at = entry
    if kind not in (3, 4, 16):
        raise DecodeError(f"TIFF: a field of type {kind} where libtiff reads integers")
    code, width = _LIBTIFF_TYPES[kind]
    if count * width > (8 if big else 4):
        (at,) = struct.unpack_from(endian + ("Q" if big else "L"), data, at)
    if count < n or at + n * width > len(data):
        raise DecodeError("TIFF: libtiff cannot read the strip byte counts")
    return struct.unpack_from(endian + code * n, data, at)


def _estimated_counts(data: bytes, entries: dict, offsets, planes: int, big: bool):
    """libtiff's EstimateStripByteCounts for a compressed file without
    StripByteCounts: the file past the header, the directory and its
    values, shared by every strip (a plane's share, planar), the last
    strip cut at the file's end."""
    space = (16 + 8 + len(entries) * 20 + 8) if big else (8 + 2 + len(entries) * 12 + 4)
    for kind, count, _ in entries.values():
        width = _LIBTIFF_TYPES.get(kind, (None, 0))[1]
        if width == 0:
            raise DecodeError(f"TIFF: cannot size unknown tag type {kind} (libtiff)")
        if width * count > (8 if big else 4):
            space += width * count
    space = len(data) if len(data) < space else len(data) - space
    counts = [space // planes] * len(offsets)
    last = offsets[-1]
    if last + counts[-1] > len(data):
        counts[-1] = 0 if last >= len(data) else len(data) - last
    return tuple(counts)


_DTYPES = {1: np.uint8, 2: np.uint8, 4: np.uint8, 8: np.uint8, 16: np.uint16, 32: np.uint32}
_BIT_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _reverse_bits(buf: np.ndarray) -> np.ndarray:
    """Each byte with its bits in the other order (fill order 2)."""
    return _BIT_REVERSED[buf]


# ---------------------------------------------------------------------------
# the codecs: each turns one strip's or tile's bytes into `size` bytes


class _Partial(DecodeError):
    """A codec's error, with the bytes libtiff's codec wrote before it
    (`out`): libtiff's RGBA reader, which PIL's YCbCr route uses without
    stopping on errors, reads on with them."""

    def __init__(self, message: str, out: bytes):
        super().__init__(message)
        self.out = out


def _chunk(data: bytes, offsets, counts, k: int, size: int) -> bytes:
    """Strip or tile k's bytes as libtiff's TIFFFillStrip and TIFFFillTile
    read them: a count past 1 MiB is first limited to ten times the decoded
    size and 4096; a count of 0, or bytes past the file's end, fail."""
    off, n = offsets[k], counts[k]
    if n > 1 << 20 and (n - 4096) // 10 > size:
        n = size * 10 + 4096
    if n == 0 or off + n > len(data):
        raise DecodeError(f"TIFF: read error on strip or tile {k}: {n} bytes at {off} in a file "
                          f"of {len(data)}")
    return data[off:off + n]


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
                raise _Partial(f"TIFF: corrupt LZW data (code {code} after a clear)",
                               bytes(out[:size]))
            entry = table[code]
        elif code < len(table):
            entry = table[code]
        elif code == len(table):
            entry = prev + prev[:1]
        else:
            raise _Partial(f"TIFF: corrupt LZW data (code {code})", bytes(out[:size]))
        out += entry
        if prev is not None and len(table) < 4096:
            table.append(prev + entry[:1])
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
        prev = entry
    if len(out) < size:
        raise _Partial("TIFF: not enough LZW data for a strip", bytes(out))
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
    """libtiff's LZMA codec: an xz stream, `size` bytes of it, in one call
    of lzma_code, which writes what it decodes before an error. As
    LZMADecode, an error after the `size` bytes are out (a bad check, a
    damaged index) is no failure."""
    try:
        out = lzma.LZMADecompressor(format=lzma.FORMAT_XZ).decompress(src, size)
    except lzma.LZMAError as e:
        out = _lzma_before_error(src, size)
        if len(out) < size:
            raise _Partial(f"TIFF: corrupt LZMA data: {e}", out) from e
    if len(out) < size:
        raise _Partial("TIFF: not enough LZMA data for a strip", out)
    return out


def _lzma_before_error(src: bytes, size: int) -> bytes:
    """The bytes liblzma writes before its error, for an xz stream as
    libtiff writes it: one block of LZMA2 whose first chunk resets the
    dictionary and sets the properties. A header whose CRC fails gives
    nothing. In one call liblzma's LZMA decoder reads on past the chunk's
    compressed size and writes every byte up to the chunk's uncompressed
    size before the chunk's own checks fail (the compressed size, the
    range coder's end), so the chunk's data go through a raw LZMA1
    decoder of the same properties, which makes no such checks; its
    output is pulled 4096 bytes a call, then a byte a call from the last
    clean call, Python dropping the output of a call that fails. Other
    streams: the output of the input a byte a call."""
    if len(src) < 12 or src[:6] != b"\xfd7zXZ\x00" or zlib.crc32(src[6:8]) != int.from_bytes(
            src[8:12], "little"):
        return b""
    head = 12
    block = (src[head] + 1) * 4 if head < len(src) and src[head] else 0
    if not block or head + block > len(src) or zlib.crc32(
            src[head:head + block - 4]) != int.from_bytes(src[head + block - 4:head + block],
                                                          "little"):
        return b""
    flags, at = src[head + 1], head + 2
    for bit in (0x40, 0x80):  # compressed and uncompressed sizes (VLIs), skipped
        if flags & bit:
            while at < head + block and src[at] & 0x80:
                at += 1
            at += 1
    filters = []  # libtiff's chain: a delta filter, then LZMA2
    for _ in range((flags & 3) + 1):
        if src[at:at + 2] == b"\x03\x01" and not filters:
            filters.append({"id": lzma.FILTER_DELTA, "dist": src[at + 2] + 1})
        elif src[at:at + 2] == b"\x21\x01" and src[at + 2] <= 40:
            dict_byte = src[at + 2]
        else:
            return _lzma_fed(src, size)
        at += 3
    chunk = head + block
    if (src[at - 3] != 0x21 or chunk + 6 > len(src) or src[chunk] < 0xE0
            or src[chunk + 5] >= 225):
        return _lzma_fed(src, size)
    usize = ((src[chunk] & 0x1F) << 16 | src[chunk + 1] << 8 | src[chunk + 2]) + 1
    props = src[chunk + 5]
    lc, lp, pb = props % 9, props // 9 % 5, props // 45
    dict_size = (2 | dict_byte & 1) << (dict_byte // 2 + 11) if dict_byte < 40 else 0xFFFFFFFF
    if lc + lp > 4:
        return b""
    filters.append({"id": lzma.FILTER_LZMA1, "lc": lc, "lp": lp, "pb": pb,
                    "dict_size": max(dict_size, 4096)})
    out = _fed(lambda: lzma.LZMADecompressor(format=lzma.FORMAT_RAW, filters=filters),
               src[chunk + 6:], min(size, usize))
    if len(out) == usize < size:  # a second chunk: liblzma's own stream
        return max(out, _lzma_fed(src, size), key=len)
    return out


def _lzma_fed(src: bytes, size: int) -> bytes:
    """What liblzma writes of an xz stream before its error."""
    return _fed(lambda: lzma.LZMADecompressor(format=lzma.FORMAT_XZ), src, size)


def _fed(new, src: bytes, size: int) -> bytes:
    """Up to `size` bytes a liblzma decoder (`new()`) writes of `src`
    before its error. Python drops the output of a call that fails, and
    the decoder reads the next symbol after the bytes asked for, so the
    input goes in a byte a call; then again the input before the failing
    byte at once, and that byte's output a byte a call."""
    d, out, bad = new(), b"", len(src)
    for i in range(len(src)):
        try:
            out += d.decompress(src[i:i + 1])
        except lzma.LZMAError:
            bad = i
            break
        if len(out) >= size or d.eof:
            return out[:size]
    d = new()
    more, data = d.decompress(src[:bad]), src[bad:bad + 1]
    try:
        while len(more) < size:
            got = d.decompress(data, 1)
            data = b""
            if not got:
                break
            more += got
    except lzma.LZMAError:
        pass
    return max(out, more, key=len)[:size]


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
    """libtiff's ZIPDecode: a zlib stream, `size` bytes of it; on an error
    the bytes inflate wrote before it (inflate_prefix)."""
    try:
        out = zlib.decompressobj().decompress(src, size)
    except zlib.error as e:
        raise _Partial(f"TIFF: corrupt Deflate data: {e}", inflate_prefix(src, size)) from e
    if len(out) < size:
        raise _Partial("TIFF: not enough Deflate data for a strip", out)
    return out


# zlib's inflate as far as it writes before an error (RFC 1950/1951): the
# lengths' and distances' bases and extra bits
_LEN_BASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59, 67, 83, 99,
             115, 131, 163, 195, 227, 258)
_LEN_EXTRA = (0,) * 8 + tuple(n for n in range(1, 6) for _ in range(4)) + (0,)
_DIST_BASE = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513, 769,
              1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577)
_DIST_EXTRA = (0, 0) + tuple(n for n in range(14) for _ in range(2))
_CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)


class _Stop(Exception):
    """The stream ends, or zlib finds an error: inflate writes no more."""


def _huffman(lengths, kind: str) -> dict:
    """{(length, code): symbol} of canonical code lengths, with zlib's
    inflate_table checks: an over-subscribed set is an error, and so is
    an incomplete one, except one code of one bit (lengths and distances)
    or no code at all (distances)."""
    left, counts = 1, [0] * 16
    for n in lengths:
        counts[n] += 1
    top = max(lengths, default=0)
    if top == 0:
        if kind == "codes":
            raise _Stop
        return {}
    for n in range(1, 16):
        left = (left << 1) - counts[n]
        if left < 0:
            raise _Stop
    if left > 0 and (kind == "codes" or top != 1):
        raise _Stop
    code, start, table = 0, {}, {}
    for n in range(1, 16):
        code = (code + counts[n - 1]) << 1 if n > 1 else 0
        start[n] = code
    for sym, n in enumerate(lengths):
        if n:
            table[(n, start[n])] = sym
            start[n] += 1
    return table


def inflate_prefix(src: bytes, size: int) -> bytes:
    """The bytes zlib's inflate writes of a zlib stream, at most `size`,
    before the stream's end, the data's end or an error stops it (what
    libtiff's ZIPDecode leaves in its buffer when it fails)."""
    bits, nbits = int.from_bytes(src, "little"), 8 * len(src)
    out, pos = bytearray(), 0

    def get(n: int) -> int:
        nonlocal pos
        if pos + n > nbits:
            raise _Stop
        pos += n
        return (bits >> (pos - n)) & ((1 << n) - 1)

    def decode(table: dict) -> int:
        code = n = 0
        while n < 15:
            code = code << 1 | get(1)
            n += 1
            if (n, code) in table:
                return table[(n, code)]
        raise _Stop

    try:
        if len(src) < 2 or (src[0] << 8 | src[1]) % 31 or src[0] & 15 != 8 or src[0] >> 4 > 7 or (
                src[1] & 0x20):
            raise _Stop
        pos = 16
        final = False
        while not final and len(out) < size:
            final, kind = get(1), get(2)
            if kind == 0:
                pos = -(-pos // 8) * 8
                n, inv = get(16), get(16)
                if n != inv ^ 0xFFFF:
                    raise _Stop
                take = min(n, (nbits - pos) // 8)
                out += src[pos // 8:pos // 8 + take]
                pos += 8 * take
                if take < n:
                    raise _Stop
                continue
            if kind == 1:
                lit = _huffman([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8, "lens")
                dist = _huffman([5] * 32, "dists")
            elif kind == 2:
                nlen, ndist, ncode = get(5) + 257, get(5) + 1, get(4) + 4
                if nlen > 286 or ndist > 30:
                    raise _Stop
                cl = [0] * 19
                for i in range(ncode):
                    cl[_CL_ORDER[i]] = get(3)
                codes = _huffman(cl, "codes")
                lens = []
                while len(lens) < nlen + ndist:
                    sym = decode(codes)
                    if sym < 16:
                        lens.append(sym)
                        continue
                    if sym == 16:
                        if not lens:
                            raise _Stop
                        rep, value = 3 + get(2), lens[-1]
                    else:
                        rep, value = (3 + get(3), 0) if sym == 17 else (11 + get(7), 0)
                    if len(lens) + rep > nlen + ndist:
                        raise _Stop
                    lens += [value] * rep
                if lens[256] == 0:
                    raise _Stop
                lit = _huffman(lens[:nlen], "lens")
                dist = _huffman(lens[nlen:], "dists")
            else:
                raise _Stop
            while len(out) < size:
                sym = decode(lit)
                if sym < 256:
                    out.append(sym)
                    continue
                if sym == 256:
                    break
                if sym > 285:
                    raise _Stop
                length = _LEN_BASE[sym - 257] + get(_LEN_EXTRA[sym - 257])
                d = decode(dist)
                if d > 29:
                    raise _Stop
                d = _DIST_BASE[d] + get(_DIST_EXTRA[d])
                if d > len(out):
                    raise _Stop
                for _ in range(min(length, size - len(out))):
                    out.append(out[-d])
    except _Stop:
        pass
    return bytes(out[:size])



_TWO_BIT_DELTAS = (0, 1, None, -1)  # 2: skip
_THREE_BIT_DELTAS = (0, 1, 2, 3, None, -3, -2, -1)  # 4: skip


def _thunderscan(src: bytes, width: int, rows: int, row_bytes: int) -> bytes:
    """libtiff's ThunderDecodeRow (tif_thunder.c): 4-bit samples, each row
    from the next byte, a byte a code in its top two bits and six bits of
    data: a run of the last pixel (0), three 2-bit deltas (1), two 3-bit
    deltas (2), a raw pixel (3: the data's low four bits). The last pixel
    starts each row at 0; deltas wrap modulo 16; a pixel past the row is
    dropped, and a run past it writes nothing. A row of fewer pixels
    (the data ran out) or a run past its end fails the strip."""
    buf = bytearray(rows * row_bytes)
    pos, end = 0, len(src)
    for y in range(rows):
        op = y * row_bytes
        last = npix = 0
        while pos < end and npix < width:
            n = src[pos]
            pos += 1
            code = n >> 6
            if code == 0:  # as libtiff writes the run, a byte at a time
                if npix & 1:
                    buf[op] |= last
                    last = buf[op]
                    op += 1
                    npix += 1
                    n -= 1
                else:
                    last |= last << 4
                npix += n
                if npix <= width:
                    while n > 0:
                        buf[op] = last
                        op += 1
                        n -= 2
                if n == -1:
                    op -= 1
                    buf[op] &= 0xF0
                last &= 0xF
                continue
            if code == 3:
                values = [n & 0xF]
            else:
                deltas = ([_TWO_BIT_DELTAS[n >> s & 3] for s in (4, 2, 0)] if code == 1 else
                          [_THREE_BIT_DELTAS[n >> s & 7] for s in (3, 0)])
                values = []
                for d in deltas:
                    if d is not None:
                        last = (last + d) & 0xF
                        values.append(last)
            for v in values:
                last = v
                if npix < width:
                    if npix & 1:
                        buf[op] |= v
                        op += 1
                    else:
                        buf[op] = v << 4
                    npix += 1
        if npix != width:
            raise DecodeError(f"TIFF: {'not enough' if npix < width else 'too much'} "
                              f"ThunderScan data in row {y} of a strip ({npix} pixels of "
                              f"{width})")
    return bytes(buf)


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

def tiff_grey_mode(data: bytes, modes: tuple = ("1", "L")) -> str:
    """The PIL mode of a one-band TIFF by OPEN_INFO where it is one of
    `modes` (a big-endian I;16 as I;16B), "other" for any other file."""
    try:
        endian = "<" if data[:2] == b"II" else ">"
        tags = _ifd(data, struct.unpack_from(endian + "L", data, 4)[0], endian)
        key = (_get(tags, _PHOTOMETRIC, 0), _get(tags, _SAMPLE_FORMAT, (1,)),
               _get(tags, _BITS, (1,)), _get(tags, _EXTRA, ()))
    except (DecodeError, struct.error):
        return "other"
    mode = _MODES.get(key, ("other",))[0]
    if mode == "I;16" and endian == ">":
        mode = "I;16B"
    return mode if mode in modes and _get(tags, _SAMPLES, 1) == 1 else "other"


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
    entries = {}
    if comp != 1:  # libtiff opens the file too, and reads its directory its own way
        entries = _libtiff_directory(data, first, endian, big)
        for tag in _LIBTIFF_SIDE & entries.keys() - tags.keys():  # where PIL's reading stopped
            try:
                kind, count, _ = entries[tag]
                tags[tag] = (_libtiff_values(data, entries[tag], endian, big, count)
                             if tag != _JPEG_TABLES else _libtiff_bytes(data, entries[tag],
                                                                        endian, big))
            except DecodeError:
                pass
        if _STRIP_COUNTS not in tags and _STRIP_OFFSETS in tags and _TILE_OFFSETS not in tags:
            offsets = _get(tags, _STRIP_OFFSETS)
            if _STRIP_COUNTS in entries:  # PIL skipped it; libtiff reads it as it can
                tags[_STRIP_COUNTS] = _libtiff_values(data, entries[_STRIP_COUNTS], endian, big,
                                                      len(offsets))
            else:
                tags[_STRIP_COUNTS] = _estimated_counts(
                    data, entries, offsets,
                    _get(tags, _SAMPLES, 1) if _get(tags, _PLANAR, 1) == 2 else 1, big)
    planar = _get(tags, _PLANAR, 1)
    # PIL reads an old-style JPEG file as YCbCr, whatever its photometric tag
    photo = 6 if comp == 6 else _get(tags, _PHOTOMETRIC, 0)
    fill = lt_fill = _get(tags, _FILL_ORDER, 1)
    if comp != 1:  # libtiff undoes the fill order as it reads the tag: one value, 1 or 2
        lt_fill = 1
        if entries.get(_FILL_ORDER, (0, 0))[1] == 1:
            try:
                got = _libtiff_values(data, entries[_FILL_ORDER], endian, big, 1)[0]
                lt_fill = got if got in (1, 2) else 1
            except DecodeError:
                pass
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
        samples = _ycbcr_rgba(data, tags, comp, width, height, endian, lt_fill)
    elif {_SAMPLES, _BITS} & entries.keys() - tags.keys() and (
            _row_bytes(data, entries, endian, big, width) != (width * sum(bits) + 7) // 8):
        # PIL's reading stopped before them: libtiff's rows are not PIL's
        raise DecodeError("TIFF: libtiff's scanline size differs from PIL's row size")
    elif comp == 7:
        samples = _jpeg_samples(data, tags, photo, width, height, bps, nbands, planar)
    elif comp == 6:
        samples = _ojpeg_samples(data, tags, width, height, nbands, endian)
    else:
        samples = _libtiff_samples(data, tags, comp, width, height, bps, nbands, planar,
                                   endian, lt_fill)
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
    if not tiled and _get(tags, _ROWS_PER_STRIP, 0xFFFFFFFF) != 0xFFFFFFFF and (
            th * row_bytes > 0x7FFFFFFF):
        raise DecodeError(f"TIFF: {th} rows a strip overflow PIL's strip buffer")
    out = np.zeros((height, width, nbands), _DTYPES[bps])
    if comp in _CCITT:
        options = _get(tags, _T4_OPTIONS, (0,))[0] if comp == 3 else 0
        state = CcittState()
        held = np.zeros((th, tw), np.uint8)  # PIL's strip or tile buffer
        known = 0  # its rows a chunk wrote

        def codec(src, size):
            nonlocal known
            rows = size // row_bytes
            # RLEW's word alignment reads the address of the strip in the
            # mapped file: its offset's parity
            bits, written = decode_ccitt(src, comp, tw, rows, options, state,
                                         bool(offsets[k - 1] & 1))
            if written < rows:  # Group 4 ending early: the rows as the buffer held them
                if known < rows:
                    raise DecodeError(f"CCITT: Group 4 data ends in row {written - 1} of "
                                      "the first chunk to reach it, where PIL shows its "
                                      "strip buffer's unwritten memory")
                bits[written:] = held[written:rows]
            held[:written] = bits[:written]
            known = max(known, written)
            return np.packbits(bits, 1).tobytes()
    elif comp == _THUNDERSCAN:
        if bps != 4 or nbands != 1 or tiled:
            raise DecodeError("TIFF: ThunderScan of other than 4-bit single-sample strips "
                              "(libtiff decodes no other)")

        def codec(src, size):
            return _thunderscan(src, tw, size // row_bytes, row_bytes)
    elif comp == 5 and _old_lzw(data[offsets[0]:offsets[0] + counts[0]]):
        codec = _lzw_compat  # libtiff keeps the first strip's kind of LZW for all
    else:
        codec = _CODECS[comp]
    k = 0
    for plane in range(planes):
        for ty in range(down):
            for tx in range(across):
                rows = th if tiled else min(th, height - ty * th)
                src = _chunk(data, offsets, counts, k, th * row_bytes)
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
    streams = [_chunk(data, offsets, counts, k, th * tw * nbands // planes)
               for k in range(across * down * planes)]
    sampling = (1, 1)
    if photo == 6:
        sampling = tuple(_get(tags, _YCBCR_SUBSAMPLING, ()))[:2]
        if not sampling:  # JPEGFixupTagsSubsampling: the first stream's, else the default
            first = read_frame(streams[0], tiff=True)
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
    frame = read_frame(src, tiff=True)
    if len(frame.ids) != nbands:
        raise DecodeError(f"improper JPEG component count {len(frame.ids)} (expected {nbands})")
    factors = list(zip(frame.h, frame.v))
    if factors[0] != sampling or any(f != (1, 1) for f in factors[1:]):
        raise DecodeError(f"improper JPEG sampling factors {factors} (expected {sampling} "
                          "then 1x1)")
    cut = not tiled and frame.width == seg_w and frame.height > seg_h and y0 + seg_h == height
    if (frame.width, frame.height) != (seg_w, seg_h) and not cut:
        raise DecodeError(f"{frame.width}x{frame.height} where {seg_w}x{seg_h} is expected")
    s, _ = decode_jpeg_samples(src, tables, "ycc" if photo == 6 else "raw", tiff=True)
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
    buf = None
    for k in range(across * down):
        ty, tx = divmod(k, across)
        rows = th if tiled else min(th, height - ty * th)
        tall = -(-rows // vs)
        size = tall * wide * block
        if not tiled or tx == 0:  # PIL's TIFFRGBAImageGet: a new buffer a strip or row of tiles
            buf = None
        try:
            src = _chunk(data, offsets, counts, k, size)
        except DecodeError:
            if buf is None:
                raise
        else:  # (a tile that cannot be read shows the buffer as the last one left it)
            if fill == 2:
                src = _reverse_bits(np.frombuffer(src, np.uint8)).tobytes()
            if buf is None:
                buf = bytearray(size)
            try:
                got = _CODECS[comp](src, size)
            except _Partial as e:  # TIFFRGBAImageGet reads on
                got = e.out
            buf[:len(got)] = got
        b = np.frombuffer(bytes(buf), np.uint8).reshape(tall, wide, block)
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
        frame = read_frame(stream, tiff=True)
        if frame.progressive or frame.arith:
            raise DecodeError("TIFF: old-style JPEG of a progressive or arithmetic-coded stream "
                              "is not supported")
        if len(frame.ids) != nbands or (frame.width, frame.height) != (width, h):
            raise DecodeError(f"TIFF: old-style JPEG stream of {len(frame.ids)} components, "
                              f"{frame.width}x{frame.height}, for {nbands} samples of "
                              f"{width}x{h}")
        frame, planes, _ = decode_jpeg_planes(stream, tiff=True)
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
