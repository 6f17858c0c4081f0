"""PIL's remaining small raster formats, decoded in numpy and the standard
library as PIL 12.1.0 opens each and `convert("RGB")` converts it, byte for
byte: GIMP brushes (GBR), McIdas area files, PIXAR, SPIDER, XV thumbnails
and IPTC/NAA.

  GBR      GbrImagePlugin: a big-endian header (size, version 1 or 2,
           width, height, depth 1 or 4; v2's "GIMP" magic and spacing),
           the data at the header's size: L or RGBA (alpha dropped)
  McIdas   McIdasImagePlugin: a 256-byte directory of 64 big-endian words
           (word 11 the bytes a sample: L, I;16B, I;32B read as I), rows
           of `stride` bytes from the directory's offset (PIL's raw
           decoder: a stride shorter than a row is an error, as here;
           PIL opening such a file from a path maps it and reads
           overlapping rows instead; a stride of 0 is none)
  PIXAR    PixarImagePlugin: only mode (14, 2), raw RGB at 1024; a file of
           another mode is not PIL's PIXAR (Image.open tries on)
  SPIDER   SpiderImagePlugin: 27 header floats, big- then little-endian,
           PIL's header test, a 2D image; float32 samples of the header's
           byte order after the header (a stack's first image after its
           own header); F -> RGB as PIL converts it
  XVThumb  XVThumbImagePlugin: "P7 332", comment lines, "w h ...", then
           bytes indexing PIL's fixed 3-3-2 palette
  IPTC     IptcImagePlugin: fields of 0x1C, record, dataset, size
           (extended sizes of up to 4 bytes) up to the first (8, 10)
           field; (3, 20) and (3, 30) the size, (3, 60) the bands, (3, 65)
           the band the data fills, (3, 120) the compression; the data,
           the concatenated (8, 10) fields, is a P5 PNM body (raw) or an
           image file of any format PIL opens (compression 5: PIL opens
           it from memory with Image.open, so here it goes through
           models/texture.decode_texture, PIL's plugin order); one band
           (L) is that image in its own mode, or the image is that one
           band of RGB or CMYK, the other bands 0, as PIL's Image.merge
           makes it (an L image; or, in band 1, which merge does not
           check, any one-band image: a 1-bit one, or a P one's indices)

Each `open_*` is its plugin's `_open`: Unidentified (image_decode) where
PIL's Image.open goes on to its next plugin, DecodeError where it fails.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_decode import DecodeError, Unidentified, _check_size, read_frame
from .pil_modes import band_reads, cmyk_to_rgb, to_rgb
from .raster_decode import _rows, bmp_grey_mode, decode_pnm, tga_header_ok


def _sized(width, height, what: str) -> None:
    """ImageFile's check that a plugin set a size (else PIL tries its next
    plugin), then the decompression-bomb limit."""
    if width <= 0 or height <= 0:
        raise Unidentified(f"{what}: empty image {width}x{height}")
    _check_size(width, height)


# ---------------------------------------------------------------------------
# GBR

def open_gbr(d: bytes):
    """GbrImageFile._open: (mode, width, height, data offset)."""
    if len(d) < 20:
        raise Unidentified("not a GIMP brush")
    size, version, width, height, depth = struct.unpack(">5I", d[:20])
    if size < 20 or version not in (1, 2) or not width or not height or depth not in (1, 4):
        raise Unidentified("not a GIMP brush")
    if version == 2 and (d[20:24] != b"GIMP" or len(d) < 28):
        raise Unidentified("not a GIMP brush, bad magic number or no spacing")
    _sized(width, height, "GBR")
    if version == 2 and size < 28:  # PIL reads the rest of the file as the comment
        raise DecodeError("GBR: header size below 28 (no image data after the comment)")
    return ("L" if depth == 1 else "RGBA"), width, height, size


def decode_gbr(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a GIMP brush, as PIL's `convert("RGB")` of
    it."""
    data = bytes(data)
    mode, w, h, pos = open_gbr(data)
    bands = len(mode)
    if pos + w * h * bands > len(data):
        raise DecodeError("GBR: not enough image data")
    s = np.frombuffer(data, np.uint8, w * h * bands, pos).reshape(h, w, bands)
    return to_rgb("L", s[..., 0]) if mode == "L" else to_rgb("RGBA", s)


# ---------------------------------------------------------------------------
# McIdas

_MCIDAS = {1: ("L", "u1"), 2: ("I", ">u2"), 4: ("I", ">i4")}


def open_mcidas(d: bytes):
    """McIdasImageFile._open: (sample type, width, height, offset, stride)."""
    if len(d) < 256 or d[:8] != b"\0\0\0\0\0\0\0\4":
        raise Unidentified("not an McIdas area file")
    w = (0,) + struct.unpack(">64i", d[:256])
    if w[11] not in _MCIDAS:
        raise Unidentified("unsupported McIdas format")
    _sized(w[10], w[9], "McIdas")
    return _MCIDAS[w[11]][1], w[10], w[9], w[34] + w[15], w[15] + w[10] * w[11] * w[14]


def decode_mcidas(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a McIdas area file, as PIL's
    `convert("RGB")` of it (L as grey, I;16B and I clipped to 0-255)."""
    data = bytes(data)
    dtype, w, h, offset, stride = open_mcidas(data)
    size = np.dtype(dtype).itemsize
    line = w * size
    if offset < 0:
        raise DecodeError("McIdas: negative data offset")
    if stride and stride < line:
        raise DecodeError(f"McIdas: a stride of {stride} bytes is shorter than a row")
    rows = _rows(data, offset, h, line, stride or line, False)
    s = np.ascontiguousarray(rows).view(dtype).reshape(h, w)
    return to_rgb("L" if size == 1 else "I", s)


# ---------------------------------------------------------------------------
# PIXAR

def open_pixar(d: bytes):
    """PixarImageFile._open: (width, height) of a (14, 2) file."""
    if d[:4] != b"\x80\xe8\0\0" or len(d) < 428:
        raise Unidentified("not a PIXAR file")
    height, width, _, _, kind, bands = struct.unpack_from("<6H", d, 416)
    if (kind, bands) != (14, 2):
        raise Unidentified(f"PIXAR mode ({kind}, {bands}) is not one PIL reads")
    _sized(width, height, "PIXAR")
    return width, height


def decode_pixar(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a PIXAR file of mode (14, 2): raw RGB
    rows at byte 1024."""
    data = bytes(data)
    w, h = open_pixar(data)
    return np.ascontiguousarray(_rows(data, 1024, h, 3 * w, 3 * w, False).reshape(h, w, 3))


# ---------------------------------------------------------------------------
# SPIDER

def _spider_header(h) -> int:
    """SpiderImagePlugin.isSpiderHeader on the 1-based header `h`."""
    for i in (1, 2, 5, 12, 13, 22, 23):
        f = h[i]
        if f != f or f in (float("inf"), float("-inf")) or f != int(f):
            return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    return int(h[22]) if int(h[22]) == int(h[13]) * int(h[23]) else 0


def open_spider(d: bytes):
    """SpiderImageFile._open: (sample type, width, height, offset)."""
    if len(d) < 108:
        raise Unidentified("not a valid Spider file")
    for order in ">", "<":
        h = (99,) + struct.unpack(order + "27f", d[:108])
        hdrlen = _spider_header(h)
        if hdrlen:
            break
    else:
        raise Unidentified("not a valid Spider file")
    if int(h[5]) != 1:
        raise Unidentified("not a Spider 2D image")
    width, height, stack, number = int(h[12]), int(h[2]), int(h[24]), int(h[27])
    if stack == 0 and number == 0:
        offset = hdrlen
    elif stack > 0 and number == 0:  # a stack: its first image, after its own header
        offset = 2 * hdrlen
    elif stack == 0 and number > 0:  # PIL fails (no stack offset yet)
        raise DecodeError("SPIDER: an image of a stack opened alone")
    else:
        raise Unidentified("inconsistent stack header values")
    _sized(width, height, "SPIDER")
    return order + "f4", width, height, offset


def decode_spider(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a SPIDER image, as PIL's `convert("RGB")`
    of its float samples."""
    data = bytes(data)
    dtype, w, h, offset = open_spider(data)
    if offset < 0:
        raise DecodeError("SPIDER: negative header length")
    rows = _rows(data, offset, h, 4 * w, 4 * w, False)
    return to_rgb("F", np.ascontiguousarray(rows).view(dtype).reshape(h, w))


# ---------------------------------------------------------------------------
# XVThumb

# XVThumbImagePlugin.PALETTE: 3 bits red, 3 green, 2 blue
_XV_PALETTE = np.array([(r * 255 // 7, g * 255 // 7, b * 255 // 3)
                        for r in range(8) for g in range(8) for b in range(4)], np.uint8)


def open_xvthumb(d: bytes):
    """XVThumbImageFile._open: (width, height, data offset)."""
    if d[:6] != b"P7 332":
        raise Unidentified("not an XV thumbnail file")
    pos = d.find(b"\n", 6)
    pos = len(d) if pos < 0 else pos + 1
    while True:
        if pos >= len(d):
            raise Unidentified("unexpected end of an XV thumbnail header")
        end = d.find(b"\n", pos)
        end = len(d) if end < 0 else end + 1
        s, pos = d[pos:end], end
        if s[0] != 35:  # '#'
            break
    fields = s.strip().split(maxsplit=2)[:2]
    if len(fields) < 2:
        raise DecodeError("XVThumb: no size line")
    try:
        width, height = int(fields[0]), int(fields[1])
    except ValueError:
        raise DecodeError(f"XVThumb: size {fields!r} is not numbers") from None
    _sized(width, height, "XVThumb")
    return width, height, pos


def decode_xvthumb(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of an XV thumbnail, as PIL's
    `convert("RGB")` of it."""
    data = bytes(data)
    w, h, pos = open_xvthumb(data)
    return _XV_PALETTE[_rows(data, pos, h, w, w, False)]


# ---------------------------------------------------------------------------
# IPTC

_IPTC_RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)


def _iptc_field(d: bytes, pos: int):
    """IptcImageFile.field at pos: (tag or None at the end, size, position
    after the header). IndexError and struct.error as PIL's reads raise
    them (Image.open's next plugin while opening)."""
    s = d[pos:pos + 5]
    pos += len(s)
    if not s.strip(b"\0"):
        return None, 0, pos
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in _IPTC_RECORDS:
        raise Unidentified("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise DecodeError("IPTC: illegal field length")
    if size == 128:
        size = 0
    elif size > 128:
        c = d[pos:pos + size - 128]
        pos += len(c)
        size = _int(c)
    else:
        size = struct.unpack(">H", s[3:5])[0]
    return tag, size, pos


def _int(c: bytes) -> int:
    return int.from_bytes((b"\0\0\0\0" + c)[-4:], "big")


def open_iptc(d: bytes):
    """IptcImageFile._open: (mode, band or None, width, height,
    compression, offset of the first (8, 10) field)."""
    info, pos = {}, 0
    try:
        while True:
            offset = pos
            tag, size, pos = _iptc_field(d, pos)
            if not tag or tag == (8, 10):
                break
            value = d[pos:pos + size] if size else None
            pos += len(value) if size else 0
            if tag in info:  # PIL keeps repeats as a list, which its reads below fail on
                info[tag] = [info[tag], value]
            else:
                info[tag] = value
    except (IndexError, struct.error):
        raise Unidentified("IPTC: truncated field") from None

    def get(key):
        v = info[key]
        if not isinstance(v, bytes):
            raise TypeError
        return v

    try:
        layers = get((3, 60))
        if layers[0] == 1 and not layers[1]:
            mode, band = "L", None
        else:
            mode = {3: "RGB", 4: "CMYK"}.get(layers[0]) if layers[1] else None
            band = get((3, 65))[0] - 1 if (3, 65) in info else 0
        width, height = _int(get((3, 20))), _int(get((3, 30)))
    except (KeyError, IndexError, TypeError):
        raise Unidentified("IPTC: no image size or bands") from None
    if (3, 120) not in info:
        raise DecodeError("IPTC: unknown image compression")
    if not isinstance(info[(3, 120)], bytes):
        raise Unidentified("IPTC: no compression value")
    compression = _int(info[(3, 120)])
    if compression not in (1, 5):
        raise DecodeError(f"IPTC: unknown image compression {compression}")
    if mode is None:
        raise Unidentified("IPTC: bands PIL has no mode for")
    _sized(width, height, "IPTC")
    return mode, band, width, height, compression, (offset if tag == (8, 10) else None)


def iptc_body(data: bytes):
    """(mode, band, width, height, compression, the image data: the
    concatenated (8, 10) fields) of an IPTC/NAA file."""
    data = bytes(data)
    mode, band, w, h, compression, pos = open_iptc(data)
    if pos is None:
        raise DecodeError("IPTC: no image data field (8, 10)")
    body = bytearray()
    while True:
        tag, size, pos = _iptc_field(data, pos)
        if tag != (8, 10):
            break
        chunk = data[pos:pos + size]
        body += chunk
        pos += len(chunk)
    return mode, band, w, h, compression, bytes(body)


def decode_iptc(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of an IPTC/NAA file, as PIL's
    `convert("RGB")` of it."""
    mode, band, w, h, compression, body = iptc_body(data)
    if compression == 1:
        grey = decode_pnm(b"P5\n%d %d\n255\n" % (w, h) + body)[..., 0]
    else:
        from ..models.texture import decode_texture  # PIL's Image.open of the body
        if band is None:
            return decode_texture(body)
        with band_reads() as seen:
            grey = decode_texture(body)[..., 0]
        kind = _body_mode(body, [m for m, _ in seen])
        if kind != "L" and (band or kind not in ("1", "P") + tuple(_STORAGE)):
            raise DecodeError(f"IPTC: an image of mode {kind} as band {band + 1} of {mode} "
                              "(PIL's merge takes an L image, and any one-band image as "
                              "band 1)")
        if kind in _STORAGE:  # merge copies a row's first bytes of PIL's storage
            samples = np.ascontiguousarray(seen[-1][1].astype(_STORAGE[kind]))
            grey = samples.view(np.uint8)[:, :samples.shape[1]]
        elif kind == "P":  # the indices
            grey = seen[-1][1].astype(np.uint8)
    if band is None:
        return to_rgb("L", grey)
    bands = [np.zeros_like(grey)] * len(mode)
    try:
        bands[band] = grey
    except IndexError:
        raise DecodeError(f"IPTC: band {band + 1} of mode {mode}") from None
    s = np.stack(bands, -1)
    return cmyk_to_rgb(s) if mode == "CMYK" else s


# PIL's storage of the one-band modes of more than 8 bits
_STORAGE = {"I;16": "<u2", "I;16B": ">u2", "I": "<i4", "F": "<f4"}


def _body_mode(body: bytes, modes: list) -> str:
    """The PIL mode an IPTC band's image opens in: told from the header for
    JPEG, PNG, PNM, TIFF and BMP (a BMP's P from `modes`, those its decoder
    converted from), from `modes` for GIF and TGA; "other" else."""
    if body[:3] == b"\xff\xd8\xff":
        return "L" if len(read_frame(body).ids) == 1 else "other"
    if body[:8] == b"\x89PNG\r\n\x1a\n" and body[12:16] == b"IHDR":
        depth, ctype = body[24], body[25]
        if ctype == 3:
            return "P"
        return {1: "1", 2: "L", 4: "L", 8: "L", 16: "I;16"}.get(depth, "other") if ctype == 0 \
            else "other"
    if body[:2] in (b"P1", b"P4"):
        return "1"
    if body[:2] in (b"P2", b"P5"):
        fields = body[2:64].split()
        return "L" if len(fields) >= 3 and fields[2].isdigit() and int(fields[2]) < 256 else \
            "other"
    if body[:4] in (b"II*\0", b"MM\0*"):
        from .tiff_decode import tiff_grey_mode
        return tiff_grey_mode(body, ("1", "L", "P") + tuple(_STORAGE))
    if body[:2] == b"BM":
        grey = bmp_grey_mode(body)
        return "P" if grey == "other" and modes[-1:] == ["P"] else grey
    if body[:4] == b"GIF8" or tga_header_ok(body):
        return modes[-1] if modes and modes[-1] in ("1", "L", "P") else "other"
    return "other"
