"""Texture decoding in numpy and the standard library of the containers of
block-compressed texels: DDS, FTEX and BLP.

Each decoder returns the (H, W, 3) uint8 pixels, top row first, that PIL's
`Image.open(f).convert("RGB")` gives for the same file, byte for byte: it
reads the file as PIL's plugin reads it (DdsImagePlugin, FtexImagePlugin,
BlpImagePlugin), decodes the texels with utils/bcn_decode (PIL's C
decoder for DDS and FTEX, its Python one for BLP2), and converts the mode
PIL opens as to RGB (utils/pil_modes).

  DDS   the 124-byte header, its pixel-format flags tested in PIL's order
        (RGB, luminance, palette, FourCC): uncompressed RGB(A) under any
        channel masks (PIL's dds_rgb decoder: each masked value shifted
        down and scaled by 255 / its mask in float64, truncated; past the
        file's end the pixels read zero bytes), L and LA, 8-bit palette
        indices into a 1,024-byte RGBA palette, the FourCCs DXT1, DXT3,
        DXT5, BC4U/ATI1, BC5S, BC5U/ATI2 and DX10, whose DXGI formats are
        BC1-BC7 (the typeless and UNORM ones PIL lists; BC7's sRGB too),
        BC6H_UF16/SF16 and R8G8B8A8 (typeless, UNORM, sRGB). The first
        surface's top mip only: mipmaps, cube faces and array slices after
        it are ignored, as PIL ignores them.
  FTEX  one format only: DXT1 (PIL's C BC1) or uncompressed RGB.
  BLP   BLP1: JPEG (the shared header before mip 0; four-component
        streams read as CMYK without libjpeg's YCCK conversion, PIL's raw
        CMYK tile; the RGB bytes PIL gets are then stored as raw "BGR", so
        red and blue swap) and palette (encodings 4 and 5, the indices read
        right after the palette); BLP2: palette and DXT1/3/5 (PIL's Python
        decoders). BLP2's DXT rows are decoded a row of blocks at a time,
        four texel rows of the padded width each, and read back as rows of
        the image's width and mode (RGB, or RGBA where the alpha flag is
        set): at a width that is not a multiple of 4, or DXT3/DXT5 without
        the alpha flag (four bytes a texel read as three), the rows shear,
        as PIL's do.

What PIL refuses raises DecodeError naming the cause: a header size other
than 124, an unimplemented FourCC or DXGI format or BLP encoding, an
unsupported luminance bit count, truncated data, an image of more pixels
than PIL's decompression-bomb limit.
"""

from __future__ import annotations

import struct

import numpy as np

from . import bcn_decode
from .image_decode import DecodeError, _check_size, decode_jpeg_samples
from .pil_modes import cmyk_to_rgb, to_rgb

# DDS pixel-format flags (DDPF)
_ALPHAPIXELS, _FOURCC, _PALETTEINDEXED8, _RGB, _LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000
# FourCC -> block kind (DdsImagePlugin's legacy formats)
_FOURCCS = {b"DXT1": "BC1", b"DXT3": "BC2", b"DXT5": "BC3", b"BC4U": "BC4", b"ATI1": "BC4",
            b"BC5S": "BC5S", b"BC5U": "BC5", b"ATI2": "BC5"}
# DXGI format -> block kind, or "RGBA" (raw R8G8B8A8)
_DXGI = {70: "BC1", 71: "BC1", 73: "BC2", 74: "BC2", 76: "BC3", 77: "BC3", 79: "BC4",
         80: "BC4", 82: "BC5", 83: "BC5", 84: "BC5S", 95: "BC6H", 96: "BC6HS", 97: "BC7",
         98: "BC7", 99: "BC7", 27: "RGBA", 28: "RGBA", 29: "RGBA"}


def _unpack(fmt: str, data, pos: int, what: str):
    size = struct.calcsize(fmt)
    if pos < 0 or pos + size > len(data):
        raise DecodeError(f"truncated file inside {what}")
    return struct.unpack_from(fmt, data, pos)


def _size(width: int, height: int, kind: str) -> None:
    if width <= 0 or height <= 0:
        raise DecodeError(f"{kind}: image size {width}x{height}")
    _check_size(width, height)


def _take(data, pos: int, count: int, what: str) -> np.ndarray:
    """(count,) uint8 of `data` from `pos`, all present, as PIL's raw
    decoder and ImageFile._safe_read need them (none if count <= 0)."""
    if count <= 0:
        return np.zeros(0, np.uint8)
    if pos + count > len(data):
        raise DecodeError(f"truncated {what}: {count} bytes needed, {max(len(data) - pos, 0)} "
                          "in the file")
    return np.frombuffer(data, np.uint8, count, pos)


def _blocks(data, pos: int, width: int, height: int, kind: str, what: str) -> np.ndarray:
    """RGB of the BCn blocks of `kind` at `pos` (PIL's C decoder)."""
    size = bcn_decode.KINDS[kind][0]
    need = bcn_decode.block_count(width, height) * size
    px, mode = bcn_decode.decode_blocks(_take(data, pos, need, what), width, height, kind)
    return to_rgb(mode, px if mode != "L" else px[..., 0])


# ---------------------------------------------------------------------------
# DDS

def _mask_channel(value, mask: int) -> np.ndarray:
    """PIL's DdsRgbDecoder on one mask: int((v & mask) >> offset) / total
    * 255) with offset the mask's trailing zeros, total mask >> offset."""
    if mask == 0:
        return np.zeros(value.shape, np.uint8)
    offset = (mask & -mask).bit_length() - 1
    total = mask >> offset
    return (((value & mask) >> offset) / total * 255).astype(np.uint8)


def _dds_rgb(data, width: int, height: int, bitcount: int, masks) -> np.ndarray:
    """PIL's dds_rgb decoder: bitcount // 8 little-endian bytes a pixel from
    byte 128, zeros past the file's end."""
    step, k = bitcount // 8, np.arange(min(bitcount // 8, 4))  # the masks are 32-bit
    at = 128 + np.arange(width * height, dtype=np.int64)[:, None] * step + k
    buf = np.frombuffer(data, np.uint8)
    got = np.where(at < buf.size, buf[np.minimum(at, buf.size - 1)], 0).astype(np.int64)
    value = (got << (8 * k)).sum(1)
    return np.stack([_mask_channel(value, m) for m in masks[:3]], -1).reshape(height, width, 3)


def decode_dds(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a DDS file as PIL's convert("RGB")."""
    data = memoryview(data)
    header_size = _unpack("<I", data, 4, "the DDS header")[0]
    if header_size != 124:
        raise DecodeError(f"DDS: unsupported header size {header_size}, not 124")
    if len(data) < 128:
        raise DecodeError(f"DDS: incomplete header, {max(len(data) - 8, 0)} of 120 bytes")
    height, width = struct.unpack_from("<2I", data, 12)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", data, 80)
    masks = struct.unpack_from("<4I", data, 92)
    if pfflags & _RGB:
        _size(width, height, "DDS")
        count = 4 if pfflags & _ALPHAPIXELS else 3
        return _dds_rgb(data, width, height, bitcount, masks[:count])
    if pfflags & _LUMINANCE:
        if bitcount == 8:
            channels = 1
        elif bitcount == 16 and pfflags & _ALPHAPIXELS:
            channels = 2
        else:
            raise DecodeError(f"DDS: unsupported luminance bit count {bitcount} (flags "
                              f"{pfflags:#x})")
        _size(width, height, "DDS")
        grey = _take(data, 128, width * height * channels, "DDS luminance data")
        return to_rgb("L", grey[::channels].reshape(height, width))
    if pfflags & _PALETTEINDEXED8:
        _size(width, height, "DDS")
        palette = _take(data, 128, 1024, "DDS palette").reshape(256, 4)[:, :3]
        return to_rgb("P", _take(data, 1152, width * height, "DDS palette indices")
                      .reshape(height, width), palette)
    if not pfflags & _FOURCC:
        raise DecodeError(f"DDS: unknown pixel format flags {pfflags:#x}")
    pos, kind = 128, _FOURCCS.get(bytes(fourcc))
    if bytes(fourcc) == b"DX10":
        dxgi = _unpack("<I", data, 128, "the DDS DX10 header")[0]
        pos, kind = 148, _DXGI.get(dxgi)
        if kind is None:
            raise DecodeError(f"DDS: unimplemented DXGI format {dxgi}")
    elif kind is None:
        raise DecodeError(f"DDS: unimplemented pixel format {bytes(fourcc)!r}")
    _size(width, height, "DDS")
    if kind == "RGBA":
        return to_rgb("RGBA", _take(data, pos, width * height * 4, "DDS R8G8B8A8 data")
                      .reshape(height, width, 4))
    return _blocks(data, pos, width, height, kind, f"DDS {kind} data")


# ---------------------------------------------------------------------------
# FTEX

def decode_ftex(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of an FTEX file (FtexImagePlugin) as PIL's
    convert("RGB")."""
    data = memoryview(data)
    width, height, _, formats = _unpack("<4i", data, 8, "the FTEX header")
    if formats != 1:
        raise DecodeError(f"FTEX: {formats} formats, not 1")
    fmt, where = _unpack("<2i", data, 24, "the FTEX header")
    if where < 0:
        raise DecodeError(f"FTEX: negative data offset {where}")
    size = _unpack("<i", data, where, "the FTEX mipmap size")[0]
    body = data[where + 4:] if size < 0 else data[where + 4:where + 4 + size]
    if fmt not in (0, 1):
        raise DecodeError(f"FTEX: invalid texture compression format {fmt}")
    _size(width, height, "FTEX")
    if fmt == 0:
        return _blocks(body, 0, width, height, "BC1", "FTEX DXT1 data")
    return _take(body, 0, width * height * 3, "FTEX RGB data").reshape(height, width, 3).copy()


# ---------------------------------------------------------------------------
# BLP

def _palette_pixels(data, pos: int, count: int, palette, width: int, height: int):
    """BLP's _read_bgra: `count` index bytes from `pos` into the BGRA
    palette, the first width * height of them the image."""
    idx = _take(data, pos, count, "BLP palette indices")
    if idx.size < width * height:
        raise DecodeError(f"BLP: not enough image data ({idx.size} indices for "
                          f"{width}x{height})")
    return palette.reshape(256, 4)[idx[:width * height].reshape(height, width)][..., [2, 1, 0]]


def _blp1_jpeg(data, offset: int, length: int, width: int, height: int) -> np.ndarray:
    """BLP1 JPEG: the shared JPEG header before mip 0, decoded as PIL's
    JpegImageFile with a four-component stream read as CMYK (no YCCK
    conversion, Adobe's inversion kept), its RGB bytes stored as raw BGR
    into the BLP's size."""
    size = _unpack("<I", data, 156, "the BLP JPEG header size")[0]
    pos = 160 + size
    stream = _take(data, 160, size, "BLP JPEG header").tobytes()
    pos += _take(data, pos, offset - pos, "BLP data before mip 0").size
    stream += _take(data, pos, length, "BLP mip 0").tobytes()
    samples, space = decode_jpeg_samples(stream)
    if samples.shape[-1] == 4:
        samples, _ = decode_jpeg_samples(stream, space="raw")
        rgb = cmyk_to_rgb(255 - samples)
    elif space == "grey":
        rgb = np.repeat(samples, 3, -1)
    else:
        rgb = samples
    flat = rgb.reshape(-1)
    if flat.size < width * height * 3:
        raise DecodeError(f"BLP: not enough image data ({rgb.shape[1]}x{rgb.shape[0]} JPEG for "
                          f"{width}x{height})")
    return flat[:width * height * 3].reshape(height, width, 3)[..., ::-1].copy()


def _blp2_dxt(data, pos: int, width: int, height: int, alpha: bool, alpha_encoding: int):
    kind = {0: "DXT1", 1: "DXT3", 7: "DXT5"}.get(alpha_encoding)
    if kind is None:
        raise DecodeError(f"BLP: unsupported alpha encoding {alpha_encoding}")
    size = 8 if kind == "DXT1" else 16
    bw, bh = -(-width // 4), -(-height // 4)
    blocks = _take(data, pos, bh * bw * size, f"BLP {kind} rows").reshape(-1, size)
    px = bcn_decode.dxt_python(blocks, kind, alpha)
    stream = bcn_decode.tile(px, bw * 4, bh * 4).reshape(-1)
    bpp = 4 if alpha else 3
    return stream[:width * height * bpp].reshape(height, width, bpp)[..., :3].copy()


def decode_blp(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a BLP1 or BLP2 file (BlpImagePlugin) as
    PIL's convert("RGB")."""
    data = memoryview(data)
    magic = bytes(data[:4])
    if magic == b"BLP1":
        compression, alpha_word, width, height, encoding = _unpack("<iIIIi", data, 4,
                                                                   "the BLP header")
        alpha, start = alpha_word != 0, 28
    else:
        compression, encoding, alpha, alpha_encoding = _unpack("<ibbb", data, 4,
                                                               "the BLP header")
        width, height = _unpack("<II", data, 12, "the BLP header")
        alpha, start = alpha != 0, 20
    _size(width, height, "BLP")
    offsets = _unpack("<16I", data, start, "the BLP mip offsets")
    lengths = _unpack("<16I", data, start + 64, "the BLP mip lengths")
    if magic == b"BLP1":
        if compression == 0:
            return _blp1_jpeg(data, offsets[0], lengths[0], width, height)
        if compression != 1:
            raise DecodeError(f"BLP: unsupported BLP1 compression {compression}")
        if encoding not in (4, 5):
            raise DecodeError(f"BLP: unsupported BLP1 encoding {encoding}")
        palette = _take(data, 156, 1024, "BLP palette")
        return _palette_pixels(data, 1180, lengths[0], palette, width, height)
    palette = _take(data, 148, 1024, "BLP palette")
    if compression != 1:
        raise DecodeError(f"BLP: unknown BLP2 compression {compression}")
    if encoding == 1:
        return _palette_pixels(data, offsets[0], lengths[0], palette, width, height)
    if encoding == 2:
        return _blp2_dxt(data, offsets[0], width, height, alpha, alpha_encoding)
    raise DecodeError(f"BLP: unknown BLP2 encoding {encoding}")
