"""Texture atlas loader.

Equivalent of ReadTexture (Render.cpp:418-434): each image is
decoded to interleaved 8-bit RGB and appended to one flat atlas; per-texture
(byte offset, width, height) triples are recorded in import order and later
resolved into object fields by the DSL post-pass.

Every format is decoded with numpy and the standard library, so textures
load on a host without an image library, byte for byte as PIL's
`Image.open(f).convert("RGB")` decodes them (the JAX package's decoder; the
reference's CImg reads PNM and BMP itself and the rest through libraries,
and the byte layout after its permute_axes("cxyz") is the same row-major
interleaved RGB): JPEG (Huffman- and arithmetic-coded, utils/jpeg_arith)
and PNG by utils/image_decode, the PNM family, BMP, TGA and GIF by
utils/raster_decode, TIFF (JPEG-in-TIFF, new and old style, among its
compressions) by utils/tiff_decode, WebP by utils/webp_decode (the first
frame on its canvas), the block-compressed containers DDS (BC1-BC7 and the
uncompressed kinds), FTEX and BLP by utils/dds_decode. The format is
told as `Image.open` tells it: by the file's first bytes, in the order PIL
tries its plugins, TGA (which has no magic number) by its header's checks
after the others. A format PIL opens and the port does not, and an unknown
one, raise TextureError.
"""

from __future__ import annotations

import numpy as np

from ..utils.dds_decode import decode_blp, decode_dds, decode_ftex
from ..utils.image_decode import decode_jpeg, decode_png
from ..utils.raster_decode import decode_bmp, decode_gif, decode_pnm, decode_tga, tga_header_ok
from ..utils.tiff_decode import decode_tiff
from ..utils.webp_decode import decode_webp, is_webp

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)  # BmpImagePlugin._dib_accept
_TIFF_MAGIC = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
               b"II\x2b\x00")


def _entries(data: bytes) -> bool:
    """A cursor's or icon's directory as CurImageFile and IcoFile read it:
    at least one 16-byte entry, each present (else PIL tries the next
    plugin)."""
    count = int.from_bytes(data[4:6], "little")
    return count > 0 and len(data) >= 6 + 16 * count


# formats PIL opens and this loader does not, by their first bytes; the
# other formats' plugins come before TGA's in PIL's order
_OTHER_FORMATS = ((lambda d: d[4:8] == b"ftyp", "AVIF/HEIF"),
                  (lambda d: d[:4] == b"\0\0\2\0" and _entries(d), "CUR"),
                  (lambda d: d[:1] == b"\x0a" and d[1:2] in (b"\0", b"\2", b"\3", b"\5"), "PCX"),
                  (lambda d: d[:4] in (b"%!PS", b"\xc5\xd0\xd3\xc6"), "EPS"),
                  (lambda d: d[:6] == b"SIMPLE", "FITS"),
                  (lambda d: d[:4] == b"icns", "ICNS"),
                  (lambda d: d[:4] == b"\0\0\1\0" and _entries(d), "ICO"),
                  (lambda d: d[:4] == b"\xff\x4f\xff\x51" or d[:12] == b"\0\0\0\x0cjP  \r\n\x87\n",
                   "JPEG 2000"),
                  (lambda d: d[:4] in (b"DanM", b"LinS"), "MSP"),
                  (lambda d: d[:4] == b"8BPS", "PSD"),
                  (lambda d: d[:4] == b"qoif", "QOI"),
                  (lambda d: d[:2] == b"\x01\xda", "SGI"),
                  (lambda d: d[:4] == b"\x59\xa6\x6a\x95", "Sun raster"),
                  (lambda d: d[:7] == b"#define", "XBM"),
                  (lambda d: d[:9] == b"/* XPM */", "XPM"))


class TextureError(ValueError):
    pass


def write_ppm(path: str, rgb: np.ndarray) -> None:
    """Write (h, w, 3) uint8 pixels as a binary PPM (P6, maxval 255)."""
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(rgb, np.uint8).tobytes())


def decode_texture(data: bytes) -> np.ndarray:
    """(h, w, 3) uint8 pixels of an image file's bytes, its format told as
    PIL's Image.open tells it (module docstring)."""
    if data[:2] == b"BM":
        return decode_bmp(data)
    if len(data) >= 4 and int.from_bytes(data[:4], "little") in _DIB_HEADERS:
        return decode_bmp(data, dib=True)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return decode_gif(data)
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg(data)
    if data[:1] == b"P" and len(data) > 1 and data[1] in b"0123456fy":
        return decode_pnm(data)
    if data[:8] == _PNG_MAGIC:
        return decode_png(data)
    if data[:4] in _TIFF_MAGIC:
        return decode_tiff(data)
    if is_webp(data):
        return decode_webp(data)
    # PIL's plugins in its order: BLP, DDS and FTEX among the others, each
    # told by a magic number no plugin tried before it takes
    if data[:4] in (b"BLP1", b"BLP2"):
        return decode_blp(data)
    if data[:4] == b"DDS ":
        return decode_dds(data)
    if data[:4] == b"FTEX":
        return decode_ftex(data)
    kind = next((name for test, name in _OTHER_FORMATS if test(data)), None)
    if kind is None and tga_header_ok(data):
        return decode_tga(data)
    raise ValueError(f"{kind or f'unknown format (first bytes {data[:8]!r})'}: textures are "
                     "PNM, BMP, GIF, JPEG, PNG, TIFF, WebP, BLP, DDS, FTEX or TGA")


def read_texture(path: str, atlas: bytearray, values: list) -> None:
    try:
        with open(path, "rb") as f:
            arr = decode_texture(f.read())
    except Exception as e:  # noqa: BLE001 - mirror the reference's single failure path
        raise TextureError(f"Failed to load texture {path}: {e}") from e
    h, w = arr.shape[:2]
    values.append(len(atlas))  # byte offset
    values.append(int(w))
    values.append(int(h))
    atlas.extend(arr.tobytes())
