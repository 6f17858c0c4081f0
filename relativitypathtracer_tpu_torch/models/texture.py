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
and PNG by utils/image_decode, the PNM family (PIL's own P0CMYK, PyCMYK,
PyRGBA, PyP and Pf too), BMP, TGA and GIF by utils/raster_decode, TIFF
(JPEG-in-TIFF, new and old style, LZMA, ZSTD and the CCITT compressions
among its compressions; BigTIFF, float, CIELab and YCbCr among its kinds)
by utils/tiff_decode, WebP by utils/webp_decode (the first
frame on its canvas), the block-compressed containers DDS (BC1-BC7 and the
uncompressed kinds), FTEX and BLP by utils/dds_decode, PSD (the merged
image) by utils/psd_decode, SGI, PCX, DCX (its first page), Sun raster,
QOI and MSP by utils/legacy_raster, ICO, CUR and ICNS (the entry PIL
picks, PNG and JPEG 2000 entries among them) by utils/icon_decode, XBM
and XPM by utils/text_raster, FITS (its first image, GZIP_1 tiles too)
by utils/fits_decode, JPEG 2000 (J2K codestreams and JP2 files, OpenJPEG's
arithmetic to the bit) by utils/j2k_decode, FLI/FLC (the first frame) by
utils/fli_decode, IM and IMT by utils/im_decode, GBR, McIdas, PIXAR,
SPIDER, XVThumb and IPTC by utils/misc_raster, Photo CD (its base image)
by utils/pcd_decode, AVIF (its primary AV1 still picture: the tools PIL's
own encodes of photographs use, the others refused by name) by
utils/avif_decode. The format
is told as `Image.open` tells it: by the file's first bytes, PIL's first
five plugins first, then its other plugins in its order (Image.ID), each
by its accept test and the header checks on which PIL moves on to the
next plugin (utils/pil_open), TGA (which has no magic number) by its
header's checks after the others; an AVIF file whose container libavif
cannot parse is one PIL identifies as nothing. A format PIL opens and the
port does not (EPS), and an unknown one, raise TextureError, as does a
decoder's error, named by its format; so does an image of more pixels
than PIL's decompression-bomb limit (178,956,970) in any format.
"""

from __future__ import annotations

import numpy as np

from ..utils import pil_open
from ..utils.avif_decode import decode_avif
from ..utils.avif_decode import identify as avif_identify
from ..utils.avif_decode import parse_failure as avif_parse_failure
from ..utils.dds_decode import decode_blp, decode_dds, decode_ftex
from ..utils.fits_decode import decode_fits
from ..utils.fli_decode import decode_fli
from ..utils.icon_decode import decode_cur, decode_icns, decode_ico
from ..utils.im_decode import decode_im, decode_imt
from ..utils.image_decode import DecodeError, decode_jpeg, decode_png
from ..utils.j2k_decode import decode_j2k
from ..utils.legacy_raster import (decode_dcx, decode_msp, decode_pcx, decode_qoi, decode_sgi,
                                   decode_sun)
from ..utils.misc_raster import (decode_gbr, decode_iptc, decode_mcidas, decode_pixar,
                                 decode_spider, decode_xvthumb)
from ..utils.pcd_decode import decode_pcd
from ..utils.psd_decode import decode_psd
from ..utils.raster_decode import decode_bmp, decode_gif, decode_pnm, decode_tga, tga_header_ok
from ..utils.text_raster import decode_xbm, decode_xpm
from ..utils.tiff_decode import decode_tiff
from ..utils.webp_decode import decode_webp, is_webp

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)  # BmpImagePlugin._dib_accept
_TIFF_MAGIC = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
               b"II\x2b\x00")
_JPEG2000 = (b"\xff\x4f\xff\x51", b"\0\0\0\x0cjP  \r\n\x87\n")

# PIL's plugins after its first five, in its order (Image.ID), each as
# (name, the test on which PIL's Image.open takes the file, the name of
# this module's decoder of it); the formats PIL opens and this loader does
# not are _OTHER_FORMATS, each with why
_PLUGINS = (
    ("AVIF", avif_identify, "decode_avif"),
    ("BLP", lambda d: d[:4] in (b"BLP1", b"BLP2"), "decode_blp"),
    ("CUR", pil_open.cur, "decode_cur"),
    ("PCX", pil_open.pcx, "decode_pcx"),
    ("DCX", pil_open.dcx, "decode_dcx"),
    ("DDS", lambda d: d[:4] == b"DDS ", "decode_dds"),
    ("EPS", lambda d: d[:4] in (b"%!PS", b"\xc5\xd0\xd3\xc6"), None),
    ("FITS", lambda d: d[:6] == b"SIMPLE", "decode_fits"),
    ("FLI/FLC", pil_open.fli, "decode_fli"),
    ("FTEX", lambda d: d[:4] == b"FTEX", "decode_ftex"),
    ("GBR", pil_open.gbr, "decode_gbr"),
    ("JPEG 2000", lambda d: d.startswith(_JPEG2000), "decode_j2k"),
    ("ICNS", pil_open.icns, "decode_icns"),
    ("ICO", lambda d: d[:4] == b"\0\0\1\0" and pil_open.entries(d), "decode_ico"),
    ("IM", pil_open.im, "decode_im"),
    ("IMT", pil_open.imt, "decode_imt"),
    ("IPTC", pil_open.iptc, "decode_iptc"),
    ("McIdas", pil_open.mcidas, "decode_mcidas"),
    ("MSP", pil_open.msp, "decode_msp"),
    ("PCD", pil_open.pcd, "decode_pcd"),
    ("PIXAR", pil_open.pixar, "decode_pixar"),
    ("PSD", lambda d: d[:4] == b"8BPS" and d[4:6] == b"\0\1", "decode_psd"),
    ("QOI", lambda d: d[:4] == b"qoif", "decode_qoi"),
    ("SGI", lambda d: d[:2] == b"\x01\xda" and len(d) >= 12, "decode_sgi"),
    ("SPIDER", pil_open.spider, "decode_spider"),
    ("Sun raster", lambda d: d[:4] == b"\x59\xa6\x6a\x95" and len(d) >= 32, "decode_sun"),
    ("TGA", tga_header_ok, "decode_tga"),
    ("XBM", lambda d: d[:16].lstrip().startswith(b"#define"), "decode_xbm"),
    ("XPM", lambda d: d[:9] == b"/* XPM */", "decode_xpm"),
    ("XVThumb", pil_open.xvthumb, "decode_xvthumb"))
_OTHER_FORMATS = tuple(name for name, _, decoder in _PLUGINS if decoder is None)
_WHY_NOT = {"EPS": "PIL renders it with Ghostscript"}
_DECODED = ("PNM, BMP, GIF, JPEG, PNG, TIFF, WebP, "
            + ", ".join(name for name, _, decoder in _PLUGINS if decoder is not None))


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
    for name, test, decoder in _PLUGINS:
        if test(data):
            if decoder is None:
                raise ValueError(f"{name}: a format PIL opens and the port does not decode "
                                 f"({_WHY_NOT[name]}); textures are {_DECODED}")
            try:
                return globals()[decoder](data)
            except DecodeError as e:  # named by its format
                if str(e).startswith(name):
                    raise
                raise DecodeError(f"{name}: {e}") from e
    why = avif_parse_failure(data)
    if why:  # Pillow's AVIF plugin takes the file, libavif's parse fails, PIL moves on
        why = f"; {why}, so libavif does not parse it"
    raise ValueError(f"unknown format (first bytes {data[:8]!r}{why}): textures are {_DECODED}")


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
