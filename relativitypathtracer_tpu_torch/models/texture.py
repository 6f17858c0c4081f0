"""Texture atlas loader.

Equivalent of ReadTexture (Render.cpp:418-434): each image is
decoded to interleaved 8-bit RGB and appended to one flat atlas; per-texture
(byte offset, width, height) triples are recorded in import order and later
resolved into object fields by the DSL post-pass.

Every format is decoded with numpy and the standard library, so textures
load on a host without an image library: binary PPM (P6, maxval 255) here,
as the reference's CImg decodes PNM by itself; JPEG and PNG by
utils/image_decode, byte for byte as PIL's `convert("RGB")` decodes them
(the JAX package's decoder; the reference's CImg reads them through libjpeg
and libpng, and the byte layout after its permute_axes("cxyz") is the same
row-major interleaved RGB). The format is told by the file's first bytes;
any other format raises TextureError.
"""

from __future__ import annotations

import numpy as np

from ..utils.image_decode import decode_jpeg, decode_png

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# formats PIL opens and this loader does not, by their first bytes
_OTHER_FORMATS = ((b"GIF8", "GIF"), (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
                  (b"RIFF", "RIFF (WebP)"), (b"P", "PNM other than binary PPM (P6)"))


class TextureError(ValueError):
    pass


def read_ppm(data: bytes):
    """(h, w, 3) uint8 pixels of a binary PPM (P6, maxval 255), or None when
    `data` is any other format. The header is four whitespace-separated
    fields (magic, width, height, maxval) with '#' comments allowed between
    them, and one whitespace byte before the pixels."""
    if data[:2] != b"P6":
        return None
    fields, pos = [], 2
    while len(fields) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        fields.append(int(data[start:pos]))
    w, h, maxval = fields
    if maxval != 255:
        return None
    pixels = np.frombuffer(data, np.uint8, count=w * h * 3, offset=pos + 1)
    return pixels.reshape(h, w, 3)


def write_ppm(path: str, rgb: np.ndarray) -> None:
    """Write (h, w, 3) uint8 pixels as a binary PPM (P6, maxval 255)."""
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(rgb, np.uint8).tobytes())


def decode_texture(data: bytes) -> np.ndarray:
    """(h, w, 3) uint8 pixels of a PPM, JPEG or PNG file's bytes, told
    apart by their first bytes."""
    if data[:2] == b"P6":
        arr = read_ppm(data)
        if arr is None:
            raise ValueError("PPM with a maxval other than 255 is not supported")
        return arr
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    if data[:8] == _PNG_MAGIC:
        return decode_png(data)
    kind = next((name for magic, name in _OTHER_FORMATS if data.startswith(magic)),
                f"unknown format (first bytes {data[:8]!r})")
    raise ValueError(f"{kind}: textures are binary PPM (P6), JPEG or PNG")


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
