"""Texture atlas loader.

Equivalent of ReadTexture (Render.cpp:418-434): each image is
decoded to interleaved 8-bit RGB and appended to one flat atlas; per-texture
(byte offset, width, height) triples are recorded in import order and later
resolved into object fields by the DSL post-pass.

Binary PPM (P6, maxval 255) is decoded here with numpy, as the reference's
CImg decodes PNM by itself, so PPM textures load where PIL is not installed.
Other formats go through PIL (the byte layout after CImg's
permute_axes("cxyz") equals PIL's row-major interleaved RGB).
"""

from __future__ import annotations

import numpy as np


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


def read_texture(path: str, atlas: bytearray, values: list) -> None:
    try:
        with open(path, "rb") as f:
            arr = read_ppm(f.read())
        if arr is None:
            from PIL import Image

            with Image.open(path) as im:
                arr = np.asarray(im.convert("RGB"), np.uint8)  # (h, w, 3)
    except Exception as e:  # noqa: BLE001 - mirror the reference's single failure path
        raise TextureError(f"Failed to load texture {path}: {e}") from e
    h, w = arr.shape[:2]
    values.append(len(atlas))  # byte offset
    values.append(int(w))
    values.append(int(h))
    atlas.extend(arr.tobytes())
