"""Texture atlas loader.

Equivalent of ReadTexture (Render.cpp:418-434): each image is
decoded to interleaved 8-bit RGB and appended to one flat atlas; per-texture
(byte offset, width, height) triples are recorded in import order and later
resolved into object fields by the DSL post-pass.

Uses PIL in place of the vendored CImg (the byte layout after CImg's
permute_axes("cxyz") equals PIL's row-major interleaved RGB).
"""

from __future__ import annotations

import numpy as np


class TextureError(ValueError):
    pass


def read_texture(path: str, atlas: bytearray, values: list) -> None:
    try:
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
