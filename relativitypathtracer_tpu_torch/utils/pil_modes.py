"""PIL's image modes and its `convert("RGB")` from them, for the texture
decoders (utils/image_decode, utils/raster_decode, utils/tiff_decode).

A decoder that follows PIL reads a file's samples into one of PIL's modes,
as PIL's format plugin would (its "rawmode" unpacking: bit depths, byte
orders, palettes), then converts to RGB as `Image.convert("RGB")` does
(Convert.c), which `to_rgb` does here:

  1, L       grey, repeated into three channels ("1" holds 0 or 255);
  LA         the grey channel;
  P, PA      the palette's colour of each index (a palette of 256 entries);
  RGB, RGBA, RGBX
             the first three channels;
  I, I;16    integers clipped to 0-255 (not scaled: 4000 -> 255);
  CMYK       Convert.c cmyk2rgb: nk = 255 - K, each channel
             nk - MULDIV255(C, nk) in integers.
"""

from __future__ import annotations

import numpy as np


def unpack_bits(rows, depth: int, width: int) -> np.ndarray:
    """(h, n) uint8 rows of samples packed `depth` (1, 2 or 4) bits each,
    first sample in the high bits -> (h, width) uint8 sample values."""
    rows = np.asarray(rows, np.uint8)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth].reshape(rows.shape[0], width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)


def scale_bits(s, depth: int) -> np.ndarray:
    """Samples of 1, 2 or 4 bits scaled to 0-255 as PIL's L;1/L;2/L;4
    unpackers scale them (x 255, 85, 17)."""
    return (np.asarray(s, np.uint8) * (255 // ((1 << depth) - 1))).astype(np.uint8)


def five_bits(v) -> np.ndarray:
    """The low 5 bits of v to 8 bits as PIL's BGR;15 unpackers do:
    v * 255 // 31."""
    return ((np.asarray(v, np.int64) & 31) * 255 // 31).astype(np.uint8)


def palette256(entries) -> np.ndarray:
    """(256, 3) uint8: the palette's first 256 (r, g, b) entries, black past
    its end."""
    entries = np.asarray(entries, np.uint8).reshape(-1, 3)[:256]
    pal = np.zeros((256, 3), np.uint8)
    pal[:entries.shape[0]] = entries
    return pal


def cmyk_to_rgb(cmyk) -> np.ndarray:
    """(..., 4) uint8 CMYK -> (..., 3) uint8 RGB, Convert.c cmyk2rgb."""
    c = np.asarray(cmyk, np.int64)
    nk = 255 - c[..., 3:4]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def to_rgb(mode: str, a, palette=None) -> np.ndarray:
    """(h, w, 3) uint8: PIL's `convert("RGB")` of an image of `mode` whose
    samples are `a`, (h, w) for one band and (h, w, bands) for several;
    `palette` (256, 3) for P and PA."""
    a = np.asarray(a)
    if mode in ("1", "L"):
        grey = a.astype(np.uint8)
    elif mode == "LA":
        grey = a[..., 0].astype(np.uint8)
    elif mode in ("I", "I;16"):
        grey = np.clip(a, 0, 255).astype(np.uint8)
    elif mode in ("P", "PA"):
        return palette[a if mode == "P" else a[..., 0]]
    elif mode in ("RGB", "RGBA", "RGBX"):
        return np.ascontiguousarray(a[..., :3], np.uint8)
    elif mode == "CMYK":
        return cmyk_to_rgb(a)
    else:
        raise ValueError(f"no conversion from mode {mode} to RGB")
    return np.repeat(grey[..., None], 3, -1)
