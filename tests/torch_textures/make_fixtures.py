"""Write the texture decoders' fixtures into this directory, and their
PIL decodes' hashes into pil_rgb.json.

    python tests/torch_textures/make_fixtures.py

Each file is small and made from a seed: JPEGs written by PIL (baseline,
optimised Huffman tables, progressive, restart markers, 4:4:4, 4:2:2,
4:2:0, greyscale), PNGs written by PIL (palette with transparency, RGBA,
16-bit grey with samples past 255), and an Adam7-interlaced PNG written
here with zlib (PIL writes no interlaced PNG). pil_rgb.json holds each
file's shape and the SHA-256 of `Image.open(f).convert("RGB")`'s bytes,
with the Pillow and libjpeg-turbo versions that made them; the tests and
chip_smoke.py's textures phase hold the port's decoders to those hashes.
"""

from __future__ import annotations

import hashlib
import io
import json
import pathlib
import struct
import zlib

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
SEED = 18


def _picture(rng, h: int, w: int) -> np.ndarray:
    """(h, w, 3) uint8: smooth gradients under seeded noise."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1), (x + y) * 4 % 256], -1)
    return np.clip(base + rng.integers(-24, 24, (h, w, 3)), 0, 255).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def interlaced_png(rgb: np.ndarray, rng) -> bytes:
    """An 8-bit RGB Adam7 PNG of `rgb`, each row of each pass under a
    seeded filter type (0-4)."""
    h, w, _ = rgb.shape
    data = bytearray()
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
                           (1, 0, 2, 2), (0, 1, 1, 2)):
        sub = rgb[y0::dy, x0::dx].astype(np.int64)
        if sub.size == 0:
            continue
        prev = np.zeros(sub.shape[1] * 3, np.int64)
        for row in sub.reshape(sub.shape[0], -1):
            kind = int(rng.integers(0, 5))
            left = np.concatenate([[0, 0, 0], row[:-3]])
            upleft = np.concatenate([[0, 0, 0], prev[:-3]])
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            pred = (0, left, prev, (left + prev) // 2, paeth)[kind]
            data += bytes([kind]) + ((row - pred) % 256).astype(np.uint8).tobytes()
            prev = row
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
            + _chunk(b"IDAT", zlib.compress(bytes(data))) + _chunk(b"IEND", b""))


def main() -> None:
    from PIL import Image, features

    rng = np.random.default_rng(SEED)
    files = {}
    jpegs = {"baseline.jpg": ((24, 40), {}), "optimized.jpg": ((31, 29), {"optimize": True}),
             "progressive.jpg": ((48, 64), {"progressive": True}),
             "restart.jpg": ((40, 56), {"restart_marker_blocks": 2}),
             "s444.jpg": ((17, 23), {"subsampling": "4:4:4", "quality": 95}),
             "s422.jpg": ((21, 35), {"subsampling": "4:2:2", "quality": 50}),
             "s420.jpg": ((33, 19), {"subsampling": "4:2:0", "quality": 100}),
             "grey.jpg": ((26, 30), {"quality": 90})}
    for name, (shape, kw) in jpegs.items():
        im = Image.fromarray(_picture(rng, *shape))
        buf = io.BytesIO()
        (im.convert("L") if name == "grey.jpg" else im).save(buf, "JPEG", **kw)
        files[name] = buf.getvalue()
    pal = Image.fromarray(_picture(rng, 20, 28)).quantize(16)
    rgba = Image.fromarray(np.concatenate([_picture(rng, 18, 22),
                                           rng.integers(0, 256, (18, 22, 1), dtype=np.uint8)],
                                          2), "RGBA")
    grey16 = Image.fromarray(rng.integers(0, 4096, (14, 19)).astype(np.uint16))
    for name, im, kw in (("palette.png", pal, {"transparency": 3}), ("rgba.png", rgba, {}),
                         ("grey16.png", grey16, {})):
        buf = io.BytesIO()
        im.save(buf, "PNG", **kw)
        files[name] = buf.getvalue()
    files["interlaced.png"] = interlaced_png(_picture(rng, 27, 37), rng)
    record = {"pillow": features.version("pil"), "libjpeg_turbo": features.version("libjpeg_turbo"),
              "files": {}}
    for name, data in files.items():
        (HERE / name).write_bytes(data)
        with Image.open(io.BytesIO(data)) as im:
            rgb = np.asarray(im.convert("RGB"))
        record["files"][name] = {"shape": list(rgb.shape),
                                 "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    (HERE / "pil_rgb.json").write_text(json.dumps(record, indent=1) + "\n")


if __name__ == "__main__":
    main()
