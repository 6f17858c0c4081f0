"""Texture decoding in numpy and the standard library of Adobe Photoshop
(PSD) files.

`decode_psd` returns the (H, W, 3) uint8 pixels, top row first, that PIL's
`Image.open(f).convert("RGB")` gives for the same file, byte for byte: it
reads the file as PsdImagePlugin reads it and converts the mode PIL opens
as (utils/pil_modes).

PIL reads the merged image after the layer section and nothing of the
layers. The header's (colour mode, depth) gives the PIL mode (MODES):
bitmap at 1 bit reads as mode 1 with a set bit white (PIL's raw "1", the
inverse of what Photoshop shows), grey, duotone and multichannel as L from
the first channel, indexed as P with the 768-byte palette of the colour
mode data (planar: 256 reds, greens, blues), RGB as RGB, or RGBA where the
file has exactly four channels, CMYK as CMYK with every sample inverted
(the ";I" raw modes), Lab as LAB (a and b stored with the top bit flipped,
PIL's signed a and b; utils/pil_modes' littleCMS transform to sRGB). The channels are planes one after another, raw or PackBits (a table
of 2-byte row counts a channel and row, used only to find where each
channel starts; each channel's rows then decode from there as one stream,
a packet crossing a row's end cut there, as PIL's C decoder does).

What PIL refuses raises DecodeError naming the cause: a version other than
1, a depth of 16 or 32 bits or any (mode, depth) PIL does not list, fewer
channels than the mode needs, a compression other than raw and PackBits,
truncated data, more pixels than PIL's decompression-bomb limit.
"""

from __future__ import annotations

import numpy as np

from .image_decode import DecodeError, _check_size
from .legacy_raster import packbits_rows
from .pil_modes import to_rgb, unpack_bits

# (photoshop mode, bits) -> (PIL mode, channels read) (PsdImagePlugin.MODES)
MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
         (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
         (9, 8): ("LAB", 3)}


class _Reader:
    """PIL's sequential reads of the file: short at the end, and an integer
    read short of its bytes raises (PIL's struct.error)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        got = self.data[self.pos:self.pos + n]
        self.pos += len(got)
        return got

    def int(self, n: int) -> int:
        got = self.read(n)
        if len(got) < n:
            raise DecodeError("PSD: truncated file inside a header")
        return int.from_bytes(got, "big")


def decode_psd(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a PSD file's merged image, as PIL's
    `convert("RGB")` of it."""
    data = bytes(data)
    if data[:4] != b"8BPS":
        raise DecodeError("not a PSD file")
    if len(data) < 26:
        raise DecodeError("PSD: truncated header")
    version = int.from_bytes(data[4:6], "big")
    if version != 1:
        raise DecodeError(f"PSD: version {version} (1 is read)")
    channels_in_file = int.from_bytes(data[12:14], "big")
    height, width = int.from_bytes(data[14:18], "big"), int.from_bytes(data[18:22], "big")
    bits, psd_mode = int.from_bytes(data[22:24], "big"), int.from_bytes(data[24:26], "big")
    if (psd_mode, bits) not in MODES:
        raise DecodeError(f"PSD: colour mode {psd_mode} at {bits} bits a channel is not one "
                          "PIL reads (8-bit modes and 1-bit bitmaps are)")
    mode, channels = MODES[(psd_mode, bits)]
    if channels > channels_in_file:
        raise DecodeError(f"PSD: {channels_in_file} channels, fewer than mode {mode} needs")
    if mode == "RGB" and channels_in_file == 4:
        mode, channels = "RGBA", 4
    f = _Reader(data, 26)
    palette = None
    size = f.int(4)  # colour mode data
    if size:
        table = f.read(size)
        if mode == "P" and size == 768:
            palette = np.frombuffer(table, np.uint8).reshape(3, 256).T.copy()
    size = f.int(4)  # image resources, read entry by entry as PIL reads them
    if size:
        end = f.pos + size
        while f.pos < end:
            f.read(4)
            f.int(2)
            name = f.read(f.int(1))
            if not len(name) & 1:
                f.read(1)
            block = f.read(f.int(4))
            if len(block) & 1:
                f.read(1)
    size = f.int(4)  # layer and mask information, skipped
    if size:
        end = f.pos + size
        f.int(4)
        f.pos = end
    compression = f.int(2)
    if width <= 0 or height <= 0:
        raise DecodeError(f"PSD: empty image {width}x{height}")
    _check_size(width, height)
    if compression not in (0, 1):
        raise DecodeError(f"PSD: compression {compression} (raw and PackBits are read)")
    row_bytes = (width + 7) // 8 if mode == "1" else width
    planes = []
    if compression == 0:
        offset = f.pos
        for _ in range(channels):
            need = offset + row_bytes * height
            if need > len(data):
                raise DecodeError("PSD: truncated image data")
            planes.append(np.frombuffer(data, np.uint8, row_bytes * height, offset)
                          .reshape(height, row_bytes))
            offset += width * height
    else:
        counts = f.read(channels * height * 2)
        if len(counts) < channels * height * 2:
            raise DecodeError("PSD: truncated table of PackBits row counts")
        sums = np.frombuffer(counts, ">u2").astype(np.int64).reshape(channels, height).sum(1)
        offset = f.pos
        for c in range(channels):
            planes.append(packbits_rows(data, offset, height, row_bytes))
            offset += int(sums[c])
    if mode == "1":
        return to_rgb("1", unpack_bits(planes[0], 1, width) * np.uint8(255))
    px = np.stack(planes, -1) if channels > 1 else planes[0]
    if mode == "P":
        # a P image without a palette converts to black in PIL
        return to_rgb("P", px, np.zeros((256, 3), np.uint8) if palette is None else palette)
    if mode == "CMYK":
        return to_rgb("CMYK", 255 - px)
    if mode == "LAB":  # PIL's "A" and "B" unpackers flip the top bit (signed a, b)
        return to_rgb("LAB", px ^ np.array([0, 0x80, 0x80], np.uint8))
    return to_rgb(mode, px)
