"""Texture decoding in numpy and the standard library of the small raster
formats of PIL: SGI, PCX and DCX, Sun raster, QOI and MSP.

Each decoder returns the (H, W, 3) uint8 pixels, top row first, that PIL's
`Image.open(f).convert("RGB")` gives for the same file, byte for byte: it
reads the file as PIL's plugin reads it (SgiImagePlugin, PcxImagePlugin,
DcxImagePlugin, SunImagePlugin, QoiImagePlugin, MspImagePlugin and their
C decoders sgi_rle, pcx and sun_rle), then converts the mode PIL opens as
(utils/pil_modes).

  SGI   magic 474; verbatim (a plane a channel) or RLE (a table of row
        starts and one of row lengths, each row's atoms decoded as PIL's
        C decoder decodes them: a length counts atoms, not bytes; a row
        whose last atom is not 0 ends the image there, the rows after it
        black); 8 or 16 bits a sample (16-bit samples keep their high
        byte, PIL's ";16B" unpackers); dimensions 1-3, 1, 3 or 4 channels;
        rows bottom-up.
  PCX   RLE rows of planes x stride bytes (the stride from the width, made
        even where the header's differs); 1 bit (mode 1), 1 bit in 2 or 4
        planes (the header's 16-colour palette), 8 bits (the 769-byte
        palette at the end of the file, grey read as L) and 8 bits in 3
        planes (RGB); a run may not cross a row; the planes of a row packed
        as PIL's C decoder packs them.
  DCX   a table of page offsets; the first page, a PCX (an 8-bit page's
        palette is the end of the whole file, as PIL reads it).
  Sun   depths 1 (0 is white), 4, 8, 24 and 32 (RGB or BGR by type), a
        colour map making 4 and 8 bits a palette image (PIL fails on one
        beside 1, 24 or 32 bits); rows padded to 16 bits, or for the RLE
        type (0x80 escapes: 80 00 is one 0x80, 80 n v is n + 1 copies of
        v, runs across rows) rows of the unpadded width, as PIL reads them.
  QOI   PIL's Python decoder: INDEX, DIFF, LUMA, RUN, RGB and RGBA ops over
        the 64-entry hash table, 3 or 4 channels.
  MSP   version 1 (DanM) raw bits, version 2 (LinS) PIL's row map and RLE;
        the header's XOR checksum.

The RLE codes are Python loops over packets, runs or atoms (QOI's over
ops, which chain); the bytes they copy are gathered by numpy. What PIL
would not open, and corrupt or truncated data, raises DecodeError; nothing
returns a partial image except where PIL does (an SGI row that ends the
image).
"""

from __future__ import annotations

import numpy as np

from .image_decode import DecodeError, _check_size
from .pil_modes import palette256, scale_bits, to_rgb, unpack_bits
from .raster_decode import _rows


def _be(data: bytes, pos: int, size: int) -> int:
    if pos + size > len(data):
        raise DecodeError("truncated file inside a header")
    return int.from_bytes(data[pos:pos + size], "big")


def _le(data: bytes, pos: int, size: int) -> int:
    if pos + size > len(data):
        raise DecodeError("truncated file inside a header")
    return int.from_bytes(data[pos:pos + size], "little")


def _sized(width: int, height: int, what: str) -> None:
    if width <= 0 or height <= 0:
        raise DecodeError(f"{what}: empty image {width}x{height}")
    _check_size(width, height)


def expand(data: bytes, starts, counts, literal, step: int = 1) -> np.ndarray:
    """uint8 bytes of a packet stream: packet k gives counts[k] bytes, read
    every `step` bytes from data[starts[k]:] (literal) or data[starts[k]]
    repeated (a run)."""
    counts = np.asarray(counts, np.int64)
    if counts.size == 0:
        return np.zeros(0, np.uint8)
    starts, literal = np.asarray(starts, np.int64), np.asarray(literal, bool)
    first = np.cumsum(counts) - counts
    ramp = np.repeat(literal.astype(np.int64) * step, counts)
    idx = np.repeat(starts - step * first * literal, counts) + np.arange(int(counts.sum())) * ramp
    return np.frombuffer(data, np.uint8)[idx]


def packbits_rows(data: bytes, pos: int, height: int, row_bytes: int):
    """PIL's C packbits decoder (PackDecode.c) from data[pos:]: `height`
    rows of `row_bytes`; a header n < 128 copies n + 1 bytes, n > 128
    repeats the next byte 257 - n times, 128 is nothing; a packet crossing
    a row's end is cut there. -> (height, row_bytes) uint8."""
    starts, counts, literal = [], [], []
    n, total, x = len(data), height * row_bytes, 0
    done = 0
    while done < total:
        if pos >= n:
            raise DecodeError("truncated PackBits data")
        head = data[pos]
        if head == 0x80:
            pos += 1
            continue
        if head > 0x80:
            if pos + 2 > n:
                raise DecodeError("truncated PackBits data")
            take, lit, src = 257 - head, False, pos + 1
            pos += 2
        else:
            if pos + head + 2 > n:
                raise DecodeError("truncated PackBits data")
            take, lit, src = head + 1, True, pos + 1
            pos += head + 2
        take = min(take, row_bytes - x)
        starts.append(src)
        counts.append(take)
        literal.append(lit)
        x += take
        done += take
        if x >= row_bytes:
            x = 0
    return expand(data, starts, counts, literal).reshape(height, row_bytes)


# ---------------------------------------------------------------------------
# SGI

_SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L",
              (1, 3, 3): "RGB", (2, 3, 3): "RGB", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}
_SGI_HEADER = 512


def _sgi_row(data, pos: int, n: int, width: int, bpc: int, end: int):
    """SgiRleDecode.c's expandrow/expandrow2: the row's runs as (starts,
    counts, literal) in samples, and its status: 0 done, 1 the image ends
    here (a row's last atom not 0); -1 (PIL's overrun) raises. `end` is
    the file's last byte; atoms are bpc bytes, the count in the last."""
    starts, counts, literal, x = [], [], [], 0
    for k in range(n, 0, -1):
        if pos + bpc - 1 > end:
            raise DecodeError("SGI: an RLE row runs past the end of the file")
        pixel = data[pos + bpc - 1]
        pos += bpc
        if k == 1 and pixel:
            return starts, counts, literal, 1
        count = pixel & 0x7F
        if not count:
            break
        if x + count > width:
            raise DecodeError("SGI: an RLE row is longer than the image")
        x += count
        if pixel & 0x80:
            if pos + bpc * count > end:
                raise DecodeError("SGI: an RLE copy runs past the end of the file")
            starts.append(pos)
            literal.append(True)
            pos += bpc * count
        else:
            if pos + bpc - (bpc == 1) > end:
                raise DecodeError("SGI: an RLE run runs past the end of the file")
            starts.append(pos)
            literal.append(False)
            pos += bpc
        counts.append(count)
    return starts, counts, literal, 0


def decode_sgi(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of an SGI image file (.sgi, .rgb, .bw), as
    PIL's `convert("RGB")` of it."""
    data = bytes(data)
    if _be(data, 0, 2) != 474:
        raise DecodeError("not an SGI file")
    compression, bpc = data[2], data[3]
    dimension, width, height, zsize = (_be(data, p, 2) for p in (4, 6, 8, 10))
    mode = _SGI_MODES.get((bpc, dimension, zsize))
    if mode is None:
        raise DecodeError(f"SGI: {bpc} bytes a sample, dimension {dimension}, {zsize} channels "
                          "is not a mode PIL reads")
    if compression not in (0, 1):
        raise DecodeError(f"SGI: storage {compression} (0 verbatim and 1 RLE are)")
    _sized(width, height, "SGI")
    bands = len(mode)
    page = width * height * bpc
    if compression == 0:
        if _SGI_HEADER + bands * page > len(data):
            raise DecodeError("SGI: truncated image data")
        planes = np.frombuffer(data, np.uint8, bands * page, _SGI_HEADER)
        px = planes.reshape(bands, height, width, bpc)[..., 0].transpose(1, 2, 0)[::-1]
        return to_rgb(mode, px if bands > 1 else px[..., 0])
    size = len(data) - _SGI_HEADER
    rows = bands * height
    if size < 8 * rows:
        raise DecodeError("SGI: truncated RLE tables")
    tabs = np.frombuffer(data, ">u4", 2 * rows, _SGI_HEADER).astype(np.int64)
    start, length = tabs[:rows].tolist(), tabs[rows:].tolist()
    out = np.zeros((height, width, bands), np.uint8)
    row = np.zeros((width, bands), np.uint8)  # PIL's row buffer, kept from row to row
    end = len(data) - 1
    for r in range(height):
        for c in range(bands):
            pos, n = start[r + c * height], length[r + c * height]
            n = n if n < 1 << 31 else 0  # PIL's C int: a negative length reads no atoms
            if pos < _SGI_HEADER:  # each atom read is checked against the end
                raise DecodeError("SGI: an RLE row starts inside the header")
            starts, counts, literal, status = _sgi_row(data, pos, n, width, bpc, end)
            got = expand(data, starts, counts, literal, bpc)  # each atom's high byte
            row[:got.size, c] = got
            if status:
                return to_rgb(mode, out if bands > 1 else out[..., 0])
        out[height - 1 - r] = row
    return to_rgb(mode, out if bands > 1 else out[..., 0])


# ---------------------------------------------------------------------------
# PCX and DCX

def decode_pcx(data: bytes, start: int = 0) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a PCX file, or of the PCX page at `start`
    of a DCX file, as PIL's `convert("RGB")` of it."""
    data = bytes(data)
    head = data[start:start + 68]
    if len(head) < 68:
        raise DecodeError("PCX: truncated header")
    if head[0] != 10 or head[1] not in (0, 2, 3, 5):
        raise DecodeError("not a PCX file")
    x0, y0, x1, y1 = (int.from_bytes(head[p:p + 2], "little") for p in (4, 6, 8, 10))
    width, height = x1 + 1 - x0, y1 + 1 - y0
    if width <= 0 or height <= 0:
        raise DecodeError(f"PCX: bad image size {width}x{height}")
    version, bits, planes = head[1], head[3], head[65]
    provided = int.from_bytes(head[66:68], "little")
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P"
        palette = palette256(np.frombuffer(head[16:64], np.uint8))
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        if len(data) < 769:  # PIL seeks 769 bytes back from the end
            raise DecodeError("PCX: an 8-bit file shorter than its 769-byte palette")
        tail = data[-769:]
        if tail[0] == 12:
            entries = np.frombuffer(tail, np.uint8, 768, 1).reshape(256, 3)
            if (entries != np.arange(256)[:, None]).any():
                mode, palette = "P", entries
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise DecodeError(f"PCX: {bits} bits in {planes} planes (version {version}) is not a "
                          "mode PIL reads")
    _check_size(width, height)
    stride = (width * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    line = planes * stride
    rows = _pcx_rle(data, start + 128, height, line)
    # PcxDecode.c packs the planes' rows before unpacking: bit planes to
    # ceil(width / 8) bytes each, byte planes to the width
    if bits == 1 and planes > 1:
        size, bands, step = (width + 7) // 8, planes, line // planes
    else:
        size, bands = width, line // width
        step = line // bands if bands else 0
    if step > size:
        rows = rows.copy()
        for i in range(1, bands):
            rows[:, i * size:(i + 1) * size] = rows[:, i * step:i * step + size]
    if mode == "1":
        return to_rgb("1", unpack_bits(rows, 1, width) * np.uint8(255))
    if mode == "P" and bits == 1:
        s = (width + 7) // 8  # the unpacker's plane stride
        idx = sum(unpack_bits(rows[:, k * s:(k + 1) * s], 1, width) << k for k in range(planes))
        return to_rgb("P", idx.astype(np.uint8), palette)
    if mode == "RGB":
        return np.ascontiguousarray(rows[:, :3 * width].reshape(height, 3, width)
                                    .transpose(0, 2, 1))
    px = rows[:, :width]
    return to_rgb("L", px) if palette is None else to_rgb("P", px, palette)


def _pcx_rle(data: bytes, pos: int, height: int, line: int) -> np.ndarray:
    """PcxDecode.c: a byte 0xC0 | n is a run of the next byte n times, any
    other byte itself; a run may not cross a row (PIL fails at the image's
    end). In a stretch of bytes >= 0xC0 the first is a run's head, the next
    its value, and so on, so the packets are found without a loop.
    -> (height, line) uint8."""
    total = height * line
    buf = np.frombuffer(data, np.uint8)[pos:]
    high = np.flatnonzero(buf >= 0xC0)
    starts = np.diff(high, prepend=-2) != 1  # where a stretch of such bytes starts
    first = np.maximum.accumulate(np.where(starts, high, 0))
    heads = high[(high - first) % 2 == 0]
    count = np.ones(buf.size, np.int64)
    count[heads] = buf[heads] & 0x3F
    values = heads + 1
    count[values[values < buf.size]] = 0
    src = np.arange(buf.size)
    src[heads] = np.minimum(values, buf.size - 1)
    made = np.cumsum(count)
    last = int(np.searchsorted(made, total))  # the packet that completes the image
    is_head = np.zeros(buf.size + 1, bool)
    is_head[heads] = True
    if last >= buf.size or (is_head[last] and last + 1 >= buf.size):
        raise DecodeError("PCX: truncated image data")
    runs = heads[heads <= last]
    if ((made[runs] - count[runs]) % line + count[runs] > line).any():
        raise DecodeError("PCX: an RLE run crosses a row")
    return np.repeat(buf[src[:last + 1]], count[:last + 1])[:total].reshape(height, line)


DCX_MAGIC = 0x3ADE68B1


def decode_dcx(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a DCX file's first page, as PIL's
    `convert("RGB")` of it."""
    data = bytes(data)
    if _le(data, 0, 4) != DCX_MAGIC:
        raise DecodeError("not a DCX file")
    offsets = []
    for i in range(1024):
        offset = _le(data, 4 + 4 * i, 4)
        if not offset:
            break
        offsets.append(offset)
    if not offsets:
        raise DecodeError("DCX: no pages")
    return decode_pcx(data, offsets[0])


# ---------------------------------------------------------------------------
# Sun raster

SUN_MAGIC = 0x59A66A95


def decode_sun(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a Sun raster file, as PIL's
    `convert("RGB")` of it."""
    data = bytes(data)
    if _be(data, 0, 4) != SUN_MAGIC:
        raise DecodeError("not a Sun raster file")
    width, height, depth, _, kind, map_kind, map_len = (_be(data, 4 * i, 4) for i in range(1, 8))
    if depth not in (1, 4, 8, 24, 32):
        raise DecodeError(f"Sun raster: depth {depth} is not one PIL reads")
    pos, palette = 32, None
    if map_len:
        if map_len > 1024:
            raise DecodeError(f"Sun raster: a colour map of {map_len} bytes (1024 at most)")
        if map_kind != 1:
            raise DecodeError(f"Sun raster: colour map type {map_kind} (1, RGB, is read)")
        if depth not in (4, 8):  # PIL cannot put a palette on a 1-bit or RGB image
            raise DecodeError(f"Sun raster: a colour map beside {depth} bits a pixel")
        raw = data[pos:pos + map_len]
        pos += map_len
        k = len(raw) // 3
        planes = np.frombuffer(raw, np.uint8, 3 * k).reshape(3, k)
        palette = palette256(planes.T)
    if kind not in (0, 1, 2, 3, 4, 5):
        raise DecodeError(f"Sun raster: type {kind} is not one PIL reads")
    if width >= 2 ** 31 or height >= 2 ** 31:
        raise DecodeError(f"Sun raster: {width}x{height} pixels")
    _sized(width, height, "Sun raster")
    row_bytes = (width * depth + 7) // 8
    if kind == 2:
        rows = _sun_rle(data, pos, height * row_bytes).reshape(height, row_bytes)
    else:
        rows = _rows(data, pos, height, row_bytes, (width * depth + 15) // 16 * 2, False)
    if depth == 1:
        return to_rgb("1", (1 - unpack_bits(rows, 1, width)) * np.uint8(255))
    if depth in (4, 8):
        px = unpack_bits(rows, 4, width) if depth == 4 else rows[:, :width]
        if palette is not None:
            return to_rgb("P", px, palette)
        return to_rgb("L", scale_bits(px, 4) if depth == 4 else px)
    order = ("RGB" if depth == 24 else "RGBX") if kind == 3 else ("BGR" if depth == 24
                                                                   else "BGRX")
    px = rows[:, :width * len(order)].reshape(height, width, len(order))
    return np.ascontiguousarray(px[..., [order.index(c) for c in "RGB"]])


def _sun_rle(data: bytes, pos: int, total: int) -> np.ndarray:
    """SunRleDecode.c: 80 00 is one 0x80, 80 n v is n + 1 copies of v (a run
    goes on across rows), any other byte itself; `total` bytes. A loop over
    the 0x80 bytes finds the escapes; the rest is numpy."""
    buf = np.frombuffer(data, np.uint8)[pos:]
    n = buf.size
    count = np.ones(n + 2, np.int64)
    src = np.arange(n + 2)
    free = 0  # where the next packet starts, at or after
    for c in np.flatnonzero(buf == 0x80).tolist():
        if c < free:
            continue
        if c + 1 >= n:
            count[c], free = 1 << 40, n  # a cut escape: the image cannot complete here
            break
        if buf[c + 1] == 0:
            count[c + 1], free = 0, c + 2
        else:
            count[c], src[c] = int(buf[c + 1]) + 1, c + 2
            count[c + 1:c + 3], free = 0, c + 3
    count = count[:n]
    made = np.cumsum(count)
    last = int(np.searchsorted(made, total))  # the packet that completes the image
    if last >= n or count[last] >= 1 << 40 or src[last] >= n:
        raise DecodeError("Sun raster: truncated RLE image data")
    return np.repeat(buf[src[:last + 1]], count[:last + 1])[:total]


# ---------------------------------------------------------------------------
# QOI

def decode_qoi(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a QOI file, as PIL's `convert("RGB")` of
    it (its Python decoder, op by op)."""
    data = bytes(data)
    if data[:4] != b"qoif":
        raise DecodeError("not a QOI file")
    if len(data) < 13:
        raise DecodeError("QOI: truncated header")
    width, height = _be(data, 4, 4), _be(data, 8, 4)
    bands = 3 if data[12] == 3 else 4
    _sized(width, height, "QOI")
    want = width * height
    # the ops' pixels as 32-bit RGBA words (r in the low byte), each op's
    # repeat count; the hash table holds words too
    words, reps = [], []
    seen = {}
    prev = 0xFF000000
    pos, n, got = 14, len(data), 0
    while got < want:
        if pos >= n:
            raise DecodeError("QOI: truncated image data")
        b = data[pos]
        pos += 1
        if b == 0xFE:
            if pos + 3 > n:
                raise DecodeError("QOI: truncated image data")
            value = data[pos] | data[pos + 1] << 8 | data[pos + 2] << 16 | (prev & 0xFF000000)
            pos += 3
        elif b == 0xFF:
            if pos + 4 > n:
                raise DecodeError("QOI: truncated image data")
            value = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        elif b < 0x40:
            value = seen.get(b, 0)
        elif b < 0x80:
            dr, dg, db = (b >> 4 & 3) - 2, (b >> 2 & 3) - 2, (b & 3) - 2
            value = ((prev + dr) & 0xFF | (((prev >> 8) + dg) & 0xFF) << 8
                     | (((prev >> 16) + db) & 0xFF) << 16 | prev & 0xFF000000)
        elif b < 0xC0:
            if pos >= n:
                raise DecodeError("QOI: truncated image data")
            second = data[pos]
            pos += 1
            dg = (b & 0x3F) - 32
            dr, db = dg + (second >> 4) - 8, dg + (second & 15) - 8
            value = ((prev + dr) & 0xFF | (((prev >> 8) + dg) & 0xFF) << 8
                     | (((prev >> 16) + db) & 0xFF) << 16 | prev & 0xFF000000)
        else:
            run = (b & 0x3F) + 1
            words.append(prev)
            reps.append(run)
            got += run
            continue
        prev = value
        r, g, bl, a = value & 0xFF, value >> 8 & 0xFF, value >> 16 & 0xFF, value >> 24
        seen[(r * 3 + g * 5 + bl * 7 + a * 11) % 64] = value
        words.append(value)
        reps.append(1)
        got += 1
    px = np.repeat(np.array(words, np.uint32), reps)[:want]
    rgba = px.view(np.uint8).reshape(height, width, 4)
    return np.ascontiguousarray(rgba[..., :3])


# ---------------------------------------------------------------------------
# MSP

def decode_msp(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a Windows Paint (MSP) file, as PIL's
    `convert("RGB")` of it."""
    data = bytes(data)
    if data[:4] not in (b"DanM", b"LinS"):
        raise DecodeError("not an MSP file")
    if len(data) < 32:
        raise DecodeError("MSP: truncated header")
    words = np.frombuffer(data, "<u2", 16)
    if int(np.bitwise_xor.reduce(words)):
        raise DecodeError("MSP: bad header checksum")
    width, height = int(words[2]), int(words[3])
    _sized(width, height, "MSP")
    row_bytes = (width + 7) // 8
    if data[:4] == b"DanM":
        rows = _rows(data, 32, height, row_bytes, row_bytes, False)
    else:
        if 32 + 2 * height > len(data):
            raise DecodeError("MSP: truncated row map")
        rowmap = np.frombuffer(data, "<u2", height, 32).tolist()
        starts, counts, literal = [], [], []
        pos = 32 + 2 * height
        for y, size in enumerate(rowmap):
            if size == 0:  # PIL fills the row white
                starts.append(len(data))
                counts.append(row_bytes)
                literal.append(False)
                continue
            row_end = pos + size
            if row_end > len(data):
                raise DecodeError(f"MSP: truncated file in row {y}")
            while pos < row_end:
                kind = data[pos]
                pos += 1
                if kind == 0:
                    if pos + 2 > row_end:
                        raise DecodeError(f"MSP: corrupted row {y}")
                    starts.append(pos + 1)
                    counts.append(data[pos])
                    literal.append(False)
                    pos += 2
                else:
                    take = min(kind, row_end - pos)
                    starts.append(pos)
                    counts.append(take)
                    literal.append(True)
                    pos += kind
            pos = row_end
        flat = expand(data + b"\xff", starts, counts, literal)
        if flat.size < height * row_bytes:
            raise DecodeError("MSP: not enough image data")
        rows = flat[:height * row_bytes].reshape(height, row_bytes)
    return to_rgb("1", unpack_bits(rows, 1, width) * np.uint8(255))
