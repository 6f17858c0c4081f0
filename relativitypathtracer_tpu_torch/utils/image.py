"""Image output: PNG, GIF and baseline JPEG in numpy and the standard library.

The renderer produces (H, W, 3) float images in bottom-up row order (pixel
row 0 = bottom of screen, matching the reference's GL presentation,
gl_interop.cpp:51-67). The PNG and GIF writers flip to top-down; the JPEG
encoder, which the web viewer calls on frames already in display order,
takes top-down rows.

No codec library is needed (the card's host promises none): PNG is zlib
over filter-0 rows; GIF quantises to a fixed 256-colour palette and codes
it with LZW; JPEG is baseline sequential JFIF with 4:2:0 chroma and the
Annex K tables, its DCT, quantisation and entropy coding vectorised over
all blocks of a frame.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(img) -> np.ndarray:
    """Float [0,1] -> uint8 by truncation, like the reference's uchar cast
    (opencl_kernel.cl:653-657)."""
    arr = np.asarray(img)
    return (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)


def flip_vertical(img) -> np.ndarray:
    return np.asarray(img)[::-1]


def _rgb8(img) -> np.ndarray:
    """(H, W, 3) uint8 of a float [0, 1] or uint8 image."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {arr.shape}")
    return arr


# ---------------------------------------------------------------------------
# PNG


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img) -> None:
    """img: (H, W, 3) float [0,1] bottom-up, or uint8. 8-bit RGB, filter 0
    on every row."""
    arr = np.ascontiguousarray(flip_vertical(_rgb8(img)))
    h, w, _ = arr.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # a filter-type byte (0) a row
    rows[:, 1:] = arr.reshape(h, 3 * w)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# GIF

# A fixed palette: a 6x7x6 colour cube (252 entries, seven green levels for
# the eye's green sensitivity) and four greys between the cube's.
_CUBE_R = np.round(np.linspace(0, 255, 6)).astype(np.int32)
_CUBE_G = np.round(np.linspace(0, 255, 7)).astype(np.int32)
_CUBE_B = _CUBE_R
_GREYS = np.array([32, 96, 160, 224], np.int32)
PALETTE = np.concatenate([
    np.stack(np.meshgrid(_CUBE_R, _CUBE_G, _CUBE_B, indexing="ij"), -1).reshape(-1, 3),
    np.repeat(_GREYS[:, None], 3, 1)]).astype(np.uint8)  # (256, 3)


def _nearest_level(x, levels):
    """Index of the nearest of ascending `levels` to each x (the lower on a tie)."""
    mid = (levels[1:] + levels[:-1]) / 2.0
    return np.searchsorted(mid, x, side="left")


def quantize(img_uint8) -> np.ndarray:
    """(H, W) uint8 indices into PALETTE of the nearest colour (Euclidean in
    RGB) to each pixel of an (H, W, 3) uint8 image. The cube is a product
    grid, so its nearest entry is the nearest level per channel; a grey wins
    only when strictly nearer."""
    x = np.asarray(img_uint8).astype(np.int32)
    ir = _nearest_level(x[..., 0], _CUBE_R)
    ig = _nearest_level(x[..., 1], _CUBE_G)
    ib = _nearest_level(x[..., 2], _CUBE_B)
    idx = (ir * len(_CUBE_G) + ig) * len(_CUBE_B) + ib
    best = ((x - PALETTE[idx].astype(np.int32)) ** 2).sum(-1)
    base = len(_CUBE_R) * len(_CUBE_G) * len(_CUBE_B)
    for k, g in enumerate(_GREYS):
        d = ((x - g) ** 2).sum(-1)
        closer = d < best
        idx = np.where(closer, base + k, idx)
        best = np.where(closer, d, best)
    return idx.astype(np.uint8)


def _pack_bits_lsb(values, widths) -> bytes:
    """Concatenate codes LSB first (GIF's order): code i occupies `widths[i]`
    bits after the codes before it. Codes never overlap, so a byte's value is
    the sum of the pieces that land in it."""
    values = np.asarray(values, np.int64)
    widths = np.asarray(widths, np.int64)
    start = np.concatenate([[0], np.cumsum(widths)[:-1]])
    nbytes = int((start[-1] + widths[-1] + 7) // 8)
    shifted = values << (start % 8)  # at most 12 + 7 bits: three bytes
    first = start // 8
    out = np.zeros(nbytes + 2, np.float64)
    for k in range(3):
        out += np.bincount(first + k, weights=((shifted >> (8 * k)) & 0xFF).astype(np.float64),
                           minlength=nbytes + 2)
    return out[:nbytes].astype(np.uint8).tobytes()


def _lzw_codes(indices: bytes):
    """GIF LZW of 8-bit indices (minimum code size 8): the codes and their
    widths. A clear code first and whenever the table is full (4096 codes);
    a code's width grows when the table outgrows it; the end code last, in
    the width the decoder expects after its last entry."""
    clear, end = 256, 257
    codes, widths = [clear], [9]
    table: dict = {}
    next_code, width = 258, 9
    prefix = indices[0]
    for c in indices[1:]:
        key = (prefix << 8) | c
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        widths.append(width)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << width):
                width += 1
        else:
            codes.append(clear)
            widths.append(width)
            table.clear()
            next_code, width = 258, 9
        prefix = c
    codes.append(prefix)
    widths.append(width)
    # the decoder adds its entry for the last code (it lags one code behind
    # the encoder) and widens if that fills the current width
    if len(codes) > 2 and codes[-2] != clear and next_code == (1 << width) and width < 12:
        width += 1
    codes.append(end)
    widths.append(width)
    return codes, widths


def _sub_blocks(data: bytes) -> bytes:
    """GIF data sub-blocks: a length byte before each 255 bytes, then 0."""
    out = bytearray()
    for i in range(0, len(data), 255):
        piece = data[i:i + 255]
        out.append(len(piece))
        out += piece
    out.append(0)
    return bytes(out)


def write_gif(path: str, frames, fps: float = 30.0) -> None:
    """frames: sequence of (H, W, 3) float [0,1] or uint8 bottom-up images;
    one GIF89a frame each (the fixed PALETTE, nearest colour), looping,
    1000 / fps ms apart in the format's centiseconds, truncated as PIL
    truncates the JAX package's `duration=int(1000.0 / fps)`."""
    frames = [np.ascontiguousarray(flip_vertical(_rgb8(f))) for f in frames]
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    h, w, _ = frames[0].shape
    if any(f.shape != frames[0].shape for f in frames):
        raise ValueError("write_gif: every frame must have the same size")
    delay = int(1000.0 / fps) // 10
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0))
    out += PALETTE.tobytes()  # the global colour table, 2**(7 + 1) entries
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"  # loop forever
    for f in frames:
        out += b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00"  # no disposal
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0)
        codes, widths = _lzw_codes(quantize(f).tobytes())
        out += b"\x08" + _sub_blocks(_pack_bits_lsb(codes, widths))
    out += b"\x3b"
    with open(path, "wb") as fh:
        fh.write(bytes(out))


# ---------------------------------------------------------------------------
# JPEG (baseline sequential, JFIF, 8-bit, 4:2:0)

# ITU T.81 Annex K.1 quantisation tables, natural (row-major) order.
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32, np.int64)

# Annex K.3 Huffman tables: code counts of lengths 1-16, then the symbols.
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1,
    0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18,
    0x19, 0x1A, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8,
    0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09,
    0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25,
    0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA,
    0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6,
    0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])

# ZIGZAG[k]: the natural index of the k-th coefficient in zig-zag order
ZIGZAG = np.array(sorted(range(64), key=lambda n: (n // 8 + n % 8,
                                                  n // 8 if (n // 8 + n % 8) % 2 else n % 8)))


def quant_tables(quality: int = 85):
    """The luminance and chrominance tables scaled to `quality` (1-100) as
    libjpeg scales them (jcparam.c jpeg_quality_scaling, baseline clamp to
    1-255); natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((base * scale + 50) // 100, 1, 255) for base in (_LUMA_Q, _CHROMA_Q))


def _huffman_codes(spec):
    """(code, length) of each of 256 symbols from a table's counts and
    symbols (T.81 Annex C); a length of 0 where the symbol has no code."""
    counts, symbols = spec
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


# the four tables one after another (luminance DC, AC, chrominance DC, AC)
_HUFF_CODE, _HUFF_LEN = (np.concatenate(t) for t in zip(*(
    _huffman_codes(s) for s in (_DC_LUMA, _AC_LUMA, _DC_CHROMA, _AC_CHROMA))))


def _dct_matrix():
    """(64, 64) orthonormal 2-D DCT-II of a row-major 8x8 block (T.81's FDCT),
    columns in zig-zag order."""
    n = np.arange(8)
    c = np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return np.kron(c, c)[ZIGZAG].T  # (pixel, coefficient)


_DCT = _dct_matrix()


def _blocks(plane, by: int, bx: int):
    """(rows, cols) -> (rows/8 * cols/8, 64): the plane's 8x8 blocks in scan
    order, by x bx blocks an MCU (row-major within it), MCUs in raster order."""
    r, c = plane.shape
    x = plane.reshape(r // (8 * by), by, 8, c // (8 * bx), bx, 8)
    return x.transpose(0, 3, 1, 4, 2, 5).reshape(-1, 64)


def _transform(blocks, matrix):
    """blocks (n, 64) @ matrix (64, 64) in float32, 64 rows a product: BLAS
    runs a product that small on the calling thread, where it spreads a
    frame's whole product over its thread pool, whose start-up and spinning
    on a host busy with the viewer's other threads cost far more than the
    arithmetic."""
    out = np.empty((blocks.shape[0], 64), np.float32)
    for i in range(0, blocks.shape[0], 64):
        np.matmul(blocks[i:i + 64], matrix, out=out[i:i + 64])
    return out


def _bit_length(v):
    """Bits of |v| (0 for 0), the JPEG magnitude category."""
    return np.where(v == 0, 0, np.frexp(np.abs(v).astype(np.float64))[1]).astype(np.int64)


def _pack_bits_msb(values, widths) -> np.ndarray:
    """Concatenate codes MSB first (JPEG's order), pad the last byte with 1s
    (T.81 F.1.2.3). A code is at most 16 + 11 bits, so with its start's
    offset in its byte it spans at most five bytes."""
    end = np.cumsum(widths)
    nbits = int(end[-1])
    nbytes = (nbits + 7) // 8
    # each code left-aligned in a 40-bit window from its start byte
    shifted = values << (40 - widths - (end - widths) % 8)
    first = (end - widths) // 8
    out = np.zeros(nbytes + 5, np.float64)
    for k in range(5):
        out += np.bincount(first + k, weights=((shifted >> (32 - 8 * k)) & 0xFF).astype(np.float64),
                           minlength=nbytes + 5)
    data = out[:nbytes].astype(np.uint8)
    if nbits % 8:
        data[-1] |= 0xFF >> (nbits % 8)
    return data


def _entropy_code(coefs, comp) -> bytes:
    """Huffman-code quantised blocks in scan order (T.81 F.1.2): coefs (n,
    64) int in zig-zag order, comp (n,) each block's component (0 Y, coded
    with the luminance tables; 1 Cb and 2 Cr, with the chrominance ones).
    The DC as the difference from the previous block of its own component;
    each nonzero AC as (run, size) after a ZRL for each 16 zeros of its
    run; an EOB after the last nonzero AC unless it is the 63rd. Returns
    the byte-stuffed scan data."""
    coefs = np.asarray(coefs, np.int32)
    n = coefs.shape[0]
    comp = np.asarray(comp)
    dc = coefs[:, 0].copy()
    for c in np.unique(comp):
        sel = np.flatnonzero(comp == c)
        dc[sel] = np.diff(coefs[sel, 0], prepend=0)
    # tokens in stream order: column 0 the DC, 1-63 the nonzero ACs, 64 an EOB
    tokens = np.empty((n, 65), bool)
    tokens[:, 0] = True
    np.not_equal(coefs[:, 1:], 0, out=tokens[:, 1:64])
    tokens[:, 64] = ~tokens[:, 63]  # the last AC is zero: its run ends in an EOB
    blk, col = np.divmod(np.flatnonzero(tokens).astype(np.int32), 65)
    ac = (col > 0) & (col < 64)
    val = np.where(col == 0, dc[blk], np.where(ac, coefs[blk, np.minimum(col, 63)], 0))
    size = _bit_length(val)
    extra = np.where(val < 0, val + (1 << size) - 1, val).astype(np.int64)
    prev = np.concatenate([[0], col[:-1]])
    run = np.where(ac, col - prev - 1, 0)
    zrl = run >> 4
    # one lookup in the four Huffman tables: luminance DC, AC, chrominance DC, AC
    symbol = np.where(col == 0, size, np.where(ac, (run & 15) * 16 + size, 0x00))
    which = (comp[blk] != 0) * 512 + (col != 0) * 256 + symbol
    code, clen = _HUFF_CODE[which], _HUFF_LEN[which]
    values = (code << size) | extra
    widths = clen + size
    # each ZRL (symbol 0xF0) of a token goes right before it
    reps = zrl + 1
    pos = np.cumsum(reps) - 1  # each token's slot after its ZRLs
    zrl_at = (comp[blk] != 0) * 512 + 256 + 0xF0
    all_values = np.repeat(_HUFF_CODE[zrl_at], reps)
    all_widths = np.repeat(_HUFF_LEN[zrl_at], reps)
    all_values[pos] = values
    all_widths[pos] = widths
    data = _pack_bits_msb(all_values, all_widths)
    ff = np.flatnonzero(data == 0xFF)  # byte stuffing: 0x00 after each 0xFF
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", 0xFF00 | marker, len(payload) + 2) + payload


def encode_jpeg(img_hwc_uint8_topdown, quality: int = 85) -> bytes:
    """Baseline sequential JFIF bytes of an (H, W, 3) uint8 image in display
    (top-down) order: YCbCr (JFIF's full-range matrix), 4:2:0 chroma (2x2
    means), the Annex K tables scaled to `quality` as libjpeg scales them,
    the Annex K Huffman tables. The image is padded to 16-pixel MCUs by
    repeating its last row and column; the header holds its own size."""
    img = np.asarray(img_hwc_uint8_topdown)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, got {img.shape} {img.dtype}")
    h, w, _ = img.shape
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    if (ph, pw) != (h, w):
        img = np.pad(img, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    r, g, b = np.ascontiguousarray(img.transpose(2, 0, 1), dtype=np.float32)  # planes
    y = 0.299 * r + 0.587 * g + 0.114 * b - 128.0
    # 4:2:0: the 2x2 means of R, G and B, then their chroma (a linear map,
    # so the same as the 2x2 means of Cb and Cr)
    r, g, b = ((p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]) * 0.25
               for p in (r, g, b))
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b
    qy, qc = quant_tables(quality)
    n = (ph // 16) * (pw // 16)  # MCUs: four Y blocks, one Cb, one Cr
    coefs = np.empty((n, 6, 64), np.float32)
    # the DCT, the quantiser's division and the zig-zag order in one matrix
    coefs[:, :4] = _transform(_blocks(y, 2, 2), (_DCT / qy[ZIGZAG]).astype(np.float32)).reshape(
        n, 4, 64)
    dct_c = (_DCT / qc[ZIGZAG]).astype(np.float32)
    coefs[:, 4] = _transform(_blocks(cb, 1, 1), dct_c)
    coefs[:, 5] = _transform(_blocks(cr, 1, 1), dct_c)
    return jfif(np.rint(coefs).astype(np.int32), h, w, qy, qc)


def jfif(coefs, height: int, width: int, qy, qc) -> bytes:
    """The baseline JFIF file of quantised coefficients: coefs (MCUs, 6, 64)
    int in zig-zag order, each MCU's four Y blocks (row-major) then its Cb
    and its Cr block, MCUs in raster order over the image padded to 16
    pixels; qy, qc the quantisation tables (natural order, 1-255) the
    decoder multiplies by."""
    coefs = np.asarray(coefs)
    n = coefs.shape[0]
    scan = _entropy_code(coefs.reshape(-1, 64), np.tile(np.array([0, 0, 0, 0, 1, 2]), n))
    dqt = b"".join(bytes([k]) + np.asarray(t)[ZIGZAG].astype(np.uint8).tobytes()
                   for k, t in enumerate((qy, qc)))
    sof = struct.pack(">BHHB", 8, height, width, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    dht = b""
    for tc_th, (counts, symbols) in zip((0x00, 0x10, 0x01, 0x11),
                                        (_DC_LUMA, _AC_LUMA, _DC_CHROMA, _AC_CHROMA)):
        dht += bytes([tc_th]) + bytes(counts) + bytes(symbols)
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (b"\xff\xd8"
            + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + _segment(0xDB, dqt) + _segment(0xC0, sof) + _segment(0xC4, dht)
            + _segment(0xDA, sos) + scan + b"\xff\xd9")
