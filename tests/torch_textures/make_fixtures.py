"""Write the texture decoders' fixtures into this directory, and their
PIL decodes' hashes into pil_rgb.json.

    python tests/torch_textures/make_fixtures.py

Each file is small (under 4 KB) and made from a seed: JPEGs written by PIL
(baseline, optimised Huffman tables, progressive, restart markers, 4:4:4,
4:2:2, 4:2:0, greyscale, CMYK) and PNGs written by PIL (palette with
transparency, RGBA, 16-bit grey with samples past 255), PNM, BMP, TGA, GIF
and TIFF files written by PIL, and what PIL does not write, built here: an
Adam7-interlaced PNG, JPEGs with Adobe's RGB and YCCK transforms and with
luma sampled 3x1, plain PNM with comments and odd maxvals, RLE8, RLE4,
565-bitfield, OS/2 and top-down BMPs, TGAs with a 16-bit colour map and
with RLE packets across rows, a GIF with a local palette and a frame
smaller than its screen, and TIFFs in planar tiles, big-endian 16-bit RGB
and fill order 2; WebP files PIL writes (lossless, lossy, with alpha) and
built here (an animation whose first frame is smaller than its canvas,
VP8 frames from a boolean encoder with the header features PIL's encoder
leaves out, VP8L with simple codes and every palette bundling width);
arithmetic-coded JPEGs, PIL's Huffman files transcoded by libjpeg's
arithmetic encoder (jcarith.c, `QMEncoder`); JPEG-in-TIFF written by PIL
(compression 7) and built here (tiles, strips, JPEGTables, planar;
old-style compression 6 as the interchange format and with its tables in
tags); DDS written by PIL (DXT1/3/5, BC5, RGB, RGBA, L, LA) and built here
(seeded random blocks of every BCn kind, every BC6H and BC7 mode, masks,
a palette, mipmaps, a cube map, BC7 mode 6 from `bc7_mode6`), FTEX, and
BLP1/BLP2 (PIL's palette files; JPEG, palette and DXT built here). The
builders (`bmp_file`, `tga_file`, `gif_file`, `tiff_file`,
`jpeg_sampled`, `vp8_frame`, `vp8l_palette`, `riff_webp`, `arith_jpeg`,
`jpeg_tiff`, `ojpeg_tiff`, `dds_file`, `ftex_file`, `blp_file` and their
encoders) serve the tests too. pil_rgb.json holds each file's shape and the SHA-256 of
`Image.open(f).convert("RGB")`'s bytes, with the Pillow, libjpeg-turbo and
libwebp versions that made them; the tests and chip_smoke.py's textures phase hold
the port's decoders to those hashes.
"""

from __future__ import annotations

import hashlib
import io
import json
import lzma
import pathlib
import struct
import sys
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


# --- BMP ---------------------------------------------------------------------

def bmp_file(width: int, height: int, bits: int, pixels: bytes, palette=None, compression=0,
             header=40, masks=None, top_down=False, colors=None) -> bytes:
    """A BMP of `pixels` (the stored rows, padded, bottom row first unless
    top_down; or an RLE stream), a palette of (r, g, b) entries, the given
    info-header size (12 for OS/2, 40-124) and bitfield masks."""
    entry = 3 if header == 12 else 4
    pal = b"".join(bytes([b, g, r, 0][:entry]) for r, g, b in (palette or ()))
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        ncolors = len(palette) if palette is not None and colors is None else colors or 0
        info = struct.pack("<IiiHHIIiiII", header, width, -height if top_down else height, 1,
                           bits, compression, len(pixels), 2835, 2835, ncolors, 0)
        if header > 40:
            info += struct.pack("<4I", *(list(masks or (0, 0, 0, 0)) + [0] * 4)[:4])
            info = info[:header].ljust(header, b"\0")
    extra = struct.pack("<3I", *masks[:3]) if header == 40 and compression == 3 else b""
    offset = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + info + extra
            + pal + pixels)


def bmp_rows(rows: np.ndarray, bits: int) -> bytes:
    """(h, w) indices or (h, w, k) bytes -> stored BMP rows, bottom first,
    each padded to 4 bytes."""
    h, w = rows.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    out = []
    for row in rows[::-1]:
        if bits < 8:
            bitsarr = (row[:, None] >> np.arange(bits - 1, -1, -1)) & 1
            data = np.packbits(bitsarr.astype(np.uint8).ravel()).tobytes()
        else:
            data = np.ascontiguousarray(row, np.uint8).tobytes()
        out.append(data.ljust(stride, b"\0"))
    return b"".join(out)


def bmp_rle(idx: np.ndarray, rle4: bool) -> bytes:
    """An RLE8 or RLE4 stream of an (h, w) index image, bottom row first:
    runs of equal pixels, absolute runs of 3 or more others (padded to a
    16-bit word), an end of line a row and an end of bitmap."""
    out = bytearray()
    for row in idx[::-1].tolist():
        x, w = 0, len(row)
        while x < w:
            n = 1
            if rle4:  # a run repeats a pair of nibbles
                while x + n < w and n < 255 and row[x + n] == row[x + (n % 2)]:
                    n += 1
            else:
                while x + n < w and n < 255 and row[x + n] == row[x]:
                    n += 1
            if n >= 2 or w - x < 3:
                pair = (row[x] << 4 | row[x + 1 if n > 1 else x]) if rle4 else row[x]
                out += bytes([n, pair])
                x += n
                continue
            n = 3
            while x + n < w and n < 64 and row[x + n] != row[x + n - 1]:
                n += 1
            vals = row[x:x + n]
            if rle4:
                vals = vals + [0] * (n % 2)
                data = bytes(vals[i] << 4 | vals[i + 1] for i in range(0, len(vals), 2))
            else:
                data = bytes(vals)
            out += bytes([0, n]) + data + b"\0" * (len(data) % 2)
            x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


# --- TGA ---------------------------------------------------------------------

def tga_file(width: int, height: int, kind: int, depth: int, body: bytes, flags: int = 0,
             cmap=None, id_text: bytes = b"") -> bytes:
    """A Targa file: image type `kind`, `depth` bits a pixel, the stored
    pixels `body`, a colour map (first index, entries as bytes, bits)."""
    spec, pal = bytes(5), b""
    if cmap is not None:
        start, entries, map_bits = cmap
        spec, pal = struct.pack("<HHB", start, len(entries), map_bits), b"".join(entries)
    return (bytes([len(id_text), cmap is not None, kind]) + spec
            + struct.pack("<4H", 0, 0, width, height) + bytes([depth, flags]) + id_text + pal
            + body)


def tga_packets(pixels: list, runs: list) -> bytes:
    """TGA RLE packets over a list of pixels (bytes each): `runs` gives each
    packet's (is_run, count) in turn; a literal packet may cross rows."""
    out, i = bytearray(), 0
    for is_run, n in runs:
        if is_run:
            out += bytes([0x80 | (n - 1)]) + pixels[i]
        else:
            out += bytes([n - 1]) + b"".join(pixels[i:i + n])
        i += n
    return bytes(out)


# --- GIF ---------------------------------------------------------------------

def lzw_gif(idx: bytes, min_size: int, clear_at_full: bool = True) -> bytes:
    """GIF LZW of `idx` (codes LSB first): a clear code first, then the
    width growing with the table; a full table clears, or with
    clear_at_full False goes on with no new entries (a deferred clear)."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    codes, cur = [], b""

    def reset():
        return {bytes([i]): i for i in range(clear)}, end + 1, min_size + 1

    table, nxt, size = reset()
    codes.append((clear, size))
    for v in idx:
        c = cur + bytes([v])
        if c in table:
            cur = c
            continue
        codes.append((table[cur], size))
        if nxt < 4096:
            table[c] = nxt
            nxt += 1
            if nxt - 1 == 1 << size and size < 12:
                size += 1
        elif clear_at_full:
            codes.append((clear, size))
            table, nxt, size = reset()
        cur = bytes([v])
    codes += [(table[cur], size), (end, size)]
    acc = nacc = 0
    out = bytearray()
    for code, width in codes:
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8
    return bytes(out + (bytes([acc]) if nacc else b""))


def gif_file(width: int, height: int, frames, palette: bytes = None) -> bytes:
    """A GIF89a of `frames`: each (x0, y0, w, h, local palette or None,
    interlaced, LZW minimum code size, LZW data, transparent index or
    None); palettes of 2**n (r, g, b) entries as bytes."""
    def bits(pal):
        return (len(pal) // 3).bit_length() - 2

    out = b"GIF89a" + struct.pack("<HH", width, height)
    out += bytes([0x80 | bits(palette), 0, 0]) + palette if palette else bytes(3)
    for x0, y0, w, h, local, interlaced, min_size, data, transparent in frames:
        if transparent is not None:
            out += b"\x21\xf9\x04" + bytes([1, 10, 0, transparent, 0])
        out += b"\x21\xfe\x07fixture\x00"  # a comment, skipped
        flags = (0x40 if interlaced else 0) | (0x80 | bits(local) if local else 0)
        out += b"," + struct.pack("<4HB", x0, y0, w, h, flags) + (local or b"")
        out += bytes([min_size]) + b"".join(
            bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255))
        out += b"\0"
    return out + b";"


# --- TIFF --------------------------------------------------------------------

def lzw_tiff(data: bytes) -> bytes:
    """TIFF LZW (libtiff's codes: MSB first, the width growing when the next
    entry is 512, 1024, 2048; a clear at the start and at 4094 entries)."""
    codes, cur = [], b""

    def reset():
        return {bytes([i]): i for i in range(256)}, 258, 9

    table, nxt, width = reset()
    codes.append((256, width))
    for v in data:
        c = cur + bytes([v])
        if c in table:
            cur = c
            continue
        codes.append((table[cur], width))
        table[c] = nxt
        nxt += 1
        if nxt >= 1 << width and width < 12:
            width += 1
        if nxt >= 4094:
            codes.append((256, width))
            table, nxt, width = reset()
        cur = bytes([v])
    if cur:
        codes.append((table[cur], width))
    codes.append((257, width))
    acc = nacc = 0
    out = bytearray()
    for code, w in codes:
        acc = (acc << w) | code
        nacc += w
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 255)
            nacc -= 8
    return bytes(out + (bytes([(acc << (8 - nacc)) & 255]) if nacc else b""))


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes, literals of up to 128 others."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1)]) + data[i:i + 1]
            i = j + 1
            continue
        k = i
        while k + 1 < n and data[k + 1] != data[k] and k - i < 127:
            k += 1
        out += bytes([k - i]) + data[i:k + 1]
        i = k + 1
    return bytes(out)


TIFF_CODECS = {1: lambda b: b, 5: lzw_tiff, 8: zlib.compress, 32946: zlib.compress,
               32773: packbits, 34925: lambda b: lzma.compress(b, format=lzma.FORMAT_XZ)}
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def tiff_file(samples: np.ndarray, bits: int, photo: int, comp: int = 1, planar: int = 1,
              tile=None, rows_per_strip=None, endian: str = "<", extra=(), colormap=None,
              predictor: int = 1, fill: int = 1, sample_format=None, orientation=None,
              codec=None, big: bool = False) -> bytes:
    """A one-page TIFF of (h, w, n) sample values at `bits` bits: strips of
    rows_per_strip rows or tiles of tile=(w, h), chunky or planar, any of
    TIFF_CODECS (or `codec`, compressing each strip or tile), horizontal
    differencing (predictor 2), fill order 2 (every stored byte's bits
    reversed), BigTIFF (`big`)."""
    h, w, n = samples.shape

    def rows_bytes(block):
        r, c, k = block.shape
        v = block.astype(np.int64)
        if predictor == 2:
            v = np.concatenate([v[:, :1], np.diff(v, axis=1)], 1) % (1 << bits)
        if bits >= 8:
            return v.astype(endian + f"u{bits // 8}").tobytes()
        bitsarr = (v.reshape(r, c * k)[..., None] >> np.arange(bits - 1, -1, -1)) & 1
        return b"".join(np.packbits(row.astype(np.uint8).ravel()).tobytes() for row in bitsarr)

    planes = [samples[..., i:i + 1] for i in range(n)] if planar == 2 else [samples]
    chunks = []
    for plane in planes:
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    block = np.zeros((th, tw, plane.shape[2]), samples.dtype)
                    part = plane[ty:ty + th, tx:tx + tw]
                    block[:part.shape[0], :part.shape[1]] = part
                    chunks.append(rows_bytes(block))
        else:
            for y in range(0, h, rows_per_strip or h):
                chunks.append(rows_bytes(plane[y:y + (rows_per_strip or h)]))
    stored = [(codec or TIFF_CODECS[comp])(c) for c in chunks]
    if fill == 2:
        stored = [_REVERSE[np.frombuffer(c, np.uint8)].tobytes() for c in stored]
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * n), (259, 3, [comp]),
            (262, 3, [photo]), (277, 3, [n]), (284, 3, [planar])]
    for tag, value in ((266, fill), (317, predictor)):
        if value != 1:
            tags.append((tag, 3, [value]))
    for tag, values in ((338, extra), (339, sample_format), (320, colormap)):
        if values:
            tags.append((tag, 3, list(values)))
    if orientation:
        tags.append((274, 3, [orientation]))
    return tiff_from_chunks(stored, h, tags, tile, rows_per_strip, endian, big)


def tiff_from_chunks(stored, height: int, tags, tile=None, rows_per_strip=None,
                     endian: str = "<", big: bool = False) -> bytes:
    """A one-page TIFF of the stored strips (of rows_per_strip rows, the
    whole height if None) or tiles (tile=(w, h)) and the tags, each (tag,
    type, values): 3 SHORT, 4 LONG, 7 UNDEFINED (values: bytes), 16 LONG8;
    the layout tags are added. BigTIFF (`big`): the 16-byte header, 8-byte
    counts and offsets, 20-byte entries, the layout's offsets as LONG8."""
    magic = (b"II+\0" if endian == "<" else b"MM\0+") if big else (
        b"II*\0" if endian == "<" else b"MM\0*")
    head = magic + (struct.pack(endian + "HHQ", 8, 0, 0) if big else bytes(4))
    body, offsets = bytearray(head), []
    for c in stored:
        offsets.append(len(body))
        body += c + b"\0" * (len(c) % 2)
    counts = [len(c) for c in stored]
    where = 16 if big else 4
    tags = list(tags) + ([(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, where, offsets),
                          (325, 4, counts)] if tile else
                         [(273, where, offsets), (278, 4, [rows_per_strip or height]),
                          (279, 4, counts)])
    inline, entry, count, at_fmt = (8, "HHQ", "Q", "Q") if big else (4, "HHL", "H", "L")
    entries = []
    for tag, kind, values in sorted(tags):
        raw = bytes(values) if kind == 7 else struct.pack(
            endian + {3: "H", 4: "L", 16: "Q"}[kind] * len(values), *values)
        if len(raw) > inline:
            at = len(body)
            body += raw + b"\0" * (len(raw) % 2)
            raw = struct.pack(endian + at_fmt, at)
        entries.append(struct.pack(endian + entry, tag, kind, len(values))
                       + raw.ljust(inline, b"\0"))
    at = len(body)
    body += struct.pack(endian + count, len(entries)) + b"".join(entries) + bytes(inline)
    if big:
        body[8:16] = struct.pack(endian + "Q", at)
    else:
        body[4:8] = struct.pack(endian + "L", at)
    return bytes(body)


def lzw_tiff_old(data: bytes) -> bytes:
    """Old-style (pre-TIFF 5.0 libtiff) LZW: codes LSB first, a clear
    first, the width growing as the reader's table reaches 512, 1024 and
    2048 entries, a clear before the table passes 4093."""
    out, acc, nbits = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    def width(emitted):  # the reader's width for the next code
        size = 258 + max(emitted - 1, 0)
        return 9 if size < 512 else 10 if size < 1024 else 11 if size < 2048 else 12

    table, emitted, w = {bytes([i]): i for i in range(256)}, 0, b""
    put(256, 9)
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w], width(emitted))
        emitted += 1
        table[wc] = 258 + len(table) - 256
        w = bytes([c])
        if 258 + emitted - 1 >= 4093:
            put(256, width(emitted))
            table, emitted = {bytes([i]): i for i in range(256)}, 0
    if w:
        put(table[w], width(emitted))
        emitted += 1
    put(257, width(emitted))
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def ccitt_tiff(bits: np.ndarray, comp: int, Image, t4: int = 0, fill: int = 1, photo: int = 0,
               rows_per_strip=None) -> bytes:
    """A bilevel TIFF of (h, w) bits (1 black) in CCITT RLE (2), Group 3
    (3, T4Options `t4`) or Group 4 (4), coded by libtiff through PIL, its
    strips put into a file of this module's with fill order `fill` (2:
    their bits reversed) and PhotometricInterpretation `photo`."""
    h, w = bits.shape
    ones = np.asarray(bits, bool) if photo == 0 else ~np.asarray(bits, bool)  # 1: a black run
    info = {278: rows_per_strip or h} | ({292: t4} if comp == 3 else {})
    buf = io.BytesIO()
    Image.fromarray(ones).convert("1").save(
        buf, "TIFF", compression={2: "tiff_ccitt", 3: "group3", 4: "group4"}[comp],
        tiffinfo=info)
    with Image.open(buf) as im:
        data = buf.getvalue()
        strips = [data[o:o + n] for o, n in zip(im.tag_v2[273], im.tag_v2[279])]
    if fill == 2:
        strips = [_REVERSE[np.frombuffer(c, np.uint8)].tobytes() for c in strips]
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [1]), (259, 3, [comp]), (262, 3, [photo]),
            (277, 3, [1])] + ([(266, 3, [2])] if fill == 2 else []) + (
        [(292, 4, [t4])] if comp == 3 and t4 else [])
    return tiff_from_chunks(strips, h, tags, rows_per_strip=rows_per_strip)


def ycbcr_tiff(ycc: np.ndarray, sub=(2, 2), comp: int = 5, tile=None, rows_per_strip=None,
               tag: bool = True) -> bytes:
    """A YCbCr TIFF (photometric 6) of (h, w, 3) samples in libtiff's
    subsampled layout: blocks of sub[0] x sub[1] luma in raster order,
    then the block's Cb and Cr (its first pixel's), each strip or tile
    padded to whole blocks; `tag` False leaves YCbCrSubsampling out (2x2
    for a reader)."""
    hs, vs = sub

    def blocks(part, rows, cols):
        pad = np.zeros((-(-rows // vs) * vs, -(-cols // hs) * hs, 3), np.uint8)
        pad[:part.shape[0], :part.shape[1]] = part
        bh, bw = pad.shape[0] // vs, pad.shape[1] // hs
        y = pad[..., 0].reshape(bh, vs, bw, hs).transpose(0, 2, 1, 3).reshape(bh, bw, vs * hs)
        return np.concatenate([y, pad[::vs, ::hs, 1:]], 2).tobytes()

    h, w = ycc.shape[:2]
    if tile:
        tw, th = tile
        chunks = [blocks(ycc[y:y + th, x:x + tw], th, tw) for y in range(0, h, th)
                  for x in range(0, w, tw)]
    else:
        step = rows_per_strip or h
        chunks = [blocks(ycc[y:y + step], min(step, h - y), w) for y in range(0, h, step)]
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]), (259, 3, [comp]),
            (262, 3, [6]), (277, 3, [3])] + ([(530, 3, list(sub))] if tag else [])
    return tiff_from_chunks([TIFF_CODECS[comp](c) for c in chunks], h, tags, tile,
                            rows_per_strip)


# --- JPEG --------------------------------------------------------------------

def jpeg_sampled(rng, width: int, height: int, sampling: bytes, quality: int = 75) -> bytes:
    """A baseline JFIF file of seeded coefficients whose Y, Cb, Cr sampling
    bytes are `sampling` (0xHV each; PIL writes none but 1 and 2)."""
    from relativitypathtracer_tpu_torch.utils import image

    hs, vs = [b >> 4 for b in sampling], [b & 15 for b in sampling]
    mcus = -(-width // (8 * max(hs))) * -(-height // (8 * max(vs)))
    comp = np.tile(np.repeat([0, 1, 2], [h * v for h, v in zip(hs, vs)]), mcus)
    coefs = np.zeros((comp.size, 64), np.int32)
    coefs[:, 0] = rng.integers(-60, 60, coefs.shape[0])
    coefs[:, 1:10] = rng.integers(-12, 12, (coefs.shape[0], 9))
    qy, qc = image.quant_tables(quality)
    dqt = b"".join(bytes([k]) + np.asarray(t)[image.ZIGZAG].astype(np.uint8).tobytes()
                   for k, t in enumerate((qy, qc)))
    sof = struct.pack(">BHHB", 8, height, width, 3) + bytes(
        [1, sampling[0], 0, 2, sampling[1], 1, 3, sampling[2], 1])
    dht = b"".join(bytes([tc_th]) + bytes(counts) + bytes(symbols) for tc_th, (counts, symbols)
                   in zip((0x00, 0x10, 0x01, 0x11), (image._DC_LUMA, image._AC_LUMA,
                                                     image._DC_CHROMA, image._AC_CHROMA)))
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (b"\xff\xd8" + image._segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + image._segment(0xDB, dqt) + image._segment(0xC0, sof) + image._segment(0xC4, dht)
            + image._segment(0xDA, sos) + image._entropy_code(coefs, comp) + b"\xff\xd9")


def jpeg_adobe(data: bytes, transform: int) -> bytes:
    """A JPEG with its APP0 (JFIF) segment, if any, replaced by an Adobe
    APP14 segment of `transform` (0: RGB or CMYK, 1: YCbCr, 2: YCCK), or
    its APP14's transform set."""
    i = data.find(b"\xff\xee")
    if i >= 0:
        return data[:i + 15] + bytes([transform]) + data[i + 16:]
    j = data.index(b"\xff\xe0")
    end = j + 2 + int.from_bytes(data[j + 2:j + 4], "big")
    app14 = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([transform])
    return data[:j] + app14 + data[end:]


def new_formats(rng, Image) -> dict:
    """The fixtures of the PNM family, BMP, TGA, GIF, TIFF and the JPEG
    kinds, by file name."""
    from relativitypathtracer_tpu_torch.utils.demo_scene import demo_texture

    def save(im, fmt, **kw):
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        return buf.getvalue()

    files = {}
    pic = Image.fromarray(_picture(rng, 14, 20))
    # PNM: PIL's P4, P5 (16-bit) and P6; plain P2/P3 with comments and odd maxvals
    files["bitmap.pbm"] = save(Image.fromarray(_picture(rng, 20, 30)).convert("1"), "PPM")
    files["grey16.pgm"] = save(Image.fromarray(rng.integers(0, 600, (12, 16)).astype(np.uint16)),
                               "PPM")
    v = rng.integers(0, 101, (10, 12, 3))
    files["maxval100.ppm"] = b"P6\n# maxval 100\n12 10\n100\n" + v.astype(np.uint8).tobytes()
    v = rng.integers(0, 1001, (9, 11))
    files["plain.pgm"] = (b"P2\n# plain, maxval 1000\n11 9\n1000\n" + b"\n".join(
        b" ".join(b"%d" % x for x in row) for row in v) + b"\n")
    v = rng.integers(0, 8, (6, 7, 3))
    files["plain.ppm"] = (b"P3 7 6 7\n" + b" # a comment\n".join(
        b" ".join(b"%d" % x for x in row) for row in v.reshape(6, -1)) + b"\n")
    # BMP: PIL's 8-bit palette and 24-bit; RLE8, RLE4, 5-6-5 bitfields, OS/2, top-down V5
    files["palette8.bmp"] = save(pic.quantize(20), "BMP")
    files["rgb24.bmp"] = save(pic, "BMP")
    idx = (np.add.outer(np.arange(18) // 3, np.arange(26) // 4) % 7).astype(np.uint8)
    idx[::5, ::3] = rng.integers(0, 16, idx[::5, ::3].shape)
    pal16 = [tuple(int(c) for c in rng.integers(0, 256, 3)) for _ in range(16)]
    files["rle8.bmp"] = bmp_file(26, 18, 8, bmp_rle(idx, False), pal16, compression=1)
    files["rle4.bmp"] = bmp_file(26, 18, 4, bmp_rle(idx, True), pal16, compression=2)
    px = rng.integers(0, 65536, (10, 13)).astype("<u2")
    files["bitfields565.bmp"] = bmp_file(13, 10, 16, bmp_rows(px.view(np.uint8).reshape(10, 13, 2),
                                                             16), compression=3, header=56,
                                         masks=(0xF800, 0x7E0, 0x1F, 0))
    rgb = _picture(rng, 9, 15)
    files["os2.bmp"] = bmp_file(15, 9, 24, bmp_rows(rgb[..., ::-1], 24), header=12)
    bgra = np.concatenate([_picture(rng, 12, 16)[..., ::-1], np.full((12, 16, 1), 255)], 2)
    files["topdown32.bmp"] = bmp_file(16, 12, 32, bmp_rows(bgra[::-1].astype(np.uint8), 32),
                                      header=124, top_down=True)
    # TGA: the textured fixture's 32x32 texture RLE-coded by PIL (bottom-up);
    # top-left grey, a 16-bit colour map, RLE packets across rows
    files["blob_rle.tga"] = save(Image.fromarray(demo_texture(32)), "TGA", rle=True)
    files["grey_topleft.tga"] = save(pic.convert("L"), "TGA", orientation=1)
    entries = [struct.pack("<H", int(x)) for x in rng.integers(0, 65536, 24)]
    files["cmap16.tga"] = tga_file(14, 9, 1, 8, rng.integers(0, 28, 14 * 9).astype(np.uint8)
                                   .tobytes(), 0x20, cmap=(4, entries, 16), id_text=b"cmap16")
    pixels = [bytes(rng.integers(0, 256, 3).astype(np.uint8)) for _ in range(11 * 6)]
    for i in range(5, 20):  # a run of one colour
        pixels[i] = pixels[5]
    runs = [(False, 5), (True, 6), (True, 9), (False, 24), (True, 9), (False, 13)]
    files["rle_rows.tga"] = tga_file(11, 6, 10, 24, tga_packets(pixels, runs), 0x10)
    # GIF: PIL's interlaced with transparency; a local palette on a smaller frame
    files["interlaced.gif"] = save(Image.fromarray(_picture(rng, 24, 20)).quantize(12), "GIF",
                                   transparency=3)
    sub = rng.integers(0, 16, 9 * 12).astype(np.uint8)
    sub[:40] //= 8
    pal = rng.integers(0, 256, 48).astype(np.uint8).tobytes()
    files["local_palette.gif"] = gif_file(20, 14, [(5, 3, 12, 9, pal, True, 4, lzw_gif(sub, 4), 2)],
                                          rng.integers(0, 256, 12).astype(np.uint8).tobytes())
    # TIFF: the cubes fixture's texture (64x64, LZW with predictor 2, K8's
    # windowed atlas); planar tiles in PackBits; big-endian 16-bit RGB in
    # Deflate; palette at fill order 2; CMYK; min-is-white bilevel
    square = (np.add.outer(np.arange(64) // 8 * 3, np.arange(64) // 8 * 5) % 6)
    colours = rng.integers(30, 225, (6, 3)).astype(np.uint8)
    files["cubes_lzw.tif"] = save(Image.fromarray(colours[square]), "TIFF",
                                  compression="tiff_lzw", tiffinfo={317: 2})
    files["planar_tiles.tif"] = tiff_file(_picture(rng, 20, 21), 8, 2, comp=32773, planar=2,
                                          tile=(16, 16))
    files["rgb16_be.tif"] = tiff_file(rng.integers(0, 65536, (9, 13, 3)).astype(np.uint16), 16, 2,
                                      comp=8, endian=">", rows_per_strip=4)
    cmap = rng.integers(0, 65536, 48).tolist()
    files["palette4_fill2.tif"] = tiff_file(rng.integers(0, 16, (10, 17, 1)), 4, 3, comp=5,
                                            fill=2, colormap=cmap)
    files["cmyk.tif"] = save(Image.fromarray(rng.integers(0, 256, (10, 14, 4)).astype(np.uint8),
                                             "CMYK"), "TIFF")
    files["minwhite.tif"] = tiff_file(rng.integers(0, 2, (11, 19, 1)), 1, 0, rows_per_strip=3)
    # JPEG: CMYK (Adobe, inverted), YCCK, Adobe RGB, luma sampled 3x1
    cmyk = Image.fromarray(rng.integers(0, 256, (16, 24, 4)).astype(np.uint8), "CMYK")
    files["cmyk.jpg"] = save(cmyk, "JPEG", quality=80)
    files["ycck.jpg"] = jpeg_adobe(files["cmyk.jpg"], 2)
    files["adobe_rgb.jpg"] = jpeg_adobe(save(pic, "JPEG", quality=85, subsampling="4:4:4"), 0)
    files["s31.jpg"] = jpeg_sampled(rng, 37, 21, b"\x31\x11\x11")
    return files


# --- WebP --------------------------------------------------------------------

def riff_webp(chunks) -> bytes:
    """A RIFF WEBP file of (fourcc, payload) chunks, each padded to even."""
    body = b"".join(fourcc + struct.pack("<I", len(p)) + p + b"\0" * (len(p) & 1)
                    for fourcc, p in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def vp8x(flags: int, width: int, height: int) -> tuple:
    """A VP8X chunk: flags (0x10 alpha, 0x02 animation) and the canvas."""
    return b"VP8X", bytes([flags, 0, 0, 0]) + (width - 1).to_bytes(3, "little") + (
        height - 1).to_bytes(3, "little")


def anmf(x: int, y: int, width: int, height: int, chunks, duration: int = 100,
         flags: int = 0) -> tuple:
    """An ANMF chunk: a frame at (x, y) (even), its size, and its
    sub-chunks (ALPH, VP8 or VP8L) as (fourcc, payload)."""
    head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, width - 1, height - 1,
                                                      duration)) + bytes([flags])
    return b"ANMF", head + b"".join(f + struct.pack("<I", len(p)) + p + b"\0" * (len(p) & 1)
                                    for f, p in chunks)


def webp_chunks(data: bytes) -> list:
    """The (fourcc, payload) chunks of a RIFF WEBP file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = int.from_bytes(data[pos + 4:pos + 8], "little")
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def alph_raw(alpha: np.ndarray, filt: int) -> bytes:
    """An ALPH chunk's payload, uncompressed (method 0), the (h, w) uint8
    plane under filter `filt` (0 none, 1 horizontal, 2 vertical, 3
    gradient; row 0 from the left, its first value from 0, a row's first
    value from the one above)."""
    a = alpha.astype(np.int64)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    if filt:
        pred[1:, 0] = a[:-1, 0]
        if filt == 1:
            pred[1:, 1:] = a[1:, :-1]
        elif filt == 2:
            pred[1:, 1:] = a[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    else:
        pred[:] = 0
    return bytes([filt << 2]) + ((a - pred) & 255).astype(np.uint8).tobytes()


class BoolWriter:
    """VP8's boolean entropy encoder (RFC 6386 section 7.3)."""

    def __init__(self):
        self.out, self.range, self.bottom, self.count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if self.count == 0:
                self.out.append(self.bottom >> 24)
                self.bottom &= 0xFFFFFF
                self.count = 8

    def literal(self, value: int, bits: int) -> None:
        for k in range(bits - 1, -1, -1):
            self.put((value >> k) & 1, 128)

    def signed(self, value: int, bits: int) -> None:
        self.literal(abs(value), bits)
        self.put(int(value < 0), 128)

    def flush(self) -> bytes:
        c, v = self.count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _tree_path(tree, leaf: int) -> list:
    """(node, bit) pairs from the root to `leaf` in a VP8 tree array."""
    def walk(i, path):
        for bit in (0, 1):
            nxt = tree[i + bit]
            here = path + [(i // 2, bit)]
            if nxt <= 0 and -nxt == leaf:
                return here
            if nxt > 0:
                found = walk(2 * nxt, here)
                if found:
                    return found
        return None
    return walk(0, [])


def vp8_frame(rng, width: int, height: int, *, simple: bool = False, level: int = 20,
              sharpness: int = 0, partitions: int = 1, segments=None, deltas=None,
              base_q: int = 30, qdeltas=(0, 0, 0, 0, 0), skip_prob=None, i4_share: float = 0.5,
              density: float = 0.3, updates: int = 6) -> bytes:
    """A VP8 key frame (a "VP8 " chunk's payload) of seeded macroblocks:
    random segments, skip flags, 16x16 / 4x4 / chroma modes and sparse
    coefficients (runs of zeros, every token size up to category 6, each
    value times its quantiser within +-2047) under the given header: the
    simple or normal loop filter, its level and sharpness, 1-8 token
    partitions, segmentation (dict: absolute, quant, filter, probs) with
    per-segment quantiser and filter levels, loop-filter deltas ((ref,
    mode), 4 each), the base quantiser and its 5 deltas, the skip
    probability, and `updates` coefficient probabilities updated."""
    from relativitypathtracer_tpu_torch.utils import webp_lossy as wl

    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    head = BoolWriter()
    head.put(0, 128)  # colour space
    head.put(0, 128)  # clamping type
    head.put(segments is not None, 128)
    if segments is not None:
        head.put(1, 128)  # update the map
        head.put(1, 128)  # update the data
        head.put(segments["absolute"], 128)
        for v, bits in [(q, 7) for q in segments["quant"]] + [(f, 6) for f in segments["filter"]]:
            head.put(1, 128)
            head.signed(v, bits)
        for p in segments["probs"]:
            head.put(1, 128)
            head.literal(p, 8)
    head.put(simple, 128)
    head.literal(level, 6)
    head.literal(sharpness, 3)
    head.put(deltas is not None, 128)
    if deltas is not None:
        head.put(1, 128)
        for d in list(deltas[0]) + list(deltas[1]):
            head.put(d != 0, 128)
            if d:
                head.signed(d, 6)
    head.literal(partitions.bit_length() - 1, 2)
    head.literal(base_q, 7)
    for d in qdeltas:
        head.put(d != 0, 128)
        if d:
            head.signed(d, 4)
    head.put(0, 128)  # refresh_entropy_probs
    probs = bytearray(wl._COEF_PROBS)
    changed = set(rng.choice(len(probs), updates, replace=False).tolist())
    for i in range(len(probs)):
        if i in changed:
            head.put(1, wl._COEF_UPDATE[i])
            probs[i] = int(rng.integers(1, 256))
            head.literal(probs[i], 8)
        else:
            head.put(0, wl._COEF_UPDATE[i])
    head.put(skip_prob is not None, 128)
    if skip_prob is not None:
        head.literal(skip_prob, 8)
    def at(t, n, c):  # the 11 probabilities of type t, position n, context c
        i = ((t * 8 + wl._BANDS[n]) * 3 + c) * 11
        return probs[i:i + 11]
    band = [[[at(t, n, c) for c in range(3)] for n in range(17)] for t in range(4)]
    def quant(s):  # the segment's dequantisation factors, to bound the values
        q = base_q if segments is None else segments["quant"][s] + (
            0 if segments["absolute"] else base_q)
        return wl.dequant(q, qdeltas)

    def tokens(w, block, t, ctx, first):
        """Code `block` (16 levels in zig-zag order) as GetCoeffs reads
        them; returns the position it stops at."""
        nz = [n for n in range(first, 16) if block[n]]
        last = nz[-1] if nz else -1
        n = first
        p = band[t][n][ctx]
        while n < 16:
            if n > last:
                w.put(0, p[0])
                return n
            w.put(1, p[0])
            while block[n] == 0:
                w.put(0, p[1])
                n += 1
                p = band[t][n][0]
            w.put(1, p[1])
            v = abs(block[n])
            if v == 1:
                w.put(0, p[2])
                nxt = 1
            else:
                w.put(1, p[2])
                nxt = 2
                if v <= 4:
                    w.put(0, p[3])
                    w.put(v > 2, p[4])
                    if v > 2:
                        w.put(v - 3, p[5])
                elif v <= 10:
                    w.put(1, p[3])
                    w.put(0, p[6])
                    w.put(v > 6, p[7])
                    if v <= 6:
                        w.put(v - 5, 159)
                    else:
                        w.put((v - 7) >> 1, 165)
                        w.put((v - 7) & 1, 145)
                else:
                    w.put(1, p[3])
                    w.put(1, p[6])
                    cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
                    w.put(cat >> 1, p[8])
                    w.put(cat & 1, p[9 + (cat >> 1)])
                    extra = v - 3 - (8 << cat)
                    cats = wl._CATS[cat]
                    for k, prob in enumerate(cats):
                        w.put((extra >> (len(cats) - 1 - k)) & 1, prob)
            w.put(int(block[n] < 0), 128)
            n += 1
            p = band[t][n][nxt]
        return 16

    def levels(first, dq_dc, dq_ac):
        block = [0] * 16
        for n in range(first, 16):
            if rng.random() < density * (1.2 - n / 16):
                dq = dq_ac if n else dq_dc
                top = max(1, 2047 // dq)
                size = (1, 2, 3, 5, 8, 15, 30, 60, 200, 2114)[int(rng.integers(0, 10))]
                block[n] = int(rng.integers(1, min(size, top) + 1)) * int(rng.choice([-1, 1]))
        return block

    parts = [BoolWriter() for _ in range(partitions)]
    seg_probs = segments["probs"] if segments else None
    top_modes = [wl.DC] * (4 * mb_w)
    nz_top, nz_dc_top = [0] * mb_w, [0] * mb_w
    for my in range(mb_h):
        left_modes = [wl.DC] * 4
        nz_left = nz_dc_left = 0
        tw = parts[my % partitions]
        for mx in range(mb_w):
            seg = int(rng.integers(0, 4)) if segments else 0
            if segments:
                head.put(seg >= 2, seg_probs[0])
                head.put(seg & 1, seg_probs[1 + (seg >= 2)])
            skip = skip_prob is not None and rng.random() < 0.2
            if skip_prob is not None:
                head.put(int(skip), skip_prob)
            i4 = rng.random() < i4_share
            head.put(int(not i4), 145)
            if not i4:
                mode = int(rng.choice([wl.DC, wl.VE, wl.HE, wl.TM]))
                head.put(mode in (wl.TM, wl.HE), 156)
                head.put(mode in (wl.TM, wl.VE), 128 if mode in (wl.TM, wl.HE) else 163)
                top_modes[4 * mx:4 * mx + 4] = [mode] * 4
                left_modes = [mode] * 4
            else:
                for y in range(4):
                    for x in range(4):
                        mode = int(rng.integers(0, 10))
                        base = (top_modes[4 * mx + x] * 10 + left_modes[y]) * 9
                        for node, bit in _tree_path(wl._BMODE_TREE, mode):
                            head.put(bit, wl._BMODE_PROBS[base + node])
                        top_modes[4 * mx + x] = left_modes[y] = mode
            uv = int(rng.choice([wl.DC, wl.VE, wl.HE, wl.TM]))
            head.put(uv != wl.DC, 142)
            if uv != wl.DC:
                head.put(uv != wl.VE, 114)
                if uv != wl.VE:
                    head.put(uv == wl.TM, 183)
            if skip:
                nz_top[mx] = nz_left = 0
                if not i4:
                    nz_dc_top[mx] = nz_dc_left = 0
                continue
            y1dc, y1ac, y2dc, y2ac, uvdc, uvac = quant(seg)
            if not i4:
                nz = tokens(tw, levels(0, y2dc, y2ac), 1, nz_dc_top[mx] + nz_dc_left, 0)
                nz_dc_top[mx] = nz_dc_left = int(nz > 0)
                first, t = 1, 0
            else:
                first, t = 0, 3
            tnz, lnz = nz_top[mx] & 15, nz_left & 15
            for y in range(4):
                left = lnz & 1
                for x in range(4):
                    nz = tokens(tw, levels(first, y1dc, y1ac), t, left + (tnz & 1), first)
                    left = int(nz > first)
                    tnz = (tnz >> 1) | (left << 7)
                tnz >>= 4
                lnz = (lnz >> 1) | (left << 7)
            out_t, out_l = tnz, lnz >> 4
            for ch in (0, 2):
                tnz, lnz = nz_top[mx] >> (4 + ch), nz_left >> (4 + ch)
                for y in range(2):
                    left = lnz & 1
                    for x in range(2):
                        nz = tokens(tw, levels(0, uvdc, uvac), 2, left + (tnz & 1), 0)
                        left = int(nz > 0)
                        tnz = (tnz >> 1) | (left << 3)
                    tnz >>= 2
                    lnz = (lnz >> 1) | (left << 5)
                out_t |= (tnz << 4) << ch
                out_l |= (lnz & 0xF0) << ch
            nz_top[mx], nz_left = out_t, out_l
    first_part = head.flush()
    streams = [p.flush() for p in parts]
    tag = (1 << 4) | (len(first_part) << 5)  # a key frame, version 0, shown
    return (tag.to_bytes(3, "little") + b"\x9d\x01\x2a" + struct.pack("<HH", width, height)
            + first_part + b"".join(len(s).to_bytes(3, "little") for s in streams[:-1])
            + b"".join(streams))


class LsbWriter:
    """VP8L's bit writer: values least significant bit first, prefix
    codes first bit first."""

    def __init__(self):
        self.acc, self.n = 0, 0

    def bits(self, value: int, count: int) -> None:
        self.acc |= value << self.n
        self.n += count

    def code(self, code: int, length: int) -> None:
        for k in range(length - 1, -1, -1):
            self.bits((code >> k) & 1, 1)

    def done(self) -> bytes:
        return self.acc.to_bytes((self.n + 7) // 8, "little")


# a code-length code over 0, 8, 16 (repeat the last length 3-6 times), 17
# (3-10 zeros) and 18 (11-138 zeros): their lengths, and canonical codes
_CL_LENGTHS = {8: 2, 16: 2, 18: 2, 0: 3, 17: 3}
_CL_CODES = {8: 0b00, 16: 0b01, 18: 0b10, 0: 0b110, 17: 0b111}
_CL_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def vp8l_all_8(w: LsbWriter, alphabet: int, max_symbol: bool = False) -> None:
    """A normal prefix code giving each of symbols 0-255 length 8 (so a
    symbol's code is itself), the rest none: its code lengths through the
    code-length code with repeat codes 16, 17 and 18; with `max_symbol`,
    the count of code-length symbols read is given and the zeros past 255
    are not coded."""
    w.bits(0, 1)
    w.bits(12 - 4, 4)  # code-length code lengths for the first 12 of the order
    for s in _CL_ORDER[:12]:
        w.bits(_CL_LENGTHS.get(s, 0), 3)
    toks = [(8, None)]
    left = 255
    while left:
        n = min(6, left) if left - min(6, left) not in (1, 2) else left - 3
        toks.append((16, n - 3))
        left -= n
    zeros = alphabet - 256
    if not max_symbol:
        while zeros:
            n = min(138, zeros)
            toks.append((18, n - 11) if n >= 11 else (17, n - 3) if n >= 3 else (0, None))
            zeros -= n if n >= 3 else 1
    w.bits(int(max_symbol), 1)
    if max_symbol:
        w.bits(3, 3)  # length_nbits 2 + 2 * 3
        w.bits(len(toks) - 2, 8)
    for sym, extra in toks:
        w.code(_CL_CODES[sym], _CL_LENGTHS[sym])
        if extra is not None:
            w.bits(extra, {16: 2, 17: 3, 18: 7}[sym])


def vp8l_simple_code(w: LsbWriter, symbols) -> None:
    """A simple prefix code of one or two symbols (the first in 1 bit when
    it is 0 or 1, else 8)."""
    w.bits(1, 1)
    w.bits(len(symbols) - 1, 1)
    short = symbols[0] < 2
    w.bits(0 if short else 1, 1)
    w.bits(symbols[0], 1 if short else 8)
    if len(symbols) == 2:
        w.bits(symbols[1], 8)


def vp8l_palette(rng, width: int, height: int, colours: int) -> bytes:
    """A VP8L bitstream of seeded indices into a seeded palette of
    `colours` (1-256) ARGB entries, through the colour-indexing transform:
    2, 4, 16 or 256 colours bundle 8, 4, 2 or 1 indices a pixel; the
    palette coded as deltas with all-8-bit codes, the bundled image's
    green the same, red, blue and alpha one-symbol simple codes."""
    w = LsbWriter()
    w.bits(0x2F, 8)
    w.bits(width - 1, 14)
    w.bits(height - 1, 14)
    w.bits(1, 1)
    w.bits(0, 3)
    w.bits(1, 1)  # a transform:
    w.bits(3, 2)  # colour indexing
    w.bits(colours - 1, 8)
    pal = rng.integers(0, 256, (colours, 4))
    delta = (pal - np.concatenate([np.zeros((1, 4), np.int64), pal[:-1]])) & 255
    w.bits(0, 1)  # no colour cache
    for alphabet in (280, 256, 256, 256):
        vp8l_all_8(w, alphabet, max_symbol=alphabet == 280)
    vp8l_simple_code(w, [0])
    for a, r, g, b in delta.tolist():
        w.code(g, 8)
        w.code(r, 8)
        w.code(b, 8)
        w.code(a, 8)
    w.bits(0, 1)  # no more transforms
    bits = 0 if colours > 16 else 1 if colours > 4 else 2 if colours > 2 else 3
    idx = rng.integers(0, colours, (height, width))
    per = 8 >> bits
    packed_w = -(-width // (1 << bits))
    padded = np.zeros((height, packed_w << bits), np.int64)
    padded[:, :width] = idx
    packed = (padded.reshape(height, packed_w, 1 << bits) << (np.arange(1 << bits) * per)).sum(2)
    w.bits(0, 1)  # no colour cache
    w.bits(0, 1)  # no meta prefix codes
    vp8l_all_8(w, 280)
    vp8l_simple_code(w, [0])
    vp8l_simple_code(w, [0])
    vp8l_simple_code(w, [255])
    vp8l_simple_code(w, [0])
    for g in packed.ravel().tolist():
        w.code(g, 8)
    return w.done()


def vp8l_simple(rng, width: int, height: int) -> bytes:
    """A VP8L bitstream of simple prefix codes only: green and blue of two
    symbols (one bit a pixel), red and alpha of one (none), no transform,
    no distance ever used."""
    w = LsbWriter()
    w.bits(0x2F, 8)
    w.bits(width - 1, 14)
    w.bits(height - 1, 14)
    w.bits(0, 1)
    w.bits(0, 3)
    w.bits(0, 1)  # no transform
    w.bits(0, 1)  # no colour cache
    w.bits(0, 1)  # no meta prefix codes
    greens, blues = sorted(rng.choice(256, 2, replace=False).tolist()), [1, 230]
    vp8l_simple_code(w, greens)
    vp8l_simple_code(w, [int(rng.integers(2, 256))])
    vp8l_simple_code(w, blues)
    vp8l_simple_code(w, [200])
    vp8l_simple_code(w, [1])
    for g, b in rng.integers(0, 2, (width * height, 2)).tolist():
        w.bits(g, 1)
        w.bits(b, 1)
    return w.done()


def webp_fixtures(rng, Image) -> dict:
    """WebP files: PIL's lossless (with and without `exact`, with alpha),
    lossy at several qualities and methods and odd sizes, lossy with alpha
    at several alpha qualities; a two-frame animation whose first frame is
    smaller than the canvas; and what PIL's encoder never writes: VP8
    frames with the simple filter, sharpness, 4 and 8 partitions,
    segmentation with per-segment quantiser and filter levels and
    loop-filter deltas (one in VP8X with an uncompressed, gradient-filtered
    ALPH chunk), VP8L with simple codes only and colour-indexed at every
    bundling width. The textured and cubes scenes' textures of
    chip_smoke.py's textures phase: the 32x32 demo texture lossy, the
    cubes' 64x64 squares lossless."""
    from relativitypathtracer_tpu_torch.utils.demo_scene import demo_texture

    def save(im, **kw):
        buf = io.BytesIO()
        im.save(buf, "WEBP", **kw)
        return buf.getvalue()

    def rgba(h, w):
        a = rng.integers(0, 256, (h, w, 1)).astype(np.uint8)
        a[::3, ::2] = 0
        return Image.fromarray(np.concatenate([_picture(rng, h, w), a], 2), "RGBA")

    files = {}
    files["lossless.webp"] = save(Image.fromarray(_picture(rng, 19, 23)), lossless=True)
    files["lossless_alpha.webp"] = save(rgba(15, 17), lossless=True, quality=100, method=6)
    files["lossless_exact.webp"] = save(rgba(13, 11), lossless=True, exact=True, quality=30,
                                        method=1)
    files["lossy_q80.webp"] = save(Image.fromarray(_picture(rng, 21, 37)), quality=80)
    files["lossy_q20_m6.webp"] = save(Image.fromarray(_picture(rng, 33, 17)), quality=20,
                                      method=6)
    files["lossy_q95_m0.webp"] = save(Image.fromarray(_picture(rng, 9, 30)), quality=95,
                                      method=0)
    files["lossy_alpha.webp"] = save(rgba(18, 25), quality=70, alpha_quality=40)
    files["lossy_alpha_q100.webp"] = save(rgba(11, 21), quality=60, alpha_quality=100,
                                          method=5)
    # an animation: frame 1 (lossy, 20x14) at (6, 4) on a 40x30 canvas, frame 2
    # (lossless) at (0, 0)
    first = webp_chunks(save(Image.fromarray(_picture(rng, 14, 20)), quality=75))
    second = webp_chunks(save(Image.fromarray(_picture(rng, 30, 40)), lossless=True))
    files["animated.webp"] = riff_webp([
        vp8x(0x02, 40, 30), (b"ANIM", bytes([10, 20, 30, 255, 0, 0])),
        anmf(6, 4, 20, 14, [c for c in first if c[0] == b"VP8 "]),
        anmf(0, 0, 40, 30, [c for c in second if c[0] == b"VP8L"], flags=2)])
    seg = {"absolute": 0, "quant": [-10, 0, 12, 25], "filter": [-8, 0, 9, 30],
           "probs": [120, 60, 200]}
    files["vp8_simple.webp"] = riff_webp([(b"VP8 ", vp8_frame(
        rng, 37, 45, simple=True, level=24, sharpness=3, partitions=4, segments=seg,
        deltas=((3, -2, 1, 0), (-4, 0, 2, 5)), base_q=20, qdeltas=(2, -3, 4, -2, 1),
        skip_prob=180))])
    seg = {"absolute": 1, "quant": [5, 40, 70, 110], "filter": [0, 12, 33, 63],
           "probs": [90, 160, 30]}
    alpha = rng.integers(0, 256, (120, 7)).astype(np.uint8)
    files["vp8_normal8_alpha.webp"] = riff_webp([
        vp8x(0x10, 7, 120), (b"ALPH", alph_raw(alpha, 3)),
        (b"VP8 ", vp8_frame(rng, 7, 120, level=40, sharpness=6, partitions=8, segments=seg,
                            deltas=((-6, 0, 0, 0), (9, 0, 0, 0)), base_q=12,
                            density=0.15, i4_share=0.7))])
    files["vp8l_simple.webp"] = riff_webp([(b"VP8L", vp8l_simple(rng, 23, 14))])
    for colours in (2, 4, 16, 256):
        files[f"vp8l_palette{colours}.webp"] = riff_webp([
            (b"VP8L", vp8l_palette(rng, 17 if colours < 256 else 9, 7, colours))])
    files["blob_lossy.webp"] = save(Image.fromarray(demo_texture(32)), quality=85)
    square = (np.add.outer(np.arange(64) // 8 * 3, np.arange(64) // 8 * 5) % 6)
    colours = rng.integers(30, 225, (6, 3)).astype(np.uint8)
    files["cubes_lossless.webp"] = save(Image.fromarray(colours[square]), lossless=True)
    return files


def jpeg_scans(data: bytes, keep) -> bytes:
    """A progressive JPEG with only the scans numbered in `keep` (from 0),
    each with the DHT segments before it, then EOI: coefficient bits left
    unsent, which libjpeg block-smooths."""
    pos, head, units, pending = 2, None, [], b""
    while data[pos + 1] != 0xD9:
        marker = data[pos + 1]
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker == 0xDA:  # the scan's data runs to the next marker but RSTn
            while not (data[end] == 0xFF and data[end + 1] != 0
                       and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
            if head is None:
                head, pending = data[:pos], b""
            units.append(pending + data[pos:end])
            pending = b""
        else:
            pending += data[pos:end]
        pos = end
    return head + b"".join(u for k, u in enumerate(units) if k in keep) + b"\xff\xd9"


def smoothed_jpegs(rng, Image) -> dict:
    """Progressive JPEGs written by PIL (libjpeg's default scan script)
    with scans left out: 4:2:0 with its DC scan only (DC at Al 1, never
    refined), 4:4:4 after its first three scans, 4:2:0 with every chroma
    AC scan gone, greyscale after its first two scans."""
    def save(im, **kw):
        buf = io.BytesIO()
        im.save(buf, "JPEG", progressive=True, **kw)
        return buf.getvalue()

    files = {}
    files["prog_dc_only.jpg"] = jpeg_scans(save(Image.fromarray(_picture(rng, 30, 44)),
                                                quality=85), {0})
    files["prog_first3.jpg"] = jpeg_scans(save(Image.fromarray(_picture(rng, 21, 27)),
                                               quality=70, subsampling="4:4:4"), {0, 1, 2})
    files["prog_no_chroma_ac.jpg"] = jpeg_scans(save(Image.fromarray(_picture(rng, 26, 35)),
                                                     quality=90), {0, 1, 4, 5, 6, 9})
    files["prog_grey_first2.jpg"] = jpeg_scans(save(Image.fromarray(_picture(rng, 17, 40))
                                                    .convert("L"), quality=75), {0, 1})
    return files


# --- arithmetic-coded JPEG ------------------------------------------------------

class QMEncoder:
    """libjpeg's arithmetic (QM) encoder, jcarith.c arith_encode and
    finish_pass: registers C and A, the bit counter CT, the byte held back
    for a carry, the stacked 0xFF bytes (SC) and the pending zero bytes
    (ZC) that the end of a segment may drop."""

    def __init__(self):
        from relativitypathtracer_tpu_torch.utils.jpeg_arith import QE

        self.qe, self.out = QE, bytearray()
        self.reset()

    def reset(self) -> None:
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _zeros(self) -> None:
        self.out += bytes(self.zc)
        self.zc = 0

    def _put(self, byte: int) -> None:
        self.out.append(byte)
        if byte == 0xFF:
            self.out.append(0)

    def _settle(self, temp: int) -> None:
        """A byte that can no longer carry: write the held byte and the
        stacked 0xFFs."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self.out.append(self.buffer)
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0
        self.buffer = temp

    def _carry(self) -> None:
        if self.buffer >= 0:
            self._zeros()
            self._put(self.buffer + 1)
        self.zc += self.sc  # the stacked 0xFFs carry over into 0x00s
        self.sc = 0

    def __call__(self, st: bytearray, i: int, val: int) -> None:
        """Code decision `val` in statistics bin st[i]."""
        sv = st[i]
        qe, lps, mps = self.qe[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the LPS
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ lps
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ mps
        while True:  # renormalise, a byte out each 8 bits
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._settle(temp)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                return

    def finish(self) -> None:
        """The end of a segment: the value of the interval with the most
        trailing zeros, its final bytes unless they are zeros."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._settle(self.buffer)
            self.buffer = -1
        if self.c & 0x7FFF800:
            self._zeros()
            self._put((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._put((self.c >> 11) & 0xFF)


def _encode_dc(enc, st, s: int, v: int, lo: int, hi: int) -> int:
    """jcarith.c's DC difference v from context bin s; returns the next
    context."""
    if v == 0:
        enc(st, s, 0)
        return 0
    enc(st, s, 1)
    sign = int(v < 0)
    v = abs(v) - 1
    enc(st, s + 1, sign)
    i, ctx, m = s + 2 + sign, 4 + 4 * sign, 0
    if v:
        enc(st, i, 1)
        m, v2, i = 1, v >> 1, 20
        while v2:
            enc(st, i, 1)
            m, v2, i = m << 1, v2 >> 1, i + 1
    enc(st, i, 0)
    ctx = 0 if m < lo else ctx + 8 if m > hi else ctx
    m >>= 1
    while m:
        enc(st, i + 14, int(bool(m & v)))
        m >>= 1
    return ctx


def _encode_ac(enc, st, fixed, i: int, k: int, v: int, kx: int) -> None:
    """jcarith.c's nonzero AC value v after its 'nonzero' decision at bin
    i + 1: the sign at the fixed probability, then the magnitude."""
    enc(fixed, 0, int(v < 0))
    v = abs(v) - 1
    i += 2
    m = 0
    if v:
        enc(st, i, 1)
        m = 1
        v2 = v >> 1
        if v2:
            enc(st, i, 1)
            m, i = 2, 189 if k <= kx else 217
            v2 >>= 1
            while v2:
                enc(st, i, 1)
                m, v2, i = m << 1, v2 >> 1, i + 1
    enc(st, i, 0)
    m >>= 1
    while m:
        enc(st, i + 14, int(bool(m & v)))
        m >>= 1


def _point(v: int, al: int) -> int:
    """The point transform of an AC coefficient: |v| >> Al, signed."""
    return -((-v) >> al) if v < 0 else v >> al


def _encode_block(enc, kind: str, blk, st_dc, st_ac, fixed, state, lo, hi, kx, ss, se, ah, al):
    """One block of a scan of `kind` (jcarith.c encode_mcu,
    encode_mcu_DC_first, _AC_first, _DC_refine, _AC_refine); `blk` its 64
    zig-zag coefficients, `state` the component's [prediction, context]."""
    if kind in ("seq", "dc_first"):
        m = int(blk[0]) >> al
        state[1] = _encode_dc(enc, st_dc, state[1], m - state[0], lo, hi)
        state[0] = m
    if kind == "dc_refine":
        enc(fixed, 0, (int(blk[0]) >> al) & 1)
    if kind not in ("seq", "ac_first", "ac_refine"):
        return
    lo_k, hi_k = (1, 63) if kind == "seq" else (ss, se)
    vals = [_point(int(x), al) for x in blk]
    ke = max([k for k in range(1, hi_k + 1) if vals[k]], default=0)
    kex = max([k for k in range(1, ke + 1) if _point(int(blk[k]), ah)], default=0) \
        if kind == "ac_refine" else -1
    k = lo_k
    while k <= ke:
        i = 3 * (k - 1)
        if k > kex:
            enc(st_ac, i, 0)  # not the end of the block
        while True:
            v = vals[k]
            if v and kind == "ac_refine" and abs(v) >> 1:  # nonzero before: its bit
                enc(st_ac, i + 2, abs(v) & 1)
                break
            if v:
                enc(st_ac, i + 1, 1)
                if kind == "ac_refine":
                    enc(fixed, 0, int(v < 0))
                else:
                    _encode_ac(enc, st_ac, fixed, i, k, v, kx)
                break
            enc(st_ac, i + 1, 0)
            i += 3
            k += 1
        k += 1
    if k <= hi_k:
        enc(st_ac, 3 * (k - 1), 1)


def _arith_scan(frame, coefs, header: bytes, restart: int, cond) -> bytes:
    """One scan (its SOS body `header`) of the frame's coefficients coded
    as jcarith.c codes it, RSTn markers between restart intervals."""
    ns = header[0]
    comps = [frame.ids.index(header[1 + 2 * j]) for j in range(ns)]
    tabs = [(header[2 + 2 * j] >> 4, header[2 + 2 * j] & 15) for j in range(ns)]
    ss, se, a = header[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    if not frame.progressive:
        kind = "seq"
    elif ss == 0:
        kind = "dc_refine" if ah else "dc_first"
    else:
        kind = "ac_refine" if ah else "ac_first"
    blocks, slots, per_mcu = frame.scan_blocks(comps)
    step = restart * per_mcu or blocks.size
    enc = QMEncoder()
    for n, b0 in enumerate(range(0, blocks.size, step)):
        if n:
            enc.finish()
            enc.out += bytes([0xFF, 0xD0 + (n - 1) % 8])
            enc.reset()
        st_dc = [bytearray(64) for _ in range(16)]
        st_ac = [bytearray(256) for _ in range(16)]
        fixed = bytearray([113])
        states = [[0, 0] for _ in comps]
        for b in range(b0, min(b0 + step, blocks.size)):
            j = slots[b]
            dt, at = tabs[j]
            lo, hi = ((1 << x) >> 1 for x in cond[0].get(dt, (0, 1)))
            _encode_block(enc, kind, coefs[comps[j]][blocks[b]], st_dc[dt], st_ac[at], fixed,
                          states[j], lo, hi, cond[1].get(at, 5), ss, se, ah, al)
    enc.finish()
    return bytes(enc.out)


def arith_jpeg(data: bytes, dac: bytes = b"") -> bytes:
    """A Huffman-coded JPEG (as PIL writes it) transcoded to arithmetic
    coding: SOF0/1 to SOF9, SOF2 to SOF10, the DHT segments dropped, `dac`
    (a DAC segment's body of (index, value) pairs) before the frame, and
    each scan's coefficients (utils/image_decode's Huffman decode of
    `data`) coded by jcarith.c's encoder with the same scan script and
    restart interval."""
    from relativitypathtracer_tpu_torch.utils import image_decode

    frame, coefs, _, _, _ = image_decode._read(data, image_decode.Tables(), image=True)
    cond = ({}, {})
    for index, value in zip(dac[::2], dac[1::2]):
        if index >= 16:
            cond[1][index - 16] = value
        else:
            cond[0][index] = (value & 15, value >> 4)
    out, pos, restart = bytearray(data[:2]), 2, 0
    while data[pos + 1] != 0xD9:
        marker = data[pos + 1]
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        body = data[pos + 4:end]
        if marker == 0xDD:
            restart = int.from_bytes(body[:2], "big")
        if marker == 0xDA:
            out += data[pos:end] + _arith_scan(frame, coefs, body, restart, cond)
            while not (data[end] == 0xFF and data[end + 1] != 0
                       and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
        elif marker in (0xC0, 0xC1, 0xC2):
            if dac:
                out += b"\xff\xcc" + struct.pack(">H", 2 + len(dac)) + dac
            out += bytes([0xFF, 0xCA if marker == 0xC2 else 0xC9]) + data[pos + 2:end]
        elif marker != 0xC4:
            out += data[pos:end]
        pos = end
    return bytes(out) + b"\xff\xd9"


def arith_sources(rng, Image) -> dict:
    """The arithmetic-coded fixtures and their Huffman-coded sources (PIL's
    files): {name: (arithmetic file, source)}. Sequential 4:2:0, 4:4:4 and
    grey; progressive (libjpeg's script, successive approximation);
    restart intervals, sequential and progressive; non-default DAC
    conditioning (DC L and U, AC Kx, both kinds of table); a progressive
    file cut after three scans, which libjpeg block-smooths; CMYK; the
    textured fixture's 32x32 texture, progressive (chip_smoke.py's K2
    scene)."""
    from relativitypathtracer_tpu_torch.utils.demo_scene import demo_texture

    def save(im, **kw):
        buf = io.BytesIO()
        im.save(buf, "JPEG", **kw)
        return buf.getvalue()

    def pic(h, w):
        return Image.fromarray(_picture(rng, h, w))

    src = {
        "arith_s420.jpg": save(pic(22, 35), quality=80),
        "arith_s444.jpg": save(pic(17, 26), quality=90, subsampling="4:4:4"),
        "arith_grey.jpg": save(pic(20, 31).convert("L"), quality=85),
        "arith_progressive.jpg": save(pic(30, 41), quality=75, progressive=True),
        "arith_restart.jpg": save(pic(26, 40), quality=70, restart_marker_blocks=1),
        "arith_prog_restart.jpg": save(pic(19, 33), quality=85, progressive=True,
                                       restart_marker_blocks=1),
        "arith_dac.jpg": save(pic(24, 37), quality=95),
        "arith_prog_first3.jpg": jpeg_scans(save(pic(21, 29), quality=70, progressive=True),
                                            {0, 1, 2}),
        "arith_cmyk.jpg": save(Image.fromarray(rng.integers(0, 256, (12, 18, 4))
                                               .astype(np.uint8), "CMYK"), quality=80),
        "blob_arith_prog.jpg": save(Image.fromarray(demo_texture(32)), quality=85,
                                    progressive=True),
    }
    dac = {"arith_dac.jpg": bytes([0x00, 0x31, 0x01, 0x20, 0x10, 2, 0x11, 20])}
    return {name: (arith_jpeg(data, dac.get(name, b"")), data) for name, data in src.items()}


# --- JPEG in TIFF -----------------------------------------------------------------

def jpeg_segments(data: bytes) -> list:
    """(marker, bytes) of each segment of a JPEG from SOI to EOI, exclusive,
    a scan's entropy-coded data with its SOS segment."""
    pos, out = 2, []
    while data[pos + 1] != 0xD9:
        marker = data[pos + 1]
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] != 0
                       and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
        out.append((marker, data[pos:end]))
        pos = end
    return out


def jpeg_split(data: bytes) -> tuple:
    """A JPEG as JPEG-in-TIFF stores it: (the abbreviated table-specification
    stream of its DQT and DHT segments, the abbreviated image stream of the
    rest without its APPn segments)."""
    segs = jpeg_segments(data)
    tables = b"\xff\xd8" + b"".join(b for m, b in segs if m in (0xDB, 0xC4)) + b"\xff\xd9"
    image = b"\xff\xd8" + b"".join(b for m, b in segs if m not in (0xDB, 0xC4)
                                    and not 0xE0 <= m <= 0xEF) + b"\xff\xd9"
    return tables, image


def jpeg_tiff(pic: np.ndarray, photo: int, chunk, Image, tile: bool = False,
              subsampling=None, tag530="stream", inline: bool = False, planar: int = 1,
              full_last: bool = False, quality: int = 80) -> bytes:
    """A JPEG-in-TIFF file (compression 7) of `pic` (h, w, n) in strips of
    chunk[1] rows or tiles of chunk, each coded by PIL's JPEG encoder:
    abbreviated streams with the tables in JPEGTables (347), or whole
    streams (`inline`); `tag530` the YCbCrSubsampling tag's value
    ("stream": the streams' sampling, None: no tag); planar 2 a stream a
    plane; `full_last` codes the last strip at the full strip height (its
    rows past the image zeros)."""
    h, w, n = pic.shape
    tw, th = chunk

    def code(part):
        kw = {"quality": quality}
        if subsampling and part.shape[2] == 3:
            kw["subsampling"] = subsampling
        im = Image.fromarray(part[..., 0] if part.shape[2] == 1 else part,
                             "CMYK" if part.shape[2] == 4 else None)
        buf = io.BytesIO()
        im.save(buf, "JPEG", **kw)
        return buf.getvalue()

    streams = []
    for plane in ([pic[..., c:c + 1] for c in range(n)] if planar == 2 else [pic]):
        for y in range(0, h, th):
            for x in (range(0, w, tw) if tile else [0]):
                if tile or full_last:
                    part = np.zeros((th, tw if tile else w, plane.shape[2]), np.uint8)
                    got = plane[y:y + th, x:x + tw] if tile else plane[y:y + th]
                    part[:got.shape[0], :got.shape[1]] = got
                else:
                    part = plane[y:y + th]
                streams.append(code(part))
    tables = jpeg_split(streams[0])[0]
    stored = streams if inline else [jpeg_split(x)[1] for x in streams]
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * n), (259, 3, [7]), (262, 3, [photo]),
            (277, 3, [n]), (284, 3, [planar])]
    if not inline:
        tags.append((347, 7, tables))
    if tag530 == "stream":
        tag530 = {"4:2:0": (2, 2), "4:2:2": (2, 1), None: (1, 1), "4:4:4": (1, 1)}[subsampling] \
            if photo == 6 else None
    if tag530:
        tags.append((530, 3, list(tag530)))
    return tiff_from_chunks(stored, h, tags, chunk if tile else None, None if tile else th)


def ojpeg_tiff(stream: bytes, form: str, rows=None, sub=(2, 2), photo: int = 6) -> bytes:
    """An old-style JPEG TIFF (compression 6) of the JPEG `stream`'s pixels:
    form "jif" keeps the stream whole at JPEGInterchangeFormat (513/514)
    with the strip the whole stream, "jif_sos" the same with the strip its
    entropy-coded data only; "tables" puts the quantisation and Huffman
    tables in tags 519-521 (a table a component; the stream's Y and chroma
    ones) and the entropy-coded data in the strip (`rows`: strips of that
    many rows, then `stream` is a list of one stream a strip)."""
    streams = stream if isinstance(stream, list) else [stream]
    frame = jpeg_segments(streams[0])
    sofs = [next(b for m, b in jpeg_segments(x) if m in (0xC0, 0xC1, 0xC2)) for x in streams]
    height = sum(int.from_bytes(sof[5:7], "big") for sof in sofs)
    width, n = int.from_bytes(sofs[0][7:9], "big"), sofs[0][9]
    body = bytearray(b"II*\0" + bytes(4))

    def put(x: bytes) -> int:
        at = len(body)
        body.extend(x + b"\0" * (len(x) % 2))
        return at

    def entropy(x: bytes) -> bytes:
        sos = next(b for m, b in jpeg_segments(x) if m == 0xDA)
        return sos[2 + int.from_bytes(sos[2:4], "big"):]

    tags = [(256, 4, [width]), (257, 4, [height]), (258, 3, [8] * n), (259, 3, [6]),
            (262, 3, [photo]), (277, 3, [n])]
    if sub:
        tags.append((530, 3, list(sub)))
    if form.startswith("jif"):
        at = put(streams[0])
        sos = streams[0].index(b"\xff\xda")
        data_at = sos + 2 + int.from_bytes(streams[0][sos + 2:sos + 4], "big")
        strip = (at + data_at, len(streams[0]) - data_at) if form == "jif_sos" else (
            at, len(streams[0]))
        tags += [(513, 4, [at]), (514, 4, [len(streams[0])]), (273, 4, [strip[0]]),
                 (278, 4, [height]), (279, 4, [strip[1]])]
    else:
        data = [entropy(x) for x in streams]
        offsets = [put(x) for x in data]
        qt, dc, ac = [], {}, {}
        for m, b in frame:
            seg, i = b[4:], 0
            while m == 0xDB and i < len(seg):
                qt.append(seg[i + 1:i + 65])
                i += 65
            while m == 0xC4 and i < len(seg):
                k = 17 + sum(seg[i + 1:i + 17])
                (ac if seg[i] >> 4 else dc)[seg[i] & 15] = seg[i + 1:i + k]
                i += k
        tags += [(273, 4, offsets), (278, 4, [rows or height]), (279, 4, [len(x) for x in data]),
                 (512, 3, [1]), (519, 4, [put(qt[min(c, len(qt) - 1)]) for c in range(n)]),
                 (520, 4, [put(dc[min(c, 1)]) for c in range(n)]),
                 (521, 4, [put(ac[min(c, 1)]) for c in range(n)])]
    entries = []
    for tag, kind, values in sorted(tags):
        raw = struct.pack("<" + {3: "H", 4: "L"}[kind] * len(values), *values)
        if len(raw) > 4:
            raw = struct.pack("<L", put(raw))
        entries.append(struct.pack("<HHL", tag, kind, len(values)) + raw.ljust(4, b"\0"))
    at = len(body)
    body += struct.pack("<H", len(entries)) + b"".join(entries) + bytes(4)
    body[4:8] = struct.pack("<L", at)
    return bytes(body)


def tiff_jpegs(rng, Image) -> dict:
    """JPEG-in-TIFF fixtures: PIL's compression 7 in RGB, YCbCr, L and CMYK;
    built here, tiles of 4:2:0 YCbCr (the cubes fixture's 64x64 texture,
    K8's windowed atlas), strips of 4:2:0 with the last coded at the full
    strip height, whole streams with their own tables in tiles, 4:2:2
    streams without a YCbCrSubsampling tag, planar RGB; old-style JPEG
    (compression 6) as the interchange format with the strip the whole
    stream (its 4:4:4 sampling over the tag's 2x2) and its entropy-coded
    data only (4:2:0), and with the tables in tags, two strips of 4:2:0
    and one of grey."""
    def save(im, **kw):
        buf = io.BytesIO()
        im.save(buf, "TIFF", compression="jpeg", quality=80, **kw)
        return buf.getvalue()

    def jpeg(pic, **kw):
        buf = io.BytesIO()
        Image.fromarray(pic).save(buf, "JPEG", quality=80, **kw)
        return buf.getvalue()

    files = {}
    pic = Image.fromarray(_picture(rng, 18, 27))
    files["jpeg_rgb.tif"] = save(pic)
    files["jpeg_ycbcr.tif"] = save(pic.convert("YCbCr"))
    files["jpeg_grey.tif"] = save(pic.convert("L"))
    files["jpeg_cmyk.tif"] = save(Image.fromarray(rng.integers(0, 256, (12, 17, 4))
                                                  .astype(np.uint8), "CMYK"))
    square = (np.add.outer(np.arange(64) // 8 * 3, np.arange(64) // 8 * 5) % 6)
    colours = rng.integers(30, 225, (6, 3)).astype(np.uint8)
    files["cubes_jpeg_tiles.tif"] = jpeg_tiff(colours[square], 6, (32, 32), Image, tile=True,
                                              subsampling="4:2:0")
    files["jpeg_strips420.tif"] = jpeg_tiff(_picture(rng, 37, 30), 6, (30, 16), Image,
                                            subsampling="4:2:0", full_last=True)
    files["jpeg_inline_tiles.tif"] = jpeg_tiff(_picture(rng, 17, 30), 6, (16, 16), Image,
                                               tile=True, subsampling="4:4:4", inline=True)
    files["jpeg_no530.tif"] = jpeg_tiff(_picture(rng, 19, 26), 6, (26, 8), Image,
                                        subsampling="4:2:2", tag530=None)
    files["jpeg_planar.tif"] = jpeg_tiff(_picture(rng, 14, 22), 2, (22, 8), Image, planar=2)
    files["ojpeg_jif.tif"] = ojpeg_tiff(jpeg(_picture(rng, 20, 28), subsampling="4:4:4"), "jif")
    files["ojpeg_jif_sos.tif"] = ojpeg_tiff(jpeg(_picture(rng, 22, 30)), "jif_sos", sub=None)
    strips = [jpeg(_picture(rng, 16, 25)), jpeg(_picture(rng, 9, 25))]
    files["ojpeg_tables.tif"] = ojpeg_tiff(strips, "tables", rows=16)
    files["ojpeg_grey.tif"] = ojpeg_tiff(jpeg(_picture(rng, 15, 21)[..., 0]), "tables",
                                         sub=None, photo=1)
    return files


# --- DDS, FTEX, BLP -------------------------------------------------------------

# DDS pixel-format flags
DDPF_ALPHAPIXELS, DDPF_FOURCC, DDPF_PAL8, DDPF_RGB, DDPF_LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000


def dds_file(width: int, height: int, body: bytes, *, pfflags: int = DDPF_FOURCC,
             fourcc: bytes = bytes(4), bitcount: int = 0, masks=(0, 0, 0, 0), dxgi=None,
             mipmaps: int = 0, cube: bool = False, header_size: int = 124) -> bytes:
    """A DDS file: the 124-byte header (mipmap count, cube-map caps), a
    DX10 header where `dxgi` is given, then `body` (every surface)."""
    flags = 0x1007 | (0x20000 if mipmaps else 0)
    caps = 0x1000 | (0x400008 if mipmaps else 0) | (0x8 if cube else 0)
    head = struct.pack("<7I", header_size, flags, height, width, 0, 0, mipmaps) + bytes(44)
    head += struct.pack("<2I", 32, pfflags) + fourcc + struct.pack("<5I", bitcount, *masks)
    head += struct.pack("<4I", caps, 0xFE00 if cube else 0, 0, 0) + bytes(4)
    dx10 = b"" if dxgi is None else struct.pack("<5I", dxgi, 3, 4 if cube else 0, 1, 0)
    return b"DDS " + head + dx10 + body


def bc7_mode6(rgb: np.ndarray) -> bytes:
    """Opaque BC7 mode-6 blocks of (h, w, 3) uint8 pixels (h and w
    multiples of 4): each block's endpoints its two texels farthest apart
    (made odd: 7 bits and a p-bit of 1, alpha 255), each texel the nearest
    of the 16 weights along them, texel 0's index below 8."""
    h, w = rgb.shape[:2]
    px = rgb.reshape(h // 4, 4, w // 4, 4, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 3)
    px = px.astype(np.int64)
    far = (((px[:, :, None] - px[:, None]) ** 2).sum(-1)).reshape(len(px), -1).argmax(1)
    rows = np.arange(len(px))
    e0, e1 = px[rows, far // 16] | 1, px[rows, far % 16] | 1
    d = e1 - e0
    t = ((px - e0[:, None]) * d[:, None]).sum(-1) / np.maximum((d * d).sum(-1), 1)[:, None]
    weights = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64])
    idx = np.abs(t[..., None] * 64 - weights).argmin(-1)
    flip = idx[:, 0] >= 8
    e0[flip], e1[flip] = e1[flip].copy(), e0[flip].copy()
    idx[flip] = 15 - idx[flip]
    fields = [(np.full(len(px), 1 << 6), 7)]
    for c in range(3):
        fields += [(e0[:, c] >> 1, 7), (e1[:, c] >> 1, 7)]
    fields += [(np.full(len(px), 127), 7)] * 2 + [(np.ones(len(px), np.int64), 1)] * 2
    fields += [(idx[:, 0], 3)] + [(idx[:, k], 4) for k in range(1, 16)]
    bits = np.concatenate([(np.asarray(v)[:, None] >> np.arange(n)) & 1 for v, n in fields], 1)
    return np.packbits(bits.astype(np.uint8), axis=1, bitorder="little").tobytes()


def ftex_file(width: int, height: int, fmt: int, body: bytes, formats: int = 1) -> bytes:
    """An FTEX file of one mipmap: its format (0 DXT1, 1 RGB) and data."""
    return (b"FTEX" + struct.pack("<7i", 0x80, width, height, 1, formats, fmt, 32)
            + struct.pack("<i", len(body)) + body)


def blp_file(version: int, width: int, height: int, mip0: bytes, *, compression: int = 1,
             encoding: int = 1, alpha: int = 0, alpha_encoding: int = 0, palette: bytes = b"",
             jpeg_header: bytes = b"", gap: int = 0) -> bytes:
    """A BLP1 or BLP2 file with one mipmap: for BLP1 JPEG (compression 0)
    the shared JPEG header, `gap` bytes, then mip 0; otherwise the BGRA
    palette (1,024 bytes, zero-padded), then mip 0."""
    if version == 1:
        head = b"BLP1" + struct.pack("<iIIIiI", compression, alpha, width, height, encoding, 0)
    else:
        head = b"BLP2" + struct.pack("<ibbbbII", compression, encoding, alpha, alpha_encoding, 1,
                                     width, height)
    if compression == 0:
        table = struct.pack("<I", len(jpeg_header)) + jpeg_header + bytes(gap)
    else:
        table = palette.ljust(1024, b"\0")
    at = len(head) + 128 + len(table)
    return (head + struct.pack("<16I", at, *(0,) * 15) + struct.pack("<16I", len(mip0), *(0,) * 15)
            + table + mip0)


def block_fixtures(rng, Image) -> dict:
    """DDS, FTEX and BLP fixtures: seeded random blocks of every BCn kind
    under the legacy FourCCs and under DX10 at sizes that are not multiples
    of 4, BC7 blocks in each mode and mode byte 0, BC6H (unsigned and
    signed) in each mode and the reserved ones, BC1 in both colour forms;
    DDS files PIL writes (DXT1, DXT3, DXT5, BC5, RGB, RGBA, L, LA);
    hand-built DDS (565, 1555, 4444, BGR24 and odd 32-bit masks, an 8-bit
    palette, mipmaps, a cube map); the textured fixture's 32x32 texture as
    DXT1 (PIL) and the cubes fixture's 64x64 squares as BC7 mode 6; FTEX
    in both formats; BLP1 JPEG (RGB with alpha, CMYK, YCCK) and palette,
    BLP2 palette with and without alpha (PIL), and BLP2 DXT1/3/5 at alpha
    flags 0 and 1 at an odd width."""
    from relativitypathtracer_tpu_torch.utils.demo_scene import demo_texture

    def save(im, fmt, **kw):
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        return buf.getvalue()

    def blocks(w, h, size):
        return rng.integers(0, 256, (-(-w // 4) * -(-h // 4), size), dtype=np.uint8)

    files = {}
    for fourcc, size, (w, h) in ((b"DXT1", 8, (13, 10)), (b"DXT3", 16, (9, 7)),
                                 (b"DXT5", 16, (18, 11)), (b"ATI1", 8, (15, 6)),
                                 (b"BC4U", 8, (6, 15)), (b"ATI2", 16, (11, 9)),
                                 (b"BC5U", 16, (7, 13)), (b"BC5S", 16, (14, 5))):
        files[f"rand_{fourcc.decode().lower()}.dds"] = dds_file(w, h, blocks(w, h, size).tobytes(),
                                                                fourcc=fourcc)
    for name, dxgi, size, (w, h) in (("bc1", 70, 8, (13, 10)), ("bc2", 74, 16, (10, 13)),
                                     ("bc3", 76, 16, (17, 5)), ("bc4", 80, 8, (19, 9)),
                                     ("bc5", 82, 16, (9, 17)), ("bc5s", 84, 16, (12, 7)),
                                     ("bc6h", 95, 16, (13, 10)), ("bc6hs", 96, 16, (11, 14)),
                                     ("bc7", 99, 16, (13, 10))):
        files[f"dx10_{name}.dds"] = dds_file(w, h, blocks(w, h, size).tobytes(), fourcc=b"DX10",
                                             dxgi=dxgi)
    # a row of 8 blocks a mode (30 texels wide): BC7's 8 modes and mode byte 0
    b = rng.integers(0, 256, (9, 8, 16), dtype=np.uint8)
    for m in range(8):
        b[m, :, 0] = (b[m, :, 0] & ((0xFF << (m + 1)) & 0xFF)) | (1 << m)
    b[8, :, 0] = 0
    files["bc7_modes.dds"] = dds_file(30, 36, b.tobytes(), fourcc=b"DX10", dxgi=98)
    # BC6H's 14 modes (2- and 5-bit codes) and its 4 reserved codes, a row each
    codes = [0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23, 27, 31]
    for name, dxgi in (("bc6h", 95), ("bc6hs", 96)):
        b = rng.integers(0, 256, (len(codes), 4, 16), dtype=np.uint8)
        for row, code in enumerate(codes):
            keep = 0xFC if code < 2 else 0xE0
            b[row, :, 0] = (b[row, :, 0] & keep) | code
        files[f"{name}_modes.dds"] = dds_file(15, 4 * len(codes), b.tobytes(), fourcc=b"DX10",
                                              dxgi=dxgi)
    # BC1 with c0 <= c1 (three colours and transparent black; equal in a
    # few) in the top half, c0 > c1 below
    b = blocks(16, 16, 8)
    c = np.sort(rng.integers(0, 65536, (16, 2)), 1)
    c[:3, 1] = c[:3, 0]
    c[8:] = c[8:, ::-1]
    c[8:, 0] = np.maximum(c[8:, 0], c[8:, 1] + 1)
    b[:, :4] = c.astype("<u2").view(np.uint8).reshape(16, 4)
    files["bc1_both_forms.dds"] = dds_file(16, 16, b.tobytes(), fourcc=b"DXT1")
    # written by PIL
    pic = Image.fromarray(_picture(rng, 14, 19))
    rgba = Image.fromarray(np.concatenate([_picture(rng, 14, 19),
                                           rng.integers(0, 256, (14, 19, 1), dtype=np.uint8)], 2),
                           "RGBA")
    for fmt in ("DXT1", "DXT3", "DXT5"):
        files[f"pil_{fmt.lower()}.dds"] = save(rgba, "DDS", pixel_format=fmt)
    files["pil_bc5.dds"] = save(pic, "DDS", pixel_format="BC5")
    files["pil_rgb.dds"] = save(pic, "DDS")
    files["pil_rgba.dds"] = save(rgba, "DDS")
    files["pil_l.dds"] = save(pic.convert("L"), "DDS")
    files["pil_la.dds"] = save(rgba.convert("LA"), "DDS")
    # hand-built uncompressed kinds
    px = rng.integers(0, 65536, (9, 11)).astype("<u2").tobytes()
    for name, flags, masks in (("r5g6b5", DDPF_RGB, (0xF800, 0x7E0, 0x1F, 0)),
                               ("a1r5g5b5", DDPF_RGB | DDPF_ALPHAPIXELS,
                                (0x7C00, 0x3E0, 0x1F, 0x8000)),
                               ("a4r4g4b4", DDPF_RGB | DDPF_ALPHAPIXELS,
                                (0xF00, 0xF0, 0xF, 0xF000))):
        files[f"{name}.dds"] = dds_file(11, 9, px, pfflags=flags, bitcount=16, masks=masks)
    files["bgr24.dds"] = dds_file(10, 7, rng.integers(0, 256, 210, dtype=np.uint8).tobytes(),
                                  pfflags=DDPF_RGB, bitcount=24,
                                  masks=(0xFF0000, 0xFF00, 0xFF, 0))
    # 32-bit masks that are not bytes: 10-10-10-2, a gapped mask, an empty one
    files["odd_masks32.dds"] = dds_file(9, 8, rng.integers(0, 256, 288, dtype=np.uint8).tobytes(),
                                        pfflags=DDPF_RGB, bitcount=32,
                                        masks=(0x3FF00000, 0xB0700, 0, 0xC0000000))
    files["a2b10g10r10.dds"] = dds_file(7, 6, rng.integers(0, 256, 168, dtype=np.uint8).tobytes(),
                                        pfflags=DDPF_RGB | DDPF_ALPHAPIXELS, bitcount=32,
                                        masks=(0x3FF, 0xFFC00, 0x3FF00000, 0xC0000000))
    files["p8.dds"] = dds_file(12, 9, rng.integers(0, 256, 1024 + 108, dtype=np.uint8).tobytes(),
                               pfflags=DDPF_PAL8, bitcount=8)
    files["mipmaps.dds"] = dds_file(12, 8, blocks(12, 8, 16).tobytes() + blocks(6, 4, 16).tobytes()
                                    + blocks(3, 2, 16).tobytes() + blocks(1, 1, 16).tobytes(),
                                    fourcc=b"DXT5", mipmaps=4)
    files["cube_bc7.dds"] = dds_file(8, 8, blocks(8, 8, 16).tobytes() * 6, fourcc=b"DX10",
                                     dxgi=98, cube=True)
    # the scenes' textures: textured's 32x32 as DXT1 (PIL), cubes' 64x64
    # squares as BC7 mode 6
    files["blob_bc1.dds"] = save(Image.fromarray(demo_texture(32)), "DDS", pixel_format="DXT1")
    square = (np.add.outer(np.arange(64) // 8 * 3, np.arange(64) // 8 * 5) % 6)
    colours = rng.integers(30, 225, (6, 3)).astype(np.uint8)
    files["cubes_bc7.dds"] = dds_file(64, 64, bc7_mode6(colours[square]), fourcc=b"DX10",
                                      dxgi=98)
    # FTEX
    files["dxt1.ftc"] = ftex_file(13, 10, 0, blocks(13, 10, 8).tobytes())
    files["rgb.ftu"] = ftex_file(11, 7, 1, _picture(rng, 7, 11).tobytes())
    # BLP1 JPEG: RGB with the alpha flag (the JPEG header shared, a gap
    # before mip 0), CMYK (Adobe), YCCK; BLP1 palette
    for name, mode, adobe, alpha in (("blp1_jpeg_alpha.blp", "RGB", None, 8),
                                     ("blp1_jpeg_cmyk.blp", "CMYK", None, 0),
                                     ("blp1_jpeg_ycck.blp", "CMYK", 2, 0)):
        im = Image.fromarray(rng.integers(0, 256, (12, 18, 4), dtype=np.uint8)[..., :len(mode)],
                             mode) if mode == "CMYK" else Image.fromarray(_picture(rng, 12, 18))
        jpeg = save(im, "JPEG", quality=85)
        if adobe is not None:
            jpeg = jpeg_adobe(jpeg, adobe)
        sos = jpeg.index(b"\xff\xda")
        files[name] = blp_file(1, 18, 12, jpeg[sos:], compression=0, alpha=alpha,
                               jpeg_header=jpeg[:sos], gap=6)
    pal = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    files["blp1_palette.blp"] = blp_file(1, 11, 9, rng.integers(0, 256, 99 + 99, dtype=np.uint8)
                                         .tobytes(), encoding=5, alpha=8, palette=pal)
    # BLP2 palette, PIL's writer: without alpha and with it
    quant = pic.quantize(24)
    files["blp2_palette.blp"] = save(quant, "BLP")
    files["blp2_palette_alpha.blp"] = save(rgba.quantize(24), "BLP")
    # BLP2 DXT (PIL's Python decoders) at width 11: alpha flag 0 and 1
    for kind, enc, size in (("dxt1", 0, 8), ("dxt3", 1, 16), ("dxt5", 7, 16)):
        for alpha in (0, 1):
            files[f"blp2_{kind}_a{alpha}.blp"] = blp_file(
                2, 11, 7, blocks(11, 7, size).tobytes(), encoding=2, alpha=alpha,
                alpha_encoding=enc, palette=bytes(1024))
    return files


# --- the small raster formats: PSD, SGI, PCX, DCX, Sun, QOI, MSP, icons, XBM, XPM

def psd_file(mode: int, bits: int, planes, comp: int = 0, mode_data: bytes = b"",
             resources: bytes = b"", layers: bytes = b"", channels=None) -> bytes:
    """A PSD of the merged image `planes` ((channels, h, row bytes) uint8),
    raw (comp 0) or PackBits rows (comp 1, a row count a channel and row)."""
    planes = np.asarray(planes, np.uint8)
    c, h, _ = planes.shape
    width = planes.shape[2] * 8 if bits == 1 else planes.shape[2]
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels or c, h, width, bits, mode)
    body = b"".join(struct.pack(">I", len(x)) + x for x in (mode_data, resources, layers))
    if comp == 0:
        return head + body + struct.pack(">H", 0) + planes.tobytes()
    rows = [packbits(bytes(r)) for plane in planes for r in plane]
    return (head + body + struct.pack(">H", 1) + struct.pack(f">{len(rows)}H", *map(len, rows))
            + b"".join(rows))


def sgi_rle_row(samples, bpc: int = 1) -> bytes:
    """SGI's RLE of one row of one channel: runs of 2-127 equal samples
    (count, value), copies of up to 127 others (0x80 | count, values), a 0
    atom at the end; each atom `bpc` bytes."""
    v = [int(x) for x in samples]
    atom = (lambda x: bytes([x])) if bpc == 1 else (lambda x: struct.pack(">H", x))
    out, i, n = bytearray(), 0, len(v)
    while i < n:
        j = i
        while j + 1 < n and v[j + 1] == v[i] and j - i < 126:
            j += 1
        if j > i:
            out += atom(j - i + 1) + atom(v[i])
            i = j + 1
            continue
        k = i
        while k + 1 < n and v[k + 1] != v[k] and k - i < 126:
            k += 1
        out += atom(0x80 | (k - i + 1)) + b"".join(atom(x) for x in v[i:k + 1])
        i = k + 1
    return bytes(out + atom(0))


def sgi_file(samples, bpc: int = 1, rle: bool = False, dimension=None, rows=None) -> bytes:
    """An SGI image of (h, w, z) samples (top row first; stored bottom-up),
    verbatim or RLE (`rows`: a (channel, file row) -> bytes override; equal
    rows share their data, as SGI's tools write them)."""
    samples = np.asarray(samples)
    h, w, z = samples.shape
    dimension = dimension or (3 if z > 1 else 2)
    head = struct.pack(">HBBHHHH", 474, int(rle), bpc, dimension, w, h, z).ljust(512, b"\0")
    up = samples[::-1]
    if not rle:
        dt = np.uint8 if bpc == 1 else ">u2"
        return head + np.ascontiguousarray(up.transpose(2, 0, 1)).astype(dt).tobytes()
    chunks = [(rows or {}).get((c, r)) or sgi_rle_row(up[r, :, c], bpc)
              for c in range(z) for r in range(h)]
    starts, pos, seen = [], 512 + 8 * h * z, {}
    for chunk in chunks:
        if chunk not in seen:
            seen[chunk] = pos
            pos += len(chunk)
        starts.append(seen[chunk])
    return (head + struct.pack(f">{h * z}I", *starts) + struct.pack(f">{h * z}I", *map(len, chunks))
            + b"".join(seen))


def pcx_rle(line: bytes) -> bytes:
    """PCX's RLE of one line: runs of 2-63 (or a byte >= 0xC0) as 0xC0 | n
    and the byte, other bytes themselves."""
    out, i, n = bytearray(), 0, len(line)
    while i < n:
        j = i
        while j + 1 < n and line[j + 1] == line[i] and j - i < 62:
            j += 1
        if j > i or line[i] >= 0xC0:
            out += bytes([0xC0 | (j - i + 1), line[i]])
        else:
            out.append(line[i])
        i = j + 1
    return bytes(out)


def pcx_file(lines, width: int, height: int, bits: int, planes: int, version: int = 5,
             palette16: bytes = bytes(48), palette256=None, stride=None, box=(0, 0)) -> bytes:
    """A PCX of `lines` (height rows of planes x stride bytes), RLE-coded
    a line at a time, with the header's 16-colour palette and, for 8 bits,
    the 769-byte one after the data."""
    stride = stride if stride is not None else len(lines[0]) // planes
    x0, y0 = box
    head = (struct.pack("<BBBBHHHHHH", 10, version, 1, bits, x0, y0, x0 + width - 1,
                        y0 + height - 1, 72, 72) + palette16[:48].ljust(48, b"\0") + b"\0"
            + struct.pack("<BHH", planes, stride, 1)).ljust(128, b"\0")
    body = b"".join(pcx_rle(bytes(line)) for line in lines)
    return head + body + (b"\x0c" + bytes(palette256) if palette256 is not None else b"")


def dcx_file(pages) -> bytes:
    """A DCX of PCX pages: the magic, the page offsets, a 0 entry."""
    table = 4 + 4 * (len(pages) + 1)
    offsets, pos = [], table
    for page in pages:
        offsets.append(pos)
        pos += len(page)
    return (struct.pack(f"<I{len(pages) + 1}I", 0x3ADE68B1, *offsets, 0) + b"".join(pages))


def sun_rle(data: bytes) -> bytes:
    """Sun's RLE: runs of 3-256 (or of 0x80) as 80 n-1 v, a lone 0x80 as
    80 00, other bytes themselves; runs go across rows."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 255:
            j += 1
        count = j - i + 1
        if count >= 3 or (data[i] == 0x80 and count > 1):
            out += bytes([0x80, count - 1, data[i]])
        elif data[i] == 0x80:
            out += b"\x80\x00"
        else:
            out += data[i:i + count]
        i = j + 1
    return bytes(out)


def sun_file(width: int, height: int, depth: int, body: bytes, kind: int = 1,
             cmap: bytes = b"") -> bytes:
    """A Sun raster file: the 32-byte header, an RGB colour map (planar),
    then `body` as it is stored."""
    return struct.pack(">8I", 0x59A66A95, width, height, depth, len(body), kind, 1 if cmap else 0,
                       len(cmap)) + cmap + body


def sun_rows(rows: np.ndarray, pad: bool = True) -> bytes:
    """Rows of bytes, each padded to 16 bits where `pad`."""
    rows = np.asarray(rows, np.uint8)
    if pad and rows.shape[1] % 2:
        rows = np.concatenate([rows, np.zeros((rows.shape[0], 1), np.uint8)], 1)
    return rows.tobytes()


def qoi_file(width: int, height: int, channels: int, ops: bytes) -> bytes:
    """A QOI file of an op stream, with its 8-byte end marker."""
    return (b"qoif" + struct.pack(">IIBB", width, height, channels, 0) + ops
            + b"\0" * 7 + b"\1")


def msp_file(width: int, height: int, rows, version: int = 2) -> bytes:
    """An MSP file of (height, ceil(width / 8)) bytes of bits: version 1
    raw, version 2 a row map and each row RLE-coded (runs of 3-255 as 00 n
    v, literals of up to 255 bytes)."""
    header = [0] * 16
    header[0:2] = struct.unpack("<2H", b"DanM" if version == 1 else b"LinS")
    header[2:4], header[4:8], header[8:10] = (width, height), (1, 1, 1, 1), (width, height)
    check = 0
    for word in header:
        check ^= word
    header[12] = check
    head = struct.pack("<16H", *header)
    rows = [bytes(r) for r in np.asarray(rows, np.uint8)]
    if version == 1:
        return head + b"".join(rows)
    coded = []
    for row in rows:
        out, i = bytearray(), 0
        while i < len(row):
            j = i
            while j + 1 < len(row) and row[j + 1] == row[i] and j - i < 254:
                j += 1
            if j - i >= 2:
                out += bytes([0, j - i + 1, row[i]])
                i = j + 1
            else:
                k = min(len(row), i + 255)
                stop = next((m for m in range(i, k - 2) if row[m] == row[m + 1] == row[m + 2]), k)
                stop = max(stop, i + 1)
                out += bytes([stop - i]) + row[i:stop]
                i = stop
        coded.append(bytes(out))
    return head + struct.pack(f"<{len(coded)}H", *map(len, coded)) + b"".join(coded)


def dib(rgb_or_idx: np.ndarray, bits: int, palette=None, mask=None) -> bytes:
    """An icon's or cursor's DIB: the 40-byte header at twice the height,
    the palette, the bottom-up rows and the AND mask (1 bit, rows padded to
    32 bits)."""
    h, w = rgb_or_idx.shape[:2]
    pal = b"".join(bytes([b, g, r, 0]) for r, g, b in (palette or []))
    if bits == 32:
        px = np.concatenate([rgb_or_idx[..., ::-1], np.full((h, w, 1), 255)], 2)
        rows = bmp_rows(px.astype(np.uint8), 32)
    elif bits == 24:
        rows = bmp_rows(rgb_or_idx[..., ::-1].astype(np.uint8), 24)
    else:
        rows = bmp_rows(rgb_or_idx.astype(np.uint8), bits)
    mask = np.zeros((h, w), np.uint8) if mask is None else mask
    stride = (w + 31) // 32 * 4
    packed = np.packbits(mask[::-1], axis=1)
    and_rows = np.zeros((h, stride), np.uint8)
    and_rows[:, :packed.shape[1]] = packed
    head = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0, len(palette or []), 0)
    return head + pal + rows + and_rows.tobytes()


def icon_file(kind: int, entries) -> bytes:
    """An ICO (kind 1) or CUR (kind 2): entries of (width byte, height byte,
    colour count, bit count, data); a CUR's planes and bit count fields
    hold its hotspot."""
    out, pos = struct.pack("<HHH", 0, kind, len(entries)), 6 + 16 * len(entries)
    for w, h, colors, bpp, data in entries:
        out += struct.pack("<BBBBHHII", w, h, colors, 0, 1, bpp, len(data), pos)
        pos += len(data)
    return out + b"".join(e[4] for e in entries)


def icns_rle(plane: bytes) -> bytes:
    """ICNS's RLE of one channel plane: runs of 3-130 as (n + 125, v),
    literals of up to 128 bytes as (n - 1, bytes)."""
    out, i, n = bytearray(), 0, len(plane)
    while i < n:
        j = i
        while j + 1 < n and plane[j + 1] == plane[i] and j - i < 129:
            j += 1
        if j - i >= 2:
            out += bytes([j - i + 1 + 125, plane[i]])
            i = j + 1
            continue
        k = i
        while k + 1 < n and k - i < 127 and not (k + 2 < n and plane[k + 1] == plane[k + 2]
                                                 == plane[min(k + 3, n - 1)]):
            k += 1
        out += bytes([k - i]) + plane[i:k + 1]
        i = k + 1
    return bytes(out)


def icns_file(blocks) -> bytes:
    """An ICNS file of (type, data) blocks."""
    body = b"".join(kind + struct.pack(">I", 8 + len(data)) + data for kind, data in blocks)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def icns_rgb(rgb: np.ndarray, it32: bool = False) -> bytes:
    """An RGB resource: each channel plane RLE-coded (it32 behind 4 zero
    bytes)."""
    data = b"".join(icns_rle(np.ascontiguousarray(rgb[..., c]).tobytes()) for c in range(3))
    return (b"\0\0\0\0" if it32 else b"") + data


def xpm_file(idx: np.ndarray, colours, cpp: int, keys=None, pixels_comment: bool = True) -> bytes:
    """An XPM of (h, w) indices into `colours` ("#rrggbb" or "None"), each
    pixel `cpp` characters."""
    h, w = idx.shape
    alphabet = b".#abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    keys = keys or [bytes(alphabet[(k // len(alphabet) ** j) % len(alphabet)]
                          for j in range(cpp)) for k in range(len(colours))]
    lines = [b"/* XPM */", b"static char *x[] = {", f'"{w} {h} {len(colours)} {cpp}",'.encode()]
    lines += [b'"' + k + b" c " + c.encode() + b'",' for k, c in zip(keys, colours)]
    if pixels_comment:
        lines.append(b"/* pixels */")
    lines += [b'"' + b"".join(keys[i] for i in row) + b'",' for row in idx]
    return b"\n".join(lines) + b"\n};\n"


def legacy_fixtures(rng, Image) -> dict:
    """The PSD, SGI, PCX, DCX, Sun raster, QOI, MSP, ICO, CUR, ICNS, XBM
    and XPM fixtures, by file name: files PIL writes (PCX, SGI verbatim,
    ICO, ICNS with PNG entries, MSP v1, XBM, QOI) and built here (PSD in
    every mode, SGI RLE, Sun raster at every depth, DCX, CUR, ICO entries of
    equal size, ICNS RLE resources, MSP v2, XPM); odd sizes and padded
    rows throughout. Two are the chip-smoke scenes' textures: textured's
    32x32 as a PackBits RGB PSD, cubes' 64x64 squares as an RLE SGI."""
    from relativitypathtracer_tpu_torch.utils.demo_scene import demo_texture

    def save(im, fmt, **kw):
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        return buf.getvalue()

    files = {}
    pic = Image.fromarray(_picture(rng, 11, 13))
    # PCX written by PIL: 1, L (a grey palette), P, RGB (odd width: padded planes)
    files["bits.pcx"] = save(Image.fromarray(_picture(rng, 9, 21)).convert("1"), "PCX")
    files["grey.pcx"] = save(pic.convert("L"), "PCX")
    files["palette.pcx"] = save(pic.quantize(23), "PCX")
    files["rgb.pcx"] = save(pic, "PCX")
    # PCX built here: 4 planes of 1 bit (16 colours), 2 planes, a window
    idx = rng.integers(0, 16, (7, 19))
    pal16 = rng.integers(0, 256, 48, dtype=np.uint8).tobytes()
    for planes in (2, 4):
        v = idx % (1 << planes)
        lines = [b"".join(np.packbits((row >> k) & 1).tobytes() + b"\0" for k in range(planes))
                 for row in v]
        files[f"planes{planes}.pcx"] = pcx_file(lines, 19, 7, 1, planes, stride=4,
                                                palette16=pal16, box=(3, 5))
    # DCX of two 8-bit pages (the first page's palette is the file's last)
    pages = [save(Image.fromarray(_picture(rng, 6 + k, 9 + k)).quantize(9 + k), "PCX")
             for k in range(2)]
    files["two_pages.dcx"] = dcx_file(pages)
    # SGI written by PIL (verbatim): L as .bw, RGB as .rgb, RGBA, 16-bit RGB
    files["grey.bw"] = save(pic.convert("L"), "SGI")
    files["verbatim.rgb"] = save(pic, "SGI")
    files["rgba.sgi"] = save(pic.convert("RGBA"), "SGI")
    files["rgb16.sgi"] = save(Image.fromarray(_picture(rng, 7, 10)), "SGI", bpc=2)
    # SGI RLE built here: 8-bit L and RGBA, 16-bit RGB
    files["grey_rle.sgi"] = sgi_file(_picture(rng, 10, 15)[..., :1] // 16 * 16, rle=True)
    rgba = np.concatenate([_picture(rng, 9, 12) // 32 * 32,
                           rng.integers(0, 256, (9, 12, 1))], 2).astype(np.uint8)
    files["rgba_rle.sgi"] = sgi_file(rgba, rle=True)
    files["rgb16_rle.sgi"] = sgi_file(rng.integers(0, 4, (6, 11, 3)) * 20000, bpc=2, rle=True)
    # the cubes scene's texture: 64x64 squares as RLE SGI
    square = (np.add.outer(np.arange(64) // 8 * 3, np.arange(64) // 8 * 5) % 6)
    colours = rng.integers(30, 225, (6, 3)).astype(np.uint8)
    files["cubes_rle.sgi"] = sgi_file(colours[square], rle=True)
    # PSD in every mode PIL reads, raw and PackBits
    grey = _picture(rng, 9, 14)[..., 0]
    files["bitmap.psd"] = psd_file(0, 1, np.packbits(grey > 128, axis=1)[None])
    files["grey_packbits.psd"] = psd_file(1, 8, (grey // 8 * 8)[None], comp=1)
    files["indexed.psd"] = psd_file(2, 8, rng.integers(0, 256, (1, 7, 10)),
                                    mode_data=rng.integers(0, 256, 768, dtype=np.uint8).tobytes())
    rgb = _picture(rng, 8, 11)
    files["rgb_raw.psd"] = psd_file(3, 8, rgb.transpose(2, 0, 1),
                                    resources=b"8BIM\x03\xed\0\0\0\0\0\x10" + bytes(16))
    files["rgba_packbits.psd"] = psd_file(3, 8, np.concatenate(
        [rgb // 16 * 16, rng.integers(0, 256, (8, 11, 1))], 2).transpose(2, 0, 1), comp=1,
        layers=bytes(12))
    files["cmyk.psd"] = psd_file(4, 8, rng.integers(0, 256, (4, 6, 9)), comp=1)
    files["multichannel.psd"] = psd_file(7, 8, rng.integers(0, 256, (2, 5, 7)))
    files["duotone.psd"] = psd_file(8, 8, rng.integers(0, 256, (1, 5, 9)), comp=1,
                                    mode_data=bytes(range(40)))
    files["lab.psd"] = psd_file(9, 8, rng.integers(0, 256, (3, 7, 9)))
    files["blob_packbits.psd"] = psd_file(3, 8, demo_texture(32).transpose(2, 0, 1), comp=1)
    # Sun raster at every depth, raw and RLE, with and without a colour map
    bits = np.packbits(_picture(rng, 7, 13)[..., 0] > 128, axis=1)
    files["sun1.ras"] = sun_file(13, 7, 1, sun_rows(bits))
    nib = rng.integers(0, 16, (6, 9))
    packed = (nib[:, 0::2] << 4 | np.pad(nib[:, 1::2], ((0, 0), (0, 1)))).astype(np.uint8)
    files["sun4.ras"] = sun_file(9, 6, 4, sun_rows(packed))
    cmap = rng.integers(0, 256, 48, dtype=np.uint8).tobytes()
    files["sun4_map.ras"] = sun_file(9, 6, 4, sun_rows(packed), cmap=cmap)
    files["sun8.ras"] = sun_file(11, 5, 8, sun_rows(grey[:5, :11]))
    cmap = rng.integers(0, 256, 3 * 40, dtype=np.uint8).tobytes()
    idx = rng.integers(0, 40, (8, 9)).astype(np.uint8)
    idx[2:5] = 0x80
    files["sun8_map_rle.ras"] = sun_file(9, 8, 8, sun_rle(idx.tobytes()), kind=2, cmap=cmap)
    rgb = _picture(rng, 6, 7) // 64 * 64
    files["sun24_bgr.ras"] = sun_file(7, 6, 24, sun_rows(rgb[..., ::-1].reshape(6, -1)))
    files["sun24_rgb_type3.ras"] = sun_file(7, 6, 24, sun_rows(rgb.reshape(6, -1)), kind=3)
    files["sun24_rle.ras"] = sun_file(7, 6, 24, sun_rle(rgb[..., ::-1].tobytes()), kind=2)
    xrgb = np.concatenate([np.zeros((6, 7, 1), np.uint8), rgb[..., ::-1]], 2)[..., [1, 2, 3, 0]]
    files["sun32.ras"] = sun_file(7, 6, 32, sun_rows(xrgb.reshape(6, -1)))
    files["sun32_rle.ras"] = sun_file(7, 6, 32, sun_rle(xrgb.tobytes()), kind=2)
    # QOI written by PIL
    files["rgb.qoi"] = save(Image.fromarray(_picture(rng, 12, 17) // 4 * 4), "QOI")
    files["rgba.qoi"] = save(Image.fromarray(np.concatenate(
        [_picture(rng, 10, 9), rng.integers(250, 256, (10, 9, 1), dtype=np.uint8)], 2)), "QOI")
    # MSP: v1 by PIL, v2 built here (runs, literals, an empty row)
    files["v1.msp"] = save(Image.fromarray(_picture(rng, 9, 19)).convert("1"), "MSP")
    rows = np.packbits(_picture(rng, 8, 29)[..., 0] > 100, axis=1)
    rows[2:4, :2] = 0xFF
    files["v2.msp"] = msp_file(29, 8, rows)
    # ICO written by PIL (PNG entries; BMP entries), ICO entries of one size
    # at 4, 8 and 24 bits (the 4-bit one opened), CUR with several entries
    icon = Image.fromarray(_picture(rng, 32, 32))
    files["png_entries.ico"] = save(icon, "ICO", sizes=[(16, 16), (32, 32)])
    files["bmp_entries.ico"] = save(icon.resize((21, 21)), "ICO", sizes=[(16, 16), (21, 21)],
                                    bitmap_format="bmp")
    small = _picture(rng, 12, 12)
    pal = [tuple(int(c) for c in rng.integers(0, 256, 3)) for _ in range(16)]
    idx = rng.integers(0, 16, (12, 12))
    pal256 = pal + [(0, 0, 0)] * 240
    files["equal_sizes.ico"] = icon_file(1, [(12, 12, 0, 24, dib(small, 24)),
                                             (12, 12, 0, 8, dib(idx, 8, pal256)),
                                             (12, 12, 16, 4, dib(idx, 4, pal)),
                                             (8, 8, 0, 32, dib(small[:8, :8], 32))])
    files["cursor.cur"] = icon_file(2, [(7, 5, 0, 24, dib(small[:5, :7], 24)),
                                        (11, 9, 0, 24, dib(small[:9, :11], 24)),
                                        (13, 8, 0, 24, dib(small[:8, :12], 24)),
                                        (10, 10, 0, 24, dib(small[:10, :10], 24))])
    # ICNS: PNG entries (PIL's own ICNS files pass 4 KB; the tests write
    # them); RLE it32, ih32 + h8mk, il32 + l8mk, is32 + s8mk
    files["png.icns"] = icns_file(
        [(b"icp4", save(Image.fromarray(_picture(rng, 16, 16)), "PNG")),
         (b"icp5", save(Image.fromarray(_picture(rng, 32, 32) // 32 * 32), "PNG"))])
    big = colours[(np.add.outer(np.arange(128) // 32, np.arange(128) // 32 * 2) % 6)]
    files["it32.icns"] = icns_file([(b"it32", icns_rgb(big, it32=True))])
    for kind, mask, side in ((b"ih32", b"h8mk", 48), (b"il32", b"l8mk", 32),
                             (b"is32", b"s8mk", 16)):
        rgb = _picture(rng, side, side) // 128 * 128
        files[f"{kind.decode()}.icns"] = icns_file(
            [(kind, icns_rgb(rgb)), (mask, rng.integers(0, 256, side * side,
                                                        dtype=np.uint8).tobytes())])
    # XBM written by PIL; XPM at 1 and 2 characters a pixel, with None
    files["bitmap.xbm"] = save(Image.fromarray(_picture(rng, 7, 19)).convert("1"), "XBM")
    cols = ["#%06x" % int(c) for c in rng.integers(0, 1 << 24, 5)]
    files["one_char.xpm"] = xpm_file(rng.integers(0, 5, (6, 11)), cols, 1)
    files["two_chars_none.xpm"] = xpm_file(rng.integers(1, 70, (9, 7)),
                                           ["None"] + ["#%06x" % int(c) for c in
                                                       rng.integers(0, 1 << 24, 69)], 2)
    return files

# ---------------------------------------------------------------------------
# JPEG 2000, FITS, and PNG as PIL reads a bad CRC or a missing IEND


def _openjp2():
    """PIL's own libopenjp2 (2.5.4), by ctypes: its encoder writes what PIL's
    save does not (code-block styles, SOP/EPH, ROI, POC, subsampling,
    precisions other than 8 and 16, tile-parts, TLM)."""
    import ctypes
    import glob
    import os

    import PIL

    lib = ctypes.CDLL(glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                                             "pillow.libs", "libopenjp2-*.so*"))[0])
    for name in ("opj_image_create", "opj_create_compress",
                 "opj_stream_create_default_file_stream"):
        getattr(lib, name).restype = ctypes.c_void_p
    for name in ("opj_setup_encoder", "opj_start_compress", "opj_encode", "opj_end_compress",
                 "opj_stream_destroy", "opj_destroy_codec", "opj_image_destroy",
                 "opj_encoder_set_extra_options"):
        getattr(lib, name).argtypes = [ctypes.c_void_p] * {"opj_setup_encoder": 3,
                                                           "opj_start_compress": 3,
                                                           "opj_encode": 2, "opj_end_compress": 2,
                                                           "opj_encoder_set_extra_options": 2
                                                           }.get(name, 1)
    return lib


# byte offsets in libopenjp2 2.5's opj_cparameters_t (x86-64); `openjpeg`
# checks them against opj_set_default_encoder_parameters' defaults
_CPARAMS = {"tile_size_on": 0, "cp_tx0": 4, "cp_ty0": 8, "cp_tdx": 12, "cp_tdy": 16,
            "cp_disto_alloc": 20, "csty": 48, "prog_order": 52, "POC": 56, "numpocs": 4792,
            "tcp_numlayers": 4796, "tcp_rates": 4800, "numresolution": 5600,
            "cblockw_init": 5604, "cblockh_init": 5608, "mode": 5612, "irreversible": 5616,
            "roi_compno": 5620, "roi_shift": 5624, "res_spec": 5628, "prcw_init": 5632,
            "prch_init": 5764, "image_offset_x0": 18188, "image_offset_y0": 18192,
            "subsampling_dx": 18196, "decod_format": 18204, "tp_on": 18696, "tcp_mct": 18698}
_POC_SIZE = 148  # sizeof(opj_poc_t)


def openjpeg(planes, *, dx=None, dy=None, prec=8, sgnd=False, offset=(0, 0), rates=None,
             cblk=None, precincts=None, tiles=None, pocs=None, tile_parts=None, extra=(),
             mct=False, **ints) -> bytes:
    """A J2K codestream of the component planes ((h, w) integer arrays,
    each at its subsampling) written by libopenjp2's encoder. `ints` sets
    opj_cparameters_t's int fields by name (numresolution, irreversible,
    mode: the code-block style, csty: 2 SOP, 4 EPH, prog_order, roi_compno,
    roi_shift); rates are the layers' compression ratios (0 lossless); pocs
    (RSpoc, CSpoc, LYEpoc, REpoc, CEpoc, order) for the first tile;
    tile_parts 'R', 'L' or 'C'; extra the encoder's options ("TLM=YES")."""
    import ctypes
    import os
    import tempfile

    lib = _openjp2()
    n = len(planes)
    dx, dy = dx or [1] * n, dy or [1] * n
    buf = ctypes.create_string_buffer(1 << 16)
    lib.opj_set_default_encoder_parameters(buf)

    def put(name, value, i=0, size=4, fmt="<i"):
        ctypes.memmove(ctypes.addressof(buf) + _CPARAMS[name] + size * i,
                       struct.pack(fmt, value), size)

    def get(name):
        return struct.unpack_from("<i", buf.raw, _CPARAMS[name])[0]

    if (get("numresolution"), get("cblockw_init"), get("roi_compno"), get("subsampling_dx"),
            get("decod_format")) != (6, 64, -1, 1, -1):
        raise RuntimeError("libopenjp2's opj_cparameters_t is not laid out as _CPARAMS says")
    rates = rates or [0]
    put("tcp_numlayers", len(rates))
    for i, r in enumerate(rates):
        put("tcp_rates", r, i, fmt="<f")
    put("cp_disto_alloc", 1)
    for name, value in ints.items():
        put(name, value)
    if cblk:
        put("cblockw_init", cblk[0])
        put("cblockh_init", cblk[1])
    if precincts:
        put("csty", get("csty") | 1)
        put("res_spec", len(precincts))
        for i, (w, h) in enumerate(precincts):
            put("prcw_init", w, i)
            put("prch_init", h, i)
    if tiles:
        (tw, th), (tx0, ty0) = tiles
        for name, value in (("tile_size_on", 1), ("cp_tdx", tw), ("cp_tdy", th), ("cp_tx0", tx0),
                            ("cp_ty0", ty0)):
            put(name, value)
    put("image_offset_x0", offset[0])
    put("image_offset_y0", offset[1])
    for i, (rs, cs, ly, re_, ce, order) in enumerate(pocs or ()):
        base = _CPARAMS["POC"] + _POC_SIZE * i
        ctypes.memmove(ctypes.addressof(buf) + base, struct.pack("<5I", rs, cs, ly, re_, ce), 20)
        ctypes.memmove(ctypes.addressof(buf) + base + 32, struct.pack("<I", order), 4)  # prg1
        ctypes.memmove(ctypes.addressof(buf) + base + 48, struct.pack("<I", 1), 4)  # tile 1
    put("numpocs", len(pocs or ()))
    if tile_parts:
        put("tp_on", 1, size=1, fmt="<B")
        ctypes.memmove(ctypes.addressof(buf) + _CPARAMS["tp_on"] + 1, tile_parts.encode(), 1)
    if mct:
        put("tcp_mct", 1, size=1, fmt="<B")

    class Component(ctypes.Structure):
        _fields_ = [(f, ctypes.c_uint32) for f in ("dx", "dy", "w", "h", "x0", "y0", "prec",
                                                   "bpp", "sgnd")]

    comps = (Component * n)()
    for i, p in enumerate(planes):
        comps[i].dx, comps[i].dy = dx[i], dy[i]
        comps[i].h, comps[i].w = p.shape
        comps[i].x0, comps[i].y0 = -(-offset[0] // dx[i]), -(-offset[1] // dy[i])
        comps[i].prec = comps[i].bpp = prec
        comps[i].sgnd = int(sgnd)
    image = lib.opj_image_create(n, comps, 1 if n >= 3 else 2)
    rect = (ctypes.c_uint32 * 4).from_address(image)
    rect[0], rect[1] = offset
    rect[2] = offset[0] + max((p.shape[1] - 1) * dx[i] + 1 for i, p in enumerate(planes))
    rect[3] = offset[1] + max((p.shape[0] - 1) * dy[i] + 1 for i, p in enumerate(planes))
    comp_array = ctypes.c_void_p.from_address(image + 24).value  # opj_image_t.comps
    for i, p in enumerate(planes):  # opj_image_comp_t is 64 bytes, its data at 48
        samples = np.ascontiguousarray(p, np.int32)
        ctypes.memmove(ctypes.c_void_p.from_address(comp_array + 64 * i + 48).value,
                       samples.ctypes.data, samples.nbytes)
    codec = lib.opj_create_compress(0)  # OPJ_CODEC_J2K
    ok = lib.opj_setup_encoder(codec, buf, image)
    if extra:
        ok = ok and lib.opj_encoder_set_extra_options(
            codec, (ctypes.c_char_p * (len(extra) + 1))(*[e.encode() for e in extra], None))
    fd, path = tempfile.mkstemp(suffix=".j2k")
    os.close(fd)
    stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
    ok = ok and lib.opj_start_compress(codec, image, stream) and lib.opj_encode(codec, stream) \
        and lib.opj_end_compress(codec, stream)
    lib.opj_stream_destroy(stream)
    lib.opj_destroy_codec(codec)
    lib.opj_image_destroy(image)
    with open(path, "rb") as f:
        data = f.read()
    os.unlink(path)
    if not ok:
        raise RuntimeError("libopenjp2 refused the parameters")
    return data


def j2k_marker(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def j2k_split(cs: bytes) -> tuple:
    """A codestream as (main header marker segments, [(SOT body, tile-part
    header segments, data)]): each segment its whole bytes."""
    pos, main, parts = 2, [], []
    while True:
        marker, length = struct.unpack_from(">HH", cs, pos)
        if marker == 0xFF90:
            break
        main.append(cs[pos:pos + 2 + length])
        pos += 2 + length
    while struct.unpack_from(">H", cs, pos)[0] == 0xFF90:
        psot = struct.unpack_from(">I", cs, pos + 6)[0]
        end = pos + psot
        sot, p, headers = cs[pos + 4:pos + 12], pos + 12, []
        while struct.unpack_from(">H", cs, p)[0] != 0xFF93:
            length = struct.unpack_from(">H", cs, p + 2)[0]
            headers.append(cs[p:p + 2 + length])
            p += 2 + length
        parts.append((sot, headers, cs[p + 2:end]))
        pos = end
    return main, parts


def j2k_join(main: list, parts: list) -> bytes:
    out = [b"\xff\x4f"] + main
    for sot, headers, data in parts:
        body = b"".join(headers)
        psot = 12 + len(body) + 2 + len(data)
        out.append(j2k_marker(0xFF90, sot[:2] + struct.pack(">I", psot) + sot[6:]) + body
                   + b"\xff\x93" + data)
    return b"".join(out) + b"\xff\xd9"


def j2k_packets(data: bytes) -> list:
    """(header, body) of each packet of a tile-part written with SOP and EPH:
    the header from after SOP to EPH (EPH kept), the body up to the next
    SOP (neither marker occurs inside a packet)."""
    starts = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0x91]
    out = []
    for a, b in zip(starts, starts[1:] + [len(data)]):
        eph = data.index(b"\xff\x92", a + 6) + 2
        out.append((data[a + 6:eph], data[eph:b]))
    return out


def j2k_headers_apart(cs: bytes, where: str) -> bytes:
    """The codestream (written with SOP and EPH) with its packet headers moved
    into PPT markers in each tile-part's header (where "ppt", split over
    several markers), or into PPM markers in the main header ("ppm"); SOP
    stays before each packet body."""
    main, parts = j2k_split(cs)
    new_parts, ppm = [], b""
    for sot, headers, data in parts:
        packets = j2k_packets(data)
        heads = b"".join(h for h, _ in packets)
        sop = [data[i:i + 6] for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\x91"]
        bodies = b"".join(s + b for s, (_, b) in zip(sop, packets))
        if where == "ppt":
            half = len(heads) // 2
            headers = headers + [j2k_marker(0xFF61, bytes([0]) + heads[:half]),
                                 j2k_marker(0xFF61, bytes([1]) + heads[half:])]
        else:
            ppm += struct.pack(">I", len(heads)) + heads
        new_parts.append((sot, headers, bodies))
    if where == "ppm":
        half = len(ppm) // 2  # two PPM markers, the split inside a header's bytes
        main = main + [j2k_marker(0xFF60, bytes([0]) + ppm[:half]),
                       j2k_marker(0xFF60, bytes([1]) + ppm[half:])]
    return j2k_join(main, new_parts)


def j2k_with_main(cs: bytes, *segments: bytes, replace=None) -> bytes:
    """The codestream with marker segments added to its main header (after
    SIZ, COD and QCD), or the segment of marker `replace` replaced by the
    first of them."""
    main, parts = j2k_split(cs)
    if replace is not None:
        main = [segments[0] if struct.unpack_from(">H", m)[0] == replace else m for m in main]
    else:
        main = main + list(segments)
    return j2k_join(main, parts)


def htj2k_stub(width: int = 16, height: int = 16) -> bytes:
    """An HTJ2K (Part 15) codestream, Rsiz bit 14 and a CAP marker, whose one
    packet is empty: OpenJPEG (and so PIL) decode it to mid-grey."""
    siz = struct.pack(">H8IH", 0x4000, width, height, 0, 0, width, height, 0, 0, 1) + b"\x07\1\1"
    cod = bytes([0, 0]) + struct.pack(">H", 1) + bytes([0, 0, 4, 4, 0x40, 1])
    body = j2k_marker(0xFF51, siz) + j2k_marker(0xFF50, struct.pack(">IH", 0x00020000, 0)) \
        + j2k_marker(0xFF52, cod) + j2k_marker(0xFF5C, bytes([0x20, 8 << 3]))
    return b"\xff\x4f" + body + j2k_marker(0xFF90, struct.pack(">HIBB", 0, 15, 0, 1)) \
        + b"\xff\x93\x00\xff\xd9"


def jp2_box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(body), kind) + body


def jp2_file(cs: bytes, width: int, height: int, nc: int, *, colr=None, extra: bytes = b"",
             bpc: int = 7) -> bytes:
    """A JP2 file around a codestream: signature, ftyp, jp2h (ihdr, colr:
    an enumerated colour space by number or the box's bytes, then `extra`
    boxes), jp2c."""
    if colr is None or isinstance(colr, int):
        colr = struct.pack(">BBBI", 1, 0, 0, colr or (16 if nc >= 3 else 17))
    header = jp2_box(b"ihdr", struct.pack(">IIHBBBB", height, width, nc, bpc, 7, 0, 0)) \
        + jp2_box(b"colr", colr) + extra
    return (jp2_box(b"jP  ", b"\r\n\x87\n") + jp2_box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + jp2_box(b"jp2h", header) + jp2_box(b"jp2c", cs))


def jp2_palette(entries, depth: int = 7) -> bytes:
    """pclr (each entry one byte a column) and cmap boxes."""
    npc = len(entries[0])
    pclr = struct.pack(">HB", len(entries), npc) + bytes([depth] * npc) \
        + b"".join(bytes(e) for e in entries)
    cmap = b"".join(struct.pack(">HBB", 0, 1, i) for i in range(npc))
    return jp2_box(b"pclr", pclr) + jp2_box(b"cmap", cmap)


def fits_card(key: str, value=None) -> bytes:
    text = key.ljust(8) + ("= " + str(value).rjust(20) if value is not None else "")
    return text.ljust(80).encode()


def fits_header(cards) -> bytes:
    body = b"".join(cards) + fits_card("END")
    return body + b" " * (-len(body) % 2880)


def fits_file(samples: np.ndarray, bitpix: int, naxis: int = 2) -> bytes:
    """A FITS primary HDU (big-endian samples, the data unit not padded:
    PIL does not need it)."""
    dtype = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    cards = [fits_card("SIMPLE", "T"), fits_card("BITPIX", bitpix), fits_card("NAXIS", naxis)]
    cards += [fits_card(f"NAXIS{i + 1}", n) for i, n in enumerate(samples.shape[::-1][:naxis])]
    return fits_header(cards) + np.asarray(samples).astype(dtype).tobytes()


def fits_gzip(samples: np.ndarray, zbitpix: int, primary: bool = True) -> bytes:
    """A tile-compressed FITS image as PIL's FitsGzipDecoder reads it: a
    BINTABLE with ZIMAGE T and ZCMPTYPE 'GZIP_1  ' whose heap (after its one
    8-byte row) is the gzipped samples, 4 big-endian bytes each; after an
    empty primary HDU, or (primary False, under 4 KB) with the table's
    keywords in the primary header, which PIL reads alike."""
    import gzip

    payload = gzip.compress(np.asarray(samples).astype(">i4").tobytes(), mtime=0)
    cards = [fits_card("XTENSION", "'BINTABLE'"), fits_card("BITPIX", 8), fits_card("NAXIS", 2),
             fits_card("NAXIS1", 8), fits_card("NAXIS2", 1), fits_card("PCOUNT", len(payload)),
             fits_card("GCOUNT", 1), fits_card("TFIELDS", 1), fits_card("ZIMAGE", "T"),
             fits_card("ZCMPTYPE", "'GZIP_1  '"), fits_card("ZBITPIX", zbitpix),
             fits_card("ZNAXIS", 2), fits_card("ZNAXIS1", samples.shape[1]),
             fits_card("ZNAXIS2", samples.shape[0])]
    if primary:
        head = fits_header([fits_card("SIMPLE", "T"), fits_card("BITPIX", 8),
                            fits_card("NAXIS", 0)]) + fits_header(cards)
    else:
        head = fits_header([fits_card("SIMPLE", "T")] + cards)
    return head + bytes(8) + payload


def png_chunks(data: bytes) -> list:
    """(type, start, end) of each chunk of a PNG file."""
    out, pos = [], 8
    while pos + 8 <= len(data):
        length = int.from_bytes(data[pos:pos + 4], "big")
        out.append((data[pos + 4:pos + 8], pos, pos + 12 + length))
        pos += 12 + length
    return out


def png_bad_crc(data: bytes, kind: bytes) -> bytes:
    """The PNG file with the CRC of its first `kind` chunk flipped."""
    _, _, end = next(c for c in png_chunks(data) if c[0] == kind)
    return data[:end - 1] + bytes([data[end - 1] ^ 0x5A]) + data[end:]


def j2k_fixtures(rng, Image) -> dict:
    """JPEG 2000, FITS and PNG-read-as-PIL fixtures, by file name. JPEG
    2000: PIL's save (modes L, LA, RGB, RGBA, I;16, signed, reversible and
    irreversible, the five progressions, layers, precincts, code-block
    sizes, tiles with image and tile offsets, a comment, PLT),
    libopenjp2's encoder by `openjpeg` (each code-block style, SOP/EPH, ROI,
    POC, 4:2:0 and mixed subsampling, 12 and 4 bits, tile-parts, TLM),
    marker surgery (PPT and PPM headers by `j2k_headers_apart`, COC and QCC,
    derived quantisation with 3 guard bits, CRG, PLM, a COC that mixes the
    MCT's transforms) and JP2 boxes by
    `jp2_file` (sYCC, CMYK, ICC, palettes of P and PA with a repeated
    colour, cdef, a 64-bit box length), and ICNS with ic08 and ic09 JPEG
    2000 entries. Two are the chip-smoke scenes' textures: textured's 32x32
    as an irreversible JP2, cubes' 64x64 squares as a lossless tiled J2K.
    FITS at each BITPIX, NAXIS 1 and GZIP_1 (in one header; the tests
    write the two-HDU form, over 4 KB). PNG files PIL reads though a
    CRC is bad (IDAT, IEND), IEND is missing or the file ends after IDAT."""
    from relativitypathtracer_tpu_torch.utils.demo_scene import demo_texture

    def save(im, **kw):
        buf = io.BytesIO()
        im.save(buf, "JPEG2000", **kw)
        return buf.getvalue()

    files = {}
    j2k = {"no_jp2": True}
    pic = lambda h, w: Image.fromarray(_picture(rng, h, w))  # noqa: E731
    # the chip-smoke scenes' textures
    files["blob_irrev.jp2"] = save(Image.fromarray(demo_texture(32)), irreversible=True, mct=1,
                                   quality_layers=[2.2])
    square = (np.add.outer(np.arange(64) // 8 * 3, np.arange(64) // 8 * 5) % 6)
    colours = rng.integers(30, 225, (6, 3)).astype(np.uint8)
    files["cubes_lossless.j2k"] = save(Image.fromarray(colours[square]), tile_size=(32, 32), **j2k)
    # PIL's save: modes, transforms, progressions, layers, precincts, blocks, tiles
    files["grey_rev.j2k"] = save(pic(21, 30).convert("L"), **j2k)
    files["grey_irrev.jp2"] = save(pic(17, 23).convert("L"), irreversible=True)
    files["la.jp2"] = save(pic(13, 14).convert("LA"))
    files["rgba_irrev.jp2"] = save(pic(11, 13).convert("RGBA"), irreversible=True, mct=1)
    files["i16.jp2"] = save(Image.fromarray(rng.integers(0, 600, (12, 15)).astype(np.uint16)))
    files["signed.j2k"] = save(pic(12, 16), signed=True, **j2k)
    for order in ("RLCP", "RPCL", "PCRL", "CPRL"):
        files[f"{order.lower()}.j2k"] = save(pic(19, 22), progression=order, mct=1,
                                             precinct_size=(16, 16), num_resolutions=3,
                                             quality_layers=[20, 5], **j2k)
    files["layers_irrev.j2k"] = save(pic(30, 27), irreversible=True, mct=1,
                                     quality_layers=[40, 12, 4], **j2k)
    files["blocks.j2k"] = save(pic(20, 36), codeblock_size=(8, 16), precinct_size=(32, 32),
                               num_resolutions=3, quality_layers=[8], **j2k)
    files["offsets.j2k"] = save(pic(23, 29), offset=(7, 5), tile_offset=(3, 2), tile_size=(16, 12),
                                num_resolutions=2, quality_layers=[6], **j2k)
    files["comment_plt.j2k"] = save(pic(14, 17), comment="a texture", plt=True,
                                    quality_layers=[5], **j2k)
    # libopenjp2's encoder: code-block styles, SOP/EPH, ROI, POC, subsampling, precision

    def planes(h, w, n=3, bits=8):
        y, x = np.mgrid[0:h, 0:w]
        return [(x * (5 + 2 * k) + y * (3 + k) + rng.integers(0, 1 << (bits - 3), (h, w)))
                % (1 << bits) for k in range(n)]

    rgb = planes(24, 26)
    for name, mode in (("bypass", 1), ("reset", 2), ("termall", 4), ("vsc", 8), ("pterm", 16),
                       ("segsym", 32)):
        files[f"style_{name}.j2k"] = openjpeg(rgb, mode=mode, numresolution=3, rates=[3], mct=True)
    files["styles_irrev.j2k"] = openjpeg(planes(16, 18), mode=63, irreversible=1, numresolution=3,
                                         rates=[6, 2], mct=True)
    files["sop_eph.j2k"] = openjpeg(planes(16, 20), csty=6, numresolution=3, rates=[8, 3],
                                    precincts=[(16, 16), (8, 8)], mct=True)
    files["roi.j2k"] = openjpeg(planes(18, 20), roi_compno=0, roi_shift=6, numresolution=3,
                                rates=[5], mct=True)
    files["poc.j2k"] = openjpeg(planes(18, 21), numresolution=3, rates=[12, 4, 2], mct=True,
                                pocs=[(0, 0, 1, 2, 3, 1), (0, 0, 3, 3, 3, 4)])
    y = planes(20, 22, 1)[0]
    files["sub420.j2k"] = openjpeg([y, planes(10, 11, 1)[0], planes(10, 11, 1)[0]], dx=[1, 2, 2],
                                   dy=[1, 2, 2], numresolution=2, rates=[4])
    files["sub_mixed.jp2"] = jp2_file(openjpeg(
        [planes(15, 17, 1)[0], planes(15, 9, 1)[0], planes(5, 17, 1)[0]], dx=[1, 2, 1],
        dy=[1, 1, 3], offset=(3, 1), numresolution=2, rates=[4]), 17, 15, 3)
    files["prec12.j2k"] = openjpeg(planes(13, 17, 1, 12), prec=12, numresolution=2)
    files["prec4_signed.j2k"] = openjpeg([p - 8 for p in planes(12, 14, 3, 4)], prec=4, sgnd=True,
                                         numresolution=2)
    files["tile_parts.j2k"] = openjpeg(planes(20, 24), tiles=((16, 16), (0, 0)), tile_parts="R",
                                       numresolution=2, rates=[6], mct=True)
    files["tlm.j2k"] = openjpeg(planes(14, 15), extra=["TLM=YES", "PLT=YES"], numresolution=2,
                                rates=[4], mct=True)
    # marker surgery: PPT, PPM, COC, QCC, derived quantisation, CRG, PLM
    sop_eph = openjpeg(planes(18, 20), csty=6, numresolution=3, rates=[10, 3], mct=True,
                       tiles=((16, 16), (0, 0)))
    files["ppt.j2k"] = j2k_headers_apart(sop_eph, "ppt")
    files["ppm.j2k"] = j2k_headers_apart(sop_eph, "ppm")
    irrev = openjpeg(planes(16, 17), irreversible=1, numresolution=2, rates=[5], mct=True)
    main, _ = j2k_split(irrev)
    cod = next(m for m in main if m[:2] == b"\xff\x52")
    qcd = next(m for m in main if m[:2] == b"\xff\x5c")
    spcod = cod[9:]  # after Scod, the progression, layers and MCT
    coc = j2k_marker(0xFF53, bytes([1, 0]) + spcod[:3] + bytes([spcod[3] ^ 16]) + spcod[4:])
    steps = bytearray(qcd[5:])
    steps[1::2] = bytes((b + 37) & 0xFF for b in steps[1::2])  # other mantissas
    qcc = j2k_marker(0xFF5D, bytes([2, qcd[4]]) + bytes(steps))
    files["coc_qcc.j2k"] = j2k_with_main(irrev, coc, qcc)
    derived = j2k_marker(0xFF5C, bytes([(3 << 5) | 1]) + qcd[5:7])
    files["derived_guard3.j2k"] = j2k_with_main(irrev, derived, replace=0xFF5C)
    crg = j2k_marker(0xFF63, struct.pack(">6H", 0, 0, 32768, 0, 0, 32768))
    plm = j2k_marker(0xFF57, bytes([0, 2, 0x81, 0x05]))
    files["crg_plm.j2k"] = j2k_with_main(irrev, crg, plm)
    # JP2 boxes
    cs3 = openjpeg(planes(12, 14), numresolution=2, rates=[3])
    cs4 = openjpeg(planes(12, 14, 4), numresolution=2, rates=[3])
    files["sycc.jp2"] = jp2_file(cs3, 14, 12, 3, colr=18)
    files["cmyk.jp2"] = jp2_file(cs4, 14, 12, 4, colr=12)
    files["icc.jp2"] = jp2_file(cs3, 14, 12, 3, colr=bytes([2, 0, 0]) + bytes(128))
    entries = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(7)]
    entries[4] = entries[1]  # PIL keeps each colour once: later indices shift
    index = openjpeg([rng.integers(0, 8, (10, 13))], numresolution=2)
    files["palette.jp2"] = jp2_file(index, 13, 10, 1, colr=16, extra=jp2_palette(entries))
    index_alpha = openjpeg([rng.integers(0, 8, (10, 13)), rng.integers(0, 256, (10, 13))],
                           numresolution=2)
    files["palette_alpha.jp2"] = jp2_file(index_alpha, 13, 10, 2, colr=16,
                                          extra=jp2_palette([e + (200,) for e in entries]))
    cdef = jp2_box(b"cdef", struct.pack(">H", 3) + b"".join(struct.pack(">3H", i, 0, 3 - i)
                                                            for i in range(3)))
    files["cdef.jp2"] = jp2_file(cs3, 14, 12, 3, extra=cdef)
    xl = jp2_file(cs3, 14, 12, 3)
    xl = xl[:xl.index(b"jp2c") - 4] + struct.pack(">I4sQ", 1, b"jp2c", 16 + len(cs3)) + cs3
    files["xl_box.jp2"] = xl
    # ICNS with JPEG 2000 entries (ic08: 256x256; ic09: 512x512, beside an ic08)
    ramp = np.add.outer(np.arange(512), np.arange(512)) // 4

    def smooth(side):
        r = ramp[:side, :side].astype(np.uint8)
        return Image.fromarray(np.stack([r, r.T, 255 - r], -1))

    files["ic08.icns"] = icns_file([(b"ic08", save(smooth(256), quality_layers=[400], **j2k))])
    files["ic09.icns"] = icns_file([(b"ic08", save(smooth(256), quality_layers=[400], **j2k)),
                                    (b"ic09", save(smooth(512), quality_layers=[1500]))])
    # FITS
    files["u8.fits"] = fits_file(_picture(rng, 19, 23)[..., 0], 8)
    files["i16.fits"] = fits_file(rng.integers(-200, 900, (14, 17)), 16)
    files["i32.fits"] = fits_file(rng.integers(-70000, 70000, (13, 11)), 32)
    floats = rng.normal(120, 90, (12, 15))
    floats[0, :3] = (np.nan, np.inf, -np.inf)
    files["f32.fits"] = fits_file(floats, -32)
    files["f64.fits"] = fits_file(rng.normal(100, 80, (9, 14)), -64)
    files["naxis1.fits"] = fits_file(rng.integers(0, 256, 37), 8, naxis=1)
    files["gzip16.fits"] = fits_gzip(rng.integers(0, 700, (15, 18)), 16, primary=False)
    # PNG: what PIL reads though a CRC is bad, IEND is missing, or the file ends
    png = io.BytesIO()
    Image.fromarray(_picture(rng, 17, 21)).save(png, "PNG")
    png = png.getvalue()
    files["bad_idat_crc.png"] = png_bad_crc(png, b"IDAT")
    files["bad_iend_crc.png"] = png_bad_crc(png, b"IEND")
    files["no_iend.png"] = png[:-12]
    files["cut_after_idat.png"] = png[:-14]
    files["after_iend.png"] = png + struct.pack(">I", 3) + b"tEXt" + b"abc" + bytes(2)
    # a COC giving the MCT's second component the 5/3 transform in a 9/7
    # file: OpenJPEG reads its integers as floats (PIL's pixels, not noise)
    mixed = openjpeg(planes(13, 15), irreversible=1, numresolution=2, rates=[3], mct=True)
    spcod = next(m for m in j2k_split(mixed)[0] if m[:2] == b"\xff\x52")[9:]
    files["mixed_transforms.j2k"] = j2k_with_main(mixed, j2k_marker(
        0xFF53, bytes([1, 0]) + spcod[:4] + bytes([1]) + spcod[5:]))
    return files


# ---------------------------------------------------------------------------
# FLI/FLC, IM, IMT, GBR, McIdas, PIXAR, SPIDER, XVThumb, IPTC and PCD


def fli_chunk(kind: int, body: bytes) -> bytes:
    """An FLI sub-chunk: its size (header included), its type, its body."""
    return struct.pack("<IH", 6 + len(body), kind) + body


def fli_file(width: int, height: int, chunks, *, magic: int = 0xAF12, flags: int = 0,
             frames: int = 1, prefix: bytes = b"", frame_size=None, tail: bytes = b"") -> bytes:
    """An FLI (magic 0xAF11) or FLC (0xAF12) file of one frame whose
    sub-chunks are `chunks` (bytes from fli_chunk), after an optional
    prefix chunk (0xF100) of body `prefix`; `frame_size` overrides the
    frame's size field."""
    frame = b"".join(chunks)
    size = 16 + len(frame) if frame_size is None else frame_size
    body = struct.pack("<IHH8x", size, 0xF1FA, len(chunks)) + frame
    if prefix:
        body = struct.pack("<IH", 6 + len(prefix), 0xF100) + prefix + body
    head = struct.pack("<IHHHHHHI", 128 + len(body), magic, frames, width, height, 8, flags, 70)
    # reserved 20-22 zero; the creator fields (22-42) are not read; 42-80
    # zero; the frame offsets (80-88) are not read; 88-128 zero
    head += bytes(2) + b"created-updated-aspect"[:20] + bytes(38) + b"frm1frm2"
    return head + bytes(128 - len(head)) + body + tail


def fli_palette(colours, shift: int = 0, skip: int = 0) -> bytes:
    """A COLOR_256 (shift 0) or COLOR_64 (shift 2) body: one packet of
    `skip` entries skipped, then the colours (a count of 256 written 0)."""
    c = np.asarray(colours, np.uint8).reshape(-1, 3) >> shift
    return struct.pack("<HBB", 1, skip, len(c) & 255) + c.tobytes()


def fli_brun(idx: np.ndarray) -> bytes:
    """A BRUN body: per row a packet count, then runs of 3 or more equal
    pixels (count, value) and literal copies (256 - count, pixels)."""
    out = bytearray()
    for row in np.asarray(idx, np.uint8):
        packets, x, w = bytearray(), 0, len(row)
        n = 0
        while x < w:
            run = 1
            while x + run < w and run < 127 and row[x + run] == row[x]:
                run += 1
            if run >= 3:
                packets += bytes([run, row[x]])
                x += run
            else:
                lit = 1
                while x + lit < w and lit < 127 and not (
                        x + lit + 2 < w and row[x + lit] == row[x + lit + 1] == row[x + lit + 2]):
                    lit += 1
                packets += bytes([256 - lit]) + row[x:x + lit].tobytes()
                x += lit
            n += 1
        out += bytes([n & 255]) + packets
    return bytes(out)


def fli_lc(idx: np.ndarray, first: int = 0) -> bytes:
    """An LC body over a black image: lines from `first`, each one packet a
    run of its zeros' skip then copies of at most 127 pixels or runs."""
    rows = np.asarray(idx, np.uint8)[first:]
    out = bytearray(struct.pack("<HH", first, len(rows)))
    for row in rows:
        nz = np.nonzero(row)[0]
        x = int(nz[0]) if len(nz) else len(row)
        packets, n, skip = bytearray(), 0, x
        while x < len(row):
            step = min(255, skip)
            if step < skip:
                packets += bytes([step, 0])  # a zero-length copy to skip further
                skip -= step
                n += 1
                continue
            if x + 3 <= len(row) and row[x] == row[x + 1] == row[x + 2]:
                run = 3
                while x + run < len(row) and run < 128 and row[x + run] == row[x]:
                    run += 1
                packets += bytes([skip, 256 - run, row[x]])
            else:
                run = min(127, len(row) - x)
                packets += bytes([skip, run]) + row[x:x + run].tobytes()
            x, skip, n = x + run, 0, n + 1
        out += bytes([n]) + packets
    return bytes(out)


def fli_ss2(idx: np.ndarray, skip_first: int = 0) -> bytes:
    """An SS2 body over a black image: `skip_first` lines skipped by a
    0xC000 word, then each line as word copies (of at most 127 pairs), an
    odd width's last pixel by a 0x8000 word."""
    rows = np.asarray(idx, np.uint8)
    w = rows.shape[1]
    out = bytearray(struct.pack("<H", rows.shape[0] - skip_first))
    for y in range(skip_first, rows.shape[0]):
        row = rows[y]
        words = bytearray()
        if y == skip_first and skip_first:
            words += struct.pack("<H", 65536 - skip_first)
        if w % 2:
            words += struct.pack("<H", 0x8000 | int(row[-1]))
        packets, x, n = bytearray(), 0, 0
        even = w - w % 2
        while x < even:
            pairs = min(127, (even - x) // 2)
            if pairs >= 2 and (row[x:x + 2 * pairs].reshape(-1, 2) == row[x:x + 2]).all():
                packets += bytes([0, 256 - pairs]) + row[x:x + 2].tobytes()
            else:
                packets += bytes([0, pairs]) + row[x:x + 2 * pairs].tobytes()
            x, n = x + 2 * pairs, n + 1
        out += words + struct.pack("<H", n) + packets
    return bytes(out)


def im_file(image_type: str, width: int, height: int, body: bytes, lut: bytes = None,
            lines=(), pad: bool = True, newline: bytes = b"\r\n") -> bytes:
    """An IM file: "Image type" and "Image size" lines (and `lines`), a
    "Lut" line with `lut` after the header, the header padded with NULs to
    511 bytes and a 0x1A (as PIL writes it; `pad` False: the 0x1A at once),
    then `body`."""
    head = [b"Image type: " + image_type.encode(), b"Name: fixture",
            b"Image size (x*y): %d*%d" % (width, height)] + [x.encode() for x in lines]
    if lut is not None:
        head.append(b"Lut: 1")
    text = b"".join(x + newline for x in head)
    text += (bytes(511 - len(text)) if pad else b"") + b"\x1a"
    return text + (lut or b"") + body


def imt_file(width: int, height: int, body: bytes, comments=()) -> bytes:
    """An IM Tools file: comment lines, width, height and pixel n8, a form
    feed, then the rows."""
    head = b"".join(b"*" + c.encode() + b"\n" for c in comments)
    return head + b"width %d\nheight %d\npixel n8\n\x0c" % (width, height) + body


def gbr_file(pixels: np.ndarray, version: int = 2, comment: bytes = b"brush\0") -> bytes:
    """A GIMP brush of (h, w) grey or (h, w, 4) RGBA pixels."""
    h, w = pixels.shape[:2]
    depth = 1 if pixels.ndim == 2 else 4
    extra = b"GIMP" + struct.pack(">I", 25) if version == 2 else b""
    size = 20 + len(extra) + len(comment)
    return (struct.pack(">5I", size, version, w, h, depth) + extra + comment
            + np.ascontiguousarray(pixels, np.uint8).tobytes())


def mcidas_file(samples: np.ndarray, prefix: int = 0, bands: int = 1, offset: int = 256) -> bytes:
    """A McIdas area file of (h, w) samples (uint8, >u2 or >i4), each row
    after `prefix` bytes of line prefix, rows `bands` samples wide apart."""
    h, w = samples.shape
    size = samples.dtype.itemsize
    words = [0] * 64
    words[1] = 4  # the directory's word 2: the area format
    words[8], words[9], words[10], words[13], words[14], words[33] = h, w, size, bands, prefix, \
        offset
    stride = prefix + w * size * bands
    body = bytearray(stride * h)
    raw = np.ascontiguousarray(samples).view(np.uint8).reshape(h, w * size)
    for y in range(h):
        body[y * stride + prefix:y * stride + prefix + w * size] = raw[y].tobytes()
    head = struct.pack(">64i", *words)
    return head + bytes(offset - len(head)) + bytes(body)


def pixar_file(rgb: np.ndarray, mode=(14, 2)) -> bytes:
    """A PIXAR file of (h, w, 3) pixels (raw RGB at 1024)."""
    h, w = rgb.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\0\0"
    struct.pack_into("<6H", head, 416, h, w, 0, 0, *mode)
    return bytes(head) + np.ascontiguousarray(rgb, np.uint8).tobytes()


def spider_file(samples: np.ndarray, order: str = "<", stack: int = 0) -> bytes:
    """A SPIDER image of (h, w) float32 samples in byte order `order`; with
    `stack`, a stack header of that many images, then the first image's own
    header and samples."""
    h, w = samples.shape
    lenbyt = w * 4
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt
    hdr = np.zeros(labbyt // 4, np.float64)
    hdr[[0, 1, 2, 4, 11, 12, 21, 22]] = [1, h, h, 1, w, labrec, labbyt, lenbyt]
    image = hdr.astype(order + "f4").tobytes() + np.asarray(samples, order + "f4").tobytes()
    if not stack:
        return image
    top = hdr.copy()
    top[[23, 25]] = [2, stack]  # istack, maxim
    return top.astype(order + "f4").tobytes() + image


def xv_file(idx: np.ndarray, comments=(b"#XVVERSION:Version 2.28",)) -> bytes:
    """An XV thumbnail of (h, w) 3-3-2 indices."""
    h, w = idx.shape
    return (b"P7 332\n" + b"".join(c + b"\n" for c in comments) + b"#END_OF_COMMENTS\n"
            + b"%d %d 255\n" % (w, h) + np.ascontiguousarray(idx, np.uint8).tobytes())


def iptc_field(record: int, dataset: int, value: bytes, extended: bool = False) -> bytes:
    """One IPTC/NAA field; `extended` writes the size in a 4-byte extended
    length."""
    if extended:
        return bytes([0x1C, record, dataset, 0x84]) + struct.pack(">I", len(value)) + value
    return bytes([0x1C, record, dataset]) + struct.pack(">H", len(value)) + value


def iptc_file(width: int, height: int, layers: int, component: int, data: bytes,
              compression: int = 1, band=None, chunk: int = 0) -> bytes:
    """An IPTC/NAA image: the size, bands ((3, 60)), band ((3, 65)) and
    compression ((3, 120)) fields, then the data as (8, 10) fields of
    `chunk` bytes (one field if 0)."""
    out = iptc_field(1, 90, b"\x1b%G") + iptc_field(2, 5, b"fixture")
    out += iptc_field(3, 20, struct.pack(">H", width))
    out += iptc_field(3, 30, struct.pack(">H", height))
    out += iptc_field(3, 60, bytes([layers, component]))
    if band is not None:
        out += iptc_field(3, 65, bytes([band]))
    out += iptc_field(3, 120, bytes([compression]))
    step = chunk or max(len(data), 1)
    for i in range(0, len(data), step):
        out += iptc_field(8, 10, data[i:i + step], extended=len(data[i:i + step]) > 32767)
    return out + bytes(5)


def pcd_file(ycc_pairs: np.ndarray, orientation: int = 0) -> bytes:
    """A Photo CD file whose base image is (256, 2304) bytes of row pairs
    (two 768-byte luma rows, 384 Cb, 384 Cr); the rest zero."""
    out = bytearray(96 * 2048)
    out[2048:2052] = b"PCD_"
    out[2048 + 1538] = orientation
    return bytes(out) + np.ascontiguousarray(ycc_pairs, np.uint8).tobytes()


def plugin_fixtures(rng, Image) -> dict:
    """The FLI/FLC, IM, IMT, GBR, McIdas, PIXAR, SPIDER, XVThumb, IPTC and
    PCD fixtures, by file name: IM and SPIDER files PIL writes (every IM
    mode PIL saves), and built here: FLI/FLC frames of each chunk kind
    (BRUN, LC, SS2 with skipped lines and an odd width, COPY behind a
    PSTAMP, COLOR_256, COLOR_64 and PIL's grey default), IM of the image
    types PIL does not write (B2 and B4, RGB3, X 24, L 32 F, L 8S, L*12
    through PIL's bit decoder, grey and colour Luts), IMT, GIMP brushes v1
    (L) and v2 (RGBA), McIdas at 1, 2 and 4 bytes a sample with line
    prefixes, PIXAR (14, 2), big-endian and stacked SPIDER, XV thumbnails,
    IPTC raw L, one band of RGB and CMYK, and JPEG, and a Photo CD base
    image turned 90 degrees. One is the chip-smoke scene's texture:
    textured's 32x32 as a line-interleaved RGB IM (`blob_rgb.im`)."""
    from relativitypathtracer_tpu_torch.utils.demo_scene import demo_texture

    def save(im, fmt, **kw):
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        return buf.getvalue()

    files = {}
    pic = _picture(rng, 11, 13)
    rgb = Image.fromarray(pic)
    # IM written by PIL, one file a mode it saves
    files["blob_rgb.im"] = save(Image.fromarray(demo_texture(32)), "IM")
    files["grey.im"] = save(rgb.convert("L"), "IM")
    files["bits.im"] = save(rgb.convert("1"), "IM")
    files["la.im"] = save(rgb.convert("LA"), "IM")
    files["palette_lut.im"] = save(rgb.quantize(21), "IM")
    files["pa_lut.im"] = save(rgb.quantize(9).convert("PA"), "IM")
    files["rgba.im"] = save(rgb.convert("RGBA"), "IM")
    files["rgbx.im"] = save(rgb.convert("RGBX"), "IM")
    files["cmyk.im"] = save(rgb.convert("CMYK"), "IM")
    files["ycc.im"] = save(rgb.convert("YCbCr"), "IM")
    wide = (rng.integers(-400, 700, (7, 9))).astype(np.int32)
    files["i32.im"] = save(Image.fromarray(wide, "I"), "IM")
    files["i16.im"] = save(Image.fromarray(np.abs(wide).astype(np.uint16)), "IM")
    files["i16b.im"] = save(Image.fromarray(np.abs(wide).astype(np.uint16)).convert("I;16B"),
                            "IM")
    files["f32.im"] = save(Image.fromarray(rng.normal(120, 90, (6, 10)).astype(np.float32)), "IM")
    # IM built here: the image types PIL reads and does not write
    idx = rng.integers(0, 256, (5, 12)).astype(np.uint8)
    colour_lut = rng.integers(0, 256, 768, dtype=np.uint8).tobytes()
    files["b2_lut.im"] = im_file("B2 image", 12, 5, idx.tobytes(), lut=colour_lut)
    files["b4.im"] = im_file("B4 image", 12, 5, idx[:, :6].tobytes())
    files["rgb3.im"] = im_file("RGB3 image", 13, 11, pic.transpose(2, 0, 1)[[1, 0, 2]].tobytes())
    files["x24.im"] = im_file("X 24 image", 13, 11, pic[::-1].tobytes())
    files["l32f.im"] = im_file("L 32 F image", 9, 7, wide.astype("<u4").tobytes())
    files["l8s.im"] = im_file("L 8S image", 9, 7, (wide % 256).astype(np.uint8).tobytes())
    files["l12_bits.im"] = im_file("L*12 image", 9, 7, rng.integers(0, 256, 7 * 14,
                                                                    dtype=np.uint8).tobytes())
    files["grey_lut.im"] = im_file("Greyscale image", 13, 11, pic[..., 0].tobytes(),
                                   lut=bytes(255 - np.arange(256, dtype=np.uint8)) * 3,
                                   pad=False, newline=b"\n")
    files["rgb_lut.im"] = im_file("RGB image", 4, 3, pic[:3, :4].transpose(0, 2, 1).tobytes(),
                                  lut=colour_lut)
    files["grey.imt"] = imt_file(13, 11, pic[..., 1].tobytes(), comments=("IM Tools",))
    # FLI/FLC: a frame of each chunk kind over few colours
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    blocks = (np.add.outer(np.arange(13) // 3, np.arange(23) // 4) % 7).astype(np.uint8)
    blocks[5] = rng.integers(0, 7, 23)
    files["brun.flc"] = fli_file(23, 13, [fli_chunk(4, fli_palette(pal[:40])),
                                          fli_chunk(15, fli_brun(blocks))])
    files["color64_lc.fli"] = fli_file(23, 13, [fli_chunk(11, fli_palette(pal[:64], 2, 2)),
                                                fli_chunk(13, b""),
                                                fli_chunk(12, fli_lc(blocks, 4))],
                                       magic=0xAF11)
    files["ss2_odd.flc"] = fli_file(17, 9, [fli_chunk(4, fli_palette(pal)),
                                            fli_chunk(7, fli_ss2(blocks[:9, :17], 2))])
    files["copy_grey.flc"] = fli_file(12, 6, [fli_chunk(18, bytes(20)),
                                              fli_chunk(16, rng.integers(0, 256, 72, dtype=np.uint8)
                                                        .tobytes())], flags=3)
    # GIMP brushes, McIdas, PIXAR, SPIDER, XVThumb
    files["grey_v1.gbr"] = gbr_file(pic[..., 2], version=1)
    files["rgba_v2.gbr"] = gbr_file(np.concatenate([pic, pic[..., :1]], 2), version=2)
    files["l_prefix.area"] = mcidas_file(pic[..., 0], prefix=4)
    files["i16_bands.area"] = mcidas_file(np.abs(wide).astype(">u2"), bands=2)
    files["i32.area"] = mcidas_file(wide.astype(">i4"), offset=300)
    files["rgb.pxr"] = pixar_file(pic)
    f = rng.normal(120, 90, (9, 14)).astype(np.float32)
    files["float.spi"] = save(Image.fromarray(f), "SPIDER")
    files["big_endian.spi"] = spider_file(f[:7, :10], ">")
    files["stack.spi"] = spider_file(f[:5, :8], "<", stack=3)
    files["thumb.xv"] = xv_file(rng.integers(0, 256, (10, 14)))
    # IPTC/NAA: raw L, one band of RGB and CMYK, greyscale and colour JPEG
    files["raw_l.iim"] = iptc_file(13, 11, 1, 0, pic[..., 0].tobytes(), chunk=40)
    files["raw_rgb_band2.iim"] = iptc_file(13, 11, 3, 1, pic[..., 1].tobytes(), band=2)
    files["raw_cmyk_band4.iim"] = iptc_file(13, 11, 4, 1, pic[..., 2].tobytes(), band=4)
    files["jpeg_l.iim"] = iptc_file(13, 11, 1, 0, save(rgb.convert("L"), "JPEG"), 5)
    files["jpeg_rgb.iim"] = iptc_file(13, 11, 1, 0, save(rgb, "JPEG", quality=90), 5, chunk=300)
    # a Photo CD base image, turned 90 degrees: flat, one patterned band
    pairs = np.full((256, 3 * 768), 128, np.uint8)
    pairs[100:120, :1536] = np.tile(np.arange(0, 256, 2, dtype=np.uint8), 12)[:1536]
    pairs[100:120, 1536:] = (np.arange(768) * 3 % 256).astype(np.uint8)
    files["rotated.pcd"] = pcd_file(pairs, orientation=1)
    return files


def rare_fixtures(rng, Image) -> dict:
    """PIL's own PNM kinds (P0CMYK, PyCMYK at 16 bits, PyRGBA, PyP, Pf in
    either byte order) and TIFF's rare kinds, by file name: written by PIL
    (BigTIFF, float raw and with predictor 3, CIELab raw and LZMA, LZMA with
    predictor 2, ZSTD with predictors 2 and 3, Group 4) and built here
    (BigTIFF with LONG8 offsets in
    tiles, big-endian float under LZW, CCITT RLE, Group 3 1D and 2D with
    fill order 2 and min-is-white, a Group 4 row wider than the make-up
    codes' 2560, old-style LZW, YCbCr 2x2 and 2x1 subsampled under LZW and
    Deflate tiles, uncompressed YCbCr as PIL misreads it, a planar palette,
    compressed planar RGBA without ExtraSamples). One is the chip-smoke
    scene's texture: cubes' 256x256 squares as a Group 4 TIFF
    (`cubes_g4.tif`)."""

    def save(im, fmt, **kw):
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        return buf.getvalue()

    files = {}
    pic = _picture(rng, 9, 13)
    cmyk = rng.integers(0, 256, (7, 10, 4)).astype(np.uint8)
    files["p0cmyk.pnm"] = b"P0CMYK\n10 7\n255\n" + cmyk.tobytes()
    files["pycmyk_16bit.pnm"] = b"PyCMYK 6 5 1000\n" + rng.integers(
        0, 1001, (5, 6, 4)).astype(">u2").tobytes()
    files["pyrgba.pnm"] = b"PyRGBA\n# alpha\n10 7 255\n" + cmyk.tobytes()
    files["pyp.pnm"] = b"PyP 13 9 255\n" + pic[..., 0].tobytes()
    floats = (rng.normal(120, 90, (9, 13)) * [[1.0] * 12 + [1e6]]).astype(np.float32)
    files["float_le.pfm"] = save(Image.fromarray(floats), "PPM")
    files["float_be.pfm"] = b"Pf\n13 9\n2.5\n" + floats[::-1].astype(">f4").tobytes()
    rgb = Image.fromarray(pic)
    f = Image.fromarray(floats)
    files["bigtiff_lzw.tif"] = save(rgb, "TIFF", compression="tiff_lzw", big_tiff=True)
    files["bigtiff_long8_tiles.tif"] = tiff_file(pic, 8, 2, comp=8, tile=(16, 16), big=True)
    files["float.tif"] = save(f, "TIFF")
    files["float_pred3.tif"] = save(f, "TIFF", compression="tiff_adobe_deflate",
                                    tiffinfo={317: 3})
    files["float_be_lzw.tif"] = tiff_file(floats.view(np.uint32)[..., None], 32, 1, comp=5,
                                          endian=">", sample_format=(3,))
    files["lab.tif"] = save(rgb.convert("LAB"), "TIFF")
    files["lab_lzma.tif"] = save(rgb.convert("LAB"), "TIFF", compression="lzma")
    files["lzma_pred2.tif"] = save(rgb, "TIFF", compression="lzma", tiffinfo={317: 2})
    files["zstd.tif"] = save(rgb, "TIFF", compression="zstd")
    files["zstd_pred2_strips.tif"] = save(Image.fromarray(_picture(rng, 40, 30)), "TIFF",
                                          compression="zstd", tiffinfo={317: 2, 278: 16})
    files["zstd_float.tif"] = save(f, "TIFF", compression="zstd", tiffinfo={317: 3})
    ink = (_picture(rng, 20, 45)[..., 0] < 100)
    files["ccitt_rle.tif"] = ccitt_tiff(ink, 2, Image, rows_per_strip=8)
    files["g3_1d.tif"] = ccitt_tiff(ink, 3, Image, photo=1)
    files["g3_2d_fill.tif"] = ccitt_tiff(ink, 3, Image, t4=5, fill=2, rows_per_strip=7)
    files["g4.tif"] = save(Image.fromarray(~ink).convert("1"), "TIFF", compression="group4")
    wide = np.zeros((3, 2700), bool)
    wide[0, 5:2690] = True
    wide[1, 2600:] = True
    wide[2, ::977] = True
    files["g4_wide.tif"] = ccitt_tiff(wide, 4, Image)
    files["old_lzw.tif"] = tiff_file(pic // 32 * 32, 8, 2, comp=5, codec=lzw_tiff_old,
                                     rows_per_strip=4)
    ycc = np.asarray(rgb.convert("YCbCr"))
    files["ycbcr_22_lzw.tif"] = ycbcr_tiff(ycc, (2, 2), 5, rows_per_strip=4)
    files["ycbcr_21_tiles.tif"] = ycbcr_tiff(ycc, (2, 1), 8, tile=(16, 16))
    files["ycbcr_raw.tif"] = tiff_file(ycc[:4, :5], 8, 6)
    files["planar_palette.tif"] = tiff_file(
        pic[..., :1], 8, 3, comp=8, planar=2, colormap=rng.integers(0, 65536, 768).tolist())
    files["planar_rgba_deflate.tif"] = tiff_file(
        np.concatenate([pic, 40 + pic[..., :1] // 2], 2), 8, 2, comp=8, planar=2)
    # the cubes scene's texture: 256x256 squares, bilevel, Group 4
    squares = (np.add.outer(np.arange(256) // 32, np.arange(256) // 32) % 2).astype(bool)
    files["cubes_g4.tif"] = ccitt_tiff(squares, 4, Image)
    return files


def main() -> None:
    from PIL import Image, features

    sys.path.insert(0, str(HERE.parents[1]))  # the port's demo texture and JPEG tables

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
    files.update(new_formats(np.random.default_rng(SEED + 1), Image))
    files.update(webp_fixtures(np.random.default_rng(SEED + 2), Image))
    files.update(smoothed_jpegs(np.random.default_rng(SEED + 3), Image))
    files.update({name: pair[0] for name, pair in arith_sources(np.random.default_rng(SEED + 4),
                                                                Image).items()})
    files.update(tiff_jpegs(np.random.default_rng(SEED + 5), Image))
    files.update(block_fixtures(np.random.default_rng(SEED + 6), Image))
    files.update(legacy_fixtures(np.random.default_rng(SEED + 7), Image))
    files.update(j2k_fixtures(np.random.default_rng(SEED + 8), Image))
    files.update(plugin_fixtures(np.random.default_rng(SEED + 9), Image))
    files.update(rare_fixtures(np.random.default_rng(SEED + 10), Image))
    record = {"pillow": features.version("pil"), "libjpeg_turbo": features.version("libjpeg_turbo"),
              "libwebp": features.version("webp"), "openjpeg": features.version("jpg_2000"),
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
