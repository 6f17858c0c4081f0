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
and fill order 2. The builders (`bmp_file`, `tga_file`, `gif_file`,
`tiff_file`, `jpeg_sampled` and their encoders) serve the tests too.
pil_rgb.json holds each file's shape and the SHA-256 of
`Image.open(f).convert("RGB")`'s bytes, with the Pillow and libjpeg-turbo
versions that made them; the tests and chip_smoke.py's textures phase hold
the port's decoders to those hashes.
"""

from __future__ import annotations

import hashlib
import io
import json
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
               32773: packbits}
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def tiff_file(samples: np.ndarray, bits: int, photo: int, comp: int = 1, planar: int = 1,
              tile=None, rows_per_strip=None, endian: str = "<", extra=(), colormap=None,
              predictor: int = 1, fill: int = 1, sample_format=None, orientation=None) -> bytes:
    """A one-page TIFF of (h, w, n) sample values at `bits` bits: strips of
    rows_per_strip rows or tiles of tile=(w, h), chunky or planar, any of
    TIFF_CODECS, horizontal differencing (predictor 2), fill order 2 (every
    stored byte's bits reversed)."""
    h, w, n = samples.shape

    def rows_bytes(block):
        r, c, k = block.shape
        v = block.astype(np.int64)
        if predictor == 2:
            v = np.concatenate([v[:, :1], np.diff(v, axis=1)], 1) % (1 << bits)
        if bits >= 8:
            return v.astype(endian + ("u2" if bits == 16 else "u1")).tobytes()
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
    stored = [TIFF_CODECS[comp](c) for c in chunks]
    if fill == 2:
        stored = [_REVERSE[np.frombuffer(c, np.uint8)].tobytes() for c in stored]
    body, offsets = bytearray((b"II*\0" if endian == "<" else b"MM\0*") + bytes(4)), []
    for c in stored:
        offsets.append(len(body))
        body += c + b"\0" * (len(c) % 2)
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
    counts = [len(c) for c in stored]
    tags += ([(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 4, offsets), (325, 4, counts)]
             if tile else [(273, 4, offsets), (278, 4, [rows_per_strip or h]),
                           (279, 4, counts)])
    entries = []
    for tag, kind, values in sorted(tags):
        raw = struct.pack(endian + {3: "H", 4: "L"}[kind] * len(values), *values)
        if len(raw) > 4:
            at = len(body)
            body += raw + b"\0" * (len(raw) % 2)
            raw = struct.pack(endian + "L", at)
        entries.append(struct.pack(endian + "HHL", tag, kind, len(values)) + raw.ljust(4, b"\0"))
    at = len(body)
    body += struct.pack(endian + "H", len(entries)) + b"".join(entries) + bytes(4)
    body[4:8] = struct.pack(endian + "L", at)
    return bytes(body)


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
