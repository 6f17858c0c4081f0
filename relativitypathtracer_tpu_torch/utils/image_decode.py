"""Texture decoding in numpy and the standard library: JPEG and PNG.

`decode_jpeg` and `decode_png` return the (H, W, 3) uint8 pixels, top row
first, that PIL's `Image.open(f).convert("RGB")` gives for the same file,
byte for byte. No codec library is needed, so textures load on a host
without one.

JPEG follows libjpeg (the library behind PIL and the reference's CImg) with
its default decompression settings: baseline, extended (8-bit) and
progressive frames, Huffman- or arithmetic-coded (utils/jpeg_arith, with
the DAC segment's conditioning), of 1, 3 or 4 components with sampling
factors of 1 to 4; the colour space libjpeg infers (greyscale, YCbCr, RGB
under Adobe's transform 0 or components named 'R', 'G', 'B', CMYK, or YCCK
under Adobe's transform 2, which PIL reads as Adobe's inverted CMYK and
converts with utils/pil_modes); the accurate integer inverse DCT
(jidctint.c `jpeg_idct_islow`); fancy (triangle-filter) upsampling by 2 and
replication by 3 or 4 (jdsample.c); the fixed-point YCbCr to RGB tables
(jdcolor.c); the block smoothing of a progressive file whose scans leave
coefficient bits unsent (jdcoefct.c `decompress_smooth_data`). The inverse
DCT saturates out-of-range values as libjpeg-turbo's SIMD code, which PIL
runs, does. The entropy
decode is the one sequential part, a Python loop over symbols (a 16-bit
peek into a lookup table a symbol) or over the arithmetic coder's binary
decisions; every step after it is vectorised over all blocks of a
component. `read_tables` and `decode_jpeg_samples` decode the abbreviated
streams of JPEG-in-TIFF (tables in one stream, the image in others) with
the colour space the caller sets, and `decode_jpeg_planes` gives
libjpeg's raw (not upsampled) component planes.

PIL reads a file 64 KB at a time and libjpeg's arithmetic decoder cannot
wait for more, so PIL fails on an arithmetic-coded file whose scan runs
past its first read; this module decodes it, to the pixels PIL gives when
handed the whole file at once.

PNG: every colour type and bit depth, Adam7 interlace, the five filters
(undone along the image's anti-diagonals, so Average and Paeth, which read
the reconstructed pixel to the left, run vectorised too), the chunks read
as PIL reads them (`decode_png`: CRCs checked before the image data only;
the file may end, or IEND be missing, after the image data). 16-bit
samples keep their high byte, except 16-bit grey, which is clipped at 255
as PIL's `I;16` to RGB conversion clips it (utils/pil_modes).

What neither decoder supports raises `DecodeError`, as does corrupt or
truncated data; nothing returns a partial image.
"""

from __future__ import annotations

import array
import re
import struct
import zlib

import numpy as np

from . import jpeg_arith
from .image import ZIGZAG, _huffman_codes
from .pil_modes import cmyk_to_rgb, palette256, scale_bits, to_rgb


class DecodeError(ValueError):
    pass


class Unidentified(DecodeError):
    """A file that the format's PIL plugin does not take: its `_open` fails
    where PIL's Image.open goes on to its next plugin."""


# PIL refuses images of more pixels (DecompressionBombError past twice
# Image.MAX_IMAGE_PIXELS); so does this module, before allocating them
MAX_PIXELS = 178_956_970


def _check_size(width: int, height: int) -> None:
    if width * height > MAX_PIXELS:
        raise DecodeError(f"{width}x{height} is more pixels than {MAX_PIXELS:,}")


# ---------------------------------------------------------------------------
# JPEG

# the frames decoded here: baseline, extended and progressive, Huffman- or
# arithmetic-coded; and the others' names
_SOF_DECODED = {0xC0, 0xC1, 0xC2, 0xC9, 0xCA}
_SOF_KINDS = {0xC3: "lossless", 0xC5: "differential sequential", 0xC6: "differential progressive",
              0xC7: "differential lossless", 0xCB: "arithmetic-coded lossless",
              0xCD: "arithmetic-coded differential sequential",
              0xCE: "arithmetic-coded differential progressive",
              0xCF: "arithmetic-coded differential lossless"}
# markers with no segment after them, and those libjpeg skips
_STANDALONE = {0x01} | set(range(0xD0, 0xD8))
_SKIPPED = {0xDC, 0xFE} | set(range(0xE0, 0xF0))


def _huffman_lut(counts: bytes, symbols: bytes, dc: bool) -> list:
    """The decoding table of a DHT table: for each 16-bit peek, the tuple of
    the code it starts with, or None where no code matches. The code's
    symbol gives a run r (AC: the high nibble) and a size s (the low
    nibble; a DC symbol is its size); s bits of value follow the code.
    DC: (bits, mask, half); AC: (bits, run, mask, half), with bits the
    code's length plus s, mask 2**s - 1 and half 2**(s - 1) (0 if s is
    0). A ZRL (r 15, s 0) has run 16; an EOBr (s 0) has run r."""
    n = sum(counts)
    if n > 256 or len(symbols) != n:
        raise DecodeError("bad Huffman table (DHT)")
    if dc and any(x > 15 for x in symbols):
        raise DecodeError("bad Huffman table (DHT): DC symbol above 15")
    code_of, len_of = _huffman_codes((list(counts), list(symbols)))
    lut = [None] * 65536
    for x in set(symbols):
        code, bits = int(code_of[x]), int(len_of[x])
        if code >= 1 << bits:
            raise DecodeError("bad Huffman table (DHT): code lengths overflow")
        size = x if dc else x & 15
        entry = (bits + size, (1 << size) - 1, (1 << size) >> 1)
        if not dc:
            entry = (entry[0], 16 if x == 0xF0 else x >> 4) + entry[1:]
        lo = code << (16 - bits)
        lut[lo:lo + (1 << (16 - bits))] = [entry] * (1 << (16 - bits))
    return lut


class _Frame:
    """A SOF segment: size, precision, components (id, h, v, quantiser
    table id), progressive or not, arithmetic- or Huffman-coded and, per
    component, its size in samples and in blocks."""

    def __init__(self, marker: int, body: bytes):
        if len(body) < 6:
            raise DecodeError("short SOF segment")
        self.progressive = marker in (0xC2, 0xCA)
        self.arith = marker in (0xC9, 0xCA)
        precision, self.height, self.width, nf = struct.unpack(">BHHB", body[:6])
        if precision != 8:
            raise DecodeError(f"{precision}-bit precision is not supported (SOF)")
        if self.height == 0 or self.width == 0:
            raise DecodeError(f"empty image {self.width}x{self.height} (SOF; DNL not supported)")
        _check_size(self.width, self.height)
        if nf not in (1, 3, 4):  # PIL opens no other count
            raise DecodeError(f"{nf} components (SOF): greyscale (1), YCbCr or RGB (3) and "
                              "CMYK or YCCK (4) are supported")
        if len(body) < 6 + 3 * nf:
            raise DecodeError("short SOF segment")
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for i in range(nf):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4):
                raise DecodeError(f"sampling factor {h}x{v} of component {cid} (SOF): "
                                  "1 to 4 are valid")
            if cid in self.ids:
                raise DecodeError(f"component id {cid} twice (SOF)")
            self.ids.append(cid)
            self.h.append(h)
            self.v.append(v)
            self.tq.append(tq)
        self.max_h, self.max_v = max(self.h), max(self.v)
        if any(self.max_h % h or self.max_v % v for h, v in zip(self.h, self.v)):
            raise DecodeError(f"sampling factors {list(zip(self.h, self.v))} (SOF): a "
                              "fractional ratio (libjpeg does not upsample it)")
        self.mcus_x = -(-self.width // (8 * self.max_h))
        self.mcus_y = -(-self.height // (8 * self.max_v))
        # per component: size in samples, block grid padded to whole MCUs
        self.cw = [-(-self.width * h // self.max_h) for h in self.h]
        self.ch = [-(-self.height * v // self.max_v) for v in self.v]
        self.bw = [self.mcus_x * h for h in self.h]
        self.bh = [self.mcus_y * v for v in self.v]

    def scan_blocks(self, comps):
        """(block, comp) of the scan over frame components `comps` in coding
        order, and the blocks an MCU: block is an index into its
        component's padded grid (row-major), comp an index into `comps`.
        A scan of one component codes its blocks in raster order over the
        component's own size; a scan of several codes MCUs in raster
        order, each component's h x v blocks in turn."""
        if len(comps) == 1:
            c = comps[0]
            rows, cols = np.mgrid[0:-(-self.ch[c] // 8), 0:-(-self.cw[c] // 8)]
            blocks = (rows * self.bw[c] + cols).ravel()
            return blocks, np.zeros(blocks.size, np.int64), 1
        my, mx = np.mgrid[0:self.mcus_y, 0:self.mcus_x]
        my, mx = my.reshape(-1, 1), mx.reshape(-1, 1)
        blocks, slots = [], []
        for j, c in enumerate(comps):
            v, h = (a.ravel() for a in np.mgrid[0:self.v[c], 0:self.h[c]])
            blocks.append((my * self.v[c] + v) * self.bw[c] + mx * self.h[c] + h)
            slots.append(np.full(blocks[-1].shape, j))
        per_mcu = sum(b.shape[1] for b in blocks)
        return np.concatenate(blocks, 1).ravel(), np.concatenate(slots, 1).ravel(), per_mcu


def _scan_data(data: bytes, pos: int):
    """The entropy-coded data from `pos` to the next marker other than RSTn:
    (bytes, intervals, end). Stuffed zeros, fill bytes and RSTn markers
    are removed; `intervals` holds each restart interval's (first bit, bit
    past its last) in the bytes left; `end` is the offset of the marker's
    0xFF."""
    if pos >= len(data):
        raise DecodeError("truncated file: no data after SOS")
    buf = np.frombuffer(data, np.uint8, offset=pos)
    ff = np.flatnonzero(buf[:-1] == 0xFF)
    nxt = buf[ff + 1]
    marker = ff[(nxt != 0x00) & (nxt != 0xFF) & ((nxt < 0xD0) | (nxt > 0xD7))]
    if marker.size == 0:
        raise DecodeError("truncated file: no marker after the scan")
    n = int(marker[0])
    rst = ff[(ff < n) & (nxt >= 0xD0) & (nxt <= 0xD7)]
    numbers = buf[rst + 1].astype(np.int64) - 0xD0  # RST0-7 in turn
    if np.any(numbers != np.arange(numbers.size) % 8):
        raise DecodeError("restart markers out of sequence")
    keep = np.ones(n, bool)
    inside = ff[ff < n]
    keep[inside[buf[inside + 1] == 0x00] + 1] = False  # stuffed zeros
    keep[inside[buf[inside + 1] == 0xFF]] = False  # fill bytes
    keep[np.concatenate([rst, rst + 1])] = False
    cuts = np.concatenate([[0], rst + 2, [n]])
    # each interval's start and end in the unstuffed bytes
    before = np.concatenate([[0], np.cumsum(keep)])
    bounds = before[cuts]
    intervals = [(int(a) * 8, int(b) * 8) for a, b in zip(bounds[:-1], bounds[1:])]
    return buf[:n][keep], intervals, pos + n


def _windows(d) -> list:
    """The big-endian 64-bit word at each byte of `d` (zeros past its end),
    as Python ints: a symbol at bit p is read from word p >> 3."""
    d = np.concatenate([d, np.zeros(8, np.uint8)]).astype(np.uint64)
    w = np.zeros(d.size - 7, np.uint64)
    for i in range(8):
        w = (w << np.uint64(8)) | d[i:i + w.size]
    return w.tolist()


def _intervals(nblocks: int, per_interval: int, intervals):
    """Each restart interval's (first block, block past its last, first
    bit, bit past its last)."""
    starts = list(range(0, nblocks, per_interval)) if per_interval else [0]
    if len(starts) != len(intervals):
        raise DecodeError(f"{len(intervals)} restart intervals where {len(starts)} were expected")
    return [(b, min(b + per_interval, nblocks) if per_interval else nblocks, p, e)
            for b, (p, e) in zip(starts, intervals)]


def _decode_sequential(w, spans, bases, slots, tables, coef, nslots):
    """Huffman-decode a sequential scan: each block's DC difference and its
    63 ACs into `coef` (zig-zag order) from `bases[i]` on."""
    for b0, b1, p, end in spans:
        pred = [0] * nslots
        for i in range(b0, b1):
            s = slots[i]
            dc, ac = tables[s]
            x = w[p >> 3]
            b = p & 7
            n, m, h = dc[(x >> (48 - b)) & 65535]
            v = (x >> (64 - b - n)) & m
            if v < h:
                v -= m
            p += n
            v += pred[s]
            pred[s] = v
            j = bases[i]
            coef[j] = v
            j += 1
            stop = j + 63
            while j < stop:
                x = w[p >> 3]
                b = p & 7
                n, r, m, h = ac[(x >> (48 - b)) & 65535]
                p += n
                if m:
                    v = (x >> (64 - b - n)) & m
                    if v < h:
                        v -= m
                    j += r
                    coef[j] = v
                    j += 1
                elif r == 16:
                    j += 16
                else:
                    break
            if j > stop:
                raise DecodeError("corrupt data: coefficients past the block's end")
        if p > end:
            raise DecodeError("corrupt or truncated data: a scan runs past its data")


def _decode_dc_first(w, spans, bases, slots, tables, coef, nslots, al):
    """A progressive DC scan's first pass: each block's DC, shifted by Al."""
    for b0, b1, p, end in spans:
        pred = [0] * nslots
        for i in range(b0, b1):
            s = slots[i]
            x = w[p >> 3]
            b = p & 7
            n, m, h = tables[s][(x >> (48 - b)) & 65535]
            v = (x >> (64 - b - n)) & m
            if v < h:
                v -= m
            p += n
            v += pred[s]
            pred[s] = v
            coef[bases[i]] = v << al
        if p > end:
            raise DecodeError("corrupt or truncated data: a scan runs past its data")


def _decode_ac_first(w, spans, bases, ac, band, ss, se, al):
    """A progressive AC scan's first pass over band Ss..Se of one
    component, with end-of-band runs; `band[bases[i] + k]` is block i's
    coefficient k."""
    for b0, b1, p, end in spans:
        eobrun = 0
        for i in range(b0, b1):
            if eobrun:
                eobrun -= 1
                continue
            j = bases[i] + ss
            stop = j + se - ss + 1
            while j < stop:
                x = w[p >> 3]
                b = p & 7
                n, r, m, h = ac[(x >> (48 - b)) & 65535]
                p += n
                if m:
                    v = (x >> (64 - b - n)) & m
                    if v < h:
                        v -= m
                    j += r
                    band[j] = v << al
                    j += 1
                elif r == 16:
                    j += 16
                else:
                    eobrun = (1 << r) - 1
                    if r:
                        eobrun += (w[p >> 3] >> (64 - (p & 7) - r)) & ((1 << r) - 1)
                        p += r
                    break
            if j > stop:
                raise DecodeError("corrupt data: coefficients past the band's end")
        if p > end:
            raise DecodeError("corrupt or truncated data: a scan runs past its data")


def _decode_ac_refine(w, spans, bases, ac, band, ss, se, al):
    """A progressive AC scan's refinement pass (jdphuff.c
    decode_mcu_AC_refine): newly nonzero coefficients of +-2**Al, and a
    correction bit for each coefficient already nonzero that the scan
    passes."""
    p1, m1 = 1 << al, -1 << al
    for b0, b1, p, end in spans:
        eobrun = 0
        for i in range(b0, b1):
            base = bases[i]
            k = ss
            if not eobrun:
                while k <= se:
                    x = w[p >> 3]
                    b = p & 7
                    n, r, m, h = ac[(x >> (48 - b)) & 65535]
                    p += n
                    if m:
                        if m != 1:
                            raise DecodeError("corrupt data: a refinement value of size > 1")
                        new = p1 if (x >> (64 - b - n)) & 1 else m1
                    elif r == 16:  # ZRL: pass 16 zeros
                        new, r = 0, 15
                    else:
                        eobrun = 1 << r
                        if r:
                            eobrun += (w[p >> 3] >> (64 - (p & 7) - r)) & ((1 << r) - 1)
                            p += r
                        break
                    while k <= se:  # pass the nonzero coefficients and r zeros
                        c = band[base + k]
                        if c:
                            if (w[p >> 3] >> (63 - (p & 7))) & 1 and not c & p1:
                                band[base + k] = c + p1 if c > 0 else c + m1
                            p += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if new:
                        if k > se:
                            raise DecodeError("corrupt data: coefficients past the band's end")
                        band[base + k] = new
                    k += 1
            if eobrun:
                while k <= se:
                    c = band[base + k]
                    if c:
                        if (w[p >> 3] >> (63 - (p & 7))) & 1 and not c & p1:
                            band[base + k] = c + p1 if c > 0 else c + m1
                        p += 1
                    k += 1
                eobrun -= 1
        if p > end:
            raise DecodeError("corrupt or truncated data: a scan runs past its data")


def _idct_1d(d, shift: int):
    """One pass of jpeg_idct_islow (jidctint.c, CONST_BITS 13) over eight
    int64 arrays, descaled by `shift` with rounding."""
    d0, d1, d2, d3, d4, d5, d6, d7 = d
    z1 = (d2 + d6) * 4433  # FIX_0_541196100
    tmp2 = z1 - d6 * 15137  # FIX_1_847759065
    tmp3 = z1 + d2 * 6270  # FIX_0_765366865
    tmp0 = (d0 + d4) << 13
    tmp1 = (d0 - d4) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    z1, z2, z3, z4 = d7 + d1, d5 + d3, d7 + d3, d5 + d1
    z5 = (z3 + z4) * 9633  # FIX_1_175875602
    z1 = z1 * -7373  # FIX_0_899976223
    z2 = z2 * -20995  # FIX_2_562915447
    z3 = z3 * -16069 + z5  # FIX_1_961570560
    z4 = z4 * -3196 + z5  # FIX_0_390180644
    o0 = d7 * 2446 + z1 + z3  # FIX_0_298631336
    o1 = d5 * 16819 + z2 + z4  # FIX_2_053119869
    o2 = d3 * 25172 + z2 + z3  # FIX_3_072711026
    o3 = d1 * 12299 + z1 + z4  # FIX_1_501321110
    r = 1 << (shift - 1)
    return [(t10 + o3 + r) >> shift, (t11 + o2 + r) >> shift, (t12 + o1 + r) >> shift,
            (t13 + o0 + r) >> shift, (t13 - o0 + r) >> shift, (t12 - o1 + r) >> shift,
            (t11 - o2 + r) >> shift, (t10 - o3 + r) >> shift]


_IDCT_CHUNK = 8192  # blocks an IDCT step (bounds the int64 temporaries)


def _idct(coef, q) -> np.ndarray:
    """(n, 64) quantised coefficients in zig-zag order and the (64,) table
    in natural order -> (n, 8, 8) uint8 samples: dequantise, the column
    pass (PASS1_BITS 2), the row pass, the +128 shift and the range limit.
    Both passes saturate as libjpeg-turbo's SIMD form (PIL's) does: the
    column pass's results to int16, the samples to 0-255. On every value
    an 8-bit image gives this is the C code's result; past it the C
    code's range-limit table wraps."""
    out = np.empty((coef.shape[0], 8, 8), np.uint8)
    q = q.reshape(8, 8)
    for i in range(0, coef.shape[0], _IDCT_CHUNK):
        blk = np.empty((min(_IDCT_CHUNK, coef.shape[0] - i), 64), np.int64)
        blk[:, ZIGZAG] = coef[i:i + _IDCT_CHUNK]
        blk = blk.reshape(-1, 8, 8) * q
        # columns: each input row k is vertical frequency k of every column
        ws = np.clip(np.stack(_idct_1d([blk[:, k, :] for k in range(8)], 13 - 2), 1),
                     -32768, 32767)
        # rows: input u is horizontal frequency u of every row; output x column x
        cols = _idct_1d([ws[:, :, u] for u in range(8)], 13 + 2 + 3)
        out[i:i + blk.shape[0]] = np.clip(np.stack(cols, 2) + 128, 0, 255)
    return out


def _edges(p, axis: int):
    """The neighbours of each sample of `p` before and after it along
    `axis`, the edge sample repeated past either end."""
    n = p.shape[axis]
    before = np.take(p, np.r_[0, 0:n - 1], axis)
    after = np.take(p, np.r_[1:n, n - 1], axis)
    return before, after


def _interleave(even, odd, axis: int):
    out = np.stack([even, odd], axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample(p, rh: int, rv: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of a component plane cropped to its own
    size (jdsample.c): h2v2 and h2v1 fancy (box below 3 columns), h1v2
    fancy, each with the edge sample repeated past the plane; any other
    ratio (3 or 4 along an axis) by replication (int_upsample)."""
    p = p.astype(np.int32)
    if rh > 2 or rv > 2 or rh == 2 and p.shape[1] <= 2:  # int_upsample, h2v1/h2v2_upsample
        return np.repeat(np.repeat(p, rh, 1), rv, 0)
    if rv == 2:
        up, down = _edges(p, 0)
        if rh == 1:  # h1v2_fancy_upsample
            return _interleave((3 * p + up + 1) >> 2, (3 * p + down + 2) >> 2, 0)
        p = _interleave(3 * p + up, 3 * p + down, 0)  # h2v2: column sums
        left, right = _edges(p, 1)
        return _interleave((3 * p + left + 8) >> 4, (3 * p + right + 7) >> 4, 1)
    if rh == 2:  # h2v1_fancy_upsample
        left, right = _edges(p, 1)
        return _interleave((3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2, 1)
    return p


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


_CENTRED = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _CENTRED + 32768) >> 16
_CB_B = (_fix(1.77200) * _CENTRED + 32768) >> 16
_CR_G = -_fix(0.71414) * _CENTRED
_CB_G = -_fix(0.34414) * _CENTRED + 32768


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert: the fixed-point tables (SCALEBITS 16)."""
    y = y.astype(np.int64)
    rgb = np.stack([y + _CR_R[cr], y + ((_CB_G[cb] + _CR_G[cr]) >> 16), y + _CB_B[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _color_space(frame, jfif: bool, adobe) -> str:
    """The components' colour space as libjpeg reads it
    (jdapimin.c default_decompression_parms): "grey", "ycc", "rgb", "cmyk"
    or "ycck"."""
    if len(frame.ids) == 1:
        return "grey"
    if len(frame.ids) == 4:  # JFIF does not count; Adobe transform 0 is CMYK, others YCCK
        return "ycck" if adobe not in (None, 0) else "cmyk"
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    return "rgb" if frame.ids == [82, 71, 66] else "ycc"  # ids 'R', 'G', 'B'


class Tables:
    """The tables a JPEG decoder keeps from one stream to the next, as
    libjpeg keeps them in its decompressor: quantisation tables and Huffman
    tables by id. An abbreviated table-specification stream (read_tables)
    fills them for the abbreviated image streams that follow (a JPEG-in-TIFF
    file's strips and tiles); a table an image stream defines replaces the
    one of its id for the streams after it too. Arithmetic conditioning
    (DAC) and the restart interval are not kept: libjpeg resets them at
    each SOI."""

    def __init__(self):
        self.q, self.dc, self.ac = {}, {}, {}


def read_tables(data: bytes, tables: Tables | None = None) -> Tables:
    """The tables of an abbreviated table-specification stream (SOI, DQT
    and DHT segments, EOI), added to `tables` (new ones if None)."""
    tables = Tables() if tables is None else tables
    _read(bytes(data), tables, image=False)
    return tables


def read_frame(data: bytes) -> _Frame:
    """The frame header (SOF) of a JPEG stream, found without decoding a
    scan: its size, components and their sampling factors."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise DecodeError("not a JPEG stream (no SOI)")
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise DecodeError("no marker where a marker segment should start")
        marker = data[pos + 1]
        if marker == 0xFF or marker in _STANDALONE:
            pos += 1 if marker == 0xFF else 2
            continue
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker in _SOF_KINDS:
            raise DecodeError(f"{_SOF_KINDS[marker]} JPEG (SOF{marker - 0xC0}) is not supported")
        if marker in _SOF_DECODED:
            return _Frame(marker, data[pos + 4:end])
        if marker in (0xDA, 0xD9):
            break
        pos = end
    raise DecodeError("no SOF before the first scan")


def decode_jpeg(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a JPEG file, top row first, as PIL's
    `convert("RGB")` of it; raises DecodeError on what is not supported,
    corrupt or truncated."""
    samples, space = decode_jpeg_samples(data)
    if space == "grey":
        return np.repeat(samples, 3, 2)
    if space in ("cmyk", "ycck"):  # PIL reads libjpeg's CMYK as Adobe's inverted CMYK (CMYK;I)
        return cmyk_to_rgb(255 - samples)
    return samples


def decode_jpeg_samples(data: bytes, tables: Tables | None = None, space: str | None = None):
    """(samples, space) of a JPEG stream: the (H, W, n) uint8 samples that
    libjpeg's decompressor outputs, top row first, and the colour space it
    read. `tables` holds the tables of streams read before (read_tables),
    which the stream's own segments update. `space` overrides the colour
    space libjpeg infers from the stream's markers, as a caller that sets
    libjpeg's jpeg_color_space does: "ycc" (converted to RGB) or "raw"
    (JCS_UNKNOWN: the components as decoded, each upsampled to the image's
    size). The samples are, by space: "grey" one channel; "ycc" and "rgb"
    RGB; "cmyk" and "ycck" libjpeg's CMYK (YCCK converted: C, M, Y = 255 -
    the YCC conversion's R, G, B); "raw" one channel a component."""
    frame, planes, inferred = decode_jpeg_planes(data, tables)
    space = space or inferred
    if space == "ycc" and len(frame.ids) != 3:
        raise DecodeError(f"{len(frame.ids)} components where YCbCr has 3")
    planes = [_upsample(p, frame.max_h // h, frame.max_v // v)[:frame.height, :frame.width]
              .astype(np.uint8) for p, h, v in zip(planes, frame.h, frame.v)]
    if space == "ycc":
        return _ycc_to_rgb(*planes), space
    if space == "ycck":  # jdcolor.c ycck_cmyk_convert
        return np.concatenate([255 - _ycc_to_rgb(*planes[:3]), planes[3][..., None]], -1), space
    return np.stack(planes, -1), space


def decode_jpeg_planes(data: bytes, tables: Tables | None = None):
    """(frame, planes, space) of a JPEG stream: each component's samples
    at its own size (its share of the image's, rounded up), as libjpeg's
    raw-data output gives them (block smoothing, inverse DCT, no
    upsampling, no colour conversion), and the colour space libjpeg infers.
    `tables` as for decode_jpeg_samples."""
    frame, coefs, bits, latched, space = _read(bytes(data), Tables() if tables is None
                                               else tables, image=True)
    smooth = frame.progressive and _smoothing_ok(bits, latched)
    planes = []
    for c in range(len(frame.ids)):
        coef = _block_smooth(frame, c, coefs[c], bits[c], latched[c]) if smooth else coefs[c]
        blocks = _idct(coef, latched[c])
        bh, bw = frame.bh[c], frame.bw[c]
        plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        planes.append(plane[:frame.ch[c], :frame.cw[c]])
    return frame, planes, space


def _read(data: bytes, tables: Tables, image: bool):
    """Parse a stream from SOI to EOI and entropy-decode its scans with
    `tables` (updated by its DQT and DHT segments): (frame, coefficients,
    bits, latched quantisation tables, colour space) of an image stream;
    None of a table-specification stream (`image` False), which must hold
    no frame."""
    if data[:2] != b"\xff\xd8":
        raise DecodeError("not a JPEG file (no SOI)")
    qtabs, dc_tabs, ac_tabs = tables.q, tables.dc, tables.ac
    cond = ({}, {})  # DAC: (L, U) of each DC table, Kx of each AC table; reset at SOI
    frame, coefs, latched = None, None, {}
    restart, jfif, adobe, space = 0, False, None, None
    bits = None  # per component: each coefficient's Al after the last scan (-1: never sent)
    pos = 2
    while True:
        # libjpeg's next_marker: skip other bytes, fill bytes, stuffed zeros
        while True:
            i = data.find(b"\xff", pos)
            if i < 0:
                raise DecodeError("truncated file: no EOI")
            pos = i + 1
            while pos < len(data) and data[pos] == 0xFF:
                pos += 1
            if pos >= len(data):
                raise DecodeError("truncated file: no EOI")
            if data[pos] != 0:
                break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if marker in _STANDALONE:
            continue
        if pos + 2 > len(data):
            raise DecodeError("truncated file inside a marker segment")
        length = int.from_bytes(data[pos:pos + 2], "big")
        body = data[pos + 2:pos + length]
        if length < 2 or pos + length > len(data):
            raise DecodeError(f"truncated file inside marker FF{marker:02X}'s segment")
        pos += length
        if marker in _SOF_KINDS:
            raise DecodeError(f"{_SOF_KINDS[marker]} JPEG (SOF{marker - 0xC0}) is not supported")
        if marker in _SOF_DECODED:
            if not image:
                raise DecodeError("a frame (SOF) in a table-specification stream")
            if frame is not None:
                raise DecodeError("two SOF markers")
            frame = _Frame(marker, body)
            coefs = [np.zeros((bh * bw, 64), np.int32) for bh, bw in zip(frame.bh, frame.bw)]
            bits = [[-1] * 64 for _ in frame.ids]
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                if i + 17 > len(body):
                    raise DecodeError("short DHT segment")
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                symbols = body[i + 17:i + 17 + sum(counts)]
                if tc > 1 or th > 3:
                    raise DecodeError(f"bad DHT table class {tc} or id {th}")
                (ac_tabs if tc else dc_tabs)[th] = _huffman_lut(counts, symbols, tc == 0)
                i += 17 + sum(counts)
        elif marker == 0xCC:  # jdmarker.c get_dac
            if len(body) % 2:
                raise DecodeError("bad DAC segment length")
            for index, value in zip(body[::2], body[1::2]):
                if index >= 32:
                    raise DecodeError(f"bad DAC table index {index}")
                if index >= 16:
                    cond[1][index - 16] = value
                elif value & 15 > value >> 4:
                    raise DecodeError(f"bad DAC value {value:#04x}: L above U")
                else:
                    cond[0][index] = (value & 15, value >> 4)
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                size = 128 if pq else 64
                if pq > 1 or tq > 3 or i + 1 + size > len(body):
                    raise DecodeError("bad DQT segment")
                q = np.frombuffer(body, ">u2" if pq else np.uint8, 64, i + 1).astype(np.int64)
                qtabs[tq] = np.empty(64, np.int64)
                qtabs[tq][ZIGZAG] = q
                i += 1 + size
        elif marker == 0xDD:
            if len(body) < 2:
                raise DecodeError("short DRI segment")
            restart = int.from_bytes(body[:2], "big")
        elif marker == 0xE0:
            jfif = jfif or (len(body) >= 14 and body[:5] == b"JFIF\x00")
        elif marker == 0xEE:
            if len(body) >= 12 and body[:5] == b"Adobe":
                adobe = body[11]
        elif marker == 0xDA:
            if frame is None:
                raise DecodeError("a scan (SOS) in a table-specification stream" if not image
                                  else "SOS before SOF")
            if not latched:  # libjpeg reads the colour space up to the first SOS
                space = _color_space(frame, jfif, adobe)
            pos = _decode_scan(data, pos, body, frame, coefs, bits, latched, tables, cond,
                               restart)
        elif marker not in _SKIPPED:
            raise DecodeError(f"unknown marker FF{marker:02X}")
    if not image:
        return None
    if frame is None:
        raise DecodeError("no SOF before EOI")
    for c, cid in enumerate(frame.ids):
        if bits[c][0] < 0:
            raise DecodeError(f"component {cid} has no DC scan")
    return frame, coefs, bits, latched, space


# Block smoothing (libjpeg-turbo's jdcoefct.c decompress_smooth_data): the
# natural-order positions of zig-zag coefficients 1-9, and the estimates of
# each from the 5x5 neighbourhood of DC values DC01-DC25 (row by row, the
# block itself DC13): {DC number: weight}, with all of 1-9 unsent ("change
# DC") and without; "change DC" also re-estimates the DC itself
_SMOOTH_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)
_SMOOTH_CHANGE_DC = (
    {1: -1, 2: -1, 4: 1, 5: 1, 6: -3, 7: 13, 9: -13, 10: 3, 11: -3, 12: 38, 14: -38, 15: 3,
     16: -3, 17: 13, 19: -13, 20: 3, 21: -1, 22: -1, 24: 1, 25: 1},
    {1: -1, 2: -3, 3: -3, 4: -3, 5: -1, 6: -1, 7: 13, 8: 38, 9: 13, 10: -1, 16: 1, 17: -13,
     18: -38, 19: -13, 20: 1, 21: 1, 22: 3, 23: 3, 24: 3, 25: 1},
    {3: 1, 7: 2, 8: 7, 9: 2, 12: -5, 13: -14, 14: -5, 17: 2, 18: 7, 19: 2, 23: 1},
    {1: -1, 5: 1, 7: 9, 9: -9, 17: -9, 19: 9, 21: 1, 25: -1},
    {7: 2, 8: -5, 9: 2, 11: 1, 12: 7, 13: -14, 14: 7, 15: 1, 17: 2, 18: -5, 19: 2},
    {7: 1, 9: -1, 12: 2, 14: -2, 17: 1, 19: -1},
    {7: 1, 8: -3, 9: 1, 17: -1, 18: 3, 19: -1},
    {7: 1, 9: -1, 12: -3, 14: 3, 17: 1, 19: -1},
    {7: 1, 8: 2, 9: 1, 17: -1, 18: -2, 19: -1})
_SMOOTH_KEEP_DC = (
    {11: -7, 12: 50, 14: -50, 15: 7},
    {3: -7, 8: 50, 18: -50, 23: 7},
    {3: -1, 8: 13, 13: -24, 18: 13, 23: -1},
    {10: 1, 16: 1, 17: -10, 19: 10, 2: -1, 20: -1, 22: 1, 24: -1, 4: 1, 6: -1, 7: 10, 9: -10},
    {11: -1, 12: 13, 13: -24, 14: 13, 15: -1})
_SMOOTH_DC = {1: -2, 2: -6, 3: -8, 4: -6, 5: -2, 6: -6, 7: 6, 8: 42, 9: 6, 10: -6, 11: -8,
              12: 42, 13: 152, 14: 42, 15: -8, 16: -6, 17: 6, 18: 42, 19: 6, 20: -6, 21: -2,
              22: -6, 23: -8, 24: -6, 25: -2}


def _smoothing_ok(bits, latched) -> bool:
    """jdcoefct.c smoothing_ok: every component's table nonzero at the DC
    and the first nine ACs, and some component with one of zig-zag
    coefficients 1-9 not fully sent (its last scan's Al above 0, or no
    scan)."""
    if not all(q[[0, *_SMOOTH_POS]].all() for q in latched.values()):
        return False
    return any(b != 0 for cbits in bits for b in cbits[1:10])


def _smooth_rows(frame, c, rows: int) -> list:
    """Each block row's five neighbour rows (two above, itself, two below)
    as decompress_smooth_data picks them: an iMCU row (v block rows) at a
    time, the rows past the image's top and bottom replaced by the nearest
    one it reads. In the last iMCU row libjpeg counts its rows as
    `height_in_blocks % v` a row in every iMCU row, so that with two iMCU
    rows the last one's first row finds no row two above it."""
    v, total = frame.v[c], frame.mcus_y
    out = []
    for r in range(rows):
        m, k = divmod(r, v)
        n = v if m < total - 1 else rows % v or v
        at, count = m * n + k, n * total
        prev = r - 1 if at > 0 else r
        nxt = r + 1 if at < count - 1 else r
        out.append((r - 2 if at > 1 else prev, prev, r, nxt, r + 2 if at < count - 2 else nxt))
    return out


def _smooth_estimate(num, q: int, al: int):
    """A coefficient's estimate from `num` (Q00 times the DC sum), rounded
    away from zero over q * 256, capped below 2**Al when Al > 0."""
    pred = ((q << 7) + np.abs(num)) // (q << 8)
    if al > 0:
        pred = np.minimum(pred, (1 << al) - 1)
    return np.where(num < 0, -pred, pred)


def _block_smooth(frame, c, coef, cbits, q) -> np.ndarray:
    """libjpeg-turbo's interblock smoothing of a progressive component
    whose coefficients 1-9 are not all fully sent (jdcoefct.c
    decompress_smooth_data): each of them still zero and not exact (its
    Al not 0) is estimated from the 5x5 DC neighbourhood (the edge block
    repeated past the image's right and left, rows as _smooth_rows picks
    them) and the quantisation table; where none of 1-9 was sent the DC is
    re-estimated too. `coef` (blocks, 64) zig-zag in; a new array out."""
    rows, cols = -(-frame.ch[c] // 8), -(-frame.cw[c] // 8)
    bw = frame.bw[c]
    grid = coef.reshape(-1, bw, 64)
    dc = grid[:, :, 0].astype(np.int64)
    pick = np.array(_smooth_rows(frame, c, rows))
    near = np.clip(np.arange(cols)[:, None] + np.arange(-2, 3), 0, cols - 1)
    # DC[n]: (rows, cols) of DC value n (1-25) of each block's neighbourhood
    nb = dc[pick[:, :, None, None], near[None, None, :, :]]  # (rows, 5, cols, 5)
    dcs = {5 * i + j + 1: nb[:, i, :, j] for i in range(5) for j in range(5)}
    change_dc = all(b == -1 for b in cbits[1:10])
    forms = _SMOOTH_CHANGE_DC if change_dc else _SMOOTH_KEEP_DC
    out = grid.copy()
    work = out[:rows, :cols]
    q00 = int(q[0])
    for k, form in enumerate(forms, start=1):
        al = cbits[k]
        if al == 0:
            continue
        num = q00 * sum(w * dcs[n] for n, w in form.items())
        est = _smooth_estimate(num, int(q[_SMOOTH_POS[k - 1]]), al)
        work[:, :, k] = np.where(work[:, :, k] == 0, est, work[:, :, k])
    if change_dc:
        num = q00 * sum(w * dcs[n] for n, w in _SMOOTH_DC.items())
        work[:, :, 0] = _smooth_estimate(num, q00, 0)
    return out.reshape(coef.shape)


def _decode_scan(data, pos, body, frame, coefs, bits, latched, tables, cond, restart) -> int:
    """Decode one scan (its SOS header `body`, its data from `pos`) into
    the components' coefficient arrays, with the frame's entropy coding;
    returns the offset of the marker after its data."""
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) < 4 + 2 * ns:
        raise DecodeError("bad SOS segment")
    comps, tabs = [], []
    for j in range(ns):
        cid, t = body[1 + 2 * j:3 + 2 * j]
        if cid not in frame.ids:
            raise DecodeError(f"SOS names component {cid}, which the frame lacks")
        comps.append(frame.ids.index(cid))
        tabs.append((t >> 4, t & 15))
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    if not frame.progressive:
        ss, se, ah, al = 0, 63, 0, 0
    elif ((ss == 0) != (se == 0)) or ss > se or se > 63 or (ss and ns != 1) or al > 13 or (
            ah and al != ah - 1):
        raise DecodeError(f"bad progression parameters Ss {ss} Se {se} Ah {ah} Al {al} (SOS)")
    for c in comps:  # libjpeg latches a component's table at its first scan
        if c not in latched:
            if frame.tq[c] not in tables.q:
                raise DecodeError(f"quantisation table {frame.tq[c]} is not defined (DQT)")
            latched[c] = tables.q[frame.tq[c]]
        for k in range(ss, se + 1):  # jdphuff.c / jdarith.c start_pass
            if ah != max(bits[c][k], 0):
                raise DecodeError(f"bad progression: coefficient {k} of component "
                                  f"{frame.ids[c]} refined out of order (SOS)")
            bits[c][k] = al
        if ss and bits[c][0] < 0:
            raise DecodeError("bad progression: an AC scan before the DC scan (SOS)")
    lut_dc, lut_ac = [], []
    if not frame.arith:
        need_dc = ss == 0 and ah == 0
        for td, ta in tabs:
            if need_dc and td not in tables.dc:
                raise DecodeError(f"DC Huffman table {td} is not defined (DHT)")
            if se > 0 and ta not in tables.ac:
                raise DecodeError(f"AC Huffman table {ta} is not defined (DHT)")
            lut_dc.append(tables.dc.get(td))
            lut_ac.append(tables.ac.get(ta))
    blocks, slots, per_mcu = frame.scan_blocks(comps)
    if per_mcu > 10:
        raise DecodeError(f"{per_mcu} blocks an MCU (SOS): at most 10")
    d, intervals, end = _scan_data(data, pos)
    spans = _intervals(blocks.size, restart * per_mcu, intervals)
    if ah and ss == 0 and not frame.arith:  # Huffman DC refinement: one raw bit a block
        _dc_refine(d, spans, comps, coefs, blocks, slots, al)
        return end
    width = se - ss + 1
    # the scan's band of each of its components, one list, component after
    # component, holding the coefficients so far: as libjpeg's, a scan writes
    # only the coefficients it decodes
    offsets = np.cumsum([0] + [coefs[c].shape[0] * width for c in comps])
    bases = (offsets[slots] + blocks * width - ss).tolist()
    band = array.array("i", np.concatenate(
        [coefs[c][:, ss:se + 1].ravel() for c in comps]).astype(np.int32).tobytes())
    slots_l = slots.tolist()
    if frame.arith:
        jpeg_arith.decode_scan(d, spans, bases, slots_l, band, tabs, frame.progressive, ss, se,
                               ah, al, *cond)
    else:
        _huffman_scan(d, spans, bases, slots_l, band, frame.progressive, ss, se, ah, al, lut_dc,
                      lut_ac, ns)
    band = np.frombuffer(band, np.int32)
    for j, c in enumerate(comps):
        coefs[c][:, ss:se + 1] = band[offsets[j]:offsets[j + 1]].reshape(-1, width)
    return end


def _huffman_scan(d, spans, bases, slots, band, progressive, ss, se, ah, al, lut_dc, lut_ac,
                  ns) -> None:
    """A Huffman-coded scan into `band`; corrupt data raises."""
    w = _windows(d)
    try:
        if not progressive:
            _decode_sequential(w, spans, bases, slots, list(zip(lut_dc, lut_ac)), band, ns)
        elif ss == 0:
            _decode_dc_first(w, spans, bases, slots, lut_dc, band, ns, al)
        elif ah:
            _decode_ac_refine(w, spans, bases, lut_ac[0], band, ss, se, al)
        else:
            _decode_ac_first(w, spans, bases, lut_ac[0], band, ss, se, al)
    except (TypeError, IndexError) as e:  # a peek with no code, or data past the end
        raise DecodeError("corrupt or truncated entropy-coded data") from e
    except OverflowError as e:
        raise DecodeError("corrupt data: a coefficient out of range") from e
    if np.abs(np.frombuffer(band, np.int32)).max(initial=0) > 32767:
        raise DecodeError("corrupt data: a coefficient out of range")


def _dc_refine(d, spans, comps, coefs, blocks, slots, al) -> None:
    """A progressive DC refinement scan: bit Al of each block's DC, one
    bit a block in coding order (each interval starts on a byte)."""
    got = np.empty(blocks.size, np.int64)
    for b0, b1, p, end in spans:
        if p + (b1 - b0) > end:
            raise DecodeError("corrupt or truncated data: a scan runs past its data")
        got[b0:b1] = np.unpackbits(d[p >> 3:end >> 3])[:b1 - b0]
    for j, c in enumerate(comps):
        sel = slots == j
        coefs[c][blocks[sel], 0] |= (got[sel] << al).astype(np.int32)


# ---------------------------------------------------------------------------
# PNG

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _unfilter(rows, ft, bpp: int) -> np.ndarray:
    """Undo PNG's filters: rows (h, n) uint8 filtered bytes, ft (h,) their
    filter types, bpp the bytes a pixel (at least 1). A byte's value
    depends on the byte a pixel to its left (a), the one above (b) and the
    one above that (c), so the reconstruction runs along the image's
    anti-diagonals of pixels, every pixel and byte of one at once. The
    image, with a row of zeros on top and a pixel of zeros on the left,
    is held diagonal after diagonal, so that a diagonal and its
    neighbours on the two before it are contiguous runs."""
    h, n = rows.shape
    if not ft.any():
        return rows
    u = n // bpp
    rows_p, cols_p = h + 1, u + 1
    diag = np.arange(rows_p + cols_p - 1)
    lo = np.maximum(0, diag - cols_p + 1)  # each diagonal's first row
    size = np.minimum(rows_p - 1, diag) - lo + 1
    off = np.concatenate([[0], np.cumsum(size)])
    which = np.repeat(diag, size)
    row = lo[which] + np.arange(off[-1]) - off[which]
    order = row * cols_p + which - row  # row-major index of each entry
    padded = np.zeros((rows_p, cols_p, bpp), np.int16)
    padded[1:, 1:] = rows.reshape(h, u, bpp)
    raw = padded.reshape(-1, bpp)[order]
    kind = np.concatenate([[0], ft]).astype(np.intp)[row][:, None]
    out = np.zeros_like(raw)
    lo, off = lo.tolist(), off.tolist()
    for s in range(2, h + u + 1):
        r0, r1 = max(1, lo[s]), min(h, s - 1)  # the diagonal's image rows
        i0, k = off[s] + r0 - lo[s], r1 - r0 + 1
        la = off[s - 1] + r0 - lo[s - 1]
        lc = off[s - 2] + r0 - 1 - lo[s - 2]
        a, b, c = out[la:la + k], out[la - 1:la - 1 + k], out[lc:lc + k]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(kind[i0:i0 + k], (0, a, b, (a + b) >> 1, paeth))
        out[i0:i0 + k] = (raw[i0:i0 + k] + pred) & 255
    flat = np.empty_like(out)
    flat[order] = out
    return flat.reshape(rows_p, cols_p, bpp)[1:, 1:].reshape(h, n).astype(np.uint8)


def _png_samples(raw, width: int, height: int, depth: int, channels: int):
    """Reconstruct one (sub-)image: (samples (height, width, channels)
    uint16, bytes consumed)."""
    bpp = max(1, channels * depth // 8)
    rowbytes = -(-width * channels * depth // 8)
    need = height * (rowbytes + 1)
    if raw.size < need:
        raise DecodeError("truncated image data (IDAT)")
    rows = raw[:need].reshape(height, rowbytes + 1)
    ft = rows[:, 0]
    if ft.max() > 4:
        raise DecodeError(f"unknown filter type {int(ft.max())}")
    rec = _unfilter(rows[:, 1:], ft, bpp)
    if depth == 16:
        s = rec.reshape(height, width, channels, 2).astype(np.uint16)
        s = (s[..., 0] << 8) | s[..., 1]
    elif depth == 8:
        s = rec.reshape(height, width, channels).astype(np.uint16)
    else:
        bits = np.unpackbits(rec, axis=1).reshape(height, -1, depth)
        s = (bits.astype(np.uint16) << np.arange(depth - 1, -1, -1, dtype=np.uint16)).sum(
            -1, dtype=np.uint16)
        s = s[:, :width * channels].reshape(height, width, channels)
    return s, need


_CHUNK_TYPE = re.compile(rb"\w\w\w\w")  # PngImagePlugin.is_cid


def _png_chunk(data: bytes, pos: int):
    """(length, type) of the chunk header at pos, or None where PIL's
    ChunkStream.read fails (fewer than 8 bytes, a type not of 4 word
    characters)."""
    head = data[pos:pos + 8]
    if len(head) < 8 or not _CHUNK_TYPE.match(head[4:]):
        return None
    return int.from_bytes(head[:4], "big"), head[4:]


def _png_idat(data: bytes, pos: int, need: int) -> tuple:
    """(the first `need` bytes of the image data, the end of the IDAT chunk
    they end in) from the IDAT chunk at pos on, read as PIL reads them: consecutive IDAT chunks (their CRCs not
    checked), the zlib stream inflated until the image is complete (its
    checksum and anything after it not read). It fails where the data
    runs out first: a file cut inside IDAT or a chunk of another type
    before the image is complete."""
    inflate, out = zlib.decompressobj(), []
    got = 0
    while True:
        length, _ = _png_chunk(data, pos)
        body = data[pos + 8:pos + 8 + length]
        try:
            piece = inflate.decompress(inflate.unconsumed_tail + body, need - got)
        except zlib.error as e:
            raise DecodeError(f"corrupt image data (IDAT): {e}") from e
        out.append(piece)
        got += len(piece)
        if got >= need:
            return np.frombuffer(b"".join(out), np.uint8), pos + 8 + length
        if len(body) < length:
            raise DecodeError("truncated file inside IDAT")
        pos += 12 + length
        chunk = _png_chunk(data, pos)
        if chunk is None or chunk[1] != b"IDAT":
            kind = "the end of the file" if chunk is None else f"chunk {chunk[1]!r}"
            raise DecodeError(f"truncated image data (IDAT): {kind} before the image's end")


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a PNG file, top row first, as PIL's
    `convert("RGB")` of it. Chunks are read as PIL reads them: those
    before the first IDAT must be whole and their CRCs right; the image
    data is read to the image's end (`_png_idat`);
    after it chunks are skipped up to IEND, the file may end anywhere
    between two chunks, and a chunk cut short fails. Raises DecodeError
    where PIL fails: a bad CRC before IDAT, a bad header, corrupt or
    truncated image data."""
    data = bytes(data)
    if data[:8] != _PNG_SIGNATURE:
        raise DecodeError("not a PNG file")
    pos, header, palette, animated = 8, None, None, False
    while True:  # PngImageFile._open: up to the first IDAT
        chunk = _png_chunk(data, pos)
        if chunk is None:
            raise DecodeError("truncated file: no image data (IDAT)")
        length, kind = chunk
        if kind == b"IDAT":
            break
        if kind == b"IEND":
            raise DecodeError("no image data (IEND before IDAT)")
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) < length:
            raise DecodeError(f"truncated file inside chunk {kind!r}")
        if kind == b"IHDR":
            if length < 13:
                raise DecodeError("truncated IHDR chunk")
            header = struct.unpack(">IIBBBBB", body[:13])
            if header[5]:
                raise DecodeError("unknown filter category (IHDR)")
        elif kind == b"PLTE" and header is not None and header[3] == 3:
            if len(body) % 3 or len(body) > 768:
                raise DecodeError("bad PLTE")
            palette = palette256(np.frombuffer(body, np.uint8))
        elif kind == b"acTL" and length >= 8 and 0 < int.from_bytes(body[:4], "big") <= 1 << 31:
            animated = True
        if len(crc) < 4 or zlib.crc32(kind + body) != int.from_bytes(crc, "big"):
            raise DecodeError(f"bad CRC in chunk {kind!r}")
        pos += 12 + length
    if header is None:
        raise DecodeError("image data (IDAT) before IHDR")
    width, height, depth, ctype, _, _, interlace = header  # PIL reads neither method byte
    if ctype not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[ctype]:
        raise DecodeError(f"colour type {ctype} at bit depth {depth} is not valid (IHDR)")
    if not width or not height:
        raise DecodeError("bad IHDR: an empty image")
    _check_size(width, height)
    if ctype == 3 and palette is None:
        raise DecodeError("palette image without PLTE")
    channels = _PNG_CHANNELS[ctype]
    rowbytes = lambda w: -(-w * channels * depth // 8) + 1  # noqa: E731
    if interlace:  # any value but 0 is Adam7 to PIL
        need = sum(rowbytes(-(-(width - x0) // dx)) * -(-(height - y0) // dy)
                   for x0, y0, dx, dy in _ADAM7 if width > x0 and height > y0)
    else:
        need = rowbytes(width) * height
    raw, pos = _png_idat(data, pos, need)
    while True:  # PngImageFile.load_end: chunks after the image, up to IEND
        chunk = _png_chunk(data, pos + 4)  # after the CRC, which it skips
        if chunk is None or chunk[1] == b"IEND" or (chunk[1] == b"fcTL" and animated):
            break
        length = chunk[0]
        if len(data) < pos + 12 + length:
            raise DecodeError(f"truncated file inside chunk {chunk[1]!r} after the image data")
        pos += 12 + length
    if interlace:
        s = np.zeros((height, width, channels), np.uint16)
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            s[y0::dy, x0::dx], used = _png_samples(raw, pw, ph, depth, channels)
            raw = raw[used:]
    else:
        s, _ = _png_samples(raw, width, height, depth, channels)
    if ctype == 3:
        return to_rgb("P", s[..., 0], palette)
    if ctype == 0 and depth == 16:  # PIL opens 16-bit grey as I;16
        return to_rgb("I;16", s[..., 0])
    # PIL keeps a 16-bit sample's high byte and scales 1, 2 and 4 bits to 0-255
    s = s >> 8 if depth == 16 else scale_bits(s, depth) if depth < 8 else s
    return to_rgb({0: "L", 2: "RGB", 4: "LA", 6: "RGBA"}[ctype], s[..., 0] if ctype == 0 else s)
