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

Damaged data is read as libjpeg-turbo 3.1.3 under PIL reads it, warnings
and all: the entropy-coded data cut into segments at any marker (the
bits past one read as zeros, the rest of a restart interval's MCUs left
as they were once an MCU ran out of data), restart markers resynchronised
(jpeg_resync_to_restart's three actions), a code no table holds read as
symbol 0 after 17 bits, runs past coefficient 63 or a progressive band's
end written where libjpeg writes them, a refinement of any size read as
one bit, a progression out of order only warned about, coefficients kept
in 16 bits, Huffman tables 0 and 1 left undefined taken as the standard
ones, libjpeg's marker parsers with their own checks, the SIMD inverse
DCT's 16-bit arithmetic on coefficients far out of range, and the file's
end where libjpeg would wait for more data (PIL then fails, unless every
row of a one-scan image is out). JPEG-in-TIFF streams are read as
libtiff hands them over (a fake EOI wherever a strip's data ends, and
nothing after a one-scan strip's scan).

PNG: every colour type and bit depth, Adam7 interlace, the five filters
(undone along the image's anti-diagonals, so Average and Paeth, which read
the reconstructed pixel to the left, run vectorised too), the chunks read
as PIL reads them (`decode_png`: CRCs checked before the image data only;
the file may end, or IEND be missing, after the image data; a zlib stream
ending with a row ends the image, the rest zero), an APNG as PIL's frame
0 (the image data in the box of an fcTL before it, on a zeroed image; the
acTL, fcTL and fdAT checks on which PIL fails). 16-bit
samples keep their high byte, except 16-bit grey, which is clipped at 255
as PIL's `I;16` to RGB conversion clips it (utils/pil_modes).

What neither decoder supports raises `DecodeError`, as does data on
which PIL fails; nothing returns a partial image that PIL would not.
"""

from __future__ import annotations

import array
import bisect
import functools
import re
import struct
import zlib

import numpy as np

from . import jpeg_arith
from .image import _AC_CHROMA, _AC_LUMA, _DC_CHROMA, _DC_LUMA, ZIGZAG
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
# the standard tables libjpeg-turbo installs for Huffman tables 0 and 1
# that a stream leaves undefined (jstdhuff.c std_huff_tables, as Motion
# JPEG needs them): {(class, id): (counts, symbols)}
_STD_TABLES = {(tc, th): (bytes(spec[0]), bytes(spec[1])) for (tc, th), spec in (
    ((0, 0), _DC_LUMA), ((1, 0), _AC_LUMA), ((0, 1), _DC_CHROMA), ((1, 1), _AC_CHROMA))}
# zero bytes after a segment's data: more than one MCU of ten blocks can
# read (about 250 bytes a block at 17 bits a code and 15 a value)
_PAD = 2600


class _Suspend(DecodeError):
    """Where libjpeg suspends: the data ends where it reads on. PIL gives
    it no more and fails, unless every row of a one-scan image is out."""


@functools.lru_cache(maxsize=64)
def _huffman_lut(counts: bytes, symbols: bytes, kind: str) -> list:
    """The decoding table of a DHT table as libjpeg derives it when a scan
    starts (jdhuff.c jpeg_make_d_derived_tbl): for each 16-bit peek, the
    tuple of the code it starts with. Codes go to the table's positions in
    order (a symbol listed twice has two codes). The code's symbol gives a
    run r (AC: the high nibble) and a size s (the low nibble; a DC symbol
    is its size); s bits of value follow the code. "dc": (bits, mask,
    half); "ac": (bits, run, mask, half), with bits the code's length plus
    s, mask 2**s - 1 and half 2**(s - 1) (0 if s is 0); "refine": as "ac"
    with every size taken as 1 (jdphuff.c reads one bit, and warns, for a
    refinement of another size). A ZRL (r 15, s 0) has run 16, an EOBr (s
    0) run r. A peek that no code starts is libjpeg's bad code: symbol 0
    after 17 bits (jpeg_huff_decode), a DC difference of 0 or an EOB."""
    if kind == "dc" and any(x > 15 for x in symbols):
        raise DecodeError("bad Huffman table (DHT): DC symbol above 15")
    lut = [None] * 65536
    code, p = 0, 0
    for bits, count in enumerate(counts, start=1):
        for x in symbols[p:p + count]:
            size = x if kind == "dc" else x & 15
            if kind == "refine" and size:
                size = 1
            entry = (bits + size, (1 << size) - 1, (1 << size) >> 1)
            if kind != "dc":
                entry = (entry[0], 16 if x == 0xF0 else x >> 4) + entry[1:]
            lo = code << (16 - bits)
            lut[lo:lo + (1 << (16 - bits))] = [entry] * (1 << (16 - bits))
            code += 1
        p += count
        if count and code >= 1 << bits:  # no code may be all ones
            raise DecodeError("bad Huffman table (DHT): code lengths overflow")
        code <<= 1
    bad = (17, 0, 0) if kind == "dc" else (17, 0, 0, 0)
    return [bad if e is None else e for e in lut]


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
        if len(body) != 6 + 3 * nf:
            raise DecodeError("bad SOF segment length")
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

    def imcu_row(self, comps, mcu: int) -> int:
        """The iMCU row (image band one MCU row high) of a scan's MCU."""
        if len(comps) > 1:
            return mcu // self.mcus_x
        c = comps[0]
        return mcu // -(-self.cw[c] // 8) // self.v[c]


def _next_marker(data: bytes, pos: int):
    """libjpeg's next_marker from `pos`: bytes up to an 0xFF skipped, the
    0xFFs after it, and 0xFF 0x00 pairs; (the marker's code, the offset
    past it). The data's end suspends."""
    n = len(data)
    while True:
        i = data.find(b"\xff", pos)
        if i < 0:
            raise _Suspend("truncated file: no marker before the data's end")
        pos = i + 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise _Suspend("truncated file: no marker before the data's end")
        if data[pos]:
            return data[pos], pos + 1
        pos += 1


class _Entropy:
    """The entropy-coded data of a scan from offset `pos`, cut into
    segments at markers as libjpeg's decoders read it (jdhuff.c
    jpeg_fill_bit_buffer, jdarith.c get_byte): any 0xFF followed by a byte
    other than 0x00 and 0xFF ends a segment (fill 0xFFs before it, and an
    0xFF 0x00 is a data byte 0xFF). The region held ends at the first
    marker that a restart cannot step over (one from 0xC0 on, RSTn
    aside), or at the data's end; `d` is its data bytes, segment after
    segment, `w` their 64-bit windows (zeros past the region)."""

    def __init__(self, data: bytes, pos: int):
        self.pos = pos
        buf = np.frombuffer(data, np.uint8)[pos:]
        ff = np.flatnonzero(buf[:-1] == 0xFF)
        nxt = buf[ff + 1]
        mk = ff[(nxt != 0x00) & (nxt != 0xFF)]  # the 0xFF right before a marker's code
        codes = buf[mk + 1]
        last = np.flatnonzero((codes >= 0xC0) & ((codes < 0xD0) | (codes > 0xD7)))
        if last.size:
            n = int(mk[last[0]])
            mk, codes = mk[:last[0] + 1], codes[:last[0] + 1]
        else:  # a trailing 0xFF is no data: libjpeg waits for the byte after it
            n = buf.size
            while n and buf[n - 1] == 0xFF:
                n -= 1
        self.mk, self.codes, self.n = mk.tolist(), codes.tolist(), n
        keep = np.ones(n, bool)
        inside = ff[ff < n]
        keep[inside[buf[inside + 1] == 0x00] + 1] = False  # stuffed zeros
        keep[inside[buf[inside + 1] == 0xFF]] = False  # fill bytes
        inner = mk[mk < n]
        keep[inner] = False
        keep[inner + 1] = False
        self.raw = buf[:n]
        self.before = np.concatenate([[0], np.cumsum(keep)])  # data bytes before each offset
        self.d = buf[:n][keep]
        self.start = 0  # the offset of the last segment asked for, from pos
        self.w = _windows(np.concatenate([self.d, np.zeros(_PAD, np.uint8)]))

    def marker(self, at: int):
        """The marker that ends the segment from offset `at` (as libjpeg's
        next_marker finds it): (code, offset past it), or None at the
        data's end."""
        i = bisect.bisect_left(self.mk, at - self.pos)
        if i == len(self.mk):
            return None
        return self.codes[i], self.pos + self.mk[i] + 2

    def segment(self, at: int):
        """The data bits of the segment from offset `at`: (first bit, bit
        past the last, whether the data's end ends it)."""
        self.start = at - self.pos
        i = bisect.bisect_left(self.mk, self.start)
        end = self.mk[i] if i < len(self.mk) else self.n
        return (int(self.before[at - self.pos]) * 8, int(self.before[end]) * 8,
                i == len(self.mk))

    def zeros_after(self, s: int, e: int) -> list:
        """Windows of the segment's bits s..e with zeros after them, as
        libjpeg reads past a marker: bit s at bit 0."""
        return _windows(np.concatenate([self.d[s >> 3:e >> 3], np.zeros(_PAD, np.uint8)]))


def _windows(d) -> list:
    """The big-endian 64-bit word at each byte of `d` (zeros past its end),
    as Python ints: a symbol at bit p is read from word p >> 3."""
    d = np.concatenate([d, np.zeros(8, np.uint8)]).astype(np.uint64)
    w = np.zeros(d.size - 7, np.uint64)
    for i in range(8):
        w = (w << np.uint64(8)) | d[i:i + w.size]
    return w.tolist()


def _resync(ent: _Entropy, marker, expected: int):
    """jdmarker.c read_restart_marker with jpeg_resync_to_restart, the
    default data source's: the marker where restart `expected` (0-7) is
    due, as (code, offset past it). Returns None where decoding goes on
    after the marker (the expected RSTn, or action 1: one too far away,
    discarded), or the marker left unread (action 3: a marker from 0xC0
    on, or one of the next two RSTns: the interval has no data); action 2
    (a marker below 0xC0, or one of the two RSTns before) scans on to the
    next marker and decides again."""
    while True:
        code, after = marker
        if code == 0xD0 + expected:
            return None, after
        if code < 0xC0:
            action = 2
        elif not 0xD0 <= code <= 0xD7:
            action = 3
        elif code - 0xD0 in ((expected + 1) & 7, (expected + 2) & 7):
            action = 3
        elif code - 0xD0 in ((expected - 1) & 7, (expected - 2) & 7):
            action = 2
        else:
            action = 1
        if action == 1:
            return None, after
        if action == 3:
            return marker, after
        marker = ent.marker(after)
        if marker is None:
            raise _Suspend("truncated file: no marker where a restart is due")


def _decode_sequential(w, b0, b1, p, end, bases, slots, tables, coef, pred):
    """Huffman-decode blocks b0..b1 of a sequential scan from bit p: each
    block's DC difference and its 63 ACs into `coef` (zig-zag order, 80
    places a block) from `bases[i]` on. A run past coefficient 63 puts its
    value at 63, as libjpeg's natural-order table's extra entries do.
    Returns (the block after the last decoded, p): it stops after the
    first block that reads past bit `end`."""
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
        v = ((v + pred[s] + 32768) & 65535) - 32768  # the 16 bits a JCOEF keeps
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
        if j > stop and coef[j - 1]:
            coef[stop - 1] = coef[j - 1]
            coef[j - 1] = 0
        if p > end:
            return i + 1, p
    return b1, p


def _decode_dc_first(w, b0, b1, p, end, bases, slots, tables, coef, pred, al):
    """A progressive DC scan's first pass: each block's DC, shifted by Al
    (returns as _decode_sequential)."""
    for i in range(b0, b1):
        s = slots[i]
        x = w[p >> 3]
        b = p & 7
        n, m, h = tables[s][(x >> (48 - b)) & 65535]
        v = (x >> (64 - b - n)) & m
        if v < h:
            v -= m
        p += n
        v = ((v + pred[s] + 32768) & 65535) - 32768
        pred[s] = v
        coef[bases[i]] = v << al
        if p > end:
            return i + 1, p
    return b1, p


def _decode_ac_first(w, b0, b1, p, end, bases, ac, band, ss, se, al, run):
    """A progressive AC scan's first pass over band Ss..Se of one
    component, with end-of-band runs (`run`, a one-item list, carries the
    run across calls); `band[bases[i] + k]` is block i's coefficient k. A
    run past Se writes coefficient k all the same, as libjpeg does (at 63
    past 63). Returns as _decode_sequential."""
    eobrun = run[0]
    for i in range(b0, b1):
        if eobrun:
            eobrun -= 1
            continue
        base = bases[i]
        j = base + ss
        stop = base + se + 1
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
        if j > base + 64 and band[j - 1]:
            band[base + 63] = band[j - 1]
            band[j - 1] = 0
        if p > end:
            run[0] = eobrun
            return i + 1, p
    run[0] = eobrun
    return b1, p


def _decode_ac_refine(w, b0, b1, p, end, bases, ac, band, ss, se, al, run):
    """A progressive AC scan's refinement pass (jdphuff.c
    decode_mcu_AC_refine): newly nonzero coefficients of +-2**Al, and a
    correction bit for each coefficient already nonzero that the scan
    passes; a new coefficient past Se lands past it, as libjpeg writes it.
    `ac` is a "refine" table. Returns as _decode_sequential."""
    p1, m1 = 1 << al, -1 << al
    eobrun = run[0]
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
                    band[base + min(k, 63)] = new
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
            run[0] = eobrun
            return i + 1, p
    run[0] = eobrun
    return b1, p


def _wrap16(x):
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _wrap32(x):
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _idct_1d(d, shift: int, exact: bool):
    """One pass of libjpeg-turbo's SIMD islow inverse DCT (jidctint-avx2.asm,
    CONST_BITS 13) over eight int64 arrays of 16-bit inputs, descaled by
    `shift` with rounding: jpeg_idct_islow's
    arithmetic as the SIMD code orders it, whose sums in0 + in4, in0 - in4,
    in7 + in3 and in5 + in1 wrap at 16 bits and whose 32-bit sums wrap
    (the caller saturates). `exact` False leaves the wrapping out, for
    inputs too small to wrap (_idct's bounds)."""
    wrap16, wrap32 = (_wrap16, _wrap32) if exact else (_same, _same)
    d0, d1, d2, d3, d4, d5, d6, d7 = d
    tmp3 = d2 * 10703 + d6 * 4433  # F_0_541 + F_0_765, F_0_541
    tmp2 = d2 * 4433 - d6 * 10704  # F_0_541, F_0_541 - F_1_847
    tmp0 = wrap16(d0 + d4) << 13
    tmp1 = wrap16(d0 - d4) << 13
    t10, t13 = wrap32(tmp0 + tmp3), wrap32(tmp0 - tmp3)
    t11, t12 = wrap32(tmp1 + tmp2), wrap32(tmp1 - tmp2)
    z3, z4 = wrap16(d7 + d3), wrap16(d5 + d1)
    z3, z4 = z3 * -6436 + z4 * 9633, z3 * 9633 + z4 * 6437  # F_1_175 - F_1_961 ...
    o0 = wrap32(d7 * -4927 + d1 * -7373 + z3)  # F_0_298 - F_0_899, -F_0_899
    o3 = wrap32(d7 * -7373 + d1 * 4926 + z4)  # -F_0_899, F_1_501 - F_0_899
    o1 = wrap32(d5 * -4176 + d3 * -20995 + z4)  # F_2_053 - F_2_562, -F_2_562
    o2 = wrap32(d5 * -20995 + d3 * 4177 + z3)  # -F_2_562, F_3_072 - F_2_562
    r = 1 << (shift - 1)
    return [wrap32(wrap32(x) + r) >> shift
            for x in (t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2,
                      t10 - o3)]


def _same(x):
    return x


_IDCT_CHUNK = 8192  # blocks an IDCT step (bounds the int64 temporaries)


def _idct(coef, q) -> np.ndarray:
    """(n, 64) quantised coefficients in zig-zag order and the (64,) table
    in natural order -> (n, 8, 8) uint8 samples, as libjpeg-turbo's SIMD
    islow code (PIL's) computes them: dequantised by a 16-bit multiply
    (the low 16 bits of coefficient times table entry), the column pass
    (PASS1_BITS 2) saturated to 16 bits, except that a block whose rows 1-7
    are all zero takes each column's DC shifted left by 2 in 16 bits; the
    row pass; the samples saturated to -128..127 and shifted by 128. On
    the values a valid 8-bit image gives this is jidctint.c's result. A
    pass whose inputs are small (dequantised values within 8191, column
    results within 16383) cannot wrap, and runs without the wrapping."""
    out = np.empty((coef.shape[0], 8, 8), np.uint8)
    q = _wrap16(np.asarray(q, np.int64).reshape(8, 8))
    for i in range(0, coef.shape[0], _IDCT_CHUNK):
        blk = np.empty((min(_IDCT_CHUNK, coef.shape[0] - i), 64), np.int64)
        blk[:, ZIGZAG] = coef[i:i + _IDCT_CHUNK]
        blk = blk.reshape(-1, 8, 8)
        dq = blk * q
        exact = bool(dq.max(initial=0) > 8191 or dq.min(initial=0) < -8191)
        if exact:
            dq = _wrap16(dq)
        # columns: each input row k is vertical frequency k of every column
        ws = np.clip(np.stack(_idct_1d([dq[:, k, :] for k in range(8)], 13 - 2, exact), 1),
                     -32768, 32767)
        if exact:
            flat = ~blk[:, 1:, :].any((1, 2))
            ws[flat] = _wrap16(dq[flat, :1, :] << 2)
        # rows: input u is horizontal frequency u of every row; output x column x
        cols = _idct_1d([ws[:, :, u] for u in range(8)], 13 + 2 + 3,
                        bool(ws.max(initial=0) > 16383 or ws.min(initial=0) < -16383))
        out[i:i + blk.shape[0]] = np.clip(np.stack(cols, 2), -128, 127) + 128
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
    tables (their counts and symbols) by id. An abbreviated
    table-specification stream (read_tables) fills them for the
    abbreviated image streams that follow (a JPEG-in-TIFF file's strips and
    tiles); a table an image stream defines replaces the one of its id for
    the streams after it too, as do the standard tables a Huffman-coded
    image stream gets for tables 0 and 1 it leaves undefined. Arithmetic
    conditioning (DAC) and the restart interval are not kept: libjpeg
    resets them at each SOI."""

    def __init__(self):
        self.q, self.dc, self.ac = {}, {}, {}


class _Progress:
    """What libjpeg keeps of a stream's scans: per component each
    coefficient's Al after the last scan (-1: never sent; coef_bits) and
    before the last scan of the component (prev_coef_bits), the scans so
    far, whether the image is one scan, and the last iMCU row that the
    last scan began with its data not yet run out (last_good_iMCU_row)."""

    def __init__(self, nf: int):
        self.bits = [[-1] * 64 for _ in range(nf)]
        self.prev = [[-1] * 64 for _ in range(nf)]
        self.scans, self.onepass, self.done, self.last_good = 0, False, False, -1


def read_tables(data: bytes, tables: Tables | None = None) -> Tables:
    """The tables of an abbreviated table-specification stream (SOI, DQT
    and DHT segments, EOI), added to `tables` (new ones if None)."""
    tables = Tables() if tables is None else tables
    _read(bytes(data), tables, image=False, tiff=True)
    return tables


def read_frame(data: bytes, tiff: bool = False) -> _Frame:
    """The frame header (SOF) of a JPEG stream as jpeg_read_header finds
    it, without decoding a scan: its size, components and their sampling
    factors. `tiff` as for decode_jpeg_samples."""
    if data[:2] != b"\xff\xd8":
        raise DecodeError("not a JPEG stream (no SOI)")
    return _read(bytes(data), Tables(), image=True, tiff=tiff, header=True)


def decode_jpeg(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a JPEG file, top row first, as PIL's
    `convert("RGB")` of it; raises DecodeError on what is not supported
    and where PIL fails."""
    samples, space = decode_jpeg_samples(data)
    if space == "grey":
        return np.repeat(samples, 3, 2)
    if space in ("cmyk", "ycck"):  # PIL reads libjpeg's CMYK as Adobe's inverted CMYK (CMYK;I)
        return cmyk_to_rgb(255 - samples)
    return samples


def decode_jpeg_samples(data: bytes, tables: Tables | None = None, space: str | None = None,
                        tiff: bool = False):
    """(samples, space) of a JPEG stream: the (H, W, n) uint8 samples that
    libjpeg's decompressor outputs, top row first, and the colour space it
    read. `tables` holds the tables of streams read before (read_tables),
    which the stream's own segments update. `space` overrides the colour
    space libjpeg infers from the stream's markers, as a caller that sets
    libjpeg's jpeg_color_space does: "ycc" (converted to RGB) or "raw"
    (JCS_UNKNOWN: the components as decoded, each upsampled to the image's
    size). The samples are, by space: "grey" one channel; "ycc" and "rgb"
    RGB; "cmyk" and "ycck" libjpeg's CMYK (YCCK converted: C, M, Y = 255 -
    the YCC conversion's R, G, B); "raw" one channel a component. `tiff`
    reads the stream as libtiff's JPEG codecs hand it to libjpeg: a fake
    EOI wherever the data runs out (tif_jpeg.c std_fill_input_buffer), and
    of a one-scan image nothing after its scan (jpeg_finish_decompress's
    errors are ignored)."""
    frame, planes, inferred = decode_jpeg_planes(data, tables, tiff)
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


def decode_jpeg_planes(data: bytes, tables: Tables | None = None, tiff: bool = False):
    """(frame, planes, space) of a JPEG stream: each component's samples
    at its own size (its share of the image's, rounded up), as libjpeg's
    raw-data output gives them (block smoothing, inverse DCT, no
    upsampling, no colour conversion), and the colour space libjpeg infers.
    A component no scan reached has no table latched, and libjpeg's
    dequantiser, zeroed, makes it 128 throughout. `tables` and `tiff` as
    for decode_jpeg_samples."""
    frame, coefs, prog, latched, space = _read(bytes(data), Tables() if tables is None
                                               else tables, image=True, tiff=tiff)
    smooth = frame.progressive and _smoothing_ok(frame, prog, latched)
    planes = []
    for c in range(len(frame.ids)):
        q = latched.get(c, np.zeros(64, np.int64))
        coef = _block_smooth(frame, c, coefs[c], prog, q) if smooth else coefs[c]
        blocks = _idct(coef, q)
        bh, bw = frame.bh[c], frame.bw[c]
        plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        planes.append(plane[:frame.ch[c], :frame.cw[c]])
    return frame, planes, space


class _Reader:
    """libjpeg's marker reader's view of the stream: bytes read one after
    another from `pos`, the data's end suspending (INPUT_BYTE)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise _Suspend("truncated file inside a marker segment")
        self.pos += 1
        return self.data[self.pos - 1]

    def two(self) -> int:
        return self.byte() << 8 | self.byte()

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise _Suspend("truncated file inside a marker segment")
        self.pos += n
        return self.data[self.pos - n:self.pos]


def _get_dht(rd: _Reader, tables: Tables) -> None:
    """jdmarker.c get_dht, its checks where it makes them."""
    length = rd.two() - 2
    while length > 16:
        index = rd.byte()
        counts = rd.take(16)
        n = sum(counts)
        length -= 17
        if n > 256 or n > length:
            raise DecodeError("bad Huffman table (DHT)")
        symbols = rd.take(n)
        length -= n
        if index & 0x10:
            if index - 0x10 >= 4:
                raise DecodeError(f"bad DHT table index {index:#04x}")
            tables.ac[index - 0x10] = (counts, symbols)
        else:
            if index >= 4:
                raise DecodeError(f"bad DHT table index {index:#04x}")
            tables.dc[index] = (counts, symbols)
    if length:
        raise DecodeError("bad DHT segment length")


def _get_dqt(rd: _Reader, tables: Tables) -> None:
    """jdmarker.c get_dqt: a table cut short is padded with ones."""
    length = rd.two() - 2
    while length > 0:
        n = rd.byte()
        length -= 1
        pq, tq = n >> 4, n & 15
        if tq >= 4:
            raise DecodeError(f"bad DQT table index {tq}")
        count = min(64, length // 2 if pq else length)
        q = np.frombuffer(rd.take(count * (2 if pq else 1)), ">u2" if pq else np.uint8)
        tables.q[tq] = np.ones(64, np.int64)
        tables.q[tq][ZIGZAG[:count]] = q
        length -= count * (2 if pq else 1)
    if length:
        raise DecodeError("bad DQT segment length")


def _get_dac(rd: _Reader, cond) -> None:
    """jdmarker.c get_dac."""
    length = rd.two() - 2
    while length > 0:
        index, value = rd.byte(), rd.byte()
        length -= 2
        if index >= 32:
            raise DecodeError(f"bad DAC table index {index}")
        if index >= 16:
            cond[1][index - 16] = value
        elif value & 15 > value >> 4:
            raise DecodeError(f"bad DAC value {value:#04x}: L above U")
        else:
            cond[0][index] = (value & 15, value >> 4)
    if length:
        raise DecodeError("bad DAC segment length")


def _read(data: bytes, tables: Tables, image: bool, tiff: bool = False, header: bool = False):
    """Parse a stream from SOI to EOI as libjpeg's marker reader does
    (jdmarker.c read_markers, each segment's checks where it makes them)
    and entropy-decode its scans with `tables` (updated by its DQT and DHT
    segments): (frame, coefficients, progress, latched quantisation
    tables, colour space) of an image stream; None of a
    table-specification stream (`image` False), which must hold no frame.
    What libjpeg only warns about is read on; its errors raise. A one-scan
    image whose rows are all out is complete where the data ends (PIL's
    JpegDecode.c takes jpeg_finish_decompress suspending so); any other
    stream must reach EOI. `tiff` as for decode_jpeg_samples; `header`
    returns the frame at the first SOS (jpeg_read_header)."""
    if data[:2] != b"\xff\xd8":
        raise DecodeError("not a JPEG file (no SOI)")
    real = len(data)
    if tiff:  # libtiff's source: a fake EOI each time the data runs out
        data += b"\xff\xd9" * 64
    cond = ({}, {})  # DAC: (L, U) of each DC table, Kx of each AC table; reset at SOI
    frame, coefs, latched, prog = None, None, {}, None
    restart, jfif, adobe, space = 0, False, None, None
    rd, unread = _Reader(data, 2), None
    try:
        while True:
            if unread is None:
                marker, rd.pos = _next_marker(data, rd.pos)
            else:
                (marker, rd.pos), unread = unread, None
            if marker == 0xD9:
                break
            if marker in _STANDALONE:  # RSTn and TEM: no segment
                continue
            if marker == 0xD8:
                raise DecodeError("SOI twice")
            if marker in _SKIPPED:  # APPn, COM, DNL: skipped after their length
                length = rd.two() - 2
                if marker in (0xE0, 0xEE):  # get_interesting_appn reads the first bytes
                    head = rd.take(max(0, min(length, 14 if marker == 0xE0 else 12)))
                    jfif = jfif or (len(head) == 14 and head[:5] == b"JFIF\x00")
                    if len(head) == 12 and head[:5] == b"Adobe":
                        adobe = head[11]
                    length -= len(head)
                rd.pos += max(length, 0)
                if tiff and rd.pos > real:  # std_skip_input_data past the end: the fake EOI
                    rd.pos = real
            elif marker in _SOF_DECODED:
                if frame is not None:
                    raise DecodeError("two SOF markers")
                if not image:
                    raise DecodeError("a frame (SOF) in a table-specification stream")
                length = rd.two()
                head = rd.take(6)
                nf = head[5]
                if length - 8 != 3 * nf:
                    raise DecodeError("bad SOF segment length")
                frame = _Frame(marker, head + rd.take(3 * nf))
                coefs = [np.zeros((bh * bw, 64), np.int32) for bh, bw in zip(frame.bh, frame.bw)]
                prog = _Progress(len(frame.ids))
            elif marker in _SOF_KINDS:
                raise DecodeError(f"{_SOF_KINDS[marker]} JPEG (SOF{marker - 0xC0}) is not "
                                  "supported")
            elif marker == 0xC4:
                _get_dht(rd, tables)
            elif marker == 0xDB:
                _get_dqt(rd, tables)
            elif marker == 0xCC:
                _get_dac(rd, cond)
            elif marker == 0xDD:
                if rd.two() != 4:
                    raise DecodeError("bad DRI segment length")
                restart = rd.two()
            elif marker == 0xDA:
                if frame is None:
                    raise DecodeError("a scan (SOS) in a table-specification stream" if not image
                                      else "SOS before SOF")
                length, ns = rd.two(), rd.byte()
                if length != 2 * ns + 6 or not 1 <= ns <= 4:
                    raise DecodeError("bad SOS segment")
                body = bytes([ns]) + rd.take(2 * ns + 3)
                if header:
                    return frame
                if not latched:  # libjpeg reads the colour space up to the first SOS
                    space = _color_space(frame, jfif, adobe)
                unread = _decode_scan(data, rd.pos, body, frame, coefs, prog, latched, tables,
                                      cond, restart)
                if tiff and prog.onepass:
                    break
                if unread is None:
                    raise _Suspend("truncated file: no marker after the scan")
            else:
                raise DecodeError(f"unknown marker FF{marker:02X}")
    except _Suspend:
        if not (image and prog is not None and prog.onepass and prog.done):
            raise
    if not image:
        return None
    if frame is None:
        raise DecodeError("no SOF before EOI")
    if not prog.scans:
        raise DecodeError("no scan (SOS) before EOI")
    return frame, coefs, prog, latched, space


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


def _smoothing_ok(frame, prog, latched) -> bool:
    """jdcoefct.c smoothing_ok: every component's table latched and nonzero
    at the DC and the first nine ACs, every component's DC sent at least
    in part, and some component with one of zig-zag coefficients 1-9 not
    fully sent (its last scan's Al above 0, or no scan)."""
    for c in range(len(frame.ids)):
        q = latched.get(c)
        if q is None or not q[[0, *_SMOOTH_POS]].all() or prog.bits[c][0] < 0:
            return False
    return any(b != 0 for cbits in prog.bits for b in cbits[1:10])


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


def _smooth(frame, c, coef, cbits, q) -> np.ndarray:
    """libjpeg-turbo's interblock smoothing of a progressive component
    with the coefficient bits `cbits` (1-9 read): each of zig-zag
    coefficients 1-9 still zero and not exact (its Al not 0) is estimated
    from the 5x5 DC neighbourhood (the edge block repeated past the image's
    right and left, rows as _smooth_rows picks them) and the quantisation
    table; where none of 1-9 was sent the DC is re-estimated too. `coef`
    (blocks, 64) zig-zag in; a new array out."""
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


def _block_smooth(frame, c, coef, prog, q) -> np.ndarray:
    """decompress_smooth_data over a component: iMCU rows up to the last
    scan's last good one with the coefficient bits after all scans, the
    rows after it with those before the component's last scan (all unsent
    after a single scan), as libjpeg-turbo smooths a scan that ran out of
    data."""
    out = _smooth(frame, c, coef, prog.bits[c], q)
    rows = -(-frame.ch[c] // 8)
    first_bad = (prog.last_good + 1) * frame.v[c]  # the first block row past it
    if first_bad < rows:
        before = prog.prev[c] if prog.scans > 1 else [-1] * 64
        late = _smooth(frame, c, coef, before, q).reshape(-1, frame.bw[c], 64)
        out.reshape(-1, frame.bw[c], 64)[first_bad:rows] = late[first_bad:rows]
    return out


def _decode_scan(data, pos, body, frame, coefs, prog, latched, tables, cond, restart):
    """Decode one scan (its SOS header `body`, its data from `pos`) into
    the components' coefficient arrays, as libjpeg's entropy decoders read
    it, restarts and damaged data included; returns the marker after its
    data, as (code, offset past it), or None at the data's end."""
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
        raise DecodeError("bad SOS segment")
    comps, tabs, slot = [], [], [None] * 4
    for j in range(ns):  # jdmarker.c get_sos, its test of cur_comp_info[ci] as it is
        cid, t = body[1 + 2 * j:3 + 2 * j]
        c = next((c for c in range(min(len(frame.ids), 4))
                  if frame.ids[c] == cid and slot[c] is None), None)
        if c is None or c in comps:
            raise DecodeError(f"SOS names component {cid}, which the frame lacks or the scan "
                              "names twice")
        slot[j] = c
        comps.append(c)
        tabs.append((t >> 4, t & 15))
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    prog.scans += 1
    if prog.scans == 1:  # jdinput.c initial_setup, jinit_huff_decoder's standard tables
        prog.onepass = not frame.progressive and ns == len(frame.ids)
        if not frame.arith:
            for (tc, th), spec in _STD_TABLES.items():
                (tables.ac if tc else tables.dc).setdefault(th, spec)
    elif prog.onepass:
        raise DecodeError("a second scan in a one-scan image (libjpeg expects EOI)")
    if not frame.progressive:
        ss, se, ah, al = 0, 63, 0, 0
    elif ((ss == 0) != (se == 0)) or ss > se or se > 63 or (ss and ns != 1) or al > 13 or (
            ah and al != ah - 1):
        raise DecodeError(f"bad progression parameters Ss {ss} Se {se} Ah {ah} Al {al} (SOS)")
    blocks, slots, per_mcu = frame.scan_blocks(comps)
    if per_mcu > 10:
        raise DecodeError(f"{per_mcu} blocks an MCU (SOS): at most 10")
    for c in comps:  # libjpeg latches a component's table at its first scan
        if c not in latched:
            if frame.tq[c] not in tables.q:
                raise DecodeError(f"quantisation table {frame.tq[c]} is not defined (DQT)")
            latched[c] = tables.q[frame.tq[c]]
        if frame.progressive:  # jdphuff.c / jdarith.c start_pass: a bad order only warns
            for k in range(min(ss, 1), max(se, 9) + 1):
                prog.prev[c][k] = prog.bits[c][k] if prog.scans > 1 else 0
            for k in range(ss, se + 1):
                prog.bits[c][k] = al
    if not frame.arith:
        luts = []
        for td, ta in tabs:
            dc = ac = None
            if not frame.progressive or (ss == 0 and ah == 0):
                dc = _table(tables.dc, td, "dc")
            if not frame.progressive or ss:
                ac = _table(tables.ac, ta, "refine" if ah else "ac")
            luts.append((dc, ac))
    # the scan's components' coefficients so far, one list: a block's DC
    # alone (DC scans) or its 64 coefficients and 16 places for a run past them
    stride = 1 if frame.progressive and ss == 0 else 80
    offsets = np.cumsum([0] + [coefs[c].shape[0] * stride for c in comps])
    bases = (offsets[slots] + blocks * stride).tolist()
    source = np.zeros(int(offsets[-1]), np.int32)
    for j, c in enumerate(comps):
        source[offsets[j]:offsets[j + 1]].reshape(-1, stride)[:, :64] = coefs[c][:, :stride]
    band = array.array("i", source.tobytes())
    slots_l = slots.tolist()
    if frame.arith:
        coder = jpeg_arith.Scan(bases, slots_l, band, tabs, frame.progressive, ss, se, ah, al,
                                *cond)
    else:
        coder = _HuffmanScan(bases, slots_l, band, source, luts, frame.progressive, ss, se, ah,
                             al, bool(restart))
    ent = _Entropy(data, pos)
    per_interval = restart * per_mcu
    nblocks = blocks.size
    at, unread, expected, flag, good = pos, None, 0, False, -1
    for b0 in range(0, nblocks, per_interval or nblocks):
        b1 = min(b0 + per_interval, nblocks) if per_interval else nblocks
        if not flag:
            good = b0 // per_mcu
        if b0:  # a restart is due (jdhuff.c / jdarith.c process_restart)
            if unread is None:
                unread = ent.marker(at)
                if unread is None:
                    raise _Suspend("truncated file: no marker where a restart is due")
            unread, at = _resync(ent, unread, expected)
            expected = (expected + 1) & 7
            if unread is None:
                flag = False
        if unread is None:
            s, e, eof = ent.segment(at)
        else:  # the marker left unread: no data for the interval
            s, e, eof = 0, 0, False
        if eof and not (prog.onepass and b1 == nblocks):
            raise _Suspend("truncated file inside a scan")
        got = coder.interval(ent, b0, b1, s, e, eof, flag, per_mcu)
        if got is None:  # jdarith.c get_byte: no suspending
            raise DecodeError("truncated file inside an arithmetic-coded scan")
        end_block, flag = got
        mcu = (end_block - 1) // per_mcu
        if mcu > b0 // per_mcu:
            good = mcu
    prog.last_good = frame.imcu_row(comps, max(good, 0))
    vals = np.frombuffer(band, np.int32).astype(np.int16)  # stored as libjpeg's 16-bit JCOEF
    for j, c in enumerate(comps):
        part = vals[offsets[j]:offsets[j + 1]].reshape(-1, stride)
        if stride == 1:
            coefs[c][:, 0] = part[:, 0]
        else:
            coefs[c][:] = part[:, :64]
    prog.done = True
    return unread if unread is not None else ent.marker(at)


def _table(specs: dict, th: int, kind: str) -> list:
    if th not in specs:
        raise DecodeError(f"{'DC' if kind == 'dc' else 'AC'} Huffman table {th} is not "
                          "defined (DHT)")
    counts, symbols = specs[th]
    return _huffman_lut(bytes(counts), bytes(symbols), kind)


class _HuffmanScan:
    """The Huffman decoder of one scan over its restart intervals, as
    libjpeg's (jdhuff.c, jdphuff.c): each MCU decoded until one reads past
    its segment's data, which it completes with zero bits; after it the
    interval's MCUs keep what they held (insufficient_data) until the
    next restart."""

    def __init__(self, bases, slots, band, source, luts, progressive, ss, se, ah, al,
                 restart):
        self.bases, self.slots, self.band, self.source = bases, slots, band, source
        self.ss, self.se, self.al, self.restart, self.ncomps = ss, se, al, restart, len(luts)
        dc = [t[0] for t in luts]
        if not progressive:
            self.kind, self.tables = "seq", luts
        elif ss == 0:
            self.kind, self.tables = ("dc_refine", None) if ah else ("dc", dc)
        else:
            self.kind, self.tables = ("ac_refine" if ah else "ac"), luts[0][1]

    def _run(self, w, b0, b1, p, end):
        """Decode blocks b0..b1 from bit p: (the block after the last
        decoded, p), stopping after a block that reads past bit `end`."""
        bases, slots, band, tables = self.bases, self.slots, self.band, self.tables
        if self.kind == "seq":
            return _decode_sequential(w, b0, b1, p, end, bases, slots, tables, band,
                                      [0] * self.ncomps)
        if self.kind == "dc":
            return _decode_dc_first(w, b0, b1, p, end, bases, slots, tables, band,
                                    [0] * self.ncomps, self.al)
        fn = _decode_ac_refine if self.kind == "ac_refine" else _decode_ac_first
        return fn(w, b0, b1, p, end, bases, tables, band, self.ss, self.se, self.al, [0])

    def interval(self, ent, b0, b1, s, e, eof, flag, per_mcu) -> tuple:
        """Decode restart interval b0..b1 from its segment's bits s..e
        unless the data ran out before it (flag); returns (the block after
        the last MCU decoded, whether the data ran out)."""
        if flag:
            return b0, True
        if self.kind == "dc_refine":
            return self._dc_refine(ent, b0, b1, s, e, per_mcu)
        stop, p = self._run(ent.w, b0, b1, s, e)
        if p <= e:
            if eof and _suspends(ent, self, b0, b1, s, per_mcu):
                raise _Suspend("truncated file inside a scan")
            return b1, False
        if eof:
            raise _Suspend("truncated file inside a scan")
        # an MCU read past its data: decode the interval again up to that
        # MCU's end with zeros after the data, from the band as it was
        stop = min(b1, b0 + ((stop - 1 - b0) // per_mcu + 1) * per_mcu)
        self._restore(b0, stop)
        self._run(ent.zeros_after(s, e), b0, stop, 0, 1 << 62)
        return stop, True

    def _restore(self, b0, b1):
        """Blocks b0..b1 as the scan found them."""
        width = 1 if self.kind in ("dc", "dc_refine") else 80
        for i in range(b0, b1):
            j = self.bases[i]
            self.band[j:j + width] = array.array("i", self.source[j:j + width].tobytes())

    def _dc_refine(self, ent, b0, b1, s, e, per_mcu) -> tuple:
        """A progressive DC refinement's interval: bit Al of each block's
        DC, one bit a block, zeros past the data (jdphuff.c
        decode_mcu_DC_refine)."""
        n = b1 - b0
        got = np.unpackbits(ent.d[s >> 3:e >> 3])[:n]
        p1, band, bases = 1 << self.al, self.band, self.bases
        for i in np.flatnonzero(got).tolist():
            band[bases[b0 + i]] |= p1
        if n > e - s:
            return min(b1, b0 + ((e - s) // per_mcu + 1) * per_mcu), True
        return b1, False


class _PastTheEnd(Exception):
    pass


def _suspends(ent, scan, b0, b1, s, per_mcu) -> bool:
    """Whether libjpeg-turbo suspends in the last restart interval of a
    one-scan image, blocks b0..b1 from bit s, whose data the file's end
    ends: its bit reader (jdhuff.c, a 64-bit buffer) reads ahead of the
    bits it needs, and at the file's end it suspends even where those bits
    are all there. For an MCU, decode_mcu_fast (no restart interval set,
    512 bytes a block left) reads six bytes whenever 16 bits or fewer are
    left before a code or a value (an 0xFF 0xFF sends the MCU to the slow
    path); decode_mcu_slow fills to 57 bits whenever fewer than it needs
    are left (8 before a code, 9 and then 1 a bit for a code longer than
    8, the value's size before a value)."""
    w, slots, tables = ent.w, scan.slots, scan.tables
    mcus, p = [], s
    for m0 in range(b0, b1, per_mcu):  # the (code length, value size) of each symbol
        syms = []
        for i in range(m0, min(m0 + per_mcu, b1)):
            dc, ac = tables[slots[i]]
            x = w[p >> 3]
            n, m, _ = dc[(x >> (48 - (p & 7))) & 65535]
            syms.append((n - m.bit_length(), m.bit_length()))
            p += n
            k = 1
            while k < 64:
                x = w[p >> 3]
                n, r, m, _ = ac[(x >> (48 - (p & 7))) & 65535]
                p += n
                syms.append((n - m.bit_length(), m.bit_length()))
                if m:
                    k += r + 1
                elif r == 16:
                    k += 16
                else:
                    break
        mcus.append(syms)
    raw = ent.raw[ent.start:].tolist()
    end, at, left = len(raw), 0, 0

    def slow_fill():
        nonlocal at, left
        while left < 57:
            if at >= end:
                raise _PastTheEnd
            c = raw[at]
            at += 1
            while c == 0xFF:  # 0xFF 0x00 (after any fill 0xFFs) is a data byte
                if at >= end:
                    raise _PastTheEnd
                c = raw[at]
                at += 1
                if c == 0:
                    break
            left += 8

    def fast_fill():
        nonlocal at, left
        for _ in range(6):
            c = raw[at]
            at += 1
            if c == 0xFF:
                if raw[at]:
                    return False
                at += 1
            left += 8
        return True

    try:
        for syms in mcus:
            if not scan.restart and end - at >= 512 * per_mcu:
                saved = at, left
                for code, size in syms:
                    if left <= 16 and not fast_fill():
                        break
                    left -= code
                    if size:
                        if left <= 16 and not fast_fill():
                            break
                        left -= size
                else:
                    continue
                at, left = saved
            for code, size in syms:
                if left < 8:
                    slow_fill()
                if code <= 8:
                    left -= code
                else:
                    if left < 9:
                        slow_fill()
                    left -= 9
                    for _ in range(code - 9):
                        if left < 1:
                            slow_fill()
                        left -= 1
                if size:
                    if left < size:
                        slow_fill()
                    left -= size
    except _PastTheEnd:
        return True
    return False


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


def _png_idat(data: bytes, pos: int, need: int, apng) -> tuple:
    """(the first `need` bytes of the image data, the end of the chunk
    they end in) from the data chunk at pos on, read as PIL reads them:
    consecutive IDAT, DDAT and fdAT chunks (an fdAT's sequence number
    checked and skipped; their CRCs not checked), the zlib stream inflated
    until the image is complete (its checksum and anything after it not
    read) or the stream ends (fewer bytes). It fails where the data runs
    out first: a file cut inside the data or a chunk of another type
    before the image is complete."""
    inflate, out = zlib.decompressobj(), []
    got = 0
    while True:
        length, kind = _png_chunk(data, pos)
        skip = 4 if kind == b"fdAT" else 0
        if skip:
            apng.fdat(data[pos + 8:pos + 12], length)
        body = data[pos + 8 + skip:pos + 8 + length]
        try:
            piece = inflate.decompress(inflate.unconsumed_tail + body, need - got)
        except zlib.error as e:
            raise DecodeError(f"corrupt image data (IDAT): {e}") from e
        out.append(piece)
        got += len(piece)
        if got >= need or inflate.eof:  # the image, or the end of the zlib stream
            return np.frombuffer(b"".join(out), np.uint8), pos + 8 + length
        if len(body) < length - skip:
            raise DecodeError("truncated file inside IDAT")
        pos += 12 + length
        chunk = _png_chunk(data, pos)
        if chunk is None or chunk[1] not in (b"IDAT", b"DDAT", b"fdAT"):
            kind = "the end of the file" if chunk is None else f"chunk {chunk[1]!r}"
            raise DecodeError(f"truncated image data (IDAT): {kind} before the image's end")


class _Apng:
    """PngStream's APNG state as PIL reads frame 0: acTL's frame count,
    the fcTL sequence, the frame's box (the last fcTL before the image
    data; without one an acTL makes the image data a default image that
    is not a frame)."""

    def __init__(self):
        self.frames = self.seq = self.box = None
        self.default_image = False

    def actl(self, body: bytes) -> None:
        if len(body) < 8:
            raise DecodeError("APNG contains truncated acTL chunk")
        n = int.from_bytes(body[:4], "big")
        if self.frames is not None:
            self.frames = None  # a second acTL: "Invalid APNG"
        elif 0 < n <= 1 << 31:
            self.frames = n

    def fctl(self, body: bytes, size) -> None:
        if len(body) < 26:
            raise DecodeError("APNG contains truncated fcTL chunk")
        self._next(body[:4])
        w, h, x, y = struct.unpack(">IIII", body[4:20])
        if x + w > size[0] or y + h > size[1]:
            raise DecodeError("APNG contains invalid frames")
        self.box = (x, y, w, h)

    def fdat(self, head: bytes, length: int) -> None:
        if length < 4:
            raise DecodeError("APNG contains truncated fDAT chunk")
        if self.seq is None:
            raise DecodeError("APNG contains frame sequence errors")
        self._next(head)

    def _next(self, head: bytes) -> None:
        seq = int.from_bytes(head, "big")
        if seq != (0 if self.seq is None else self.seq + 1):
            raise DecodeError("APNG contains frame sequence errors")
        self.seq = seq

    @property
    def animated(self) -> bool:
        return (self.frames or 1) + self.default_image > 1


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a PNG file, top row first, as PIL's
    `convert("RGB")` of it. Chunks are read as PIL reads them: those
    before the first IDAT must be whole and their CRCs right; the image
    data is read to the image's end (`_png_idat`);
    after it chunks are skipped up to IEND (or, in an animation, the next
    fcTL), the file may end anywhere between two chunks, and a chunk cut
    short fails. An APNG gives PIL's frame 0: the image data placed in
    the box of an fcTL before it, on a canvas of zeros (the palette's
    first colour), whatever its dispose and blend operations; without
    such an fcTL the image data whole. Raises DecodeError where PIL fails:
    a bad CRC before IDAT, a bad header, corrupt or truncated image data,
    a truncated acTL, fcTL or fdAT, an fcTL or fdAT out of sequence, a
    frame outside the image."""
    data = bytes(data)
    if data[:8] != _PNG_SIGNATURE:
        raise DecodeError("not a PNG file")
    pos, header, palette, apng = 8, None, None, _Apng()
    while True:  # PngImageFile._open: up to the first IDAT (or fdAT)
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
        if kind == b"fdAT":  # the image data, after its sequence number
            if len(body) < min(length, 4):
                raise DecodeError("truncated file inside chunk b'fdAT'")
            break
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
        elif kind == b"acTL":
            apng.actl(body)
        elif kind == b"fcTL":
            apng.fctl(body, header[:2] if header else (0, 0))
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
    if apng.box is None and apng.frames is not None:
        apng.default_image = True
    x0, y0, bw, bh = apng.box or (0, 0, width, height)
    if not bw or not bh:
        raise DecodeError("APNG frame of no pixels (tile cannot extend outside image)")
    channels = _PNG_CHANNELS[ctype]
    rowbytes = lambda w: -(-w * channels * depth // 8) + 1  # noqa: E731
    if interlace:  # any value but 0 is Adam7 to PIL
        passes = [(rowbytes(-(-(bw - x) // dx)), -(-(bh - y) // dy))
                  for x, y, dx, dy in _ADAM7 if bw > x and bh > y]
    else:
        passes = [(rowbytes(bw), bh)]
    need = sum(n * rows for n, rows in passes)
    raw, pos = _png_idat(data, pos, need, apng)
    if len(raw) < need:  # ZipDecode: a stream ending with a row ends the image
        ends, at = set(), 0
        for n, rows in passes:
            ends.update(range(at + n, at + n * rows + 1, n))
            at += n * rows
        if len(raw) not in ends:
            raise DecodeError("truncated image data (IDAT): the zlib stream ends inside a row")
        raw = np.concatenate([raw, np.zeros(need - len(raw), np.uint8)])
    animated = apng.animated  # is_animated, as _open left it
    while True:  # PngImageFile.load_end: chunks after the image, up to IEND
        chunk = _png_chunk(data, pos + 4)  # after the CRC, which it skips
        if chunk is None or chunk[1] == b"IEND" or (chunk[1] == b"fcTL" and animated):
            break
        length, kind = chunk
        body = data[pos + 12:pos + 12 + length]
        if kind in (b"acTL", b"fcTL", b"fdAT") and len(body) == length:
            if kind == b"acTL":
                apng.actl(body)
            elif kind == b"fcTL":
                apng.fctl(body, (width, height))
            else:
                apng.fdat(body[:4], length)
        if len(data) < pos + 12 + length:
            raise DecodeError(f"truncated file inside chunk {kind!r} after the image data")
        pos += 12 + length
    if interlace:
        s = np.zeros((bh, bw, channels), np.uint16)
        for x, y, dx, dy in _ADAM7:
            pw, ph = -(-(bw - x) // dx), -(-(bh - y) // dy)
            if pw <= 0 or ph <= 0:
                continue
            s[y::dy, x::dx], used = _png_samples(raw, pw, ph, depth, channels)
            raw = raw[used:]
    else:
        s, _ = _png_samples(raw, bw, bh, depth, channels)
    if (bw, bh) != (width, height):  # the frame on PIL's new (zeroed) image
        canvas = np.zeros((height, width, channels), s.dtype)
        canvas[y0:y0 + bh, x0:x0 + bw] = s
        s = canvas
    if ctype == 3:
        return to_rgb("P", s[..., 0], palette)
    if ctype == 0 and depth == 16:  # PIL opens 16-bit grey as I;16
        return to_rgb("I;16", s[..., 0])
    # PIL keeps a 16-bit sample's high byte and scales 1, 2 and 4 bits to 0-255
    s = s >> 8 if depth == 16 else scale_bits(s, depth) if depth < 8 else s
    return to_rgb({0: "L", 2: "RGB", 4: "LA", 6: "RGBA"}[ctype], s[..., 0] if ctype == 0 else s)
