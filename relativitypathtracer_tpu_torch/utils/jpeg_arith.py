"""The arithmetic (QM-coder) entropy decoding of JPEG scans, ITU T.81
Annex D and sections F.2.4 and G.2, as libjpeg-turbo's jdarith.c and
jaricom.c do it.

`Scan` fills the same coefficient band that utils/image_decode's Huffman
scans fill, so everything after entropy decoding (the inverse DCT,
upsampling, colour conversion, block smoothing) is shared. It covers a
sequential scan (SOF9) and the four progressive kinds (SOF10): DC first, AC
first, DC refinement and AC refinement.

As libjpeg, the decoder never raises on bad data: past the end of a restart
interval's segment it reads zeros (libjpeg's get_byte after a marker), and
a magnitude or spectral overflow stops the interval's decoding, leaving
what was decoded before it, until the next restart marker. Only the
file's end, which libjpeg's arithmetic decoder cannot wait past, fails. A
coefficient is stored as libjpeg's 16-bit JCOEF stores it, wrapped to
-32768..32767.

The decoder is a Python loop over binary decisions: a few microseconds
each, paid once when a texture is read.
"""

from __future__ import annotations

# Table D.2 (jaricom.c jpeg_aritab): each state's (Qe, next state after an
# LPS with the MPS switch in bit 7, next state after an MPS). State 113 is
# the fixed probability 0.5 (T.851 Table 5) that signs and refinement bits
# of the AC scans are coded with.
_D2 = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))
QE = tuple((qe, (switch << 7) | lps, mps) for qe, lps, mps, switch in _D2)
FIXED = 113  # the state of the fixed-probability bin

DC_BINS, AC_BINS = 64, 256  # statistics bins a table (jdarith.c DC_STAT_BINS, AC_STAT_BINS)
DC_X1, AC_X2_LOW, AC_X2_HIGH = 20, 189, 217  # Table F.4 X1; F.1.4.4.2's X2 at k <= Kx and past it
# DAC defaults (jdmarker.c / jdapimin.c): DC conditioning L 0, U 1; AC Kx 5
DEFAULT_DC, DEFAULT_AC = (0, 1), 5


class _Stop(Exception):
    """A magnitude or spectral overflow: libjpeg's `ct = -1`, which stops
    the decoding until the next restart interval."""


class Decoder:
    """The QM decoder of one restart interval (jdarith.c arith_decode):
    registers C and A and the bit counter CT; `data` is the interval's
    bytes with stuffing removed, followed by zeros without end."""

    __slots__ = ("data", "pos", "c", "a", "ct")

    def __init__(self, data: bytes):
        self.data, self.pos, self.c, self.a, self.ct = data, 0, 0, 0, -16

    def __call__(self, st: bytearray, i: int) -> int:
        """The next binary decision, coded in statistics bin st[i] (bit 7
        the MPS, bits 0-6 the state), which it updates."""
        a = self.a
        if a < 0x8000:  # renormalise, reading a byte each 8 bits (D.2.6)
            c, ct, pos, data = self.c, self.ct, self.pos, self.data
            while a < 0x8000:
                ct -= 1
                if ct < 0:
                    c = (c << 8) | (data[pos] if pos < len(data) else 0)
                    pos += 1
                    ct += 8
                    if ct < 0:
                        ct += 1
                        if ct == 0:  # the two first bytes read: A starts at 0x10000
                            a = 0x8000
                a <<= 1
            self.c, self.ct, self.pos = c, ct, pos
        sv = st[i]
        qe, lps, mps = QE[sv & 0x7F]
        a -= qe
        temp = a << self.ct
        if self.c >= temp:  # the lower subinterval: an LPS, or an MPS after an exchange
            self.c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ mps
            else:
                st[i] = (sv & 0x80) ^ lps
                sv ^= 0x80
            a = qe
        elif a < 0x8000:  # renormalisation follows: the estimate moves
            if a < qe:
                st[i] = (sv & 0x80) ^ lps
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ mps
        self.a = a
        return sv >> 7


def _jcoef(v: int) -> int:
    """v as a 16-bit JCOEF stores it."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _magnitude(dec, st, i: int, m: int) -> int:
    """Figure F.24: the low bits of a magnitude of category m (a power of
    two, or 0), from bin i + 14 on; returns |v| - 1."""
    v = m
    i += 14
    m >>= 1
    while m:
        if dec(st, i):
            v |= m
        m >>= 1
    return v


def _dc_diff(dec, st, s: int, lo: int, hi: int):
    """Figures F.19-F.24: a DC difference coded from context bin s; returns
    (difference, the next block's context). lo and hi are the
    conditioning bounds (1 << L) >> 1 and (1 << U) >> 1."""
    if not dec(st, s):
        return 0, 0
    sign = dec(st, s + 1)
    i = s + 2 + sign
    m = dec(st, i)
    if m:
        i = DC_X1
        while dec(st, i):
            m <<= 1
            if m == 0x8000:
                raise _Stop
            i += 1
    ctx = 0 if m < lo else 12 + 4 * sign if m > hi else 4 + 4 * sign
    v = _magnitude(dec, st, i, m) + 1
    return (-v if sign else v), ctx


def _ac_value(dec, st, fixed, i: int, k: int, kx: int) -> int:
    """Figures F.21-F.24: an AC value whose 'nonzero' decision was bin i +
    1; the sign at the fixed probability."""
    sign = dec(fixed, 0)
    i += 2
    m = dec(st, i)
    if m and dec(st, i):
        m <<= 1
        i = AC_X2_LOW if k <= kx else AC_X2_HIGH
        while dec(st, i):
            m <<= 1
            if m == 0x8000:
                raise _Stop
            i += 1
    v = _magnitude(dec, st, i, m) + 1
    return -v if sign else v


class Scan:
    """The arithmetic decoder of one scan over its restart intervals. It
    fills the coefficient band that utils/image_decode's Huffman scans fill
    (block i's coefficient k, zig-zag, at bases[i] + k; the band holds the
    coefficients so far, and a first pass writes only what it decodes, as
    libjpeg does); `slots` gives each block's component in the scan and
    `tables` each component's (DC table, AC table). `dc_cond` and `ac_k`
    hold the DAC segments' values by table (the defaults where absent)."""

    def __init__(self, bases, slots, band, tables, progressive: bool, ss: int, se: int, ah: int,
                 al: int, dc_cond: dict, ac_k: dict):
        self.bases, self.slots, self.band, self.tables = bases, slots, band, tables
        self.ss, self.se, self.al, self.ac_k = ss, se, al, ac_k
        self.lohi = {t: ((1 << lo) >> 1, (1 << up) >> 1)
                     for t, (lo, up) in ((t, dc_cond.get(t, DEFAULT_DC)) for t, _ in tables)}
        if not progressive:
            self.kind = _sequential
        elif ss == 0:
            self.kind = _dc_refine if ah else _dc_first
        else:
            self.kind = _ac_refine if ah else _ac_first

    def interval(self, ent, b0: int, b1: int, s: int, e: int, eof: bool, flag, per_mcu):
        """Decode restart interval b0..b1 from the scan data's bits s..e
        (ent.d, stuffing removed), zeros after them as after a marker:
        statistics, predictions and contexts start afresh (jdarith.c
        process_restart). Returns (b1, False), or None where the decoder
        reads past the data's end (eof): libjpeg's arithmetic decoder cannot
        suspend."""
        data = ent.d[s >> 3:e >> 3].tobytes()
        dec = Decoder(data)
        dc_stats = [bytearray(DC_BINS) for _ in range(16)]
        ac_stats = [bytearray(AC_BINS) for _ in range(16)]
        try:
            self.kind(dec, range(b0, b1), self.bases, self.slots, self.band, self.tables,
                      dc_stats, ac_stats, bytearray([FIXED]), self.lohi, self.ac_k, self.ss,
                      self.se, self.al)
        except _Stop:
            pass  # the rest of the interval keeps what it held
        return None if eof and dec.pos > len(data) else (b1, False)


def _sequential(dec, blocks, bases, slots, band, tables, dc_stats, ac_stats, fixed, lohi, ac_k,
                ss, se, al):
    """jdarith.c decode_mcu: each block's DC difference (16-bit
    predictions) and its 63 ACs."""
    pred, ctx = [0] * len(tables), [0] * len(tables)
    for i in blocks:
        s = slots[i]
        dt, at = tables[s]
        st = dc_stats[dt]
        lo, hi = lohi[dt]
        v, ctx[s] = _dc_diff(dec, st, ctx[s], lo, hi)
        pred[s] = (pred[s] + v) & 0xFFFF
        base = bases[i]
        band[base] = _jcoef(pred[s])
        st, kx = ac_stats[at], ac_k.get(at, DEFAULT_AC)
        k = 1
        while k <= 63:
            j = 3 * (k - 1)
            if dec(st, j):  # end of block
                break
            while not dec(st, j + 1):
                j += 3
                k += 1
                if k > 63:
                    raise _Stop
            band[base + k] = _jcoef(_ac_value(dec, st, fixed, j, k, kx))
            k += 1


def _dc_first(dec, blocks, bases, slots, band, tables, dc_stats, ac_stats, fixed, lohi, ac_k,
              ss, se, al):
    """decode_mcu_DC_first: each block's DC, shifted left by Al."""
    pred, ctx = [0] * len(tables), [0] * len(tables)
    for i in blocks:
        s = slots[i]
        dt = tables[s][0]
        lo, hi = lohi[dt]
        v, ctx[s] = _dc_diff(dec, dc_stats[dt], ctx[s], lo, hi)
        pred[s] = (pred[s] + v) & 0xFFFF
        band[bases[i]] = _jcoef(pred[s] << al)


def _ac_first(dec, blocks, bases, slots, band, tables, dc_stats, ac_stats, fixed, lohi, ac_k,
              ss, se, al):
    """decode_mcu_AC_first: band Ss..Se of one component, each nonzero
    value shifted left by Al."""
    at = tables[0][1]
    st, kx = ac_stats[at], ac_k.get(at, DEFAULT_AC)
    for i in blocks:
        base = bases[i]
        k = ss
        while k <= se:
            j = 3 * (k - 1)
            if dec(st, j):
                break
            while not dec(st, j + 1):
                j += 3
                k += 1
                if k > se:
                    raise _Stop
            band[base + k] = _jcoef(_ac_value(dec, st, fixed, j, k, kx) << al)
            k += 1


def _dc_refine(dec, blocks, bases, slots, band, tables, dc_stats, ac_stats, fixed, lohi, ac_k,
               ss, se, al):
    """decode_mcu_DC_refine: bit Al of each block's DC, at the fixed
    probability."""
    p1 = 1 << al
    for i in blocks:
        if dec(fixed, 0):
            band[bases[i]] = _jcoef(band[bases[i]] | p1)


def _ac_refine(dec, blocks, bases, slots, band, tables, dc_stats, ac_stats, fixed, lohi, ac_k,
               ss, se, al):
    """decode_mcu_AC_refine: a correction bit for each coefficient already
    nonzero, and newly nonzero ones of +-2**Al; the end-of-block decision
    is coded only past the last coefficient the earlier scans made
    nonzero (EOBx)."""
    at = tables[0][1]
    st = ac_stats[at]
    p1, m1 = 1 << al, -1 << al
    for i in blocks:
        base = bases[i]
        kex = se
        while kex >= ss and not band[base + kex]:
            kex -= 1
        k = ss
        while k <= se:
            j = 3 * (k - 1)
            if k > kex and dec(st, j):
                break
            while True:
                c = band[base + k]
                if c:  # previously nonzero: its correction bit
                    if dec(st, j + 2):
                        band[base + k] = _jcoef(c + (m1 if c < 0 else p1))
                    break
                if dec(st, j + 1):  # newly nonzero
                    band[base + k] = m1 if dec(fixed, 0) else p1
                    break
                j += 3
                k += 1
                if k > se:
                    raise _Stop
            k += 1
