"""JPEG 2000 tier 1 in Python and numpy: the MQ decoder and EBCOT's
coding passes, one code-block at a time, as OpenJPEG 2.5.4 (t1.c, mqc.c)
decodes them.

The MQ coder is JPEG 2000's (ITU-T T.800 Annex C): 47 states and 19
contexts, not the QM coder of arithmetic-coded JPEG (utils/jpeg_arith),
whose tables and register conventions differ. A segment's bytes are read
with two 0xFF bytes after them, as OpenJPEG appends them, so a decoder
that runs past the end reads ones. In BYPASS (lazy) mode the significance
and refinement passes of the fourth bit-plane on are raw bits with JPEG
2000's bit stuffing (a 0xFF byte's successor gives 7 bits).

Coefficients are kept as OpenJPEG keeps them, with one bit below the
least significant bit-plane: a coefficient that becomes significant at
plane p is 3 * 2**p (the mid-point, "one plus half"), a refinement bit
adds or takes 2**p. The caller halves them (5/3) or scales them by half
the step size (9/7). ROI maxshift (RGN) then shifts down every magnitude
of at least 2**shift, again as OpenJPEG does.

The code-block styles are those of COD/COC's SPcod: BYPASS (1), RESET (2),
TERMALL (4), VSC (8), PTERM (16, only the encoder's termination) and
SEGSYM (32); tier 2 splits the passes into segments by them.
"""

from __future__ import annotations

import numpy as np

BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32

# T.800 Table C.2: Qe, the next state on an MPS and on an LPS, the switch
_QE = (0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801,
       0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401,
       0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101,
       0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
       0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601)
_NMPS = (1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23,
         24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44,
         45, 45, 46)
_NLPS = (1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19,
         20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
         41, 42, 43, 46)
_SWITCH = (1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1) + (0,) * 32

_CTX_AGG, _CTX_UNI = 17, 18  # run-length and uniform contexts


def _zc_table(orient: int) -> tuple:
    """T.800 Table D.1: the zero-coding context of each neighbourhood
    key h * 15 + v * 5 + d (h, v: significant horizontal and vertical
    neighbours, 0-2; d: diagonal ones, 0-4) for a band's orientation
    (0 LL, 1 HL, 2 LH, 3 HH)."""
    out = []
    for key in range(45):
        h, v, d = key // 15, key // 5 % 3, key % 5
        if orient == 1:
            h, v = v, h
        if orient == 3:
            hv = h + v
            n = ((0 if not hv else 1 if hv == 1 else 2) if not d else
                 (3 if not hv else 4 if hv == 1 else 5) if d == 1 else
                 (6 if not hv else 7) if d == 2 else 8)
        elif h == 2:
            n = 8
        elif h == 1:
            n = 7 if v else 6 if d else 5
        else:
            n = 4 if v == 2 else 3 if v == 1 else 2 if d >= 2 else d
        out.append(n)
    return tuple(out)


_ZC = tuple(_zc_table(o) for o in range(4))
# T.800 Table D.3: (context, XOR bit) of the sign by the clipped horizontal
# and vertical contributions (each -1, 0, 1), at index (h + 1) * 3 + v + 1
_SC = ((13, 1), (12, 1), (11, 1), (10, 1), (9, 0), (10, 0), (11, 0), (12, 0), (13, 0))


class Tier1Error(ValueError):
    pass


def decode_codeblock(w: int, h: int, orient: int, numbps: int, roishift: int, style: int,
                     segments) -> np.ndarray:
    """(h, w) int32: a code-block's coefficients as OpenJPEG's
    opj_t1_decode_cblk leaves them (module docstring), ROI shift applied.
    `segments` is the code-block's codeword segments in order, each
    (bytes, passes); `numbps` the code-block's magnitude bit-planes
    (the band's Mb less its zero bit-planes)."""
    bpno = roishift + numbps
    if bpno >= 31:
        raise Tier1Error(f"a code-block of {bpno} bit-planes (more than 30)")
    W = w + 2
    size = W * (h + 2)
    sig = [0] * size  # significant
    neg = [0] * size  # its sign
    mag = [0] * size
    nb = [0] * size  # zero-coding key of the significant neighbours
    visit = [-1] * size  # bit-plane of the last significance-pass visit
    refined = [0] * size
    zc = _ZC[orient]
    vsc = bool(style & VSC)
    st, mps = [0] * 19, [0] * 19

    def reset():
        for i in range(19):
            st[i] = mps[i] = 0
        st[_CTX_UNI], st[_CTX_AGG], st[0] = 46, 3, 4

    reset()
    # the MQ decoder's registers; buf is the segment with 0xFF 0xFF after it
    a = c = ct = bp = 0
    buf = b""

    def bytein():
        nonlocal c, ct, bp
        if buf[bp] == 0xFF:
            if buf[bp + 1] > 0x8F:
                c += 0xFF00
                ct = 8
            else:
                bp += 1
                c += buf[bp] << 9
                ct = 7
        else:
            bp += 1
            c += buf[bp] << 8
            ct = 8

    def decode(cx: int) -> int:
        nonlocal a, c, ct
        s = st[cx]
        qe = _QE[s]
        a -= qe
        if (c >> 16) < qe:
            if a < qe:
                d = mps[cx]
                st[cx] = _NMPS[s]
            else:
                d = 1 - mps[cx]
                if _SWITCH[s]:
                    mps[cx] = d
                st[cx] = _NLPS[s]
            a = qe
        else:
            c -= qe << 16
            if a & 0x8000:
                return mps[cx]
            if a < qe:
                d = 1 - mps[cx]
                if _SWITCH[s]:
                    mps[cx] = d
                st[cx] = _NLPS[s]
            else:
                d = mps[cx]
                st[cx] = _NMPS[s]
        while True:  # RENORMD
            if ct == 0:
                bytein()
            a <<= 1
            c = (c << 1) & 0xFFFFFFFF
            ct -= 1
            if a & 0x8000:
                return d

    def raw() -> int:
        nonlocal c, ct, bp
        if ct == 0:
            if c == 0xFF:
                if buf[bp] > 0x8F:
                    ct = 8
                else:
                    c = buf[bp]
                    bp += 1
                    ct = 7
            else:
                c = buf[bp]
                bp += 1
                ct = 8
        ct -= 1
        return (c >> ct) & 1

    def significant(p: int, y: int, negative: int, one: int) -> None:
        sig[p] = 1
        neg[p] = negative
        mag[p] = one
        nb[p - 1] += 15
        nb[p + 1] += 15
        nb[p + W] += 5
        nb[p + W - 1] += 1
        nb[p + W + 1] += 1
        if not (vsc and y & 3 == 0):
            nb[p - W] += 5
            nb[p - W - 1] += 1
            nb[p - W + 1] += 1

    def sign_context(p: int, y: int) -> tuple:
        hc = vc = 0
        q = p - 1
        if sig[q]:
            hc += -1 if neg[q] else 1
        q = p + 1
        if sig[q]:
            hc += -1 if neg[q] else 1
        q = p - W
        if sig[q]:
            vc += -1 if neg[q] else 1
        q = p + W
        if sig[q] and not (vsc and y & 3 == 3):
            vc += -1 if neg[q] else 1
        hc = 1 if hc > 0 else -1 if hc < 0 else 0
        vc = 1 if vc > 0 else -1 if vc < 0 else 0
        return _SC[(hc + 1) * 3 + vc + 1]

    # stripes of four rows, column by column: each column's (row, index)
    order = [[(y, (y + 1) * W + x + 1) for y in range(y0, min(y0 + 4, h))]
             for y0 in range(0, h, 4) for x in range(w)]

    def sigpass(plane: int, is_raw: bool) -> None:
        one = 3 << (plane - 1)
        for column in order:
            for y, p in column:
                if sig[p] or not nb[p]:
                    continue
                if is_raw:
                    if raw():
                        significant(p, y, raw(), one)
                elif decode(zc[nb[p]]):
                    cx, xor = sign_context(p, y)
                    significant(p, y, decode(cx) ^ xor, one)
                visit[p] = plane

    def refpass(plane: int, is_raw: bool) -> None:
        half = 1 << (plane - 1)
        for column in order:
            for _, p in column:
                if not sig[p] or visit[p] == plane:
                    continue
                if is_raw:
                    bit = raw()
                else:
                    bit = decode(16 if refined[p] else 15 if nb[p] else 14)
                mag[p] += half if bit else -half
                refined[p] = 1

    def cleanpass(plane: int) -> None:
        one = 3 << (plane - 1)
        for column in order:
            start = 0
            if len(column) == 4:
                p0, p1, p2, p3 = column[0][1], column[1][1], column[2][1], column[3][1]
                if not (sig[p0] or sig[p1] or sig[p2] or sig[p3] or nb[p0] or nb[p1] or nb[p2]
                        or nb[p3] or visit[p0] == plane or visit[p1] == plane
                        or visit[p2] == plane or visit[p3] == plane):
                    if not decode(_CTX_AGG):
                        continue
                    start = decode(_CTX_UNI) << 1
                    start |= decode(_CTX_UNI)
                    y, p = column[start]
                    cx, xor = sign_context(p, y)
                    significant(p, y, decode(cx) ^ xor, one)
                    start += 1
            for y, p in column[start:] if start else column:
                if sig[p] or visit[p] == plane:
                    continue
                if decode(zc[nb[p]]):
                    cx, xor = sign_context(p, y)
                    significant(p, y, decode(cx) ^ xor, one)
        if style & SEGSYM:
            for _ in range(4):
                decode(_CTX_UNI)

    passtype = 2
    for data, passes in segments:
        is_raw = bool(bpno <= numbps - 4 and passtype < 2 and style & BYPASS)
        buf = bytes(data) + b"\xff\xff"
        if is_raw:
            c = ct = bp = 0
        else:  # INITDEC
            bp = 0
            c = buf[0] << 16
            bytein()
            c <<= 7
            ct -= 7
            a = 0x8000
        for _ in range(passes):
            if bpno < 1:
                break
            if passtype == 0:
                sigpass(bpno, is_raw)
            elif passtype == 1:
                refpass(bpno, is_raw)
            else:
                cleanpass(bpno)
            if style & RESET and not is_raw:
                reset()
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno -= 1
    out = np.array(mag, np.int64).reshape(h + 2, W)[1:-1, 1:-1]
    signs = np.array(neg, bool).reshape(h + 2, W)[1:-1, 1:-1]
    if roishift:
        if roishift >= 31:
            out = np.zeros_like(out)
        else:
            out = np.where(out >= 1 << roishift, out >> roishift, out)
    return np.where(signs, -out, out).astype(np.int32)
