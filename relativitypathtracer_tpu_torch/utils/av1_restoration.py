"""AV1 loop restoration (AV1 specification sections 5.11.57-58 and 7.17):
the units' coefficients read from the tiles, and the Wiener and
self-guided filters over the frame, to the bit.

Reading: `read_lr` at each superblock reads the units whose top-left
corner it covers (unit sizes from lr_unit_shift and lr_uv_shift, the
counts rounded as count_units_in_frame rounds them): use_wiener,
use_sgrproj or the switchable restoration_type, then the Wiener taps (3 a
pass; chroma's first is 0) or the self-guided set and its two projection
weights, each coded in subexp against the tile's reference values (reset
at each tile) and becoming the next reference.

Filtering runs after CDEF on each plane's visible area. A 4x4 luma block
(its chroma share in subsampled planes) lies in the 64-row stripe that
starts 8 luma rows above the superblock rows, and in the unit whose rows
are offset the same way. A filter tap reads the CDEF output inside the
block's stripe, and the deblocked frame before CDEF above and below it,
at most 2 rows past the stripe; rows and columns are clamped to the
plane's edges. Within one (stripe, unit) rectangle every pixel sees the
same rules, so each rectangle is one numpy pass:
- Wiener: the 7-tap separable filter (chroma's outer taps 0), horizontal
  then vertical, rounded at InterRound0 and InterRound1 (3 and 11; 5 and 9
  at 12 bits), the intermediate clamped to BitDepth + 8 - InterRound0 bits
  about its offset;
- self-guided: box sums of radius 2 (used on every other row) and 1, the
  variance (the sums rounded down to 8-bit scale) through x/(x+1) and 1/n
  at 12 bits, the 3x3 weighted sums of A and B, and the two projections'
  weights.
Both clip their output to (1 << BitDepth) - 1.
"""

from __future__ import annotations

import numpy as np

from . import av1_tables as T


def reset_refs(dec) -> None:
    """The tile's reference values (RefLrWiener, RefSgrXqd)."""
    dec.ref_wiener = [[list(T.WIENER_TAPS_MID) for _ in range(2)] for _ in range(3)]
    dec.ref_sgr = [list(T.SGRPROJ_XQD_MID) for _ in range(3)]


def _count(size: int, length: int) -> int:
    return max((length + (size >> 1)) // size, 1)


def _plane_size(dec, plane: int) -> tuple:
    sx, sy = (dec.ssx, dec.ssy) if plane else (0, 0)
    return (dec.fh.width + sx) >> sx, (dec.fh.height + sy) >> sy


def _subexp(sd, num_syms: int, k: int) -> int:
    i = mk = 0
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if num_syms <= mk + 3 * a:
            return sd.read_ns(num_syms - mk) + mk
        if not sd.read_literal(1):
            return sd.read_literal(b2) + mk
        i += 1
        mk += a


def _recenter(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    return r - ((v + 1) >> 1) if v & 1 else r + (v >> 1)


def _signed_subexp(sd, low: int, high: int, k: int, ref: int) -> int:
    mx, r = high - low, ref - low
    v = _subexp(sd, mx, k)
    x = _recenter(r, v) if (r << 1) <= mx else mx - 1 - _recenter(mx - 1 - r, v)
    return x + low


def read_lr(dec, r: int, c: int, bsize: int) -> None:
    fh = dec.fh
    if fh.allow_intrabc:
        return
    n4 = T.BLOCK_SIZES[bsize][0] >> 2
    for plane in range(dec.num_planes):
        if fh.lr_type[plane] == T.RESTORE_NONE:
            continue
        sx, sy = (dec.ssx, dec.ssy) if plane else (0, 0)
        size = fh.lr_unit_size[plane]
        pw, ph = _plane_size(dec, plane)
        rows, cols = _count(size, ph), _count(size, pw)
        row0 = (r * (4 >> sy) + size - 1) // size
        row1 = min(rows, ((r + n4) * (4 >> sy) + size - 1) // size)
        col0 = (c * (4 >> sx) + size - 1) // size
        col1 = min(cols, ((c + n4) * (4 >> sx) + size - 1) // size)
        for ur in range(row0, row1):
            for uc in range(col0, col1):
                _read_unit(dec, plane, ur, uc)


def _read_unit(dec, plane: int, ur: int, uc: int) -> None:
    sd, cdf = dec.sd, dec.cdf
    frame_type = dec.fh.lr_type[plane]
    if frame_type == T.RESTORE_WIENER:
        typ = T.RESTORE_WIENER if sd.read_symbol(cdf["use_wiener"]) else T.RESTORE_NONE
    elif frame_type == T.RESTORE_SGRPROJ:
        typ = T.RESTORE_SGRPROJ if sd.read_symbol(cdf["use_sgrproj"]) else T.RESTORE_NONE
    else:
        typ = sd.read_symbol(cdf["restoration_type"])
    if typ != T.RESTORE_NONE:
        dec.tools.add(("restored unit", "Wiener" if typ == T.RESTORE_WIENER else "self-guided"))
    if typ == T.RESTORE_WIENER:
        taps = []
        for ps in range(2):
            ref = dec.ref_wiener[plane][ps]
            coef = [0, 0, 0]
            for j in range(1 if plane else 0, 3):
                coef[j] = ref[j] = _signed_subexp(sd, T.WIENER_TAPS_MIN[j],
                                                  T.WIENER_TAPS_MAX[j] + 1, T.WIENER_TAPS_K[j],
                                                  ref[j])
            taps.append(coef)
        dec.lr_units[plane][(ur, uc)] = (typ, taps)
    elif typ == T.RESTORE_SGRPROJ:
        sgr_set = sd.read_literal(4)
        ref = dec.ref_sgr[plane]
        for i in range(2):
            lo, hi = T.SGRPROJ_XQD_MIN[i], T.SGRPROJ_XQD_MAX[i]
            if T.SGR_PARAMS[sgr_set][2 * i]:
                ref[i] = _signed_subexp(sd, lo, hi + 1, 4, ref[i])
            else:
                ref[i] = 0 if i == 0 else min(max((1 << 7) - ref[0], lo), hi)
        dec.lr_units[plane][(ur, uc)] = (typ, (sgr_set, tuple(ref)))


# --- filtering --------------------------------------------------------------------------

def loop_restoration(dec, deblocked: list, cdef: list) -> list:
    """The planes after loop restoration (`cdef` where a plane or a unit
    restores nothing), from the deblocked planes and CDEF's output."""
    fh = dec.fh
    out = list(cdef)
    for plane in range(dec.num_planes):
        if fh.lr_type[plane] == T.RESTORE_NONE or not dec.lr_units[plane]:
            continue
        sy = dec.ssy if plane else 0
        size = fh.lr_unit_size[plane]
        pw, ph = _plane_size(dec, plane)
        rows, cols = _count(size, ph), _count(size, pw)
        y = np.arange(ph)
        luma4 = ((y << sy) >> 2) * 4  # each row's 4x4 luma block row, in samples
        stripe = (luma4 + 8) // 64
        unit_row = np.minimum(rows - 1, ((luma4 + 8) >> sy) // size)
        unit_col = np.minimum(cols - 1, np.arange(pw) // size)
        res = cdef[plane].copy()
        key = stripe * 4096 + unit_row
        starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        ends = np.r_[starts[1:], ph]
        cstarts = np.flatnonzero(np.r_[True, unit_col[1:] != unit_col[:-1]])
        cends = np.r_[cstarts[1:], pw]
        for y0, y1 in zip(starts, ends):
            s = int(stripe[y0])
            top = (-8 + 64 * s) >> sy
            bottom = top + (64 >> sy) - 1
            src = _source(deblocked[plane], cdef[plane], y0, y1, pw, ph, top, bottom)
            for x0, x1 in zip(cstarts, cends):
                unit = dec.lr_units[plane].get((int(unit_row[y0]), int(unit_col[x0])))
                if unit is None:
                    continue
                block = src[:, x0:x1 + 6]
                if unit[0] == T.RESTORE_WIENER:
                    res[y0:y1, x0:x1] = _wiener(block, unit[1], dec.bit_depth)
                else:
                    res[y0:y1, x0:x1] = _self_guided(block, unit[1], y0, dec.bit_depth)
        out[plane] = res
    return out


def _source(pre: np.ndarray, post: np.ndarray, y0: int, y1: int, pw: int, ph: int, top: int,
            bottom: int) -> np.ndarray:
    """get_source_sample over rows y0 - 3 .. y1 + 2 and columns -3 .. pw + 2."""
    ys = np.clip(np.arange(y0 - 3, y1 + 3), 0, ph - 1)
    xs = np.clip(np.arange(-3, pw + 3), 0, pw - 1)
    above, below = ys < top, ys > bottom
    ys = np.where(above, np.maximum(top - 2, ys), np.where(below, np.minimum(bottom + 2, ys), ys))
    rows = np.where((above | below)[:, None], pre[ys][:, xs], post[ys][:, xs])
    return rows.astype(np.int64)


def _wiener(src: np.ndarray, taps: list, depth: int = 8) -> np.ndarray:
    """src: the rectangle's rows and columns with 3 more on each side."""
    def kernel(c):
        return (c[0], c[1], c[2], 128 - 2 * (c[0] + c[1] + c[2]), c[2], c[1], c[0])

    round0 = 5 if depth == 12 else 3
    round1 = 14 - round0
    offset = 1 << (depth + 6 - round0)
    limit = (1 << (depth + 8 - round0)) - 1
    vk, hk = kernel(taps[0]), kernel(taps[1])
    w = src.shape[1] - 6
    s = sum(hk[t] * src[:, t:t + w] for t in range(7))
    inter = np.clip((s + (1 << (round0 - 1))) >> round0, -offset, limit - offset)
    h = src.shape[0] - 6
    s = sum(vk[t] * inter[t:t + h] for t in range(7))
    return np.clip((s + (1 << (round1 - 1))) >> round1, 0, (1 << depth) - 1)


def _box(src: np.ndarray, r: int) -> tuple:
    """Sums and sums of squares over (2r + 1)^2 windows centred on the
    rectangle's samples and one ring around them (src has 3 more)."""
    h, w = src.shape[0] - 4, src.shape[1] - 4
    out = []
    for v in (src, src * src):
        c = np.zeros((v.shape[0] + 1, v.shape[1] + 1), np.int64)
        c[1:, 1:] = v.cumsum(0).cumsum(1)
        a0, a1 = 2 - r, 3 + r
        out.append(c[a1:a1 + h, a1:a1 + w] - c[a0:a0 + h, a1:a1 + w]
                   - c[a1:a1 + h, a0:a0 + w] + c[a0:a0 + h, a0:a0 + w])
    return out[0], out[1]


def _ab(src: np.ndarray, r: int, s: int, depth: int = 8) -> tuple:
    b, a = _box(src, r)
    n = (2 * r + 1) ** 2
    if depth > 8:
        sh = depth - 8
        a = (a + (1 << (2 * sh - 1))) >> (2 * sh)
        d = (b + (1 << (sh - 1))) >> sh
        p = np.maximum(0, a * n - d * d)
    else:
        p = np.maximum(0, a * n - b * b)
    z = (p * s + (1 << 19)) >> 20
    a2 = np.array(T.SGR_X_BY_XPLUS1, np.int64)[np.minimum(z, 255)]
    b2 = (256 - a2) * b * T.SGR_ONE_BY_X[n]
    return a2, (b2 + 2048) >> 12


def _self_guided(src: np.ndarray, params: tuple, y0: int, depth: int = 8) -> np.ndarray:
    sgr_set, (w0, w1) = params
    r0, s0, r1, s1 = T.SGR_PARAMS[sgr_set]
    h, w = src.shape[0] - 6, src.shape[1] - 6
    x = src[3:3 + h, 3:3 + w]
    u = x << 4
    v = w1 * u
    w2 = (1 << 7) - w0 - w1
    if r0:
        a, b = _ab(src, 2, s0, depth)  # (h + 2, w + 2): one ring around the rectangle

        def odd_rows(m, i0, i1):  # rows i0 .. i1 - 1 of the ring's frame
            return 6 * m[i0:i1, 1:1 + w] + 5 * (m[i0:i1, 0:w] + m[i0:i1, 2:2 + w])

        odd = ((y0 + np.arange(h)) & 1).astype(bool)[:, None]
        fa = np.where(odd, odd_rows(a, 1, 1 + h), odd_rows(a, 0, h) + odd_rows(a, 2, 2 + h))
        fb = np.where(odd, odd_rows(b, 1, 1 + h), odd_rows(b, 0, h) + odd_rows(b, 2, 2 + h))
        t = fa * x + fb
        flt = np.where(odd, (t + (1 << 7)) >> 8, (t + (1 << 8)) >> 9)
        v = v + w0 * flt
    else:
        v = v + w0 * u
    if r1:
        a, b = _ab(src, 1, s1, depth)

        def cross(m):
            return (4 * (m[1:1 + h, 1:1 + w] + m[0:h, 1:1 + w] + m[2:2 + h, 1:1 + w]
                         + m[1:1 + h, 0:w] + m[1:1 + h, 2:2 + w])
                    + 3 * (m[0:h, 0:w] + m[0:h, 2:2 + w] + m[2:2 + h, 0:w] + m[2:2 + h, 2:2 + w]))

        flt = (cross(a) * x + cross(b) + (1 << 8)) >> 9
        v = v + w2 * flt
    else:
        v = v + w2 * u
    return np.clip((v + (1 << 10)) >> 11, 0, (1 << depth) - 1)
