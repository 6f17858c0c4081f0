"""AV1 intra prediction and inverse transforms, to the bit (AV1 specification
sections 7.11.2 and 7.13).

Prediction: DC, V, H, the six directional modes with their angle deltas
(the intra edge filter, the corner filter and edge upsampling), SMOOTH,
SMOOTH_V, SMOOTH_H, PAETH, the recursive filter-intra modes and chroma from
luma. The edges come in as the specification's AboveRow and LeftCol
(indices -1 .. w + h - 1, here shifted by 16 so that upsampling's -2 fits).

Transforms: the inverse DCT of 4 to 64 points as the specification's
butterfly steps (B rotations rounded at 12 bits, H additions), the inverse
ADST of 4, 8 and 16 points, the identity of 4 to 32 points and the Walsh-
Hadamard transform of lossless blocks; a 2D transform runs its rows, then
its columns, with the 1:2 rectangles' 2896/4096 scale, the row shift of
each size and, between the passes, dav1d's clamp to Max(BitDepth + 6, 16)
bits. A 1D transform runs
down the columns of an (N, m) array: the butterfly steps are recorded once
(`_Program`) and run a stage of independent steps as one numpy operation.
"""

from __future__ import annotations

import math

import numpy as np

from . import av1_tables as T

_COS128 = tuple(round(4096 * math.cos(i * math.pi / 128)) for i in range(65))
_SINPI = (0, 1321, 2482, 3344, 3803)
EDGE = 16  # offset of index 0 in an edge array


def _cos128(angle: int) -> int:
    a = angle & 255
    if a <= 64:
        return _COS128[a]
    if a <= 128:
        return -_COS128[128 - a]
    if a <= 192:
        return -_COS128[a - 128]
    return _COS128[256 - a]


def _r12(x):
    return (x + 2048) >> 12


class _Program:
    """A 1D transform's butterfly steps, recorded once: an input
    permutation, then B rotations (rounded at 12 bits) and H additions
    (clipped as dav1d clips every butterfly sum: to 16 bits at 8 bits, else
    to BitDepth + 8 bits in the row pass and BitDepth + 6 in the column
    pass; a conforming stream never reaches the clip), then an output order
    with signs. `run` applies it to every column of an (N, m) array at
    once, a stage of independent steps a numpy operation."""

    def __init__(self, perm: list):
        self.perm = perm
        self.ops: list = []
        self.out = None
        self.stages: list = []

    def b(self, a: int, b: int, angle: int, flip: int) -> None:
        self.ops.append(("B", a, b, _cos128(angle), _cos128(angle - 64), flip))

    def h(self, a: int, b: int, flip: int) -> None:
        self.ops.append(("H", b, a, 0, 0, 0) if flip else ("H", a, b, 0, 0, 0))

    def compile(self) -> "_Program":
        stage, used = [], set()
        for op in self.ops + [None]:
            if op is None or (stage and (op[0] != stage[0][0] or op[1] in used or op[2] in used)):
                a = np.array([o[1] for o in stage])
                b = np.array([o[2] for o in stage])
                col = lambda k: np.array([o[k] for o in stage], np.int64)[:, None]  # noqa: E731
                self.stages.append((stage[0][0] == "B", a, b, col(3), col(4),
                                    col(5).astype(bool)))
                stage, used = [], set()
            if op is not None:
                stage.append(op)
                used |= {op[1], op[2]}
        return self

    def run(self, x: np.ndarray, lo: int = -32768, hi: int = 32767) -> np.ndarray:
        x = x[self.perm]
        for rotate, a, b, c, s, flip in self.stages:
            xa, xb = x[a], x[b]
            if rotate:
                u, v = xa * c - xb * s, xa * s + xb * c
                x[a], x[b] = _r12(np.where(flip, v, u)), _r12(np.where(flip, u, v))
            else:
                x[a], x[b] = np.clip(xa + xb, lo, hi), np.clip(xa - xb, lo, hi)
        if self.out is not None:
            x = x[self.out[0]] * self.out[1][:, None]
        return x


def _brev(n: int, x: int) -> int:
    return int(format(x, f"0{n}b")[::-1], 2) if n else 0


def _idct(n: int) -> "_Program":
    """The inverse DCT of 2^n points (7.13.2.3): the bit-reversal
    permutation, then the specification's B and H steps."""
    p = _Program([_brev(n, i) for i in range(1 << n)])
    if n == 6:
        for i in range(16):
            p.b(32 + i, 63 - i, 63 - 4 * _brev(4, i), 0)
    if n >= 5:
        for i in range(8):
            p.b(16 + i, 31 - i, 6 + (_brev(3, 7 - i) << 3), 0)
    if n == 6:
        for i in range(16):
            p.h(32 + i * 2, 33 + i * 2, i & 1)
    if n >= 4:
        for i in range(4):
            p.b(8 + i, 15 - i, 12 + (_brev(2, 3 - i) << 4), 0)
    if n >= 5:
        for i in range(8):
            p.h(16 + 2 * i, 17 + 2 * i, i & 1)
    if n == 6:
        for i in range(4):
            for j in range(2):
                p.b(62 - i * 4 - j, 33 + i * 4 + j, 60 - 16 * _brev(2, i) + 64 * j, 1)
    if n >= 3:
        for i in range(2):
            p.b(4 + i, 7 - i, 56 - 32 * i, 0)
    if n >= 4:
        for i in range(4):
            p.h(8 + 2 * i, 9 + 2 * i, i & 1)
    if n >= 5:
        for i in range(2):
            for j in range(2):
                p.b(30 - 4 * i - j, 17 + 4 * i + j, 24 + (j << 6) + ((1 - i) << 5), 1)
    if n == 6:
        for i in range(8):
            for j in range(2):
                p.h(32 + 4 * i + j, 35 + 4 * i - j, i & 1)
    for i in range(2):
        p.b(2 * i, 2 * i + 1, 32 + 16 * i, 1 - i)
    if n >= 3:
        for i in range(2):
            p.h(4 + 2 * i, 5 + 2 * i, i)
    if n >= 4:
        for i in range(2):
            p.b(14 - i, 9 + i, 48 + 64 * i, 1)
    if n >= 5:
        for i in range(4):
            for j in range(2):
                p.h(16 + 4 * i + j, 19 + 4 * i - j, i & 1)
    if n == 6:
        for i in range(2):
            for j in range(4):
                p.b(61 - i * 8 - j, 34 + i * 8 + j, 56 - i * 32 + (j >> 1) * 64, 1)
    for i in range(2):
        p.h(i, 3 - i, 0)
    if n >= 3:
        p.b(6, 5, 32, 1)
    if n >= 4:
        for i in range(2):
            for j in range(2):
                p.h(8 + 4 * i + j, 11 + 4 * i - j, i)
    if n >= 5:
        for i in range(4):
            p.b(29 - i, 18 + i, 48 + (i >> 1) * 64, 1)
    if n == 6:
        for i in range(4):
            for j in range(4):
                p.h(32 + 8 * i + j, 39 + 8 * i - j, i & 1)
    if n >= 3:
        for i in range(4):
            p.h(i, 7 - i, 0)
    if n >= 4:
        for i in range(2):
            p.b(13 - i, 10 + i, 32, 1)
    if n >= 5:
        for i in range(2):
            for j in range(4):
                p.h(16 + i * 8 + j, 23 + i * 8 - j, i)
    if n == 6:
        for i in range(8):
            p.b(59 - i, 36 + i, 48 if i < 4 else 112, 1)
    if n >= 4:
        for i in range(8):
            p.h(i, 15 - i, 0)
    if n >= 5:
        for i in range(4):
            p.b(27 - i, 20 + i, 32, 1)
    if n == 6:
        for i in range(2):
            for j in range(8):
                p.h(32 + i * 16 + j, 47 + i * 16 - j, i)
    if n >= 5:
        for i in range(16):
            p.h(i, 31 - i, 0)
    if n == 6:
        for i in range(8):
            p.b(55 - i, 40 + i, 32, 1)
        for i in range(32):
            p.h(i, 63 - i, 0)
    return p


def _iadst4(t) -> np.ndarray:
    s0 = _SINPI[1] * t[0]
    s1 = _SINPI[2] * t[0]
    s2 = _SINPI[3] * t[1]
    s3 = _SINPI[4] * t[2]
    s4 = _SINPI[1] * t[2]
    s5 = _SINPI[2] * t[3]
    s6 = _SINPI[4] * t[3]
    b7 = t[0] - t[2] + t[3]
    s0 = s0 + s3 + s5
    s1 = s1 - s4 - s6
    s3 = s2
    s2 = _SINPI[3] * b7
    return np.stack([_r12(s0 + s3), _r12(s1 + s3), _r12(s2), _r12(s0 + s1 - s3)])


def _iadst8() -> "_Program":
    p = _Program([7, 0, 5, 2, 3, 4, 1, 6])
    for i in range(4):
        p.b(2 * i, 2 * i + 1, 60 - 16 * i, 1)
    for i in range(4):
        p.h(i, 4 + i, 0)
    for i in range(2):
        p.b(4 + 3 * i, 5 + i, 48 - 32 * i, 1)
    for i in range(2):
        for j in range(2):
            p.h(4 * j + i, 2 + 4 * j + i, 0)
    for i in range(2):
        p.b(2 + 4 * i, 3 + 4 * i, 32, 1)
    p.out = (np.array([0, 4, 6, 2, 3, 7, 5, 1]), np.array([1, -1, 1, -1, 1, -1, 1, -1]))
    return p


def _iadst16() -> "_Program":
    p = _Program([15 - i if i % 2 == 0 else i - 1 for i in range(16)])
    for i in range(8):
        p.b(2 * i, 2 * i + 1, 62 - 8 * i, 1)
    for i in range(8):
        p.h(i, 8 + i, 0)
    for i in range(2):
        p.b(8 + 2 * i, 9 + 2 * i, 56 - 32 * i, 1)
        p.b(13 + 2 * i, 12 + 2 * i, 8 + 32 * i, 1)
    for i in range(4):
        for j in range(2):
            p.h(8 * j + i, 4 + 8 * j + i, 0)
    for i in range(2):
        for j in range(2):
            p.b(4 + 8 * j + 3 * i, 5 + 8 * j + i, 48 - 32 * i, 1)
    for i in range(2):
        for j in range(4):
            p.h(4 * j + i, 2 + 4 * j + i, 0)
    for i in range(4):
        p.b(2 + 4 * i, 3 + 4 * i, 32, 1)
    p.out = (np.array([0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1]),
             np.array([1, -1] * 8))
    return p


_PROGRAMS = {("dct", n): _idct(n).compile() for n in range(2, 7)}
_PROGRAMS[("adst", 3)] = _iadst8().compile()
_PROGRAMS[("adst", 4)] = _iadst16().compile()


def _identity(x: np.ndarray, n: int) -> np.ndarray:
    if n == 2:
        return _r12(x * 5793)
    if n == 3:
        return x * 2
    if n == 4:
        return _r12(x * 11586)
    return x * 4


def _iwht(t, shift: int) -> np.ndarray:
    a, c, d, b = (x >> shift for x in t)
    a = a + c
    d = d - b
    e = (a - d) >> 1
    b = e - b
    c = e - c
    a = a - b
    d = d + c
    return np.stack([a, b, c, d])


def _1d(x: np.ndarray, kind: int, n: int, bits: int) -> np.ndarray:
    """The 1D transform of kind (0 DCT, 1 and 2 ADST, 3 identity) of 2^n
    points down each column of x (2^n, m), its sums clipped to `bits`."""
    if kind == 3:
        return _identity(x, n)
    if kind != 0 and n == 2:
        return _iadst4(x)
    return _PROGRAMS[("dct" if kind == 0 else "adst", n)].run(x, -(1 << (bits - 1)),
                                                              (1 << (bits - 1)) - 1)


def inverse_transform(coef: np.ndarray, tx: int, tx_type: int, lossless: bool,
                      bit_depth: int = 8) -> np.ndarray:
    """Residual (h, w) int64 of dequantised coefficients (h, w), row-major
    (7.13.3): rows, the clamp, columns; flips are the caller's."""
    h, w = coef.shape
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    if lossless:
        res = _iwht(coef.astype(np.int64).T, 2).T
        return _iwht(res, 0)
    vk, hk = T.TX_1D[tx_type]
    nrows = min(h, 32)
    x = coef[:nrows].astype(np.int64)
    if abs(log2w - log2h) == 1:
        x = _r12(x * 2896)
    row_bits, col_bits = max(bit_depth + 8, 16), max(bit_depth + 6, 16)
    rowout = _1d(x.T, hk, log2w, row_bits).T
    shift = T.TX_ROW_SHIFT[tx]
    if shift:
        rowout = (rowout + (1 << (shift - 1))) >> shift
    res = np.zeros((h, w), np.int64)
    res[:nrows] = np.clip(rowout, -(1 << (col_bits - 1)), (1 << (col_bits - 1)) - 1)
    return (_1d(res, vk, log2h, col_bits) + 8) >> 4


# --- prediction ---------------------------------------------------------

_EDGE_KERNEL = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))


def edge_filter_strength(w: int, h: int, filter_type: int, delta: int) -> int:
    d = abs(delta)
    wh = w + h
    s = 0
    if filter_type == 0:
        if wh <= 8:
            s = 1 if d >= 56 else 0
        elif wh <= 16:
            s = 1 if d >= 40 else 0
        elif wh <= 24:
            s = 3 if d >= 32 else 2 if d >= 16 else 1 if d >= 8 else 0
        elif wh <= 32:
            s = 3 if d >= 32 else 2 if d >= 4 else 1 if d >= 1 else 0
        else:
            s = 3 if d >= 1 else 0
    else:
        if wh <= 8:
            s = 2 if d >= 64 else 1 if d >= 40 else 0
        elif wh <= 16:
            s = 2 if d >= 48 else 1 if d >= 20 else 0
        elif wh <= 24:
            s = 3 if d >= 4 else 0
        else:
            s = 3 if d >= 1 else 0
    return s


def edge_filter(edge: list, sz: int, strength: int) -> None:
    """Filter edge[EDGE - 1 .. EDGE + sz - 2] in place (7.11.2.12)."""
    if strength == 0:
        return
    k = _EDGE_KERNEL[strength - 1]
    src = edge[EDGE - 1:EDGE - 1 + sz]
    for i in range(1, sz):
        s = 0
        for j in range(5):
            s += k[j] * src[min(max(i - 2 + j, 0), sz - 1)]
        edge[EDGE + i - 1] = (s + 8) >> 4


def use_upsample(w: int, h: int, filter_type: int, delta: int) -> bool:
    d = abs(delta)
    if d <= 0 or d >= 40:
        return False
    return w + h <= (8 if filter_type else 16)


def upsample(edge: list, num_px: int, top: int = 255) -> None:
    """Double edge[EDGE - 1 ..] in place (7.11.2.11); the result runs from
    index EDGE - 2."""
    dup = [0] * (num_px + 3)
    dup[0] = edge[EDGE - 1]
    for i in range(-1, num_px):
        dup[i + 2] = edge[EDGE + i]
    dup[num_px + 2] = edge[EDGE + num_px - 1]
    edge[EDGE - 2] = dup[0]
    for i in range(num_px):
        s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3]
        edge[EDGE + 2 * i - 1] = min(max((s + 8) >> 4, 0), top)
        edge[EDGE + 2 * i] = dup[i + 2]


def directional(above: list, left: list, w: int, h: int, angle: int, up_a: int,
                up_l: int) -> np.ndarray:
    """7.11.2.4's final step: the (h, w) prediction from prepared edges."""
    a = np.array(above, np.int64)
    lc = np.array(left, np.int64)
    i = np.arange(h)[:, None]
    j = np.arange(w)[None, :]
    if angle == 90:
        return np.broadcast_to(a[EDGE:EDGE + w][None, :], (h, w)).copy()
    if angle == 180:
        return np.broadcast_to(lc[EDGE:EDGE + h][:, None], (h, w)).copy()
    dx = dy = 0
    if angle < 90:
        dx = T.DR_INTRA_DERIVATIVE[angle]
    elif angle < 180:
        dx = T.DR_INTRA_DERIVATIVE[180 - angle]
    if 90 < angle < 180:
        dy = T.DR_INTRA_DERIVATIVE[angle - 90]
    elif angle > 180:
        dy = T.DR_INTRA_DERIVATIVE[270 - angle]
    if angle < 90:
        idx = (i + 1) * dx
        base = (idx >> (6 - up_a)) + (j << up_a)
        shift = ((idx << up_a) >> 1) & 0x1F
        max_base = (w + h - 1) << up_a
        bc = np.minimum(base, max_base)
        v = (a[EDGE + bc] * (32 - shift) + a[EDGE + np.minimum(bc + 1, len(a) - EDGE - 1)]
             * shift + 16) >> 5
        return np.where(base < max_base, v, a[EDGE + max_base])
    if angle < 180:
        idx = (j << 6) - (i + 1) * dx
        base = idx >> (6 - up_a)
        shift = ((idx << up_a) >> 1) & 0x1F
        use_a = base >= -(1 << up_a)
        bs = np.where(use_a, base, 0)
        va = (a[EDGE + bs] * (32 - shift) + a[EDGE + bs + 1] * shift + 16) >> 5
        idx2 = (i << 6) - (j + 1) * dy
        base2 = idx2 >> (6 - up_l)
        shift2 = ((idx2 << up_l) >> 1) & 0x1F
        bl = np.where(use_a, 0, base2)
        vl = (lc[EDGE + bl] * (32 - shift2) + lc[EDGE + bl + 1] * shift2 + 16) >> 5
        return np.where(use_a, va, vl)
    idx = (j + 1) * dy
    base = (idx >> (6 - up_l)) + (i << up_l)
    shift = ((idx << up_l) >> 1) & 0x1F
    return (lc[EDGE + base] * (32 - shift) + lc[EDGE + base + 1] * shift + 16) >> 5


def smooth(above: list, left: list, w: int, h: int, mode: int) -> np.ndarray:
    a = np.array(above[EDGE:EDGE + w], np.int64)[None, :]
    lc = np.array(left[EDGE:EDGE + h], np.int64)[:, None]
    wx = np.array(T.sm_weights(w.bit_length() - 1), np.int64)[None, :]
    wy = np.array(T.sm_weights(h.bit_length() - 1), np.int64)[:, None]
    bottom, right = left[EDGE + h - 1], above[EDGE + w - 1]
    if mode == T.SMOOTH_PRED:
        p = wy * a + (256 - wy) * bottom + wx * lc + (256 - wx) * right
        return (p + 256) >> 9
    if mode == T.SMOOTH_V_PRED:
        return (wy * a + (256 - wy) * bottom + 128) >> 8
    return (wx * lc + (256 - wx) * right + 128) >> 8


def paeth(above: list, left: list, w: int, h: int) -> np.ndarray:
    a = np.array(above[EDGE:EDGE + w], np.int64)[None, :]
    lc = np.array(left[EDGE:EDGE + h], np.int64)[:, None]
    tl = above[EDGE - 1]
    base = a + lc - tl
    pl, pt, ptl = np.abs(base - lc), np.abs(base - a), np.abs(base - tl)
    return np.where((pl <= pt) & (pl <= ptl), lc, np.where(pt <= ptl, a, tl))


def dc(above: list, left: list, w: int, h: int, have_above: bool,
       have_left: bool, mid: int = 128) -> np.ndarray:
    if have_above and have_left:
        s = sum(above[EDGE:EDGE + w]) + sum(left[EDGE:EDGE + h])
        v = (s + ((w + h) >> 1)) // (w + h)
    elif have_left:
        v = (sum(left[EDGE:EDGE + h]) + (h >> 1)) >> (h.bit_length() - 1)
    elif have_above:
        v = (sum(above[EDGE:EDGE + w]) + (w >> 1)) >> (w.bit_length() - 1)
    else:
        v = mid
    return np.full((h, w), v, np.int64)


def filter_intra(above: list, left: list, w: int, h: int, mode: int,
                 top: int = 255) -> np.ndarray:
    pred = [[0] * w for _ in range(h)]
    taps = T.FILTER_INTRA_TAPS[mode * 56:(mode + 1) * 56]
    for i2 in range(h >> 1):
        for j4 in range(w >> 2):
            p = [0] * 7
            for i in range(7):
                if i < 5:
                    if i2 == 0:
                        p[i] = above[EDGE + (j4 << 2) + i - 1]
                    elif j4 == 0 and i == 0:
                        p[i] = left[EDGE + (i2 << 1) - 1]
                    else:
                        p[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1]
                elif j4 == 0:
                    p[i] = left[EDGE + (i2 << 1) + i - 5]
                else:
                    p[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1]
            for i in range(8):
                k = taps[i * 7:i * 7 + 7]
                pr = (k[0] * p[0] + k[1] * p[1] + k[2] * p[2] + k[3] * p[3] + k[4] * p[4]
                      + k[5] * p[5] + k[6] * p[6])
                v = (pr + 8) >> 4 if pr >= 0 else -((-pr + 8) >> 4)
                pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = min(max(v, 0), top)
    return np.array(pred, np.int64)
