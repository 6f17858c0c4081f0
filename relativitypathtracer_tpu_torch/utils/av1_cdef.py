"""AV1's Constrained Directional Enhancement Filter (AV1 specification
section 7.15), to the bit, on the deblocked frame.

Each 8x8 luma block of a 64x64 whose cdef_idx was read: the direction
search (the eight partial sums of the block's samples, shifted down to 8
bits, less 128 along each
direction, their costs weighted by Div_Table, the best direction and the
variance from its cost less the orthogonal one's), then the filter of the
block in each plane: luma's primary strength scaled by the variance,
chroma's damping one less than luma's and its direction through
Cdef_Uv_Dir, each tap's difference constrained by the strength and
damping, taps outside the frame's 4x4-aligned area left out, and the sum
clamped to the taps' range. Above 8 bits the strengths are shifted up and
the damping raised by BitDepth - 8, and the primary taps are chosen by the
strength shifted back. A 64x64 whose blocks all skipped
(cdef_idx -1) and an 8x8 whose four 4x4s all skip are left as they are.
Every filter reads only the deblocked frame, so each plane is one pass:
the direction search on every 8x8 block at once (partial sums as matrix
products), the taps as gathers over the whole plane.
"""

from __future__ import annotations

import numpy as np

from . import av1_tables as T


def _partial_matrices() -> np.ndarray:
    """(8, 64, 15) one-hot: sample (i, j) of an 8x8 block to its line in
    each direction's partial sums."""
    m = np.zeros((8, 64, 15), np.int64)
    for i in range(8):
        for j in range(8):
            k = i * 8 + j
            for d, line in enumerate((i + j, i + j // 2, i, 3 + i - j // 2, 7 + i - j,
                                      3 - i // 2 + j, j, i // 2 + j)):
                m[d, k, line] = 1
    return m


_PARTIAL = _partial_matrices()


def _directions(luma: np.ndarray, shift: int = 0) -> tuple:
    """cdef_direction of every 8x8 block of luma (rows, cols multiples of
    8; samples >> shift): (direction, variance), each (rows / 8, cols / 8)."""
    h, w = luma.shape
    blocks = ((luma.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 64)
               .astype(np.int64) >> shift) - 128)
    part = np.einsum("nk,dkl->ndl", blocks, _PARTIAL)  # (n, 8, 15)
    sq = part * part
    div = T.CDEF_DIV_TABLE
    cost = np.zeros((len(blocks), 8), np.int64)
    cost[:, 2] = sq[:, 2, :8].sum(1) * div[8]
    cost[:, 6] = sq[:, 6, :8].sum(1) * div[8]
    for d in (0, 4):
        c = sq[:, d, 7] * div[8]
        for i in range(7):
            c = c + (sq[:, d, i] + sq[:, d, 14 - i]) * div[i + 1]
        cost[:, d] = c
    for d in (1, 3, 5, 7):
        c = sq[:, d, 3:8].sum(1) * div[8]
        for j in range(3):
            c = c + (sq[:, d, j] + sq[:, d, 10 - j]) * div[2 * j + 2]
        cost[:, d] = c
    best = np.zeros(len(blocks), np.int64)
    best_cost = np.zeros(len(blocks), np.int64)
    for d in range(8):
        better = cost[:, d] > best_cost
        best = np.where(better, d, best)
        best_cost = np.where(better, cost[:, d], best_cost)
    var = (best_cost - cost[np.arange(len(blocks)), (best + 4) & 7]) >> 10
    return best.reshape(h // 8, w // 8), var.reshape(h // 8, w // 8)


def _floor_log2(x: np.ndarray) -> np.ndarray:
    """FloorLog2 of positive integers, exactly."""
    return np.frexp(x.astype(np.float64))[1].astype(np.int64) - 1


def _constrain(diff: np.ndarray, threshold: np.ndarray, damping: int) -> np.ndarray:
    adj = np.maximum(0, damping - _floor_log2(np.maximum(threshold, 1)))
    mag = np.minimum(np.abs(diff), np.maximum(0, threshold - (np.abs(diff) >> adj)))
    return np.where(threshold > 0, np.sign(diff) * mag, 0)


def cdef(dec) -> list:
    """The planes after CDEF (the deblocked ones where nothing is filtered)."""
    fh = dec.fh
    frame = dec.frame
    if not fh.cdef_read or not any(any(st) for st in fh.cdef_strengths):
        return list(frame)
    rows8, cols8 = dec.mi_rows // 2, dec.mi_cols // 2
    luma = frame[0][:rows8 * 8, :cols8 * 8]
    shift = dec.bit_depth - 8
    direction, var = _directions(luma, shift)
    # each 8x8's strengths index, -1 where its 64x64 read none or its 4x4s all skip
    idx = np.full((rows8, cols8), -1, np.int64)
    for (r, c), v in dec.cdef_idx.items():
        idx[r * 8:r * 8 + 8, c * 8:c * 8 + 8] = v
    skips = np.array([row[:dec.mi_cols] for row in dec.skips[:dec.mi_rows]], bool)
    skip8 = skips[0::2, 0::2] & skips[1::2, 0::2] & skips[0::2, 1::2] & skips[1::2, 1::2]
    idx = np.where(skip8, -1, idx)
    on = idx >= 0
    table = [(st + [0, 0])[:4] for st in fh.cdef_strengths] + [[0, 0, 0, 0]]
    strengths = np.array(table, np.int64)[np.where(on, idx, -1)] << shift
    out = [f.copy() for f in frame]
    for plane in range(dec.num_planes):
        sx, sy = (dec.ssx, dec.ssy) if plane else (0, 0)
        if plane == 0:
            pri, sec = strengths[..., 0], strengths[..., 1]
            var_str = np.where(var >> 6, np.minimum(_floor_log2(np.maximum(var >> 6, 1)), 12), 0)
            pri = np.where(var > 0, (pri * (4 + var_str) + 8) >> 4, 0)
            damping = fh.cdef_damping + shift
            dirs = np.where(strengths[..., 0] == 0, 0, direction)
        else:
            pri, sec = strengths[..., 2], strengths[..., 3]
            damping = fh.cdef_damping - 1 + shift
            dirs = np.where(pri == 0, 0, np.array(T.CDEF_UV_DIR[sx][sy])[direction])
        bw, bh = 8 >> sx, 8 >> sy
        _filter_plane(frame[plane], out[plane], on & ((pri > 0) | (sec > 0)), pri, sec,
                      damping, dirs, bw, bh, (dec.mi_rows * 4) >> sy, (dec.mi_cols * 4) >> sx,
                      shift)
    return out


def _filter_plane(src, dst, on, pri, sec, damping, dirs, bw, bh, height, width,
                  shift=0) -> None:
    by, bx = np.nonzero(on)
    if not len(by):
        return
    i = np.arange(bh)[:, None]
    j = np.arange(bw)[None, :]
    ys = (by[:, None, None] * bh + i[None]).astype(np.int64)  # (n, bh, 1)
    xs = (bx[:, None, None] * bw + j[None]).astype(np.int64)  # (n, 1, bw)
    x = src[ys, xs].astype(np.int64)
    p = pri[by, bx][:, None, None]
    s = sec[by, bx][:, None, None]
    d = dirs[by, bx]
    pri_taps = np.array(T.CDEF_PRI_TAPS, np.int64)[(p[:, 0, 0] >> shift) & 1]  # (n, 2)
    sec_taps = np.array(T.CDEF_SEC_TAPS, np.int64)[(p[:, 0, 0] >> shift) & 1]
    dir_tab = np.array(T.CDEF_DIRECTIONS, np.int64)  # (8, 2, 2)
    total = np.zeros_like(x)
    lo, hi = x.copy(), x.copy()
    for k in range(2):
        for sign in (-1, 1):
            for off, strength, taps in ((0, p, pri_taps), (-2, s, sec_taps), (2, s, sec_taps)):
                dd = dir_tab[(d + off) & 7, k]  # (n, 2)
                yy = ys + sign * dd[:, 0][:, None, None]
                xx = xs + sign * dd[:, 1][:, None, None]
                ok = (yy >= 0) & (yy < height) & (xx >= 0) & (xx < width)
                v = src[np.clip(yy, 0, height - 1), np.clip(xx, 0, width - 1)].astype(np.int64)
                total = total + np.where(ok, taps[:, k][:, None, None]
                                         * _constrain(v - x, strength, damping), 0)
                lo = np.where(ok, np.minimum(lo, v), lo)
                hi = np.where(ok, np.maximum(hi, v), hi)
    dst[ys, xs] = np.clip(x + ((8 + total - (total < 0)) >> 4), lo, hi)
