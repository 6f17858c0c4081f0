"""AV1 intra block copy (AV1 specification sections 5.11.23-5.11.32, 7.10.2
and 7.11.3): the vector an intra frame's block copies from, and the copy.

The predicted vector: the motion vector stack as an intra frame reaches it
(find_mv_stack with RefFrame[0] = INTRA_FRAME; only intrabc blocks are
candidates, so no temporal, global or extra candidate enters it): the row
above, the column to the left and the top-right 4x4 where it is decoded,
weighted by length, the nearest ones lifted by REF_CAT_LEVEL, then the
top-left 4x4 and the rows and columns 3 and 5 out; both parts sorted by
weight (a stable bubble sort), each vector clamped to MV_BORDER past the
frame. assign_mv takes the first nonzero of the first two entries, else a
vector one superblock up (or, in the first superblock row of a tile, one
superblock and INTRABC_DELAY_PIXELS to the left); read_mv adds a coded
difference under MV_INTRABC_CONTEXT, whole samples only (force_integer_mv).

The copy: block inter prediction from the current frame before any
filter, with the BILINEAR filter at 1/16 sample (luma vectors are whole
samples; subsampled chroma lands on half samples), the reference clamped
to the frame's 4x4-aligned size (RefUpscaledWidth[-1] = MiCols * MI_SIZE),
rounded at InterRound0 = 3 and InterRound1 = 11 (5 and 9 at 12 bits),
clipped to (1 << BitDepth) - 1. Every block of an intra
frame has RefFrame[0] = INTRA_FRAME, so compute_prediction's someUseIntra
holds and a chroma block always takes its own block's vector.
"""

from __future__ import annotations

import numpy as np

from . import av1_tables as T

_REF_CAT_LEVEL = 640
_INTRABC_DELAY_PIXELS = 256


def _lower(mv: tuple) -> tuple:
    """lower_mv_precision with force_integer_mv: each component to whole
    samples, rounding half away from zero."""
    out = []
    for v in mv:
        a = (abs(v) + 3) >> 3
        out.append(a << 3 if v > 0 else -(a << 3))
    return tuple(out)


def _stack(dec) -> list:
    """find_mv_stack(0) of the current block: [(mv, weight), ...] sorted
    and clamped, at least two entries (zero vectors fill it)."""
    r, c = dec.mi_row, dec.mi_col
    bw, bh = T.BLOCK_SIZES[dec.mi_size]
    bw4, bh4 = bw >> 2, bh >> 2
    stack: list = []

    def add(row, col, weight):
        if not dec.is_inters[row][col]:
            return
        mv = _lower(dec.mvs[row][col])
        for e in stack:
            if e[0] == mv:
                e[1] += weight
                return
        if len(stack) < 8:
            stack.append([mv, weight])

    def scan_row(dr):
        end4 = min(bw4, dec.mi_cols - c, 16)
        dc = 0
        if abs(dr) > 1:
            dr += r & 1
            dc = 1 - (c & 1)
        i = 0
        while i < end4:
            mr, mc = r + dr, c + dc + i
            if not dec.inside(mr, mc):
                break
            n = min(bw4, T.BLOCK_SIZES[dec.mi_sizes[mr][mc]][0] >> 2)
            if abs(dr) > 1:
                n = max(2, n)
            if bw4 >= 16:
                n = max(4, n)
            add(mr, mc, 2 * n)
            i += n

    def scan_col(dc):
        end4 = min(bh4, dec.mi_rows - r, 16)
        dr = 0
        if abs(dc) > 1:
            dr = 1 - (r & 1)
            dc += c & 1
        i = 0
        while i < end4:
            mr, mc = r + dr + i, c + dc
            if not dec.inside(mr, mc):
                break
            n = min(bh4, T.BLOCK_SIZES[dec.mi_sizes[mr][mc]][1] >> 2)
            if abs(dc) > 1:
                n = max(2, n)
            if bh4 >= 16:
                n = max(4, n)
            add(mr, mc, 2 * n)
            i += n

    def scan_point(dr, dc):
        mr, mc = r + dr, c + dc
        if dec.inside(mr, mc) and dec.written[mr][mc]:
            add(mr, mc, 4)

    scan_row(-1)
    scan_col(-1)
    if max(bw4, bh4) <= 16:
        scan_point(-1, bw4)
    nearest = len(stack)
    for e in stack:
        e[1] += _REF_CAT_LEVEL
    scan_point(-1, -1)
    scan_row(-3)
    scan_col(-3)
    if bh4 > 1:
        scan_row(-5)
    if bw4 > 1:
        scan_col(-5)
    for start, end in ((0, nearest), (nearest, len(stack))):
        while end > start:
            new_end = start
            for i in range(start + 1, end):
                if stack[i - 1][1] < stack[i][1]:
                    stack[i - 1], stack[i] = stack[i], stack[i - 1]
                    new_end = i
            end = new_end
    top, bottom = -(r * 32), (dec.mi_rows - bh4 - r) * 32
    left, right = -(c * 32), (dec.mi_cols - bw4 - c) * 32
    brow, bcol = T.MV_BORDER + bh4 * 32, T.MV_BORDER + bw4 * 32
    out = [((min(max(mv[0], top - brow), bottom + brow),
             min(max(mv[1], left - bcol), right + bcol)), w) for mv, w in stack]
    while len(out) < 2:
        out.append(((0, 0), 0))
    return out


def predicted_vector(dec) -> tuple:
    """assign_mv's PredMv[0] for an intrabc block, in 1/8 sample (row, col)."""
    stack = _stack(dec)
    mv = stack[0][0]
    if mv == (0, 0):
        mv = stack[1][0]
    if mv == (0, 0):
        sb4 = dec.sb4
        if dec.mi_row - sb4 < dec.tile[0]:
            mv = (0, -(sb4 * 4 + _INTRABC_DELAY_PIXELS) * 8)
        else:
            mv = (-(sb4 * 4 * 8), 0)
    return mv


def _component(dec, i: int) -> int:
    sd, cdf = dec.sd, dec.cdf
    sign = sd.read_symbol(cdf["mv_sign"][i])
    cls = sd.read_symbol(cdf["mv_class"][i])
    if cls == 0:
        up = sd.read_symbol(cdf["mv_class0_bit"][i])
    else:
        up = 1 << cls
        for n in range(cls):
            up |= sd.read_symbol(cdf["mv_bit"][i][n]) << n
    mag = (up << 3) + 8  # mv_fr 3, mv_hp 1: whole samples
    return -mag if sign else mag


def read_mv(dec, pred: tuple) -> tuple:
    """read_mv(0) under MV_INTRABC_CONTEXT: PredMv plus the coded difference
    (the joint says which of row and column is coded)."""
    joint = dec.sd.read_symbol(dec.cdf["mv_joint"])
    dr = _component(dec, 0) if joint in (2, 3) else 0
    dc = _component(dec, 1) if joint in (1, 3) else 0
    return pred[0] + dr, pred[1] + dc


def clip_vector(dec, mv: tuple) -> tuple:
    """dav1d's clip of a vector to the decoded part of the tile: the source
    block moved inside the tile's left, right and top edges, then out of
    the current superblock (up into the superblock row above where there
    is room, else left) and not below the superblock row; a source still
    overlapping the current superblock fails the decode. A valid vector
    comes back unchanged."""
    r0, _, c0, c1 = dec.tile
    bw, bh = T.BLOCK_SIZES[dec.mi_size]
    bw4, bh4 = bw >> 2, bh >> 2
    left_edge, top_edge = c0 * 4, r0 * 4
    if dec.has_chroma:
        if bw4 < 2 and dec.ssx:
            left_edge += 4
        if bh4 < 2 and dec.ssy:
            top_edge += 4
    left = dec.mi_col * 4 + (mv[1] >> 3)
    top = dec.mi_row * 4 + (mv[0] >> 3)
    right_edge = ((c1 + bw4 - 1) & ~(bw4 - 1)) * 4
    if left < left_edge:
        left = left_edge
    elif left + bw > right_edge:
        left = right_edge - bw
    top = max(top, top_edge)
    sb = dec.sb4 * 4
    sbx, sby = (dec.mi_col * 4) // sb * sb, (dec.mi_row * 4) // sb * sb
    if top + bh > sby and left + bw > sbx:
        if top - top_edge >= top + bh - sby:
            top = sby - bh
        elif left - left_edge >= left + bw - sbx:
            left = sbx - bw
    if top + bh > sby + sb:
        top = sby + sb - bh
    if top + bh > sby and left + bw > sbx:
        raise ValueError("AV1: an intra block copy from the current superblock")
    return (top - dec.mi_row * 4) * 8, (left - dec.mi_col * 4) * 8


def predict(dec, plane: int, x: int, y: int, w: int, h: int, mv: tuple) -> None:
    """The (h, w) block at (x, y) of `plane` copied from the current frame
    along mv (1/8 luma sample): the BILINEAR filter, horizontal then
    vertical, at 1/16 sample."""
    f = dec.frame[plane]
    sx, sy = (dec.ssx, dec.ssy) if plane else (0, 0)
    last_x = ((dec.mi_cols * 4) >> sx) - 1
    last_y = ((dec.mi_rows * 4) >> sy) - 1
    px = (x << 4) + ((2 * mv[1]) >> sx)
    py = (y << 4) + ((2 * mv[0]) >> sy)
    fx, fy = px & 15, py & 15
    cols = (px >> 4) + np.arange(w)
    rows = (py >> 4) + np.arange(h)
    ca, cb = np.clip(cols, 0, last_x), np.clip(cols + 1, 0, last_x)

    round0 = 5 if dec.bit_depth == 12 else 3
    round1 = 14 - round0

    def horizontal(rr):
        rr = np.clip(rr, 0, last_y)[:, None]
        s = f[rr, ca[None, :]].astype(np.int64) * (128 - 8 * fx) + f[rr, cb[None, :]] * (8 * fx)
        return (s + (1 << (round0 - 1))) >> round0

    s = horizontal(rows) * (128 - 8 * fy) + horizontal(rows + 1) * (8 * fy)
    f[y:y + h, x:x + w] = np.clip((s + (1 << (round1 - 1))) >> round1, 0, dec.pixel_max)
