"""AV1 palette mode (AV1 specification sections 5.11.46, 5.11.49-50 and
7.11.4): a block's palettes and colour-index maps, read from the tile.

palette_mode_info: has_palette_y (context: the block size and whether the
blocks above and to the left have a luma palette) and has_palette_uv
(context: whether this block has one); the size; the colours, first those
taken from the palette cache (the above and left blocks' colours merged in
ascending order without repeats; the row above only inside the same
64-row superblock row), then a literal of BitDepth bits, then ascending
deltas (luma's at least 1; BitDepth - 3 bits and more), the bit count
narrowing to what the remaining range needs; V's colours coded as signed
deltas (BitDepth - 4 bits and more, wrapping at 1 << BitDepth) or as
literals.

palette_tokens: the first index as NS(n), the rest in wavefront order
(anti-diagonals, each from its top-right end), each symbol an index into
the colours ordered by their score among the left, top-left and top
neighbours (get_palette_color_context), whose hash picks the CDF; the
part of the block past the frame's edge copies the last column and row
decoded. The prediction is the palette's colour at each index.
"""

from __future__ import annotations

import numpy as np

from . import av1_tables as T


def _ceil_log2(x: int) -> int:
    return 0 if x < 2 else (x - 1).bit_length()


def _cache(dec, plane: int) -> list:
    """get_palette_cache(plane)."""
    r, c = dec.mi_row, dec.mi_col
    sizes, colours = dec.pal_sizes[plane], dec.pal_colours[plane]
    above = colours[r - 1][c][:sizes[r - 1][c]] if (r * 4) % 64 and dec.avail_u else ()
    left = colours[r][c - 1][:sizes[r][c - 1]] if dec.avail_l else ()
    out: list = []
    i = j = 0
    while i < len(above) and j < len(left):
        a, b = above[i], left[j]
        if b < a:
            v = b
            j += 1
        else:
            v = a
            i += 1
            if b == a:
                j += 1
        if not out or v != out[-1]:
            out.append(v)
    for v in list(above[i:]) + list(left[j:]):
        if not out or v != out[-1]:
            out.append(v)
    return out


def _colours(dec, plane: int, n: int, delta_min: int) -> list:
    """The cached, literal and delta-coded colours of a luma (delta_min 1)
    or U (delta_min 0) palette of n colours, sorted."""
    sd = dec.sd
    out = []
    for v in _cache(dec, plane):
        if len(out) >= n:
            break
        if sd.read_literal(1):
            out.append(v)
    depth = dec.bit_depth
    if len(out) < n:
        out.append(sd.read_literal(depth))
    if len(out) < n:
        bits = depth - 3 + sd.read_literal(2)
        while len(out) < n:
            v = min(dec.pixel_max, out[-1] + sd.read_literal(bits) + delta_min)
            out.append(v)
            bits = min(bits, _ceil_log2((1 << depth) - v - delta_min))
    return sorted(out)


def mode_info(dec) -> None:
    """palette_mode_info: sets dec.pal_y and dec.pal_uv (colour lists, U
    then V for chroma; empty without a palette)."""
    sd, cdf = dec.sd, dec.cdf
    bw, bh = T.BLOCK_SIZES[dec.mi_size]
    bsize_ctx = (bw >> 2).bit_length() + (bh >> 2).bit_length() - 4
    r, c = dec.mi_row, dec.mi_col
    if dec.y_mode == T.DC_PRED:
        ctx = ((dec.avail_u and dec.pal_sizes[0][r - 1][c] > 0)
               + (dec.avail_l and dec.pal_sizes[0][r][c - 1] > 0))
        if sd.read_symbol(cdf["palette_y_mode"][bsize_ctx][ctx]):
            n = sd.read_symbol(cdf["palette_y_size"][bsize_ctx]) + 2
            dec.pal_y = _colours(dec, 0, n, 1)
            dec.tools.add("palette")
    if dec.has_chroma and dec.uv_mode == T.DC_PRED:
        if sd.read_symbol(cdf["palette_uv_mode"][int(bool(dec.pal_y))]):
            n = sd.read_symbol(cdf["palette_uv_size"][bsize_ctx]) + 2
            u = _colours(dec, 1, n, 0)
            depth = dec.bit_depth
            if sd.read_literal(1):  # delta_encode_palette_colors_v
                bits = depth - 4 + sd.read_literal(2)
                v = [sd.read_literal(depth)]
                for _ in range(1, n):
                    d = sd.read_literal(bits)
                    if d and sd.read_literal(1):
                        d = -d
                    v.append((v[-1] + d) % (1 << depth))
            else:
                v = [sd.read_literal(depth) for _ in range(n)]
            dec.pal_uv = (u, v)
            dec.tools.add("chroma palette")


def _color_map(dec, n: int, bw: int, bh: int, onw: int, onh: int, cdfs: list) -> np.ndarray:
    """One plane's colour-index map (bh, bw)."""
    sd = dec.sd
    m = [[0] * bw for _ in range(bh)]
    m[0][0] = sd.read_ns(n)
    mult = T.PALETTE_COLOR_HASH_MULTIPLIERS
    for i in range(1, onh + onw - 1):
        for j in range(min(i, onw - 1), max(0, i - onh + 1) - 1, -1):
            row, col = i - j, j
            scores = [0] * 8
            if col > 0:
                scores[m[row][col - 1]] += 2
            if row > 0:
                if col > 0:
                    scores[m[row - 1][col - 1]] += 1
                scores[m[row - 1][col]] += 2
            order = list(range(8))
            for k in range(3):
                best, at = scores[k], k
                for q in range(k + 1, n):
                    if scores[q] > best:
                        best, at = scores[q], q
                if at != k:
                    o = order[at]
                    del scores[at], order[at]
                    scores.insert(k, best)
                    order.insert(k, o)
            h = scores[0] * mult[0] + scores[1] * mult[1] + scores[2] * mult[2]
            m[row][col] = order[sd.read_symbol(cdfs[T.PALETTE_COLOR_CONTEXT[h]])]
    out = np.array(m, np.int64)
    out[:onh, onw:] = out[:onh, onw - 1:onw]
    out[onh:] = out[onh - 1]
    return out


def tokens(dec) -> None:
    """palette_tokens: dec.map_y and dec.map_uv."""
    bw, bh = T.BLOCK_SIZES[dec.mi_size]
    onh = min(bh, (dec.mi_rows - dec.mi_row) * 4)
    onw = min(bw, (dec.mi_cols - dec.mi_col) * 4)
    if onw < bw or onh < bh:
        dec.tools.add("palette past the frame's edge")
    if dec.pal_y:
        n = len(dec.pal_y)
        dec.map_y = _color_map(dec, n, bw, bh, onw, onh, dec.cdf[f"palette_{n}_y_color"])
    if dec.pal_uv:
        n = len(dec.pal_uv[0])
        bw, bh, onw, onh = bw >> dec.ssx, bh >> dec.ssy, onw >> dec.ssx, onh >> dec.ssy
        if bw < 4:
            bw, onw = bw + 2, onw + 2
        if bh < 4:
            bh, onh = bh + 2, onh + 2
        dec.map_uv = _color_map(dec, n, bw, bh, onw, onh, dec.cdf[f"palette_{n}_uv_color"])


def predict(dec, plane: int, x: int, y: int, x4: int, y4: int, w: int, h: int) -> None:
    """The (h, w) transform block at (x, y) of `plane` from the palette, its
    map read at the block's 4x4 offset (x4, y4)."""
    if plane == 0:
        colours, m = dec.pal_y, dec.map_y
    else:
        colours, m = dec.pal_uv[plane - 1], dec.map_uv
    dec.frame[plane][y:y + h, x:x + w] = np.array(colours, np.int64)[
        m[4 * y4:4 * y4 + h, 4 * x4:4 * x4 + w]]
