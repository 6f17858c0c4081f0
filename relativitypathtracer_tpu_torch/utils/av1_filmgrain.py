"""AV1 film grain synthesis (AV1 specification section 7.18.3) at 8, 10 and
12 bits, as dav1d 1.5.1 applies it to the picture it hands libavif: after
loop restoration, before the YUV to RGB conversion.

- The random numbers: the 16-bit LFSR (taps 0, 1, 3 and 12), `bits` from its
  top. Luma's template is seeded with grain_seed, Cb's and Cr's with it xor
  0xb524 and 0x49d8.
- The templates: 73x82 for luma, 38x44 / 73x44 / 73x82 for chroma at
  4:2:0 / 4:2:2 / 4:4:4, Gaussian_Sequence values rounded by 12 -
  BitDepth + grain_scale_shift, then the auto-regressive filter of lag 0-3
  row by row (the rows above are summed for a whole row at once; the row's
  own taps and its clip to the grain's range, [-128, 127] << (BitDepth -
  8), run left to right), chroma's last tap on the luma template averaged
  over its subsampled block.
- The scaling functions: 256 entries, piecewise linear between the points,
  flat before the first and after the last (dav1d's generate_scaling); a
  plane with no points scales by 0; chroma_scaling_from_luma reads luma's.
  Above 8 bits a sample indexes the table by its top 8 bits and rounds
  between neighbouring entries by the rest (scale_lut).
- The noise: 32-row stripes, each seeded from grain_seed and its number;
  each 32x32 block (16 where subsampled) takes its template offsets from 8
  random bits; with overlap_flag a block's first 2 columns (1 where
  subsampled) blend with its left neighbour's block and a stripe's first 2
  rows (1) with the stripe above, weights (27, 17) and (17, 27), or (23,
  22), Round2(..., 5), clipped to the grain's range; the corner blends the
  row above first.
- The add: Round2(scale[index] * grain, scaling_shift), luma's index its
  own sample, chroma's its sample mixed with the average of the luma pair
  it covers (the last column of an odd width pairs with itself), or that
  average alone under chroma_scaling_from_luma (the offset shifted up by
  BitDepth - 8); clipped to [0, (1 << BitDepth) - 1] or to [16, 235]
  (luma) and [16, 240] (chroma; 235 under the identity matrix), shifted up
  by BitDepth - 8.
Luma's template is built only where luma has points; its noise, as dav1d
takes it, reads the decoded luma before any grain.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from . import av1_tables as T

GRAIN_MIN, GRAIN_MAX = -128, 127  # at 8 bits; shifted up by BitDepth - 8
# (rows, columns) of a template by (ssx, ssy)
TEMPLATE = {(0, 0): (73, 82), (1, 0): (73, 44), (1, 1): (38, 44)}


class Lfsr:
    """The specification's RandomRegister and get_random_number()."""

    def __init__(self, seed: int):
        self.state = seed & 0xFFFF

    def take(self, bits: int) -> int:
        r = self.state
        bit = (r ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        self.state = r = (r >> 1) | (bit << 15)
        return (r >> (16 - bits)) & ((1 << bits) - 1)


def _round2(x, n: int):
    return (x + ((1 << n) >> 1)) >> n


def gaussian_template(seed: int, rows: int, cols: int, shift: int) -> np.ndarray:
    """A template's Gaussian values before the AR filter: rows x cols draws
    of 11 bits, Round2(Gaussian_Sequence[draw], shift)."""
    rng = Lfsr(seed)
    draws = np.array([rng.take(11) for _ in range(rows * cols)], np.int64)
    return _round2(T.GAUSSIAN_SEQUENCE[draws], shift).reshape(rows, cols)


def auto_regress(buf: np.ndarray, coeffs: list, lag: int, shift: int,
                 luma=None, depth: int = 8) -> np.ndarray:
    """The AR filter over a template from row 3 and column 3 to 3 short of
    the right edge, in place: coefficients in raster order over the rows
    above and the row's left, then (with `luma`, the averaged luma template
    at each filtered sample) luma's."""
    rows, cols = buf.shape
    width = cols - 6
    lo, hi = GRAIN_MIN << (depth - 8), ((GRAIN_MAX + 1) << (depth - 8)) - 1
    above = 2 * lag + 1
    own = coeffs[lag * above:lag * above + lag]
    for y in range(3, rows):
        acc = np.zeros(width, np.int64)
        k = 0
        for dy in range(-lag, 0):
            for dx in range(-lag, lag + 1):
                acc += coeffs[k] * buf[y + dy, 3 + dx:3 + dx + width]
                k += 1
        if luma is not None:
            acc += coeffs[-1] * luma[y - 3]
        row = buf[y].tolist()
        acc = acc.tolist()
        for x in range(3, cols - 3):
            s = acc[x - 3]
            for j in range(lag):
                s += own[j] * row[x - lag + j]
            v = row[x] + _round2(s, shift)
            row[x] = lo if v < lo else hi if v > hi else v
        buf[y] = row
    return buf


def templates(g: SimpleNamespace, mono: bool, ssx: int, ssy: int, depth: int = 8) -> list:
    """[luma, Cb, Cr] templates after the AR filter (None where the plane
    takes no grain)."""
    shift = 12 - depth + g.grain_scale_shift
    out = [None, None, None]
    luma = None
    if g.num_y_points:
        luma = gaussian_template(g.grain_seed, 73, 82, shift)
        out[0] = auto_regress(luma, g.ar_coeffs_y, g.ar_coeff_lag, g.ar_coeff_shift, None, depth)
    if mono:
        return out
    rows, cols = TEMPLATE[(ssx, ssy)]
    avg = None
    if luma is not None:  # luma's template averaged over each filtered chroma sample's block
        ys = ((np.arange(3, rows) - 3) << ssy) + 3
        xs = ((np.arange(3, cols - 3) - 3) << ssx) + 3
        total = sum(luma[np.ix_(ys + i, xs + j)] for i in range(ssy + 1) for j in range(ssx + 1))
        avg = _round2(total, ssx + ssy)
    for p, xor in ((0, 0xB524), (1, 0x49D8)):
        if g.uv_points[p] or g.chroma_scaling_from_luma:
            buf = gaussian_template(g.grain_seed ^ xor, rows, cols, shift)
            out[1 + p] = auto_regress(buf, g.ar_coeffs_uv[p], g.ar_coeff_lag,
                                      g.ar_coeff_shift, avg, depth)
    return out


def scaling(points: list) -> np.ndarray:
    """dav1d's generate_scaling at 8 bits: 256 entries from the points."""
    out = np.zeros(256, np.int64)
    if not points:
        return out
    out[:points[0][0]] = points[0][1]
    for (bx, by), (ex, ey) in zip(points, points[1:]):
        dx = ex - bx
        delta = (ey - by) * ((0x10000 + (dx >> 1)) // dx)
        out[bx:ex] = by + ((0x8000 + delta * np.arange(dx)) >> 16)
    out[points[-1][0]:] = points[-1][1]
    return out


def scale_lut(table: np.ndarray, index: np.ndarray, depth: int) -> np.ndarray:
    """The specification's scale_lut: the 256-entry table at a sample of
    `depth` bits, rounded between entries by its low bits."""
    if depth == 8:
        return table[index]
    shift = depth - 8
    x = index >> shift
    rem = index - (x << shift)
    start = table[x]
    end = table[np.minimum(x + 1, 255)]
    return start + (((end - start) * rem + (1 << (shift - 1))) >> shift)


def block_offsets(seed: int, stripes: int, blocks: int) -> np.ndarray:
    """(stripes, blocks) of 8 random bits: each stripe's LFSR seeded from
    grain_seed and the stripe's number, one draw a 32-column block."""
    out = np.zeros((stripes, blocks), np.int64)
    for n in range(stripes):
        rng = Lfsr(seed ^ (((n * 37 + 178) & 255) << 8) ^ ((n * 173 + 105) & 255))
        out[n] = [rng.take(8) for _ in range(blocks)]
    return out


def _blend(old: np.ndarray, new: np.ndarray, weights: tuple, depth: int) -> np.ndarray:
    return np.clip(_round2(old * weights[0] + new * weights[1], 5), GRAIN_MIN << (depth - 8),
                   ((GRAIN_MAX + 1) << (depth - 8)) - 1)


def noise_plane(template: np.ndarray, offsets: np.ndarray, pw: int, ph: int, sx: int,
                sy: int, overlap: bool, depth: int = 8) -> np.ndarray:
    """(ph, pw) noise of one plane: each stripe's blocks cut from the
    template at their offsets, 34 samples wide and tall (17 where
    subsampled) so that a block carries its right and bottom neighbours'
    overlap, blended left to right within the stripe, then each stripe's
    first rows with the rows the stripe above carried."""
    bw, bh = 32 >> sx, 32 >> sy
    ew, eh = 34 >> sx, 34 >> sy
    stripes, blocks = offsets.shape
    weights_x = ((27, 17), (17, 27)) if not sx else ((23, 22),)
    weights_y = ((27, 17), (17, 27)) if not sy else ((23, 22),)
    out = np.zeros((stripes * bh, blocks * bw + ew), np.int64)
    carried = None
    for n in range(stripes):
        stripe = np.zeros((eh, blocks * bw + ew), np.int64)
        for b in range(blocks):
            r = int(offsets[n, b])
            oy = 3 + (2 >> sy) * (3 + (r & 15))
            ox = 3 + (2 >> sx) * (3 + (r >> 4))
            x0 = b * bw
            stripe_cut = stripe[:, x0:x0 + ew]
            old = stripe_cut[:, :len(weights_x)].copy()
            stripe_cut[:] = template[oy:oy + eh, ox:ox + ew]
            if overlap and b:
                for j, w in enumerate(weights_x):
                    stripe_cut[:, j] = _blend(old[:, j], stripe_cut[:, j], w, depth)
        rows = stripe[:bh].copy()
        if overlap and n:
            for i, w in enumerate(weights_y):
                rows[i] = _blend(carried[i], rows[i], w, depth)
        out[n * bh:(n + 1) * bh] = rows
        carried = stripe[bh:]
    return out[:ph, :pw]


def apply_grain(planes: list, w: int, h: int, seq, g: SimpleNamespace) -> list:
    """The planes (each cut to its visible size, int64) with the grain
    added."""
    ssx, ssy, depth = seq.ssx, seq.ssy, seq.bit_depth
    shift = depth - 8
    luma = planes[0][:h, :w].astype(np.int64)
    out = [luma] + [planes[p][:(h + ssy) >> ssy, :(w + ssx) >> ssx].astype(np.int64)
                    for p in range(1, seq.num_planes)]
    tmpl = templates(g, seq.mono, ssx, ssy, depth)
    stripes, blocks = (h + 31) >> 5, (w + 31) >> 5
    offsets = block_offsets(g.grain_seed, stripes, blocks)
    top = (1 << depth) - 1
    lo, hi_y, hi_uv = 0, top, top
    if g.clip_to_restricted_range:
        lo, hi_y, hi_uv = 16 << shift, 235 << shift, (235 if seq.mc == 0 else 240) << shift
    y_scale = scaling(g.y_points)
    if g.num_y_points:
        noise = noise_plane(tmpl[0], offsets, w, h, 0, 0, g.overlap_flag, depth)
        out[0] = np.clip(luma + _round2(scale_lut(y_scale, luma, depth) * noise, g.scaling_shift),
                         lo, hi_y)
    if seq.mono:
        return out
    pw, ph = (w + ssx) >> ssx, (h + ssy) >> ssy
    lx = np.arange(pw) << ssx
    rows = luma[np.arange(ph) << ssy]
    avg = rows[:, lx]
    if ssx:
        avg = (avg + rows[:, np.minimum(lx + 1, w - 1)] + 1) >> 1
    for p in range(2):
        if tmpl[1 + p] is None:
            continue
        src = out[1 + p]
        if g.chroma_scaling_from_luma:
            index, scale = avg, y_scale
        else:
            combined = avg * g.uv_luma_mult[p] + src * g.uv_mult[p]
            index = np.clip((combined >> 6) + (g.uv_offset[p] << shift), 0, top)
            scale = scaling(g.uv_points[p])
        noise = noise_plane(tmpl[1 + p], offsets, pw, ph, ssx, ssy, g.overlap_flag, depth)
        out[1 + p] = np.clip(src + _round2(scale_lut(scale, index, depth) * noise,
                                           g.scaling_shift), lo, hi_uv)
    return out
