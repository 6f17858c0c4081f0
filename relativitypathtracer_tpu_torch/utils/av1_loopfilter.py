"""The AV1 deblocking filter of an intra frame (AV1 specification section
7.14), to the bit.

Per plane (luma whenever either luma level is nonzero, each chroma plane
when its level is), all vertical edges of the frame, then all horizontal
ones. An edge 4 samples long is filtered where it is a transform edge on
the picture (not at its left or top border, not past its width or
height); its filter length is the smaller transform of the two sides (4,
8 or 16 for luma, 4 or 6 for chroma, 16 meaning the 14-tap filter); its
level comes from the frame's level of that plane and direction, delta lf,
the segment's feature and the intra reference delta, or from the
previous block's when it is 0; sharpness gives limit, blimit and thresh.
Then the masks (hev, filter, flat, flat2) and the narrow filter or the 6-,
8- or 14-tap wide one; above 8 bits the limits and the flatness threshold
are shifted up by BitDepth - 8 and the narrow filter works on BitDepth-bit
signed samples.

Within one pass no filter reads a sample that another one writes (edges
with long filters lie at least as far apart as the filters reach), so
each pass gathers its edges first and filters them all at once in numpy.
"""

from __future__ import annotations

import numpy as np

from . import av1_tables as T


def _level(dec, r: int, c: int, plane: int, pss: int) -> int:
    fh = dec.fh
    i = pss if plane == 0 else plane + 1
    delta = dec.delta_lfs[r][c][i if fh.delta_lf_multi else 0]
    lvl = max(0, min(63, delta + fh.lf_level[i]))
    seg = dec.seg_ids[r][c]
    if fh.seg_enabled and fh.seg_feature[seg][i + 1] is not None:
        lvl = max(0, min(63, lvl + fh.seg_feature[seg][i + 1]))
    if fh.lf_delta_enabled:
        lvl = max(0, min(63, lvl + fh.lf_ref_deltas[0] * (1 << (lvl >> 5))))
    return lvl


def loop_filter(dec) -> None:
    fh, seq = dec.fh, dec.seq
    if not (fh.lf_level[0] or fh.lf_level[1]):
        return
    sharp = fh.lf_sharpness
    shift = 2 if sharp > 4 else 1 if sharp > 0 else 0
    for plane in range(seq.num_planes):
        if plane and not fh.lf_level[plane + 1]:
            continue
        sx, sy = (seq.ssx, seq.ssy) if plane else (0, 0)
        for pss in (0, 1):
            edges = {4: [], 6: [], 8: [], 16: []}
            lf = dec.lf_tx[plane]
            for row in range(0, dec.mi_rows, 1 << sy):
                y = row * 4
                if y >= fh.height or (pss == 1 and y == 0):
                    continue
                for col in range(0, dec.mi_cols, 1 << sx):
                    x = col * 4
                    if x >= fh.width or (pss == 0 and x == 0):
                        continue
                    r, c = row | sy, col | sx
                    xp, yp = x >> sx, y >> sy
                    tx = lf[r >> sy][c >> sx]
                    tw, th = T.TX_SIZES[tx]
                    if (xp % tw if pss == 0 else yp % th) != 0:
                        continue
                    pr, pc = (r, c - (1 << sx)) if pss == 0 else (r - (1 << sy), c)
                    ptw, pth = T.TX_SIZES[lf[pr >> sy][pc >> sx]]
                    base = min(tw, ptw) if pss == 0 else min(th, pth)
                    size = min(16, base) if plane == 0 else min(8, base)
                    lvl = _level(dec, r, c, plane, pss)
                    if lvl == 0:
                        lvl = _level(dec, pr, pc, plane, pss)
                    if lvl == 0:
                        continue
                    limit = (max(1, min(9 - sharp, lvl >> shift)) if sharp
                             else max(1, lvl >> shift))
                    length = 6 if (plane and size == 8) else size
                    edges[length].append((xp, yp, limit, 2 * (lvl + 2) + limit, lvl >> 4))
            for length, lst in edges.items():
                if lst:
                    _filter(dec.frame[plane], np.array(lst, np.int64), length, pss,
                            seq.bit_depth)


def _filter(f: np.ndarray, e: np.ndarray, length: int, pss: int, depth: int = 8) -> None:
    """Filter every edge segment of `e` (rows x, y, limit, blimit, thresh):
    four lines each, across the edge."""
    shift = depth - 8
    i = np.arange(4)
    if pss == 0:  # vertical edge: lines are rows, taps run along x
        ys = (e[:, 1][:, None] + i[None, :]).ravel()
        xs = np.repeat(e[:, 0], 4)
        k = np.arange(-7, 7)
        rr = np.broadcast_to(ys[:, None], (len(ys), 14))
        cc = xs[:, None] + k[None, :]
    else:
        xs = (e[:, 0][:, None] + i[None, :]).ravel()
        ys = np.repeat(e[:, 1], 4)
        k = np.arange(-7, 7)
        rr = ys[:, None] + k[None, :]
        cc = np.broadcast_to(xs[:, None], (len(xs), 14))
    rr = np.maximum(rr, 0)
    cc = np.maximum(cc, 0)
    px = f[rr, cc].astype(np.int64)  # px[:, 7 + j]: j = 0 is q0, j = -1 is p0
    limit = np.repeat(e[:, 2], 4) << shift
    blimit = np.repeat(e[:, 3], 4) << shift
    thresh = np.repeat(e[:, 4], 4) << shift
    one = 1 << shift

    def s(j):
        return px[:, 7 + j]

    p0, p1, p2, p3 = s(-1), s(-2), s(-3), s(-4)
    q0, q1, q2, q3 = s(0), s(1), s(2), s(3)
    ad = np.abs
    hev = (ad(p1 - p0) > thresh) | (ad(q1 - q0) > thresh)
    edge_ok = ad(p0 - q0) * 2 + ad(p1 - q1) // 2 <= blimit
    mask = (ad(p1 - p0) <= limit) & (ad(q1 - q0) <= limit) & edge_ok
    if length >= 6:
        mask &= (ad(p2 - p1) <= limit) & (ad(q2 - q1) <= limit)
    if length >= 8:
        mask &= (ad(p3 - p2) <= limit) & (ad(q3 - q2) <= limit)
    flat = np.zeros(len(px), bool)
    flat2 = np.zeros(len(px), bool)
    if length == 6:
        flat = ((ad(p1 - p0) <= one) & (ad(q1 - q0) <= one) & (ad(p2 - p0) <= one)
                & (ad(q2 - q0) <= one))
    elif length >= 8:
        flat = ((ad(p1 - p0) <= one) & (ad(q1 - q0) <= one) & (ad(p2 - p0) <= one)
                & (ad(q2 - q0) <= one) & (ad(p3 - p0) <= one) & (ad(q3 - q0) <= one))
    if length == 16:
        flat2 = ((ad(s(-7) - p0) <= one) & (ad(s(6) - q0) <= one) & (ad(s(-6) - p0) <= one)
                 & (ad(s(5) - q0) <= one) & (ad(s(-5) - p0) <= one) & (ad(s(4) - q0) <= one))
    out = px.copy()
    narrow = mask & ~flat
    if narrow.any():
        half = 1 << (depth - 1)
        c = lambda v: np.clip(v, -half, half - 1)  # noqa: E731
        ps1, ps0, qs0, qs1 = p1 - half, p0 - half, q0 - half, q1 - half
        filt = np.where(hev, c(ps1 - qs1), 0)
        filt = c(filt + 3 * (qs0 - ps0))
        f1 = c(filt + 4) >> 3
        f2 = c(filt + 3) >> 3
        n = narrow
        out[n, 7] = (c(qs0 - f1) + half)[n]
        out[n, 6] = (c(ps0 + f2) + half)[n]
        keep = n & ~hev
        fo = (f1 + 1) >> 1
        out[keep, 8] = (c(qs1 - fo) + half)[keep]
        out[keep, 5] = (c(ps1 + fo) + half)[keep]
    wide = mask & flat & ~flat2 if length == 16 else mask & flat
    if length >= 6 and wide.any():
        _wide(px, out, wide, 3, 2 if length == 6 else 3, 1 if length == 6 else 0)
    if length == 16:
        w16 = mask & flat & flat2
        if w16.any():
            _wide(px, out, w16, 4, 6, 1)
    lo, hi = {4: (-2, 2), 6: (-2, 2), 8: (-3, 3), 16: (-6, 6)}[length]
    f[rr[:, 7 + lo:7 + hi], cc[:, 7 + lo:7 + hi]] = out[:, 7 + lo:7 + hi]


def _wide(px, out, sel, log2size, n, n2):
    rows = px[sel]
    for i in range(-n, n):
        t = 0
        for j in range(-n, n + 1):
            p = max(-(n + 1), min(n, i + j))
            t = t + rows[:, 7 + p] * (2 if abs(j) <= n2 else 1)
        out[sel, 7 + i] = (t + (1 << (log2size - 1))) >> log2size
