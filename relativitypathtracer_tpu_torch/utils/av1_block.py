"""AV1 tile decoding of an intra frame (AV1 specification sections 5.11 and
7.11-7.13): the partition tree (all ten partition types, split_or_horz and
split_or_vert at the frame's edges; in 4:2:2 the vertical ones refused, as
dav1d refuses them), each superblock's loop-restoration
units (av1_restoration.read_lr), intra_frame_mode_info (segment id, skip,
cdef_idx, delta q and delta lf, use_intrabc and its vector (av1_intrabc),
the key frame's y mode, uv mode with CFL alphas, angle deltas, palette
mode info and tokens (av1_palette), filter intra), the transform size and
depth (an intrabc block's transform tree: read_var_tx_size and
InterTxSizes), the transform type (the intra sets, or an intrabc block's
inter sets with chroma taking luma's type), the coefficients (txb skip,
eob, base and range levels and their contexts, Golomb, dc sign) and their
dequantisation (weighted by the segment's quantiser matrix), then
prediction (intra, palette, or the block copy before its residual) and
reconstruction through av1_recon, transform block by transform block in
the specification's order (transform_tree for an intrabc block's luma).

`FrameDecoder(seq, fh).decode()` returns the reconstructed planes before
the loop filter, with the per-4x4 information av1_loopfilter, av1_cdef and
av1_restoration read. Samples have the sequence's BitDepth (8, 10 or 12):
reconstruction and prediction clip to (1 << BitDepth) - 1, the edges
without neighbours start from 1 << (BitDepth - 1), and the dequantisers
and their clamp are the depth's.
"""

from __future__ import annotations

import functools

import numpy as np

from . import av1_intrabc as IBC
from . import av1_palette as PAL
from . import av1_recon as R
from . import av1_restoration as LR
from . import av1_tables as T
from .av1_entropy import SymbolDecoder
from .av1_obu import qindex

_EDGE = R.EDGE


def _log2(n: int) -> int:
    return n.bit_length() - 1


class FrameDecoder:
    def __init__(self, seq, fh):
        self.seq, self.fh = seq, fh
        self.ssx, self.ssy = seq.ssx, seq.ssy
        self.num_planes = seq.num_planes
        self.bit_depth = seq.bit_depth
        self.pixel_max = (1 << seq.bit_depth) - 1
        self.mid = 1 << (seq.bit_depth - 1)
        mr, mc = fh.mi_rows, fh.mi_cols
        self.mi_rows, self.mi_cols = mr, mc
        self.sb4 = 32 if seq.sb128 else 16
        pad = 40
        grid = lambda v: [[v] * (mc + pad) for _ in range(mr + pad)]  # noqa: E731
        self.y_modes = grid(0)
        self.uv_modes = grid(0)
        self.skips = grid(0)
        self.mi_sizes = grid(0)
        self.seg_ids = grid(0)
        self.tx_sizes = grid(0)  # InterTxSizes
        self.tx_types = grid(0)  # TxTypes, luma
        self.delta_lfs = grid((0, 0, 0, 0))
        self.is_inters = grid(0)
        self.mvs = grid((0, 0))
        self.written = grid(0)
        self.pal_sizes = [grid(0), grid(0)]
        self.pal_colours = [grid(()), grid(())]
        self.cdef_idx = {}  # a 64x64's (row, col) >> 4: its cdef_idx, where read
        self.lr_units = [{}, {}, {}]  # (unit row, unit col): (type, coefficients)
        self.frame = []
        self.lf_tx = []
        for p in range(self.num_planes):
            sx, sy = (self.ssx, self.ssy) if p else (0, 0)
            self.frame.append(np.zeros(((mr * 4 >> sy) + 160, (mc * 4 >> sx) + 160), np.int32))
            self.lf_tx.append([[0] * ((mc >> sx) + pad) for _ in range((mr >> sy) + pad)])
        self.tools = fh.tools

    # --- frame and tiles ---------------------------------------------

    def decode(self) -> list:
        fh = self.fh
        cols = len(fh.col_starts) - 1
        for t, data in enumerate(fh.tiles):
            tr, tc = divmod(t, cols)
            self.decode_tile(data, fh.row_starts[tr], fh.row_starts[tr + 1],
                             fh.col_starts[tc], fh.col_starts[tc + 1])
        return self.frame

    def decode_tile(self, data, r0, r1, c0, c1) -> None:
        fh = self.fh
        self.sd = SymbolDecoder(data, fh.disable_cdf_update)
        self.cdf = T.default_cdfs(T.qctx(fh.base_q_idx))
        self.tile = (r0, r1, c0, c1)
        self.current_q = fh.base_q_idx
        self.delta_lf = [0, 0, 0, 0]
        wide = self.mi_cols + 40
        self.above_level = [[0] * wide for _ in range(3)]
        self.above_dc = [[0] * wide for _ in range(3)]
        LR.reset_refs(self)
        sb4 = self.sb4
        bsize = T.BLOCK_128X128 if sb4 == 32 else T.BLOCK_64X64
        for r in range(r0, r1, sb4):
            tall = self.mi_rows + 40
            self.left_level = [[0] * tall for _ in range(3)]
            self.left_dc = [[0] * tall for _ in range(3)]
            for c in range(c0, c1, sb4):
                self.read_deltas = fh.delta_q_present
                self.clear_block_decoded(r, c)
                LR.read_lr(self, r, c, bsize)
                self.decode_partition(r, c, bsize)
        # dav1d's overread check (its symbol decoder's count at -15 or below)
        if self.sd.bitpos - 8 * len(data) >= 15:
            raise ValueError("AV1: the symbol decoder reads past its tile")

    def inside(self, r: int, c: int) -> bool:
        r0, r1, c0, c1 = self.tile
        return c0 <= c < c1 and r0 <= r < r1

    def clear_block_decoded(self, r: int, c: int) -> None:
        _, r1, _, c1 = self.tile
        sb4 = self.sb4
        self.sb_origin = (r, c)
        self.decoded = []
        for p in range(self.num_planes):
            sx, sy = (self.ssx, self.ssy) if p else (0, 0)
            w4, h4 = (c1 - c) >> sx, (r1 - r) >> sy
            n = (sb4 >> min(sx, sy)) + 3
            grid = [[0] * n for _ in range(n)]
            for y in range(-1, (sb4 >> sy) + 1):
                for x in range(-1, (sb4 >> sx) + 1):
                    if (y < 0 and x < w4) or (x < 0 and y < h4):
                        grid[y + 1][x + 1] = 1
            grid[(sb4 >> sy) + 1][0] = 0
            self.decoded.append(grid)

    # --- partition -----------------------------------------------------

    def decode_partition(self, r: int, c: int, bsize: int) -> None:
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        avail_u, avail_l = self.inside(r - 1, c), self.inside(r, c - 1)
        bw = T.BLOCK_SIZES[bsize][0]
        num4 = bw >> 2
        half = num4 >> 1
        quarter = half >> 1
        has_rows = (r + half) < self.mi_rows
        has_cols = (c + half) < self.mi_cols
        if bsize < T.BLOCK_8X8:
            partition = T.PARTITION_NONE
        else:
            bsl = _log2(bw) - 2
            above = avail_u and _log2(T.BLOCK_SIZES[self.mi_sizes[r - 1][c]][0]) - 2 < bsl
            left = avail_l and _log2(T.BLOCK_SIZES[self.mi_sizes[r][c - 1]][1]) - 2 < bsl
            cdf = self.cdf["partition"][(bsl - 1) * 4 + left * 2 + above]
            if has_rows and has_cols:
                partition = self.sd.read_symbol(cdf)
            elif has_cols or has_rows:
                probs = [(32768 - cdf[k]) - (32768 - cdf[k - 1] if k else 0)
                         for k in range(len(cdf) - 1)]
                if has_cols:  # split_or_horz
                    kinds = [T.PARTITION_VERT, T.PARTITION_SPLIT, T.PARTITION_HORZ_A,
                             T.PARTITION_VERT_A, T.PARTITION_VERT_B]
                    if bsize != T.BLOCK_128X128:
                        kinds.append(T.PARTITION_VERT_4)
                else:  # split_or_vert
                    kinds = [T.PARTITION_HORZ, T.PARTITION_SPLIT, T.PARTITION_HORZ_A,
                             T.PARTITION_HORZ_B, T.PARTITION_VERT_A]
                    if bsize != T.BLOCK_128X128:
                        kinds.append(T.PARTITION_HORZ_4)
                psum = sum(probs[k] for k in kinds)
                split = self.sd.read_bool_cdf(psum)
                partition = T.PARTITION_SPLIT if split else (
                    T.PARTITION_HORZ if has_cols else T.PARTITION_VERT)
            else:
                partition = T.PARTITION_SPLIT
        if self.ssx and not self.ssy and self.num_planes > 1 and partition in _TALL:
            # 4:2:2 has no chroma block taller than wide: dav1d refuses these
            raise ValueError("AV1: a vertical partition in 4:2:2")
        if partition > T.PARTITION_SPLIT:
            self.tools.add("AB and 4-way partitions")
        sub = T.partition_subsize(partition, bsize)
        split = T.partition_subsize(T.PARTITION_SPLIT, bsize) if bsize >= T.BLOCK_8X8 else sub
        db = self.decode_block
        if partition == T.PARTITION_NONE:
            db(r, c, sub)
        elif partition == T.PARTITION_HORZ:
            db(r, c, sub)
            if has_rows:
                db(r + half, c, sub)
        elif partition == T.PARTITION_VERT:
            db(r, c, sub)
            if has_cols:
                db(r, c + half, sub)
        elif partition == T.PARTITION_SPLIT:
            self.decode_partition(r, c, sub)
            self.decode_partition(r, c + half, sub)
            self.decode_partition(r + half, c, sub)
            self.decode_partition(r + half, c + half, sub)
        elif partition == T.PARTITION_HORZ_A:
            db(r, c, split)
            db(r, c + half, split)
            db(r + half, c, sub)
        elif partition == T.PARTITION_HORZ_B:
            db(r, c, sub)
            db(r + half, c, split)
            db(r + half, c + half, split)
        elif partition == T.PARTITION_VERT_A:
            db(r, c, split)
            db(r + half, c, split)
            db(r, c + half, sub)
        elif partition == T.PARTITION_VERT_B:
            db(r, c, sub)
            db(r, c + half, split)
            db(r + half, c + half, split)
        elif partition == T.PARTITION_HORZ_4:
            for k in range(4):
                if k < 3 or r + quarter * 3 < self.mi_rows:
                    db(r + quarter * k, c, sub)
        else:
            for k in range(4):
                if k < 3 or c + quarter * 3 < self.mi_cols:
                    db(r, c + quarter * k, sub)

    # --- block ---------------------------------------------------------

    def decode_block(self, r: int, c: int, bsize: int) -> None:
        fh = self.fh
        self.mi_row, self.mi_col, self.mi_size = r, c, bsize
        bw, bh = T.BLOCK_SIZES[bsize]
        bw4, bh4 = bw >> 2, bh >> 2
        ssx, ssy = self.ssx, self.ssy
        if bh4 == 1 and ssy and (r & 1) == 0:
            self.has_chroma = False
        elif bw4 == 1 and ssx and (c & 1) == 0:
            self.has_chroma = False
        else:
            self.has_chroma = self.num_planes > 1
        self.avail_u, self.avail_l = self.inside(r - 1, c), self.inside(r, c - 1)
        self.avail_uc, self.avail_lc = self.avail_u, self.avail_l
        if self.has_chroma:
            if ssy and bh4 == 1:
                self.avail_uc = self.inside(r - 2, c)
            if ssx and bw4 == 1:
                self.avail_lc = self.inside(r, c - 2)
        else:
            self.avail_uc = self.avail_lc = False
        self.pal_y, self.pal_uv = [], ()
        self.mode_info()
        if self.pal_y or self.pal_uv:
            PAL.tokens(self)
        self.read_block_tx_size()
        if self.skip:
            self.reset_block_context(bw4, bh4)
        dl = tuple(self.delta_lf)
        pal_u = self.pal_uv[0] if self.pal_uv else ()
        for y in range(r, r + bh4):
            self.y_modes[y][c:c + bw4] = [self.y_mode] * bw4
            self.uv_modes[y][c:c + bw4] = [self.uv_mode] * bw4
            self.skips[y][c:c + bw4] = [self.skip] * bw4
            self.mi_sizes[y][c:c + bw4] = [bsize] * bw4
            self.seg_ids[y][c:c + bw4] = [self.segment_id] * bw4
            self.delta_lfs[y][c:c + bw4] = [dl] * bw4
            self.is_inters[y][c:c + bw4] = [self.is_inter] * bw4
            self.mvs[y][c:c + bw4] = [self.mv] * bw4
            self.written[y][c:c + bw4] = [1] * bw4
            self.pal_sizes[0][y][c:c + bw4] = [len(self.pal_y)] * bw4
            self.pal_sizes[1][y][c:c + bw4] = [len(pal_u)] * bw4
            self.pal_colours[0][y][c:c + bw4] = [self.pal_y] * bw4
            self.pal_colours[1][y][c:c + bw4] = [pal_u] * bw4
        if self.is_inter:
            self.predict_intrabc()
        self.residual()

    def mode_info(self) -> None:
        fh, sd, cdf = self.fh, self.sd, self.cdf
        r, c = self.mi_row, self.mi_col
        if fh.seg_id_pre_skip:
            self.intra_segment_id(pre_skip=True)
        self.skip = 0
        if fh.seg_id_pre_skip and fh.seg_feature[self.segment_id][6] is not None:
            self.skip = 1
        else:
            ctx = (self.skips[r - 1][c] if self.avail_u else 0) + (
                self.skips[r][c - 1] if self.avail_l else 0)
            self.skip = sd.read_symbol(cdf["skip"][ctx])
        if not fh.seg_id_pre_skip:
            self.intra_segment_id(pre_skip=False)
        self.read_cdef()
        self.read_delta_qindex()
        self.read_delta_lf()
        self.read_deltas = 0
        self.is_inter, self.mv = 0, (0, 0)
        self.use_filter_intra = 0
        if fh.allow_intrabc and sd.read_symbol(cdf["intrabc"]):
            self.is_inter = 1
            self.y_mode = self.uv_mode = T.DC_PRED
            self.angle_delta_y = self.angle_delta_uv = 0
            self.mv = IBC.clip_vector(self, IBC.read_mv(self, IBC.predicted_vector(self)))
            self.tools.add("intrabc")
            return
        above = self.y_modes[r - 1][c] if self.avail_u else T.DC_PRED
        left = self.y_modes[r][c - 1] if self.avail_l else T.DC_PRED
        self.y_mode = sd.read_symbol(
            cdf["kf_y_mode"][T.INTRA_MODE_CONTEXT[above]][T.INTRA_MODE_CONTEXT[left]])
        self.angle_delta_y = self.angle_delta_uv = 0
        bw, bh = T.BLOCK_SIZES[self.mi_size]
        if self.mi_size >= T.BLOCK_8X8 and T.V_PRED <= self.y_mode <= T.D67_PRED:
            self.angle_delta_y = sd.read_symbol(cdf["angle_delta"][self.y_mode - 1]) - 3
        self.uv_mode = T.DC_PRED
        if self.has_chroma:
            if self.lossless:
                sx, sy = self.ssx, self.ssy
                cfl_allowed = max(bw >> sx, 4) == 4 and max(bh >> sy, 4) == 4
            else:
                cfl_allowed = max(bw, bh) <= 32
            self.uv_mode = sd.read_symbol(cdf["uv_mode"][int(cfl_allowed)][self.y_mode])
            if self.uv_mode == T.UV_CFL_PRED:
                self.tools.add("CFL")
                signs = sd.read_symbol(cdf["cfl_sign"])
                sign_u, sign_v = (signs + 1) // 3, (signs + 1) % 3
                self.cfl_u = self.cfl_v = 0
                if sign_u:
                    a = 1 + sd.read_symbol(cdf["cfl_alpha"][(sign_u - 1) * 3 + sign_v])
                    self.cfl_u = -a if sign_u == 1 else a
                if sign_v:
                    a = 1 + sd.read_symbol(cdf["cfl_alpha"][(sign_v - 1) * 3 + sign_u])
                    self.cfl_v = -a if sign_v == 1 else a
            if self.mi_size >= T.BLOCK_8X8 and T.V_PRED <= self.uv_mode <= T.D67_PRED:
                self.angle_delta_uv = sd.read_symbol(cdf["angle_delta"][self.uv_mode - 1]) - 3
        if self.angle_delta_y or self.angle_delta_uv:
            self.tools.add("angle deltas")
        if (self.mi_size >= T.BLOCK_8X8 and bw <= 64 and bh <= 64
                and fh.allow_screen_content_tools):
            PAL.mode_info(self)
        if (self.seq.enable_filter_intra and self.y_mode == T.DC_PRED and not self.pal_y
                and max(bw, bh) <= 32):
            self.use_filter_intra = sd.read_symbol(cdf["filter_intra"][self.mi_size])
            if self.use_filter_intra:
                self.tools.add("filter intra")
                self.filter_intra_mode = sd.read_symbol(cdf["filter_intra_mode"])
        self.tools.add(("y mode", self.y_mode))
        if self.has_chroma:
            self.tools.add(("uv mode", self.uv_mode))

    def intra_segment_id(self, pre_skip: bool) -> None:
        fh = self.fh
        self.segment_id = 0
        if fh.seg_enabled:
            r, c = self.mi_row, self.mi_col
            au, al = self.avail_u, self.avail_l
            prev_ul = self.seg_ids[r - 1][c - 1] if au and al else -1
            prev_u = self.seg_ids[r - 1][c] if au else -1
            prev_l = self.seg_ids[r][c - 1] if al else -1
            if prev_u == -1:
                pred = 0 if prev_l == -1 else prev_l
            elif prev_l == -1:
                pred = prev_u
            else:
                pred = prev_u if prev_ul == prev_u else prev_l
            if not pre_skip and self.skip:
                self.segment_id = pred
            else:
                if prev_ul < 0:
                    ctx = 0
                elif prev_ul == prev_u and prev_ul == prev_l:
                    ctx = 2
                elif prev_ul == prev_u or prev_ul == prev_l or prev_u == prev_l:
                    ctx = 1
                else:
                    ctx = 0
                v = self.sd.read_symbol(self.cdf["segment_id"][ctx])
                mx = fh.last_active_seg_id + 1
                self.segment_id = max(0, min(fh.last_active_seg_id, _neg_deinterleave(v, pred, mx)))
        self.lossless = fh.lossless[self.segment_id]

    def read_cdef(self) -> None:
        fh = self.fh
        if self.skip or not fh.cdef_read:
            return
        r, c = self.mi_row & ~15, self.mi_col & ~15
        if (r >> 4, c >> 4) not in self.cdef_idx:
            v = self.sd.read_literal(fh.cdef_bits)
            bw, bh = T.BLOCK_SIZES[self.mi_size]
            for y in range(r, r + (bh >> 2), 16):
                for x in range(c, c + (bw >> 2), 16):
                    self.cdef_idx[(y >> 4, x >> 4)] = v

    def read_delta_qindex(self) -> None:
        sb = T.BLOCK_128X128 if self.sb4 == 32 else T.BLOCK_64X64
        if self.mi_size == sb and self.skip:
            return
        if self.read_deltas:
            sd = self.sd
            a = sd.read_symbol(self.cdf["delta_q"])
            if a == 3:
                n = sd.read_literal(3) + 1
                a = sd.read_literal(n) + (1 << n) + 1
            if a:
                sign = sd.read_literal(1)
                d = -a if sign else a
                self.current_q = max(1, min(255, self.current_q + (d << self.fh.delta_q_res)))

    def read_delta_lf(self) -> None:
        fh = self.fh
        sb = T.BLOCK_128X128 if self.sb4 == 32 else T.BLOCK_64X64
        if self.mi_size == sb and self.skip:
            return
        if self.read_deltas and fh.delta_lf_present:
            sd = self.sd
            count = 1
            if fh.delta_lf_multi:
                count = 4 if self.num_planes > 1 else 2
            for i in range(count):
                cdf = self.cdf["delta_lf_multi"][i] if fh.delta_lf_multi else self.cdf["delta_lf"]
                a = sd.read_symbol(cdf)
                if a == 3:
                    n = sd.read_literal(3) + 1
                    a = sd.read_literal(n) + (1 << n) + 1
                if a:
                    sign = sd.read_literal(1)
                    d = -a if sign else a
                    self.delta_lf[i] = max(-63, min(63, self.delta_lf[i] + (d << fh.delta_lf_res)))

    def read_block_tx_size(self) -> None:
        """read_block_tx_size: an intrabc block's transform tree
        (read_var_tx_size), else read_tx_size; InterTxSizes for the block."""
        bsize = self.mi_size
        bw, bh = T.BLOCK_SIZES[bsize]
        r, c = self.mi_row, self.mi_col
        if (self.fh.tx_mode_select and bsize > T.BLOCK_4X4 and self.is_inter and not self.skip
                and not self.lossless):
            max_tx = T.max_tx_rect(bsize)
            tw, th = T.TX_SIZES[max_tx]
            for row in range(r, r + (bh >> 2), th >> 2):
                for col in range(c, c + (bw >> 2), tw >> 2):
                    self.read_var_tx_size(row, col, max_tx, 0)
        else:
            self.read_tx_size(not self.skip or not self.is_inter)
            for y in range(r, r + (bh >> 2)):
                self.tx_sizes[y][c:c + (bw >> 2)] = [self.tx_size] * (bw >> 2)

    def read_var_tx_size(self, row: int, col: int, tx: int, depth: int) -> None:
        if row >= self.mi_rows or col >= self.mi_cols:
            return
        tw, th = T.TX_SIZES[tx]
        split = 0
        if tx != T.TX_4X4 and depth < 2:
            above = self.above_tx_width(row, col) < tw
            left = self.left_tx_height(row, col) < th
            bw, bh = T.BLOCK_SIZES[self.mi_size]
            size = min(64, max(bw, bh))
            max_sq = T.TX_INDEX[(size, size)]
            ctx = (T.tx_sqr_up(tx) != max_sq) * 3 + (4 - max_sq) * 6 + above + left
            split = self.sd.read_symbol(self.cdf["txfm_split"][ctx])
        if split:
            self.tools.add("inter tx split")
            sub = T.SPLIT_TX_SIZE[tx]
            sw, sh = T.TX_SIZES[sub]
            for i in range(0, th >> 2, sh >> 2):
                for j in range(0, tw >> 2, sw >> 2):
                    self.read_var_tx_size(row + i, col + j, sub, depth + 1)
        else:
            for i in range(th >> 2):
                self.tx_sizes[row + i][col:col + (tw >> 2)] = [tx] * (tw >> 2)
            self.tx_size = tx

    def above_tx_width(self, row: int, col: int) -> int:
        if row == self.mi_row:
            if not self.avail_u:
                return 64
            if self.skips[row - 1][col] and self.is_inters[row - 1][col]:
                return T.BLOCK_SIZES[self.mi_sizes[row - 1][col]][0]
        return T.TX_SIZES[self.tx_sizes[row - 1][col]][0]

    def left_tx_height(self, row: int, col: int) -> int:
        if col == self.mi_col:
            if not self.avail_l:
                return 64
            if self.skips[row][col - 1] and self.is_inters[row][col - 1]:
                return T.BLOCK_SIZES[self.mi_sizes[row][col - 1]][1]
        return T.TX_SIZES[self.tx_sizes[row][col - 1]][1]

    def read_tx_size(self, allow_select: bool) -> None:
        fh = self.fh
        bsize = self.mi_size
        if self.lossless:
            self.tx_size = T.TX_4X4
            return
        max_rect = T.max_tx_rect(bsize)
        self.tx_size = max_rect
        if bsize > T.BLOCK_4X4 and allow_select and fh.tx_mode_select:
            tx, cat = max_rect, -1  # cat: the splits down to 4x4, less one
            while tx != T.TX_4X4:
                cat += 1
                tx = T.SPLIT_TX_SIZE[tx]
            mw, mh = T.TX_SIZES[max_rect]
            r, c = self.mi_row, self.mi_col
            if self.avail_u and self.is_inters[r - 1][c]:
                above = T.BLOCK_SIZES[self.mi_sizes[r - 1][c]][0] >= mw
            else:
                above = self.avail_u and self.above_tx_width(r, c) >= mw
            if self.avail_l and self.is_inters[r][c - 1]:
                left = T.BLOCK_SIZES[self.mi_sizes[r][c - 1]][1] >= mh
            else:
                left = self.avail_l and self.left_tx_height(r, c) >= mh
            depth = self.sd.read_symbol(self.cdf["tx_size"][cat][above + left])
            for _ in range(depth):
                self.tx_size = T.SPLIT_TX_SIZE[self.tx_size]
            if depth:
                self.tools.add("tx split")

    def reset_block_context(self, bw4: int, bh4: int) -> None:
        bw, bh = bw4 * 4, bh4 * 4
        for p in range(1 + 2 * self.has_chroma):
            sx, sy = (self.ssx, self.ssy) if p else (0, 0)
            x0, y0 = self.mi_col >> sx, self.mi_row >> sy
            w4, h4 = max(bw >> sx, 4) >> 2, max(bh >> sy, 4) >> 2
            self.above_level[p][x0:x0 + w4] = [0] * w4
            self.above_dc[p][x0:x0 + w4] = [0] * w4
            self.left_level[p][y0:y0 + h4] = [0] * h4
            self.left_dc[p][y0:y0 + h4] = [0] * h4

    # --- residual ------------------------------------------------------

    def residual(self) -> None:
        bw, bh = T.BLOCK_SIZES[self.mi_size]
        for cy in range(max(1, bh >> 6)):
            for cx in range(max(1, bw >> 6)):
                for p in range(1 + 2 * self.has_chroma):
                    sx, sy = (self.ssx, self.ssy) if p else (0, 0)
                    if self.lossless:
                        tx = T.TX_4X4
                    elif p == 0:
                        tx = self.tx_size
                    else:
                        tx = T.max_tx_rect(T.BLOCK_INDEX[(max(bw >> sx, 4), max(bh >> sy, 4))])
                        tw, th = T.TX_SIZES[tx]
                        if tw == 64 or th == 64:
                            tx = (T.TX_16X32 if tw == 16 else T.TX_32X16 if th == 16
                                  else T.TX_32X32)
                    tw, th = T.TX_SIZES[tx]
                    n4w, n4h = max(bw >> sx, 4) >> 2, max(bh >> sy, 4) >> 2
                    if self.is_inter and not self.lossless and p == 0:
                        self.transform_tree(self.mi_col * 4 + (cx << 6),
                                            self.mi_row * 4 + (cy << 6), min(bw, 64), min(bh, 64))
                        continue
                    bx, by = (self.mi_col >> sx) * 4, (self.mi_row >> sy) * 4
                    for y in range(0, min(n4h, 16 >> sy), th >> 2):
                        for x in range(0, min(n4w, 16 >> sx), tw >> 2):
                            self.transform_block(p, bx, by, tx, x + ((cx << 4) >> sx),
                                                 y + ((cy << 4) >> sy))

    def transform_tree(self, x: int, y: int, w: int, h: int) -> None:
        """An inter block's luma transform blocks in transform_tree's order,
        their sizes from InterTxSizes."""
        if x >= self.mi_cols * 4 or y >= self.mi_rows * 4:
            return
        lw, lh = T.TX_SIZES[self.tx_sizes[y >> 2][x >> 2]]
        if w <= lw and h <= lh:
            self.transform_block(0, x, y, T.TX_INDEX[(w, h)], 0, 0)
        elif w > h:
            self.transform_tree(x, y, w // 2, h)
            self.transform_tree(x + w // 2, y, w // 2, h)
        elif w < h:
            self.transform_tree(x, y, w, h // 2)
            self.transform_tree(x, y + h // 2, w, h // 2)
        else:
            for dy in (0, h // 2):
                for dx in (0, w // 2):
                    self.transform_tree(x + dx, y + dy, w // 2, h // 2)

    def predict_intrabc(self) -> None:
        """compute_prediction of an intrabc block: each plane's whole block
        copied along the block's vector."""
        bw, bh = T.BLOCK_SIZES[self.mi_size]
        for p in range(1 + 2 * self.has_chroma):
            sx, sy = (self.ssx, self.ssy) if p else (0, 0)
            IBC.predict(self, p, (self.mi_col >> sx) * 4, (self.mi_row >> sy) * 4,
                        max(bw >> sx, 4), max(bh >> sy, 4), self.mv)

    def transform_block(self, p: int, base_x: int, base_y: int, tx: int, x: int, y: int) -> None:
        sx, sy = (self.ssx, self.ssy) if p else (0, 0)
        start_x, start_y = base_x + 4 * x, base_y + 4 * y
        row, col = (start_y << sy) >> 2, (start_x << sx) >> 2
        sbr, sbc = row - self.sb_origin[0], col - self.sb_origin[1]
        tw, th = T.TX_SIZES[tx]
        step_x, step_y = tw >> 2, th >> 2
        max_x, max_y = (self.mi_cols * 4) >> sx, (self.mi_rows * 4) >> sy
        if start_x >= max_x or start_y >= max_y:
            return
        is_cfl = p > 0 and self.uv_mode == T.UV_CFL_PRED
        mode = self.y_mode if p == 0 else (T.DC_PRED if is_cfl else self.uv_mode)
        dec = self.decoded[p]
        if self.is_inter:
            pass
        elif self.pal_y if p == 0 else self.pal_uv:
            PAL.predict(self, p, start_x, start_y, x, y, tw, th)
        else:
            have_left = (self.avail_l if p == 0 else self.avail_lc) or x > 0
            have_above = (self.avail_u if p == 0 else self.avail_uc) or y > 0
            have_ar = dec[(sbr >> sy) - 1 + 1][(sbc >> sx) + step_x + 1]
            have_bl = dec[(sbr >> sy) + step_y + 1][(sbc >> sx) - 1 + 1]
            self.predict_intra(p, start_x, start_y, have_left, have_above, have_ar, have_bl,
                               mode, tw, th)
            if is_cfl:
                self.cfl(p, start_x, start_y, tw, th)
        if p == 0:
            self.max_luma_w = start_x + step_x * 4
            self.max_luma_h = start_y + step_y * 4
        if not self.skip:
            res = self.coeffs(p, start_x >> 2, start_y >> 2, tx)
            if res is not None:
                coef, tx_type = res
                resid = R.inverse_transform(coef, tx, tx_type, self.lossless, self.bit_depth)
                vk, hk = T.TX_1D[tx_type]
                if vk == 2:
                    resid = resid[::-1]
                if hk == 2:
                    resid = resid[:, ::-1]
                f = self.frame[p]
                blk = f[start_y:start_y + th, start_x:start_x + tw]
                f[start_y:start_y + th, start_x:start_x + tw] = np.clip(blk + resid, 0,
                                                                        self.pixel_max)
        lf = self.lf_tx[p]
        for i in range(step_y):
            lf[(row >> sy) + i][(col >> sx):(col >> sx) + step_x] = [tx] * step_x
            r = (sbr >> sy) + i + 1
            dec[r][(sbc >> sx) + 1:(sbc >> sx) + 1 + step_x] = [1] * step_x

    # --- prediction ----------------------------------------------------

    def predict_intra(self, p, x, y, have_left, have_above, have_ar, have_bl, mode, w, h):
        f = self.frame[p]
        sx, sy = (self.ssx, self.ssy) if p else (0, 0)
        max_x = ((self.mi_cols * 4) >> sx) - 1
        max_y = ((self.mi_rows * 4) >> sy) - 1
        n = w + h
        size = _EDGE + 2 * n + 16
        if not have_above and have_left:
            above = [int(f[y, x - 1])] * size
        elif not have_above:
            above = [self.mid - 1] * size
        else:
            lim = min(max_x, x + (2 * w if have_ar else w) - 1)
            row = f[y - 1, x:lim + 1].tolist()
            row += [row[-1]] * (size - len(row))
            above = [0] * _EDGE + row[:size - _EDGE]
        if not have_left and have_above:
            left = [int(f[y - 1, x])] * size
        elif not have_left:
            left = [self.mid + 1] * size
        else:
            lim = min(max_y, y + (2 * h if have_bl else h) - 1)
            col = f[y:lim + 1, x - 1].tolist()
            col += [col[-1]] * (size - len(col))
            left = [0] * _EDGE + col[:size - _EDGE]
        if have_above and have_left:
            corner = int(f[y - 1, x - 1])
        elif have_above:
            corner = int(f[y - 1, x])
        elif have_left:
            corner = int(f[y, x - 1])
        else:
            corner = self.mid
        above[_EDGE - 1] = left[_EDGE - 1] = corner
        if p == 0 and self.use_filter_intra:
            pred = R.filter_intra(above, left, w, h, self.filter_intra_mode, self.pixel_max)
        elif T.V_PRED <= mode <= T.D67_PRED:
            delta = self.angle_delta_y if p == 0 else self.angle_delta_uv
            angle = T.MODE_TO_ANGLE[mode] + delta * 3
            up_a = up_l = 0
            if self.seq.enable_intra_edge_filter:
                ftype = 0
                if angle != 90 and angle != 180:
                    if 90 < angle < 180 and w + h >= 24:
                        v = (left[_EDGE] * 5 + above[_EDGE - 1] * 6 + above[_EDGE] * 5 + 8) >> 4
                        above[_EDGE - 1] = left[_EDGE - 1] = v
                    ftype = self.filter_type(p)
                    if have_above:
                        st = R.edge_filter_strength(w, h, ftype, angle - 90)
                        num = min(w, max_x - x + 1) + (h if angle < 90 else 0) + 1
                        R.edge_filter(above, num, st)
                    if have_left:
                        st = R.edge_filter_strength(w, h, ftype, angle - 180)
                        num = min(h, max_y - y + 1) + (w if angle > 180 else 0) + 1
                        R.edge_filter(left, num, st)
                up_a = int(R.use_upsample(w, h, ftype, angle - 90))
                if up_a:
                    R.upsample(above, w + (h if angle < 90 else 0), self.pixel_max)
                up_l = int(R.use_upsample(w, h, ftype, angle - 180))
                if up_l:
                    R.upsample(left, h + (w if angle > 180 else 0), self.pixel_max)
            pred = R.directional(above, left, w, h, angle, up_a, up_l)
        elif mode in (T.SMOOTH_PRED, T.SMOOTH_V_PRED, T.SMOOTH_H_PRED):
            pred = R.smooth(above, left, w, h, mode)
        elif mode == T.DC_PRED:
            pred = R.dc(above, left, w, h, have_above, have_left, self.mid)
        else:
            pred = R.paeth(above, left, w, h)
        f[y:y + h, x:x + w] = pred

    def filter_type(self, p: int) -> int:
        r, c = self.mi_row, self.mi_col
        smooth = (T.SMOOTH_PRED, T.SMOOTH_V_PRED, T.SMOOTH_H_PRED)
        modes = self.y_modes if p == 0 else self.uv_modes
        if self.avail_u if p == 0 else self.avail_uc:
            rr, cc = r - 1, c
            if p:
                if self.ssx and not (c & 1):
                    cc += 1
                if self.ssy and (r & 1):
                    rr -= 1
            if modes[rr][cc] in smooth:
                return 1
        if self.avail_l if p == 0 else self.avail_lc:
            rr, cc = r, c - 1
            if p:
                if self.ssx and (c & 1):
                    cc -= 1
                if self.ssy and not (r & 1):
                    rr += 1
            if modes[rr][cc] in smooth:
                return 1
        return 0

    def cfl(self, p: int, x: int, y: int, w: int, h: int) -> None:
        sx, sy = self.ssx, self.ssy
        alpha = self.cfl_u if p == 1 else self.cfl_v
        luma = self.frame[0]
        ys = np.minimum((y + np.arange(h)) << sy, self.max_luma_h - (1 << sy))
        xs = np.minimum((x + np.arange(w)) << sx, self.max_luma_w - (1 << sx))
        t = np.zeros((h, w), np.int64)
        for dy in range(sy + 1):
            for dx in range(sx + 1):
                t += luma[(ys + dy)[:, None], (xs + dx)[None, :]]
        lv = t << (3 - sx - sy)
        avg = (int(lv.sum()) + ((w * h) >> 1)) >> (_log2(w) + _log2(h))
        f = self.frame[p]
        dcv = f[y:y + h, x:x + w].astype(np.int64)
        d = alpha * (lv - avg)
        scaled = np.where(d >= 0, (d + 32) >> 6, -((-d + 32) >> 6))
        f[y:y + h, x:x + w] = np.clip(dcv + scaled, 0, self.pixel_max)

    # --- coefficients --------------------------------------------------

    def tx_set(self, tx: int) -> int:
        """get_tx_set: the inter sets for an intrabc block."""
        up = T.tx_sqr_up(tx)
        if self.is_inter:
            if up > T.TX_32X32:
                return T.TX_SET_DCTONLY
            if self.fh.reduced_tx_set or up == T.TX_32X32:
                return T.TX_SET_INTER_3
            return T.TX_SET_INTER_2 if T.tx_sqr(tx) == T.TX_16X16 else T.TX_SET_INTER_1
        if up >= T.TX_32X32:
            return T.TX_SET_DCTONLY
        if self.fh.reduced_tx_set or T.tx_sqr(tx) == T.TX_16X16:
            return T.TX_SET_INTRA_2
        return T.TX_SET_INTRA_1

    def coeffs(self, p: int, x4: int, y4: int, tx: int):
        sd, cdf, fh = self.sd, self.cdf, self.fh
        tw, th = T.TX_SIZES[tx]
        w4, h4 = tw >> 2, th >> 2
        txs_ctx = (T.tx_sqr(tx) + T.tx_sqr_up(tx) + 1) >> 1
        ptype = 1 if p else 0
        sx, sy = (self.ssx, self.ssy) if p else (0, 0)
        max_x4, max_y4 = self.mi_cols >> sx, self.mi_rows >> sy
        al, ad = self.above_level[p], self.above_dc[p]
        ll, ld = self.left_level[p], self.left_dc[p]
        bw, bh = T.BLOCK_SIZES[self.mi_size]
        pw, ph = max(bw >> sx, 4), max(bh >> sy, 4)
        if p == 0:
            top = max([al[x4 + k] for k in range(w4) if x4 + k < max_x4] or [0])
            left = max([ll[y4 + k] for k in range(h4) if y4 + k < max_y4] or [0])
            top, left = min(top, 255), min(left, 255)
            if pw == tw and ph == th:
                ctx = 0
            elif top == 0 and left == 0:
                ctx = 1
            elif top == 0 or left == 0:
                ctx = 2 + (max(top, left) > 3)
            elif max(top, left) <= 3:
                ctx = 4
            elif min(top, left) <= 3:
                ctx = 5
            else:
                ctx = 6
        else:
            above = any(al[x4 + k] or ad[x4 + k] for k in range(w4) if x4 + k < max_x4)
            left = any(ll[y4 + k] or ld[y4 + k] for k in range(h4) if y4 + k < max_y4)
            ctx = 7 + int(above) + int(left)
            if pw * ph > tw * th:
                ctx += 3
        all_zero = sd.read_symbol(cdf["txb_skip"][txs_ctx][ctx])
        if all_zero:
            al[x4:x4 + w4] = [0] * w4
            ad[x4:x4 + w4] = [0] * w4
            ll[y4:y4 + h4] = [0] * h4
            ld[y4:y4 + h4] = [0] * h4
            if p == 0:
                for k in range(h4):
                    self.tx_types[y4 + k][x4:x4 + w4] = [T.DCT_DCT] * w4
            return None
        tx_set = self.tx_set(tx)
        lossless = self.lossless
        if p == 0:
            tx_type = T.DCT_DCT
            q_for_type = qindex(fh, self.segment_id, None)
            if tx_set != T.TX_SET_DCTONLY and q_for_type > 0 and self.is_inter:
                if tx_set == T.TX_SET_INTER_1:
                    s = sd.read_symbol(cdf["tx_inter1"][T.tx_sqr(tx)])
                    tx_type = T.TX_TYPE_INTER_INV_SET1[s]
                elif tx_set == T.TX_SET_INTER_2:
                    s = sd.read_symbol(cdf["tx_inter2"])
                    tx_type = T.TX_TYPE_INTER_INV_SET2[s]
                else:
                    s = sd.read_symbol(cdf["tx_inter3"][T.tx_sqr(tx)])
                    tx_type = T.TX_TYPE_INTER_INV_SET3[s]
            elif tx_set != T.TX_SET_DCTONLY and q_for_type > 0:
                mode = (T.FILTER_INTRA_MODE_TO_DIR[self.filter_intra_mode]
                        if self.use_filter_intra else self.y_mode)
                if tx_set == T.TX_SET_INTRA_1:
                    s = sd.read_symbol(cdf["tx_set1"][T.tx_sqr(tx)][mode])
                    tx_type = T.TX_TYPE_INTRA_INV_SET1[s]
                else:
                    s = sd.read_symbol(cdf["tx_set2"][T.tx_sqr(tx)][mode])
                    tx_type = T.TX_TYPE_INTRA_INV_SET2[s]
            for k in range(h4):
                self.tx_types[y4 + k][x4:x4 + w4] = [tx_type] * w4
            if lossless or T.tx_sqr_up(tx) > T.TX_32X32:
                tx_type = T.DCT_DCT
        else:
            if lossless or T.tx_sqr_up(tx) > T.TX_32X32:
                tx_type = T.DCT_DCT
            elif self.is_inter:  # luma's type at the same place
                tx_type = self.tx_types[max(self.mi_row, y4 << sy)][max(self.mi_col, x4 << sx)]
                if tx_type not in T.TX_TYPES_IN_SET[tx_set]:
                    tx_type = T.DCT_DCT
            else:
                tx_type = T.MODE_TO_TXFM[self.uv_mode]
                if tx_type not in T.TX_TYPES_IN_SET[tx_set]:
                    tx_type = T.DCT_DCT
        self.tools.add(("tx type", tx_type))
        cls = T.tx_class(tx_type)
        ww, hh = min(tw, 32), min(th, 32)
        multisize = min(_log2(tw), 5) + min(_log2(th), 5) - 4
        if multisize <= 4:
            eob_cdf = cdf["eob_pt_%d" % (16 << multisize)][ptype][0 if cls == 0 else 1]
        else:
            eob_cdf = cdf["eob_pt_%d" % (16 << multisize)][ptype]
        eob_pt = sd.read_symbol(eob_cdf) + 1
        eob = eob_pt if eob_pt < 2 else (1 << (eob_pt - 2)) + 1
        if eob_pt >= 3:
            if sd.read_symbol(cdf["eob_extra"][txs_ctx][ptype][eob_pt - 3]):
                eob += 1 << (eob_pt - 3)
            for i in range(1, eob_pt - 2):
                if sd.read_bool():
                    eob += 1 << (eob_pt - 3 - i)
        stride = ww + 4
        lev = [0] * (stride * (hh + 4))  # levels, on a grid padded by 4
        lev3 = lev[:]  # min(level, 3), the base contexts' terms
        lev15 = lev[:]  # min(level, 15), the range contexts' terms
        base_cdfs = cdf["coeff_base"][txs_ctx][ptype]
        br_cdfs = cdf["coeff_br"][min(txs_ctx, 3)][ptype]
        info = _scan_info(tx, cls)
        (b1, b2, b3, b4, b5), (r1, r2, r3) = _NEIGHBOURS[cls](stride)
        area = ww * hh
        read = sd.read_symbol
        for c in range(eob - 1, -1, -1):
            pos, lp, base_off, br_off = info[c]
            if c == eob - 1:
                ctx = 0 if c == 0 else 1 if c <= area // 8 else 2 if c <= area // 4 else 3
                level = read(cdf["coeff_base_eob"][txs_ctx][ptype][ctx]) + 1
            else:
                mag = lev3[lp + b1] + lev3[lp + b2] + lev3[lp + b3] + lev3[lp + b4] + lev3[lp + b5]
                level = read(base_cdfs[_BASE_MAG[mag] + base_off if base_off >= 0 else 0])
            if level > 2:
                mag = lev15[lp + r1] + lev15[lp + r2] + lev15[lp + r3]
                bc = br_cdfs[_BR_MAG[mag] + br_off]
                for _ in range(4):
                    k = read(bc)
                    level += k
                    if k < 3:
                        break
            lev[lp] = level
            lev3[lp] = level if level < 3 else 3
            lev15[lp] = level if level < 15 else 15
        # signs, Golomb, dequantisation
        dc_sign_ctx = 0
        s = 0
        for k in range(w4):
            if x4 + k < max_x4:
                s += (ad[x4 + k] == 2) - (ad[x4 + k] == 1)
        for k in range(h4):
            if y4 + k < max_y4:
                s += (ld[y4 + k] == 2) - (ld[y4 + k] == 1)
        dc_sign_ctx = 1 if s < 0 else 2 if s > 0 else 0
        q = self.current_q if fh.delta_q_present else None
        qi = qindex(fh, self.segment_id, q)
        dqy, dqu = ((fh.dq_y_dc, 0), (fh.dq_u_dc, fh.dq_u_ac), (fh.dq_v_dc, fh.dq_v_ac))[p]
        depth_row = (self.bit_depth - 8) >> 1
        dcq = int(T.DEQUANT[depth_row, max(0, min(255, qi + dqy)), 0])
        acq = int(T.DEQUANT[depth_row, max(0, min(255, qi + dqu)), 1])
        cf_max = (1 << (7 + self.bit_depth)) - 1
        pels = tw * th
        dq_shift = (pels > 256) + (pels > 1024)
        # the segment's matrix weights a 2D transform's quantisers (identity
        # and 1D types, and a lossless segment's level 15, read none)
        qm_level = fh.seg_qm_level[self.segment_id][p]
        qm = None
        if qm_level < 15:
            if tx_type < T.IDTX:
                qm = _qm_row(qm_level, p > 0, tx)
                self.tools.add(("qm tx size", T.TX_SIZES[tx]))
            else:
                self.tools.add("qm flat for identity and 1D types")
        coef = np.zeros((th, tw), np.int64)
        cul = 0
        dc_cat = 0
        for c in range(eob):
            pos, lp = info[c][:2]
            level = lev[lp]
            if not level:
                continue
            row, col = divmod(pos, ww)
            sign = read(cdf["dc_sign"][ptype][dc_sign_ctx]) if c == 0 else sd.read_bool()
            if level > 14:
                length = 0
                while True:
                    length += 1
                    if sd.read_bool():
                        break
                    if length > 32:
                        raise ValueError("AV1: Golomb code too long")
                x = 1
                for _ in range(length - 1):
                    x = (x << 1) | sd.read_bool()
                level = x + 14
            if pos == 0:
                dc_cat = 1 if sign else 2
            level &= 0xFFFFF
            cul += level
            q = dcq if pos == 0 else acq
            if qm is not None:
                q = (q * qm[pos] + 16) >> 5
            dq = ((level * q) & 0xFFFFFF) >> dq_shift
            dq = min(dq, cf_max) if not sign else -min(dq, cf_max + 1)
            coef[row, col] = dq
        cul = min(63, cul)
        al[x4:x4 + w4] = [cul] * w4
        ad[x4:x4 + w4] = [dc_cat] * w4
        ll[y4:y4 + h4] = [cul] * h4
        ld[y4:y4 + h4] = [dc_cat] * h4
        return coef, tx_type


_TALL = (T.PARTITION_VERT, T.PARTITION_VERT_A, T.PARTITION_VERT_B, T.PARTITION_VERT_4)
_BASE_MAG = tuple(min((m + 1) >> 1, 4) for m in range(16))
_BR_MAG = tuple(min((m + 1) >> 1, 6) for m in range(46))
# a class's neighbours on a grid of the given stride: the five of the base
# level's context, the three of the range's (Sig_Ref_Diff_Offset,
# Mag_Ref_Offset_With_Tx_Class)
_NEIGHBOURS = {T.TX_CLASS_2D: lambda s: ((1, s, s + 1, 2, 2 * s), (1, s, s + 1)),
               T.TX_CLASS_HORIZ: lambda s: ((1, s, 2, 3, 4), (1, s, 2)),
               T.TX_CLASS_VERT: lambda s: ((1, s, 2 * s, 3 * s, 4 * s), (1, s, 2 * s))}


@functools.lru_cache(maxsize=None)
def _qm_row(level: int, chroma: bool, tx: int) -> tuple:
    """Quantizer_Matrix[level][chroma] from Qm_Offset[tx], one weight a
    position of the (at most 32x32) coded region in this decoder's order
    (row * width + column): the table holds a size's weights column by
    column, which squares' symmetry hides and the rectangles show."""
    ww, hh = (min(n, 32) for n in T.TX_SIZES[tx])
    at = T.QM_OFFSET[tx]
    weights = T.QUANTIZER_MATRIX[level, int(chroma), at:at + ww * hh].reshape(ww, hh)
    return tuple(int(v) for v in weights.T.reshape(-1))


@functools.lru_cache(maxsize=None)
def _scan_info(tx: int, cls: int) -> tuple:
    """For each scan index: the position, its place on the padded level
    grid, its base context's offset (-1: the 2D class's DC, context 0) and
    its range context's (0 at the DC, 7 near it, 14 beyond)."""
    tw, th = T.TX_SIZES[tx]
    ww = min(tw, 32)
    offsets = T.coeff_base_ctx_offset(tx)
    out = []
    for pos in T.scan(tx, cls):
        row, col = divmod(pos, ww)
        if cls == T.TX_CLASS_2D:
            base, near = (-1 if pos == 0 else offsets[pos]), row < 2 and col < 2
        elif cls == T.TX_CLASS_HORIZ:
            base, near = 26 + 5 * min(col, 2), col == 0
        else:
            base, near = 26 + 5 * min(row, 2), row == 0
        out.append((pos, row * (ww + 4) + col, base, 0 if pos == 0 else 7 if near else 14))
    return tuple(out)


def _neg_deinterleave(diff: int, ref: int, mx: int) -> int:
    if not ref:
        return diff
    if ref >= mx - 1:
        return mx - diff - 1
    if 2 * ref < mx:
        if diff <= 2 * ref:
            return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
        return diff
    if diff <= 2 * (mx - ref - 1):
        return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
    return mx - (diff + 1)
