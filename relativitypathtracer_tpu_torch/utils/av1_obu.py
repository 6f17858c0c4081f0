"""AV1 OBUs and the headers of a still picture (AV1 specification sections
5 and 6): the OBU header, the temporal delimiter, the sequence header
(reduced still-picture headers among them, timing, decoder model and
operating points, colour config), and a key frame's frame header (frame
size, superres, screen content tools and intra block copy, tile info,
quantiser and its matrix levels, segmentation, delta q and delta lf, loop
filter, CDEF (damping and strengths) and loop-restoration params (each
plane's type, the unit sizes), tx mode, reduced tx set, and the film
grain params (av1_filmgrain synthesises the grain)) with its tile groups,
in a frame OBU or a frame header OBU and tile group OBUs.

`parse_still(data)` returns the sequence header, the frame header and the
tiles' bytes. What a file turns on goes into the frame header's `tools`
(the census: av1_block adds what its blocks use); what the decoder here
does not decode raises `Unsupported` naming the tool, before any pixel.
"""

from __future__ import annotations

from types import SimpleNamespace

from . import av1_tables as T


class Unsupported(ValueError):
    """A tool the port does not decode yet (the message names it)."""


class BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos * 8

    def f(self, n: int) -> int:
        x = 0
        for _ in range(n):
            byte = self.pos >> 3
            if byte >= len(self.data):
                raise ValueError("AV1 header runs past its OBU")
            x = (x << 1) | ((self.data[byte] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return x

    def su(self, n: int) -> int:
        v = self.f(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        return v if v < m else (v << 1) - m + self.f(1)

    def uvlc(self) -> int:
        lz = 0
        while not self.f(1):
            lz += 1
            if lz >= 32:
                return (1 << 32) - 1
        return self.f(lz) + (1 << lz) - 1

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7


def leb128(data: bytes, pos: int) -> tuple:
    v = 0
    for i in range(8):
        if pos + i >= len(data):
            raise ValueError("AV1: an OBU size runs past the data")
        b = data[pos + i]
        v |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return v, pos + i + 1
    return v, pos + 8


def obus(data: bytes):
    """(type, temporal_id, spatial_id, payload) of each OBU."""
    pos = 0
    while pos < len(data):
        h = data[pos]
        if h & 0x80:
            raise ValueError("AV1: OBU forbidden bit set")
        typ, ext, has_size = (h >> 3) & 15, (h >> 2) & 1, (h >> 1) & 1
        pos += 1
        tid = sid = 0
        if ext:
            if pos >= len(data):
                raise ValueError("AV1: truncated OBU header")
            tid, sid = data[pos] >> 5, (data[pos] >> 3) & 3
            pos += 1
        if has_size:
            size, pos = leb128(data, pos)
        else:
            size = len(data) - pos
        if pos + size > len(data):
            raise ValueError("AV1: OBU runs past the data")
        yield typ, tid, sid, data[pos:pos + size]
        pos += size


OBU_SEQUENCE_HEADER, OBU_FRAME_HEADER, OBU_TILE_GROUP, OBU_FRAME = 1, 3, 4, 6
OBU_REDUNDANT_FRAME_HEADER = 7


def sequence_header(payload: bytes) -> SimpleNamespace:
    r = BitReader(payload)
    s = SimpleNamespace()
    s.profile = r.f(3)
    s.still_picture = r.f(1)
    s.reduced = r.f(1)
    if s.profile > 2 or (s.reduced and not s.still_picture):
        raise ValueError("AV1: sequence header profile or still-picture flags")
    s.decoder_model_info_present = 0
    s.equal_picture_interval = 0
    s.op_model = []
    if s.reduced:
        r.f(5)  # seq_level_idx[0]
        s.op_idc = [0]
    else:
        timing = r.f(1)
        if timing:
            r.f(32)
            r.f(32)
            s.equal_picture_interval = r.f(1)
            if s.equal_picture_interval:
                r.uvlc()
            s.decoder_model_info_present = r.f(1)
            if s.decoder_model_info_present:
                s.buffer_delay_length = r.f(5) + 1
                r.f(32)
                s.buffer_removal_time_length = r.f(5) + 1
                s.frame_presentation_time_length = r.f(5) + 1
        initial_display_delay_present = r.f(1)
        count = r.f(5) + 1
        s.op_idc = []
        for _ in range(count):
            s.op_idc.append(r.f(12))
            if s.op_idc[-1] and not (s.op_idc[-1] & 0xFF and s.op_idc[-1] & 0xF00):
                raise ValueError("AV1: operating point idc")
            level = r.f(5)
            if level > 7:
                r.f(1)
            model = 0
            if s.decoder_model_info_present:
                model = r.f(1)
                if model:
                    r.f(s.buffer_delay_length)
                    r.f(s.buffer_delay_length)
                    r.f(1)
            s.op_model.append(model)
            if initial_display_delay_present and r.f(1):
                r.f(4)
    wbits, hbits = r.f(4) + 1, r.f(4) + 1
    s.wbits, s.hbits = wbits, hbits
    s.max_width, s.max_height = r.f(wbits) + 1, r.f(hbits) + 1
    s.frame_id_numbers_present = 0 if s.reduced else r.f(1)
    if s.frame_id_numbers_present:
        s.delta_frame_id_length = r.f(4) + 2
        s.frame_id_length = r.f(3) + 1 + s.delta_frame_id_length
    s.sb128 = r.f(1)
    s.enable_filter_intra = r.f(1)
    s.enable_intra_edge_filter = r.f(1)
    s.order_hint_bits = 0
    if s.reduced:
        s.force_screen_content_tools = 2
        s.force_integer_mv = 2
    else:
        r.f(4)  # interintra compound, masked compound, warped motion, dual filter
        enable_order_hint = r.f(1)
        if enable_order_hint:
            r.f(2)  # jnt comp, ref frame mvs
        s.force_screen_content_tools = 2 if r.f(1) else r.f(1)
        if s.force_screen_content_tools > 0:
            s.force_integer_mv = 2 if r.f(1) else r.f(1)
        else:
            s.force_integer_mv = 2
        if enable_order_hint:
            s.order_hint_bits = r.f(3) + 1
    s.enable_superres = r.f(1)
    s.enable_cdef = r.f(1)
    s.enable_restoration = r.f(1)
    s.color_config_bits = [r.pos, 0]  # where color_config() starts and ends
    high_bitdepth = r.f(1)
    if s.profile == 2 and high_bitdepth:
        s.bit_depth = 12 if r.f(1) else 10
    else:
        s.bit_depth = 10 if high_bitdepth else 8
    s.mono = 0 if s.profile == 1 else r.f(1)
    s.num_planes = 1 if s.mono else 3
    s.color_description = r.f(1)
    if s.color_description:
        s.cp, s.tc, s.mc = r.f(8), r.f(8), r.f(8)
    else:
        s.cp = s.tc = s.mc = 2
    s.chroma_sample_position = 0
    if s.mono:
        s.color_range = r.f(1)
        s.ssx = s.ssy = 1
        s.separate_uv_delta_q = 0
    else:
        if s.cp == 1 and s.tc == 13 and s.mc == 0:
            s.color_range, s.ssx, s.ssy = 1, 0, 0
        else:
            s.color_range = r.f(1)
            if s.profile == 0:
                s.ssx = s.ssy = 1
            elif s.profile == 1:
                s.ssx = s.ssy = 0
            elif s.bit_depth == 12:
                s.ssx = r.f(1)
                s.ssy = r.f(1) if s.ssx else 0
            else:
                s.ssx, s.ssy = 1, 0
            if s.ssx and s.ssy:
                s.chroma_sample_position = r.f(2)
        s.separate_uv_delta_q = r.f(1)
    s.color_config_bits[1] = r.pos
    s.film_grain_params_present = r.f(1)
    if s.mc == 0 and (s.mono or s.ssx or s.ssy):
        raise ValueError("AV1: the identity matrix on subsampled chroma")
    r.f(1)  # dav1d reads the trailing one bit (not checked further)
    return s


_LR_NAMES = {T.RESTORE_WIENER: "Wiener", T.RESTORE_SGRPROJ: "self-guided",
             T.RESTORE_SWITCHABLE: "switchable"}
_SEG_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
_SEG_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
_SEG_MAX = (255, 63, 63, 63, 63, 7, 0, 0)


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def frame_header(r: BitReader, s: SimpleNamespace, tid: int, sid: int) -> SimpleNamespace:
    """uncompressed_header() of a shown key frame (intra-only frames, shown
    existing frames and inter frames raise Unsupported)."""
    fh = SimpleNamespace(tools=set())
    if s.reduced:
        frame_type, show_frame = 0, 1
    else:
        if r.f(1):
            raise Unsupported("a shown existing frame")
        frame_type = r.f(2)
        show_frame = r.f(1)
        if frame_type != 0 or not show_frame:
            raise Unsupported("a frame other than a shown key frame")
        if show_frame and s.decoder_model_info_present and not s.equal_picture_interval:
            r.f(s.frame_presentation_time_length)
    fh.disable_cdf_update = r.f(1)
    if s.force_screen_content_tools == 2:
        fh.allow_screen_content_tools = r.f(1)
    else:
        fh.allow_screen_content_tools = s.force_screen_content_tools
    if fh.allow_screen_content_tools and s.force_integer_mv == 2:
        r.f(1)  # force_integer_mv
    if s.frame_id_numbers_present:
        r.f(s.frame_id_length)
    frame_size_override = 0 if s.reduced else r.f(1)
    r.f(s.order_hint_bits)
    if s.decoder_model_info_present:
        if r.f(1):  # buffer_removal_time_present_flag
            for op, idc in enumerate(s.op_idc):
                if s.op_model[op]:
                    in_t, in_s = (idc >> tid) & 1, (idc >> (sid + 8)) & 1
                    if idc == 0 or (in_t and in_s):
                        r.f(s.buffer_removal_time_length)
    if frame_size_override:
        fh.width = r.f(s.wbits) + 1
        fh.height = r.f(s.hbits) + 1
    else:
        fh.width, fh.height = s.max_width, s.max_height
    fh.use_superres = r.f(1) if s.enable_superres else 0
    if fh.use_superres:
        raise Unsupported("superres")
    fh.mi_cols = 2 * ((fh.width + 7) >> 3)
    fh.mi_rows = 2 * ((fh.height + 7) >> 3)
    if r.f(1):  # render_and_frame_size_different
        r.f(16)
        r.f(16)
    fh.allow_intrabc = 0
    if fh.allow_screen_content_tools:
        fh.allow_intrabc = r.f(1)
    if not (s.reduced or fh.disable_cdf_update):
        r.f(1)  # disable_frame_end_update_cdf
    _tile_info(r, s, fh)
    # quantization_params
    fh.base_q_idx = r.f(8)

    def delta_q():
        return r.su(7) if r.f(1) else 0

    fh.dq_y_dc = delta_q()
    fh.dq_u_dc = fh.dq_u_ac = fh.dq_v_dc = fh.dq_v_ac = 0
    if s.num_planes > 1:
        diff_uv = r.f(1) if s.separate_uv_delta_q else 0
        fh.dq_u_dc, fh.dq_u_ac = delta_q(), delta_q()
        if diff_uv:
            fh.dq_v_dc, fh.dq_v_ac = delta_q(), delta_q()
        else:
            fh.dq_v_dc, fh.dq_v_ac = fh.dq_u_dc, fh.dq_u_ac
    fh.using_qmatrix = r.f(1)
    fh.qm_y = fh.qm_u = fh.qm_v = 15
    if fh.using_qmatrix:
        fh.tools.add("quantizer matrices")
        fh.qm_y, fh.qm_u = r.f(4), r.f(4)
        fh.qm_v = r.f(4) if s.separate_uv_delta_q else fh.qm_u
    # segmentation_params
    fh.seg_enabled = r.f(1)
    fh.seg_feature = [[None] * 8 for _ in range(8)]
    if fh.seg_enabled:
        fh.tools.add("segmentation")
        for i in range(8):
            for j in range(8):
                if r.f(1):
                    if _SEG_SIGNED[j]:
                        v = max(-_SEG_MAX[j], min(_SEG_MAX[j], r.su(1 + _SEG_BITS[j])))
                    else:
                        v = max(0, min(_SEG_MAX[j], r.f(_SEG_BITS[j])))
                    fh.seg_feature[i][j] = v
    fh.seg_id_pre_skip = 0
    fh.last_active_seg_id = 0
    for i in range(8):
        for j in range(8):
            if fh.seg_feature[i][j] is not None:
                fh.last_active_seg_id = i
                if j >= 5:
                    fh.seg_id_pre_skip = 1
    if any(fh.seg_feature[i][j] is not None for i in range(8) for j in (5, 6, 7)):
        fh.tools.add("segment reference or skip features")
    # delta_q_params, delta_lf_params
    fh.delta_q_present = r.f(1) if fh.base_q_idx > 0 else 0
    fh.delta_q_res = r.f(2) if fh.delta_q_present else 0
    fh.delta_lf_present = fh.delta_lf_res = fh.delta_lf_multi = 0
    if fh.delta_q_present:
        fh.tools.add("delta q")
        if not fh.allow_intrabc:
            fh.delta_lf_present = r.f(1)
        if fh.delta_lf_present:
            fh.tools.add("delta lf")
            fh.delta_lf_res = r.f(2)
            fh.delta_lf_multi = r.f(1)
    fh.lossless = [qindex(fh, i, None) == 0 and fh.dq_y_dc == 0 and fh.dq_u_ac == 0
                   and fh.dq_u_dc == 0 and fh.dq_v_ac == 0 and fh.dq_v_dc == 0
                   for i in range(8)]
    fh.coded_lossless = all(fh.lossless)
    if any(fh.lossless):
        fh.tools.add("lossless")
    # SegQMLevel: each segment's level for Y, U and V (15, a lossless
    # segment's, reads no matrix)
    fh.seg_qm_level = [(15, 15, 15) if fh.lossless[i] or not fh.using_qmatrix
                       else (fh.qm_y, fh.qm_u, fh.qm_v) for i in range(8)]
    if fh.using_qmatrix and not fh.coded_lossless:
        fh.tools.update(("qm level", v) for v in (fh.qm_y, fh.qm_u, fh.qm_v)[:s.num_planes])
    # loop_filter_params
    fh.lf_level = [0, 0, 0, 0]
    fh.lf_sharpness = 0
    fh.lf_ref_deltas = [1, 0, 0, 0, -1, 0, -1, -1]
    fh.lf_mode_deltas = [0, 0]
    fh.lf_delta_enabled = 0
    if not (fh.coded_lossless or fh.allow_intrabc):
        fh.lf_level[0], fh.lf_level[1] = r.f(6), r.f(6)
        if s.num_planes > 1 and (fh.lf_level[0] or fh.lf_level[1]):
            fh.lf_level[2], fh.lf_level[3] = r.f(6), r.f(6)
        fh.lf_sharpness = r.f(3)
        fh.lf_delta_enabled = r.f(1)
        if fh.lf_delta_enabled and r.f(1):
            for i in range(8):
                if r.f(1):
                    fh.lf_ref_deltas[i] = r.su(7)
            for i in range(2):
                if r.f(1):
                    fh.lf_mode_deltas[i] = r.su(7)
    if any(fh.lf_level):
        fh.tools.add("deblocking filter")
    # cdef_params (a secondary strength of 3 means 4)
    fh.cdef_damping = 3
    fh.cdef_bits = 0
    fh.cdef_strengths = []
    if not (fh.coded_lossless or fh.allow_intrabc or not s.enable_cdef):
        fh.cdef_damping = r.f(2) + 3
        fh.cdef_bits = r.f(2)
        for _ in range(1 << fh.cdef_bits):
            st = [r.f(4), r.f(2)]
            if s.num_planes > 1:
                st += [r.f(4), r.f(2)]
            fh.cdef_strengths.append([v + (v == 3) if k & 1 else v for k, v in enumerate(st)])
        fh.tools.add("CDEF syntax")
        if any(any(st) for st in fh.cdef_strengths):
            fh.tools.add("CDEF")
    fh.cdef_read = bool(s.enable_cdef and not (fh.coded_lossless or fh.allow_intrabc))
    # lr_params: each plane's FrameRestorationType, the unit sizes
    fh.lr_type = [T.RESTORE_NONE] * 3
    fh.lr_unit_size = [256, 256, 256]
    fh.lr_unit_shift = fh.lr_uv_shift = 0
    if not (fh.coded_lossless or fh.allow_intrabc or not s.enable_restoration):
        for i in range(s.num_planes):
            fh.lr_type[i] = T.REMAP_LR_TYPE[r.f(2)]
        if any(fh.lr_type):
            if s.sb128:
                shift = r.f(1) + 1
            else:
                shift = r.f(1)
                if shift:
                    shift += r.f(1)
            uv_shift = 0
            if s.ssx and s.ssy and any(fh.lr_type[1:]):
                uv_shift = r.f(1)
            fh.lr_unit_shift, fh.lr_uv_shift = shift, uv_shift
            size = 256 >> (2 - shift)
            fh.lr_unit_size = [size, size >> uv_shift, size >> uv_shift]
            for t in fh.lr_type:
                if t:
                    fh.tools.add(("loop restoration", _LR_NAMES[t]))
            if uv_shift:
                fh.tools.add("loop restoration chroma units halved")
    # read_tx_mode
    if fh.coded_lossless:
        fh.tx_mode_select = 0
    else:
        fh.tx_mode_select = r.f(1)
    fh.reduced_tx_set = r.f(1)
    if fh.reduced_tx_set:
        fh.tools.add("reduced tx set")
    fh.film_grain = None
    if s.film_grain_params_present and r.f(1):  # apply_grain
        g = fh.film_grain = _film_grain_params(r, s)
        fh.tools.update({"film grain", ("film grain ar lag", g.ar_coeff_lag)})
        flags = {"overlap": g.overlap_flag, "restricted range": g.clip_to_restricted_range,
                 "chroma scaling from luma": g.chroma_scaling_from_luma,
                 "no luma points": not g.y_points}
        fh.tools.update(("film grain", name) for name, on in flags.items() if on)
    if fh.allow_screen_content_tools:
        fh.tools.add("screen content tools")
    return fh


def _points(r: BitReader, count: int, most: int) -> list:
    """A scaling function's points (x, y), x rising (dav1d refuses more than
    `most` points or an x that does not rise)."""
    if count > most:
        raise ValueError(f"AV1: {count} film grain scaling points")
    points = []
    for _ in range(count):
        x = r.f(8)
        if points and x <= points[-1][0]:
            raise ValueError("AV1: film grain scaling points out of order")
        points.append((x, r.f(8)))
    return points


def _film_grain_params(r: BitReader, s: SimpleNamespace) -> SimpleNamespace:
    """film_grain_params() of a shown key frame after apply_grain (update_grain
    is 1); the multipliers and AR coefficients less their 128 (the offsets
    less 256), as dav1d keeps them."""
    g = SimpleNamespace()
    g.grain_seed = r.f(16)
    g.y_points = _points(r, r.f(4), 14)
    g.chroma_scaling_from_luma = 0 if s.mono else r.f(1)
    g.uv_points = [[], []]
    if not (s.mono or g.chroma_scaling_from_luma or (s.ssx and s.ssy and not g.y_points)):
        g.uv_points = [_points(r, r.f(4), 10) for _ in range(2)]
        if s.ssx and s.ssy and bool(g.uv_points[0]) != bool(g.uv_points[1]):
            raise ValueError("AV1: 4:2:0 film grain with points for one chroma plane")
    g.num_y_points = len(g.y_points)
    g.scaling_shift = r.f(2) + 8
    g.ar_coeff_lag = r.f(2)
    n = 2 * g.ar_coeff_lag * (g.ar_coeff_lag + 1)
    g.ar_coeffs_y = [r.f(8) - 128 for _ in range(n)] if g.y_points else []
    g.ar_coeffs_uv = [[], []]
    for p in range(2):
        if g.uv_points[p] or g.chroma_scaling_from_luma:
            g.ar_coeffs_uv[p] = [r.f(8) - 128 for _ in range(n + bool(g.y_points))]
    g.ar_coeff_shift = r.f(2) + 6
    g.grain_scale_shift = r.f(2)
    g.uv_mult, g.uv_luma_mult, g.uv_offset = [0, 0], [0, 0], [0, 0]
    for p in range(2):
        if g.uv_points[p]:
            g.uv_mult[p], g.uv_luma_mult[p] = r.f(8) - 128, r.f(8) - 128
            g.uv_offset[p] = r.f(9) - 256
    g.overlap_flag = r.f(1)
    g.clip_to_restricted_range = r.f(1)
    return g


def qindex(fh: SimpleNamespace, seg: int, current) -> int:
    """get_qidx(): the segment's q index, from CurrentQIndex when given."""
    base = fh.base_q_idx if current is None else current
    v = fh.seg_feature[seg][0] if fh.seg_enabled else None
    if v is not None:
        return max(0, min(255, base + v))
    return base


def _tile_info(r: BitReader, s: SimpleNamespace, fh: SimpleNamespace) -> None:
    sb_cols = (fh.mi_cols + 31) >> 5 if s.sb128 else (fh.mi_cols + 15) >> 4
    sb_rows = (fh.mi_rows + 31) >> 5 if s.sb128 else (fh.mi_rows + 15) >> 4
    sb_shift = 5 if s.sb128 else 4
    sb_size = sb_shift + 2
    max_tile_width_sb = 4096 >> sb_size
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size)
    min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_tile_cols, _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    col_starts, row_starts = [], []
    if r.f(1):  # uniform_tile_spacing_flag
        cols_log2 = min_log2_tile_cols
        while cols_log2 < max_log2_tile_cols and r.f(1):
            cols_log2 += 1
        w = (sb_cols + (1 << cols_log2) - 1) >> cols_log2
        col_starts = [x << sb_shift for x in range(0, sb_cols, w)]
        rows_log2 = max(min_log2_tiles - cols_log2, 0)
        while rows_log2 < max_log2_tile_rows and r.f(1):
            rows_log2 += 1
        h = (sb_rows + (1 << rows_log2) - 1) >> rows_log2
        row_starts = [y << sb_shift for y in range(0, sb_rows, h)]
    else:
        widest, start = 0, 0
        while start < sb_cols:
            col_starts.append(start << sb_shift)
            size = r.ns(min(sb_cols - start, max_tile_width_sb)) + 1
            widest = max(widest, size)
            start += size
        cols_log2 = _tile_log2(1, len(col_starts))
        if min_log2_tiles > 0:
            area = (sb_rows * sb_cols) >> (min_log2_tiles + 1)
        else:
            area = sb_rows * sb_cols
        max_h = max(area // widest, 1)
        start = 0
        while start < sb_rows:
            row_starts.append(start << sb_shift)
            start += r.ns(min(sb_rows - start, max_h)) + 1
        rows_log2 = _tile_log2(1, len(row_starts))
    fh.tile_cols_log2, fh.tile_rows_log2 = cols_log2, rows_log2
    fh.col_starts = col_starts + [fh.mi_cols]
    fh.row_starts = row_starts + [fh.mi_rows]
    fh.tile_size_bytes = 4
    if cols_log2 > 0 or rows_log2 > 0:
        r.f(rows_log2 + cols_log2)  # context_update_tile_id
        fh.tile_size_bytes = r.f(2) + 1
    fh.tiles = [None] * ((len(fh.col_starts) - 1) * (len(fh.row_starts) - 1))
    if len(fh.tiles) > 1:
        fh.tools.add("tiles")


def _tile_group(data: bytes, fh: SimpleNamespace) -> None:
    n = len(fh.tiles)
    r = BitReader(data)
    start, end = 0, n - 1
    if n > 1 and r.f(1):
        bits = fh.tile_cols_log2 + fh.tile_rows_log2
        start, end = r.f(bits), r.f(bits)
    r.byte_align()
    pos = r.pos >> 3
    for t in range(start, end + 1):
        if t >= n or fh.tiles[t] is not None:
            raise ValueError("AV1: tile group out of order")
        if t == end:
            size = len(data) - pos
        else:
            if pos + fh.tile_size_bytes > len(data):
                raise ValueError("AV1: truncated tile size")
            size = int.from_bytes(data[pos:pos + fh.tile_size_bytes], "little") + 1
            pos += fh.tile_size_bytes
        if size <= 0 or pos + size > len(data):
            raise ValueError("AV1: tile runs past its tile group")
        fh.tiles[t] = data[pos:pos + size]
        pos += size


def parse_still(data: bytes, seq: SimpleNamespace | None = None) -> tuple:
    """(sequence header, frame header) of the first frame of an AV1 OBU
    stream; the frame header's `tiles` hold each tile's bytes."""
    fh = None
    for typ, tid, sid, payload in obus(data):
        if typ == OBU_SEQUENCE_HEADER:
            seq = sequence_header(payload)
        elif typ in (OBU_FRAME, OBU_FRAME_HEADER):
            if fh is not None:
                if typ == OBU_FRAME_HEADER:
                    continue  # a repeated frame header
                break
            if seq is None:
                raise ValueError("AV1: a frame before any sequence header")
            r = BitReader(payload)
            fh = frame_header(r, seq, tid, sid)
            if typ == OBU_FRAME:
                r.byte_align()
                _tile_group(payload[r.pos >> 3:], fh)
        elif typ in (OBU_TILE_GROUP, OBU_REDUNDANT_FRAME_HEADER):
            if fh is None:
                raise ValueError("AV1: a tile group before any frame header")
            if typ == OBU_TILE_GROUP:
                _tile_group(payload, fh)
        if fh is not None and all(t is not None for t in fh.tiles):
            break
    if fh is None:
        raise ValueError("AV1: no frame")
    if any(t is None for t in fh.tiles):
        raise ValueError("AV1: tiles missing")
    return seq, fh
