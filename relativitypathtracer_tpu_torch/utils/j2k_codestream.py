"""The JPEG 2000 codestream (ITU-T T.800 Annex A and B) as OpenJPEG 2.5.4
reads it (j2k.c, tcd.c, pi.c, t2.c): markers, the tiles' geometry, and
tier 2 (packet headers, tag trees, the progression orders), leaving each
code-block's codeword segments for tier 1 (utils/j2k_tier1).

Markers read: SIZ, COD, COC, QCD, QCC, RGN, POC, PPM and PPT (packet
headers kept apart from the packets' bodies), SOT, SOD and EOC; PLT and
PLM checked and dropped; TLM, COM, CRG and CAP skipped. A tile-part's
COD, COC, QCD, QCC, RGN and POC override the main header's, a COC or QCC
over a COD or QCD of the same header. Psot 0 runs to the end. OpenJPEG's
checks are kept where it fails: a marker outside the headers it may hold
(`_PLACES`), an unknown marker in a tile-part header, an unknown one in
the main header followed by no marker it knows (it scans two bytes at a
time), Scod bits past EPH, an MCT byte over 1, a mixed-HT style, QCD and
QCC lengths, tile-part indices and counts, more than 65,535 tiles, a
PLT or PLM length cut short, PPM runs (Nppm never split between
markers). A stream that ends without EOC, or inside a tile-part, fails,
as it fails in PIL, which decodes tile by tile and then asks for the next
tile's header. Tiles are decoded in OpenJPEG's order: each when its last
tile-part (by TNsot) is read, the rest at EOC in index order (PPM's
headers are consumed in that order).

Tier 2: SOP before a packet is skipped where COD allows it (OpenJPEG only
warns when it is missing), EPH after its header is required where COD
asks for it (OpenJPEG fails without it); tag trees for inclusion and zero
bit-planes; the pass count and Lblock codes; segments by the code-block
style (TERMALL: one pass each; BYPASS: ten, then two and one in turn;
else one of up to 109 passes). Packets come in the order of pi.c's five
progressions (LRCP, RLCP, RPCL, PCRL, CPRL), each POC entry in turn with
the packets an earlier one gave left out (an entry of an unknown order,
or whose first component is past the last, gives none; COD's unknown
order fails where no POC replaces it). A component is output at the
highest resolution a packet of it reached (OpenJPEG's resno_decoded).

Refused by name: HTJ2K code-blocks (Part 15: code-block style bit 6;
Rsiz's bit 14 and the CAP marker alone change nothing in OpenJPEG's
decode) and Part 2's markers (MCT, MCC, MCO, CBD, ATK, DCO, ...). Like
OpenJPEG (in its strict mode, PIL's) the decoder fails on a tile whose
tile-parts hold no data and on a packet whose data runs past its tile's
end; a packet header past the end reads zeros (an empty packet).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .j2k_tier1 import BYPASS, TERMALL


class CodestreamError(ValueError):
    pass


SOC, SOT, SOD, EOC, SIZ = 0xFF4F, 0xFF90, 0xFF93, 0xFFD9, 0xFF51
COD, COC, QCD, QCC, RGN, POC = 0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F
PPM, PPT = 0xFF60, 0xFF61
_PART2 = {0xFF74: "MCT", 0xFF75: "MCC", 0xFF77: "MCO", 0xFF78: "CBD", 0xFF79: "ATK",
          0xFF70: "DCO", 0xFF72: "NLT", 0xFF76: "VMS"}
# the markers OpenJPEG knows and the headers it takes them in (M main, T
# tile-part); elsewhere it fails ("not compliant with its position")
_PLACES = {COD: "MT", COC: "MT", QCD: "MT", QCC: "MT", RGN: "MT", POC: "MT", 0xFF64: "MT",
           0xFF55: "M", 0xFF57: "M", PPM: "M", 0xFF63: "M", 0xFF50: "M", 0xFF59: "M",
           0xFF78: "M", 0xFF74: "MT", 0xFF75: "MT", 0xFF77: "MT", 0xFF58: "T", PPT: "T",
           0xFF91: "", SIZ: "", SOT: "M"}


def ceildiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass
class Coding:
    """One component's COD/COC values."""
    nres: int = 1
    cbw: int = 6  # code-block width exponent
    cbh: int = 6
    style: int = 0
    qmfbid: int = 1  # 1: reversible 5/3; 0: irreversible 9/7
    precincts: tuple = ()  # (ppx, ppy) a resolution; () for 15, 15


@dataclass
class Quant:
    """One component's QCD/QCC values: style (0 none, 1 derived, 2
    expounded), guard bits and (exponent, mantissa) a band."""
    style: int = 0
    guard: int = 2
    steps: tuple = ()

    def step(self, index: int) -> tuple:
        if self.style == 1:
            expn, mant = self.steps[0]
            return max(expn - (index - 1) // 3, 0) if index else expn, mant
        # OpenJPEG leaves the step sizes a short QCD/QCC lacks at 0
        return self.steps[index] if index < len(self.steps) else (0, 0)


@dataclass
class TileParams:
    """COD's tile-wide values and the per-component Coding, Quant and ROI
    shift, as the main header gives them and a tile's headers override."""
    sop: bool = False
    eph: bool = False
    progression: int = 0
    layers: int = 1
    mct: int = 0
    coding: list = field(default_factory=list)
    quant: list = field(default_factory=list)
    roi: list = field(default_factory=list)
    pocs: list = field(default_factory=list)
    # which header level set each component's coding/quant: 0 COD/QCD, 1 COC/QCC
    coding_level: list = field(default_factory=list)
    quant_level: list = field(default_factory=list)
    cod_seen: bool = False
    qcd_seen: bool = False

    def copy(self) -> "TileParams":
        return TileParams(self.sop, self.eph, self.progression, self.layers, self.mct,
                          list(self.coding), list(self.quant), list(self.roi), list(self.pocs),
                          [0] * len(self.coding), [0] * len(self.quant))


@dataclass
class Component:
    prec: int
    sgnd: bool
    dx: int
    dy: int


@dataclass
class Header:
    rsiz: int
    xsiz: int
    ysiz: int
    xosiz: int
    yosiz: int
    xtsiz: int
    ytsiz: int
    xtosiz: int
    ytosiz: int
    comps: list
    params: TileParams
    tiles: dict  # tile index -> (TileParams, [tile-part data bytes], [PPT bytes])
    order: list = field(default_factory=list)  # the order OpenJPEG decodes the tiles in
    ppm: bytes = b""
    ppm_pos: int = 0

    @property
    def ntx(self) -> int:
        return ceildiv(self.xsiz - self.xtosiz, self.xtsiz)

    @property
    def nty(self) -> int:
        return ceildiv(self.ysiz - self.ytosiz, self.ytsiz)

    def tile_rect(self, t: int) -> tuple:
        p, q = t % self.ntx, t // self.ntx
        return (max(self.xtosiz + p * self.xtsiz, self.xosiz),
                max(self.ytosiz + q * self.ytsiz, self.yosiz),
                min(self.xtosiz + (p + 1) * self.xtsiz, self.xsiz),
                min(self.ytosiz + (q + 1) * self.ytsiz, self.ysiz))


def _u16(d: bytes, p: int) -> int:
    return (d[p] << 8) | d[p + 1]


def _read_spcod(seg: bytes, pos: int, with_precincts: bool) -> Coding:
    if len(seg) < pos + 5:
        raise CodestreamError("COD/COC: too short")
    nl, xcb, ycb, style, qmf = seg[pos:pos + 5]
    if nl > 32:
        raise CodestreamError(f"COD/COC: {nl} decomposition levels (at most 32)")
    if style & 0x80:
        raise CodestreamError("COD/COC: mixed HT code-block style (OpenJPEG refuses it)")
    xcb, ycb = xcb + 2, ycb + 2
    if xcb > 10 or ycb > 10 or xcb + ycb > 12:
        raise CodestreamError(f"COD/COC: code-blocks of 2^{xcb} x 2^{ycb}")
    if qmf > 1:
        raise CodestreamError(f"COD/COC: wavelet {qmf} (Part 2's arbitrary kernels)")
    if style & 64:
        raise CodestreamError("HTJ2K code-blocks (Part 15, COD/COC style bit 6) are not "
                              "decoded")
    precincts = ()
    if with_precincts:
        raw = seg[pos + 5:pos + 6 + nl]
        if len(raw) < nl + 1:
            raise CodestreamError("COD/COC: precinct sizes missing")
        precincts = tuple((b & 15, b >> 4) for b in raw)
        if any((px == 0 or py == 0) for px, py in precincts[1:]):
            raise CodestreamError("COD/COC: a precinct size of 1 above resolution 0")
    return Coding(nl + 1, xcb, ycb, style, qmf, precincts)


def _read_quant(seg: bytes, pos: int) -> Quant:
    if len(seg) <= pos:
        raise CodestreamError("QCD/QCC: too short")
    sq = seg[pos]
    style, guard = sq & 31, sq >> 5
    body = seg[pos + 1:]
    if style == 0:
        steps = tuple((b >> 3, 0) for b in body)
    else:  # OpenJPEG reads every other style as 16-bit (exponent, mantissa) pairs
        if len(body) < 2 or (len(body) != 2 if style == 1 else len(body) % 2):
            raise CodestreamError(f"QCD/QCC: {len(body)} bytes of step sizes at style {style}")
        words = [_u16(body, i) for i in range(0, len(body) - 1, 2)]
        steps = tuple((w >> 11, w & 0x7FF) for w in (words[:1] if style == 1 else words))
    if not steps:
        raise CodestreamError("QCD/QCC: no step sizes")
    return Quant(style, guard, steps)


def _component_index(seg: bytes, ncomp: int) -> tuple:
    if ncomp < 257:
        return seg[0], 1
    return _u16(seg, 0), 2


def _apply_marker(marker: int, seg: bytes, tp: TileParams, ncomp: int) -> None:
    """Reads a COD, COC, QCD, QCC, RGN or POC segment (its bytes after
    the length) into tp."""
    if marker == COD:
        if len(seg) < 5:
            raise CodestreamError("COD: too short")
        scod = seg[0]
        if scod & ~7:
            raise CodestreamError(f"COD: unknown Scod {scod:#04x}")
        tp.sop, tp.eph = bool(scod & 2), bool(scod & 4)
        tp.progression, tp.layers, tp.mct = seg[1], _u16(seg, 2), seg[4]
        if tp.mct > 1:
            raise CodestreamError(f"COD: multiple component transformation {tp.mct}")
        if tp.layers == 0:
            raise CodestreamError("COD: no quality layers")
        coding = _read_spcod(seg, 5, bool(scod & 1))
        for c in range(ncomp):
            if tp.coding_level[c] == 0:
                tp.coding[c] = coding
        tp.cod_seen = True
    elif marker == COC:
        c, n = _component_index(seg, ncomp)
        if c >= ncomp:
            raise CodestreamError(f"COC: component {c} of {ncomp}")
        if len(seg) < n + 1:
            raise CodestreamError("COC: too short")
        tp.coding[c] = _read_spcod(seg, n + 1, bool(seg[n] & 1))
        tp.coding_level[c] = 1
    elif marker == QCD:
        q = _read_quant(seg, 0)
        for c in range(ncomp):
            if tp.quant_level[c] == 0:
                tp.quant[c] = q
        tp.qcd_seen = True
    elif marker == QCC:
        c, n = _component_index(seg, ncomp)
        if c >= ncomp:
            raise CodestreamError(f"QCC: component {c} of {ncomp}")
        tp.quant[c] = _read_quant(seg, n)
        tp.quant_level[c] = 1
    elif marker == RGN:
        c, n = _component_index(seg, ncomp)
        if c >= ncomp or len(seg) < n + 2:
            raise CodestreamError("RGN: bad segment")
        if seg[n] != 0:
            raise CodestreamError(f"RGN: ROI style {seg[n]}")
        tp.roi[c] = seg[n + 1]
    elif marker == POC:
        width = 7 if ncomp < 257 else 9
        if len(seg) < width or len(seg) % width:
            raise CodestreamError("POC: bad length")
        pocs = []
        for i in range(0, len(seg), width):
            e = seg[i:i + width]
            if width == 7:
                rs, cs, ly, re_, ce, pr = e[0], e[1], _u16(e, 2), e[4], e[5], e[6]
            else:
                rs, cs, ly, re_, ce, pr = e[0], _u16(e, 1), _u16(e, 3), e[5], _u16(e, 6), e[8]
            pocs.append((rs, cs, ly, re_, min(ce or (256 if width == 7 else 16384), ncomp), pr))
        tp.pocs = pocs


def _check_lengths(seg: bytes, plm: bool) -> None:
    """PLT's (or PLM's, in Nplm-counted runs) packet lengths, 7 bits a byte
    with the top bit for more: the segment must end on a whole length."""
    if not seg:
        raise CodestreamError("PLT/PLM: too short")
    runs, p = [], 1
    while plm and p < len(seg):
        n = seg[p]
        if p + 1 + n > len(seg):
            raise CodestreamError("PLM: a run past the segment's end")
        runs.append(seg[p + 1:p + 1 + n])
        p += 1 + n
    for run in runs if plm else [seg[1:]]:
        if run and run[-1] & 0x80:
            raise CodestreamError("PLT/PLM: a packet length cut short")


def _skip_unknown(data: bytes, pos: int) -> int:
    """The position of the next marker OpenJPEG knows after the unknown one
    at pos: it reads two bytes at a time, not the segment's length, and
    fails on a known marker the main header may not hold."""
    while True:
        pos += 2
        if pos + 2 > len(data):
            raise CodestreamError("an unknown marker and no known one after it")
        value = _u16(data, pos)
        if value >= 0xFF00 and value in _PLACES:
            if "M" not in _PLACES[value]:
                raise CodestreamError(f"marker {value:#06x} in the main header")
            return pos


def parse(data: bytes) -> Header:
    """The codestream's headers and each tile's tile-part data."""
    data = bytes(data)
    if _u16(data, 0) != SOC if len(data) >= 2 else True:
        raise CodestreamError("no SOC marker")
    if len(data) < 4 or _u16(data, 2) != SIZ:
        raise CodestreamError("no SIZ marker after SOC")
    lsiz = _u16(data, 4) if len(data) >= 6 else 0
    siz = data[6:4 + lsiz]
    if lsiz < 41 or len(siz) < lsiz - 2:
        raise CodestreamError("truncated SIZ")
    rsiz, xsiz, ysiz, xosiz, yosiz, xtsiz, ytsiz, xtosiz, ytosiz, csiz = struct.unpack(
        ">H8IH", siz[:36])
    if csiz == 0 or csiz > 16384 or lsiz != 38 + 3 * csiz:
        raise CodestreamError(f"SIZ: {csiz} components in a segment of {lsiz} bytes")
    if xsiz <= xosiz or ysiz <= yosiz or not xtsiz or not ytsiz:
        raise CodestreamError("SIZ: an empty image or tile")
    if xtosiz > xosiz or ytosiz > yosiz or xtosiz + xtsiz <= xosiz or ytosiz + ytsiz <= yosiz:
        raise CodestreamError("SIZ: the first tile does not cover the image's origin")
    comps = []
    for i in range(csiz):
        s, dx, dy = siz[36 + 3 * i:39 + 3 * i]
        prec = (s & 0x7F) + 1
        if prec > 31:
            raise CodestreamError(f"SIZ: a component of {prec} bits (OpenJPEG's limit is 31)")
        if not dx or not dy:
            raise CodestreamError("SIZ: a subsampling factor of 0")
        comps.append(Component(prec, bool(s & 0x80), dx, dy))
    params = TileParams(coding=[Coding()] * csiz, quant=[Quant()] * csiz, roi=[0] * csiz,
                        coding_level=[0] * csiz, quant_level=[0] * csiz)
    header = Header(rsiz, xsiz, ysiz, xosiz, yosiz, xtsiz, ytsiz, xtosiz, ytosiz, comps, params,
                    {})
    ntiles = header.ntx * header.nty
    if ntiles > 65535:
        raise CodestreamError(f"SIZ: {ntiles} tiles (at most 65535)")
    pos = 4 + lsiz
    ppm, parts_seen, parts_said = {}, {}, {}
    current = None  # the tile of the tile-part being read
    main = True  # in the main header; after it, only SOT or EOC between tile-parts
    while True:
        if pos + 2 > len(data):  # PIL's tile-by-tile decode fails there
            raise CodestreamError("the codestream ends without EOC (a truncated file)")
        marker = _u16(data, pos)
        if marker == EOC:
            break
        if not main and current is None and marker != SOT:
            raise CodestreamError(f"marker {marker:#06x} where a tile-part or EOC was expected")
        if marker == SOD and current is not None:
            tile, end = current
            header.tiles[tile][1].append(data[pos + 2:end])
            if parts_seen[tile] == parts_said[tile]:  # its last tile-part: OpenJPEG decodes it
                header.order.append(tile)
            pos, current = end, None
            continue
        if marker < 0xFF00 or pos + 4 > len(data):
            raise CodestreamError(f"expected a marker at byte {pos}, found {marker:#06x}")
        if marker not in _PLACES:
            if current is not None:  # OpenJPEG has no handler for it there
                raise CodestreamError(f"unknown marker {marker:#06x} in a tile-part header")
            pos = _skip_unknown(data, pos)  # OpenJPEG's scan for a marker it knows
            continue
        if ("M" if current is None else "T") not in _PLACES[marker]:
            raise CodestreamError(f"marker {marker:#06x} in the "
                                  f"{'main' if current is None else 'tile-part'} header")
        length = _u16(data, pos + 2)
        seg = data[pos + 4:pos + 2 + length]
        if length < 2 or len(seg) < length - 2:
            raise CodestreamError(f"truncated marker segment {marker:#06x}")
        if marker in _PART2:
            raise CodestreamError(f"Part 2's {_PART2[marker]} marker is not decoded")
        if marker == SOT:
            if length != 10:
                raise CodestreamError("SOT: bad length")
            isot, psot, tpsot, tnsot = struct.unpack(">HIBB", seg)
            if isot >= ntiles:
                raise CodestreamError(f"SOT: tile {isot} of {ntiles}")
            end = len(data) if psot == 0 else pos + psot
            if psot and psot < 14:
                raise CodestreamError("SOT: Psot shorter than the header")
            if end > len(data):
                raise CodestreamError(f"tile-part of tile {isot} runs past the end (a truncated "
                                      "file)")
            if psot == 0 and data[-2:] == b"\xff\xd9":
                end = len(data) - 2
            if tpsot != parts_seen.get(isot, 0):
                raise CodestreamError(f"tile {isot}: tile-part {tpsot} where "
                                      f"{parts_seen.get(isot, 0)} was expected")
            said = parts_said.get(isot, 0)
            if (said and tpsot >= said) or (tnsot and tpsot >= tnsot):
                raise CodestreamError(f"tile {isot}: tile-part {tpsot} of {tnsot or said}")
            parts_seen[isot], parts_said[isot] = tpsot + 1, tnsot or said
            if isot not in header.tiles:
                if not header.params.cod_seen or not header.params.qcd_seen:
                    raise CodestreamError("no COD or QCD in the main header")
                header.tiles[isot] = (header.params.copy(), [], [])
            current, main = (isot, end), False
            pos += 2 + length
            continue
        if marker in (COD, COC, QCD, QCC, RGN, POC):
            if current is None:
                tp = header.params
            else:
                tp = header.tiles[current[0]][0]
            _apply_marker(marker, seg, tp, csiz)
        elif marker == PPM:
            if not seg or seg[0] in ppm:
                raise CodestreamError("PPM: too short, or its Zppm read already")
            ppm[seg[0]] = seg[1:]
        elif marker == PPT:
            if not seg or seg[0] in (z for z, _ in header.tiles[current[0]][2]):
                raise CodestreamError("PPT: too short, or its Zppt read already")
            header.tiles[current[0]][2].append((seg[0], seg[1:]))
        elif marker in (0xFF58, 0xFF57):  # PLT, PLM: lengths OpenJPEG checks, then drops
            _check_lengths(seg, marker == 0xFF57)
        pos += 2 + length
    if ppm:  # opj_j2k_merge_ppm: runs of Nppm bytes, Nppm never split between markers
        out, left = [], 0
        for z in sorted(ppm):
            body = ppm[z]
            out.append(body[:left])
            body, left = body[left:], max(0, left - len(body))
            while body:
                if len(body) < 4:
                    raise CodestreamError("PPM: not enough bytes to read Nppm")
                n = int.from_bytes(body[:4], "big")
                out.append(body[4:4 + n])
                left = max(0, n - (len(body) - 4))
                body = body[4 + n:]
        if left:
            raise CodestreamError("corrupted PPM markers")
        header.ppm = b"".join(out)
    if not header.tiles:
        raise CodestreamError("no tile-parts")
    # at EOC the tiles still open, in index order
    header.order += sorted(t for t in header.tiles if t not in header.order)
    return header


# ---------------------------------------------------------------------------
# tile geometry (tcd.c opj_tcd_init_tile)

@dataclass
class Block:
    x0: int
    y0: int
    x1: int
    y1: int
    segs: list = field(default_factory=list)  # [maxpasses, passes, [chunks]]
    numbps: int = 0
    lenbits: int = 3
    included: bool = False


@dataclass
class Band:
    index: int  # 0 LL, 1 HL, 2 LH, 3 HH
    x0: int
    y0: int
    x1: int
    y1: int
    numbps: int
    step: tuple  # (exponent, mantissa)
    precincts: list  # per precinct: (cw, ch, [Block], inclusion tree, imsb tree)

    @property
    def empty(self) -> bool:
        return self.x1 <= self.x0 or self.y1 <= self.y0


@dataclass
class Resolution:
    x0: int
    y0: int
    x1: int
    y1: int
    pdx: int
    pdy: int
    pw: int
    ph: int
    bands: list


class TagTree:
    """opj_tgt: a quad tree of (value, low), values read bit by bit up to
    a threshold."""

    def __init__(self, w: int, h: int):
        levels, n = [], 0
        while True:
            levels.append((n, w, h))
            n += w * h
            if w * h <= 1:
                break
            w, h = (w + 1) // 2, (h + 1) // 2
        self.parent = [-1] * n
        for (start, lw, lh), (nxt, nw, _) in zip(levels, levels[1:]):
            for j in range(lh):
                for i in range(lw):
                    self.parent[start + j * lw + i] = nxt + (j >> 1) * nw + (i >> 1)
        self.value = [999] * n
        self.low = [0] * n

    def decode(self, bits, leaf: int, threshold: int) -> bool:
        stack, node = [], leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bits.read(1):
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()
        return self.value[node] < threshold


def resolutions(header: Header, c: int, rect: tuple, tp: TileParams) -> list:
    """The component c's resolutions in tile rect: each band with its
    precincts and code-blocks."""
    comp, coding, quant = header.comps[c], tp.coding[c], tp.quant[c]
    tcx0, tcy0 = ceildiv(rect[0], comp.dx), ceildiv(rect[1], comp.dy)
    tcx1, tcy1 = ceildiv(rect[2], comp.dx), ceildiv(rect[3], comp.dy)
    out = []
    for r in range(coding.nres):
        level = coding.nres - 1 - r
        rx0, ry0 = ceildiv(tcx0, 1 << level), ceildiv(tcy0, 1 << level)
        rx1, ry1 = ceildiv(tcx1, 1 << level), ceildiv(tcy1, 1 << level)
        pdx, pdy = coding.precincts[r] if coding.precincts else (15, 15)
        px0, py0 = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
        px1, py1 = ceildiv(rx1, 1 << pdx) << pdx, ceildiv(ry1, 1 << pdy) << pdy
        pw = 0 if rx0 == rx1 else (px1 - px0) >> pdx
        ph = 0 if ry0 == ry1 else (py1 - py0) >> pdy
        if r == 0:
            gx, gy, gw, gh = px0, py0, pdx, pdy
        else:
            gx, gy, gw, gh = ceildiv(px0, 2), ceildiv(py0, 2), pdx - 1, pdy - 1
        cbw, cbh = min(coding.cbw, gw), min(coding.cbh, gh)
        bands = []
        for b in ((0,) if r == 0 else (1, 2, 3)):
            if r == 0:
                bx0, by0 = ceildiv(tcx0, 1 << level), ceildiv(tcy0, 1 << level)
                bx1, by1 = ceildiv(tcx1, 1 << level), ceildiv(tcy1, 1 << level)
                index = 0
            else:
                xb, yb = b & 1, b >> 1
                bx0 = ceildiv(tcx0 - (xb << level), 1 << (level + 1))
                by0 = ceildiv(tcy0 - (yb << level), 1 << (level + 1))
                bx1 = ceildiv(tcx1 - (xb << level), 1 << (level + 1))
                by1 = ceildiv(tcy1 - (yb << level), 1 << (level + 1))
                index = 3 * (r - 1) + b
            step = quant.step(index)
            band = Band(b, bx0, by0, bx1, by1, step[0] + quant.guard - 1, step, [])
            for prec in range(pw * ph):
                cx0 = gx + (prec % pw) * (1 << gw)
                cy0 = gy + (prec // pw) * (1 << gh)
                x0, y0 = max(cx0, bx0), max(cy0, by0)
                x1, y1 = min(cx0 + (1 << gw), bx1), min(cy0 + (1 << gh), by1)
                bxs, bys = (x0 >> cbw) << cbw, (y0 >> cbh) << cbh
                cw = max(0, (ceildiv(x1, 1 << cbw) << cbw) - bxs) >> cbw
                ch = max(0, (ceildiv(y1, 1 << cbh) << cbh) - bys) >> cbh
                if x1 <= x0 or y1 <= y0:
                    cw = ch = 0
                blocks = []
                for j in range(ch):
                    for i in range(cw):
                        kx, ky = bxs + (i << cbw), bys + (j << cbh)
                        blocks.append(Block(max(kx, x0), max(ky, y0), min(kx + (1 << cbw), x1),
                                            min(ky + (1 << cbh), y1)))
                trees = (TagTree(cw, ch), TagTree(cw, ch)) if cw * ch else (None, None)
                band.precincts.append((cw, ch, blocks) + trees)
            bands.append(band)
        out.append(Resolution(rx0, ry0, rx1, ry1, pdx, pdy, pw, ph, bands))
    return out


# ---------------------------------------------------------------------------
# packet order (pi.c)

def packet_order(header: Header, rect: tuple, tp: TileParams, res: list):
    """Yields (layer, resolution, component, precinct) in the tile's
    progression, each POC entry in turn (layers from 0, packets given
    before left out)."""
    ncomp = len(header.comps)
    maxres = max(len(r) for r in res)
    if tp.pocs:
        entries = [(rs, cs, min(ly, tp.layers), re_, ce, pr) for rs, cs, ly, re_, ce, pr
                   in tp.pocs]
    elif tp.progression > 4:  # j2k.c marks it unknown; t2.c then fails
        raise CodestreamError(f"COD: progression order {tp.progression}")
    else:
        entries = [(0, 0, tp.layers, maxres, ncomp, tp.progression)]
    done = set()
    for rs, cs, ly, re_, ce, pr in entries:
        for key in _progression(header, rect, res, pr, rs, cs, ly, re_, ce):
            if key not in done:
                done.add(key)
                yield key


def _progression(header, rect, res, pr, r0, c0, l1, r1, c1):
    """One progression's packets; an order past CPRL, or a first component
    past the last, gives none (pi.c's checks)."""
    comps = header.comps
    if c0 >= len(comps):
        return
    tx0, ty0, tx1, ty1 = rect
    if pr == 0:  # LRCP
        for lay in range(l1):
            for r in range(r0, r1):
                for c in range(c0, c1):
                    if r < len(res[c]):
                        for p in range(res[c][r].pw * res[c][r].ph):
                            yield lay, r, c, p
        return
    if pr == 1:  # RLCP
        for r in range(r0, r1):
            for lay in range(l1):
                for c in range(c0, c1):
                    if r < len(res[c]):
                        for p in range(res[c][r].pw * res[c][r].ph):
                            yield lay, r, c, p
        return

    def steps(cs):
        dx = dy = 0
        for c in cs:
            n = len(res[c])
            for r in range(n):
                e = res[c][r].pdx + n - 1 - r
                if e < 32:
                    v = comps[c].dx << e
                    dx = v if not dx else min(dx, v)
                e = res[c][r].pdy + n - 1 - r
                if e < 32:
                    v = comps[c].dy << e
                    dy = v if not dy else min(dy, v)
        return dx, dy

    def precinct(c, r, x, y):
        """The precinct index of (x, y) in component c's resolution r, or
        None where pi.c moves on."""
        comp, rr = comps[c], res[c][r]
        level = len(res[c]) - 1 - r
        trx0, try0 = ceildiv(tx0, comp.dx << level), ceildiv(ty0, comp.dy << level)
        trx1, try1 = ceildiv(tx1, comp.dx << level), ceildiv(ty1, comp.dy << level)
        rpx, rpy = rr.pdx + level, rr.pdy + level
        if not (y % (comp.dy << rpy) == 0 or (y == ty0 and (try0 << level) % (1 << rpy))):
            return None
        if not (x % (comp.dx << rpx) == 0 or (x == tx0 and (trx0 << level) % (1 << rpx))):
            return None
        if rr.pw == 0 or rr.ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        prci = (ceildiv(x, comp.dx << level) >> rr.pdx) - (trx0 >> rr.pdx)
        prcj = (ceildiv(y, comp.dy << level) >> rr.pdy) - (try0 >> rr.pdy)
        return prci + prcj * rr.pw

    def positions(dx, dy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += dx - x % dx
            y += dy - y % dy

    if pr == 2:  # RPCL
        dx, dy = steps(range(len(comps)))
        for r in range(r0, r1):
            for x, y in positions(dx, dy):
                for c in range(c0, c1):
                    if r < len(res[c]):
                        p = precinct(c, r, x, y)
                        if p is not None:
                            for lay in range(l1):
                                yield lay, r, c, p
    elif pr == 3:  # PCRL
        dx, dy = steps(range(len(comps)))
        for x, y in positions(dx, dy):
            for c in range(c0, c1):
                for r in range(r0, min(r1, len(res[c]))):
                    p = precinct(c, r, x, y)
                    if p is not None:
                        for lay in range(l1):
                            yield lay, r, c, p
    elif pr == 4:  # CPRL
        for c in range(c0, c1):
            dx, dy = steps((c,))
            for x, y in positions(dx, dy):
                for r in range(r0, min(r1, len(res[c]))):
                    p = precinct(c, r, x, y)
                    if p is not None:
                        for lay in range(l1):
                            yield lay, r, c, p


# ---------------------------------------------------------------------------
# tier 2 (t2.c)

class Bits:
    """opj_bio: bits most significant first, a byte after 0xFF giving 7;
    zeros past the end."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end
        self.buf = self.ct = 0
        self.start = pos

    def _bytein(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.pos < self.end:
            self.buf |= self.data[self.pos]
            self.pos += 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            if self.ct == 0:
                self._bytein()
            self.ct -= 1
            v = (v << 1) | ((self.buf >> self.ct) & 1)
        return v

    def align(self) -> int:
        """opj_bio_inalign, then the bytes read."""
        if self.buf & 0xFF == 0xFF:
            self._bytein()
        self.ct = 0
        return self.pos


def _numpasses(bits: Bits) -> int:
    if not bits.read(1):
        return 1
    if not bits.read(1):
        return 2
    n = bits.read(2)
    if n != 3:
        return 3 + n
    n = bits.read(5)
    if n != 31:
        return 6 + n
    return 37 + bits.read(7)


def _new_segment(block: Block, style: int) -> list:
    if style & TERMALL:
        most = 1
    elif style & BYPASS:
        if not block.segs:
            most = 10
        else:
            most = 2 if block.segs[-1][0] in (1, 10) else 1
    else:
        most = 109
    seg = [most, 0, []]
    block.segs.append(seg)
    return seg


def read_packets(header: Header, tile: int, res: list) -> dict:
    """Reads the tile's packets into its code-blocks' segments; returns
    each component's highest resolution with a packet (OpenJPEG's
    resno_decoded: it synthesises and outputs no further)."""
    tp, parts, ppt = header.tiles[tile]
    data = b"".join(parts)
    rect = header.tile_rect(tile)
    if header.ppm:
        hdata, hpos = header.ppm, header.ppm_pos
    elif ppt:
        hdata, hpos = b"".join(d for _, d in sorted(ppt, key=lambda e: e[0])), 0
    else:
        hdata = hpos = None
    if not data:
        raise CodestreamError(f"tile {tile}: tile-parts without data (OpenJPEG fails)")
    pos, decoded = 0, {}
    for lay, r, c, p in packet_order(header, rect, tp, res):
        decoded[c] = max(decoded.get(c, 0), r)
        coding = tp.coding[c]
        if tp.sop and data[pos:pos + 2] == b"\xff\x91" and len(data) - pos >= 6:
            pos += 6
        if hdata is None:
            bits = Bits(data, pos, len(data))
        else:
            bits = Bits(hdata, hpos, len(hdata))
        rr = res[c][r]
        included = []
        if bits.read(1):
            for band in rr.bands:
                if band.empty:
                    continue
                cw, ch, blocks, incl, imsb = band.precincts[p]
                for k, block in enumerate(blocks):
                    if not block.segs:
                        if not incl.decode(bits, k, lay + 1):
                            continue
                        i = 0
                        while not imsb.decode(bits, k, i):
                            i += 1
                        block.numbps = band.numbps + 1 - i
                        block.lenbits = 3
                        seg = _new_segment(block, coding.style)
                    else:
                        if not bits.read(1):
                            continue
                        seg = block.segs[-1]
                        if seg[1] == seg[0]:
                            seg = _new_segment(block, coding.style)
                    n = _numpasses(bits)
                    while bits.read(1):
                        block.lenbits += 1
                    lengths = []
                    while True:
                        take = min(seg[0] - seg[1], n)
                        nbits = block.lenbits + (take.bit_length() - 1)
                        if nbits > 32:
                            raise CodestreamError("a code-block length of more than 32 bits")
                        lengths.append((seg, take, bits.read(nbits)))
                        n -= take
                        if n <= 0:
                            break
                        seg = _new_segment(block, coding.style)
                    included.append(lengths)
        end = bits.align()
        if tp.eph:  # OpenJPEG 2.5.4 fails where COD promises EPH and it is missing
            hd = data if hdata is None else hdata
            if hd[end:end + 2] != b"\xff\x92":
                raise CodestreamError("a packet header without the EPH marker COD promises")
            end += 2
        if hdata is None:
            pos = end
        else:
            hpos = end
        for lengths in included:
            for seg, take, length in lengths:
                if pos + length > len(data):
                    raise CodestreamError("a packet's data runs past its tile-part's end "
                                          "(truncated stream)")
                seg[2].append(data[pos:pos + length])
                seg[1] += take
                pos += length
    if header.ppm:
        header.ppm_pos = hpos
    return decoded
