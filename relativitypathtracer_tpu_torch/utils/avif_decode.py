"""AVIF files as PIL opens them: the HEIF container, the AV1 still picture
at 8, 10 and 12 bits, and libavif 1.3.0's conversion to 8-bit RGB through
libyuv or its own float path, byte for byte with
`Image.open(f).convert("RGB")` (Pillow 12.1.0 on libavif 1.3.0 with
dav1d 1.5.1 and libyuv 1909).

`accept(data)` is Pillow's AvifImagePlugin._accept: a file whose major
brand is avif, avis, mif1 or msf1. The container (ISO/IEC 14496-12 and
23008-12, as libavif reads a still image): ftyp and its compatible brands,
meta with hdlr 'pict', pitm, iloc versions 0-2 (construction methods 0
and 1, idat), iinf/infe versions 2 and 3, iref (auxl, prem), iprp with
ipco and ipma (the essential bit checked), the properties ispe, pixi, av1C,
colr (nclx and ICC), auxC, irot, imir, clap, and mdat. The primary item
(av01) is decoded by av1_obu and av1_block (with av1_palette and
av1_intrabc), then filtered as dav1d filters it: the deblocking filter
(av1_loopfilter), CDEF (av1_cdef), loop restoration (av1_restoration),
then given its film grain (av1_filmgrain). An alpha auxiliary item must
have the colour's bit depth; where the primary item's 'prem' reference
names it, it is decoded and filtered the same way (widened to full range
where it is coded in limited range) and the colour divided by it, else
only decoded (as libavif decodes it) and dropped, as
convert("RGB") drops it. Pillow reports irot, imir and EXIF orientation as
metadata and leaves the pixels as decoded.

Colour (`yuv_to_rgb`, whose docstring gives each route): the nclx colr
box, where there is one, before the sequence header's colour config; an
unspecified matrix (2) taken as BT.601, as libavif takes it; BT.601,
BT.709 and BT.2020 (and the chromaticity-derived matrix under their
primaries) through libyuv's 6-bit fixed point (its YuvConstants, full and
limited range), 4:2:0 and 4:2:2 chroma upsampled by libyuv's bilinear
filter; FCC, SMPTE 240M, YCgCo, the identity matrix and the
chromaticity-derived matrix under other primaries through libavif's own
float32 path. The matrices libavif cannot convert (3, 10, 11, 13, 14, YCgCo
in limited range, the identity matrix on subsampled chroma) fail as in
PIL.

What the decoder here does not decode yet raises av1_obu.Unsupported,
named in a DecodeError "AVIF: <tool> is not decoded yet": superres, a grid
item, and an image sequence (avis) without a still primary item.
"""

from __future__ import annotations

import struct
import time

import numpy as np

from .av1_block import FrameDecoder
from .av1_cdef import cdef
from .av1_filmgrain import apply_grain
from .av1_loopfilter import loop_filter
from .av1_restoration import loop_restoration
from .av1_obu import OBU_SEQUENCE_HEADER, Unsupported, obus, parse_still, sequence_header
from .image_decode import DecodeError, _check_size

_BRANDS = (b"avif", b"avis", b"mif1", b"msf1")


def accept(data: bytes) -> bool:
    """Pillow's AvifImagePlugin._accept."""
    return data[4:8] == b"ftyp" and data[8:12] in _BRANDS


class _Box:
    __slots__ = ("type", "start", "end", "body")

    def __init__(self, typ, start, end, body):
        self.type, self.start, self.end, self.body = typ, start, end, body


def _boxes(data: bytes, start: int, end: int, stop: bytes = b"") -> list:
    """The boxes from start to end; with `stop`, up to and including the
    first box of that type (libavif reads a still image's top level up to
    its meta box and no further)."""
    out = []
    pos = start
    while pos < end:
        if end - pos < 8:
            raise DecodeError("AVIF: truncated box header")
        size, typ = struct.unpack(">I4s", data[pos:pos + 8])
        hdr = 8
        if size == 1:
            if end - pos < 16:
                raise DecodeError("AVIF: truncated box header")
            size = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            raise DecodeError(f"AVIF: box '{typ.decode('latin-1')}' runs past its parent")
        if typ == b"uuid":
            hdr += 16
        out.append(_Box(typ, pos, pos + size, pos + hdr))
        pos += size
        if typ == stop:
            break
    return out


class _Reader:
    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end

    def u(self, n: int) -> int:
        if self.pos + n > self.end:
            raise DecodeError("AVIF: box too short")
        v = int.from_bytes(self.data[self.pos:self.pos + n], "big")
        self.pos += n
        return v

    def fourcc(self) -> bytes:
        if self.pos + 4 > self.end:
            raise DecodeError("AVIF: box too short")
        self.pos += 4
        return self.data[self.pos - 4:self.pos]

    def string(self) -> bytes:
        i = self.data.find(b"\0", self.pos, self.end)
        if i < 0:
            raise DecodeError("AVIF: unterminated string")
        s = self.data[self.pos:i]
        self.pos = i + 1
        return s


def _children(data: bytes, box: _Box, full: bool = False) -> dict:
    start = box.body + (4 if full else 0)
    out: dict = {}
    for b in _boxes(data, start, box.end):
        out.setdefault(b.type, []).append(b)
    return out


def _parse_meta(data: bytes, meta: _Box) -> dict:
    if meta.end - meta.body < 4 or data[meta.body] != 0:
        raise DecodeError("AVIF: meta version")
    kids = _children(data, meta, full=True)
    hdlr = kids.get(b"hdlr")
    if not hdlr:
        raise DecodeError("AVIF: meta without hdlr")
    r = _Reader(data, hdlr[0].body, hdlr[0].end)
    if r.u(1) != 0:
        raise DecodeError("AVIF: hdlr version")
    r.u(3)
    if r.u(4) != 0:
        raise DecodeError("AVIF: hdlr pre_defined is nonzero")
    if r.fourcc() != b"pict":
        raise DecodeError("AVIF: handler is not 'pict'")
    r.u(12)
    r.string()
    info: dict = {"items": {}, "props": [], "assoc": {}, "refs": [], "idat": None}
    if b"pitm" in kids:
        b = kids[b"pitm"][0]
        r = _Reader(data, b.body, b.end)
        v = r.u(1)
        r.u(3)
        info["primary"] = r.u(2 if v == 0 else 4)
    else:
        raise DecodeError("AVIF: no primary item")
    if b"idat" in kids:
        b = kids[b"idat"][0]
        info["idat"] = (b.body, b.end)
    if b"iloc" not in kids:
        raise DecodeError("AVIF: no iloc box")
    b = kids[b"iloc"][0]
    r = _Reader(data, b.body, b.end)
    v = r.u(1)
    r.u(3)
    if v > 2:
        raise DecodeError(f"AVIF: iloc version {v}")
    sizes = r.u(2)
    off_size, len_size = sizes >> 12, (sizes >> 8) & 15
    base_size, idx_size = (sizes >> 4) & 15, (sizes & 15) if v in (1, 2) else 0
    for s in (off_size, len_size, base_size):
        if s not in (0, 4, 8):
            raise DecodeError("AVIF: iloc field size")
    count = r.u(2 if v < 2 else 4)
    locs = {}
    for _ in range(count):
        item = r.u(2 if v < 2 else 4)
        method = r.u(2) & 15 if v in (1, 2) else 0
        r.u(2)  # data_reference_index
        base = r.u(base_size)
        extents = []
        for _ in range(r.u(2)):
            if idx_size:
                r.u(idx_size)
            extents.append((base + r.u(off_size), r.u(len_size)))
        locs[item] = (method, extents)
    info["locs"] = locs
    if b"iinf" not in kids:
        raise DecodeError("AVIF: no iinf box")
    b = kids[b"iinf"][0]
    r = _Reader(data, b.body, b.end)
    v = r.u(1)
    r.u(3)
    count = r.u(2 if v == 0 else 4)
    entries = _boxes(data, r.pos, b.end)
    if count > len(entries):
        raise DecodeError("AVIF: iinf counts more entries than it holds")
    for e in entries[:count]:
        if e.type != b"infe":
            raise DecodeError("AVIF: iinf entry is not infe")
        r = _Reader(data, e.body, e.end)
        v = r.u(1)
        r.u(3)
        if v not in (2, 3):
            raise DecodeError(f"AVIF: infe version {v}")
        item = r.u(2 if v == 2 else 4)
        r.u(2)
        kind = r.fourcc()
        r.string()  # item_name
        if item in info["items"]:
            raise DecodeError("AVIF: an item id twice")
        info["items"][item] = kind
    if b"iref" in kids:
        b = kids[b"iref"][0]
        r = _Reader(data, b.body, b.end)
        v = r.u(1)
        r.u(3)
        for ref in _boxes(data, r.pos, b.end):
            rr = _Reader(data, ref.body, ref.end)
            src = rr.u(2 if v == 0 else 4)
            for _ in range(rr.u(2)):
                info["refs"].append((ref.type, src, rr.u(2 if v == 0 else 4)))
    if b"iprp" in kids:
        iprp = _children(data, kids[b"iprp"][0])
        if b"ipco" in iprp:
            info["props"] = _boxes(data, iprp[b"ipco"][0].body, iprp[b"ipco"][0].end)
            for box in info["props"]:  # libavif parses every property up front
                if box.type in (b"ispe", b"pixi", b"auxC") and (
                        box.end - box.body < 4 or data[box.body] != 0):
                    raise DecodeError(f"AVIF: {box.type.decode()} version")
                if box.type == b"av1C" and (box.end - box.body < 4 or data[box.body] != 0x81):
                    raise DecodeError("AVIF: bad av1C")
        for ipma in iprp.get(b"ipma", []):
            r = _Reader(data, ipma.body, ipma.end)
            v = r.u(1)
            flags = r.u(3)
            for _ in range(r.u(4)):
                item = r.u(2 if v < 1 else 4)
                lst = info["assoc"].setdefault(item, [])
                for _ in range(r.u(1)):
                    x = r.u(2 if flags & 1 else 1)
                    bits = 15 if flags & 1 else 7
                    lst.append((x >> bits, x & ((1 << bits) - 1)))
    return info


def _item_data(data: bytes, info: dict, item: int) -> bytes:
    if item not in info["locs"]:
        raise DecodeError(f"AVIF: item {item} has no location")
    method, extents = info["locs"][item]
    out = bytearray()
    for off, length in extents:
        if method == 0:
            lo, hi = 0, len(data)
        elif method == 1:
            if info["idat"] is None:
                raise DecodeError("AVIF: construction method 1 without idat")
            lo, hi = info["idat"]
        else:
            raise Unsupported(f"iloc construction method {method}")
        s = lo + off
        e = hi if length == 0 else s + length
        if e > hi or s > hi:
            raise DecodeError("AVIF: item data past the end of the file")
        out += data[s:e]
    return bytes(out)


def _props(data: bytes, info: dict, item: int) -> dict:
    out: dict = {}
    for essential, idx in info["assoc"].get(item, []):
        if idx == 0:
            continue
        if idx > len(info["props"]):
            raise DecodeError("AVIF: property index past ipco")
        box = info["props"][idx - 1]
        out.setdefault(box.type, box)
        if essential and box.type not in (b"av1C", b"ispe", b"pixi", b"colr", b"auxC",
                                          b"irot", b"imir", b"clap", b"lsel", b"a1op"):
            raise Unsupported(f"essential property '{box.type.decode('latin-1')}'")
    return out


def _colr(data: bytes, props: dict):
    box = props.get(b"colr")
    if box is None:
        return None
    r = _Reader(data, box.body, box.end)
    if r.fourcc() != b"nclx":
        return None
    cp, tc, mc = r.u(2), r.u(2), r.u(2)
    full = r.u(1)
    if full & 0x7F:
        raise DecodeError("AVIF: nclx reserved bits set")
    return cp, tc, mc, full >> 7


_ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
               b"urn:mpeg:hevc:2015:auxid:1")


def _container(data: bytes) -> tuple:
    """What libavif's avifDecoderParse reads: the boxes, the primary item,
    its properties and its data, and an alpha item's. A DecodeError here is
    a file PIL does not identify (Pillow's plugin raises SyntaxError)."""
    top = _boxes(data, 0, len(data), stop=b"meta")
    if not top or top[0].type != b"ftyp":
        raise DecodeError("AVIF: no ftyp box")
    r = _Reader(data, top[0].body, top[0].end)
    major = r.fourcc()
    r.u(4)
    brands = {major}
    while r.pos + 4 <= r.end:
        brands.add(r.fourcc())
    if not brands & {b"avif", b"avis"}:
        raise DecodeError("AVIF: ftyp has neither avif nor avis among its brands")
    metas = [b for b in top if b.type == b"meta"]
    if not metas:
        if b"avis" in brands:
            raise Unsupported("an image sequence (avis) without a still item")
        raise DecodeError("AVIF: no meta box")
    info = _parse_meta(data, metas[0])
    primary = info["primary"]
    kind = info["items"].get(primary)
    if kind == b"grid":
        raise Unsupported("a grid item")
    if kind != b"av01":
        raise DecodeError("AVIF: primary item is not AV1")
    props = _props(data, info, primary)
    for need in (b"av1C", b"ispe"):
        if need not in props:
            raise DecodeError(f"AVIF: primary item has no {need.decode()}")
    size = _ispe(data, props)
    _colr(data, props)
    _check_depth(data, props)
    payload = _item_data(data, info, primary)
    alpha = None
    for typ, src, dst in info["refs"]:
        if typ == b"auxl" and dst == primary and info["items"].get(src) == b"av01":
            aprops = _props(data, info, src)
            aux = aprops.get(b"auxC")
            if aux is None:
                continue
            rr = _Reader(data, aux.body + 4, aux.end)
            if rr.string() not in _ALPHA_URNS:
                continue
            if b"av1C" not in aprops or b"ispe" not in aprops:
                raise DecodeError("AVIF: alpha item without av1C or ispe")
            _check_depth(data, aprops)
            if _ispe(data, aprops) != size:
                raise DecodeError("AVIF: alpha item of another size")
            prem = (b"prem", primary, src) in info["refs"]  # libavif's premByID
            alpha = (_item_data(data, info, src), prem)
    return info, props, size, payload, alpha


def _check_depth(data: bytes, props: dict) -> int:
    """libavif's parse: pixi's depths agree with av1C's bit depth (8, 10 or
    12), which it returns."""
    av1c, pixi = props[b"av1C"], props.get(b"pixi")
    flags = data[av1c.body + 2]
    depth = 12 if flags & 0x20 else 10 if flags & 0x40 else 8
    if pixi is not None:
        r = _Reader(data, pixi.body + 4, pixi.end)
        if any(r.u(1) != depth for _ in range(r.u(1))):
            raise DecodeError("AVIF: pixi disagrees with av1C's bit depth")
    return depth


def _ispe(data: bytes, props: dict) -> tuple:
    r = _Reader(data, props[b"ispe"].body + 4, props[b"ispe"].end)
    return r.u(4), r.u(4)


def identify(data: bytes) -> bool:
    """Whether PIL's Image.open takes the file as AVIF: its accept, then
    libavif's parse (on a parse failure Pillow's plugin raises SyntaxError
    and PIL moves on to its next plugin)."""
    if not accept(data):
        return False
    try:
        _container(data)
    except Unsupported:
        return True
    except DecodeError:
        return False
    return True


def parse_failure(data: bytes) -> str:
    """Why libavif's parse fails on an accepted file ("" when it does not)."""
    if not accept(data):
        return ""
    try:
        _container(data)
    except Unsupported:
        return ""
    except DecodeError as e:
        return str(e)
    return ""


def decode_avif(data: bytes, times: dict | None = None) -> np.ndarray:
    """(h, w, 3) uint8 RGB of an AVIF file's primary image; `times`, where
    given, gets each pass's seconds (tiles, deblocking filter, CDEF, loop
    restoration, film grain, YUV to RGB)."""
    try:
        return _decode(data, {} if times is None else times)
    except Unsupported as e:
        raise DecodeError(f"AVIF: {e} is not decoded yet") from e
    except (ValueError, IndexError) as e:
        if isinstance(e, DecodeError):
            raise
        raise DecodeError(f"AVIF: {e}") from e


def _picture(seq, fh, times: dict) -> list:
    """The planes dav1d hands libavif: the tiles, then the deblocking
    filter, CDEF, loop restoration and film grain."""
    dec = FrameDecoder(seq, fh)
    t0 = time.perf_counter()
    dec.decode()
    t1 = time.perf_counter()
    loop_filter(dec)
    t2 = time.perf_counter()
    filtered = cdef(dec)
    t3 = time.perf_counter()
    planes = loop_restoration(dec, dec.frame, filtered)
    t4 = time.perf_counter()
    if fh.film_grain is not None:
        planes = apply_grain(planes, fh.width, fh.height, seq, fh.film_grain)
    times.update({"tiles": t1 - t0, "deblocking filter": t2 - t1, "CDEF": t3 - t2,
                  "loop restoration": t4 - t3, "film grain": time.perf_counter() - t4})
    return planes


def _decode(data: bytes, times: dict) -> np.ndarray:
    info, props, (iw, ih), payload, alpha = _container(data)
    av1c = props[b"av1C"]
    seq = None
    if av1c.end - av1c.body > 4:
        seq = _first_seq(data[av1c.body + 4:av1c.end])
    seq, fh = parse_still(payload, seq)
    w, h = fh.width, fh.height
    if (iw, ih) != (w, h):
        raise DecodeError(f"AVIF: ispe {iw}x{ih} disagrees with the AV1 frame {w}x{h} "
                          "(PIL shows memory the file never wrote)")
    alpha_plane, prem = None, False
    if alpha is not None:
        aseq, afh = parse_still(alpha[0])
        if (afh.width, afh.height) != (iw, ih):
            raise DecodeError(f"AVIF: alpha frame {afh.width}x{afh.height} in a {iw}x{ih} "
                              "image (PIL shows memory the file never wrote)")
        if aseq.bit_depth != seq.bit_depth:
            raise DecodeError("AVIF: the alpha item's bit depth is not the colour's")
        prem = alpha[1]
        if prem:  # divided by: decoded and filtered as the colour is
            alpha_plane = _picture(aseq, afh, {})[0][:h, :w].astype(np.int64)
            if not aseq.color_range:
                alpha_plane = limited_to_full(alpha_plane, aseq.bit_depth)
        else:  # only libavif's decode; its samples are dropped with the alpha
            FrameDecoder(aseq, afh).decode()
            alpha_plane = np.zeros((h, w), np.int64)
    _check_size(w, h)
    planes = _picture(seq, fh, times)
    t0 = time.perf_counter()
    colr = _colr(data, props)
    if colr is None:
        cp, mc, full = seq.cp, seq.mc, seq.color_range
    else:
        cp, mc, full = colr[0], colr[2], colr[3]
    rgb = yuv_to_rgb(planes, w, h, seq, seq.bit_depth, mc, cp, full, alpha_plane, prem)
    times["YUV to RGB"] = time.perf_counter() - t0
    return rgb


def census(data: bytes) -> set:
    """The tools an AVIF file turns on (av1_obu's and av1_block's names), a
    tool the port refuses as ("refused", its name)."""
    try:
        info, props, size, payload, alpha = _container(data)
        av1c = props[b"av1C"]
        seq = _first_seq(data[av1c.body + 4:av1c.end]) if av1c.end - av1c.body > 4 else None
        seq, fh = parse_still(payload, seq)
    except Unsupported as e:
        return {("refused", str(e))}
    tools = fh.tools
    tools.add(("subsampling", "4:0:0" if seq.mono else
               {(1, 1): "4:2:0", (1, 0): "4:2:2", (0, 0): "4:4:4"}[(seq.ssx, seq.ssy)]))
    if seq.bit_depth > 8:
        tools.add(("bit depth", seq.bit_depth))
    if alpha is not None and alpha[1]:
        tools.add("premultiplied alpha")
    if seq.sb128:
        tools.add("128x128 superblocks")
    dec = FrameDecoder(seq, fh)
    dec.decode()
    return tools


def _first_seq(config_obus: bytes):
    """The sequence header among av1C's configOBUs, or None."""
    for typ, _, _, payload in obus(config_obus):
        if typ == OBU_SEQUENCE_HEADER:
            return sequence_header(payload)
    return None


# libyuv's YuvConstants (row_common.cc), 6-bit fixed point, by matrix and
# full range: (UB, UG, VG, VR, YG, YB); the limited forms cap UB at 128.
# A grey (4:0:0) picture in limited range without alpha converts with YG
# 19003 (I400ToARGBMatrix); with alpha it takes the matrix's own YG.
_CONSTANTS = {("601", 1): (113, 22, 46, 90, 16320, 32),
              ("601", 0): (128, 25, 52, 102, 18997, -1160),
              ("709", 1): (119, 12, 30, 101, 16320, 32),
              ("709", 0): (128, 14, 34, 115, 18997, -1160),
              ("2020", 1): (120, 11, 37, 94, 16320, 32),
              ("2020", 0): (128, 12, 42, 107, 19003, -1160)}
# the matrices libavif hands to libyuv; chromaticity-derived (12) only
# under these colour primaries (an unspecified 2 taken as BT.709)
_MATRIX = {1: "709", 2: "601", 5: "601", 6: "601", 9: "2020"}
_DERIVED_MATRIX = {1: "709", 2: "709", 5: "601", 6: "601", 9: "2020"}
_LIBAVIF_FAILS = (3, 10, 11, 13, 14)  # avifImageYUVToRGB: "Reformat failed"
# libavif's own (kr, kb) for the matrices it converts in float
# (avifCalcYUVCoefficients; BT.601 where it has none)
_KRKB = {1: ("0.2126", "0.0722"), 4: ("0.30", "0.11"), 5: ("0.299", "0.114"),
         6: ("0.299", "0.114"), 7: ("0.212", "0.087"), 9: ("0.2627", "0.0593")}
# libavif's colour primaries (rX, rY, gX, gY, bX, bY, wX, wY), BT.709's for
# any it does not know; matrix 12 derives kr and kb from them
_BT709 = ("0.64", "0.33", "0.3", "0.6", "0.15", "0.06", "0.3127", "0.329")
_PRIMARIES = {
    4: ("0.67", "0.33", "0.21", "0.71", "0.14", "0.08", "0.310", "0.316"),
    5: ("0.64", "0.33", "0.29", "0.60", "0.15", "0.06", "0.3127", "0.3290"),
    6: ("0.630", "0.340", "0.310", "0.595", "0.155", "0.070", "0.3127", "0.3290"),
    7: ("0.630", "0.340", "0.310", "0.595", "0.155", "0.070", "0.3127", "0.3290"),
    8: ("0.681", "0.319", "0.243", "0.692", "0.145", "0.049", "0.310", "0.316"),
    9: ("0.708", "0.292", "0.170", "0.797", "0.131", "0.046", "0.3127", "0.3290"),
    10: ("1.0", "0.0", "0.0", "1.0", "0.0", "0.0", "0.3333", "0.3333"),
    11: ("0.680", "0.320", "0.265", "0.690", "0.150", "0.060", "0.314", "0.351"),
    12: ("0.680", "0.320", "0.265", "0.690", "0.150", "0.060", "0.3127", "0.3290"),
    22: ("0.630", "0.340", "0.295", "0.605", "0.155", "0.077", "0.3127", "0.3290")}
_F = np.float32


def _up_linear(c: np.ndarray, n: int) -> np.ndarray:
    """libyuv's ScaleRowUp2_Linear_Any along the last axis to n samples:
    the ends copied, 3:1 and 1:3 between neighbours."""
    out = np.empty(c.shape[:-1] + (n,), np.int64)
    out[..., 0] = c[..., 0]
    work = (n - 1) & ~1
    if work > 0:
        a, b = c[..., :work // 2], c[..., 1:work // 2 + 1]
        out[..., 1:work + 1:2] = (3 * a + b + 2) >> 2
        out[..., 2:work + 2:2] = (a + 3 * b + 2) >> 2
    out[..., n - 1] = c[..., (n - 1) // 2]
    return out


def _up_bilinear(s: np.ndarray, t: np.ndarray, n: int) -> tuple:
    """libyuv's ScaleRowUp2_Bilinear_Any of chroma rows s over t: the two
    output rows (3:1 and 1:3 vertically)."""
    d = np.empty(s.shape[:-1] + (n,), np.int64)
    e = np.empty_like(d)
    d[..., 0] = (3 * s[..., 0] + t[..., 0] + 2) >> 2
    e[..., 0] = (s[..., 0] + 3 * t[..., 0] + 2) >> 2
    work = (n - 1) & ~1
    if work > 0:
        k = work // 2
        s0, s1, t0, t1 = s[..., :k], s[..., 1:k + 1], t[..., :k], t[..., 1:k + 1]
        d[..., 1:work + 1:2] = (9 * s0 + 3 * s1 + 3 * t0 + t1 + 8) >> 4
        d[..., 2:work + 2:2] = (3 * s0 + 9 * s1 + t0 + 3 * t1 + 8) >> 4
        e[..., 1:work + 1:2] = (3 * s0 + s1 + 9 * t0 + 3 * t1 + 8) >> 4
        e[..., 2:work + 2:2] = (s0 + 3 * s1 + 3 * t0 + 9 * t1 + 8) >> 4
    m = (n - 1) // 2
    d[..., n - 1] = (3 * s[..., m] + t[..., m] + 2) >> 2
    e[..., n - 1] = (s[..., m] + 3 * t[..., m] + 2) >> 2
    return d, e


def _upsample(c: np.ndarray, w: int, h: int, ssx: int, ssy: int) -> np.ndarray:
    """A chroma plane at full size as libyuv's I420/I422ToRGBAMatrixFilter
    (kFilterBilinear) reads it."""
    if not ssx:
        return c
    if not ssy:
        return _up_linear(c, w)
    out = np.empty((h, w), np.int64)
    out[0] = _up_linear(c[0], w)
    rows = (h - 1) // 2  # the row pairs after the first row
    if rows:
        d, e = _up_bilinear(c[:rows], c[1:rows + 1], w)
        out[1:2 * rows + 1:2] = d
        out[2:2 * rows + 2:2] = e
    if not h & 1:
        out[h - 1] = _up_linear(c[rows], w)
    return out


def _derived_krkb(cp: int) -> tuple:
    """avifColorPrimariesComputeYCoeffs: kr and kb from the primaries, in
    float32 as libavif computes them."""
    rx, ry, gx, gy, bx, by, wx, wy = (_F(v) for v in _PRIMARIES.get(cp, _BT709))
    one = _F(1)
    rz, gz, bz, wz = one - (rx + ry), one - (gx + gy), one - (bx + by), one - (wx + wy)
    den = wy * (rx * (gy * bz - by * gz) + gx * (by * rz - ry * bz) + bx * (ry * gz - gy * rz))
    kr = ry * (wx * (gy * bz - by * gz) + wy * (bx * gz - gx * bz) + wz * (gx * by - bx * gy)) / den
    kb = by * (wx * (ry * gz - gy * rz) + wy * (gx * rz - rx * gz) + wz * (rx * gy - gx * ry)) / den
    return kr, kb


def _nearest(c: np.ndarray, w: int, h: int, ssx: int, ssy: int) -> np.ndarray:
    return c[(np.arange(h) >> ssy)[:, None], (np.arange(w) >> ssx)[None, :]]


def _libyuv(y, u, v, depth: int, consts: tuple) -> np.ndarray:
    """libyuv's YuvPixel (8 bits), YuvPixel10 or YuvPixel12 on full-size
    planes of `depth` bits: Y widened to 16 bits, U and V cut to 8."""
    ub, ug, vg, vr, yg, yb = consts
    shift = depth - 8
    y32 = (y << (16 - depth)) | (y >> (2 * depth - 16))
    y1 = ((y32 * yg) >> 16) + yb
    ui = np.minimum(u >> shift, 255) - 128
    vi = np.minimum(v >> shift, 255) - 128
    rgb = np.stack([(y1 + vi * vr) >> 6, (y1 - (ui * ug + vi * vg)) >> 6, (y1 + ui * ub) >> 6],
                   axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _float_tables(depth: int, full: int, identity: bool) -> tuple:
    """libavif's unormFloatTableY and unormFloatTableUV (float32); the
    identity matrix reads chroma through luma's table."""
    top = (1 << depth) - 1
    cp = np.arange(1 << depth).astype(_F)
    y = (cp - _F(0 if full else 16 << (depth - 8))) / _F(top if full else 219 << (depth - 8))
    if identity:
        return y, y
    uv = (cp - _F(1 << (depth - 1))) / _F(top if full else 224 << (depth - 8))
    return y, uv


def _float_chroma(c, table, w: int, h: int, ssx: int, ssy: int) -> np.ndarray:
    """A chroma plane at full size as libavif's own path reads it: 4:4:4 as
    it is, else its closest sample 9/16, the adjacent column's and row's 3/16
    each and the diagonal's 1/16 (edges repeat; 4:2:2 rows stand alone)."""
    if not ssx:
        return table[c]
    i, j = np.arange(w), np.arange(h)
    ci, cj = i >> ssx, j >> ssy
    ai = ci + np.where((i == 0) | ((i == w - 1) & (i % 2 == 1)), 0, np.where(i % 2 == 1, 1, -1))
    if ssy:
        aj = cj + np.where((j == 0) | ((j == h - 1) & (j % 2 == 1)), 0,
                           np.where(j % 2 == 1, 1, -1))
    else:
        aj = cj
    t = table[c]
    return (t[cj[:, None], ci[None, :]] * _F(9 / 16) + t[cj[:, None], ai[None, :]] * _F(3 / 16)
            + t[aj[:, None], ci[None, :]] * _F(3 / 16) + t[aj[:, None], ai[None, :]] * _F(1 / 16))


def _float_rgb(y, u, v, w, h, seq, depth, mc, cp, full, alpha) -> np.ndarray:
    """libavif's own conversion (reformat.c, in float32): the YUV
    coefficients of the matrix, YCgCo, or the identity matrix; with
    `alpha` (its full-depth plane) the colour divided by it as the slow
    path divides it. The result is clamped to [0, 1] and stored as
    (uint8)(0.5 + c * 255)."""
    top = (1 << depth) - 1
    ty, tuv = _float_tables(depth, full, mc == 0)
    yf = ty[np.minimum(y, top)]
    if seq.mono:
        r = g = b = yf
    else:
        cb = _float_chroma(np.minimum(u, top), tuv, w, h, seq.ssx, seq.ssy)
        cr = _float_chroma(np.minimum(v, top), tuv, w, h, seq.ssx, seq.ssy)
        if mc == 0:
            r, g, b = cr, yf, cb
        elif mc == 8:
            t = yf - cb
            r, g, b = t + cr, yf + cb, t - cr
        else:
            kr, kb = _derived_krkb(cp) if mc == 12 else (_F(k) for k in _KRKB.get(mc, _KRKB[6]))
            kg = _F(1) - kr - kb
            two = _F(2)
            r = yf + (two * (_F(1) - kr)) * cr
            b = yf + (two * (_F(1) - kb)) * cb
            g = yf - ((two * ((kr * (_F(1) - kr) * cr) + (kb * (_F(1) - kb) * cb))) / kg)
    out = [np.clip(c, _F(0), _F(1)).astype(_F) for c in (r, g, b)]
    if alpha is not None:
        a = np.clip(np.minimum(alpha, top).astype(_F) / _F(top), _F(0), _F(1))
        safe = np.where(a == 0, _F(1), a)
        out = [np.where(a == 0, _F(0), np.where(a < 1, np.minimum(c / safe, _F(1)), c))
               for c in out]
    return np.stack([(_F(0.5) + c * _F(255)).astype(np.uint8) for c in out], axis=-1)


def limited_to_full(v: np.ndarray, depth: int) -> np.ndarray:
    """libavif's avifLimitedToFullY, which it applies to an alpha item coded
    in limited range: (v - 16) * max / 219 at 8 bits (scaled to the
    depth), rounded half up, divided toward zero, clamped."""
    lo, span, top = 16 << (depth - 8), 219 << (depth - 8), (1 << depth) - 1
    num = (v - lo) * top + span // 2
    return np.clip(np.where(num < 0, -(-num // span), num // span), 0, top)


def alpha_to_8(alpha: np.ndarray, depth: int) -> np.ndarray:
    """libavif's avifReformatAlpha to 8 bits: (uint8)(0.5 + a / max * 255)
    in float32 (the samples as they are at 8 bits)."""
    if depth == 8:
        return alpha.astype(np.int64)
    top = _F((1 << depth) - 1)
    return (_F(0.5) + (np.minimum(alpha, top).astype(_F) / top) * _F(255)).astype(np.int64)


def unattenuate(rgb: np.ndarray, a8: np.ndarray) -> np.ndarray:
    """libyuv's ARGBUnattenuate as Pillow's libavif runs it (SIMD): each
    colour times its 16-bit copy and the 8.8 reciprocal of alpha, the top
    16 bits packed to 8 with signed saturation (a sum past 32767 packs to 0:
    alpha 1 under colour 128 and up)."""
    inv = np.r_[0, 0xFFFF, 0x10000 // np.arange(2, 255), 0x100]
    v = (rgb.astype(np.int64) * 257 * inv[a8][..., None]) >> 16
    return np.where(v >= 32768, 0, np.minimum(v, 255)).astype(np.uint8)


def yuv_to_rgb(planes, w, h, seq, depth, mc, cp, full, alpha=None, prem=False) -> np.ndarray:
    """RGB as Pillow's libavif 1.3.0 converts to 8 bits (RGB, or RGBA where
    the file has alpha, its colour then un-premultiplied where the file says
    prem) and convert("RGB") keeps it. The route, as PIL's bytes settle it:
    - a matrix libyuv has (BT.601, BT.709, BT.2020): planes of more than 8
      bits cut to 8 (>> (depth - 8)) and libyuv's 8-bit bilinear path; with
      alpha, 10 bits through libyuv's I010/I210/I410 alpha functions at 10
      bits (its bilinear filter on 10-bit chroma) and 12-bit 4:2:0 through
      I012ToARGBMatrix (nearest chroma); grey through I400ToARGBMatrix at
      8 bits, with alpha at any depth (cut to 8 bits, the matrix's own YG;
      the identity matrix as BT.601), above 8 bits without alpha in float;
    - else libavif's own path in float32 (`_float_rgb`); its fast forms
      (4:4:4 and grey under YUV coefficients, 8-bit full-range identity)
      leave alpha to libyuv's ARGBUnattenuate, its slow form divides in
      float.
    The alpha libyuv divides by is the 8-bit alpha of the route: cut to 8
    bits through libyuv's functions, else avifReformatAlpha's."""
    ssx, ssy, mono = seq.ssx, seq.ssy, seq.mono
    if mc in _LIBAVIF_FAILS:
        raise DecodeError(f"AVIF: libavif does not convert matrix coefficients {mc}")
    if mc == 0 and not mono and (ssx or ssy):
        raise DecodeError("AVIF: libavif does not convert the identity matrix on subsampled chroma")
    if mc == 8 and not full:
        raise DecodeError("AVIF: libavif does not convert YCgCo in limited range")
    if mc not in _MATRIX and mc not in (0, 4, 7, 8, 12):
        raise Unsupported(f"matrix coefficients {mc}")
    y = planes[0][:h, :w].astype(np.int64)
    u = v = None
    if not mono:
        cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
        u = planes[1][:ch, :cw].astype(np.int64)
        v = planes[2][:ch, :cw].astype(np.int64)
    shift = depth - 8
    name = _DERIVED_MATRIX.get(cp) if mc == 12 else _MATRIX.get(mc)
    if mono and alpha is not None and mc == 0:
        name = "601"
    a8 = None if alpha is None else alpha_to_8(alpha, depth)
    if name is None or (mono and alpha is None and depth > 8):
        fast = mc != 8 and (mono or not ssx) and (mc != 0 or (depth == 8 and full))
        rgb = _float_rgb(y, u, v, w, h, seq, depth, mc, cp, full,
                         alpha if prem and not fast else None)
        return unattenuate(rgb, a8) if prem and fast else rgb
    consts = _CONSTANTS[(name, int(bool(full)))]
    if mono:
        if alpha is None and not full:
            consts = consts[:4] + (19003,) + consts[5:]
        grey = np.full_like(y, 128)
        rgb = _libyuv(y >> shift, grey, grey, 8, consts)
    elif alpha is not None and depth == 10:
        a8 = alpha >> 2
        rgb = _libyuv(y, _upsample(u, w, h, ssx, ssy), _upsample(v, w, h, ssx, ssy), 10, consts)
    elif alpha is not None and depth == 12 and ssy:
        rgb = _libyuv(y, _nearest(u, w, h, ssx, ssy), _nearest(v, w, h, ssx, ssy), 12, consts)
    else:
        if alpha is not None:
            a8 = alpha >> shift
        rgb = _libyuv(y >> shift, _upsample(u >> shift, w, h, ssx, ssy),
                      _upsample(v >> shift, w, h, ssx, ssy), 8, consts)
    return unattenuate(rgb, a8) if prem else rgb
