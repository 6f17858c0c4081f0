"""JPEG 2000 texture decoding in numpy and the standard library: a J2K
codestream or a JP2 file to the (H, W, 3) uint8 pixels that PIL 12.1.0's
`Image.open(f).convert("RGB")` gives for it, through OpenJPEG 2.5.4, byte
for byte.

The codestream and tier 2 are utils/j2k_codestream's, tier 1
utils/j2k_tier1's. Here, as OpenJPEG's tcd.c, dwt.c and mct.c:

  dequantisation  5/3: tier 1's values (one bit below the last plane)
                  halved, truncating to 0; 9/7: in float32, times half the
                  band's step, (1 + mant / 2048) * 2 ** (prec - expn)
                  rounded to float32 (OpenJPEG's decoder leaves out the
                  band's gain, as its 9/7 synthesis scales its high-pass
                  samples by 2 / K's historic 1.625732422).
  inverse DWT     per level the rows then the columns; 5/3 in integers
                  (floor shifts); 9/7 in float32, each step rounded as
                  OpenJPEG's SSE code rounds it (no FMA): low-pass times K,
                  high-pass times 1.625732422, then the four lifting steps
                  (l + r) * c added, with whole-sample symmetric extension;
                  a signal of one sample is left as it is (5/3: an odd one
                  halved).
  MCT             RCT in integers; ICT in float32 in OpenJPEG's order
                  (r = y + v * 1.402, g = y - u * 0.34413 - v * 0.71414,
                  b = y + u * 1.772), where COD asks for it and the first
                  three components have one size; the first component's
                  transform picks one, each component's samples read as
                  the bits of its own (`_mct`).
  level shift     the DC shift added and the value clamped to the
                  component's precision; 9/7: rounded with lrintf (to
                  even) first.

Then PIL: the mode as Jpeg2KImagePlugin reads it from SIZ or the JP2
header, and Jpeg2KDecode.c's unpacking of each tile's component buffers
(OpenJPEG's byte order and sizes: 1, 2 or 4 bytes a sample) to L, I;16,
LA, RGB, RGBA or CMYK: each sample plus half its sign range (signed) and
half a step (precision over 8), shifted to 8 bits (16 for I;16), and
the subsampled components read by its own stride (the tile's width
divided by the factor, rounded down). sYCC (JP2 colr 18) goes through
PIL's YCbCr conversion. JP2: the boxes OpenJPEG reads (jP, ftyp, jp2h
with ihdr, colr, pclr, cmap, cdef, then jp2c) and the header PIL reads
for its mode and palette; a palette image is PIL's P or PA with the
palette PIL read, its indices unpacked as L.

Refused by name (J2KError, a DecodeError): HTJ2K and Part 2's markers;
what OpenJPEG or PIL refuse.
"""

from __future__ import annotations

import numpy as np

from .image_decode import DecodeError, _check_size
from .j2k_codestream import CodestreamError, parse, read_packets, resolutions
from .j2k_tier1 import Tier1Error, decode_codeblock
from .pil_modes import to_rgb, ycbcr_to_rgb

F32 = np.float32
# dwt.c
_K, _TWO_INVK = F32(1.230174105), F32(1.625732422)
_ALPHA, _BETA, _GAMMA, _DELTA = F32(-1.586134342), F32(-0.052980118), F32(0.882911075), \
    F32(0.443506852)


class J2KError(DecodeError):
    pass


# ---------------------------------------------------------------------------
# inverse DWT (dwt.c)

def _mirror(n: int) -> tuple:
    """Indices of each sample's left and right neighbours with whole-
    sample symmetric extension."""
    i = np.arange(n)
    left, right = i - 1, i + 1
    left[0] = 1 if n > 1 else 0
    right[-1] = n - 2 if n > 1 else 0
    return left, right


def _interleave(low: np.ndarray, high: np.ndarray, cas: int) -> np.ndarray:
    n = low.shape[-1] + high.shape[-1]
    out = np.empty(low.shape[:-1] + (n,), low.dtype)
    out[..., cas::2] = low
    out[..., 1 - cas::2] = high
    return out


def _synth53(low: np.ndarray, high: np.ndarray, cas: int) -> np.ndarray:
    x = _interleave(low, high, cas).astype(np.int64)
    n = x.shape[-1]
    if n <= 1:
        return np.sign(x) * (np.abs(x) // 2) if cas else x  # C's x / 2
    left, right = _mirror(n)
    lo, hi = slice(cas, None, 2), slice(1 - cas, None, 2)
    x[..., lo] -= (x[..., left[lo]] + x[..., right[lo]] + 2) >> 2
    x[..., hi] += (x[..., left[hi]] + x[..., right[hi]]) >> 1
    return x


def _synth97(low: np.ndarray, high: np.ndarray, cas: int) -> np.ndarray:
    x = _interleave(low, high, cas).astype(F32)
    n = x.shape[-1]
    if n <= 1:
        return x
    left, right = _mirror(n)
    lo, hi = slice(cas, None, 2), slice(1 - cas, None, 2)
    x[..., lo] *= _K
    x[..., hi] *= _TWO_INVK
    for part, c in ((lo, -_DELTA), (hi, -_GAMMA), (lo, -_BETA), (hi, -_ALPHA)):
        x[..., part] += (x[..., left[part]] + x[..., right[part]]) * c
    return x


def idwt(bands: list, res: list, reversible: bool) -> np.ndarray:
    """The component's samples from its bands: bands[0] the LL band,
    bands[r] (HL, LH, HH) of resolution r; res the resolutions' rects."""
    synth = _synth53 if reversible else _synth97
    a = bands[0]
    for r in range(1, len(res)):
        hl, lh, hh = bands[r]
        x0, y0 = res[r].x0, res[r].y0
        top = synth(a, hl, x0 & 1)
        bottom = synth(lh, hh, x0 & 1)
        a = synth(top.T, bottom.T, y0 & 1).T
    return a


# ---------------------------------------------------------------------------
# a tile

def _tile_components(header, t: int) -> list:
    """The tile's components after tier 1, dequantisation and the inverse
    DWT, MCT and level shift: (h, w) int64 arrays in the component's
    precision."""
    tp = header.tiles[t][0]
    rect = header.tile_rect(t)
    res = [resolutions(header, c, rect, tp) for c in range(len(header.comps))]
    decoded = read_packets(header, t, res)
    out = []
    for c, comp in enumerate(header.comps):
        coding = tp.coding[c]
        reversible = coding.qmfbid == 1
        # a component's output stops at its highest resolution with a packet
        res[c] = res[c][:decoded.get(c, len(res[c]) - 1) + 1]
        bands = []
        for r, rr in enumerate(res[c]):
            arrays = []
            for band in rr.bands:
                h, w = band.y1 - band.y0, band.x1 - band.x0
                h, w = max(h, 0), max(w, 0)
                if reversible:
                    a = np.zeros((h, w), np.int64)
                else:
                    a = np.zeros((h, w), F32)
                    step = F32((1.0 + band.step[1] / 2048.0) * 2.0 ** (comp.prec - band.step[0]))
                    half = F32(0.5) * step
                for _, _, blocks, _, _ in band.precincts:
                    for block in blocks:
                        if not block.segs or block.x1 <= block.x0 or block.y1 <= block.y0:
                            continue
                        segments = [(b"".join(chunks), passes) for _, passes, chunks in block.segs]
                        v = decode_codeblock(block.x1 - block.x0, block.y1 - block.y0, band.index,
                                             block.numbps, tp.roi[c], coding.style, segments)
                        ys = slice(block.y0 - band.y0, block.y1 - band.y0)
                        xs = slice(block.x0 - band.x0, block.x1 - band.x0)
                        if reversible:  # C's v / 2
                            a[ys, xs] = np.sign(v) * (np.abs(v.astype(np.int64)) // 2)
                        else:
                            a[ys, xs] = v.astype(F32) * half
                arrays.append(a)
            bands.append(arrays[0] if r == 0 else arrays)
        out.append(idwt(bands, res[c], reversible))
    if tp.mct and len(out) >= 3:
        if not (out[0].shape == out[1].shape == out[2].shape):
            raise J2KError("MCT over components of different sizes")
        out[:3] = _mct(out[:3], [tp.coding[i].qmfbid == 1 for i in range(3)])
    shifted = []
    for c, comp in enumerate(header.comps):
        lo, hi = ((-(1 << (comp.prec - 1)), (1 << (comp.prec - 1)) - 1) if comp.sgnd else
                  (0, (1 << comp.prec) - 1))
        shift = 0 if comp.sgnd else 1 << (comp.prec - 1)
        a = out[c]
        if a.dtype == F32:  # lrintf; NaN gives INT64_MIN, clamped to lo
            big = a > F32(2147483647.0)
            small = (a < F32(-2147483648.0)) | np.isnan(a)
            v = np.rint(np.where(big | small, 0, a)).astype(np.int64) + shift
            v = np.where(big, hi, np.where(small, lo, v))
        else:
            v = a + shift
        shifted.append(np.clip(v, lo, hi).astype(np.int64))
    return shifted


def _mct(planes: list, reversible: list) -> list:
    """OpenJPEG's MCT on the first three components: the first one's
    transform decides RCT (int32, wrapping) or ICT (float32), and each
    component's samples are read, and left, as the bits its own transform
    keeps (a COC may mix them: OpenJPEG then reads one's integers as the
    other's floats)."""
    if reversible[0]:
        y, u, v = (p.view(np.int32) if p.dtype == F32 else p.astype(np.int32) for p in planes)
        g = y - ((u + v) >> 2)
        out = [v + g, g, u + g]
        return [o.astype(np.int64) if rev else o.view(F32) for o, rev in zip(out, reversible)]
    y, u, v = (p if p.dtype == F32 else p.astype(np.int32).view(F32) for p in planes)
    out = [y + v * F32(1.402), (y - u * F32(0.34413)) - v * F32(0.71414), y + u * F32(1.772)]
    return [o.view(np.int32).astype(np.int64) if rev else o for o, rev in zip(out, reversible)]


def decode_codestream(data: bytes):
    """(header, {tile: [component arrays]}) of a J2K codestream."""
    header = parse(data)
    return header, {t: _tile_components(header, t) for t in header.order}


# ---------------------------------------------------------------------------
# JP2 boxes

_JP2_MAGIC = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
# OpenJPEG's image colour spaces by colr's enumerated colour space
SRGB, GRAY, SYCC, EYCC, CMYK, UNSPECIFIED = "sRGB", "grey", "sYCC", "eYCC", "CMYK", None
_ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}


def openjpeg_jp2(data: bytes) -> tuple:
    """(codestream, colour space) of a JP2 file as OpenJPEG's jp2.c reads
    it: the signature box, ftyp second, jp2h (ihdr; the first colr; pclr,
    cmap and cdef checked, not applied: PIL decodes tile by tile, where
    OpenJPEG applies none of them) before jp2c."""
    state = 0  # 1 signature, 2 file type, 4 header
    colour, has_colr = UNSPECIFIED, False
    pos = 0
    while pos + 8 <= len(data):
        length, kind = int.from_bytes(data[pos:pos + 4], "big"), data[pos + 4:pos + 8]
        head = 8
        if length == 1:
            if pos + 16 > len(data):
                raise J2KError("JP2: a truncated box header")
            length, head = int.from_bytes(data[pos + 8:pos + 16], "big"), 16
        if kind == b"jp2c":  # OpenJPEG reads the codestream on to the file's end
            if not state & 4:
                raise J2KError("JP2: the codestream box before the header box")
            return data[pos + head:], colour
        if length == 0:
            raise J2KError(f"JP2: box {kind!r} of undefined length")
        if length < head:
            raise J2KError(f"JP2: box {kind!r} of length {length}")
        body = data[pos + head:pos + length]
        if kind == b"jP  ":
            if state or length - head != 4 or body != b"\r\n\x87\n":
                raise J2KError("JP2: a bad signature box")
            state = 1
        elif kind == b"ftyp":
            if state != 1 or len(body) < 8 or (len(body) - 8) % 4:
                raise J2KError("JP2: the file type box is not second, or is malformed")
            state = 3
        elif kind == b"jp2h":
            if not state & 2:
                raise J2KError("JP2: the header box before the file type box")
            if pos + length > len(data):
                raise J2KError("JP2: the header box runs past the end of the file")
            colour, has_colr = _jp2h(body, colour, has_colr)
            state |= 4
        elif kind in (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef"):
            if state & 4:  # OpenJPEG reads a misplaced header box after jp2h
                colour, has_colr = _jp2h(data[pos:pos + length], colour, has_colr, nested=False)
        elif not state & 1 or not state & 2:
            raise J2KError("JP2: the first boxes are not the signature and file type boxes")
        if pos + length > len(data) and kind != b"jp2c":
            raise J2KError(f"JP2: box {kind!r} runs past the end of the file")
        pos += length
    raise J2KError("JP2: no codestream box")


def _jp2h(body: bytes, colour, has_colr: bool, nested: bool = True) -> tuple:
    has_ihdr = False
    pclr = cmap = cdef = None
    for kind, start, end in _boxes(body, 0, len(body)):
        b = body[start:end]
        if kind == b"ihdr":
            if len(b) != 14 or not int.from_bytes(b[8:10], "big"):
                raise J2KError("JP2: a bad ihdr box")
            if not int.from_bytes(b[:4], "big") or not int.from_bytes(b[4:8], "big"):
                raise J2KError("JP2: ihdr gives an empty image")
            has_ihdr = True
        elif kind == b"colr":
            if has_colr:
                continue
            if len(b) < 3:
                raise J2KError("JP2: a bad colr box")
            if b[0] == 1:
                if len(b) < 7:
                    raise J2KError("JP2: a bad colr box")
                colour = _ENUMCS.get(int.from_bytes(b[3:7], "big"), UNSPECIFIED)
                has_colr = True
            elif b[0] == 2:
                colour, has_colr = UNSPECIFIED, True
        elif kind == b"pclr":
            if pclr is not None or len(b) < 3:
                raise J2KError("JP2: a bad or second pclr box")
            entries, channels = int.from_bytes(b[:2], "big"), b[2]
            if not 0 < entries <= 1024 or not channels or len(b) < 3 + channels:
                raise J2KError(f"JP2: a pclr box of {entries} entries, {channels} columns")
            size = sum(min(((s & 0x7F) + 8) >> 3, 4) for s in b[3:3 + channels]) * entries
            if len(b) < 3 + channels + size:
                raise J2KError("JP2: a truncated pclr box")
            pclr = channels
        elif kind == b"cmap":
            if pclr is None or cmap is not None:
                raise J2KError("JP2: a cmap box without a pclr box before it, or a second one")
            if len(b) < 4 * pclr:
                raise J2KError("JP2: a truncated cmap box")
            cmap = True
        elif kind == b"cdef":
            if cdef is not None or len(b) < 2 or not int.from_bytes(b[:2], "big") or \
                    len(b) < 2 + 6 * int.from_bytes(b[:2], "big"):
                raise J2KError("JP2: a bad cdef box")
            cdef = True
    if nested and not has_ihdr:
        raise J2KError("JP2: no ihdr box in the header box")
    return colour, has_colr


def pil_jp2_header(data: bytes) -> tuple:
    """((width, height), mode, palette) as Jpeg2KImagePlugin's
    _parse_jp2_header reads them; palette, for P and PA, the pclr entries
    PIL's ImagePalette keeps (each colour once, in order)."""
    header = None
    for kind, start, end in _boxes(data, 12, len(data)):
        if kind == b"jp2h":
            header = (start, end)
            break
    if header is None:
        raise J2KError("JP2: no header box (PIL)")
    size = mode = nc = None
    palette = None
    for kind, start, end in _boxes(data, *header):
        b = data[start:end]
        if kind == b"ihdr":
            if len(b) < 11:
                raise J2KError("JP2: not enough data in the ihdr box")
            height, width, nc, bpc = (int.from_bytes(b[:4], "big"), int.from_bytes(b[4:8], "big"),
                                      int.from_bytes(b[8:10], "big"), b[10])
            size = (width, height)
            mode = ("I;16" if nc == 1 and (bpc & 0x7F) > 8 else
                    {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode))
        elif kind == b"colr" and nc == 4:
            if len(b) < 7:
                raise J2KError("JP2: not enough data in the colr box")
            if b[0] == 1 and int.from_bytes(b[3:7], "big") == 12:
                mode = "CMYK"
        elif kind == b"pclr" and mode in ("L", "LA"):
            if len(b) < 3:
                raise J2KError("JP2: not enough data in the pclr box")
            ne, npc = int.from_bytes(b[:2], "big"), b[2]
            if len(b) < 3 + npc:
                raise J2KError("JP2: not enough data in the pclr box")
            if max(b[3:3 + npc], default=0) <= 8:
                if len(b) < 3 + npc + ne * npc:
                    raise J2KError("JP2: not enough data in the pclr box")
                raw = np.frombuffer(b, np.uint8, ne * npc, 3 + npc).reshape(ne, npc)
                seen, colours = set(), []
                for row in map(tuple, raw.tolist()):
                    row = row + (255,) * (npc == 4 and len(row) < 4)
                    if row not in seen:
                        if len(colours) >= 256:
                            raise J2KError("JP2: a palette of more than 256 colours (PIL)")
                        seen.add(row)
                        colours.append(row[:3] if npc != 4 else row)
                palette = np.zeros((256, 3), np.uint8)
                if colours:
                    palette[:len(colours)] = np.array(colours, np.uint8)[:, :3]
                mode = "P" if mode == "L" else "PA"
    if size is None or mode is None:
        raise J2KError("JP2: malformed header (PIL)")
    return size, mode, palette


def _boxes(data: bytes, pos: int, end: int):
    """(type, body start, body end) of each box in data[pos:end], read as
    Jpeg2KImagePlugin's BoxReader reads them: a length of 1 reads a 64-bit
    one; a box shorter than its header (a length of 0 too), or past its
    parent's end, raises. OpenJPEG reads jp2h's boxes alike, but for a
    length of 0, which PIL refuses first."""
    while pos < end:
        if pos + 8 > end:
            raise J2KError("JP2: not enough data in a box header (PIL)")
        length, kind = int.from_bytes(data[pos:pos + 4], "big"), data[pos + 4:pos + 8]
        head = 8
        if length == 1:
            if pos + 16 > end:
                raise J2KError("JP2: not enough data in a box header (PIL)")
            length, head = int.from_bytes(data[pos + 8:pos + 16], "big"), 16
        if length < head or pos + length > end:
            raise J2KError(f"JP2: an invalid length of box {kind!r} (PIL)")
        yield kind, pos + head, pos + length
        pos += length


# ---------------------------------------------------------------------------
# PIL's unpacking (Jpeg2KDecode.c)

def _words(planes: list, header) -> tuple:
    """The tile's buffer as OpenJPEG writes it (each component's samples
    in 1, 2 or 4 little-endian bytes, components one after another) and
    each component's sample size."""
    sizes, parts = [], []
    for plane, comp in zip(planes, header.comps):
        c = (comp.prec + 7) >> 3
        c = 4 if c == 3 else c
        sizes.append(c)
        parts.append((plane.astype(np.int64) & ((1 << (8 * c)) - 1)).astype(f"<u{c}").tobytes())
    return np.frombuffer(b"".join(parts), np.uint8), sizes


def _read(buf: np.ndarray, offsets: np.ndarray, size: int) -> np.ndarray:
    """Little-endian words of `size` bytes at `offsets`; zeros past the
    buffer's end."""
    word = np.zeros(offsets.shape, np.int64)
    for i in range(size):
        at = offsets + i
        word |= np.where(at < buf.size, buf[np.minimum(at, buf.size - 1)], 0).astype(
            np.int64) << (8 * i)
    return word


def _shift(word: np.ndarray, comp, bits: int = 8) -> np.ndarray:
    """j2ku_shift(offset + word, shift), as a byte (bits 8) or a 16-bit
    word (I;16)."""
    shift = bits - comp.prec
    offset = (1 << (comp.prec - 1)) if comp.sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    v = (word + offset) & 0xFFFFFFFF
    v = v >> -shift if shift < 0 else (v << shift) & 0xFFFFFFFF
    return v & ((1 << bits) - 1)


# (mode, colour space, components) -> unpacker, whether it takes subsampling
_UNPACKERS = {("L", GRAY, 1): ("gray", 0), ("P", SRGB, 1): ("gray", 0),
              ("PA", SRGB, 2): ("graya", 0), ("I;16", GRAY, 1): ("gray_i", 0),
              ("LA", GRAY, 2): ("graya", 0), ("RGB", GRAY, 1): ("gray_rgb", 0),
              ("RGB", GRAY, 2): ("gray_rgb", 0), ("RGB", SRGB, 3): ("rgb", 1),
              ("RGB", SYCC, 3): ("ycc", 1), ("RGB", SRGB, 4): ("rgb", 1),
              ("RGB", SYCC, 4): ("ycc", 1), ("RGBA", GRAY, 1): ("gray_rgb", 0),
              ("RGBA", GRAY, 2): ("graya", 0), ("RGBA", SRGB, 3): ("rgb", 1),
              ("RGBA", SYCC, 3): ("ycc", 1), ("RGBA", SRGB, 4): ("rgba", 1),
              ("RGBA", GRAY, 4): ("rgba", 1),
              ("RGBA", SYCC, 4): ("ycca", 1), ("CMYK", CMYK, 4): ("rgba", 1)}


def _unpack(kind: str, buf: np.ndarray, sizes: list, header, w: int, h: int) -> np.ndarray:
    """(h, w, 4) samples of one tile as the unpacker `kind` stores them
    in PIL's image (one band: (h, w)), from PIL's tile buffer."""
    comps = header.comps
    y, x = np.mgrid[0:h, 0:w]
    if kind in ("gray", "gray_i", "gray_rgb", "graya"):
        word = _read(buf, sizes[0] * (y * w + x), sizes[0])
        if kind == "gray_i":
            return _shift(word, comps[0], 16)
        grey = _shift(word, comps[0])
        if kind == "gray":
            return grey
        alpha = np.full_like(grey, 255)
        if kind == "graya":
            alpha = _shift(_read(buf, sizes[0] * w * h + sizes[1] * (y * w + x), sizes[1]),
                           comps[1])
        return np.stack([grey, grey, grey, alpha], -1)
    n = 4 if kind in ("rgba", "ycca") else 3
    start, out = 0, []
    for k in range(n):
        dx, dy, c = comps[k].dx, comps[k].dy, sizes[k]
        offsets = start + c * ((y // dy) * (w // dx) + x // dx)
        out.append(_shift(_read(buf, offsets, c), comps[k]))
        start += c * (w // dx) * (h // dy)
    if n == 3:
        out.append(np.full_like(out[0], 255))
    rgba = np.stack(out, -1).astype(np.uint8)
    if kind in ("ycc", "ycca"):
        rgba[..., :3] = ycbcr_to_rgb(rgba[..., :3])
    return rgba


def decode_j2k(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a J2K codestream or a JP2 file, as PIL's
    `convert("RGB")` of it (module docstring); raises J2KError ("JPEG 2000:
    " and the cause) where PIL fails or the kind is not decoded."""
    try:
        return _decode(bytes(data))
    except (DecodeError, CodestreamError, Tier1Error) as e:
        message = str(e)
        raise J2KError(message if message.startswith("JPEG 2000") else f"JPEG 2000: {message}"
                       ) from e


def _decode(data: bytes) -> np.ndarray:
    palette = None
    if data[:4] == b"\xff\x4f\xff\x51":
        siz = data[4:]
        if len(siz) < 2 or len(siz) < int.from_bytes(siz[:2], "big") or len(siz) < 38:
            raise J2KError("J2K: a truncated SIZ segment")
        xsiz, ysiz, xosiz, yosiz = (int.from_bytes(siz[4 + 4 * i:8 + 4 * i], "big")
                                    for i in range(4))
        csiz = int.from_bytes(siz[36:38], "big")
        if csiz == 1:
            if len(siz) < 39:
                raise J2KError("J2K: a truncated SIZ segment")
            mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
        elif 2 <= csiz <= 4:
            mode = ("LA", "RGB", "RGBA")[csiz - 2]
        else:
            raise J2KError(f"J2K: {csiz} components (PIL reads 1 to 4)")
        size, stream, colour = (xsiz - xosiz, ysiz - yosiz), data, UNSPECIFIED
    elif data[:12] == _JP2_MAGIC:
        size, mode, palette = pil_jp2_header(data)
        stream, colour = openjpeg_jp2(data)
    else:
        raise J2KError("not a JPEG 2000 file")
    width, height = size
    if width <= 0 or height <= 0:
        raise J2KError(f"JPEG 2000: an image of {width}x{height}")
    _check_size(width, height)
    header, tiles = decode_codestream(stream)
    if size != (header.xsiz - header.xosiz, header.ysiz - header.yosiz):
        raise J2KError(f"JP2: ihdr's size {width}x{height} is not the codestream's (PIL fails)")
    comps = header.comps
    if not 1 <= len(comps) <= 4 or colour == EYCC:
        raise J2KError(f"JPEG 2000: {len(comps)} components in colour space {colour} (PIL "
                       "refuses it)")
    first_sub = next((i for i, c in enumerate(comps) if c.dx != 1 or c.dy != 1), -1)
    if colour is UNSPECIFIED:
        colour = (GRAY if len(comps) <= 2 else SYCC if first_sub in (1, 2) else SRGB)
    kind, subsampled = _UNPACKERS.get((mode, colour, len(comps)), (None, 0))
    if kind is None or (first_sub >= 0 and not subsampled):
        raise J2KError(f"JPEG 2000: no unpacker for mode {mode} from {len(comps)} components in "
                       f"colour space {colour} (PIL's)")
    bands = 1 if kind in ("gray", "gray_i") else 4
    image = np.zeros((height, width) + ((bands,) if bands > 1 else ()),
                     np.uint16 if kind == "gray_i" else np.uint8)
    # PIL's unpackers read a subsampled component with their own stride,
    # at a tile's end past its data, where its buffer holds zeros
    for t, planes in tiles.items():
        x0, y0, x1, y1 = header.tile_rect(t)
        data, sizes = _words(planes, header)
        if x0 < header.xosiz or y0 < header.yosiz or x1 - header.xosiz > width or \
                y1 - header.yosiz > height:
            raise J2KError("JPEG 2000: a tile outside the image (PIL)")
        image[y0 - header.yosiz:y1 - header.yosiz, x0 - header.xosiz:x1 - header.xosiz] = \
            _unpack(kind, data, sizes, header, x1 - x0, y1 - y0)
    if mode in ("P", "PA"):
        return palette[image if mode == "P" else image[..., 0]]
    if mode in ("LA", "RGB", "RGBA"):
        return np.ascontiguousarray(image[..., :3])
    return to_rgb(mode, image)
