"""IM (IFUNC Image Memory) and IMT (IM Tools) texture decoding in numpy
and the standard library, as PIL 12.1.0's ImImagePlugin and ImtImagePlugin
open a file and `convert("RGB")` converts it, byte for byte.

IM: a text header of "key: value" lines (each under 101 bytes, CR LF or LF,
CRs before a line skipped) up to a NUL, 0x1A or the end, then bytes up to
a 0x1A (PIL's writer pads the header to 512 bytes); at least one of PIL's
keys among the lines, "Image size (x*y)" (512x512 if missing) and "Image
type" (L if missing) read as ImImageFile._open reads them. A "Lut" key
puts 768 bytes after the 0x1A (256 reds, then greens, then blues): a grey
Lut keeps L and P (one that is not linear is only stored, as PIL's `lut`,
which `convert` never applies), any other Lut turns L and P into P
(read as 8-bit P, whatever P's depth was) with it as the palette, and LA
into PA; on RGB PIL only stores it. Every image type of ImImagePlugin.OPEN:

  1           0 1, L 1, B1 (1 bit, MSB first)
  P           B2, B4 (2 and 4 bits; no palette without a Lut: black)
  L, LA       Greyscale, Grayscale; LA (its rows line-interleaved)
  RGB, RGBA, RGBX, CMYK, YCC
              line-interleaved (each row R, then G, then B ...); X 24
              (interleaved); RGB3, RYB3 (planes, in PIL's order G, R, B)
  I, F        L 32 S (int32), L 32S, L*32S; L 32 F (uint32 to float), L 32F,
              L*32F, L 8, 8S, 16, 16S, 32 and their L* forms; L*2 to L*31
              other than 8 and 16 through PIL's C `bit` decoder (bits LSB
              first, each row starting on a byte, a row's unused bits left
              in the bit buffer and ORed into the next row's first byte)
  I;16        L 16, 16L, 16B and their L* forms

Rows are stored bottom first. RLB and RYB (PIL has no such raw mode), PA
without a colour Lut (no PA;L unpacking to LA) and an unknown image type
fail in PIL and raise DecodeError here.

IMT: "width n", "height n" and "pixel n8" lines (comments start with '*')
up to a form feed, then 8-bit grey rows, top first.
"""

from __future__ import annotations

import re

import numpy as np

from .image_decode import DecodeError, Unidentified, _check_size
from .pil_modes import cmyk_to_rgb, palette256, to_rgb, unpack_bits, ycbcr_to_rgb
from .raster_decode import _rows

_TAGS = {"Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut",
         "Name", "Scale (x,y)", "Image size (x*y)", "Image type"}
# ImImagePlugin.OPEN: image type -> (mode, raw mode)
_OPEN = {"0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
         "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"),
         "RLB image": ("RGB", "RLB"), "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
         "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"),
         "L 32 S image": ("I", "I;32"), "L 32 F image": ("F", "F;32"),
         "RGB3 image": ("RGB", "RGB;T"), "RYB3 image": ("RGB", "RYB;T"),
         "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
         "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
         "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L")}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    _OPEN[f"L {_i} image"] = _OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    _OPEN[f"L {_i} image"] = _OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
_OPEN["L 32S image"] = _OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    _OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
# the bands of the line-interleaved raw modes
_LINE_BANDS = {"RGB;L": 3, "RGBA;L": 4, "RGBX;L": 4, "CMYK;L": 4, "YCbCr;L": 3, "LA;L": 2,
               "PA;L": 2}
# the one-band raw modes: sample type (numpy), or bits for "1" and P;n
_SAMPLES = {"L": "u1", "P": "u1", "I;32": "<i4", "I;32S": "<i4", "F;8": "u1", "F;8S": "i1",
            "F;16": "<u2", "F;16S": "<i2", "F;32": "<u4", "F;32F": "<f4", "I;16": "<u2",
            "I;16L": "<u2", "I;16B": ">u2"}


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        try:
            return float(s)
        except ValueError:
            raise DecodeError(f"IM: {s!r} is not a number") from None


def open_im(d: bytes):
    """ImImageFile._open: (mode, raw mode, (width, height), palette or
    None, data offset), Unidentified where PIL tries its next plugin,
    DecodeError where it fails in IM."""
    if b"\n" not in d[:100]:
        raise Unidentified("not an IM file")
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    rawmode, pos, n = "L", 0, 0
    while True:
        s = d[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = d.find(b"\n", pos)
        end = len(d) if end < 0 else end + 1
        s, pos = s + d[pos:end], end
        if len(s) > 100:
            raise Unidentified("not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _SPLIT.match(s)
        if not m:
            raise Unidentified("syntax error in the IM header")
        k, v = (g.decode("latin-1") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            v = tuple(_number(x) for x in v.replace("*", ",").split(","))
            v = v[0] if len(v) == 1 else v
        elif k == "Image type" and v in _OPEN:
            v, rawmode = _OPEN[v]
        info[k] = v
        n += k in _TAGS
    if not n:
        raise Unidentified("not an IM file")
    size, mode = info["Image size (x*y)"], info["Image type"]
    while s and s != b"\x1a":
        s = d[pos:pos + 1]
        pos += len(s)
    if not s:
        raise Unidentified("IM: file truncated")
    palette = None
    if "Lut" in info:
        lut, pos = d[pos:pos + 768], pos + 768
        grey = _lut_grey(lut)
        if len(lut) < 768:
            raise DecodeError("IM: truncated Lut (no image data after it)")
        if mode in ("L", "LA", "P", "PA") and not grey:
            mode, rawmode = ("P", "P") if mode in ("L", "P") else ("PA", "PA;L")
            palette = palette256(np.frombuffer(lut, np.uint8).reshape(3, 256).T)
    if not isinstance(size, tuple) or len(size) != 2 or not mode:
        raise Unidentified("IM: no image size or type")
    if size[0] <= 0 or size[1] <= 0:
        raise Unidentified("IM: empty image")
    if not all(isinstance(x, int) for x in size):
        raise DecodeError(f"IM: image size {size} is not whole numbers")
    _check_size(*size)
    return mode, rawmode, size, palette, pos


def _lut_grey(p: bytes) -> bool:
    """ImImageFile._open's test of a Lut: whether it is grey, with PIL's
    IndexError (Image.open's next plugin) where a short one is read past
    its end. (PIL also tests a grey Lut for linearity, only to store it.)"""
    grey = True
    try:
        for i in range(256):
            if not p[i] == p[i + 256] == p[i + 512]:
                grey = False
    except IndexError:
        raise Unidentified("IM: truncated Lut") from None
    return grey


def decode_im(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of an IM file, as PIL's `convert("RGB")` of
    it."""
    data = bytes(data)
    mode, raw, (w, h), palette, pos = open_im(data)
    if raw in ("RGB;T", "RYB;T"):  # planes G, R, B (PIL's tile order)
        planes = [_rows(data, pos + k * w * h, h, w, w, True) for k in range(3)]
        return np.stack([planes[1], planes[0], planes[2]], -1)
    if raw.startswith("F;") and raw[2:].isdigit() and int(raw[2:]) not in (8, 16, 32):
        return to_rgb("F", _bit_rows(data, pos, w, h, int(raw[2:])))
    if (mode, raw) == ("LA", "PA;L") or raw == "RLB":
        raise DecodeError(f"IM: raw mode {raw} of mode {mode} is one PIL has no unpacker for")
    if raw in _LINE_BANDS:
        bands = _LINE_BANDS[raw]
        rows = _rows(data, pos, h, w * bands, w * bands, True)
        s = rows.reshape(h, bands, w).transpose(0, 2, 1)
        if mode == "LA":
            return to_rgb("L", s[..., 0])
        if mode == "PA":
            return to_rgb("P", s[..., 0], palette)
        if mode == "CMYK":
            return cmyk_to_rgb(s)
        if mode == "YCbCr":
            return ycbcr_to_rgb(s)
        return to_rgb("RGB", s)
    if raw == "RGB":
        return np.ascontiguousarray(_rows(data, pos, h, 3 * w, 3 * w, True).reshape(h, w, 3))
    if raw in ("1", "P;2", "P;4"):
        bits = 1 if raw == "1" else int(raw[2])
        line = (w * bits + 7) // 8
        s = unpack_bits(_rows(data, pos, h, line, line, True), bits, w)
        if raw == "1":
            return to_rgb("1", s * np.uint8(255))
        return to_rgb("P", s, palette256([]))
    if raw in _SAMPLES:
        dt = np.dtype(_SAMPLES[raw])
        rows = _rows(data, pos, h, w * dt.itemsize, w * dt.itemsize, True)
        s = np.ascontiguousarray(rows).view(dt).reshape(h, w)
        if mode == "P":
            return to_rgb("P", s, palette if palette is not None else palette256([]))
        return to_rgb("I" if mode.startswith("I") else mode, s)
    raise DecodeError(f"IM: raw mode {raw} of mode {mode} is one PIL has no unpacker for")


def _bit_rows(data: bytes, pos: int, w: int, h: int, bits: int) -> np.ndarray:
    """PIL's BitDecode.c (fill 3: bytes ORed in above the bits held, samples
    taken from the low end; pad 8; unsigned; bottom row first) -> (h, w)
    float32. A row takes ceil(w * bits / 8) bytes; the bits left over stay
    in the buffer, ORed into the next row's first byte."""
    line = (w * bits + 7) // 8
    rows = _rows(data, pos, h, line, line, False)
    out = np.zeros((h, w), np.float32)
    stale = 0
    weights = (1 << np.arange(bits, dtype=np.int64))
    for y in range(h):
        row = rows[y].copy()
        row[0] |= stale
        bitv = np.unpackbits(row, bitorder="little")
        v = (bitv[:w * bits].reshape(w, bits).astype(np.int64) * weights).sum(1)
        out[h - 1 - y] = v.astype(np.float32)
        rest = bitv[w * bits:]
        stale = int((rest.astype(np.int64) << np.arange(len(rest))).sum())
    return out


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def open_imt(d: bytes):
    """ImtImageFile._open: (width, height, data offset or None where no
    form feed ends the header; PIL then fails to load)."""
    buffer, pos = d[:100], 100
    if b"\n" not in buffer:
        raise Unidentified("not an IM Tools file")
    w = h = 0
    mode, start = None, None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s, pos = d[pos:pos + 1], pos + 1
        if not s:
            break
        if s == b"\x0c":
            start = min(pos, len(d)) - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += d[pos:pos + 100]
            pos += 100
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[:1] == b"*":
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                w = int(v)
            elif k == b"height":
                h = int(v)
        except ValueError:
            raise DecodeError(f"IMT: {k.decode()} {v!r} is not a number") from None
        if k == b"pixel" and v == b"n8":
            mode = "L"
    if mode is None or w <= 0 or h <= 0:
        raise Unidentified("not an IM Tools file")
    _check_size(w, h)
    return w, h, start


def decode_imt(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of an IMT file, as PIL's `convert("RGB")` of
    it: L rows after the form feed."""
    data = bytes(data)
    w, h, start = open_imt(data)
    if start is None:
        raise DecodeError("IMT: no image data (no form feed)")
    return to_rgb("L", _rows(data, start, h, w, w, False))
