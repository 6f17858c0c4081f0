"""Kodak Photo CD (PCD) texture decoding in numpy, as PIL 12.1.0's
PcdImagePlugin opens a file and its C `pcd` decoder (PcdDecode.c) reads it,
then `convert("RGB")`, byte for byte.

PIL reads only the 768x512 base image: "PCD_" at byte 2048, the
orientation in the low two bits of byte 3586 (1: the image turned 90
degrees counter-clockwise, 3: 270), the image data at 96 * 2048. Each pair
of rows is 3 * 768 bytes: the two rows' luma, then 384 Cb and 384 Cr
samples shared by both rows, each by two columns. PIL's "YCC;P" unpacker
turns each (Y, Cb, Cr) into RGB through its PhotoYCC tables (UnpackYCC.c):
r = L[Y] + CR[Cr], g = L[Y] + GB[Cb] + GR[Cr], b = L[Y] + CB[Cb], each
clipped to 0-255. The tables here were recovered from PIL's output; a
sum's split between two tables is free, the sums are PIL's, and
`ycc_to_rgb` equals PIL's unpacker on all 2**24 inputs. A file short of
the base image is truncated, as in PIL.
"""

from __future__ import annotations

import base64
import functools

import numpy as np

from .image_decode import DecodeError, Unidentified

_WIDTH, _HEIGHT = 768, 512
_DATA = 96 * 2048

# L, CR, CB, GB, GR: 256 int16 little-endian each, in that order
_TABLES = (
    "AAABAAMABAAFAAcACAAKAAsADAAOAA8AEAASABMAFAAWABcAGAAaABsAHQAeAB8AIQAiACMAJQAm"
    "ACcAKQAqACsALQAuADAAMQAyADQANQA2ADgAOQA6ADwAPQA+AEAAQQBDAEQARQBHAEgASQBLAEwA"
    "TQBPAFAAUgBTAFQAVgBXAFgAWgBbAFwAXgBfAGAAYgBjAGUAZgBnAGkAagBrAG0AbgBvAHEAcgBz"
    "AHUAdgB4AHkAegB8AH0AfgCAAIEAggCEAIUAhgCIAIkAiwCMAI0AjwCQAJEAkwCUAJUAlwCYAJkA"
    "mwCcAJ4AnwCgAKIAowCkAKYApwCoAKoAqwCtAK4ArwCxALIAswC1ALYAtwC5ALoAuwC9AL4AwADB"
    "AMIAxADFAMYAyADJAMoAzADNAM4A0ADRANMA1ADVANcA2ADZANsA3ADdAN8A4ADhAOMA5ADmAOcA"
    "6ADqAOsA7ADuAO8A8ADyAPMA9QD2APcA+QD6APsA/QD+AP8AAQECAQMBBQEGAQgBCQEKAQwBDQEO"
    "ARABEQESARQBFQEWARgBGQEbARwBHQEfASABIQEjASQBJQEnASgBKQErASwBLgEvATABMgEzATQB"
    "NgE3ATgBOgE7AT0BPgE/AUEBQgFDAUUBRgFHAUkBSgFLAU0BTgFQAVEBUgFUAVUBVgFYAVkBWgEH"
    "/wn/C/8N/w//Ef8S/xT/Fv8Y/xr/G/8d/x//If8j/yX/Jv8o/yr/LP8u/zD/Mf8z/zX/N/85/zr/"
    "PP8+/0D/Qv9E/0X/R/9J/0v/Tf9O/1D/Uv9U/1b/WP9Z/1v/Xf9f/2H/Y/9k/2b/aP9q/2z/bf9v"
    "/3H/c/91/3f/eP96/3z/fv+A/4H/g/+F/4f/if+L/4z/jv+Q/5L/lP+W/5f/mf+b/53/n/+g/6L/"
    "pP+m/6j/qv+r/63/r/+x/7P/tP+2/7j/uv+8/77/v//B/8P/xf/H/8n/yv/M/87/0P/S/9P/1f/X"
    "/9n/2//d/97/4P/i/+T/5v/n/+n/6//t/+//8f/y//T/9v/4//r//P/9////AAACAAQABQAHAAkA"
    "CwANAA8AEAASABQAFgAYABoAGwAdAB8AIQAjACQAJgAoACoALAAuAC8AMQAzADUANwA4ADoAPAA+"
    "AEAAQgBDAEUARwBJAEsATQBOAFAAUgBUAFYAVwBZAFsAXQBfAGEAYgBkAGYAaABqAGsAbQBvAHEA"
    "cwB1AHYAeAB6AHwAfgCAAIEAgwCFAIcAiQCKAIwAjgCQAJIAlACVAJcAmQCbAJ0AngCgAKIApACm"
    "AKgAqQCrAK0ArwCxALMAtAC2ALgAugC8AL0AvwDBAMMAxQDHAMgAygDMAM4A0ADRANMA1QDXAKf+"
    "qf6r/q7+sP6y/rT+t/65/rv+vf6//sL+xP7G/sj+yv7N/s/+0f7T/tb+2P7a/tz+3v7h/uP+5f7n"
    "/ur+7P7u/vD+8v71/vf++f77/v7+AP8C/wT/Bv8J/wv/Df8P/xH/FP8W/xj/Gv8d/x//If8j/yX/"
    "KP8q/yz/Lv8x/zP/Nf83/zn/PP8+/0D/Qv9E/0f/Sf9L/03/UP9S/1T/Vv9Y/1v/Xf9f/2H/ZP9m"
    "/2j/av9s/2//cf9z/3X/d/96/3z/fv+A/4P/hf+H/4n/i/+O/5D/kv+U/5f/mf+b/53/n/+i/6T/"
    "pv+o/6v/rf+v/7H/s/+2/7j/uv+8/77/wf/D/8X/x//K/8z/zv/Q/9L/1f/X/9n/2//e/+D/4v/k"
    "/+b/6f/r/+3/7//x//T/9v/4//r//f///wAAAgAEAAcACQALAA0AEAASABQAFgAYABsAHQAfACEA"
    "IwAmACgAKgAsAC8AMQAzADUANwA6ADwAPgBAAEMARQBHAEkASwBOAFAAUgBUAFYAWQBbAF0AXwBi"
    "AGQAZgBoAGoAbQBvAHEAcwB2AHgAegB8AH4AgQCDAIUAhwCKAIwAjgCQAJIAlQCXAJkAmwCdAKAA"
    "ogCkAKYAqQCrAK0ArwCxALQAtgC4ALoAvQC/AMEAwwDFAMgAygDMAM4A0ADTANUA1wDZANwANwA3"
    "ADYANgA1ADUANQA0ADQAMwAzADIAMgAyADEAMQAwADAALwAvAC8ALgAuAC0ALQAsACwALAArACsA"
    "KgAqACkAKQAoACgAKAAnACcAJgAmACUAJQAlACQAJAAjACMAIgAiACIAIQAhACAAIAAfAB8AHwAe"
    "AB4AHQAdABwAHAAcABsAGwAaABoAGQAZABkAGAAYABcAFwAWABYAFgAVABUAFAAUABMAEwATABIA"
    "EgARABEAEAAQABAADwAPAA4ADgANAA0ADQAMAAwACwALAAoACgAKAAkACQAIAAgABwAHAAcABgAG"
    "AAUABQAEAAQAAwADAAMAAgACAAEAAQAAAAAAAAD//////v/+//3//f/9//z//P/7//v/+v/6//r/"
    "+f/5//j/+P/3//f/9//2//b/9f/1//T/9P/0//T/9P/z//P/8v/y//L/8f/x//D/8P/v/+//7//u"
    "/+7/7f/t/+z/7P/s/+v/6//q/+r/6f/p/+n/6P/o/+f/5//m/+b/5v/l/+X/5P/k/+P/4//i/+L/"
    "4v/h/+H/4P/g/9//3//f/97/3v/d/93/3P/c/9z/2//b/9r/2v/Z/9n/2f/Y/9j/1//X/9b/1v/W"
    "/9X/1f/U/9T/0//T/9P/0v/S/9H/0f/Q/9D/0P/P/8//zv/O/83/zf/N/8z/zP/L/8v/yv+LAIoA"
    "iQCIAIcAhgCFAIUAhACDAIIAgQCAAH8AfgB9AHwAewB6AHkAeAB4AHcAdgB1AHQAcwByAHEAcABv"
    "AG4AbQBsAGsAawBqAGkAaABnAGYAZQBkAGMAYgBhAGAAXwBfAF4AXQBcAFsAWgBZAFgAVwBWAFUA"
    "VABTAFIAUgBRAFAATwBOAE0ATABLAEoASQBIAEcARgBFAEUARABDAEIAQQBAAD8APgA9ADwAOwA6"
    "ADkAOQA4ADcANgA1ADQAMwAyADEAMAAvAC4ALQAsACwAKwAqACkAKAAnACYAJQAkACMAIgAhACAA"
    "HwAfAB4AHQAcABsAGgAZABgAFwAWABUAFAATABIAEgARABAADwAOAA0ADAAMAAsACgAJAAgABwAH"
    "AAYABQAEAAMAAgABAAAA///+//3//P/7//r/+v/5//j/9//2//X/9P/z//L/8f/w/+//7v/t/+3/"
    "7P/r/+r/6f/o/+f/5v/l/+T/4//i/+H/4P/g/9//3v/d/9z/2//a/9n/2P/X/9b/1f/U/9T/0//S"
    "/9H/0P/P/87/zf/M/8v/yv/J/8j/x//H/8b/xf/E/8P/wv/B/8D/v/++/73/vP+7/7r/uv+5/7j/"
    "t/+2/7X/tP+z/7L/sf+w/6//rv+u/63/rP+r/6r/qf+o/6f/pv+l/6T/o/+i/6H/of+g/w==")


@functools.cache
def _tables() -> np.ndarray:
    return np.frombuffer(base64.b64decode("".join(_TABLES)), "<i2").reshape(5, 256).astype(
        np.int64)


def ycc_to_rgb(ycc) -> np.ndarray:
    """(..., 3) uint8 PhotoYCC -> (..., 3) uint8 RGB as PIL's YCC;P
    unpacker."""
    lum, cr_r, cb_b, cb_g, cr_g = _tables()
    ycc = np.asarray(ycc, np.uint8)
    y, cb, cr = lum[ycc[..., 0]], ycc[..., 1], ycc[..., 2]
    rgb = np.stack([y + cr_r[cr], y + cb_g[cb] + cr_g[cr], y + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def open_pcd(d: bytes) -> int:
    """PcdImageFile._open: the orientation (0-3)."""
    if d[2048:2052] != b"PCD_" or len(d) < 2048 + 1539:
        raise Unidentified("not a PCD file")
    return d[2048 + 1538] & 3


def decode_pcd(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a Photo CD file's base image, as PIL's
    `convert("RGB")` of it."""
    data = bytes(data)
    orientation = open_pcd(data)
    need = _HEIGHT // 2 * 3 * _WIDTH
    if _DATA + need > len(data):
        raise DecodeError("PCD: image file is truncated")
    pairs = np.frombuffer(data, np.uint8, need, _DATA).reshape(_HEIGHT // 2, 3 * _WIDTH)
    luma = pairs[:, :2 * _WIDTH].reshape(_HEIGHT, _WIDTH)
    half = np.arange(_WIDTH) // 2
    cb = np.repeat(pairs[:, 2 * _WIDTH + half], 2, 0)
    cr = np.repeat(pairs[:, 2 * _WIDTH + _WIDTH // 2 + half], 2, 0)
    rgb = ycc_to_rgb(np.stack([luma, cb, cr], -1))
    if orientation in (1, 3):  # PIL's rotate(90) or rotate(270), expanded
        rgb = np.ascontiguousarray(np.rot90(rgb, 1 if orientation == 1 else 3))
    return rgb
