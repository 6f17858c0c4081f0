"""PIL's image modes and its `convert("RGB")` from them, for the texture
decoders (utils/image_decode, utils/raster_decode, utils/tiff_decode).

A decoder that follows PIL reads a file's samples into one of PIL's modes,
as PIL's format plugin would (its "rawmode" unpacking: bit depths, byte
orders, palettes), then converts to RGB as `Image.convert("RGB")` does
(Convert.c), which `to_rgb` does here:

  1, L       grey, repeated into three channels ("1" holds 0 or 255);
  LA         the grey channel;
  P, PA      the palette's colour of each index (a palette of 256 entries);
  RGB, RGBA, RGBX
             the first three channels;
  I, I;16    integers clipped to 0-255 (not scaled: 4000 -> 255);
  F          floats through L as Convert.c's f2l: truncated toward 0,
             clipped to 0-255, NaN to 0 (PIL converts F to RGB by way of
             L, its base mode);
  CMYK       Convert.c cmyk2rgb: nk = 255 - K, each channel
             nk - MULDIV255(C, nk) in integers;
  LAB        not Convert.c: Image.convert hands LAB to littleCMS
             (ImageCms: the built-in Lab profile, D50, to the built-in
             sRGB, perceptual, 8 bits in and out), and PIL stores a and b
             as signed bytes, so littleCMS reads each a, b byte with its top
             bit flipped. littleCMS optimises an 8-bit transform from Lab
             into a 33-point 16-bit grid (its float pipeline: Lab -> XYZ,
             the sRGB profile's Bradford-adapted inverse matrix, the
             inverse sRGB curve) read by its 16-bit tetrahedral
             interpolation; `lab_to_rgb` does the same, and equals PIL on
             all 2**24 inputs.

Within `band_reads()` (an IPTC band's image, which PIL's Image.merge reads
as its one band's raw samples) `to_rgb` records each mode it converts from
with its samples.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import numpy as np


def unpack_bits(rows, depth: int, width: int) -> np.ndarray:
    """(h, n) uint8 rows of samples packed `depth` (1, 2 or 4) bits each,
    first sample in the high bits -> (h, width) uint8 sample values."""
    rows = np.asarray(rows, np.uint8)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth].reshape(rows.shape[0], width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)


def scale_bits(s, depth: int) -> np.ndarray:
    """Samples of 1, 2 or 4 bits scaled to 0-255 as PIL's L;1/L;2/L;4
    unpackers scale them (x 255, 85, 17)."""
    return (np.asarray(s, np.uint8) * (255 // ((1 << depth) - 1))).astype(np.uint8)


def five_bits(v) -> np.ndarray:
    """The low 5 bits of v to 8 bits as PIL's BGR;15 unpackers do:
    v * 255 // 31."""
    return ((np.asarray(v, np.int64) & 31) * 255 // 31).astype(np.uint8)


def palette256(entries) -> np.ndarray:
    """(256, 3) uint8: the palette's first 256 (r, g, b) entries, black past
    its end."""
    entries = np.asarray(entries, np.uint8).reshape(-1, 3)[:256]
    pal = np.zeros((256, 3), np.uint8)
    pal[:entries.shape[0]] = entries
    return pal


def cmyk_to_rgb(cmyk) -> np.ndarray:
    """(..., 4) uint8 CMYK -> (..., 3) uint8 RGB, Convert.c cmyk2rgb."""
    c = np.asarray(cmyk, np.int64)
    nk = 255 - c[..., 3:4]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


_LAB_GRID = 33


def _srgb_from_xyz() -> np.ndarray:
    """littleCMS's sRGB output matrix: its RGB -> XYZ matrix from the
    Rec. 709 primaries and D65, adapted to D50 by Bradford, inverted and
    scaled by MAX_ENCODEABLE_XYZ (the pipeline's XYZ is divided by it)."""
    white = np.array([0.3127 / 0.3290, 1.0, (1 - 0.3127 - 0.3290) / 0.3290])
    xy = np.array([(0.64, 0.33), (0.30, 0.60), (0.15, 0.06)])
    prim = np.stack([xy[:, 0], xy[:, 1], 1 - xy[:, 0] - xy[:, 1]])
    rgb_to_xyz = prim * (np.linalg.inv(prim) @ white)[None, :]
    bradford = np.array([[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367],
                         [0.0389, -0.0685, 1.0296]])
    cone = np.diag((bradford @ _D50) / (bradford @ white))
    adapt = np.linalg.inv(bradford) @ (cone @ bradford)
    return np.linalg.inv(adapt @ rgb_to_xyz) * _MAX_XYZ


_D50 = np.array([0.9642, 1.0, 0.8249])
_MAX_XYZ = 1.0 + 32767.0 / 32768.0


def _lab_pipeline(words) -> np.ndarray:
    """littleCMS's 16-bit evaluation of the Lab -> sRGB float pipeline:
    (n, 3) 16-bit Lab (v4 encoding) -> (n, 3) 16-bit RGB; float32 between
    stages, float64 within them."""
    f = (np.asarray(words).astype(np.float32) / np.float32(65535.0)).astype(np.float64)
    y = (f[:, 0] * 100.0 + 16.0) / 116.0
    t = np.stack([y + 0.002 * (f[:, 1] * 255.0 - 128.0), y, y - 0.005 * (f[:, 2] * 255.0 - 128.0)],
                 -1)
    xyz = np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t) * _D50
    xyz = (xyz / _MAX_XYZ).astype(np.float32).astype(np.float64)
    lin = (xyz @ _srgb_from_xyz().T).astype(np.float32).astype(np.float64)
    g, a, b, c, d = 2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045  # sRGB, type 4
    with np.errstate(invalid="ignore"):
        hi = (np.power(np.maximum(lin, 0.0), 1.0 / g) - b) / a
    out = np.where(lin >= (a * d + b) ** g, hi, lin / c).astype(np.float32).astype(np.float64)
    return np.clip(np.floor(out * 65535.0 + 0.5), 0, 65535).astype(np.int64)


@functools.cache
def _lab_grid() -> np.ndarray:
    """littleCMS's optimised transform: the pipeline at the 33^3 grid's
    nodes, (33, 33, 33, 3) 16-bit values, read-only."""
    n = _LAB_GRID
    nodes = np.floor(np.arange(n) * 65535.0 / (n - 1) + 0.5).astype(np.int64)
    grid = np.stack(np.meshgrid(nodes, nodes, nodes, indexing="ij"), -1).reshape(-1, 3)
    table = _lab_pipeline(grid).reshape(n, n, n, 3)
    table.flags.writeable = False
    return table


def lab_to_rgb(lab) -> np.ndarray:
    """(..., 3) uint8 PIL LAB samples (a and b signed) -> (..., 3) uint8 RGB,
    as PIL's convert("RGB") (littleCMS; module docstring)."""
    n, table = _LAB_GRID, _lab_grid()
    lab = np.asarray(lab, np.uint8)
    shape = lab.shape
    words = (lab.reshape(-1, 3).astype(np.int64) ^ [0, 0x80, 0x80]) * 257
    # TetrahedralInterp16: fixed-point cell and fractions, the cell's
    # corners visited from the largest fraction down
    fixed = words * (n - 1)
    fixed = fixed + (fixed + 0x7FFF) // 0xFFFF
    lo, frac = fixed >> 16, fixed & 0xFFFF
    hi = np.where(words == 0xFFFF, lo, lo + 1)
    rows = np.arange(words.shape[0])
    order = np.argsort(-frac, axis=1, kind="stable")
    corner = lo.copy()
    prev = first = table[lo[:, 0], lo[:, 1], lo[:, 2]]
    rest = np.full(first.shape, 0x8001, np.int64)
    for step in range(3):
        k = order[:, step]
        corner[rows, k] = hi[rows, k]
        value = table[corner[:, 0], corner[:, 1], corner[:, 2]]
        rest += (value - prev) * frac[rows, k][:, None]
        prev = value
    out = (first + ((rest + (rest >> 16)) >> 16)) & 0xFFFF
    return (((out * 65281 + 8388608) >> 24) & 0xFF).astype(np.uint8).reshape(shape)


# ConvertYCbCr.c's tables (SCALE 6): per Cr the red offset and per Cb the
# blue offset, both already shifted down, then the green tables per Cb and
# per Cr, summed before the shift; int16 little-endian, in that order. The
# green tables are one solution of the constraints PIL's output puts on
# them (the pair's sum shifted, for every (Cb, Cr)); ycbcr_to_rgb equals
# PIL's convert("RGB") from YCbCr on all 2**24 inputs.
_YCBCR_TABLES = (
    "TP9N/0//UP9S/1P/VP9W/1f/Wf9a/1v/Xf9e/2D/Yf9i/2T/Zf9n/2j/av9r/2z/bv9v/3H/cv9z"
    "/3X/dv94/3n/ev98/33/f/+A/4H/g/+E/4b/h/+I/4r/i/+N/47/j/+R/5L/lP+V/5b/mP+Z/5v/"
    "nP+d/5//oP+i/6P/pP+m/6f/qf+q/6v/rf+u/7D/sf+y/7T/tf+3/7j/uf+7/7z/vv+//8D/wv/D"
    "/8X/xv/H/8n/yv/M/83/zv/Q/9H/0//U/9X/1//Y/9r/2//c/97/3//h/+L/4//l/+b/6P/p/+r/"
    "7P/t/+//8P/y//P/9P/2//f/+f/6//v//f/+/wAAAQACAAQABQAHAAgACQALAAwADgAPABAAEgAT"
    "ABUAFgAXABkAGgAcAB0AHgAgACEAIwAkACUAJwAoACoAKwAsAC4ALwAxADIAMwA1ADYAOAA5ADoA"
    "PAA9AD8AQABBAEMARABGAEcASABKAEsATQBOAE8AUQBSAFQAVQBWAFgAWQBbAFwAXQBfAGAAYgBj"
    "AGQAZgBnAGkAagBrAG0AbgBwAHEAcgB0AHUAdwB4AHkAewB8AH4AfwCAAIIAgwCFAIYAiACJAIoA"
    "jACNAI8AkACRAJMAlACWAJcAmACaAJsAnQCeAJ8AoQCiAKQApQCmAKgAqQCrAKwArQCvALAAsgAd"
    "/x7/IP8i/yT/Jv8n/yn/K/8t/y7/MP8y/zT/Nv83/zn/O/89/z7/QP9C/0T/Rf9H/0n/S/9N/07/"
    "UP9S/1T/Vf9X/1n/W/9c/17/YP9i/2T/Zf9n/2n/a/9s/27/cP9y/3T/df93/3n/e/98/37/gP+C"
    "/4P/hf+H/4n/i/+M/47/kP+S/5P/lf+X/5n/m/+c/57/oP+i/6P/pf+n/6n/qv+s/67/sP+y/7P/"
    "tf+3/7n/uv+8/77/wP/C/8P/xf/H/8n/yv/M/87/0P/R/9P/1f/X/9n/2v/c/97/4P/h/+P/5f/n"
    "/+j/6v/s/+7/8P/x//P/9f/3//j/+v/8//7/AAABAAMABQAHAAgACgAMAA4ADwARABMAFQAXABgA"
    "GgAcAB4AHwAhACMAJQAmACgAKgAsAC4ALwAxADMANQA2ADgAOgA8AD4APwBBAEMARQBGAEgASgBM"
    "AE0ATwBRAFMAVQBWAFgAWgBcAF0AXwBhAGMAZQBmAGgAagBsAG0AbwBxAHMAdAB2AHgAegB8AH0A"
    "fwCBAIMAhACGAIgAigCLAI0AjwCRAJMAlACWAJgAmgCbAJ0AnwChAKMApACmAKgAqgCrAK0ArwCx"
    "ALIAtAC2ALgAugC7AL0AvwDBAMIAxADGAMgAygDLAM0AzwDRANIA1ADWANgA2QDbAN0A3wDhAAEL"
    "9wrJCsEKkwqJCn8KUwpJCj0KEwoHCv0J0gnFCb0JkAmFCXwJTglFCToJDgkECfkIzgjCCLkIiwiB"
    "CHgISQhBCDYICQgACNMHyQe+B5MHiAd9B1MHRgc9BxEHBQf9Bs8GxQa7Bo4GhQZ5Bk4GQwY5Bg0G"
    "AQb5BcsFwQW4BYkFgQV2BUkFQAUTBQkF/QTTBMcEvQSSBIUEfQRQBEUEPAQOBAUE+gPOA8QDuQOO"
    "A4IDeQNMA0EDOQMKAwED9wLJAsECkwKJAn8CUwJJAj0CEwIHAv0B0gHFAb0BjwGFAXsBTgFFATkB"
    "DgEDAfkAzQDBALkAiwCBAHgASQBBADYACQAAANP/yf+//5P/if99/1P/R/89/xL/Bf/9/tD+xf68"
    "/o7+hf56/k7+RP45/g3+Af75/cv9wf24/Yn9gf12/Un9QP0T/Qn9/vzT/Mj8vfyT/Ib8ffxR/EX8"
    "PfwP/AX8+/vO+8X7ufuO+4P7eftN+0H7OfsL+wH7+PrJ+sH6k/qJ+n/6U/pJ+j36E/oH+v350vnF"
    "+b35kPmF+Xz5TvlF+Tr5DvkE+fn4zvjC+Ln4jPiB+Hn4SvhB+Df4CfgB+NP3yfe/95P3ifd991P3"
    "Rvc99xH3Bff99s/2xfa79o72hfZ59k72Q/Y59g32Afb59cv1wfW49Yn1gfV29Un1QPUT9Qn17Ra3"
    "Fn8WRxYyFvsVwxWtFXcVPxUHFfIUuxSDFG0UNxT/E8cTsxN7E0MTLRP3Er8ShxJzEjsSAxLtEbcR"
    "fxFHETMR+xDDEK4QdxA/EAcQ8w+7D4MPbg83D/8OyA6zDnsOQw4uDvcNvw2IDXMNOw0DDe4Mtwx/"
    "DEgMMwz7C8QLrgt3Cz8LCAvzCrsKhApuCjcK/wnICbMJewlECS4J9wjACIgIcwg7CAQI7ge3B4AH"
    "SAczB/sGxAauBncGQAYIBvMFvAWEBW4FNwUABcgEswR8BEQELgT4A8ADiANzAzwDBAPuArgCgAJI"
    "AjMC/AHEAa4BeAFAAQgB9AC8AIQAbgA4AAAAyf+1/33/Rf8v//n+wf6J/nX+Pf4F/vD9uf2B/Un9"
    "Nf39/MX8sPx5/EH8Cfz1+737hftw+zn7AfvK+rX6ffpF+jD6+fnB+Yr5dfk9+Qb58Pi5+IH4Svg1"
    "+P33xvew93n3QfcK9/X2vfaG9nD2OfYC9sr1tfV99Ub1MPX59ML0ivR19D30BvTw87nzgvNK8zXz"
    "/vLG8rDyefJC8gry9fG+8YbxcPE58QLxyvC18H7wRvAw8Prvwu+K73XvPu8G7/Duuu6C7kruNu7+"
    "7cbtsO167ULtCu327L7shuxw7DrsAuzK67brfutG6zHr+urC6orqduo+6gbq8em66YLpbOk=")


@functools.cache
def _ycbcr_tables() -> np.ndarray:
    import base64

    return np.frombuffer(base64.b64decode("".join(_YCBCR_TABLES)), "<i2").reshape(4, 256).astype(
        np.int64)


def ycbcr_to_rgb(ycc) -> np.ndarray:
    """(..., 3) uint8 YCbCr -> (..., 3) uint8 RGB as PIL's
    ImagingConvertYCbCr2RGB (convert("RGB") from YCbCr)."""
    r_cr, b_cb, g_cb, g_cr = _ycbcr_tables()
    ycc = np.asarray(ycc, np.uint8)
    y = ycc[..., 0].astype(np.int64)
    cb, cr = ycc[..., 1], ycc[..., 2]
    rgb = np.stack([y + r_cr[cr], y + ((g_cb[cb] + g_cr[cr]) >> 6), y + b_cb[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


_BAND_READS = contextvars.ContextVar("band_reads", default=None)


@contextlib.contextmanager
def band_reads():
    """Record each (mode, samples) `to_rgb` converts from in the list it
    yields."""
    modes: list = []
    token = _BAND_READS.set(modes)
    try:
        yield modes
    finally:
        _BAND_READS.reset(token)


def to_rgb(mode: str, a, palette=None) -> np.ndarray:
    """(h, w, 3) uint8: PIL's `convert("RGB")` of an image of `mode` whose
    samples are `a`, (h, w) for one band and (h, w, bands) for several;
    `palette` (256, 3) for P and PA."""
    a = np.asarray(a)
    seen = _BAND_READS.get()
    if seen is not None:
        seen.append((mode, a))
    if mode in ("1", "L"):
        grey = a.astype(np.uint8)
    elif mode == "LA":
        grey = a[..., 0].astype(np.uint8)
    elif mode in ("I", "I;16"):
        grey = np.clip(a, 0, 255).astype(np.uint8)
    elif mode == "F":
        v = a.astype(np.float32)
        grey = np.where(v >= 255, 255, np.trunc(np.where(v > 0, v, 0))).astype(np.uint8)
    elif mode in ("P", "PA"):
        return palette[a if mode == "P" else a[..., 0]]
    elif mode in ("RGB", "RGBA", "RGBX"):
        return np.ascontiguousarray(a[..., :3], np.uint8)
    elif mode == "CMYK":
        return cmyk_to_rgb(a)
    elif mode == "LAB":
        return lab_to_rgb(a)
    else:
        raise ValueError(f"no conversion from mode {mode} to RGB")
    return np.repeat(grey[..., None], 3, -1)
