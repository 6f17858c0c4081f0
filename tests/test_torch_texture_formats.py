"""The port's decoders of the texture formats beyond JPEG and PNG
(utils/raster_decode: PNM, BMP, TGA, GIF; utils/tiff_decode: TIFF), the JPEG
kinds added to utils/image_decode (CMYK, YCCK, Adobe RGB, 3-4x sampling)
and the PIL-mode conversions they share (utils/pil_modes), against PIL, the
JAX package's decoder.

Tolerance 0: every decode equals `np.asarray(Image.open(f).convert("RGB"))`
byte for byte. Files PIL writes, in each mode it writes for each format,
and files built here for what PIL does not write (tests/torch_textures/
make_fixtures.py's builders: plain PNM, RLE and bitfield BMPs, TGA colour
maps and RLE packets across rows, GIF local palettes and LZW past a full
table, TIFF tiles, planar samples, big-endian, fill order 2 and predictor
2, JPEG YCCK and 3x1/4x2 sampling). The format is told as Image.open tells
it. Truncated and corrupt files of each decoder, and the kinds still
refused, raise TextureError with the atlas untouched. A DSL scene with a
texture of each new format builds to the JAX package's texture arrays.
"""

import importlib.util
import io
import json
import pathlib
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from torch_textures.make_fixtures import (bmp_file, bmp_rle, bmp_rows, gif_file, jpeg_adobe,
                                          jpeg_sampled, lzw_gif, tga_file, tga_packets,
                                          tiff_file)

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch.models import texture
from relativitypathtracer_tpu_torch.models.texture import TextureError, decode_texture, read_texture
from relativitypathtracer_tpu_torch.utils import misc_raster, pil_modes
from relativitypathtracer_tpu_torch.utils.demo_scene import demo_texture, write_demo_scene
from relativitypathtracer_tpu_torch.utils.raster_decode import tga_header_ok

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "torch_textures"


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _equal_to_pil(data: bytes) -> None:
    want = _pil(data)
    got = decode_texture(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), f"{int((got != want).sum())} values differ"


def _picture(seed: int, w: int, h: int) -> np.ndarray:
    """(h, w, 3) uint8: gradients and edges under seeded noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 7 + y * 3, x * x // 3 + y, (y * 11) ^ (x * 5)], -1) % 256
    return np.clip(base + rng.integers(-30, 30, (h, w, 3)), 0, 255).astype(np.uint8)


def _save(im, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _image(mode: str, w: int, h: int):
    rgb = Image.fromarray(_picture(w * 31 + h, w, h))
    rng = np.random.default_rng(w + h)
    if mode == "P":
        return rgb.quantize(13)
    if mode == "PA":
        return rgb.quantize(13).convert("PA")
    if mode == "I;16":
        return Image.fromarray(rng.integers(0, 1000, (h, w)).astype(np.uint16))
    if mode == "CMYK":
        return Image.fromarray(rng.integers(0, 256, (h, w, 4)).astype(np.uint8), "CMYK")
    return rgb.convert(mode)


# --- PIL's mode conversions -------------------------------------------------

@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "PA", "RGBA", "I", "I;16", "CMYK"])
def test_pil_modes_convert_as_pil(mode):
    """pil_modes.to_rgb against Image.convert("RGB") over every value a
    mode's samples take (CMYK over all 65,536 (C, K) pairs)."""
    rng = np.random.default_rng(len(mode))
    palette = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    if mode == "CMYK":
        c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
        a = np.stack([c, 255 - c, c // 3, k], -1).astype(np.uint8)
        im = Image.fromarray(a, "CMYK")
    elif mode in ("I", "I;16"):
        a = np.arange(-300 if mode == "I" else 0, 70000).reshape(1, -1)
        a = a[:, :65536] if mode == "I;16" else a
        raw = a.astype("<u2" if mode == "I;16" else "<i4").tobytes()
        im = Image.frombytes(mode, (a.shape[1], 1), raw, "raw", "I;16" if mode == "I;16" else "I")
    else:
        bands = {"1": 1, "L": 1, "P": 1, "LA": 2, "PA": 2, "RGBA": 4}[mode]
        a = rng.integers(0, 256, (16, 64, bands)).astype(np.uint8)
        if mode == "1":
            a = a // 128 * 255
        a = a[..., 0] if bands == 1 else a
        im = Image.frombytes(mode, (64, 16), a.tobytes(), "raw",
                             {"1": "1;8"}.get(mode, mode))
        if mode in ("P", "PA"):
            im.putpalette(palette.tobytes())
    got = pil_modes.to_rgb(mode, a, palette if mode in ("P", "PA") else None)
    assert np.array_equal(got, np.asarray(im.convert("RGB")))


# --- files PIL writes -------------------------------------------------------

PIL_WRITTEN = [("PPM", m, {}) for m in ("1", "L", "RGB", "I;16")]
PIL_WRITTEN += [("BMP", m, {}) for m in ("1", "L", "P", "RGB", "RGBA")]
PIL_WRITTEN += [("TGA", m, {"rle": rle, "orientation": o}) for m in ("1", "L", "LA", "P", "RGB",
                                                                     "RGBA")
                for rle in (False, True) for o in (-1, 1) if not (m == "1" and rle)]
PIL_WRITTEN += [("GIF", m, kw) for m in ("P", "L", "RGB") for kw in ({}, {"transparency": 2},
                                                                     {"interlace": False})]
PIL_WRITTEN += [("TIFF", m, {"compression": c}) for m in ("1", "L", "LA", "P", "PA", "RGB",
                                                          "RGBA", "CMYK", "I;16")
                for c in ("raw", "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "packbits")]
PIL_WRITTEN += [("TIFF", m, {"compression": c, "tiffinfo": {317: 2}})
                for m in ("L", "RGB", "RGBA", "CMYK", "I;16")
                for c in ("tiff_lzw", "tiff_adobe_deflate")]
PIL_WRITTEN += [("TIFF", "RGB", {"tiffinfo": {274: o}}) for o in range(2, 9)]
PIL_WRITTEN += [("TIFF", "RGB", {"compression": "tiff_lzw", "tiffinfo": {274: 6, 278: 5}})]
PIL_WRITTEN += [("TIFF", "RGB", {"tiffinfo": {278: 4}})]


@pytest.mark.parametrize("fmt,mode,kw", PIL_WRITTEN,
                         ids=lambda v: "-".join(f"{k}{w}" for k, w in v.items())
                         if isinstance(v, dict) else str(v))
def test_pil_written_files_decode_as_pil(fmt, mode, kw):
    """Each mode PIL writes in each format, at 1x1, 7x5 and 33x17 (PIL's
    GIFs interlace from 16 rows)."""
    for w, h in ((1, 1), (7, 5), (33, 17)):
        data = _save(_image(mode, w, h), fmt, **kw)
        with Image.open(io.BytesIO(data)) as im:
            assert im.format == fmt
        _equal_to_pil(data)


# --- hand-built files ---------------------------------------------------------

def _pnm_cases():
    rng = np.random.default_rng(1)
    cases = {}
    for magic in (b"P2", b"P3", b"P5", b"P6"):
        for maxval in (1, 7, 100, 256, 1000, 65534, 65535):
            bands = 3 if magic in (b"P3", b"P6") else 1
            v = rng.integers(0, maxval + 1, 9 * 4 * bands)
            if magic in (b"P2", b"P3"):
                body = b" ".join(b"%d" % x for x in v).replace(b" ", b"\n# comment\n", 3)
            else:
                body = v.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
            cases[f"{magic.decode()}_maxval{maxval}"] = (magic + b" #c\n9 4\n%d\n" % maxval
                                                         + body)
    bits = rng.integers(0, 2, 30)
    cases["P1_comments"] = (b"P1\n6 5\n" + b"".join(b"%d" % x for x in bits[:15]) + b"\n#c\n"
                            + b" ".join(b"%d" % x for x in bits[15:]))
    cases["P5_comment_inside_a_field"] = b"P5\n1#x\n0 2 255\n" + bytes(range(20))
    cases["P2_comment_glued"] = b"P2 2 1 65535\n12#c\n34 7"
    cases["P2_trailing_field"] = b"P2 2 1 10\n5 1 3x"
    cases["P2_plus_sign"] = b"P2 2 1 10\n+5 0010"
    cases["P6_crlf"] = b"P6\r\n2 1\r\n255\r\n" + bytes(range(6))
    return cases


PNM_CASES = _pnm_cases()


@pytest.mark.parametrize("case", sorted(PNM_CASES))
def test_hand_built_pnm_decodes_as_pil(case):
    """Plain and binary PNM at maxvals PIL rescales (with Python's round;
    16-bit grey clips at 255), comments anywhere, fields PIL parses with
    int()."""
    _equal_to_pil(PNM_CASES[case])


def _bmp_cases():
    rng = np.random.default_rng(2)
    w, h, cases = 13, 6, {}
    for bits in (1, 4, 8):
        pal = [tuple(int(c) for c in rng.integers(0, 256, 3)) for _ in range(1 << bits)]
        rows = bmp_rows(rng.integers(0, 1 << bits, (h, w)), bits)
        for header in (12, 40, 56, 108, 124):
            cases[f"P{bits}_header{header}"] = bmp_file(w, h, bits, rows, pal, header=header)
        top = bmp_rows(rng.integers(0, 1 << bits, (h, w))[::-1], bits)
        cases[f"P{bits}_top_down"] = bmp_file(w, h, bits, top, pal, top_down=True)
        cases[f"P{bits}_short_palette"] = bmp_file(w, h, bits, rows, pal[:3], colors=3)
    px = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    for bits in (16, 24, 32):
        rows = bmp_rows(px[..., :bits // 8], bits)
        for header in (12, 40, 124):
            cases[f"raw{bits}_header{header}"] = bmp_file(w, h, bits, rows, header=header)
    for bits, masks in ((16, (0xF800, 0x7E0, 0x1F, 0)), (16, (0x7C00, 0x3E0, 0x1F, 0)),
                        (24, (0xFF0000, 0xFF00, 0xFF, 0)), (32, (0xFF0000, 0xFF00, 0xFF, 0)),
                        (32, (0xFF000000, 0xFF0000, 0xFF00, 0)),
                        (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
                        (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)), (32, (0, 0, 0, 0))):
        for header in (56, 124) if masks[3] else (40, 52, 124):  # 40, 52: no alpha mask
            cases[f"bitfields{bits}_{masks[0]:x}_header{header}"] = bmp_file(
                w, h, bits, bmp_rows(px[..., :bits // 8], bits), compression=3, header=header,
                masks=masks)
    pal = [tuple(int(c) for c in rng.integers(0, 256, 3)) for _ in range(16)]
    idx = (np.add.outer(np.arange(h), np.arange(w) // 3) % 5).astype(np.uint8)
    idx[::2, ::4] = rng.integers(0, 16, idx[::2, ::4].shape)
    for rle4 in (False, True):
        name, comp, bits = ("rle4", 2, 4) if rle4 else ("rle8", 1, 8)
        cases[name] = bmp_file(w, h, bits, bmp_rle(idx, rle4), pal, compression=comp)
        # PIL's quirks: a delta's two ignored bytes, an end of bitmap before the
        # last row, runs past the row's end, an odd absolute run
        cases[f"{name}_delta"] = bmp_file(w, h, bits, bytes([3, 5, 0, 2, 9, 9, 2, 1, 0, 0])
                                          + bytes([w, 1, 0, 0]) * (h - 2) + b"\0\1", pal,
                                          compression=comp)
        cases[f"{name}_long_runs"] = bmp_file(w, h, bits, bytes([200, 5, 0, 0]) * h, pal,
                                              compression=comp)
        # an absolute run of 9 (RLE4 reads 4 bytes, 8 pixels) that ends on an
        # odd file offset (RLE8: a byte skipped), the row ended, then full rows
        data = bytes(range(4)) if rle4 else bytes(range(9)) + b"\0"
        cases[f"{name}_odd_absolute"] = bmp_file(w, h, bits, bytes([0, 9]) + data + b"\0\0"
                                                 + bytes([w, 5, 0, 0]) * (h - 1) + b"\0\1", pal,
                                                 compression=comp)
    grey = [(i, i, i) for i in range(256)]
    cases["grey_palette_drops"] = bmp_file(w, h, 8, bmp_rows(idx, 8), grey)
    dib = _save(Image.fromarray(_picture(4, 9, 7)).quantize(5), "DIB")
    cases["dib"] = dib
    return cases


BMP_CASES = _bmp_cases()


@pytest.mark.parametrize("case", sorted(BMP_CASES))
def test_hand_built_bmp_decodes_as_pil(case):
    """1/4/8-bit palettes under every header PIL reads (OS/2's 3-byte
    entries), bottom-up and top-down, short palettes, 16/24/32 bits raw and
    in PIL's bitfield layouts, RLE8 and RLE4 with PIL's quirks, a grey
    palette PIL drops, a headerless DIB."""
    _equal_to_pil(BMP_CASES[case])


def _tga_cases():
    rng = np.random.default_rng(3)
    w, h, cases = 11, 4, {}
    px16 = rng.integers(0, 65536, (h, w)).astype("<u2").tobytes()
    for flags in (0, 0x10, 0x20, 0x30):
        cases[f"rgb15_flags{flags:x}"] = tga_file(w, h, 2, 16, px16, flags, id_text=b"id")
        cases[f"rgb24_flags{flags:x}"] = tga_file(w, h, 2, 24, rng.integers(
            0, 256, w * h * 3).astype(np.uint8).tobytes(), flags)
    for map_bits in (16, 24):
        for start in (0, 3):
            entries = [rng.integers(0, 256, map_bits // 8).astype(np.uint8).tobytes()
                       for _ in range(20)]
            idx = rng.integers(0, 40, w * h).astype(np.uint8).tobytes()
            cases[f"cmap{map_bits}_start{start}"] = tga_file(w, h, 1, 8, idx, 0x20,
                                                             cmap=(start, entries, map_bits))
            cases[f"cmap{map_bits}_start{start}_rle"] = tga_file(
                w, h, 9, 8, tga_packets([bytes([i % 40]) for i in range(w * h)],
                                        [(False, 20), (True, 2), (False, w * h - 22)]),
                0, cmap=(start, entries, map_bits))
    pixels = [bytes([i, 2 * i % 256, 3]) for i in range(w * h)]
    runs = [(True, 7), (False, 20), (True, 6), (False, w)]
    cases["rle_literal_across_rows"] = tga_file(w, h, 10, 24, tga_packets(pixels, runs))
    cases["rle_extra_data"] = tga_file(w, h, 10, 24, tga_packets(pixels, runs) + bytes(50))
    cases["la16"] = tga_file(w, h, 3, 16, rng.integers(0, 256, w * h * 2).astype(np.uint8)
                             .tobytes())
    return cases


TGA_CASES = _tga_cases()


@pytest.mark.parametrize("case", sorted(TGA_CASES))
def test_hand_built_tga_decodes_as_pil(case):
    """16-bit (5-5-5) and 24-bit truecolour under the four orientations,
    16- and 24-bit colour maps from a first index, RLE (a literal packet
    across rows, data past the image), grey and alpha."""
    _equal_to_pil(TGA_CASES[case])


def _gif_cases():
    rng = np.random.default_rng(4)
    w, h, cases = 30, 20, {}

    def pal(n):
        return rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes()

    for size in (2, 3, 5, 8):
        idx = rng.integers(0, 1 << size, w * h).astype(np.uint8)
        idx[:200] %= 2  # runs, for the table's strings
        data = lzw_gif(idx, size)
        cases[f"global_palette_size{size}"] = gif_file(w, h, [(0, 0, w, h, None, False, size,
                                                               data, None)], pal(1 << size))
        cases[f"local_palette_size{size}"] = gif_file(w, h, [(0, 0, w, h, pal(1 << size), True,
                                                              size, data, None)], pal(4))
        cases[f"short_palette_size{size}"] = gif_file(w, h, [(0, 0, w, h, None, False, size,
                                                              data, None)], pal(2))
        cases[f"no_palette_size{size}"] = gif_file(w, h, [(0, 0, w, h, None, False, size, data,
                                                           None)])
    ident = bytes(np.repeat(np.arange(16), 3).astype(np.uint8))
    idx = rng.integers(0, 16, w * h).astype(np.uint8)
    cases["identity_palette"] = gif_file(w, h, [(0, 0, w, h, None, False, 4, lzw_gif(idx, 4),
                                                 None)], ident)
    cases["identity_local_palette"] = gif_file(w, h, [(0, 0, w, h, ident, False, 4,
                                                       lzw_gif(idx, 4), None)], pal(16))
    sub = rng.integers(0, 16, 10 * 7).astype(np.uint8)
    for transparent in (None, 9):
        cases[f"sub_rect_transparent{transparent}"] = gif_file(
            w, h, [(5, 3, 10, 7, None, False, 4, lzw_gif(sub, 4), transparent)], pal(16))
    cases["frame_past_the_screen"] = gif_file(8, 8, [(5, 3, 10, 7, None, True, 4,
                                                      lzw_gif(sub, 4), 3)], pal(16))
    big = rng.integers(0, 256, 150 * 100).astype(np.uint8)
    for clear in (False, True):
        cases[f"full_table_clear{clear}"] = gif_file(150, 100, [(0, 0, 150, 100, None, False, 8,
                                                                 lzw_gif(big, 8, clear), None)],
                                                     pal(256))
    frames = [Image.fromarray(_picture(k, 20, 20)).quantize(8) for k in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], duration=100, loop=0)
    cases["animated_first_frame"] = buf.getvalue()
    return cases


GIF_CASES = _gif_cases()


@pytest.mark.parametrize("case", sorted(GIF_CASES))
def test_hand_built_gif_decodes_as_pil(case):
    """LZW at code sizes 2-8, global and local palettes (PIL keeps the
    global one where a local one is the identity; no palette is grey),
    palettes shorter than the indices, a frame smaller than, and past, its
    screen with and without a transparent index, a full table cleared or
    not, an animation's first frame."""
    _equal_to_pil(GIF_CASES[case])


def _tiff_cases():
    rng = np.random.default_rng(5)
    h, w, cases = 13, 21, {}

    def s(n, bits):
        return rng.integers(0, 1 << bits, (h, w, n)).astype(np.uint16 if bits == 16 else np.uint8)

    cmap = rng.integers(0, 65536, 3 * 256).tolist()
    kinds = {
        "rgb8": dict(samples=s(3, 8), bits=8, photo=2),
        "rgba8": dict(samples=s(4, 8), bits=8, photo=2, extra=(2,)),
        "rgbx8": dict(samples=s(4, 8), bits=8, photo=2, extra=(0,)),
        "rgba8_premultiplied": dict(samples=s(4, 8), bits=8, photo=2, extra=(1,)),
        "rgb16": dict(samples=s(3, 16), bits=16, photo=2),
        "rgba16_premultiplied": dict(samples=s(4, 16), bits=16, photo=2, extra=(1,)),
        "cmyk8": dict(samples=s(4, 8), bits=8, photo=5),
        "cmyk16": dict(samples=s(4, 16), bits=16, photo=5),
        "min_is_white1": dict(samples=s(1, 1), bits=1, photo=0),
        "grey2": dict(samples=s(1, 2), bits=2, photo=1),
        "min_is_white4": dict(samples=s(1, 4), bits=4, photo=0),
        "grey8_signed": dict(samples=s(1, 8), bits=8, photo=1, sample_format=(2,)),
        "grey16": dict(samples=s(1, 16), bits=16, photo=1),
        "grey16_signed": dict(samples=s(1, 16), bits=16, photo=1, sample_format=(2,)),
        "la8": dict(samples=s(2, 8), bits=8, photo=1, extra=(2,)),
        "palette4": dict(samples=s(1, 4), bits=4, photo=3,
                         colormap=cmap[:16] + cmap[256:272] + cmap[512:528]),
        "palette8": dict(samples=s(1, 8), bits=8, photo=3, colormap=cmap),
    }
    layouts = {"strips": dict(rows_per_strip=4), "tiles": dict(tile=(16, 16)),
               "planar_strips": dict(planar=2, rows_per_strip=5),
               "planar_tiles": dict(planar=2, tile=(16, 32))}
    # PIL reads uncompressed planar files only in R, G, B, A or C, M, Y, K
    # planes, and compressed ones with unused planes only in tiles
    raw_planar = {"rgb8", "rgba8", "rgb16", "cmyk8", "cmyk16"}
    for name, kw in kinds.items():
        for lay, extra in layouts.items():
            if "planar" in lay and kw["samples"].shape[2] == 1:
                continue
            comps = [c for c in (1, 5, 8, 32773) if not (
                "planar" in lay and (c == 1 and name not in raw_planar
                                     or c != 1 and lay == "planar_strips" and name == "rgbx8"))]
            cases[f"{name}_{lay}"] = (dict(kw, **extra), comps, "<>")
    for name in ("min_is_white1", "grey2", "min_is_white4", "rgb8", "grey16"):
        # PIL reads 16 bits at fill order 2 little-endian only
        cases[f"{name}_fill_order2"] = (dict(kinds[name], fill=2), [1, 5, 8],
                                        "<" if name == "grey16" else "<>")
    cases["palette4_fill_order2"] = (dict(kinds["palette4"], fill=2), [5, 8], "<>")
    cases["rgb16_orientations"] = (kinds["rgb16"], [8], "<>")
    return cases


TIFF_CASES = _tiff_cases()


@pytest.mark.parametrize("case", sorted(TIFF_CASES))
def test_hand_built_tiff_decodes_as_pil(case):
    """Grey (both photometrics, 1-16 bits, signed), palette, RGB(A/X) and
    CMYK at 8 and 16 bits, premultiplied alpha, in strips and tiles, chunky
    and planar, each uncompressed (PIL's own reading, a predictor left as
    stored), in LZW and Deflate with predictor 2 and in PackBits (through
    libtiff), little- and big-endian; fill order 2; the orientations."""
    kw, comps, endians = TIFF_CASES[case]
    for comp in comps:
        for endian in endians:
            pred = 2 if comp in (5, 8) and kw["bits"] >= 8 else 1
            for orientation in ((3, 5, 8) if "orientations" in case else (None,)):
                _equal_to_pil(tiff_file(**kw, comp=comp, endian=endian, predictor=pred,
                                        orientation=orientation))


def _jpeg_cases():
    rng = np.random.default_rng(6)
    rgb = Image.fromarray(_picture(6, 40, 24))
    cmyk = Image.fromarray(rng.integers(0, 256, (24, 40, 4)).astype(np.uint8), "CMYK")
    cases = {"cmyk": _save(cmyk, "JPEG"), "cmyk_progressive": _save(cmyk, "JPEG",
                                                                     progressive=True),
             "adobe_rgb": jpeg_adobe(_save(rgb, "JPEG", subsampling="4:4:4"), 0),
             "adobe_ycc": jpeg_adobe(_save(rgb, "JPEG"), 1)}
    cases["ycck"] = jpeg_adobe(cases["cmyk"], 2)
    cases["ycck_progressive"] = jpeg_adobe(cases["cmyk_progressive"], 2)
    data = bytearray(_save(rgb, "JPEG", subsampling="4:4:4"))
    sof, sos = data.index(b"\xff\xc0") + 10, data.index(b"\xff\xda") + 5
    data[sof:sof + 7:3] = data[sos:sos + 5:2] = b"RGB"  # ids 1, 2, 3 -> 'R', 'G', 'B'
    j = data.index(b"\xff\xe0")  # and no JFIF segment
    cases["rgb_component_ids"] = bytes(data[:j] + data[j + 2 + int.from_bytes(data[j + 2:j + 4],
                                                                              "big"):])
    for sampling in (b"\x31", b"\x13", b"\x41", b"\x14", b"\x42", b"\x24", b"\x32", b"\x22"):
        for w, h in ((40, 24), (37, 29), (5, 50)):
            name = f"sampling{sampling[0] >> 4}x{sampling[0] & 15}_{w}x{h}"
            cases[name] = jpeg_sampled(rng, w, h, sampling + b"\x11\x11")
    # chroma planes upsampled two ways in one file (fancy and replicated)
    cases["sampling_mixed_4x1_2x1_1x1"] = jpeg_sampled(rng, 37, 29, b"\x41\x21\x11")
    cases["sampling_mixed_2x2_2x1_1x2"] = jpeg_sampled(rng, 37, 29, b"\x22\x21\x12")
    return cases


JPEG_CASES = _jpeg_cases()


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_jpeg_kinds_decode_as_pil(case):
    """4 components (CMYK, and YCCK under Adobe's transform 2; PIL inverts
    both as Adobe's), Adobe RGB and components named 'R', 'G', 'B', and
    luma sampled 3 or 4 times a chroma sample (libjpeg replicates) against
    2x2 (fancy upsampling)."""
    _equal_to_pil(JPEG_CASES[case])


# --- how the format is told ---------------------------------------------------

DECODERS = {"PPM": "decode_pnm", "BMP": "decode_bmp", "DIB": "decode_bmp", "TGA": "decode_tga",
            "GIF": "decode_gif", "TIFF": "decode_tiff", "JPEG": "decode_jpeg",
            "PNG": "decode_png", "WEBP": "decode_webp", "DDS": "decode_dds", "BLP": "decode_blp",
            "FTEX": "decode_ftex", "PSD": "decode_psd", "SGI": "decode_sgi", "PCX": "decode_pcx",
            "DCX": "decode_dcx", "SUN": "decode_sun", "QOI": "decode_qoi", "MSP": "decode_msp",
            "ICO": "decode_ico", "CUR": "decode_cur", "ICNS": "decode_icns", "XBM": "decode_xbm",
            "XPM": "decode_xpm", "JPEG2000": "decode_j2k", "FITS": "decode_fits",
            "FLI": "decode_fli", "IM": "decode_im", "IMT": "decode_imt", "GBR": "decode_gbr",
            "MCIDAS": "decode_mcidas", "PIXAR": "decode_pixar", "SPIDER": "decode_spider",
            "XVThumb": "decode_xvthumb", "IPTC": "decode_iptc", "PCD": "decode_pcd",
            "AVIF": "decode_avif"}


@pytest.mark.parametrize("name", sorted(json.loads((FIXTURES / "pil_rgb.json").read_text())
                                        ["files"]))
def test_formats_told_apart_as_pil_tells_them(name, monkeypatch):
    """decode_texture sends each committed fixture to the decoder of the
    format Image.open finds, by the file's bytes alone."""
    data = (FIXTURES / name).read_bytes()
    with Image.open(io.BytesIO(data)) as im:
        want = [DECODERS[im.format]]
    if want == ["decode_iptc"] and misc_raster.iptc_body(data)[4] == 5:
        # PIL opens an IPTC image's compressed data as a file of its own
        with Image.open(io.BytesIO(misc_raster.iptc_body(data)[5])) as body:
            want.append(DECODERS[body.format])
    calls = []
    for attr in set(DECODERS.values()):
        real = getattr(texture, attr)
        monkeypatch.setattr(texture, attr, lambda d, *a, _r=real, _n=attr, **k: calls.append(_n)
                            or _r(d, *a, **k))
    decode_texture(data)
    assert calls == want


def test_tga_is_told_last_by_its_header(monkeypatch):
    """A TGA has no magic number: PIL tries it after its other plugins, so a
    truecolour TGA whose first bytes look like a cursor (00 00 02 00) with
    no cursor entries still opens as a TGA, and a file that passes no check
    is unknown; with a directory entry they are a cursor, decoded as one."""
    data = tga_file(5, 3, 2, 24, bytes(range(45)))
    assert data[:4] == b"\0\0\2\0"
    with Image.open(io.BytesIO(data)) as im:
        assert im.format == "TGA"
    _equal_to_pil(data)
    with pytest.raises(ValueError, match="unknown format"):
        decode_texture(b"\0\7\2" + bytes(20))
    # with a directory entry the same first bytes make a cursor, even where
    # the entry's bytes pass the TGA checks; an icon likewise
    assert tga_header_ok(CURSOR)
    calls = []
    for attr in ("decode_cur", "decode_ico", "decode_tga"):
        real = getattr(texture, attr)
        monkeypatch.setattr(texture, attr, lambda d, _r=real, _n=attr: calls.append(_n) or _r(d))
    for data, kind in ((CURSOR, "CUR"), (_save(Image.new("RGB", (16, 16), (9, 8, 7)), "ICO"),
                                         "ICO")):
        with Image.open(io.BytesIO(data)) as im:
            assert im.format == kind
            im.convert("RGB")
        calls.clear()
        _equal_to_pil(data)
        assert calls == [f"decode_{kind.lower()}"]


def _cursor() -> bytes:
    """A 4x4 24-bit cursor whose directory entry (hotspot y 1, resource size
    0x10030) also reads as a TGA header."""
    entry = bytes([4, 4, 0, 0, 0, 0, 1, 0]) + (0x10030).to_bytes(4, "little") + (22).to_bytes(
        4, "little")
    dib = struct.pack("<IiiHHIIiiII", 40, 4, 8, 1, 24, 0, 0, 0, 0, 0, 0)
    return b"\0\0\2\0\1\0" + entry + dib + bytes(range(96)) + bytes(32)


CURSOR = _cursor()


# --- what is refused ------------------------------------------------------------

def _retile(data: bytes, old: int, new: int) -> bytes:
    """A little-endian TIFF with its TileWidth and TileLength (SHORTs) set
    from `old` to `new`."""
    for tag in (322, 323):
        was, now = (struct.pack("<HHLH", tag, 3, 1, v) for v in (old, new))
        assert data.count(was) == 1
        data = data.replace(was, now)
    return data


def _refused():
    rng = np.random.default_rng(7)
    pic = Image.fromarray(_picture(7, 20, 12))
    tif = _save(pic, "TIFF", compression="tiff_lzw")
    png = _save(pic, "PNG")
    gif = _save(pic.quantize(8), "GIF")
    bmp = _save(pic, "BMP")
    tga = _save(pic, "TGA", rle=True)
    ppm = _save(pic, "PPM")
    return {
        # truncated and corrupt, a case each decoder (PIL fails on each too)
        "pnm_truncated": (ppm[:len(ppm) - 7], "truncated"),
        "pnm_plain_bad_sample": (b"P2 2 1 10\n5 11\n", "outside 0-10"),
        "bmp_truncated": (bmp[:len(bmp) - 40], "truncated"),
        "bmp_rle_truncated": (bmp_file(13, 6, 8, bytes([4, 1]) * 5, [(1, 2, 3)] * 4,
                                       compression=1), "not enough RLE"),
        "tga_truncated": (tga[:len(tga) // 2], "truncated"),
        "tga_rle_run_across_rows": (tga_file(4, 2, 10, 24, bytes([0x85, 1, 2, 3])),
                                    "crosses a row"),
        "gif_truncated": (gif[:len(gif) // 2], "ends before the image"),
        "gif_bad_code": (gif_file(8, 8, [(0, 0, 8, 8, None, False, 4, bytes([0x10, 0xff, 0xff]),
                                          None)], bytes(48)), "bad LZW code"),
        "tiff_lzw_truncated": (tif[:60] + tif[-200:], "TIFF"),
        "tiff_raw_truncated": (tiff_file(rng.integers(0, 256, (12, 20, 3)), 8, 2)[:300],
                               "truncated"),
        "png_in_bmp_clothes": (b"BM" + png[2:], "BMP"),
        # kinds still refused
        # an uncompressed strip labelled JPEG (tag 259: 7): libjpeg finds no
        # SOI, in PIL as in the port
        "tiff_jpeg": (tiff_file(rng.integers(0, 256, (4, 4, 3)), 8, 2).replace(
            b"\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00",
            b"\x03\x01\x03\x00\x01\x00\x00\x00\x07\x00"),
                      "TIFF: JPEG strip or tile 0: not a JPEG stream (no SOI)"),
        "tiff_planar_palette": (tiff_file(rng.integers(0, 256, (6, 6, 2)), 8, 3, comp=5,
                                          planar=2, tile=(16, 16), extra=(0,),
                                          colormap=list(range(768))), "planar palette"),
        "tga_32_bit_map": (tga_file(4, 2, 1, 8, bytes(8), cmap=(0, [bytes(4)] * 2, 32)),
                            "colour map of 32 bits"),
        "webp": (b"RIFF\x10\0\0\0WEBPVP8L" + bytes(8), "truncated WebP lossless data"),
        # once refused; now decoded (words None)
        "pnm_float": (b"Pf\n2 1\n-1.0\n" + bytes(8), None),
        "cur": (CURSOR, None),
        "ico": (_save(pic.resize((16, 16)), "ICO"), None),
        # once refused; now decoded (words None): Huffman data read as
        # arithmetic-coded, the garbage libjpeg makes of it
        "arithmetic_jpeg": (_save(pic, "JPEG").replace(b"\xff\xc0", b"\xff\xc9", 1), None),
        # PIL's decompression-bomb limit, for every format
        "pnm_huge": (b"P6 20000 10000 255\n" + bytes(30), "more pixels than 178,956,970"),
        "bmp_huge": (bmp_file(20000, 10000, 24, bytes(30)), "more pixels than 178,956,970"),
        "tga_huge": (tga_file(20000, 10000, 2, 24, bytes(30)), "more pixels than 178,956,970"),
        "gif_huge": (gif_file(20000, 10000, [(0, 0, 8, 8, None, False, 2, bytes(4), None)]),
                     "more pixels than 178,956,970"),
        "tiff_huge": (tiff_file(np.zeros((1, 1, 1), np.uint8), 8, 1).replace(  # width 2**28
            b"\x00\x01\x04\x00\x01\x00\x00\x00\x01\x00\x00\x00",
            b"\x00\x01\x04\x00\x01\x00\x00\x00\x00\x00\x00\x10", 1),
                      "more pixels than 178,956,970"),
        # a 1x1 image in one 16384x16384 Deflate tile: refused before the
        # tile is inflated
        "tiff_huge_tiles": (_retile(tiff_file(np.zeros((1, 1, 3), np.uint8), 8, 2, comp=8,
                                              tile=(16, 16)), 16, 16384),
                            "tiles of 16384x16384 are more pixels than 178,956,970"),
    }


REFUSED = _refused()


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_refused_and_broken_files_raise_texture_error(tmp_path, kind, monkeypatch):
    """Each raises TextureError naming the file and what went wrong, with
    PIL blocked, and leaves the atlas as it was. The kinds once refused that
    the port now decodes (words None: an arithmetic-coded JPEG, a cursor,
    an icon, PIL's float PNM) read to PIL's pixels."""
    data, words = REFUSED[kind]
    path = tmp_path / "t.bin"
    path.write_bytes(data)
    want = _pil(data) if words is None else None
    monkeypatch.setitem(sys.modules, "PIL", None)
    atlas, values = bytearray(b"keep"), []
    if words is None:
        read_texture(str(path), atlas, values)
        h, w, _ = want.shape
        assert values == [4, w, h] and bytes(atlas[4:]) == want.tobytes()
        return
    with pytest.raises(TextureError) as err:
        read_texture(str(path), atlas, values)
    assert str(path) in str(err.value) and words in str(err.value), str(err.value)
    assert atlas == b"keep" and values == []


@pytest.mark.parametrize("kind", ["pnm_truncated", "bmp_truncated", "bmp_rle_truncated",
                                  "tga_truncated", "tga_rle_run_across_rows", "gif_truncated",
                                  "tiff_lzw_truncated", "tiff_raw_truncated", "png_in_bmp_clothes",
                                  "pnm_huge", "bmp_huge", "tga_huge", "gif_huge", "tiff_huge"])
def test_pil_fails_on_the_broken_files(kind):
    """The broken files are broken for PIL too, and the huge ones past its
    decompression-bomb limit."""
    with pytest.raises(Image.DecompressionBombError if kind.endswith("huge") else Exception):
        _pil(REFUSED[kind][0])


# --- read_texture, scenes, and the JAX package ----------------------------------

NEW_FORMAT_FIXTURES = ("plain.pgm", "maxval100.ppm", "rle8.bmp", "topdown32.bmp", "cmap16.tga",
                       "blob_rle.tga", "local_palette.gif", "interlaced.gif", "cubes_lzw.tif",
                       "planar_tiles.tif", "rgb16_be.tif", "cmyk.jpg", "ycck.jpg",
                       "adobe_rgb.jpg", "s31.jpg")


def test_read_texture_without_pil_matches_the_jax_package(tmp_path, monkeypatch):
    """read_texture of each new format, with PIL blocked, gives the JAX
    package's read_texture's atlas bytes and (offset, w, h) values."""
    from relativitypathtracer_tpu.models.texture import read_texture as jax_read

    want_atlas, want_values = bytearray(), []
    for name in NEW_FORMAT_FIXTURES:
        jax_read(str(FIXTURES / name), want_atlas, want_values)
    monkeypatch.setitem(sys.modules, "PIL", None)
    atlas, values = bytearray(), []
    for name in NEW_FORMAT_FIXTURES:
        read_texture(str(FIXTURES / name), atlas, values)
    assert values == want_values and atlas == want_atlas


_TEXTURE_PATHS = ("textures", "textures_packed", "tex_quads", "tex_fp", "objects.tex_offset",
                  "objects.tex_w", "objects.tex_h")


def _leaf(scene, path):
    for part in path.split("."):
        scene = getattr(scene, part)
    return scene


def test_scene_with_every_new_format_matches_jax(tmp_path):
    """A DSL scene with a texture of each new format (the PNM family, BMP,
    TGA, GIF, TIFF, the JPEG kinds), each shared by two objects, through
    the JAX package's build_scene (PIL) and the port's: every texture array
    exact, and the JAX scene carried over by scene_from_numpy equal to the
    port's own build."""
    import jax

    from relativitypathtracer_tpu import build_scene as jbuild
    from relativitypathtracer_tpu.models.dsl import parse_scene as jparse

    for name in NEW_FORMAT_FIXTURES:
        (tmp_path / name).write_bytes((FIXTURES / name).read_bytes())
    n = len(NEW_FORMAT_FIXTURES)
    objects = [f"{'Os' if k % 2 else 'Oc'}\n p{k % 7 - 3},{k // 7 - 1},{6 + k % 3},0,0,1,0,0.6,"
               f"0.6,0.6\n t{k % n}\n" for k in range(2 * n)]
    text = "".join(f"T{name}\n" for name in NEW_FORMAT_FIXTURES) + "".join(objects) + "R\n"
    js, jm = jbuild(jparse(text, str(tmp_path)))
    ps, pm = pt.build_scene(pt.parse_scene(text, str(tmp_path)), device="cpu")
    assert pm.textured_ids == tuple(range(2 * n)) and pm.use_footprint_tex == jm.use_footprint_tex
    for path in _TEXTURE_PATHS:
        want = np.asarray(_leaf(js, path))
        got = _leaf(ps, path).numpy()
        assert got.shape == want.shape and np.array_equal(got.astype(np.int64),
                                                          want.astype(np.int64)), path
    carried = pt.scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    for path in _TEXTURE_PATHS + ("objects.m", "objects.color", "objects.obj_type",
                                  "tex_textured"):
        a, b = _leaf(carried, path), _leaf(ps, path)
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_chip_smoke_texture_scenes_on_cpu(tmp_path):
    """chip_smoke.py's textures phase's fixture scenes, built on the CPU:
    textured with blob_rle.tga (the PPM scene's 32x32 texture, so the same
    atlas; K2's small route), with blob_lossy.webp (that texture lossy) and
    with blob_arith_prog.jpg (that texture as an arithmetic-coded
    progressive JPEG), with blob_bc1.dds (that texture as DXT1) and with
    blob_packbits.psd (that texture as a PackBits RGB PSD, lossless, so the
    PPM scene's atlas again), cubes with cubes_lzw.tif, with
    cubes_lossless.webp, with cubes_jpeg_tiles.tif (64x64 in 4:2:0
    JPEG-in-TIFF tiles; a 2,048-row atlas: K8's windowed route), with
    cubes_bc7.dds (the squares as BC7) and with cubes_rle.sgi (the squares
    as RLE SGI), textured with blob_irrev.jp2 (that texture as an
    irreversible JP2) and cubes with cubes_lossless.j2k (the squares as a
    lossless tiled J2K), textured with blob_rgb.im (that texture as a
    line-interleaved RGB IM, lossless) and cubes with cubes_g4.tif (256x256
    bilevel squares in Group 4, the PPM scene's 32,768-row atlas), textured
    with blob_thunder.tif (that texture as 4-bit grey ThunderScan) and cubes
    with cubes_rlew.tif (the 256x256 squares in CCITT RLEW), textured
    with blob.avif (that texture as PIL's default AVIF), cubes with
    cubes_screen.avif (256x256 flat squares in palette and intra block
    copy), textured with blob_lr.avif (its texture loop-restored) and
    blob_grain.avif (with film grain) and cubes with cubes_qm.avif (its
    256x256 texture with quantiser matrices), textured with
    avif10_blob.avif (blob.avif at 10 bits) and cubes with
    cubes_prem12.avif (its texture premultiplied, 12-bit 4:4:4), through
    its fixture_texture."""
    from relativitypathtracer_tpu_torch.ops.kernels.texture_kernel import texture_route

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    fixtures = [(kind, fmt) for kind, fmt, _ in smoke.TEXTURE_SCENES if fmt.count(".")]
    assert fixtures == [("textured", "blob_rle.tga"), ("cubes", "cubes_lzw.tif"),
                        ("textured", "blob_lossy.webp"), ("cubes", "cubes_lossless.webp"),
                        ("textured", "blob_arith_prog.jpg"), ("cubes", "cubes_jpeg_tiles.tif"),
                        ("textured", "blob_bc1.dds"), ("cubes", "cubes_bc7.dds"),
                        ("textured", "blob_packbits.psd"), ("cubes", "cubes_rle.sgi"),
                        ("textured", "blob_irrev.jp2"), ("cubes", "cubes_lossless.j2k"),
                        ("textured", "blob_rgb.im"), ("cubes", "cubes_g4.tif"),
                        ("textured", "blob_thunder.tif"), ("cubes", "cubes_rlew.tif"),
                        ("textured", "blob.avif"), ("cubes", "cubes_screen.avif"),
                        ("textured", "blob_lr.avif"), ("textured", "blob_grain.avif"),
                        ("cubes", "cubes_qm.avif"), ("textured", "avif10_blob.avif"),
                        ("cubes", "cubes_prem12.avif")]
    for kind, name in fixtures:
        where = tmp_path / name
        scene_file = smoke.fixture_texture(write_demo_scene(str(where), 1, kind), name)
        assert [p.name for p in (where / "Textures").iterdir()] == [name]
        host = pt.load_scene_file(scene_file)
        scene, _ = pt.build_scene(host, device="cpu")
        route = texture_route(scene.tex_quads.shape[0])
        assert bytes(host.textures) == _pil((FIXTURES / name).read_bytes()).tobytes()
        if kind == "textured":
            if name.endswith((".tga", ".psd", ".im")):
                ppm = pt.load_scene_file(write_demo_scene(str(tmp_path / "ppm"), 1, kind))
                assert bytes(host.textures) == bytes(ppm.textures) == demo_texture(32).tobytes()
            assert route == "small"
        else:
            big = ("cubes_g4.tif", "cubes_rlew.tif", "cubes_screen.avif", "cubes_qm.avif",
                   "cubes_prem12.avif")
            rows = 32768 if name in big else 2048
            assert scene.tex_quads.shape[0] == rows and route == "windowed"


def test_large_lzw_files_decode_equal_pil():
    """512x512 GIF and TIFF LZW files (many table clears) and a CMYK JPEG
    decode equal to PIL (1024x1024 times of each format:
    tools/texture_decode_times.py)."""
    im = Image.fromarray(demo_texture(512))
    _equal_to_pil(_save(im.quantize(256), "GIF"))
    _equal_to_pil(_save(im, "TIFF", compression="tiff_lzw", tiffinfo={317: 2}))
    _equal_to_pil(_save(im.convert("CMYK"), "JPEG", quality=90))


def test_bmp_rle_builder_round_trips():
    """make_fixtures' RLE encoder (the fixtures' and these tests' source of
    RLE BMPs) codes runs, absolute runs and row ends that PIL reads back as
    the image it coded."""
    rng = np.random.default_rng(8)
    pal = [tuple(int(c) for c in rng.integers(0, 256, 3)) for _ in range(16)]
    idx = rng.integers(0, 16, (9, 23)).astype(np.uint8)
    idx[2:5] = 3
    for rle4, comp, bits in ((False, 1, 8), (True, 2, 4)):
        data = bmp_file(23, 9, bits, bmp_rle(idx, rle4), pal, compression=comp)
        want = np.asarray(pal, np.uint8)[idx]
        assert np.array_equal(_pil(data), want)
        assert np.array_equal(decode_texture(data), want)
