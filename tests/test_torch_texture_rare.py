"""The port's decoders of PIL's PNM extensions (utils/raster_decode:
P0CMYK, PyCMYK, PyRGBA, PyP, Pf) and TIFF's rare kinds (utils/tiff_decode,
utils/ccitt_decode: BigTIFF, float samples with predictors 2 and 3, CIELab,
LZMA, CCITT RLE, Group 3 1D and 2D, Group 4, old-style LZW, YCbCr under
other compressions than JPEG, planar palettes, compressed planar RGBA
without ExtraSamples) against PIL, the JAX package's decoder.

Tolerance 0: every decode equals `np.asarray(Image.open(f).convert("RGB"))`
byte for byte, with PIL blocked while the port decodes. The committed
fixtures (tests/torch_textures/make_fixtures.py's `rare_fixtures`), files
PIL writes (libtiff's encoders) over sizes, modes, compressions and
predictors, files built here over their options, random images through
libtiff's CCITT encoders at widths past 2560, random PNM samples, mutated
CCITT strips (the port equals libtiff, or refuses a strip whose data ends
early, where PIL's output is its strip buffer's old contents), and broken
files: each raises TextureError naming its cause, and PIL fails on it too.
A DSL scene with LZMA, Group 4, float and CMYK-PNM textures builds to the
JAX package's texture arrays.
"""

import hashlib
import io
import json
import lzma
import pathlib
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from torch_textures.make_fixtures import (ccitt_tiff, lzw_tiff_old, tiff_file, tiff_from_chunks,
                                          ycbcr_tiff)

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch.models.texture import TextureError, decode_texture, read_texture
from relativitypathtracer_tpu_torch.utils import ccitt_decode

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "torch_textures"
RECORD = json.loads((FIXTURES / "pil_rgb.json").read_text())["files"]
RARE = sorted(
    ["p0cmyk.pnm", "pycmyk_16bit.pnm", "pyrgba.pnm", "pyp.pnm", "float_le.pfm", "float_be.pfm",
     "bigtiff_lzw.tif", "bigtiff_long8_tiles.tif", "float.tif", "float_pred3.tif",
     "float_be_lzw.tif", "lab.tif", "lab_lzma.tif", "lzma_pred2.tif", "ccitt_rle.tif",
     "g3_1d.tif", "g3_2d_fill.tif", "g4.tif", "g4_wide.tif", "old_lzw.tif",
     "ycbcr_22_lzw.tif", "ycbcr_21_tiles.tif", "ycbcr_raw.tif", "planar_palette.tif",
     "planar_rgba_deflate.tif", "cubes_g4.tif", "zstd.tif", "zstd_pred2_strips.tif",
     "zstd_float.tif"])


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _pil_outcome(data: bytes):
    try:
        return _pil(data)
    except Exception as e:  # noqa: BLE001 - any failure is PIL's refusal
        return e


def _port(data: bytes):
    """decode_texture's pixels, or the exception it raises, with PIL
    blocked."""
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None
    try:
        return decode_texture(data)
    except Exception as e:  # noqa: BLE001
        return e
    finally:
        sys.modules["PIL"] = saved


def _agree(data: bytes) -> None:
    """The port and PIL give the same pixels, or both refuse."""
    want, got = _pil_outcome(data), _port(data)
    if isinstance(want, Exception) or isinstance(got, Exception):
        assert isinstance(want, Exception) and isinstance(got, Exception), (want, got)
        return
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want), f"{int((got != want).sum())} values differ"


def _equal_to_pil(data: bytes) -> None:
    want, got = _pil(data), _port(data)
    assert not isinstance(got, Exception), got
    assert got.shape == want.shape and np.array_equal(got, want)


def _save(im, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _picture(seed: int, w: int, h: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 7 + y * 3, x * x // 3 + y, (y * 11) ^ (x * 5)], -1) % 256
    return np.clip(base + rng.integers(-30, 30, (h, w, 3)), 0, 255).astype(np.uint8)


def _floats(seed: int, w: int, h: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    f = rng.normal(120, 150, (h, w)) * rng.choice([1, 1e-3, 1e7], (h, w), p=[0.8, 0.1, 0.1])
    f[rng.random((h, w)) < 0.05] = np.nan
    return f.astype(np.float32)


# --- the committed fixtures -----------------------------------------------------

@pytest.mark.parametrize("name", RARE)
def test_fixture_decodes_to_pil_bytes(name):
    """Each committed file of the slice's kinds, decoded with PIL blocked,
    equals PIL's convert("RGB") now and the hash PIL gave where it was
    made."""
    data = (FIXTURES / name).read_bytes()
    got = _port(data)
    assert not isinstance(got, Exception), got
    assert list(got.shape) == RECORD[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == RECORD[name]["sha256"]
    assert np.array_equal(got, _pil(data))


def test_fixtures_cover_every_kind():
    """Each fixture is the kind its name says, as PIL reads its tags, and
    is under 4 KB."""
    tiff, pnm = set(), set()
    for name in RARE:
        with Image.open(FIXTURES / name) as im:
            if im.format == "TIFF":
                tiff.add((im.tag_v2.get(259), im.tag_v2.get(262)))
            else:
                pnm.add(im.mode)
        assert len((FIXTURES / name).read_bytes()) < 4096
    assert {2, 3, 4, 5, 8, 34925} <= {c for c, _ in tiff}
    assert {0, 1, 2, 3, 6, 8} <= {p for _, p in tiff}
    assert pnm == {"CMYK", "RGBA", "P", "F"}


# --- PNM -----------------------------------------------------------------------------

@pytest.mark.parametrize("magic,bands", [(b"P0CMYK", 4), (b"PyCMYK", 4), (b"PyRGBA", 4),
                                         (b"PyP", 1)])
@pytest.mark.parametrize("maxval", [1, 7, 255, 256, 1000, 65535])
def test_pnm_extensions_as_pil(magic, bands, maxval):
    """PIL's own PNM kinds at every sample width: raw at 255, rescaled
    with Python's round otherwise (PIL's ppm decoder); a file one byte
    short fails in both."""
    rng = np.random.default_rng(maxval + bands)
    for w, h in ((1, 1), (5, 3), (17, 2)):
        size = 1 if maxval < 256 else 2
        v = rng.integers(0, maxval + 1, w * h * bands)
        data = magic + b"\n%d %d\n%d\n" % (w, h, maxval) + v.astype(
            np.uint8 if size == 1 else ">u2").tobytes()
        _equal_to_pil(data)
        _agree(data[:-1])


@pytest.mark.parametrize("scale", [b"-1.0", b"1.0", b"-0.25", b"3", b"1e3", b"0", b"nan",
                                   b"inf", b"-", b"x"])
def test_pnm_float_as_pil(scale):
    """Pf: float32 rows bottom first, little-endian where the scale is
    negative; a zero, infinite or unreadable scale fails in both."""
    for w, h in ((1, 1), (6, 4)):
        f = _floats(len(scale) + w, w, h)
        for order in "<>":
            _agree(b"Pf\n%d %d\n" % (w, h) + scale + b"\n" + f.astype(order + "f4").tobytes())


@pytest.mark.parametrize("size", [(1, 1), (13, 7), (64, 3)])
def test_pil_written_pfm_decodes_as_pil(size):
    _equal_to_pil(_save(Image.fromarray(_floats(size[0], *size)), "PPM"))


def test_pyp_has_no_palette():
    """PIL opens PyP with no palette: every index converts to black."""
    data = b"PyP 3 2 255\n" + bytes([0, 1, 2, 128, 200, 255])
    assert not _port(data).any()
    _equal_to_pil(data)


# --- TIFF: files PIL writes ------------------------------------------------------

TIFF_COMPRESSIONS = ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits", "lzma")


@pytest.mark.parametrize("mode", ["F", "LAB", "YCbCr", "RGB", "L"])
@pytest.mark.parametrize("compression", TIFF_COMPRESSIONS)
@pytest.mark.parametrize("big", [False, True])
def test_pil_written_tiff_decodes_as_pil(mode, compression, big):
    """F, LAB and YCbCr (PIL writes 1x1 sampling; its raw YCbCr it cannot
    read back, and neither can the port) and RGB and L, under every
    compression PIL writes, classic and BigTIFF, at two sizes."""
    for w, h in ((1, 1), (23, 9)):
        im = Image.fromarray(_floats(w, w, h)) if mode == "F" else Image.fromarray(
            _picture(w, w, h)).convert(mode)
        _agree(_save(im, "TIFF", compression=compression, big_tiff=big))
        if mode != "YCbCr" or compression != "raw":
            _equal_to_pil(_save(im, "TIFF", compression=compression, big_tiff=big))


@pytest.mark.parametrize("compression", ["tiff_lzw", "tiff_adobe_deflate", "lzma"])
@pytest.mark.parametrize("predictor", [2, 3])
def test_float_predictors_as_pil(compression, predictor):
    """libtiff's predictor 2 on 32-bit samples and its floating-point
    predictor 3 (byte planes, most significant first), in strips of a few
    rows."""
    for w, h in ((1, 1), (19, 6)):
        data = _save(Image.fromarray(_floats(w * predictor, w, h)), "TIFF",
                     compression=compression, tiffinfo={317: predictor, 278: 4})
        _equal_to_pil(data)


def test_lzma_with_predictor_2_as_pil():
    for mode in ("L", "RGB", "RGBA", "I;16"):
        im = Image.fromarray(_picture(3, 31, 11)).convert(mode) if mode != "I;16" else \
            Image.fromarray(np.random.default_rng(1).integers(0, 700, (11, 31)).astype(np.uint16))
        _equal_to_pil(_save(im, "TIFF", compression="lzma", tiffinfo={317: 2}))


@pytest.mark.parametrize("compression", ["tiff_ccitt", "group3", "group4"])
@pytest.mark.parametrize("size", [(1, 1), (45, 20), (300, 9), (2600, 3), (6000, 2)])
def test_pil_written_ccitt_decodes_as_pil(compression, size):
    """libtiff's CCITT encoders through PIL on random bilevel images of
    three densities, widths past the make-up codes' 2560 among them, in
    strips of 4 rows, and Group 3 in 2D (T4Options 1) and with byte-aligned
    EOLs (T4Options 4)."""
    w, h = size
    rng = np.random.default_rng(w + h)
    for density in (0.05, 0.5, 0.97):
        a = rng.random((h, w)) < density
        a[:, w // 3:w // 2] = True
        im = Image.fromarray(a).convert("1")
        infos = ({}, {278: 4}) + (({292: 1}, {292: 5}) if compression == "group3" else ())
        for info in infos:
            _equal_to_pil(_save(im, "TIFF", compression=compression, tiffinfo=info))


# --- TIFF: files built here --------------------------------------------------------------

@pytest.mark.parametrize("comp", [2, 3, 4])
@pytest.mark.parametrize("fill", [1, 2])
@pytest.mark.parametrize("photo", [0, 1])
def test_ccitt_fill_order_and_photometric(comp, fill, photo):
    """Each CCITT compression under fill order 2 and both photometrics:
    black where the source is, as PIL reads it (libtiff's fax bits: 1 a
    black run, whatever the photometric says)."""
    rng = np.random.default_rng(comp * 4 + fill * 2 + photo)
    for t4 in ((0, 1, 4, 5) if comp == 3 else (0,)):
        ink = rng.random((11, 70)) < 0.3
        data = ccitt_tiff(ink, comp, Image, t4=t4, fill=fill, photo=photo, rows_per_strip=4)
        assert np.array_equal(_port(data)[..., 0], np.where(ink, 0, 255))
        _equal_to_pil(data)


def test_ccitt_tables_are_prefix_codes():
    """The code tables: the white and black codes each a prefix code over
    their make-up codes, and every 7-bit 2D mode pattern taken."""
    for codes in (ccitt_decode._WHITE_TERM + ccitt_decode._WHITE_MAKEUP
                  + ccitt_decode._EXT_MAKEUP,
                  ccitt_decode._BLACK_TERM + ccitt_decode._BLACK_MAKEUP
                  + ccitt_decode._EXT_MAKEUP):
        assert len(set(codes)) == len(codes) == 104
        assert not any(a != b and b.startswith(a) for a in codes for b in codes)
    white, black, main = ccitt_decode._tables()
    assert all(state != ccitt_decode._NULL for state, _, _ in main)
    assert white[0] == (ccitt_decode._EOL, 11, 0) and black[0] == (ccitt_decode._EOL, 11, 0)


def test_mutated_ccitt_strips_agree_or_refuse_early_ends():
    """Bytes changed in CCITT strips: libtiff reads bad codes and goes on,
    Group 3 reads a strip again without EOLs where its data ends before
    an EOL, and the port equals PIL or both refuse; where Group 4 data
    ends before the strip's last row, libtiff leaves the rest of PIL's
    strip buffer as it was (unwritten memory in a first strip, which
    differs from run to run), and the port refuses by name. The port
    never decodes what PIL refuses."""
    rng = np.random.default_rng(5)
    seen = {"equal": 0, "both refuse": 0, "refused early end": 0}
    for comp, info in (("group3", {}), ("group3", {292: 1}), ("group4", {}),
                       ("tiff_ccitt", {})):
        a = rng.random((12, 37)) < 0.3
        data = _save(Image.fromarray(a).convert("1"), "TIFF", compression=comp, tiffinfo=info)
        with Image.open(io.BytesIO(data)) as im:
            at, n = im.tag_v2[273][0], im.tag_v2[279][0]
        for _ in range(60):
            e = bytearray(data)
            for _ in range(int(rng.integers(1, 4))):
                e[at + int(rng.integers(0, n))] = int(rng.integers(0, 256))
            want, got = _pil_outcome(bytes(e)), _port(bytes(e))
            if isinstance(got, Exception):
                key = "both refuse" if isinstance(want, Exception) else "refused early end"
                assert key == "both refuse" or (
                    comp == "group4" and "unwritten memory" in str(got)), got
                seen[key] += 1
            else:
                assert not isinstance(want, Exception) and np.array_equal(got, want)
                seen["equal"] += 1
    assert seen["equal"] > 100 and seen["refused early end"], seen


@pytest.mark.parametrize("size", [(3, 4), (40, 60), (120, 200)])
def test_old_style_lzw_as_pil(size):
    """Old-style LZW (LSB-first codes, the later width change), past the
    table's clear at the larger size, with and without predictor 2."""
    rng = np.random.default_rng(size[0])
    s = (rng.integers(0, 4, size + (3,)) * 60)
    s[::3] = 7
    _equal_to_pil(tiff_file(s, 8, 2, comp=5, codec=lzw_tiff_old))
    _equal_to_pil(tiff_file(s, 8, 2, comp=5, codec=lzw_tiff_old, predictor=2, rows_per_strip=7))


@pytest.mark.parametrize("sub", [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)])
@pytest.mark.parametrize("comp", [5, 8, 32773, 34925])
def test_subsampled_ycbcr_as_pil(sub, comp):
    """YCbCr under each compression but JPEG, read as libtiff's RGBA reader
    reads it (PIL's route): blocks of luma and one chroma pair, partial
    blocks at the edges, strips and tiles; 4x4 where libtiff's reader
    reads its own layout (an even count of blocks a strip row, tiles
    within the image)."""
    rng = np.random.default_rng(sub[0] * 10 + sub[1] + comp)
    for w, h in ((8, 8), (16, 9), (7, 5)):
        y = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        for kw in ({}, {"rows_per_strip": 4}, {"tile": (16, 16)}):
            data = ycbcr_tiff(y, sub, comp, **kw)
            if sub == (4, 4) and (kw.get("tile") and w % 16 or -(-w // 4) % 2):
                got = _port(data)
                assert isinstance(got, Exception) and "4x4" in str(got)
                continue
            _equal_to_pil(data)


def test_uncompressed_ycbcr_read_as_pil_reads_it():
    """PIL reads uncompressed YCbCr with its raw mode RGBX: four bytes a
    pixel from the strip's start on, the samples unconverted; its planar
    form plane by plane as R, G and B."""
    ycc = _picture(2, 5, 4)
    data = tiff_file(ycc, 8, 6)
    _equal_to_pil(data)
    flat = np.frombuffer(data, np.uint8, 80, 8).reshape(4, 5, 4)
    assert np.array_equal(_port(data), flat[..., :3])
    _equal_to_pil(tiff_file(ycc, 8, 6, planar=2))


def test_float_byte_orders_as_pil():
    """Big-endian float samples: raw, read as stored; compressed, libtiff
    returns them in the host's order and PIL still reads F;32BF, so each
    value's bytes are swapped; photometric 0 and 1."""
    f = _floats(3, 5, 6)
    for comp in (1, 5, 8, 34925):
        for endian in "<>":
            for photo in (0, 1):
                data = tiff_file(f.view(np.uint32)[..., None], 32, photo, comp=comp,
                                 endian=endian, sample_format=(3,))
                _equal_to_pil(data)


def test_planar_palette_and_rgba_as_pil():
    """A planar palette file of one plane (as if chunky), and compressed
    planar RGBA without ExtraSamples, which libtiff reads as associated
    alpha (PIL divides it out). Beside an extra plane PIL unpacks the
    palette plane two bytes a pixel, and the port refuses it by name."""
    rng = np.random.default_rng(8)
    cmap = rng.integers(0, 65536, 768).tolist()
    idx = rng.integers(0, 256, (6, 7, 1))
    for comp in (1, 5, 8):
        for tile in (None, (16, 16)):
            _equal_to_pil(tiff_file(idx, 8, 3, comp=comp, planar=2, tile=tile, colormap=cmap))
    extra = tiff_file(np.concatenate([idx, idx], 2), 8, 3, comp=5, planar=2, tile=(16, 16),
                      extra=(0,), colormap=cmap)
    assert "planar palette" in str(_port(extra))  # PIL reads its palette plane misaligned
    assert not np.array_equal(_pil(extra), _port(tiff_file(idx, 8, 3, colormap=cmap)))
    rgba = rng.integers(0, 256, (5, 7, 4))
    for comp in (5, 8, 32773, 34925):
        for tile in (None, (16, 16)):
            data = tiff_file(rgba, 8, 2, comp=comp, planar=2, tile=tile)
            _equal_to_pil(data)
            a = rgba[..., 3:]
            want = np.where(a == 0, 0, np.where(a == 255, rgba, np.minimum(
                rgba * 255 // np.maximum(a, 1), 255)))[..., :3]
            assert np.array_equal(_port(data), want)


TEXTURES = {"smooth": lambda y, x, rng: np.stack([x * 4 % 256, y * 3 % 256, (x + y) % 256], -1),
            "noisy": lambda y, x, rng: rng.integers(0, 256, y.shape + (3,)),
            "blocks": lambda y, x, rng: np.stack([x // 16 * 60 % 256, y // 8 * 90 % 256,
                                                  (x // 16 + y // 8) * 40 % 256], -1),
            "sparse": lambda y, x, rng: (rng.random(y.shape + (3,)) < 0.05) * 255}


@pytest.mark.parametrize("texture", sorted(TEXTURES))
@pytest.mark.parametrize("size", [(1, 1), (7, 13), (64, 64), (300, 200)])
def test_zstd_as_pil(texture, size):
    """TIFF's ZSTD (utils/zstd_decode) on libzstd's frames through PIL:
    raw, RLE and compressed blocks past 128 KB, Huffman literals in one
    and four streams, FSE tables predefined, RLE and the block's own; RGB
    and L, predictor 2, strips of 16 rows."""
    h, w = size
    y, x = np.mgrid[0:h, 0:w]
    a = TEXTURES[texture](y, x, np.random.default_rng(h * 7 + w)).astype(np.uint8)
    for mode in ("RGB", "L"):
        for info in ({}, {317: 2, 278: 16}):
            _equal_to_pil(_save(Image.fromarray(a).convert(mode), "TIFF", compression="zstd",
                                tiffinfo=info))


def test_zstd_float_and_checksum():
    """Float samples under ZSTD with predictor 3; XXH64 (the content
    checksum) on its published values."""
    from relativitypathtracer_tpu_torch.utils.zstd_decode import _xxh64

    _equal_to_pil(_save(Image.fromarray(_floats(2, 33, 17)), "TIFF", compression="zstd",
                        tiffinfo={317: 3}))
    assert (_xxh64(b""), _xxh64(b"a"), _xxh64(b"abc")) == (
        0xEF46DB3751D8E999, 0xD24EC4F1A98C6E5B, 0x44BC2CF5AD770999)


def test_mutated_zstd_strips_agree_or_refuse():
    """Bytes changed in ZSTD strips: the port equals PIL, or both refuse,
    libzstd's fast Huffman loop (which leaves a literal stream's end
    unchecked) included."""
    rng = np.random.default_rng(9)
    seen = {"equal": 0, "both refuse": 0}
    for h, w in ((40, 50), (120, 90)):
        y, x = np.mgrid[0:h, 0:w]
        for name in ("noisy", "smooth"):
            data = _save(Image.fromarray(TEXTURES[name](y, x, rng).astype(np.uint8)), "TIFF",
                         compression="zstd")
            with Image.open(io.BytesIO(data)) as im:
                at, n = im.tag_v2[273][0], im.tag_v2[279][0]
            for _ in range(40):
                e = bytearray(data)
                for _ in range(int(rng.integers(1, 3))):
                    e[at + int(rng.integers(0, n))] = int(rng.integers(0, 256))
                want, got = _pil_outcome(bytes(e)), _port(bytes(e))
                if isinstance(got, Exception):
                    assert isinstance(want, Exception), got
                    seen["both refuse"] += 1
                else:
                    assert not isinstance(want, Exception) and np.array_equal(got, want)
                    seen["equal"] += 1
    assert seen["equal"] > 50 and seen["both refuse"] >= 2, seen


def test_bigtiff_as_pil():
    """BigTIFF: LONG8 offsets, 20-byte entries, values of up to 8 bytes in
    the entry, strips and tiles; a big-endian BigTIFF header PIL reads as a
    classic one and so fails on, as the port does."""
    pic = _picture(4, 21, 13)
    for comp in (1, 5, 8, 34925):
        for kw in ({}, {"tile": (16, 16)}, {"rows_per_strip": 5}):
            _equal_to_pil(tiff_file(pic, 8, 2, comp=comp, big=True, **kw))
            _agree(tiff_file(pic, 8, 2, comp=comp, big=True, endian=">", **kw))
    assert isinstance(_port(tiff_file(pic, 8, 2, big=True, endian=">")), Exception)


# --- what is refused -------------------------------------------------------------------

def _cut_strip(data: bytes) -> bytes:
    """A one-strip RGB TIFF of PIL's with the strip cut to half."""
    with Image.open(io.BytesIO(data)) as im:
        (w, h), at, n = im.size, im.tag_v2[273][0], im.tag_v2[279][0]
        comp = im.tag_v2[259]
    return tiff_from_chunks([data[at:at + n // 2]], h, [
        (256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]), (259, 3, [comp]), (262, 3, [2]),
        (277, 3, [3])])


def _broken():
    pic = _picture(6, 9, 7)
    big = tiff_file(pic, 8, 2, big=True)
    g4 = ccitt_tiff(pic[..., 0] < 100, 4, Image)
    strip = lambda comp, body: tiff_from_chunks(  # noqa: E731
        [body], 7, [(256, 4, [9]), (257, 4, [7]), (258, 3, [1]), (259, 3, [comp]),
                    (262, 3, [0]), (277, 3, [1])])
    return {
        "lzma_truncated": (tiff_file(pic, 8, 2, comp=34925, codec=lambda c: lzma.compress(
            c, format=lzma.FORMAT_XZ)[:60]), "LZMA"),
        "old_lzw_truncated": (tiff_file(pic, 8, 2, comp=5, codec=lambda c: lzw_tiff_old(c)[:40]),
                              "not enough LZW data"),
        "bigtiff_header": (big[:12], "truncated BigTIFF header"),
        "g4_empty_strip": (strip(4, b"\0"), "premature end of data"),
        "rle_cut_strip": (strip(2, bytes(g4[8:12])), "premature end of data"),
        "ccitt_8_bit": (tiff_file(pic[..., :1], 8, 0, comp=4, codec=bytes),
                        "CCITT Group 4 of (8,)-bit"),
        "pf_zero_scale": (b"Pf\n2 1\n0\n" + bytes(8), "scale must be finite and non-zero"),
        "pf_truncated": (b"Pf\n2 2\n-1\n" + bytes(12), "truncated"),
        "p0cmyk_truncated": (b"P0CMYK 2 2 255\n" + bytes(15), "truncated"),
        "zstd_not_a_frame": (tiff_file(pic, 8, 2).replace(
            b"\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00",
            b"\x03\x01\x03\x00\x01\x00\x00\x00\x50\xc3"), "ZSTD: unknown frame descriptor"),
        "zstd_truncated": (_cut_strip(_save(Image.fromarray(pic), "TIFF", compression="zstd")),
                           "ZSTD"),
        "rlew": (strip(32771, bytes(g4[8:12])), "premature end of data"),
    }


BROKEN = _broken()
# the broken files PIL reads on (none)
PIL_READS = set()


@pytest.mark.parametrize("kind", sorted(BROKEN))
def test_broken_files_raise_texture_error(tmp_path, kind, monkeypatch):
    """Each raises TextureError naming the file and its cause, with PIL
    blocked, and leaves the atlas as it was."""
    data, words = BROKEN[kind]
    path = tmp_path / "t.bin"
    path.write_bytes(data)
    monkeypatch.setitem(sys.modules, "PIL", None)
    atlas, values = bytearray(b"keep"), []
    with pytest.raises(TextureError) as err:
        read_texture(str(path), atlas, values)
    assert str(path) in str(err.value) and words in str(err.value), str(err.value)
    assert atlas == b"keep" and values == []


@pytest.mark.parametrize("kind", sorted(set(BROKEN) - PIL_READS))
def test_pil_fails_on_the_broken_files(tmp_path, kind):
    """The broken files are broken for PIL too (from a path, as the JAX
    package opens them)."""
    path = tmp_path / "t.bin"
    path.write_bytes(BROKEN[kind][0])
    with pytest.raises(Exception):
        with Image.open(path) as im:
            im.convert("RGB")


# --- read_texture, scenes, and the JAX package --------------------------------------------

SCENE_FIXTURES = ("cubes_g4.tif", "lab_lzma.tif", "float_pred3.tif", "p0cmyk.pnm",
                  "bigtiff_lzw.tif", "g3_2d_fill.tif", "old_lzw.tif", "ycbcr_22_lzw.tif",
                  "float_be.pfm", "pyrgba.pnm")


def test_read_texture_without_pil_matches_the_jax_package(monkeypatch):
    """read_texture of the slice's kinds, with PIL blocked, gives the JAX
    package's read_texture's atlas bytes and (offset, w, h) values."""
    from relativitypathtracer_tpu.models.texture import read_texture as jax_read

    want_atlas, want_values = bytearray(), []
    for name in SCENE_FIXTURES:
        jax_read(str(FIXTURES / name), want_atlas, want_values)
    monkeypatch.setitem(sys.modules, "PIL", None)
    atlas, values = bytearray(), []
    for name in SCENE_FIXTURES:
        read_texture(str(FIXTURES / name), atlas, values)
    assert values == want_values and atlas == want_atlas


_TEXTURE_PATHS = ("textures", "textures_packed", "tex_quads", "tex_fp", "objects.tex_offset",
                  "objects.tex_w", "objects.tex_h")


def _leaf(scene, path):
    for part in path.split("."):
        scene = getattr(scene, part)
    return scene


def test_scene_with_lzma_g4_float_and_cmyk_pnm_textures_matches_jax(tmp_path):
    """A DSL scene with Group 4, LZMA CIELab, float and P0CMYK textures,
    each shared by two objects, through the JAX package's build_scene (PIL)
    and the port's: every texture array exact, and the JAX scene carried
    over by scene_from_numpy equal to the port's own build."""
    import jax

    from relativitypathtracer_tpu import build_scene as jbuild
    from relativitypathtracer_tpu.models.dsl import parse_scene as jparse

    names = SCENE_FIXTURES[:4]
    for name in names:
        (tmp_path / name).write_bytes((FIXTURES / name).read_bytes())
    n = len(names)
    objects = [f"{'Os' if k % 2 else 'Oc'}\n p{k % 7 - 3},{k // 7 - 1},{6 + k % 3},0,0,1,0,0.6,"
               f"0.6,0.6\n t{k % n}\n" for k in range(2 * n)]
    text = "".join(f"T{name}\n" for name in names) + "".join(objects) + "R\n"
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


def test_cubes_fixture_takes_the_windowed_route(tmp_path):
    """chip_smoke's cubes scene with cubes_g4.tif builds an atlas past the
    small route's 1,024 rows: its fetch is K8's (windowed)."""
    from relativitypathtracer_tpu_torch.ops.kernels.texture_kernel import texture_route
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    scene_file = write_demo_scene(str(tmp_path), 1, "cubes")
    old = next(pathlib.Path(tmp_path, "Textures").iterdir())
    old.unlink()
    old.with_name("cubes_g4.tif").write_bytes((FIXTURES / "cubes_g4.tif").read_bytes())
    text = pathlib.Path(scene_file).read_text().replace(f"Textures/{old.name}",
                                                        "Textures/cubes_g4.tif")
    pathlib.Path(scene_file).write_text(text)
    scene, _ = pt.build_scene(pt.load_scene_file(scene_file), device="cpu")
    assert texture_route(scene.tex_quads.shape[0]) == "windowed"
