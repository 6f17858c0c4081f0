"""The port's WebP decoder (utils/webp_decode, utils/webp_lossless,
utils/webp_lossy) against PIL, the JAX package's decoder.

Tolerance 0: every decode equals `np.asarray(Image.open(f).convert("RGB"))`
byte for byte, which for a WebP is the first frame drawn on the canvas,
alpha dropped. Files PIL writes: lossless (with and without `exact`, with
alpha, palettes of 2 to 200 colours, every quality and method), lossy at
several qualities, methods and odd sizes, with alpha at several alpha
qualities. Files built here (tests/torch_textures/make_fixtures.py's
builders) for what PIL's encoder never writes: VP8 key frames from a
boolean encoder with the simple filter, every sharpness, 2, 4 and 8
partitions, segmentation with per-segment quantiser and filter levels,
absolute and relative, loop-filter deltas and skip flags; VP8L with simple
codes only and colour-indexed at every bundling width; uncompressed ALPH
under each filter; animations whose first frame is smaller than the
canvas. Broken and truncated files raise TextureError with the atlas
untouched (PIL fails on each too). A DSL scene with lossless and lossy
WebP textures and a block-smoothed progressive JPEG builds to the JAX
package's texture arrays.
"""

import io
import pathlib
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from torch_textures.make_fixtures import (alph_raw, anmf, riff_webp, vp8_frame, vp8l_palette,
                                          vp8l_simple, vp8x, webp_chunks)

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch.models.texture import TextureError, decode_texture, read_texture
from relativitypathtracer_tpu_torch.utils import webp_decode, webp_lossless
from relativitypathtracer_tpu_torch.utils.webp_decode import decode_webp

FIXTURES = pathlib.Path(__file__).resolve().parent / "torch_textures"
WEBP_FIXTURES = sorted(p.name for p in FIXTURES.glob("*.webp"))
SMOOTHED_FIXTURES = sorted(p.name for p in FIXTURES.glob("prog_*.jpg"))


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _equal_to_pil(data: bytes) -> None:
    want = _pil(data)
    got = decode_webp(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), f"{int((got != want).sum())} values differ"


def _picture(seed: int, w: int, h: int, alpha: bool = False) -> Image.Image:
    """Gradients and edges under seeded noise; with `alpha`, an alpha ramp
    with every fifth diagonal transparent."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 7 + y * 3, x * x // 3 + y, (y * 11) ^ (x * 5)], -1) % 256
    rgb = np.clip(base + rng.integers(-30, 30, (h, w, 3)), 0, 255).astype(np.uint8)
    if not alpha:
        return Image.fromarray(rgb)
    a = ((x * 13 + y * 7) % 256).astype(np.uint8)[..., None]
    a[(x + y) % 5 == 0] = 0
    return Image.fromarray(np.concatenate([rgb, a], 2), "RGBA")


def _save(im, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "WEBP", **kw)
    return buf.getvalue()


# --- written by PIL -----------------------------------------------------------

SIZES = ((1, 1), (7, 5), (17, 33), (64, 48), (129, 65), (3, 70))


@pytest.mark.parametrize("alpha", [False, True], ids=["rgb", "rgba"])
@pytest.mark.parametrize("quality,method,exact", [(0, 0, False), (50, 4, True), (100, 6, False),
                                                  (75, 2, True)], ids=lambda v: str(v))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pil_lossless_decodes_as_pil(size, quality, method, exact, alpha):
    """Every transform PIL's encoder picks (predictor modes, colour
    transform, subtract-green, colour indexing), the colour cache, LZ77 and
    meta prefix codes; `exact` keeps the RGB under transparent pixels."""
    _equal_to_pil(_save(_picture(size[0] * size[1] + quality, *size, alpha), lossless=True,
                        quality=quality, method=method, exact=exact))


@pytest.mark.parametrize("colours", [2, 3, 4, 5, 11, 16, 17, 200])
def test_pil_lossless_palettes_decode_as_pil(colours):
    """Colour indexing, with pixel bundling at 2, 4 and 16 colours or fewer."""
    for w, h in ((13, 9), (40, 21)):
        im = _picture(colours * w, w, h).quantize(colours).convert("RGB")
        _equal_to_pil(_save(im, lossless=True))


@pytest.mark.parametrize("quality,method", [(0, 0), (20, 6), (50, 4), (75, 2), (90, 3),
                                            (100, 6)], ids=lambda v: str(v))
@pytest.mark.parametrize("size", SIZES + ((33, 17),), ids=lambda s: f"{s[0]}x{s[1]}")
def test_pil_lossy_decodes_as_pil(size, quality, method):
    """Odd sizes (the macroblock grid cropped, the chroma's last column and
    row), low to high quantisers, every method (4x4 prediction, filter
    strengths, segments, skip flags)."""
    _equal_to_pil(_save(_picture(size[0] * size[1] + quality, *size), quality=quality,
                        method=method))


@pytest.mark.parametrize("alpha_quality", [0, 40, 90, 100])
@pytest.mark.parametrize("size", [(1, 1), (17, 33), (64, 48), (3, 70)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_pil_lossy_with_alpha_decodes_as_pil(size, alpha_quality):
    """VP8 with an ALPH chunk (lossless-compressed alpha, its filters and
    level pre-processing); the RGB under transparent pixels as decoded."""
    _equal_to_pil(_save(_picture(size[0] + alpha_quality, *size, alpha=True), quality=70,
                        alpha_quality=alpha_quality, method=alpha_quality % 7))


def test_transparent_pixels_keep_their_rgb():
    """PIL's decoder is non-premultiplied: a lossless `exact` pixel of alpha
    0 reads back with its RGB."""
    px = np.array([[[200, 100, 50, 0], [1, 2, 3, 255]]], np.uint8)
    data = _save(Image.fromarray(px, "RGBA"), lossless=True, exact=True)
    assert decode_webp(data).tolist() == [[[200, 100, 50], [1, 2, 3]]]
    _equal_to_pil(data)


# --- built here -----------------------------------------------------------------

VP8_CASES = {
    "plain": {},
    "simple_filter": {"simple": True, "level": 30},
    "simple_sharp": {"simple": True, "level": 45, "sharpness": 5},
    "sharp1": {"sharpness": 1, "level": 12},
    "sharp4": {"sharpness": 4, "level": 50},
    "sharp7": {"sharpness": 7, "level": 63},
    "no_filter": {"level": 0, "segments": {"absolute": 0, "quant": [0, 5, 10, 15],
                                           "filter": [20, 30, 40, 50], "probs": [128, 128, 128]}},
    "partitions2": {"partitions": 2},
    "partitions4": {"partitions": 4, "skip_prob": 60},
    "partitions8": {"partitions": 8, "skip_prob": 250},
    "segments_relative": {"segments": {"absolute": 0, "quant": [-20, 0, 15, 60],
                                       "filter": [-10, 0, 10, 40], "probs": [128, 30, 220]}},
    "segments_absolute": {"segments": {"absolute": 1, "quant": [0, 30, 80, 127],
                                       "filter": [0, 8, 25, 63], "probs": [200, 100, 50]}},
    "deltas": {"deltas": ((7, -3, 2, 1), (-9, 4, 0, 6)), "level": 25},
    "deltas_simple": {"deltas": ((-20, 0, 0, 0), (25, 0, 0, 0)), "simple": True, "level": 20},
    "quant_deltas": {"base_q": 60, "qdeltas": (-7, 6, -5, 7, -8)},
    "uv_dc_cap": {"base_q": 127, "qdeltas": (0, 0, 0, 7, 0)},
    "low_q": {"base_q": 0, "qdeltas": (0, -3, -4, 0, 0)},
    "all_4x4": {"i4_share": 1.0, "density": 0.5},
    "all_16x16": {"i4_share": 0.0, "density": 0.5},
    "dense": {"density": 0.9, "updates": 40},
}


@pytest.mark.parametrize("size", [(16, 16), (37, 45), (5, 130)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", sorted(VP8_CASES))
def test_hand_built_vp8_decodes_as_pil(case, size):
    """VP8 key frames of seeded modes and coefficients under each header
    feature (partitions are taken a macroblock row each in turn, so the
    130-row frame fills 8 of them)."""
    rng = np.random.default_rng(sorted(VP8_CASES).index(case) * 1000 + size[1])
    kw = dict(VP8_CASES[case])
    _equal_to_pil(riff_webp([(b"VP8 ", vp8_frame(rng, *size, **kw))]))


@pytest.mark.parametrize("colours", [1, 2, 3, 4, 5, 16, 17, 255, 256])
def test_hand_built_vp8l_palettes_decode_as_pil(colours):
    """Colour indexing at every bundling width (8, 4, 2 and 1 indices a
    pixel) and widths that leave a partial bundle; the palette's deltas,
    code lengths with repeat codes 16, 17 and 18 and with max_symbol."""
    rng = np.random.default_rng(colours)
    for w, h in ((1, 1), (9, 4), (17, 7), (33, 3)):
        _equal_to_pil(riff_webp([(b"VP8L", vp8l_palette(rng, w, h, colours))]))


def test_hand_built_vp8l_simple_codes_decode_as_pil():
    """Simple prefix codes only: two symbols of one bit (the first coded in
    1 or 8 bits), one symbol of none."""
    rng = np.random.default_rng(5)
    for w, h in ((1, 1), (23, 14), (64, 3)):
        _equal_to_pil(riff_webp([(b"VP8L", vp8l_simple(rng, w, h))]))


@pytest.mark.parametrize("filt", [0, 1, 2, 3], ids=["none", "horizontal", "vertical", "gradient"])
def test_uncompressed_alpha_under_each_filter(filt):
    """VP8X with an ALPH chunk of raw values (compression 0) under each
    filter: decoded (and dropped) without changing the RGB; the plane
    undone by PIL and by `_alpha` is the builder's."""
    rng = np.random.default_rng(filt)
    frame = vp8_frame(rng, 19, 11)
    alpha = rng.integers(0, 256, (11, 19)).astype(np.uint8)
    data = riff_webp([vp8x(0x10, 19, 11), (b"ALPH", alph_raw(alpha, filt)), (b"VP8 ", frame)])
    _equal_to_pil(data)
    with Image.open(io.BytesIO(data)) as im:
        assert np.array_equal(np.asarray(im.convert("RGBA"))[..., 3], alpha)
    assert np.array_equal(webp_decode._alpha(alph_raw(alpha, filt), 19, 11), alpha)


@pytest.mark.parametrize("name", ["lossy_alpha.webp", "lossy_alpha_q100.webp",
                                  "vp8_normal8_alpha.webp", "lossless_alpha.webp",
                                  "lossless_exact.webp"])
def test_alpha_planes_equal_pils(name):
    """The alpha that `decode_webp` decodes and drops is PIL's RGBA alpha:
    an ALPH chunk (lossless-coded, or raw under the gradient filter) or a
    VP8L image's own."""
    data = (FIXTURES / name).read_bytes()
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert("RGBA"))[..., 3]
    chunks = dict(webp_chunks(data))
    if b"VP8L" in chunks:
        got = webp_lossless.decode_vp8l(chunks[b"VP8L"])[..., 3]
    else:
        got = webp_decode._alpha(chunks[b"ALPH"], *want.shape[::-1])
    assert np.array_equal(got, want)


def test_alpha_without_the_alpha_flag_is_dropped():
    """A still image whose VP8X lacks the alpha flag: libwebp's demuxer
    drops its ALPH chunk unread, so even a corrupt one does not fail."""
    frame = vp8_frame(np.random.default_rng(2), 12, 12)
    _equal_to_pil(riff_webp([vp8x(0, 12, 12), (b"ALPH", b"\xff\x00"), (b"VP8 ", frame)]))


@pytest.mark.parametrize("first", ["VP8 ", "VP8L", "ALPH+VP8 "])
def test_animation_shows_its_first_frame_on_the_canvas(first):
    """An animation's picture is its first frame at its ANMF offset on a
    transparent black canvas (ANIM's background colour unused, no blend),
    whatever the frames after it."""
    rng = np.random.default_rng(len(first))
    small = _picture(3, 14, 10, alpha=True)
    if first == "VP8L":
        chunks = [c for c in webp_chunks(_save(small, lossless=True)) if c[0] == b"VP8L"]
    else:
        chunks = [c for c in webp_chunks(_save(small, quality=60)) if c[0] in (b"ALPH", b"VP8 ")]
        if first == "VP8 ":
            chunks = [c for c in chunks if c[0] == b"VP8 "]
    later = [(b"VP8 ", vp8_frame(rng, 30, 24))]
    data = riff_webp([vp8x(0x12, 30, 24), (b"ANIM", bytes([50, 100, 150, 255, 0, 0])),
                      anmf(8, 12, 14, 10, chunks), anmf(0, 0, 30, 24, later, flags=2)])
    with Image.open(io.BytesIO(data)) as im:
        assert im.n_frames == 2
    got = decode_webp(data)
    assert not got[:12].any() and not got[:, :8].any() and not got[22:].any()
    _equal_to_pil(data)


@pytest.mark.parametrize("name", WEBP_FIXTURES + SMOOTHED_FIXTURES)
def test_new_fixtures_without_pil(name, monkeypatch):
    """Each committed WebP fixture and progressive JPEG with unsent bits
    through read_texture with PIL blocked gives the JAX package's
    read_texture's atlas and values."""
    from relativitypathtracer_tpu.models.texture import read_texture as jax_read

    want_atlas, want_values = bytearray(), []
    jax_read(str(FIXTURES / name), want_atlas, want_values)
    monkeypatch.setitem(sys.modules, "PIL", None)
    atlas, values = bytearray(), []
    read_texture(str(FIXTURES / name), atlas, values)
    assert values == want_values and atlas == want_atlas


# --- what the loader refuses ------------------------------------------------------

def _with(data: bytes, offset: int, value: bytes) -> bytes:
    return data[:offset] + value + data[offset + len(value):]


def _broken():
    lossless = (FIXTURES / "lossless.webp").read_bytes()
    lossy = (FIXTURES / "lossy_q80.webp").read_bytes()
    alpha = (FIXTURES / "lossy_alpha.webp").read_bytes()
    anim = (FIXTURES / "animated.webp").read_bytes()
    vp8l = dict(webp_chunks(lossless))[b"VP8L"]
    vp8 = dict(webp_chunks(lossy))[b"VP8 "]
    chunks = webp_chunks(alpha)
    alph = dict(chunks)[b"ALPH"]

    def with_alph(payload):
        return riff_webp([c if c[0] != b"ALPH" else (b"ALPH", payload) for c in chunks])

    return {
        "riff_truncated": (lossless[:len(lossless) - 9], "shorter than its RIFF size"),
        "vp8l_truncated": (riff_webp([(b"VP8L", vp8l[:len(vp8l) // 2])]), "WebP lossless"),
        "vp8l_bad_signature": (riff_webp([(b"VP8L", b"\x2e" + vp8l[1:])]), "0x2F signature"),
        "vp8l_version": (riff_webp([(b"VP8L", vp8l[:4] + bytes([vp8l[4] | 0x20]) + vp8l[5:])]),
                         "version"),
        "vp8l_bad_code": (riff_webp([(b"VP8L", vp8l[:5] + b"\xff" * 40)]), "WebP lossless"),
        "vp8_truncated": (riff_webp([(b"VP8 ", vp8[:len(vp8) // 2])]), "VP8"),
        "vp8_interframe": (riff_webp([(b"VP8 ", bytes([vp8[0] | 1]) + vp8[1:])]), "key frame"),
        "vp8_no_start_code": (riff_webp([(b"VP8 ", vp8[:3] + b"\x9d\x01\x2b" + vp8[6:])]),
                              "start code"),
        "vp8_zero_width": (riff_webp([(b"VP8 ", vp8[:6] + b"\0\0" + vp8[8:])]), "zero size"),
        "alph_bad_header": (with_alph(bytes([alph[0] | 0x40]) + alph[1:]), "ALPH"),
        "alph_bad_method": (with_alph(bytes([alph[0] | 0x03]) + alph[1:]), "ALPH"),
        "alph_truncated_raw": (with_alph(b"\x00" + bytes(20)), "ALPH"),
        "alph_truncated_lossless": (with_alph(alph[:len(alph) // 3]), "WebP lossless"),
        "frame_outside_canvas": (_with(anim, 12 + 8 + 4, (20).to_bytes(3, "little")),
                                 "does not fit"),
        "anmf_before_anim": (anim.replace(b"ANIM", b"ANIX", 1), "ANMF before ANIM"),
        "reserved_flag": (_with(anim, 20, b"\x03"), "reserved VP8X flags"),
        "no_image": (riff_webp([vp8x(0, 4, 4), (b"EXIF", b"\0" * 6)]), "no frame"),
        "chunk_past_riff": (_with(lossless, 16, (len(lossless)).to_bytes(4, "little")),
                            "runs past"),
        "huge_canvas": (riff_webp([vp8x(0x02, 16384, 16384), (b"ANIM", bytes(6)),
                                   anmf(0, 0, 23, 19, [(b"VP8L", vp8l)])]),
                        "more pixels than 178,956,970"),
    }


BROKEN = _broken()


@pytest.mark.parametrize("kind", sorted(BROKEN))
def test_broken_webp_raises_texture_error(tmp_path, kind, monkeypatch):
    """Each raises TextureError naming the file and what went wrong, with
    PIL blocked, and leaves the atlas as it was."""
    data, words = BROKEN[kind]
    path = tmp_path / "t.webp"
    path.write_bytes(data)
    monkeypatch.setitem(sys.modules, "PIL", None)
    atlas, values = bytearray(b"keep"), []
    with pytest.raises(TextureError) as err:
        read_texture(str(path), atlas, values)
    assert str(path) in str(err.value) and words in str(err.value), str(err.value)
    assert atlas == b"keep" and values == []


@pytest.mark.parametrize("kind", sorted(BROKEN))
def test_pil_fails_on_the_broken_webp(kind):
    """The broken files are broken for PIL too (the huge one past its
    decompression-bomb limit)."""
    with pytest.raises(Exception):
        _pil(BROKEN[kind][0])


def test_webp_is_told_by_its_first_chunk():
    """PIL accepts a RIFF WEBP file only when its first chunk is VP8, VP8L
    or VP8X (WebPImagePlugin._accept): another first chunk is no WebP, for
    PIL and the loader alike."""
    data = riff_webp([(b"ICCP", bytes(8)), (b"VP8L", dict(webp_chunks(
        (FIXTURES / "lossless.webp").read_bytes()))[b"VP8L"])])
    with pytest.raises(Exception):
        _pil(data)
    with pytest.raises(ValueError, match="unknown format"):
        decode_texture(data)


# --- scenes -------------------------------------------------------------------------

_TEXTURE_PATHS = ("textures", "textures_packed", "tex_quads", "tex_fp", "objects.tex_offset",
                  "objects.tex_w", "objects.tex_h")


def _leaf(scene, path):
    for part in path.split("."):
        scene = getattr(scene, part)
    return scene


def test_scene_with_webp_and_smoothed_jpeg_textures_matches_jax(tmp_path):
    """A lossless WebP, a lossy WebP with alpha, the animation and a
    progressive JPEG with unsent bits (block-smoothed), each shared by
    several objects, through the JAX package's build_scene (PIL) and the
    port's: every texture array exact, and the JAX scene carried over by
    scene_from_numpy equal to the port's own build."""
    import jax

    from relativitypathtracer_tpu import build_scene as jbuild
    from relativitypathtracer_tpu.models.dsl import parse_scene as jparse

    names = ("lossless.webp", "lossy_alpha.webp", "animated.webp", "prog_no_chroma_ac.jpg")
    for name in names:
        (tmp_path / name).write_bytes((FIXTURES / name).read_bytes())
    objects = [f"{'Os' if k % 2 else 'Oc'}\n p{k - 4},0,{6 + k % 3},0,0,1,0,0.8,0.8,0.8\n"
               f" t{k % len(names)}\n" for k in range(8)]
    text = "".join(f"T{n}\n" for n in names) + "".join(objects) + "R\n"
    js, jm = jbuild(jparse(text, str(tmp_path)))
    ps, pm = pt.build_scene(pt.parse_scene(text, str(tmp_path)), device="cpu")
    assert pm.textured_ids == tuple(range(8)) and pm.use_footprint_tex == jm.use_footprint_tex
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
