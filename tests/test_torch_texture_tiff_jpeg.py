"""JPEG-in-TIFF textures (utils/tiff_decode: compression 7, JPEG, and 6,
old-style JPEG) against PIL, the JAX package's decoder.

Tolerance 0: every decode equals `np.asarray(Image.open(f).convert("RGB"))`
byte for byte. PIL reads these files through libtiff, which hands each
strip or tile to libjpeg: PIL's compression-7 files in RGB, YCbCr, L,
CMYK and RGBA; hand-built ones (tests/torch_textures/make_fixtures.py's
jpeg_tiff: tiles, 4:2:0 and 4:2:2 YCbCr, the JPEGTables tag or whole
streams, a stream that carries its own tables over the tag's, a last strip
coded at the full strip height, planar RGB, progressive and
arithmetic-coded streams); old-style files (ojpeg_tiff) as the interchange
format and with the tables in tags. What libtiff refuses (a sampling that
disagrees with the YCbCrSubsampling tag, a stream of another component
count or larger than its tile) raises TextureError naming it, and fails in
PIL too. read_texture and a DSL scene against the JAX package's.
"""

import io
import pathlib
import sys

import numpy as np
import pytest
from PIL import Image
from torch_textures.make_fixtures import (SEED, arith_jpeg, jpeg_split, jpeg_tiff, ojpeg_tiff,
                                          tiff_from_chunks, tiff_jpegs)

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch.models.texture import TextureError, decode_texture, read_texture

FIXTURES = pathlib.Path(__file__).resolve().parent / "torch_textures"
TIFF_JPEGS = tiff_jpegs(np.random.default_rng(SEED + 5), Image)


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _equal_to_pil(data: bytes) -> None:
    want = _pil(data)
    got = decode_texture(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), f"{int((got != want).sum())} values differ"


def _picture(seed: int, w: int, h: int, n: int = 3) -> np.ndarray:
    """(h, w, n) uint8: gradients and edges under seeded noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 7 + y * 3, x * x // 3 + y, (y * 11) ^ (x * 5), x * y][:n], -1) % 256
    return np.clip(base + rng.integers(-30, 30, (h, w, n)), 0, 255).astype(np.uint8)


def _jpeg(pic, quality=80, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(pic, "CMYK" if pic.ndim == 3 and pic.shape[2] == 4 else None).save(
        buf, "JPEG", quality=quality, **kw)
    return buf.getvalue()


def _save(im, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "TIFF", compression="jpeg", **kw)
    return buf.getvalue()


# --- the committed fixtures ---------------------------------------------------

@pytest.mark.parametrize("name", sorted(TIFF_JPEGS))
def test_committed_file_is_what_tiff_jpegs_writes_and_decodes_as_pil(name):
    data = (FIXTURES / name).read_bytes()
    assert TIFF_JPEGS[name] == data
    _equal_to_pil(data)


# --- PIL's files ----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["RGB", "YCbCr", "L", "CMYK", "RGBA"])
@pytest.mark.parametrize("size,quality,strip", [((27, 18), 75, None), ((40, 33), 95, 8),
                                                ((1, 1), 50, None), ((70, 9), 85, 16)])
def test_pil_written_jpeg_tiff_decodes_as_pil(mode, size, quality, strip):
    w, h = size
    pic = _picture(w + quality, w, h, 4 if mode in ("CMYK", "RGBA") else 3)
    im = Image.fromarray(pic, "CMYK" if mode == "CMYK" else None)
    im = im if mode in ("CMYK",) else im.convert(mode)
    _equal_to_pil(_save(im, quality=quality, **({"tiffinfo": {278: strip}} if strip else {})))


# --- built here ---------------------------------------------------------------

BUILT = {
    "ycc420_strips": lambda: jpeg_tiff(_picture(1, 45, 37), 6, (45, 16), Image,
                                       subsampling="4:2:0"),
    "ycc420_no_tag": lambda: jpeg_tiff(_picture(2, 45, 37), 6, (45, 16), Image,
                                       subsampling="4:2:0", tag530=None),
    "ycc444_no_tag": lambda: jpeg_tiff(_picture(3, 30, 20), 6, (30, 8), Image,
                                       subsampling="4:4:4", tag530=None),
    "ycc422_tiles": lambda: jpeg_tiff(_picture(4, 50, 35), 6, (32, 16), Image, tile=True,
                                      subsampling="4:2:2"),
    "ycc420_tiles_inline": lambda: jpeg_tiff(_picture(5, 33, 20), 6, (16, 16), Image,
                                             tile=True, subsampling="4:2:0", inline=True),
    "ycc420_full_last": lambda: jpeg_tiff(_picture(6, 21, 41), 6, (21, 16), Image,
                                          subsampling="4:2:0", full_last=True),
    "rgb_strips": lambda: jpeg_tiff(_picture(7, 25, 19), 2, (25, 8), Image, subsampling="4:4:4"),
    "rgb_tiles": lambda: jpeg_tiff(_picture(8, 40, 40), 2, (16, 32), Image, tile=True,
                                   subsampling="4:4:4"),
    "rgb_planar": lambda: jpeg_tiff(_picture(9, 31, 17), 2, (31, 8), Image, planar=2),
    "grey_tiles": lambda: jpeg_tiff(_picture(10, 37, 22, 1), 1, (16, 16), Image, tile=True),
    "min_is_white": lambda: jpeg_tiff(_picture(11, 19, 13, 1), 0, (19, 13), Image),
    "cmyk_strips": lambda: jpeg_tiff(_picture(12, 23, 21, 4), 5, (23, 8), Image),
}


@pytest.mark.parametrize("case", sorted(BUILT))
def test_hand_built_jpeg_tiff_decodes_as_pil(case):
    _equal_to_pil(BUILT[case]())


def _strips(streams, h, w, photo, tables=None, sub=None, rows=None):
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * 3), (259, 3, [7]),
            (262, 3, [photo]), (277, 3, [3]), (284, 3, [1])]
    if tables:
        tags.append((347, 7, tables))
    if sub:
        tags.append((530, 3, list(sub)))
    return tiff_from_chunks(streams, h, tags, None, rows or h)


def test_a_stream_s_own_tables_replace_the_tags():
    """JPEGTables from a quality-30 file, strips coded at quality 90 that
    carry their own tables: libjpeg uses the stream's."""
    pic = _picture(13, 24, 32)
    tables = jpeg_split(_jpeg(pic, quality=30))[0]
    streams = [_jpeg(pic[y:y + 16], quality=90, subsampling="4:4:4") for y in (0, 16)]
    _equal_to_pil(_strips(streams, 32, 24, 2, tables, rows=16))


def test_a_later_stream_keeps_an_earlier_stream_s_tables():
    """libjpeg keeps the tables an image stream defined for the streams
    after it: the first strip carries quality-90 tables, the second none,
    over JPEGTables of quality 30."""
    pic = _picture(14, 24, 32)
    tables = jpeg_split(_jpeg(pic, quality=30))[0]
    first = _jpeg(pic[:16], quality=90, subsampling="4:4:4")
    second = jpeg_split(_jpeg(pic[16:], quality=90, subsampling="4:4:4"))[1]
    _equal_to_pil(_strips([first, second], 32, 24, 2, tables, rows=16))


@pytest.mark.parametrize("kind", ["progressive", "arithmetic", "arithmetic_progressive"])
def test_progressive_and_arithmetic_streams_decode_as_pil(kind):
    pic = _picture(15, 30, 22)
    stream = _jpeg(pic, progressive=kind != "arithmetic")
    if kind.startswith("arithmetic"):
        stream = arith_jpeg(stream)
    _equal_to_pil(_strips([stream], 22, 30, 6, sub=(2, 2)))


# --- old-style JPEG -------------------------------------------------------------

OLD_STYLE = {
    "jif_420": lambda: ojpeg_tiff(_jpeg(_picture(20, 32, 24)), "jif"),
    "jif_420_sos": lambda: ojpeg_tiff(_jpeg(_picture(21, 29, 19)), "jif_sos"),
    "jif_444_over_tag_22": lambda: ojpeg_tiff(_jpeg(_picture(22, 26, 21), subsampling="4:4:4"),
                                              "jif"),
    "jif_422_no_tag": lambda: ojpeg_tiff(_jpeg(_picture(23, 33, 17), subsampling="4:2:2"),
                                         "jif_sos", sub=None),
    "jif_444_q100": lambda: ojpeg_tiff(_jpeg(_picture(33, 40, 40), quality=100,
                                             subsampling="4:4:4"), "jif", sub=(1, 1)),
    "jif_photometric_rgb": lambda: ojpeg_tiff(_jpeg(_picture(24, 18, 18)), "jif", sub=None,
                                              photo=2),
    "jif_restart": lambda: ojpeg_tiff(_jpeg(_picture(25, 40, 24), restart_marker_blocks=1),
                                      "jif_sos"),
    "tables_420": lambda: ojpeg_tiff(_jpeg(_picture(26, 32, 24)), "tables"),
    "tables_444": lambda: ojpeg_tiff(_jpeg(_picture(27, 21, 15), subsampling="4:4:4"),
                                     "tables", sub=(1, 1)),
    "tables_three_strips": lambda: ojpeg_tiff([_jpeg(_picture(28 + k, 22, 16 if k < 2 else 5))
                                               for k in range(3)], "tables", rows=16),
    "tables_grey": lambda: ojpeg_tiff(_jpeg(_picture(31, 27, 13)[..., 0]), "tables", sub=None,
                                      photo=1),
}


@pytest.mark.parametrize("case", sorted(OLD_STYLE))
def test_old_style_jpeg_decodes_as_pil(case):
    """libtiff's old-style codec hands libjpeg's raw planes to its own YCbCr
    conversion, each chroma sample repeated over its luma block."""
    _equal_to_pil(OLD_STYLE[case]())


def test_old_style_chroma_is_repeated_not_filtered():
    """The same 4:2:0 stream in a JPEG file (libjpeg's fancy upsampling)
    and as old-style JPEG-in-TIFF (repeated chroma) decodes to other
    pixels, in PIL and the port alike."""
    stream = _jpeg(_picture(32, 32, 24))
    assert not np.array_equal(decode_texture(stream), decode_texture(ojpeg_tiff(stream, "jif")))


# --- what libtiff refuses ---------------------------------------------------------

def _refused():
    pic = _picture(40, 24, 16)
    s420, s444 = _jpeg(pic), _jpeg(pic, subsampling="4:4:4")
    grey = _jpeg(pic[..., 0])
    ojpeg_cmyk = ojpeg_tiff(_jpeg(_picture(41, 16, 8, 4)), "jif", sub=None)
    return {
        "tag_11_stream_22": (_strips([s420], 16, 24, 6, sub=(1, 1)),
                             "improper JPEG sampling factors"),
        "tag_22_stream_11": (_strips([s444], 16, 24, 6, sub=(2, 2)),
                             "improper JPEG sampling factors"),
        "rgb_subsampled": (_strips([s420], 16, 24, 2), "improper JPEG sampling factors"),
        "grey_stream_in_rgb": (_strips([grey], 16, 24, 2), "improper JPEG component count"),
        "stream_wider_than_strip": (_strips([_jpeg(_picture(42, 32, 16))], 16, 24, 6,
                                            sub=(2, 2)), "32x16 where 24x16 is expected"),
        "not_a_jpeg_stream": (_strips([bytes(200)], 16, 24, 6, sub=(2, 2)),
                              "not a JPEG stream"),
        "ojpeg_progressive": (ojpeg_tiff(_jpeg(pic, progressive=True), "jif"),
                              "old-style JPEG of a progressive"),
        "ojpeg_four_samples": (ojpeg_cmyk.replace(b"\x15\x01\x03\x00\x01\x00\x00\x00\x03",
                                                  b"\x15\x01\x03\x00\x01\x00\x00\x00\x04"),
                               "YCbCr at (8, 8, 8, 8) bits"),
    }


REFUSED = _refused()


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_refused_forms_raise_texture_error_and_fail_in_pil(tmp_path, kind, monkeypatch):
    data, words = REFUSED[kind]
    with pytest.raises(Exception):
        _pil(data)
    path = tmp_path / "t.tif"
    path.write_bytes(data)
    monkeypatch.setitem(sys.modules, "PIL", None)
    atlas, values = bytearray(b"keep"), []
    with pytest.raises(TextureError) as err:
        read_texture(str(path), atlas, values)
    assert str(path) in str(err.value) and words in str(err.value), str(err.value)
    assert atlas == b"keep" and values == []


def test_stream_shorter_than_its_strip_is_refused():
    """A stream of fewer rows than its strip: libtiff reads what it has and
    PIL shows the rest of its strip buffer, memory the file never wrote;
    the port refuses the file."""
    pic = _picture(43, 24, 16)
    with pytest.raises(ValueError, match="24x16 where 24x24 is expected"):
        decode_texture(_strips([_jpeg(pic)], 24, 24, 6, sub=(2, 2)))


# --- read_texture and a scene against the JAX package -----------------------------

NAMES = sorted(TIFF_JPEGS)


def test_read_texture_without_pil_matches_the_jax_package(monkeypatch):
    from relativitypathtracer_tpu.models.texture import read_texture as jax_read

    want_atlas, want_values = bytearray(), []
    for name in NAMES:
        jax_read(str(FIXTURES / name), want_atlas, want_values)
    monkeypatch.setitem(sys.modules, "PIL", None)
    atlas, values = bytearray(), []
    for name in NAMES:
        read_texture(str(FIXTURES / name), atlas, values)
    assert values == want_values and atlas == want_atlas


def test_scene_with_jpeg_tiff_textures_matches_jax(tmp_path):
    """A DSL scene with every JPEG-in-TIFF fixture as a texture through the
    JAX package's build_scene (PIL) and the port's: every texture array
    exact."""
    from relativitypathtracer_tpu import build_scene as jbuild
    from relativitypathtracer_tpu.models.dsl import parse_scene as jparse

    for name in NAMES:
        (tmp_path / name).write_bytes((FIXTURES / name).read_bytes())
    objects = [f"Oc\n p{k % 5 - 2},{k // 5 - 1},7,0,0,1,0,0.6,0.6,0.6\n t{k}\n"
               for k in range(len(NAMES))]
    text = "".join(f"T{name}\n" for name in NAMES) + "".join(objects) + "R\n"
    js, jm = jbuild(jparse(text, str(tmp_path)))
    ps, pm = pt.build_scene(pt.parse_scene(text, str(tmp_path)), device="cpu")
    assert pm.use_footprint_tex == jm.use_footprint_tex
    for path in ("textures", "tex_quads", "objects.tex_offset", "objects.tex_w",
                 "objects.tex_h"):
        want, got = js, ps
        for part in path.split("."):
            want, got = getattr(want, part), getattr(got, part)
        assert np.array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64)), path
