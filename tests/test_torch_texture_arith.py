"""Arithmetic-coded JPEG (utils/jpeg_arith, through utils/image_decode)
against PIL, the JAX package's decoder.

Tolerance 0: every decode equals `np.asarray(Image.open(f).convert("RGB"))`
byte for byte. PIL writes no arithmetic-coded file, so the files are PIL's
Huffman-coded JPEGs transcoded by tests/torch_textures/make_fixtures.py's
arithmetic encoder (libjpeg's jcarith.c): each must decode in PIL to the
bytes of its source, which holds the writer right apart from the port.
Sequential 4:2:0, 4:4:4 and grey, progressive with successive
approximation, restart intervals, non-default DAC conditioning, a cut
progressive file that libjpeg block-smooths, CMYK; the QM coder alone on
random decisions; Huffman files relabelled SOF9 and SOF10, which libjpeg
decodes to garbage without an error (a magnitude or spectral overflow stops
an interval); the arithmetic kinds still refused. read_texture and a DSL
scene against the JAX package's.
"""

import io
import pathlib
import sys

import numpy as np
import pytest
from PIL import Image
from torch_textures.make_fixtures import SEED, QMEncoder, arith_jpeg, arith_sources, jpeg_scans

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch.models.texture import TextureError, decode_texture, read_texture
from relativitypathtracer_tpu_torch.utils import image, jpeg_arith

FIXTURES = pathlib.Path(__file__).resolve().parent / "torch_textures"
ARITH = arith_sources(np.random.default_rng(SEED + 4), Image)


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


def _jpeg(rgb, mode="RGB", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rgb).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


# --- the committed fixtures and their writer ----------------------------------

@pytest.mark.parametrize("name", sorted(ARITH))
def test_the_writer_makes_the_committed_file(name):
    assert ARITH[name][0] == (FIXTURES / name).read_bytes()
    assert ARITH[name][0][2:] != ARITH[name][1][2:]


@pytest.mark.parametrize("name", sorted(ARITH))
def test_pil_decodes_the_arithmetic_file_as_its_source(name):
    """The writer is right apart from the port: libjpeg's arithmetic
    decoder gives the pixels of the Huffman-coded source."""
    arith, source = ARITH[name]
    assert b"\xff\xc4" not in arith and (b"\xff\xc9" in arith or b"\xff\xca" in arith)
    assert np.array_equal(_pil(arith), _pil(source))


@pytest.mark.parametrize("name", sorted(ARITH))
def test_committed_arithmetic_file_decodes_as_pil(name):
    _equal_to_pil((FIXTURES / name).read_bytes())


# --- PIL's files over sizes, frames and subsamplings, transcoded --------------

SIZES = ((1, 1), (7, 5), (17, 33), (64, 48), (129, 65))  # (w, h)
FRAMES = {"baseline": {}, "progressive": {"progressive": True},
          "restart": {"restart_marker_blocks": 1},
          "progressive+restart": {"progressive": True, "restart_marker_blocks": 3}}
SUBSAMPLINGS = ("4:4:4", "4:2:2", "4:2:0", "L")


def _cases():
    return [(frame, SIZES[(i + f) % 5], SUBSAMPLINGS[(i + 2 * f) % 4], (50, 75, 90, 100)[i])
            for f, frame in enumerate(FRAMES) for i in range(4)]


@pytest.mark.parametrize("frame,size,sub,quality", _cases(),
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_transcoded_pil_jpeg_decodes_as_pil(frame, size, sub, quality):
    kw = {"quality": quality}
    for part in frame.split("+"):
        kw.update(FRAMES[part])
    if sub != "L":
        kw["subsampling"] = sub
    source = _jpeg(_picture(quality + size[0], *size), "L" if sub == "L" else "RGB", **kw)
    data = arith_jpeg(source)
    assert np.array_equal(_pil(data), _pil(source))
    _equal_to_pil(data)


@pytest.mark.parametrize("keep", [{0}, {0, 1}, {0, 1, 2, 3}, {0, 1, 2, 3, 4, 5, 6},
                                  {0, 1, 4, 5, 6, 9}])
def test_cut_progressive_files_smooth_as_pil(keep):
    """A progressive file with scans left out, transcoded: libjpeg
    block-smooths the arithmetic file as the Huffman one."""
    source = jpeg_scans(_jpeg(_picture(len(keep), 40, 27), quality=80, progressive=True), keep)
    data = arith_jpeg(source)
    assert np.array_equal(_pil(data), _pil(source))
    _equal_to_pil(data)


# --- DAC conditioning ---------------------------------------------------------

DACS = {"L0_U0": bytes([0x00, 0x00, 0x01, 0x00]), "L1_U3": bytes([0x00, 0x31, 0x01, 0x31]),
        "L2_U5_K1": bytes([0x00, 0x52, 0x10, 1, 0x11, 1]),
        "L0_U15_K63": bytes([0x00, 0xF0, 0x01, 0xF0, 0x10, 63, 0x11, 63]),
        "K20_table1": bytes([0x11, 20]), "L5_U5": bytes([0x00, 0x55, 0x01, 0x55])}


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("dac", sorted(DACS))
def test_dac_conditioning_decodes_as_pil(dac, progressive):
    source = _jpeg(_picture(3, 41, 30), quality=92, progressive=progressive)
    data = arith_jpeg(source, DACS[dac])
    assert np.array_equal(_pil(data), _pil(source))
    _equal_to_pil(data)


def test_dac_segment_is_read():
    """Without its DAC segment the dac fixture decodes to other pixels in
    PIL and in the port alike: the conditioning is not a default."""
    data = (FIXTURES / "arith_dac.jpg").read_bytes()
    at = data.index(b"\xff\xcc")
    stripped = data[:at] + data[at + 2 + int.from_bytes(data[at + 2:at + 4], "big"):]
    assert not np.array_equal(_pil(stripped), _pil(data))
    _equal_to_pil(stripped)


# --- large coefficients -------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_large_magnitudes_decode_as_pil(seed):
    """Crafted coefficients under a quantisation table of ones: DC
    differences to +-2047 and ACs to +-1023 (magnitude categories 1 to
    11), transcoded from a Huffman file."""
    rng = np.random.default_rng(seed)
    w, h = 24, 16
    comp = np.tile([0, 0, 0, 0, 1, 2], 2)
    coefs = np.zeros((comp.size, 64), np.int32)
    coefs[:, 0] = rng.integers(-1000, 1000, comp.size)
    coefs[:, 1:] = rng.integers(-1023, 1024, (comp.size, 63)) * (rng.random((comp.size, 63))
                                                                 < 0.3)
    dqt = bytes([0]) + bytes([1] * 64) + bytes([1]) + bytes([1] * 64)
    sof = bytes([8, 0, h, 0, w, 3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    dht = b"".join(bytes([k]) + bytes(counts) + bytes(symbols) for k, (counts, symbols)
                   in zip((0x00, 0x10, 0x01, 0x11), (image._DC_LUMA, image._AC_LUMA,
                                                     image._DC_CHROMA, image._AC_CHROMA)))
    source = (b"\xff\xd8" + image._segment(0xDB, dqt) + image._segment(0xC0, sof)
              + image._segment(0xC4, dht)
              + image._segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
              + image._entropy_code(coefs, comp) + b"\xff\xd9")
    data = arith_jpeg(source)
    assert np.array_equal(_pil(data), _pil(source))
    _equal_to_pil(data)


# --- the QM coder alone ---------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_qm_decoder_reads_back_the_encoder(seed):
    """20,000 decisions in random bins (skewed so that states run up the
    table and carries and stacked 0xFF bytes occur), coded by
    make_fixtures' QMEncoder and read back by jpeg_arith.Decoder from the
    unstuffed bytes."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, 40, 20_000)
    p = rng.random(40) ** 3
    bits = (rng.random(20_000) < p[bins]).astype(int).tolist()
    enc, stats = QMEncoder(), bytearray(40)
    for b, v in zip(bins.tolist(), bits):
        enc(stats, b, v)
    enc.finish()
    coded = bytes(enc.out).replace(b"\xff\x00", b"\xff")
    dec, stats = jpeg_arith.Decoder(coded), bytearray(40)
    assert [dec(stats, b) for b in bins.tolist()] == bits


def test_qe_table_is_libjpegs():
    """Table D.2's shape: 113 states and the fixed one, each next state in
    range, the switch only on states of Qe above 0x5000."""
    assert len(jpeg_arith.QE) == 114 and jpeg_arith.QE[113] == (0x5a1d, 113, 113)
    for qe, lps, mps in jpeg_arith.QE[:113]:
        assert 0 < qe < 0x8000 and (lps & 0x7F) < 113 and mps < 113
        assert not lps & 0x80 or qe > 0x5000


# --- Huffman files relabelled ----------------------------------------------------

RELABELLED = {
    "sof9_baseline": (lambda: _jpeg(_picture(5, 40, 24)), 0xC9),
    "sof9_restart": (lambda: _jpeg(_picture(6, 48, 32), restart_marker_blocks=1), 0xC9),
    "sof9_grey_q100": (lambda: _jpeg(_picture(7, 33, 17), "L", quality=100), 0xC9),
    "sof10_progressive": (lambda: _jpeg(_picture(8, 40, 24), progressive=True), 0xCA),
    "sof10_progressive_restart": (lambda: _jpeg(_picture(9, 36, 30), progressive=True,
                                                restart_marker_blocks=2), 0xCA),
}


@pytest.mark.parametrize("kind", sorted(RELABELLED))
def test_relabelled_huffman_files_decode_as_pil(kind):
    """Huffman data read as arithmetic-coded: garbage that libjpeg decodes
    without an error, overflows stopping an interval's decoding."""
    make, marker = RELABELLED[kind]
    data = make()
    sof = next(m for m in (b"\xff\xc0", b"\xff\xc2") if m in data)
    _equal_to_pil(data.replace(sof, bytes([0xFF, marker]), 1))


# --- what stays refused -------------------------------------------------------

STILL_REFUSED = {0xCB: "arithmetic-coded lossless JPEG (SOF11)",
                 0xCD: "arithmetic-coded differential sequential JPEG (SOF13)",
                 0xCE: "arithmetic-coded differential progressive JPEG (SOF14)",
                 0xCF: "arithmetic-coded differential lossless JPEG (SOF15)"}


@pytest.mark.parametrize("marker", sorted(STILL_REFUSED))
def test_other_arithmetic_kinds_are_refused(tmp_path, marker, monkeypatch):
    """SOF11 and SOF13-15 raise TextureError naming the kind, with PIL
    blocked and the atlas untouched; PIL fails on each too."""
    data = (FIXTURES / "arith_s420.jpg").read_bytes().replace(b"\xff\xc9", bytes([0xFF, marker]))
    with pytest.raises(OSError):
        _pil(data)
    path = tmp_path / "t.jpg"
    path.write_bytes(data)
    monkeypatch.setitem(sys.modules, "PIL", None)
    atlas, values = bytearray(b"keep"), []
    with pytest.raises(TextureError, match=STILL_REFUSED[marker].replace("(", r"\(")
                       .replace(")", r"\)")):
        read_texture(str(path), atlas, values)
    assert atlas == b"keep" and values == []


def test_bad_dac_is_refused():
    """A DAC segment with L above U: libjpeg's JERR_DAC_VALUE, in PIL too."""
    data = (FIXTURES / "arith_dac.jpg").read_bytes().replace(b"\xff\xcc\x00\x0a\x00\x31",
                                                             b"\xff\xcc\x00\x0a\x00\x13")
    with pytest.raises(OSError):
        _pil(data)
    with pytest.raises(ValueError, match="L above U"):
        decode_texture(data)


def test_large_file_pil_cannot_suspend_on():
    """PIL hands libjpeg its file 64 KB at a time, and libjpeg's arithmetic
    decoder cannot suspend for more, so PIL fails on a file whose scan runs
    past its first read; read in one piece it decodes, and the port gives
    those pixels."""
    from relativitypathtracer_tpu_torch.utils.demo_scene import demo_texture

    data = arith_jpeg(_jpeg(demo_texture(384), quality=95))
    assert len(data) > 65536
    with pytest.raises(OSError):
        _pil(data)
    with Image.open(io.BytesIO(data)) as im:
        im.decodermaxblock = len(data) + 1
        want = np.asarray(im.convert("RGB"))
    assert np.array_equal(decode_texture(data), want)


# --- read_texture and a scene against the JAX package -----------------------------

ARITH_FIXTURES = sorted(ARITH)


def test_read_texture_without_pil_matches_the_jax_package(monkeypatch):
    from relativitypathtracer_tpu.models.texture import read_texture as jax_read

    want_atlas, want_values = bytearray(), []
    for name in ARITH_FIXTURES:
        jax_read(str(FIXTURES / name), want_atlas, want_values)
    monkeypatch.setitem(sys.modules, "PIL", None)
    atlas, values = bytearray(), []
    for name in ARITH_FIXTURES:
        read_texture(str(FIXTURES / name), atlas, values)
    assert values == want_values and atlas == want_atlas


def test_scene_with_arithmetic_textures_matches_jax(tmp_path):
    """A DSL scene with the arithmetic-coded textures through the JAX
    package's build_scene (PIL) and the port's: every texture array
    exact."""
    from relativitypathtracer_tpu import build_scene as jbuild
    from relativitypathtracer_tpu.models.dsl import parse_scene as jparse

    names = ARITH_FIXTURES
    for name in names:
        (tmp_path / name).write_bytes((FIXTURES / name).read_bytes())
    objects = [f"Os\n p{k % 5 - 2},{k // 5 - 1},7,0,0,1,0,0.6,0.6,0.6\n t{k}\n"
               for k in range(len(names))]
    text = "".join(f"T{name}\n" for name in names) + "".join(objects) + "R\n"
    js, _ = jbuild(jparse(text, str(tmp_path)))
    ps, _ = pt.build_scene(pt.parse_scene(text, str(tmp_path)), device="cpu")
    for path in ("textures", "tex_quads", "objects.tex_offset", "objects.tex_w",
                 "objects.tex_h"):
        want, got = js, ps
        for part in path.split("."):
            want, got = getattr(want, part), getattr(got, part)
        assert np.array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64)), path
