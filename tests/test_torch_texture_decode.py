"""The port's texture decoders (utils/image_decode: decode_jpeg, decode_png)
against PIL, the JAX package's decoder.

Tolerance 0: every decode equals `np.asarray(Image.open(f).convert("RGB"))`
byte for byte. JPEGs written by PIL over sizes, qualities, chroma
subsamplings, greyscale and the frame types (baseline, optimised Huffman
tables, progressive, restart markers); a hand-built 4:4:0 file (PIL cannot
write one); the port's own `encode_jpeg`; PNGs written by PIL in every mode
it writes, and hand-built 16-bit and Adam7-interlaced ones (PIL writes
neither); the committed fixtures of tests/torch_textures against the hashes
PIL gave (pil_rgb.json). Each refused kind raises TextureError naming what
it refused, with PIL blocked as without it; the kinds once refused that now
decode (CMYK, Adobe RGB, 3x1 sampling, GIF) equal PIL. A DSL scene with
JPEG, progressive-JPEG and PNG textures builds to the JAX package's texture
arrays.
"""

import hashlib
import io
import json
import pathlib
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image
from torch_textures.make_fixtures import jpeg_scans, png_bad_crc, png_chunks

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch.models.texture import TextureError, decode_texture, read_texture
from relativitypathtracer_tpu_torch.utils import image
from relativitypathtracer_tpu_torch.utils.demo_scene import demo_texture, write_demo_scene
from relativitypathtracer_tpu_torch.utils import image_decode
from relativitypathtracer_tpu_torch.utils.image_decode import decode_jpeg, decode_png

FIXTURES = pathlib.Path(__file__).resolve().parent / "torch_textures"


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _equal_to_pil(got, data: bytes) -> None:
    want = _pil(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), f"{int((got != want).sum())} values differ"


def _picture(seed: int, w: int, h: int) -> np.ndarray:
    """(h, w, 3) uint8: gradients and edges under seeded noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 7 + y * 3, x * x // 3 + y, (y * 11) ^ (x * 5)], -1) % 256
    return np.clip(base + rng.integers(-30, 30, (h, w, 3)), 0, 255).astype(np.uint8)


# --- JPEG written by PIL ----------------------------------------------------

SIZES = ((1, 1), (7, 5), (17, 33), (64, 48), (129, 65))  # (w, h)
QUALITIES = (50, 85, 95, 100)
SUBSAMPLINGS = ("4:4:4", "4:2:2", "4:2:0", "L")
FRAMES = {"baseline": {}, "optimized": {"optimize": True}, "progressive": {"progressive": True},
          "restart": {"restart_marker_blocks": 2}}


def _jpeg_cases():
    """Ten cases a frame type, so that each size, quality and subsampling
    appears with each frame type; and progressive files with restart
    markers and with optimised tables."""
    cases = []
    for f, frame in enumerate(FRAMES):
        for i in range(10):
            cases.append((frame, SIZES[i % 5], QUALITIES[(i + f) % 4],
                          SUBSAMPLINGS[(i // 2 + f) % 4]))
    cases += [("progressive+restart", (64, 48), 85, "4:2:0"),
              ("progressive+restart", (129, 65), 95, "L"),
              ("progressive+optimized", (17, 33), 75, "4:2:2")]
    return cases


@pytest.mark.parametrize("frame,size,quality,sub", _jpeg_cases(),
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_pil_jpeg_decodes_as_pil(frame, size, quality, sub):
    rgb = _picture(quality + size[0], *size)
    kw = {"quality": quality}
    for part in frame.split("+"):
        kw.update(FRAMES.get(part, {}))
    im = Image.fromarray(rgb)
    if sub == "L":
        im = im.convert("L")
    else:
        kw["subsampling"] = sub
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    data = buf.getvalue()
    if "restart" in frame:
        assert b"\xff\xdd" in data and (b"\xff\xd0" in data or size[0] * size[1] < 300)
    _equal_to_pil(decode_jpeg(data), data)


# --- hand-built JPEGs ---------------------------------------------------------

def _crafted_blocks(rng, n: int) -> np.ndarray:
    """(n, 64) zig-zag coefficients: lone values after runs of 15-47 zeros
    (ZRLs), the last coefficient at 63 (no EOB), dense runs, and DC swings
    across blocks; the dense ones large enough that samples leave 0-255
    and saturate."""
    out = np.zeros((n, 64), np.int32)
    for i in range(n):
        kind = i % 4
        if kind == 0:
            out[i, 1 + (15, 16, 17, 31, 32, 47)[i % 6]] = rng.choice([-1, 1]) * rng.integers(1, 60)
        elif kind == 1:
            out[i, 63] = 37
            out[i, 1:63:5] = rng.integers(-30, 30, 13)
        elif kind == 2:
            out[i, 1:12] = rng.integers(-40, 40, 11)
        out[i, 0] = (100, -100, 60, -60)[i % 4] * (1 if i % 3 else -1)
    return out


def _jfif(coefs, comp, height: int, width: int, sampling: bytes, quality: int) -> bytes:
    """A baseline JFIF file of (blocks, 64) zig-zag coefficients in coding
    order, `comp` each block's component (0 Y, 1 Cb, 2 Cr), the SOF's
    sampling bytes for Y, Cb, Cr."""
    qy, qc = image.quant_tables(quality)
    scan = image._entropy_code(coefs, comp)
    dqt = b"".join(bytes([k]) + np.asarray(t)[image.ZIGZAG].astype(np.uint8).tobytes()
                   for k, t in enumerate((qy, qc)))
    sof = struct.pack(">BHHB", 8, height, width, 3) + bytes(
        [1, sampling[0], 0, 2, sampling[1], 1, 3, sampling[2], 1])
    dht = b"".join(bytes([tc_th]) + bytes(counts) + bytes(symbols) for tc_th, (counts, symbols)
                   in zip((0x00, 0x10, 0x01, 0x11), (image._DC_LUMA, image._AC_LUMA,
                                                     image._DC_CHROMA, image._AC_CHROMA)))
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (b"\xff\xd8" + image._segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + image._segment(0xDB, dqt) + image._segment(0xC0, sof) + image._segment(0xC4, dht)
            + image._segment(0xDA, sos) + scan + b"\xff\xd9")


@pytest.mark.parametrize("width,height", [(16, 8), (37, 29), (3, 50)])
def test_hand_built_440_jpeg_decodes_as_pil(width, height):
    """4:4:0 (Y sampled 1x2, so libjpeg's h1v2 fancy upsampling): MCUs of
    8 x 16 pixels, two vertically stacked Y blocks then Cb then Cr, with
    crafted coefficients; PIL cannot write this subsampling."""
    with pytest.raises(TypeError):
        Image.new("RGB", (8, 8)).save(io.BytesIO(), "JPEG", subsampling="4:4:0")
    mcus = -(-width // 8) * -(-height // 16)
    coefs = _crafted_blocks(np.random.default_rng(width), mcus * 4)
    data = _jfif(coefs, np.tile([0, 0, 1, 2], mcus), height, width, b"\x12\x11\x11", 75)
    with Image.open(io.BytesIO(data)) as im:
        assert im.layer[0][1:3] == (1, 2)  # PIL read Y's sampling as 1x2
    _equal_to_pil(decode_jpeg(data), data)


def test_crafted_420_coefficients_decode_as_pil():
    """4:2:0 with the crafted blocks (runs, a last coefficient at 63, DC
    swings, 0xFF stuffing) at unit quantisation, through image.jfif."""
    coefs = _crafted_blocks(np.random.default_rng(3), 12 * 6).reshape(12, 6, 64)
    coefs[:, :4, 0] *= 10
    ones = np.ones(64, np.int64)
    data = image.jfif(coefs, 48, 64, ones, ones)
    assert b"\xff\x00" in data[data.index(b"\xff\xda"):]
    _equal_to_pil(decode_jpeg(data), data)


@pytest.mark.parametrize("quality", [40, 85, 98])
def test_encode_jpeg_output_decodes_as_pil(quality):
    rgb = demo_texture(96)[:70, :90]
    data = image.encode_jpeg(rgb, quality)
    _equal_to_pil(decode_jpeg(data), data)


# --- progressive JPEGs with unsent bits: libjpeg's block smoothing -------------

def _progressive(sub: str, w: int, h: int, quality: int = 80) -> bytes:
    im = Image.fromarray(_picture(w * 7 + h + quality, w, h))
    kw = {"quality": quality, "progressive": True}
    if sub == "L":
        im = im.convert("L")
    else:
        kw["subsampling"] = sub
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _scan_count(data: bytes) -> int:
    return data.count(b"\xff\xda")


SMOOTH_SIZES = ((8, 8), (40, 8), (33, 16), (20, 17), (16, 24), (9, 40), (64, 48))


@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4", "L"])
@pytest.mark.parametrize("size", SMOOTH_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_dc_only_progressive_decodes_as_pil(size, sub):
    """The DC scan alone (DC at Al 1, never refined, no AC sent): every
    block's first nine ACs and its DC estimated from the 5x5 DC
    neighbourhood; images one and two block rows high (and, at 4:2:0,
    three: libjpeg's last-iMCU-row count), narrow and wide."""
    data = jpeg_scans(_progressive(sub, *size), {0})
    assert _scan_count(data) == 1
    _equal_to_pil(decode_jpeg(data), data)


@pytest.mark.parametrize("sub", ["4:2:0", "4:4:4", "L"])
@pytest.mark.parametrize("size", [(40, 24), (17, 9), (23, 17), (64, 48)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_every_cut_of_a_progressive_file_decodes_as_pil(size, sub):
    """libjpeg's default scan script cut after each of its scans (and an
    EOI): coefficients sent to Al 1 or 2, some never; each cut smoothed as
    libjpeg smooths it."""
    data = _progressive(sub, *size)
    for k in range(1, _scan_count(data)):
        cut = jpeg_scans(data, set(range(k)))
        _equal_to_pil(decode_jpeg(cut), cut)


@pytest.mark.parametrize("sub", ["4:2:0", "4:4:4"])
@pytest.mark.parametrize("size", [(8, 8), (35, 26), (64, 48)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_missing_chroma_ac_scans_decode_as_pil(size, sub):
    """Luma complete and both chroma components' AC scans (first and
    refinement) left out: chroma smoothed with its DC re-estimated, luma
    untouched."""
    data = jpeg_scans(_progressive(sub, *size, quality=90), {0, 1, 4, 5, 6, 9})
    _equal_to_pil(decode_jpeg(data), data)


@pytest.mark.parametrize("keep", [{0, 1}, {0, 1, 2}, {0, 1, 2, 3}, {0, 2}, {0, 1, 2, 4}],
                         ids=lambda k: "+".join(map(str, sorted(k))))
def test_grey_progressive_with_scans_left_out_decodes_as_pil(keep):
    """Greyscale: ACs 1-5 at Al 2 without 6-63, the refinement to Al 1
    without the last, the DC refined while the ACs are not."""
    for size in ((8, 16), (31, 40)):
        data = jpeg_scans(_progressive("L", *size), keep)
        _equal_to_pil(decode_jpeg(data), data)


def test_smoothing_changes_what_it_should():
    """Without the smoothing a DC-only file decodes to other bytes than
    PIL's (the cases above test it), and a complete progressive file is
    never smoothed (smoothing_ok finds every coefficient sent)."""
    data = jpeg_scans(_progressive("4:2:0", 40, 24), {0})
    try:
        keep = image_decode._smoothing_ok
        image_decode._smoothing_ok = lambda frame, prog, latched: False
        assert not np.array_equal(decode_jpeg(data), _pil(data))
    finally:
        image_decode._smoothing_ok = keep


@pytest.mark.parametrize("case", [c for c in _jpeg_cases() if "progressive" in c[0]],
                         ids=lambda c: "x".join(map(str, c[1])) + f"-{c[0]}-{c[3]}")
def test_complete_progressive_files_are_not_smoothed(case, monkeypatch):
    """Every complete progressive case above (and the committed
    progressive.jpg) keeps its bytes: smoothing_ok finds no unsent bit, so
    the decode is the one without smoothing."""
    frame, size, quality, sub = case
    im = Image.fromarray(_picture(quality + size[0], *size))
    kw = {"quality": quality, "progressive": True}
    if "restart" in frame:
        kw["restart_marker_blocks"] = 2
    if "optimized" in frame:
        kw["optimize"] = True
    if sub == "L":
        im = im.convert("L")
    else:
        kw["subsampling"] = sub
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    real, seen = image_decode._smoothing_ok, []
    monkeypatch.setattr(image_decode, "_smoothing_ok",
                        lambda *args: seen.append(real(*args)) or seen[-1])
    for data in (buf.getvalue(), (FIXTURES / "progressive.jpg").read_bytes()):
        seen.clear()
        got = decode_jpeg(data)
        assert seen == [False]
        _equal_to_pil(got, data)


# --- PNG ----------------------------------------------------------------------

def _pil_png(mode: str, w: int, h: int) -> bytes:
    rgb = _picture(w * h, w, h)
    rng = np.random.default_rng(w + h)
    if mode == "I;16":
        im = Image.fromarray(rng.integers(0, 1200, (h, w)).astype(np.uint16))
        assert im.mode == "I;16"
    elif mode.startswith("P"):
        im = Image.fromarray(rgb).quantize(int(mode[1:]))
    elif mode in ("LA", "RGBA"):
        alpha = rng.integers(0, 256, (h, w, 1), dtype=np.uint8)
        im = Image.fromarray(np.concatenate([rgb, alpha], 2), "RGBA").convert(mode)
    else:
        im = Image.fromarray(rgb).convert(mode)
    buf = io.BytesIO()
    im.save(buf, "PNG", **({"transparency": 1} if mode.startswith("P") else {}))
    return buf.getvalue()


@pytest.mark.parametrize("size", [(1, 1), (45, 23)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["1", "L", "LA", "P2", "P16", "P256", "RGB", "RGBA", "I;16"])
def test_pil_png_decodes_as_pil(mode, size):
    data = _pil_png(mode, *size)
    _equal_to_pil(decode_png(data), data)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _hand_png(w, h, depth, ctype, interlace, seed) -> bytes:
    """A PNG of seeded bytes under seeded filter types (0-4) a row, every
    pass of Adam7 when interlaced; a palette of 200 entries for type 3, so
    that some indices fall past it."""
    rng = np.random.default_rng(seed)
    raw = bytearray()
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            for _ in range(ph):
                raw += bytes([int(rng.integers(0, 5))]) + rng.integers(
                    0, 256, -(-pw * _CHANNELS[ctype] * depth // 8), dtype=np.uint8).tobytes()
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                              interlace))
    if ctype == 3:
        out += _chunk(b"PLTE", rng.integers(0, 256, 600, dtype=np.uint8).tobytes())
    out += _chunk(b"gAMA", struct.pack(">I", 45455))  # an ancillary chunk, skipped
    return out + _chunk(b"IDAT", zlib.compress(bytes(raw))) + _chunk(b"IEND", b"")


@pytest.mark.parametrize("ctype,depth,interlace", [
    (2, 16, 0), (6, 16, 0), (4, 16, 0), (0, 2, 0), (0, 4, 0), (3, 1, 0), (3, 4, 0),
    (0, 1, 1), (0, 16, 1), (2, 8, 1), (2, 16, 1), (3, 4, 1), (3, 8, 1), (4, 8, 1), (6, 16, 1)],
    ids=lambda v: str(v))
def test_hand_built_png_decodes_as_pil(ctype, depth, interlace):
    """16-bit RGB, RGBA and grey + alpha (high bytes), sub-byte depths, and
    Adam7 at every colour type, all five filters; PIL writes none of
    these kinds (it ignores interlace=1)."""
    for w, h in ((1, 1), (3, 2), (13, 9), (40, 33)):
        data = _hand_png(w, h, depth, ctype, interlace, seed=w * 100 + ctype * 10 + depth)
        _equal_to_pil(decode_png(data), data)


def test_16_bit_grey_clips_at_255_as_pil():
    """A quirk of PIL, and so of the JAX package, that the port keeps: 16-bit
    grey opens as I;16 and converts to RGB clipped, not scaled (4000 ->
    255), where 16-bit RGB keeps each sample's high byte."""
    samples = np.array([[4000, 255, 256, 100, 65535, 0]], np.uint16)
    buf = io.BytesIO()
    Image.fromarray(samples).save(buf, "PNG")
    got = decode_png(buf.getvalue())
    assert got[0, :, 0].tolist() == [255, 255, 255, 100, 255, 0]
    _equal_to_pil(got, buf.getvalue())


# --- the committed fixtures ---------------------------------------------------

_RECORD = json.loads((FIXTURES / "pil_rgb.json").read_text())


@pytest.mark.parametrize("name", sorted(_RECORD["files"]))
def test_committed_fixture_hashes(name):
    """Each file's PIL decode still has its recorded hash (the JSON cannot go
    stale), and the port's decode has the same."""
    data = (FIXTURES / name).read_bytes()
    want = _RECORD["files"][name]
    pil = _pil(data)
    assert list(pil.shape) == want["shape"]
    assert hashlib.sha256(pil.tobytes()).hexdigest() == want["sha256"]
    assert hashlib.sha256(decode_texture(data).tobytes()).hexdigest() == want["sha256"]


# --- what the loader refuses --------------------------------------------------

def _jpeg_bytes(mode="RGB", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_picture(5, 40, 24)).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _segments(data: bytes):
    """(marker, start, end) of each marker segment of a JPEG up to its
    first SOS, and the offset where the rest starts."""
    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((data[pos + 1], pos, pos + 2 + length))
        pos += 2 + length
    return out, pos


def _patched_sof(data: bytes, offset: int, value: int) -> bytes:
    """`data` with byte `offset` of its SOF segment's body set to `value`."""
    segs, _ = _segments(data)
    start = next(s for m, s, _ in segs if m in (0xC0, 0xC2)) + 4
    return data[:start + offset] + bytes([value]) + data[start + offset + 1:]


def _adobe_rgb() -> bytes:
    """A 3-component JPEG with no JFIF marker and an Adobe APP14 marker of
    transform 0: libjpeg reads its components as RGB."""
    data = image.encode_jpeg(_picture(6, 32, 16))
    segs, _ = _segments(data)
    _, s, e = next(x for x in segs if x[0] == 0xE0)
    app14 = image._segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    return data[:s] + app14 + data[e:]


def _unsent_progressive() -> bytes:
    """A progressive file cut after its first two scans (DC, then Y's AC 1-5
    at Al 2): coefficient bits are left unsent, which libjpeg block-smooths."""
    data = _jpeg_bytes(progressive=True)
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    assert len(sos) >= 6
    return data[:sos[2]] + b"\xff\xd9"


def _bad_crc_png() -> bytes:
    data = bytearray(_pil_png("RGB", 9, 7))
    idat = data.index(b"IDAT")
    length = int.from_bytes(data[idat - 4:idat], "big")
    data[idat + 4 + length] ^= 0x55
    return bytes(data)


def _huge_jpeg() -> bytes:
    """A JPEG whose SOF says 65535x65535: PIL's decompression-bomb limit."""
    data = _jpeg_bytes()
    data = _patched_sof(_patched_sof(data, 1, 0xFF), 2, 0xFF)
    return _patched_sof(_patched_sof(data, 3, 0xFF), 4, 0xFF)


def _huge_png() -> bytes:
    """A PNG whose IHDR says 20000x10000 (2e8 pixels, over PIL's limit)."""
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", 20000, 10000, 8, 2, 0,
                                                                0, 0))
            + _chunk(b"IDAT", zlib.compress(b"\x00" * 10)) + _chunk(b"IEND", b""))


def _gif() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_picture(7, 8, 8)).save(buf, "GIF")
    return buf.getvalue()



def _pil_outcome(data: bytes):
    try:
        return _pil(data)
    except Exception as e:  # noqa: BLE001 - any failure is PIL's refusal
        return e


def _png_with_text_and_idats() -> bytes:
    """A palette PNG with a tEXt chunk before its image data and the data
    split over IDAT chunks of 40 bytes."""
    data = _pil_png("P16", 23, 19)
    chunks = png_chunks(data)
    idat = next(c for c in chunks if c[0] == b"IDAT")
    body = data[idat[1] + 8:idat[2] - 4]
    split = b"".join(_chunk(b"IDAT", body[i:i + 40]) for i in range(0, len(body), 40))
    return data[:idat[1]] + _chunk(b"tEXt", b"key\0value") + split + data[idat[2]:]


# PIL's PngImagePlugin: CRCs are checked before the image data (IHDR, PLTE,
# ancillary chunks) and not after it; the image data may end the file
_PNG_CASES = {
    "bad_crc_ihdr": (lambda d: png_bad_crc(d, b"IHDR"), "bad CRC in chunk b'IHDR'"),
    "bad_crc_plte": (lambda d: png_bad_crc(d, b"PLTE"), "bad CRC in chunk b'PLTE'"),
    "bad_crc_text": (lambda d: png_bad_crc(d, b"tEXt"), "bad CRC in chunk b'tEXt'"),
    "bad_crc_idat": (lambda d: png_bad_crc(d, b"IDAT"), None),
    "bad_crc_iend": (lambda d: png_bad_crc(d, b"IEND"), None),
    "cut_inside_idat": (lambda d: d[:png_chunks(d)[-3][1] + 30], "truncated"),
    "cut_in_last_idat": (lambda d: d[:png_chunks(d)[-2][2] - 10], "truncated"),
    "cut_in_zlib_checksum": (lambda d: d[:png_chunks(d)[-2][2] - 6], None),
    "cut_after_idat": (lambda d: d[:png_chunks(d)[-2][2]], None),
    "cut_in_idat_crc": (lambda d: d[:png_chunks(d)[-2][2] - 2], None),
    "no_iend": (lambda d: d[:-12], None),
    "chunk_after_iend": (lambda d: d + _chunk(b"zzZz", b"abc"), None),
    "junk_after_iend": (lambda d: d + b"junk", None),
    "truncated_chunk_after_idat": (lambda d: d[:-12] + _chunk(b"tEXt", b"k\0v")[:-6], "truncated"),
    "idat_then_other_chunk": (lambda d: d[:png_chunks(d)[-3][2]] + _chunk(b"tEXt", b"k\0v")
                              + d[png_chunks(d)[-2][1]:], "truncated"),
}


@pytest.mark.parametrize("kind", sorted(_PNG_CASES))
def test_png_read_as_pil_reads_it(kind, monkeypatch):
    """A bad CRC, a missing IEND or a file cut short: the port gives PIL's
    pixels where PIL gives pixels (words None) and raises naming the cause
    where PIL fails."""
    make, words = _PNG_CASES[kind]
    data = make(_png_with_text_and_idats())
    want = _pil_outcome(data)
    monkeypatch.setitem(sys.modules, "PIL", None)
    if words is None:
        assert not isinstance(want, Exception), want
        assert np.array_equal(decode_png(data), want)
    else:
        assert isinstance(want, Exception)
        with pytest.raises(image_decode.DecodeError, match=words.replace("(", r"\(")):
            decode_png(data)


def test_icon_png_entries_follow(monkeypatch):
    """ICO and ICNS PNG entries are read by decode_png, so an entry with a
    bad IDAT CRC or without IEND decodes to PIL's pixels there too."""
    from torch_textures.make_fixtures import icns_file, icon_file

    png = _pil_png("RGB", 16, 16)
    for entry in (png_bad_crc(png, b"IDAT"), png[:-12]):
        for data in (icon_file(1, [(16, 16, 0, 32, entry)]), icns_file([(b"icp4", entry)])):
            want = _pil(data)
            monkeypatch.setitem(sys.modules, "PIL", None)
            assert np.array_equal(decode_texture(data), want)
            monkeypatch.undo()


@pytest.mark.parametrize("mode", ["RGB", "P16", "L", "RGBA"])
def test_png_every_cut_and_crc_agrees_with_pil(mode):
    """Every cut of a PNG file, and each chunk's body and CRC with a byte
    flipped: the port's pixels are PIL's, or both fail."""
    data = _png_with_text_and_idats() if mode == "P16" else _pil_png(mode, 17, 13)
    cases = [data[:cut] for cut in range(8, len(data) + 1)]
    for _, start, end in png_chunks(data):
        for at in (start + 9, end - 1):
            if at < len(data):
                cases.append(data[:at] + bytes([data[at] ^ 0x24]) + data[at + 1:])
    for case in cases:
        want = _pil_outcome(case)
        try:
            got = decode_png(case)
        except image_decode.DecodeError as e:
            got = e
        if isinstance(want, Exception) or isinstance(got, Exception):
            assert isinstance(want, Exception) and isinstance(got, Exception), (len(case), want,
                                                                                got)
        else:
            assert np.array_equal(got, want), len(case)

REFUSED = {
    "truncated_jpeg": (lambda: _jpeg_bytes()[:len(_jpeg_bytes()) // 2], "truncated"),
    "truncated_png": (lambda: _pil_png("RGB", 30, 20)[:len(_pil_png("RGB", 30, 20)) // 2],
                      "truncated"),
    "bad_crc": (_bad_crc_png, None),
    "arithmetic_sof9": (lambda: (lambda d: d.replace(b"\xff\xc0", b"\xff\xc9", 1))(_jpeg_bytes()),
                        None),
    "cmyk": (lambda: _jpeg_bytes("CMYK"), None),
    "twelve_bit": (lambda: _patched_sof(_jpeg_bytes(), 0, 12), "12-bit precision"),
    "sampling_3": (lambda: _patched_sof(_jpeg_bytes(), 7, 0x31), None),
    "adobe_rgb": (_adobe_rgb, None),
    "unsent_progressive": (_unsent_progressive, None),
    "gif": (_gif, None),
    "huge_jpeg": (_huge_jpeg, "65535x65535 is more pixels than 178,956,970"),
    "huge_png": (_huge_png, "20000x10000 is more pixels than 178,956,970"),
    "unknown": (lambda: b"\x00\x01 not an image", "unknown format"),
}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_refused_kinds_raise_texture_error(tmp_path, kind, monkeypatch):
    """Each refused file raises TextureError naming its path and what was
    refused, with PIL blocked (no fallback), though PIL opens most of them.
    The kinds once refused that the port now decodes (words None: CMYK and
    Adobe-RGB JPEG, a 3x1-sampled JPEG, GIF, a progressive JPEG with
    unsent bits, which libjpeg block-smooths, a Huffman file labelled
    arithmetic-coded (SOF9), which libjpeg decodes to garbage without an
    error, and a PNG with a bad IDAT CRC, which PIL does not check) read to
    PIL's pixels."""
    make, words = REFUSED[kind]
    data = make()
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
    assert atlas == b"keep" and values == []  # nothing of a partial image


@pytest.mark.parametrize("kind", ["huge_jpeg", "huge_png"])
def test_pil_refuses_the_huge_images(kind):
    """The pixel limit is PIL's: it refuses both files as decompression
    bombs, before reading their data."""
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(REFUSED[kind][0]()))


def test_pil_opens_the_refused_jpegs():
    """The file labelled arithmetic-coded is a file PIL decodes, so the
    port decodes it too (PIL refuses the 12-bit one)."""
    for kind, shape in (("arithmetic_sof9", (24, 40, 3)),):
        assert _pil(REFUSED[kind][0]()).shape == shape


def test_read_texture_without_pil(tmp_path, monkeypatch):
    """read_texture decodes a JPEG, a progressive JPEG and a PNG with PIL
    blocked in sys.modules, to PIL's decode of each."""
    files = {"a.jpg": _jpeg_bytes(), "b.jpg": _jpeg_bytes(progressive=True),
             "c.png": _pil_png("RGBA", 21, 17)}
    wants = {name: _pil(data) for name, data in files.items()}
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    atlas, values = bytearray(), []
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        read_texture(str(tmp_path / name), atlas, values)
    offset = 0
    for k, (name, want) in enumerate(wants.items()):
        h, w, _ = want.shape
        assert values[3 * k:3 * k + 3] == [offset, w, h]
        assert bytes(atlas[offset:offset + want.size]) == want.tobytes(), name
        offset += want.size


# --- scenes -------------------------------------------------------------------

_TEXTURE_PATHS = ("textures", "textures_packed", "tex_quads", "tex_fp", "objects.tex_offset",
                  "objects.tex_w", "objects.tex_h")


def _leaf(scene, path):
    for part in path.split("."):
        scene = getattr(scene, part)
    return scene


def test_scene_with_jpeg_and_png_textures_matches_jax(tmp_path):
    """A JPEG, a progressive JPEG and a PNG texture, each shared by several
    objects, through the JAX package's build_scene (PIL) and the port's:
    every texture array exact, and the JAX scene carried over by
    scene_from_numpy equal to the port's own build."""
    import jax

    from relativitypathtracer_tpu import build_scene as jbuild
    from relativitypathtracer_tpu.models.dsl import parse_scene as jparse

    Image.fromarray(_picture(1, 37, 21)).save(tmp_path / "a.jpg", quality=90)
    Image.fromarray(_picture(2, 16, 40)).save(tmp_path / "b.jpg", progressive=True)
    (tmp_path / "c.png").write_bytes(_pil_png("RGBA", 24, 24))
    objects = []
    for k in range(7):
        shape = "Os" if k % 2 else "Oc"
        objects.append(f"{shape}\n p{k - 3},0,{5 + k % 3},0,0,1,0,1,1,1\n t{k % 3}\n")
    text = "Ta.jpg\nTb.jpg\nTc.png\n" + "".join(objects) + "R\n"
    js, jm = jbuild(jparse(text, str(tmp_path)))
    ps, pm = pt.build_scene(pt.parse_scene(text, str(tmp_path)), device="cpu")
    assert pm.textured_ids == tuple(range(7)) and pm.use_footprint_tex == jm.use_footprint_tex
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


@pytest.mark.parametrize("kind", ["textured", "cubes"])
def test_demo_scene_texture_formats(tmp_path, kind):
    """write_demo_scene's texture_format: the PNG fixture's atlas equals the
    PPM fixture's byte for byte (write_png is fed the texture flipped, so
    its rows are the PPM's); the JPEG fixture's equals PIL's decode of its
    file. The default stays PPM."""
    hosts = {}
    for fmt in ("ppm", "png", "jpg"):
        scene = write_demo_scene(str(tmp_path / fmt), 1, kind, texture_format=fmt)
        assert f".{fmt}\n" in pathlib.Path(scene).read_text()
        hosts[fmt] = pt.load_scene_file(scene)
    default = write_demo_scene(str(tmp_path / "default"), 1, kind)
    assert ".ppm\n" in pathlib.Path(default).read_text()
    assert bytes(hosts["png"].textures) == bytes(hosts["ppm"].textures)
    assert hosts["png"].texture_values == hosts["ppm"].texture_values
    jpg = next((tmp_path / "jpg" / "Textures").glob("*.jpg")).read_bytes()
    assert bytes(hosts["jpg"].textures) == _pil(jpg).tobytes()
    assert hosts["jpg"].texture_values == hosts["ppm"].texture_values
