"""The port's decoders of the last simple formats PIL opens (utils/fli_decode:
FLI/FLC; utils/im_decode: IM, IMT; utils/misc_raster: GBR, McIdas, PIXAR,
SPIDER, XVThumb, IPTC; utils/pcd_decode: Photo CD) against PIL, the JAX
package's decoder.

Tolerance 0: every decode equals `np.asarray(Image.open(f).convert("RGB"))`
byte for byte, with PIL blocked while the port decodes. The committed
fixtures (tests/torch_textures/make_fixtures.py's `plugin_fixtures`), the
IM and SPIDER files PIL writes in each mode it writes, every image type of
PIL's IM table under each kind of Lut, random FLI chunk streams, random
files of the other formats, mutated fixtures (hypothesis or numpy seeds:
both give the same pixels or both refuse), PhotoYCC on all 2**24 inputs,
and broken files: each raises TextureError naming its cause, and PIL fails
on it too. A DSL scene with IM, FLI, SPIDER and McIdas textures builds to
the JAX package's texture arrays.
"""

import hashlib
import io
import json
import pathlib
import struct
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image
from torch_textures.make_fixtures import (fli_brun, fli_chunk, fli_file, fli_lc, fli_palette,
                                          fli_ss2, gbr_file, im_file, imt_file, iptc_field,
                                          iptc_file, mcidas_file, pcd_file, pixar_file,
                                          spider_file, xv_file)

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch.models import texture
from relativitypathtracer_tpu_torch.models.texture import TextureError, decode_texture, read_texture
from relativitypathtracer_tpu_torch.utils import im_decode, pcd_decode

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "torch_textures"
RECORD = json.loads((FIXTURES / "pil_rgb.json").read_text())["files"]
SUFFIXES = (".fli", ".flc", ".im", ".imt", ".gbr", ".area", ".pxr", ".spi", ".xv", ".iim", ".pcd")
PLUGINS = sorted(n for n in RECORD if n.endswith(SUFFIXES))


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _pil_outcome(data: bytes):
    """PIL's pixels, or the exception it raises."""
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


# --- the committed fixtures -----------------------------------------------------

@pytest.mark.parametrize("name", PLUGINS)
def test_fixture_decodes_to_pil_bytes(name):
    """Each committed file of the slice's formats, decoded with PIL blocked,
    equals PIL's convert("RGB") now and the hash PIL gave where it was
    made."""
    data = (FIXTURES / name).read_bytes()
    got = _port(data)
    assert not isinstance(got, Exception), got
    assert list(got.shape) == RECORD[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == RECORD[name]["sha256"]
    assert np.array_equal(got, _pil(data))


def test_every_format_of_the_slice_has_fixtures():
    """Each of the ten formats is among the fixtures as PIL's Image.open
    tells it, and every file but the Photo CD (whose base image alone is
    768 KB) is under 4 KB."""
    with_format = {}
    for name in PLUGINS:
        with Image.open(FIXTURES / name) as im:
            with_format.setdefault(im.format, []).append(name)
    assert set(with_format) == {"FLI", "IM", "IMT", "GBR", "MCIDAS", "PIXAR", "SPIDER",
                                "XVThumb", "IPTC", "PCD"}
    assert all(len((FIXTURES / n).read_bytes()) < 4096 for n in PLUGINS if n != "rotated.pcd")
    assert texture._OTHER_FORMATS == ("AVIF/HEIF", "EPS")


# --- files PIL writes --------------------------------------------------------------

IM_MODES = ("1", "L", "LA", "P", "PA", "I", "I;16", "I;16L", "I;16B", "F", "RGB", "RGBA",
            "RGBX", "CMYK", "YCbCr")


def _mode_image(mode: str, w: int, h: int, seed: int):
    rng = np.random.default_rng(seed)
    p = Image.fromarray(_picture(seed, w, h))
    if mode in ("P", "PA"):
        return p.quantize(int(rng.integers(2, 200))).convert(mode)
    if mode == "I":
        return Image.fromarray(rng.integers(-500, 800, (h, w)).astype(np.int32), "I")
    if mode.startswith("I;16"):
        return Image.fromarray(rng.integers(0, 700, (h, w)).astype(np.uint16)).convert(mode)
    if mode == "F":
        return Image.fromarray(rng.normal(100, 150, (h, w)).astype(np.float32))
    return p.convert(mode)


@pytest.mark.parametrize("mode", IM_MODES)
@pytest.mark.parametrize("size", [(1, 1), (13, 7), (32, 9)])
def test_pil_written_im_decodes_as_pil(mode, size):
    """IM files PIL writes in every mode it saves, at odd and even widths."""
    data = _save(_mode_image(mode, *size, seed=size[0] * 31 + len(mode)), "IM")
    with Image.open(io.BytesIO(data)) as im:
        assert im.format == "IM"
    _equal_to_pil(data)


@pytest.mark.parametrize("mode", ["L", "F", "I", "RGB"])
@pytest.mark.parametrize("size", [(1, 1), (5, 3), (300, 2), (17, 40)])
def test_pil_written_spider_decodes_as_pil(mode, size):
    """SPIDER files PIL writes (float32 in the host's order) from each mode,
    headers of one record and of several."""
    data = _save(_mode_image(mode, *size, seed=size[1]), "SPIDER")
    with Image.open(io.BytesIO(data)) as im:
        assert im.format == "SPIDER"
    _equal_to_pil(data)


# --- every IM image type and Lut ---------------------------------------------------------

_LUTS = {"none": None, "grey_linear": bytes(range(256)) * 3,
         "grey_inverted": bytes(255 - np.arange(256, dtype=np.uint8)) * 3,
         "colour": np.random.default_rng(3).integers(0, 256, 768, dtype=np.uint8).tobytes()}


@pytest.mark.parametrize("image_type", sorted(im_decode._OPEN))
def test_every_im_image_type_under_each_lut(image_type):
    """Every image type of ImImagePlugin.OPEN on random data, at widths
    that leave bits over and do not, without a Lut and with a grey linear,
    a grey inverted and a colour one: the port's pixels equal PIL's, or
    both refuse (RLB, RYB, and PA without a colour Lut, PIL cannot
    unpack)."""
    rng = np.random.default_rng(len(image_type) * 7 + ord(image_type[-7]))
    for w, h in ((1, 1), (7, 3), (16, 5)):
        body = rng.integers(0, 256, w * h * 4 + 8, dtype=np.uint8).tobytes()
        for lut in _LUTS.values():
            _agree(im_file(image_type, w, h, body, lut))
        _agree(im_file(image_type, w, h, body[:w * h // 2]))  # truncated


def test_im_lut_is_stored_and_never_applied():
    """PIL stores a grey Lut that is not linear (L) and any Lut on RGB as
    `lut`, which its convert("RGB") never applies: the port's pixels are the
    samples as stored, equal to PIL's; a colour Lut on L makes P."""
    pic = _picture(4, 6, 5)
    inverted = bytes(255 - np.arange(256, dtype=np.uint8)) * 3
    grey = im_file("Greyscale image", 6, 5, pic[::-1, :, 0].tobytes(), lut=inverted)
    with Image.open(io.BytesIO(grey)) as im:
        assert im.mode == "L" and list(im.lut) == list(inverted[:256])
    assert np.array_equal(_port(grey)[..., 0], pic[..., 0])
    _equal_to_pil(grey)
    rgb = im_file("RGB image", 6, 5, pic[::-1].transpose(0, 2, 1).tobytes(), lut=inverted)
    with Image.open(io.BytesIO(rgb)) as im:
        assert im.mode == "RGB" and len(im.lut) == 768
    assert np.array_equal(_port(rgb), pic)
    _equal_to_pil(rgb)
    colour = im_file("Greyscale image", 6, 5, pic[..., 0].tobytes(), lut=_LUTS["colour"])
    with Image.open(io.BytesIO(colour)) as im:
        assert im.mode == "P"
    _equal_to_pil(colour)


def test_im_b2_with_a_colour_lut_is_read_as_8_bit_p():
    """A colour Lut turns B2's P;2 into PIL's 8-bit P raw mode: one byte a
    pixel, not four pixels a byte."""
    idx = np.arange(12, dtype=np.uint8).reshape(3, 4) * 20
    data = im_file("B2 image", 4, 3, idx[::-1].tobytes(), lut=_LUTS["colour"])
    pal = np.frombuffer(_LUTS["colour"], np.uint8).reshape(3, 256).T
    assert np.array_equal(_port(data), pal[idx])
    _equal_to_pil(data)


def test_im_header_as_pil_reads_it():
    """LF and CR LF lines, a CR before a line, a header ended by 0x1A at
    once or padded with NULs, the 512x512 default size, a size with commas,
    and a header PIL does not take (no known key) going on to the next
    plugin."""
    pic = _picture(9, 5, 4)[..., 0]
    body = pic[::-1].tobytes()
    _equal_to_pil(im_file("Greyscale image", 5, 4, body, newline=b"\n", pad=False))
    _equal_to_pil(b"\r" + im_file("Greyscale image", 5, 4, body))
    _equal_to_pil(b"Image size (x*y): 5,4\nImage type: Grayscale image\n\x1a" + body)
    big = b"Name: x\n\x1a" + bytes(512 * 512)
    assert _port(big).shape == (512, 512, 3)
    _equal_to_pil(big)
    assert isinstance(_port(b"Colour: x\n\x1a" + body), Exception)


@pytest.mark.parametrize("bits", [2, 3, 5, 7, 12, 13, 24, 31])
def test_im_bit_decoder_rows(bits):
    """L*n through PIL's bit decoder, at widths whose rows end mid-byte: a
    row's leftover bits ORed into the next row's first byte, as PIL's
    BitDecode.c leaves them."""
    rng = np.random.default_rng(bits)
    for w, h in ((1, 4), (3, 5), (11, 6)):
        line = (w * bits + 7) // 8
        data = im_file(f"L*{bits} image", w, h, rng.integers(0, 256, line * h,
                                                             dtype=np.uint8).tobytes())
        _equal_to_pil(data)


def test_imt_decodes_as_pil():
    """IM Tools files: comments, width and height in either order, rows
    after the form feed; without one PIL cannot load the image."""
    rng = np.random.default_rng(11)
    for w, h in ((1, 1), (9, 4), (40, 3)):
        body = rng.integers(0, 256, w * h, dtype=np.uint8).tobytes()
        _equal_to_pil(imt_file(w, h, body, comments=("a", "bb")))
        _equal_to_pil(b"height %d\nwidth %d\npixel n8\n\x0c" % (h, w) + body)
        _agree(b"width %d\nheight %d\npixel n8\n" % (w, h) + body)


# --- FLI/FLC -------------------------------------------------------------------------------

def random_fli(seed: int, width: int, height: int) -> bytes:
    """A frame of random sub-chunks: BRUN, LC and SS2 bodies of random
    packets (skips, copies, runs, SS2's flag words), COPY, BLACK, PSTAMP,
    and COLOR_256 or COLOR_64 palettes; sometimes a wrong size, a cut or a
    prefix chunk."""
    rng = np.random.default_rng(seed)

    def packets(n, big):
        out = bytearray()
        for _ in range(n):
            count = int(rng.integers(0, 256)) if big else int(rng.integers(0, 6))
            out += bytes([int(rng.integers(0, 4)), count])
            out += rng.integers(0, 8, 6, dtype=np.uint8).tobytes()
        return bytes(out)

    chunks = []
    if rng.random() < 0.7:
        pal = rng.integers(0, 256, (int(rng.integers(1, 257)), 3)).astype(np.uint8)
        kind = int(rng.choice([4, 11]))
        chunks.append(fli_chunk(kind, fli_palette(pal, 2 if kind == 11 else 0,
                                                  int(rng.integers(0, 3)))))
    for _ in range(int(rng.integers(1, 4))):
        kind = int(rng.choice([7, 12, 13, 15, 16, 18]))
        if kind == 15:
            body = b"".join(bytes([0]) + packets(int(rng.integers(0, 5)), rng.random() < 0.3)
                            for _ in range(height))
        elif kind == 12:
            first = int(rng.integers(0, height + 1))
            body = struct.pack("<HH", first, int(rng.integers(0, height - first + 2))) + b"".join(
                bytes([int(rng.integers(0, 4))]) + packets(3, rng.random() < 0.5)
                for _ in range(height))
        elif kind == 7:
            words = bytearray()
            for _ in range(height):
                if rng.random() < 0.3:
                    skip = int(rng.integers(65536 - 3, 65536))
                    words += struct.pack("<H", (0xC000 | skip) & 0xFFFF)
                if rng.random() < 0.3:
                    words += struct.pack("<H", 0x8000 | int(rng.integers(0, 256)))
                words += struct.pack("<H", int(rng.integers(0, 4))) + packets(3, rng.random() < 0.5)
            body = struct.pack("<H", int(rng.integers(0, height + 2))) + bytes(words)
        elif kind == 16:
            body = rng.integers(0, 256, max(0, width * height + int(rng.integers(-2, 3))),
                                dtype=np.uint8).tobytes()
        else:
            body = rng.integers(0, 256, int(rng.integers(0, 8)), dtype=np.uint8).tobytes()
        chunks.append(fli_chunk(kind, body))
    data = fli_file(width, height, chunks, magic=int(rng.choice([0xAF11, 0xAF12])),
                    prefix=b"pfx!" if rng.random() < 0.1 else b"")
    if rng.random() < 0.15:
        data = data[:int(rng.integers(120, len(data) + 1))]
    return data


@settings(derandomize=True, max_examples=150, deadline=None)
@given(width=st.integers(1, 19), height=st.integers(1, 9), seed=st.integers(0, 2**32 - 1))
def test_random_fli_frames_agree_with_pil(width, height, seed):
    """Random FLI/FLC frames: the port's pixels equal PIL's, or both
    refuse."""
    _agree(random_fli(seed, width, height))


@pytest.mark.parametrize("kind", ["brun", "lc", "ss2", "copy"])
def test_fli_chunks_encode_what_pil_reads(kind):
    """make_fixtures' FLI encoders, the fixtures' source, code what PIL
    reads back, and the port reads the same; on FLI (0xAF11) and FLC."""
    rng = np.random.default_rng(len(kind))
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    for w, h in ((1, 1), (2, 3), (31, 6), (300, 2)):
        idx = (rng.integers(0, 3, (h, w)) * (np.arange(w) % 5 != 0)).astype(np.uint8)
        body = {"brun": lambda: fli_chunk(15, fli_brun(idx)),
                "lc": lambda: fli_chunk(12, fli_lc(idx, h // 2)),
                "ss2": lambda: fli_chunk(7, fli_ss2(idx, h // 3)),
                "copy": lambda: fli_chunk(16, idx.tobytes())}[kind]()
        for magic in (0xAF11, 0xAF12):
            # the last sub-chunk needs 10 bytes before the frame's end
            data = fli_file(w, h, [fli_chunk(4, fli_palette(pal)), body,
                                   fli_chunk(18, bytes(4))], magic=magic)
            want = pal[idx]
            if kind == "lc":
                want[:h // 2] = pal[0]
            if kind == "ss2":
                want[:h // 3] = pal[0]
            assert np.array_equal(_port(data), want)
            _equal_to_pil(data)


def test_fli_prefix_chunk_and_palettes_as_pil():
    """The prefix chunk (0xF100) is skipped for the palette; the frame is
    read at byte 128 as PIL reads it (where the prefix chunk is, which
    PIL's decoder does not take); COLOR_64 values shifted up and kept
    modulo 256; no palette chunk: PIL's grey default."""
    idx = np.arange(12, dtype=np.uint8).reshape(3, 4) * 21
    pal = np.arange(768, dtype=np.int64).reshape(256, 3) % 97
    frame = [fli_chunk(11, fli_palette(pal)), fli_chunk(16, idx.tobytes())]
    _agree(fli_file(4, 3, frame, prefix=b"prefix"))
    assert isinstance(_port(fli_file(4, 3, frame, prefix=b"prefix")), Exception)
    got = _port(fli_file(4, 3, frame))
    assert np.array_equal(got, ((pal << 2) & 255).astype(np.uint8)[idx])
    _equal_to_pil(fli_file(4, 3, frame))
    grey = _port(fli_file(4, 3, frame[1:]))
    assert np.array_equal(grey[..., 0], idx)
    _equal_to_pil(fli_file(4, 3, frame[1:]))


# --- Photo CD ------------------------------------------------------------------------------

def test_photo_ycc_equals_pil_on_every_input():
    """pcd_decode.ycc_to_rgb against PIL's YCC;P unpacker (the Photo CD
    decoder's) on all 2**24 (Y, Cb, Cr) inputs."""
    c = np.arange(256, dtype=np.uint8)
    cb, cr = np.meshgrid(c, c, indexing="ij")
    for y in range(256):
        ycc = np.stack([np.full_like(cb, y), cb, cr], -1)
        want = np.asarray(Image.frombytes("RGB", (256, 256), ycc.tobytes(), "raw", "YCC;P"))
        assert np.array_equal(pcd_decode.ycc_to_rgb(ycc), want), y


@pytest.mark.parametrize("orientation", [0, 1, 2, 3, 5, 7])
def test_pcd_orientations_and_chroma_as_pil(orientation):
    """Random base images: row pairs sharing chroma, each chroma sample two
    columns wide, turned by the orientation's low two bits."""
    rng = np.random.default_rng(orientation)
    pairs = rng.integers(0, 256, (256, 3 * 768), dtype=np.uint8)
    data = pcd_file(pairs, orientation)
    _equal_to_pil(data)
    got = _port(data)
    assert got.shape == ((768, 512, 3) if orientation & 3 in (1, 3) else (512, 768, 3))


# --- the other formats: random files -------------------------------------------------------

def _random_files(seed: int):
    rng = np.random.default_rng(seed)
    w, h = int(rng.integers(1, 23)), int(rng.integers(1, 9))
    pic = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    f = (rng.normal(100, 200, (h, w)) * rng.choice([1, 1e-3, 1e6])).astype(np.float32)
    f[rng.random((h, w)) < 0.05] = np.nan
    return {
        "gbr_v1": gbr_file(pic[..., 0], 1, comment=rng.integers(1, 255, int(rng.integers(0, 9)),
                                                               dtype=np.uint8).tobytes()),
        "gbr_v2": gbr_file(np.concatenate([pic, pic[..., :1]], 2), 2),
        "mcidas_1": mcidas_file(pic[..., 0], prefix=int(rng.integers(0, 5))),
        "mcidas_2": mcidas_file(rng.integers(0, 70000, (h, w)).astype(">u2"),
                                bands=int(rng.integers(1, 3))),
        "mcidas_4": mcidas_file(rng.integers(-2**31, 2**31 - 1, (h, w)).astype(">i4")),
        "pixar": pixar_file(pic),
        "spider_le": spider_file(f, "<"),
        "spider_be": spider_file(f, ">", stack=int(rng.integers(0, 3))),
        "xvthumb": xv_file(pic[..., 0], comments=[b"#" * int(rng.integers(1, 4))]),
        "iptc_l": iptc_file(w, h, 1, 0, pic[..., 0].tobytes(), chunk=int(rng.integers(0, 7))),
        "iptc_rgb": iptc_file(w, h, 3, 1, pic[..., 0].tobytes(), band=int(rng.integers(0, 5))),
        "iptc_cmyk": iptc_file(w, h, 4, 1, pic[..., 0].tobytes(), band=int(rng.integers(0, 6))),
    }


FORMAT_KINDS = sorted(_random_files(0))


@pytest.mark.parametrize("kind", FORMAT_KINDS)
@pytest.mark.parametrize("seed", range(6))
def test_random_files_agree_with_pil(kind, seed):
    """Random sizes and samples (NaN and huge floats in SPIDER, every
    McIdas stride, IPTC bands 0 to 5 of RGB and CMYK): the port equals
    PIL, or both refuse."""
    _agree(_random_files(seed * 13 + len(kind))[kind])


MUTATED = [n for n in PLUGINS if not n.startswith("jpeg_") and n != "rotated.pcd"]


@pytest.mark.parametrize("name", MUTATED)
def test_mutated_fixtures_agree_with_pil(name):
    """40 mutations of each fixture (cuts, byte changes in the header and
    data, bytes put in): the port's pixels equal PIL's, or both refuse.
    (The IPTC JPEG fixtures are left out: a corrupt JPEG body is
    utils/image_decode's, which refuses what libjpeg reads with warnings.)"""
    data = (FIXTURES / name).read_bytes()
    rng = np.random.default_rng(int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "big"))
    for _ in range(40):
        d = bytearray(data)
        r = rng.random()
        if r < 0.3:
            d = d[:int(rng.integers(0, len(d) + 1))]
        elif r < 0.8:
            for _ in range(int(rng.integers(1, 4))):
                p = int(rng.integers(0, min(len(d), 600)))
                d[p] = int(rng.integers(0, 256)) if rng.random() < 0.5 else d[p] ^ (
                    1 << int(rng.integers(0, 8)))
        else:
            p = int(rng.integers(0, len(d)))
            d[p:p] = rng.integers(0, 256, int(rng.integers(1, 5)), dtype=np.uint8).tobytes()
        _agree(bytes(d))


def test_pixar_of_another_mode_is_not_pil_pixar():
    """A PIXAR file of a mode other than (14, 2) leaves PIL's mode unset:
    Image.open goes on past PIXAR, and both refuse it."""
    data = pixar_file(_picture(2, 4, 3), (14, 1))
    assert not texture.pil_open.pixar(data)
    _agree(data)


def test_iptc_band_handling_as_pil():
    """Raw IPTC data is one band: the image (L), or band (3, 65) of RGB or
    CMYK with the others 0 (band 0 the last, as Python indexes); a colour
    JPEG as one band fails in PIL's merge, and as the L image is the
    image."""
    pic = _picture(3, 6, 4)
    grey = pic[..., 0]
    got = _port(iptc_file(6, 4, 3, 1, grey.tobytes(), band=2))
    assert np.array_equal(got[..., 1], grey) and not got[..., [0, 2]].any()
    _equal_to_pil(iptc_file(6, 4, 3, 1, grey.tobytes(), band=0))
    _equal_to_pil(iptc_file(6, 4, 4, 1, grey.tobytes(), band=1))
    jpeg = _save(Image.fromarray(pic), "JPEG")
    _agree(iptc_file(6, 4, 3, 1, jpeg, 5, band=1))
    assert isinstance(_port(iptc_file(6, 4, 3, 1, jpeg, 5, band=1)), Exception)
    _equal_to_pil(iptc_file(6, 4, 1, 0, jpeg, 5, chunk=7))
    big = iptc_file(6, 4, 1, 0, grey.tobytes())
    big = big.replace(iptc_field(8, 10, grey.tobytes()), iptc_field(8, 10, grey.tobytes(), True))
    _equal_to_pil(big)


# --- what is refused -------------------------------------------------------------------

def _broken():
    pic = _picture(5, 6, 4)
    f = pic[..., 0].astype(np.float32)
    cases = {
        "fli_truncated_frame": (fli_file(6, 4, [fli_chunk(16, pic[..., 0].tobytes())])[:-5],
                                "FLI/FLC: image file is truncated"),
        "fli_unknown_chunk": (fli_file(6, 4, [fli_chunk(99, bytes(8))]), "sub-chunk type 99"),
        "fli_brun_short_line": (fli_file(6, 4, [fli_chunk(15, b"\1\3\7" * 4), fli_chunk(13, b""),
                                                fli_chunk(13, b"")]), "BRUN line not filled"),
        "fli_prefix_chunk": (fli_file(6, 4, [fli_chunk(13, bytes(8))], prefix=b"pfx!"),
                             "unknown frame chunk 0xF100"),
        "im_rlb": (im_file("RLB image", 4, 2, bytes(24)), "no unpacker"),
        "im_truncated": (im_file("RGB image", 9, 7, bytes(100)), "truncated"),
        "im_size_not_a_number": (b"Image type: Greyscale image\nImage size (x*y): 4*x\n\x1a",
                                 "IM: 'x' is not a number"),
        "imt_no_form_feed": (b"width 3\nheight 2\npixel n8\n" + bytes(6), "no form feed"),
        "gbr_truncated": (gbr_file(pic[..., 0], 2)[:-3], "GBR: not enough image data"),
        "mcidas_short_stride": (mcidas_file(pic[..., 0], prefix=2, bands=0),
                                "McIdas: a stride of 2 bytes"),
        "pixar_truncated": (pixar_file(pic)[:-4], "truncated"),
        "spider_stack_image": (spider_file(f, "<")[:104] + struct.pack("<f", 2.0)
                               + spider_file(f, "<")[108:], "SPIDER: an image of a stack"),
        "spider_truncated": (spider_file(f, ">")[:-2], "truncated"),
        "xvthumb_no_size": (b"P7 332\n#c\n\n" + bytes(4), "XVThumb: no size line"),
        "iptc_bad_compression": (iptc_file(6, 4, 1, 0, bytes(24), 3), "IPTC: unknown image "
                                                                     "compression 3"),
        "iptc_truncated": (iptc_file(6, 4, 1, 0, bytes(20)), "truncated"),
        "iptc_png_body": (iptc_file(6, 4, 1, 0, _save(Image.fromarray(pic), "PNG"), 5),
                          "not a JPEG"),
        "pcd_truncated": (pcd_file(np.zeros((100, 2304), np.uint8)), "PCD: image file is "
                                                                     "truncated"),
        "huge_gbr": (struct.pack(">5I", 28, 2, 30000, 30000, 1) + b"GIMP" + bytes(8),
                     "more pixels than 178,956,970"),
        "huge_im": (im_file("Greyscale image", 30000, 30000, bytes(8)),
                    "more pixels than 178,956,970"),
    }
    return cases


BROKEN = _broken()
PIL_OPENS = {"iptc_png_body"}  # PIL hands the body to Image.open, which opens a PNG


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


@pytest.mark.parametrize("kind", sorted(BROKEN))
def test_pil_fails_on_the_broken_files(tmp_path, kind):
    """The broken files are broken for PIL too (opened from a path, as the
    JAX package opens them), the huge ones past its decompression-bomb
    limit; PIL opens an IPTC body of another format than JPEG, which the
    port refuses by name."""
    path = tmp_path / "t.bin"
    path.write_bytes(BROKEN[kind][0])
    if kind == "mcidas_short_stride":
        # from a path PIL maps the file and reads overlapping rows; its raw
        # decoder, which reads a stream, refuses the stride as the port does
        with pytest.raises(OSError, match="codec configuration error"):
            _pil(BROKEN[kind][0])
        return
    if kind in PIL_OPENS:
        with Image.open(path) as im:
            assert im.format == "IPTC" and im.convert("RGB").size == (6, 4)
        return
    with pytest.raises(Image.DecompressionBombError if kind.startswith("huge") else Exception):
        with Image.open(path) as im:
            im.convert("RGB")


# --- read_texture, scenes, and the JAX package --------------------------------------------

SCENE_FIXTURES = ("blob_rgb.im", "brun.flc", "float.spi", "l_prefix.area", "ss2_odd.flc",
                  "grey.imt", "rgba_v2.gbr", "rgb.pxr", "thumb.xv", "raw_rgb_band2.iim",
                  "jpeg_rgb.iim", "rotated.pcd", "l12_bits.im", "ycc.im")


def test_read_texture_without_pil_matches_the_jax_package(monkeypatch):
    """read_texture of every format of the slice, with PIL blocked, gives
    the JAX package's read_texture's atlas bytes and (offset, w, h)
    values."""
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


def test_scene_with_im_fli_spider_and_mcidas_textures_matches_jax(tmp_path):
    """A DSL scene with IM, FLI, SPIDER and McIdas textures, each shared by
    two objects, through the JAX package's build_scene (PIL) and the
    port's: every texture array exact, and the JAX scene carried over by
    scene_from_numpy equal to the port's own build."""
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
