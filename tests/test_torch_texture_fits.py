"""The port's FITS decoder (utils/fits_decode; PIL's F to RGB in
utils/pil_modes) against PIL 12.1.0's FitsImagePlugin, the JAX package's
decoder.

Tolerance 0: every decode equals `np.asarray(Image.open(f).convert("RGB"))`
byte for byte, with PIL blocked while the port decodes: the committed
fixtures (tests/torch_textures/make_fixtures.py's `j2k_fixtures`: each
BITPIX, NAXIS 1, GZIP_1), files built here at each BITPIX and shape, the
header forms PIL reads (comments, strings with '/', extra axes, an
extension after an empty primary HDU, a table whose compression is not
GZIP_1 read as an image), and broken files (TextureError naming the
cause, PIL failing too).
"""

import hashlib
import io
import json
import pathlib
import sys

import numpy as np
import pytest
from PIL import Image
from torch_textures.make_fixtures import fits_card, fits_file, fits_gzip, fits_header

from relativitypathtracer_tpu_torch.models.texture import TextureError, decode_texture, read_texture
from relativitypathtracer_tpu_torch.utils import pil_modes

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "torch_textures"
RECORD = json.loads((FIXTURES / "pil_rgb.json").read_text())["files"]
FITS = sorted(n for n in RECORD if n.endswith(".fits"))


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _pil_outcome(data: bytes):
    try:
        return _pil(data)
    except Exception as e:  # noqa: BLE001 - any failure is PIL's refusal
        return e


def _port(data: bytes):
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None
    try:
        return decode_texture(data)
    except Exception as e:  # noqa: BLE001
        return e
    finally:
        sys.modules["PIL"] = saved


def _agree(data: bytes) -> None:
    want, got = _pil_outcome(data), _port(data)
    if isinstance(want, Exception) or isinstance(got, Exception):
        assert isinstance(want, Exception) and isinstance(got, Exception), (want, got)
        return
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want), f"{int((got != want).sum())} values differ"


@pytest.mark.parametrize("name", FITS)
def test_fixture_decodes_to_pil_bytes(name):
    data = (FIXTURES / name).read_bytes()
    got = _port(data)
    assert not isinstance(got, Exception), got
    assert list(got.shape) == RECORD[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == RECORD[name]["sha256"]
    assert np.array_equal(got, _pil(data))


def _samples(bitpix: int, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if bitpix == 8:
        return rng.integers(0, 256, shape)
    if bitpix == 16:
        return rng.integers(-2000, 3000, shape)
    if bitpix == 32:
        return rng.integers(-100000, 100000, shape)
    v = rng.normal(100, 150, shape)
    v.flat[:3] = (np.nan, np.inf, -0.5)
    return v


@pytest.mark.parametrize("bitpix", [8, 16, 32, -32, -64])
@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (1, 9), (13, 1), (33, 20)])
def test_each_bitpix_and_shape(bitpix, shape):
    """PIL's raw modes on FITS's big-endian data (I;16, I and F read little
    endian, -64 as 4-byte floats), rows bottom first."""
    _agree(fits_file(_samples(bitpix, shape, abs(bitpix) + shape[0]), bitpix))


@pytest.mark.parametrize("bitpix", [8, 16, 32, -32])
def test_naxis_1_is_one_column(bitpix):
    data = fits_file(_samples(bitpix, 11, 3), bitpix, naxis=1)
    assert _port(data).shape == (11, 1, 3)
    _agree(data)


@pytest.mark.parametrize("zbitpix", [8, 16, 32, -32, -64])
@pytest.mark.parametrize("primary", [True, False])
def test_gzip_tables(zbitpix, primary):
    """GZIP_1 tiles: the last BITPIX / 8 bytes of each 4-byte word in
    rawmode = the mode; PIL reads none at negative BITPIX and fails."""
    _agree(fits_gzip(np.random.default_rng(abs(zbitpix)).integers(0, 700, (15, 18)), zbitpix,
                     primary=primary))


def test_header_forms():
    """Comments after '/', a string value holding '/', a third axis, other
    keywords, and a compressed table of another kind (read as the table's
    own bytes, an image of NAXIS1 x NAXIS2)."""
    rng = np.random.default_rng(4)
    samples = rng.integers(0, 256, (2, 6, 7))
    cards = [fits_card("SIMPLE", "T"), fits_card("BITPIX", 8), fits_card("NAXIS", 3),
             fits_card("NAXIS1", 7), fits_card("NAXIS2", 6), fits_card("NAXIS3", 2),
             fits_card("OBJECT", "'a/b'"), b"COMMENT  anything at all".ljust(80)]
    cards[1] = cards[1][:40] + b"/ bits a sample".ljust(40)
    _agree(fits_header(cards) + samples.astype(np.uint8).tobytes())
    rice = fits_gzip(rng.integers(0, 700, (15, 18)), 16).replace(b"'GZIP_1  '", b"'RICE_1  '")
    _agree(rice)
    assert _port(rice).shape == (1, 8, 3)


def test_a_short_data_unit_is_read_from_before_it():
    """PIL finds the data at its file position less 80 after reading the
    data's first card: where fewer than 80 bytes follow the header, it
    reads from inside the header's padding, and so does the port."""
    data = fits_file(np.arange(42).reshape(6, 7), 8)[:-5]
    got = _port(data)
    assert got[-1, 0, 0] == 32  # a space of the header, bottom row first
    _agree(data)


def test_f_to_rgb_is_pils():
    """F through L: truncated toward 0, clipped, NaN to 0 (Convert.c f2l)."""
    v = np.array([[-1, 0, 0.4, 0.6, 1.5, 127.5, 254.6, 254.99, 255, 255.5, 300, np.nan, np.inf,
                   -np.inf, 1e10, -1e10, 3e38]], np.float32)
    want = np.asarray(Image.frombytes("F", (v.shape[1], 1), v.tobytes()).convert("RGB"))
    assert np.array_equal(pil_modes.to_rgb("F", v), want)


def _broken():
    good = fits_file(_samples(8, (6, 7), 1), 8)
    return {
        "truncated_data": (fits_file(_samples(8, (20, 30), 1), 8)[:-100], "truncated"),
        "header_only": (good[:2880], "truncated"),
        "no_end": (good[:800], "truncated"),
        "huge": (fits_header([fits_card("SIMPLE", "T"), fits_card("BITPIX", 8),
                              fits_card("NAXIS", 2), fits_card("NAXIS1", 20000),
                              fits_card("NAXIS2", 10000)]) + bytes(100),
                 "more pixels than 178,956,970"),
        "bitpix_64": (good.replace(b"BITPIX  =                    8",
                                   b"BITPIX  =                   64"), "BITPIX 64"),
        "naxis_0": (fits_header([fits_card("SIMPLE", "T"), fits_card("BITPIX", 8),
                                 fits_card("NAXIS", 0)]) + bytes(80), "no image"),
        "naxis_text": (good.replace(b"NAXIS2  =                    6",
                                    b"NAXIS2  =                  six"), "NAXIS2"),
        "zimage_without_type": (fits_gzip(_samples(8, (15, 18), 2), 8).replace(
            b"ZCMPTYPE=", b"ZCMPXXXX="), "ZCMPTYPE"),
        "gzip_float": (fits_gzip(_samples(8, (15, 18), 2), -32), "BITPIX -32"),
        "gzip_junk": (fits_gzip(_samples(8, (15, 18), 2), 16) + b"junk", "GZIP_1"),
        "gzip_short": (fits_gzip(_samples(8, (15, 18), 2), 16).replace(
            b"ZNAXIS2 =                   15", b"ZNAXIS2 =                   19"), "GZIP_1"),
    }


BROKEN = _broken()


@pytest.mark.parametrize("kind", sorted(BROKEN))
def test_broken_files_raise_texture_error(tmp_path, kind, monkeypatch):
    """Each raises TextureError naming the file and the cause, with PIL
    blocked, the atlas untouched."""
    data, words = BROKEN[kind]
    path = tmp_path / "t.fits"
    path.write_bytes(data)
    monkeypatch.setitem(sys.modules, "PIL", None)
    atlas, values = bytearray(b"keep"), []
    with pytest.raises(TextureError) as err:
        read_texture(str(path), atlas, values)
    assert str(path) in str(err.value) and words in str(err.value), str(err.value)
    assert atlas == b"keep" and values == []


@pytest.mark.parametrize("kind", sorted(BROKEN))
def test_pil_fails_on_the_broken_files(tmp_path, kind):
    path = tmp_path / "t.fits"
    path.write_bytes(BROKEN[kind][0])
    with pytest.raises(Image.DecompressionBombError if kind == "huge" else Exception):
        with Image.open(path) as im:
            im.convert("RGB")
