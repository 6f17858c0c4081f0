"""Damaged TIFF data read as the JAX package reads it: PIL 12.1.0 with
libtiff 4.7.1 (its JPEG codecs on libjpeg-turbo 3.1.3, its Deflate codec
on zlib 1.2.13), for utils/tiff_decode.

Tolerance 0. tests/torch_textures/damaged.json holds 12 edits of each
committed TIFF fixture (make_fixtures.py's `damaged_cases`: bytes set,
markers over two bytes, cuts) and PIL's outcome of each from three fresh
processes: with PIL blocked, the port gives PIL's pixels where PIL reads
the file, and raises TextureError through read_texture where PIL fails or
its pixels vary; no case is left for later (`LEFT`: the cases PIL reads
and the port refuses, naming the codec). Hand-built files pin the
rules against the installed PIL: JPEG strips through libtiff's fake EOI
and its ignored errors after a one-scan strip; a corrupt Deflate or LZW
strip or tile in the YCbCr route, where libtiff's RGBA reader reads on
with what the codec wrote over the buffer's zeros or the tile before; an
LZMA stream damaged after its data; strips past the file's end; the
directory checks with which libtiff fails a file PIL's own reading takes;
a byte count libtiff estimates; a directory PIL stops reading early.
"""

import struct
import sys

import numpy as np
import pytest
from test_torch_texture_damaged_jpeg import FIXTURES, SWEEP, check_sweep, rederive
from torch_textures.make_fixtures import (damaged, damaged_cases, jpeg_tiff, tiff_file,
                                          ycbcr_tiff)

from relativitypathtracer_tpu_torch.models.texture import decode_texture
from relativitypathtracer_tpu_torch.utils import tiff_decode

TIFFS = sorted(n for n in SWEEP if n.endswith(".tif"))
# the cases left for later, by the codec the port names in refusing them:
# none (PIL reads each case of the sweep as the port does, or both refuse)
LEFT = {}


@pytest.mark.parametrize("name", TIFFS)
def test_damaged_tiff_reads_as_pil_reads_it(name, tmp_path, monkeypatch):
    data = (FIXTURES / name).read_bytes()
    cases = damaged_cases(name, data)
    rows = list(SWEEP[name])
    for (left, i), codec in LEFT.items():
        if left == name:  # PIL reads it; the port refuses it, naming the codec
            assert isinstance(rows[i][3], dict)
            got = _port(damaged(data, cases[i]))
            assert isinstance(got, Exception) and codec in str(got), (name, i, got)
            rows[i] = rows[i][:3] + ["fails"]
    monkeypatch.setitem(SWEEP, name, rows)
    check_sweep(name, tmp_path)


def test_a_sample_of_the_sweep_rederived_with_pil():
    rederive(TIFFS, 3)


# --- hand-built files -------------------------------------------------------------------

def _port(data: bytes):
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None
    try:
        return decode_texture(data)
    except Exception as e:  # noqa: BLE001 - compared below
        return e
    finally:
        if saved is None:
            del sys.modules["PIL"]
        else:
            sys.modules["PIL"] = saved


def _pil(data: bytes, tmp_path):
    """PIL's pixels of the file opened from a path, as the JAX package
    opens it, or the exception it raises."""
    from PIL import Image
    path = tmp_path / "pil.tif"
    path.write_bytes(data)
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except Exception as e:  # noqa: BLE001 - PIL's refusal
        return e


def _agree(data: bytes, tmp_path, reads: bool = True) -> None:
    """PIL reads the file (or fails, `reads` False) and the port, PIL
    blocked, gives the same pixels (or fails too)."""
    want, got = _pil(data, tmp_path), _port(data)
    if not reads:
        assert isinstance(want, Exception) and isinstance(got, Exception), (want, got)
        return
    assert not isinstance(want, Exception), want
    assert not isinstance(got, Exception), got
    assert got.shape == want.shape and np.array_equal(got, want)


def _layout(data: bytes):
    """(offsets, counts) of the strips or tiles."""
    tags = tiff_decode._ifd(data, struct.unpack_from("<L", data, 4)[0], "<")
    return tags.get(273, tags.get(324)), tags.get(279, tags.get(325))


def _entry(data: bytes, tag: int) -> int:
    """The offset of the directory entry of `tag`."""
    at = struct.unpack_from("<L", data, 4)[0]
    for k in range(struct.unpack_from("<H", data, at)[0]):
        if struct.unpack_from("<H", data, at + 2 + 12 * k)[0] == tag:
            return at + 2 + 12 * k
    raise KeyError(tag)


def _retag(data: bytes, tag: int, *, new_tag=None, kind=None, count=None, value=None) -> bytes:
    """The file with the entry of `tag` changed."""
    d, at = bytearray(data), _entry(data, tag)
    for off, fmt, v in ((0, "<H", new_tag), (2, "<H", kind), (4, "<L", count), (8, "<L", value)):
        if v is not None:
            struct.pack_into(fmt, d, at + off, v)
    return bytes(d)


def _picture(seed: int, h: int, w: int, n: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = np.linspace(0, 255, w)[None, :, None] * np.ones((h, 1, n))
    return np.clip(base + rng.normal(0, 30, (h, w, n)), 0, 255).astype(np.uint8)


def _damage(data: bytes, k: int, at: float, value: int) -> bytes:
    """Strip or tile k's byte at fraction `at` of its length set to value."""
    offsets, counts = _layout(data)
    d = bytearray(data)
    d[offsets[k] + int(counts[k] * at)] = value
    return bytes(d)


@pytest.mark.parametrize("at", [0.3, 0.6, 0.97])
def test_a_corrupt_deflate_tile_of_a_ycbcr_file_reads_on(at, tmp_path):
    """TIFFRGBAImageGet (PIL's YCbCr route) reads on past a tile that
    ZIPDecode fails: the tile shows what inflate wrote before the error
    over the buffer as the row's last tile left it (zeros for a row's
    first tile)."""
    data = ycbcr_tiff(_picture(3, 40, 48), (2, 1), 8, tile=(16, 16))
    _agree(_damage(_damage(data, 1, at, 0x5A), 3, at / 2, 0xC3), tmp_path)


@pytest.mark.parametrize("at", [0.2, 0.5, 0.9])
def test_a_corrupt_lzw_strip_of_a_ycbcr_file_reads_on(at, tmp_path):
    """LZWDecode's errors ("Using code not yet in table", a code past the
    table after a clear) leave what it decoded before them, over the
    strip buffer's zeros."""
    data = ycbcr_tiff(_picture(4, 24, 30), (2, 2), 5, rows_per_strip=8)
    for value in (0xFF, 0x00, 0x81):
        _agree(_damage(data, 1, at, value), tmp_path)


def test_lzma_damaged_after_its_data_reads(tmp_path):
    """LZMADecode takes a strip whose data came out whole before liblzma's
    error (a damaged check or footer)."""
    data = tiff_file(_picture(5, 12, 10, 1), 8, 1, comp=34925)
    offsets, counts = _layout(data)
    for back in (2, 5, 20):
        d = bytearray(data)
        d[offsets[0] + counts[0] - back] ^= 0x40
        _agree(bytes(d), tmp_path)


def test_a_strip_past_the_files_end_fails(tmp_path):
    """TIFFFillStrip's read error (a count past 1 MiB first limited to ten
    times the strip's size and 4096)."""
    data = tiff_file(_picture(6, 10, 12), 8, 2, comp=5, rows_per_strip=4)
    offsets, counts = _layout(data)
    for count in (len(data), 3 << 20, 0xFFFFFFF0):
        at = struct.unpack_from("<L", data, _entry(data, 279) + 8)[0]  # the counts' array
        d = bytearray(data)
        struct.pack_into("<L", d, at + 4, count)
        _agree(bytes(d), tmp_path, reads=False)


LIBTIFF_FAILS = {
    "spp_of_type_float": dict(tag=277, kind=11),
    "spp_of_count_2": dict(tag=277, count=2),
    "spp_0": dict(tag=277, value=0),
    "planar_3": dict(tag=284, value=3),
    "rows_per_strip_0": dict(tag=278, value=0),
    "rows_per_strip_of_type_ascii": dict(tag=278, kind=2),
    "width_of_type_rational": dict(tag=256, kind=5),
}


@pytest.mark.parametrize("case", sorted(LIBTIFF_FAILS))
def test_libtiff_fails_a_directory_pil_takes(case, tmp_path):
    """TIFFReadDirectory fails on damage to the tags it reads first
    (SamplesPerPixel, Compression, the sizes, PlanarConfiguration,
    RowsPerStrip, ExtraSamples); PIL's own reading takes the file and its
    libtiff decoder then fails."""
    data = tiff_file(_picture(7, 9, 11), 8, 2, comp=8, rows_per_strip=3)
    _agree(_retag(data, **LIBTIFF_FAILS[case]), tmp_path, reads=False)


def test_too_many_directory_entries_fail(tmp_path):
    """TIFFFetchDirectory's sanity check: more than 4096 entries."""
    data = bytearray(tiff_file(_picture(8, 6, 7), 8, 2, comp=5))
    at = struct.unpack_from("<L", data, 4)[0]
    data[at + 1] = 0x97
    _agree(bytes(data), tmp_path, reads=False)


def test_a_missing_byte_count_is_estimated(tmp_path):
    """Without StripByteCounts libtiff's EstimateStripByteCounts gives a
    compressed strip the file past its directory."""
    data = tiff_file(_picture(9, 8, 10), 8, 2, comp=5)
    _agree(_retag(data, 279, new_tag=413), tmp_path)


def test_pil_stops_reading_the_directory_where_libtiff_does_not(tmp_path):
    """A tag whose values lie past the file's end ends PIL's reading of the
    directory (the mode from the tags before it), while libtiff ignores
    the tag and decodes with the rest (strips, fill order)."""
    grey = _picture(10, 12, 16, 1)
    data = tiff_file(grey, 8, 1, comp=5, rows_per_strip=5, fill=2)
    _agree(_retag(data, 262, count=0x10000), tmp_path)


def test_a_jpeg_strip_cut_short_reads_through_a_fake_eoi(tmp_path):
    """libtiff's JPEG source gives libjpeg a fake EOI where a strip's data
    ends: the strip decodes with the rest of its scan left gray."""
    from PIL import Image
    data = jpeg_tiff(_picture(11, 16, 24), 2, (24, 8), Image, subsampling="4:4:4")
    offsets, counts = _layout(data)
    for cut in (3, 40, counts[0] // 2):
        d = bytearray(data)
        struct.pack_into("<L", d, struct.unpack_from("<L", data, _entry(data, 279) + 8)[0],
                         counts[0] - cut)
        _agree(bytes(d), tmp_path)


def test_a_jpeg_strip_damaged_after_its_scan_reads(tmp_path):
    """libtiff ignores jpeg_finish_decompress's errors: a one-scan strip
    whose EOI is a bad DRI decodes."""
    from PIL import Image
    data = bytearray(jpeg_tiff(_picture(12, 16, 24), 2, (24, 16), Image, subsampling="4:4:4"))
    offsets, counts = _layout(bytes(data))
    end = offsets[0] + counts[0]
    assert data[end - 2:end] == b"\xff\xd9"
    data[end - 1] = 0xDD
    _agree(bytes(data), tmp_path)
