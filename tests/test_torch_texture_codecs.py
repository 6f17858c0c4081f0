"""libtiff's rules where TIFF data runs out or breaks, ThunderScan and CCITT
RLEW, IPTC around other formats and APNG's first frame, against PIL 12.1.0
(libtiff 4.7.1, liblzma, libzstd 1.5.7), for utils/ccitt_decode,
utils/tiff_decode, utils/zstd_decode, utils/misc_raster and
utils/image_decode.

Tolerance 0: the port, PIL blocked, gives PIL's pixels where PIL reads a
file and raises where PIL fails. Hand-built files pin each rule: a Group 3
strip whose data ends before an EOL's 1 read again from its start without
EOLs, and that mode kept for the strips after it; Group 4 ending early,
the rest of the strip as PIL's strip buffer held it; the run arrays kept
from strip to strip; a FillOrder of the wrong count ignored; what liblzma
wrote before its error at every byte of a damaged strip; libzstd's fast
four-stream Huffman loop (streams read past their start, unchecked ends,
the 8-byte limit); ThunderScan's codes; RLEW's word alignment by the
strip's address; IPTC data of any format; APNG's frame 0 in its box; a
PNG zlib stream ending on a row. The new fixtures' damaged cases and
hashes are re-derived by PIL in a fresh process, and a DSL scene with a
ThunderScan and an IPTC-wrapped PNG texture is held to the JAX package's
build.
"""

import io
import json
import pathlib
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_texture_damaged_jpeg import SWEEP, rederive
from torch_textures.make_fixtures import (actl, ccitt_tiff, fctl, fdat, iptc_file, mh_row,
                                          png_chunk, png_data, png_file, rlew_tiff, rlew_words,
                                          thunderscan_coded, thunderscan_row, thunderscan_tiff,
                                          tiff_file, tiff_from_chunks)

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch.models.texture import decode_texture
from relativitypathtracer_tpu_torch.utils import tiff_decode, zstd_decode
from relativitypathtracer_tpu_torch.utils.ccitt_decode import CcittState, decode_ccitt
from relativitypathtracer_tpu_torch.utils.image_decode import DecodeError

FIXTURES = pathlib.Path(__file__).resolve().parent / "torch_textures"
RECORD = json.loads((FIXTURES / "pil_rgb.json").read_text())["files"]
NEW = sorted(n for n in RECORD if n.startswith(("thunder_", "rlew_", "iptc_", "apng_"))
             or n in ("blob_thunder.tif", "cubes_rlew.tif"))


def _port(data: bytes):
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None
    try:
        return decode_texture(data)
    except Exception as e:  # noqa: BLE001 - compared below
        return e
    finally:
        sys.modules["PIL"] = saved


def _pil(data: bytes, tmp_path):
    """PIL's pixels of the file opened from a path (as the JAX package
    opens textures), or the exception it raises."""
    path = tmp_path / "pil.bin"
    path.write_bytes(data)
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except Exception as e:  # noqa: BLE001 - PIL's refusal
        return e


def _outcome(data: bytes, tmp_path) -> str:
    """"equal", "both refuse", or what differs."""
    want, got = _pil(data, tmp_path), _port(data)
    if isinstance(want, Exception) or isinstance(got, Exception):
        if isinstance(want, Exception) and isinstance(got, Exception):
            return "both refuse"
        def say(x):
            return repr(x) if isinstance(x, Exception) else f"pixels {x.shape}"
        return f"PIL {say(want)}, the port {say(got)}"
    if want.shape == got.shape and np.array_equal(want, got):
        return "equal"
    return f"other pixels ({(want != got).any(2).sum()} differ)"


def _agree(data: bytes, tmp_path, reads=None) -> None:
    got = _outcome(data, tmp_path)
    assert got in ({"equal"} if reads else {"both refuse"} if reads is False else
                   {"equal", "both refuse"}), got


def _strip_counts_at(data: bytes) -> int:
    """The offset of the StripByteCounts array (several strips)."""
    at = struct.unpack_from("<L", data, 4)[0]
    for k in range(struct.unpack_from("<H", data, at)[0]):
        tag, _, count, value = struct.unpack_from("<HHLL", data, at + 2 + 12 * k)
        if tag == 279:
            return value if count > 1 else at + 2 + 12 * k + 8
    raise KeyError(279)


def _layout(data: bytes):
    tags = tiff_decode._ifd(data, struct.unpack_from("<L", data, 4)[0], "<")
    return tags[273], tags[279]


INK = (np.add.outer(np.arange(12), np.arange(40)) % 7 < 2) ^ (np.arange(40) % 9 == 0)


# --- CCITT past the data's end ---------------------------------------------------------

@pytest.mark.parametrize("t4", [0, 1, 5])
@pytest.mark.parametrize("cut", [1, 3, 6, 10])
def test_group3_strip_cut_short_reads_on_without_eols(t4, cut, tmp_path):
    """A Group 3 strip whose data ends before an EOL's 1 (SYNC_EOL's
    noEOLFound): libtiff sets FAXMODE_NOEOL, reads the strip again from its
    start without EOLs, and keeps the mode for the strips after it; a 2D
    strip cut inside a row fails (premature EOF)."""
    data = bytearray(ccitt_tiff(INK, 3, Image, t4=t4, rows_per_strip=4))
    at = _strip_counts_at(bytes(data)) + 4
    struct.pack_into("<L", data, at, struct.unpack_from("<L", data, at)[0] - cut)
    _agree(bytes(data), tmp_path)


@pytest.mark.parametrize("t4", [0, 1])
@pytest.mark.parametrize("zeros", [2, 5, 9])
def test_group3_strip_with_a_zeroed_tail(t4, zeros, tmp_path):
    """Strip 1's tail zeroed: its rows partly blank, and strip 2's rows,
    whose bytes are whole, read without EOLs too (the probe that found
    the mode carried across strips)."""
    data = bytearray(ccitt_tiff(INK, 3, Image, t4=t4, rows_per_strip=4))
    offsets, counts = _layout(bytes(data))
    end = offsets[1] + counts[1]
    data[end - zeros:end] = bytes(zeros)
    assert _outcome(bytes(data), tmp_path) == "equal"
    state = CcittState()
    decode_ccitt(bytes(data[offsets[0]:offsets[0] + counts[0]]), 3, 40, 4, t4, state)
    assert not state.no_eol
    decode_ccitt(bytes(data[offsets[1]:end]), 3, 40, 4, t4, state)
    # 9 zero bytes: strip 2 runs out looking for an EOL's 1, and strip 3 reads without
    assert state.no_eol == (zeros == 9)


def test_group4_ending_early_keeps_the_strip_buffer(tmp_path):
    """Fax4Decode returns success on a strip that ends (EOFB or no data)
    after its first row, leaving the rest of PIL's strip buffer as the
    strip before wrote it: every cut of strips 1 and 2 equals PIL or both
    fail; in the first strip the rest is unwritten memory, which the port
    refuses by name."""
    data = bytearray(ccitt_tiff(INK, 4, Image, rows_per_strip=4))
    offsets, counts = _layout(bytes(data))
    at = _strip_counts_at(bytes(data))
    kept = 0
    for strip in (1, 2):
        for n in range(1, counts[strip]):
            d = bytearray(data)
            struct.pack_into("<L", d, at + 4 * strip, n)
            assert _outcome(bytes(d), tmp_path) in ("equal", "both refuse"), (strip, n)
            src = bytes(d[offsets[strip]:offsets[strip] + n])
            try:
                kept += decode_ccitt(src, 4, 40, 4)[1] < 4
            except DecodeError:
                pass
    assert kept  # some cuts end a strip early, its last rows the strip before's
    unwritten = 0
    for n in range(1, counts[0]):
        d = bytearray(data)
        struct.pack_into("<L", d, at, n)
        got = _port(bytes(d))
        unwritten += isinstance(got, DecodeError) and "unwritten memory" in str(got)
    assert unwritten


def test_group4_eofb_in_a_first_row_fails(tmp_path):
    """An EOFB (an EOL) in a strip's first row: Fax4Decode returns -1."""
    data = bytearray(ccitt_tiff(INK, 4, Image, rows_per_strip=4))
    offsets, _ = _layout(bytes(data))
    data[offsets[1]:offsets[1] + 3] = b"\x00\x10\x01"
    _agree(bytes(data), tmp_path, reads=False)


def test_run_arrays_are_kept_from_strip_to_strip(tmp_path):
    """Fax3PreDecode resets only the reference row's first two runs: a 2D
    row reading past them takes the runs the strip before left there."""
    seen = set()
    rng = np.random.default_rng(3)
    for _ in range(40):
        ink = rng.random((12, 37)) < 0.3
        data = bytearray(ccitt_tiff(ink, 3, Image, t4=1, rows_per_strip=2))
        offsets, counts = _layout(bytes(data))
        k = int(rng.integers(1, len(offsets)))
        data[offsets[k]] ^= 0xFF  # the strip's first row, against a white row
        seen.add(_outcome(bytes(data), tmp_path))
    assert seen <= {"equal", "both refuse"} and "equal" in seen, seen


@pytest.mark.parametrize("count", [0, 2, 0x19, 0xFFFF])
def test_a_fill_order_of_another_count_is_ignored(count, tmp_path):
    """libtiff ignores a FillOrder tag whose count is not 1 ("Incorrect
    count"): the bit-reversed strips decode in the first order."""
    data = bytearray((FIXTURES / "g3_2d_fill.tif").read_bytes())
    at = struct.unpack_from("<L", data, 4)[0]
    for k in range(struct.unpack_from("<H", data, at)[0]):
        if struct.unpack_from("<H", data, at + 2 + 12 * k)[0] == 266:
            struct.pack_into("<L", data, at + 2 + 12 * k + 4, count)
    _agree(bytes(data), tmp_path)


# --- LZMA and ZSTD ---------------------------------------------------------------------

def test_lzma_keeps_what_liblzma_wrote_before_its_error(tmp_path):
    """Every byte of a small LZMA strip (delta filter and LZMA2, as libtiff
    writes it) set to two values: PIL reads the file where liblzma wrote
    the strip before its error (the LZMA decoder runs on past the chunk's
    compressed size up to its uncompressed size), and the port equals it;
    else both fail."""
    buf = io.BytesIO()
    pic = (np.add.outer(np.arange(6), np.arange(7))[..., None] * [9, 5, 3] % 256).astype(np.uint8)
    Image.fromarray(pic).save(buf, "TIFF", compression="lzma", tiffinfo={317: 2})
    data = buf.getvalue()
    (offset,), (count,) = _layout(data)
    seen = {}
    for at in range(offset, offset + count):
        for value in (0x00, data[at] ^ 0x80):
            d = bytearray(data)
            d[at] = value
            got = _outcome(bytes(d), tmp_path)
            seen[got] = seen.get(got, 0) + 1
    assert set(seen) == {"equal", "both refuse"} and seen["equal"] > 20, seen


def _four_streams(data: bytes):
    """(strip offset, the offset of its first four-stream literals' jump
    table, the section's end) in a ZSTD TIFF's first strip."""
    (offset,), (count,) = _layout(data)
    strip = data[offset:offset + count]
    fhd = strip[4]
    pos = 5 + (0 if fhd & 0x20 else 1) + (0, 1, 2, 4)[fhd & 3] + (
        1 if fhd & 0x20 else 0, 2, 4, 8)[fhd >> 6]
    head = int.from_bytes(strip[pos:pos + 3], "little")
    pos += 3
    assert head >> 1 & 3 == 2  # a compressed block
    kind, fmt = strip[pos] & 3, strip[pos] >> 2 & 3
    assert kind == 2 and fmt in (1, 2, 3)
    size_bytes = {1: 3, 2: 4, 3: 5}[fmt]
    bits = {1: 10, 2: 14, 3: 18}[fmt]
    h = int.from_bytes(strip[pos:pos + size_bytes], "little")
    csize = h >> (4 + bits) & ((1 << bits) - 1)
    start = pos + size_bytes
    _, jump = zstd_decode._huffman_weights(strip[:start + csize], start)
    return offset, jump, start + csize


@pytest.fixture(scope="module")
def zstd_strip():
    rng = np.random.default_rng(4)
    pic = (rng.normal(128, 40, (24, 40, 3))).clip(0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(pic).save(buf, "TIFF", compression="zstd")
    return buf.getvalue()


@pytest.mark.parametrize("stream", [0, 1, 2])
@pytest.mark.parametrize("shift", [-9, -3, -1, 1, 2, 9])
def test_zstd_fast_huffman_loop_reads_past_stream_ends(zstd_strip, stream, shift, tmp_path):
    """A four-stream literals section whose jump table moves a boundary:
    libzstd's fast loop (each stream of 8 bytes or more) reads a stream on
    past its start into the bytes before it and checks no stream's end,
    failing only where its read pointer ends more than 8 bytes below a
    stream's start; the port equals PIL or both fail."""
    offset, jump, _ = _four_streams(zstd_strip)
    d = bytearray(zstd_strip)
    at = offset + jump + 2 * stream
    size = int.from_bytes(d[at:at + 2], "little")
    d[at:at + 2] = (size + shift).to_bytes(2, "little")
    _agree(bytes(d), tmp_path)


def test_zstd_fast_loop_takes_what_a_checked_loop_refuses(zstd_strip, tmp_path):
    """Some boundary moves decode in PIL (the fast loop) though no stream
    ends where its symbols end, which libzstd's checked loops refuse."""
    offset, jump, _ = _four_streams(zstd_strip)
    equal = 0
    for shift in (-2, -1, 1, 2):
        d = bytearray(zstd_strip)
        at = offset + jump
        d[at:at + 2] = (int.from_bytes(d[at:at + 2], "little") + shift).to_bytes(2, "little")
        equal += _outcome(bytes(d), tmp_path) == "equal"
    assert equal >= 2


def test_zstd_block_larger_than_its_window_fails(zstd_strip, tmp_path):
    """A window descriptor smaller than a block (blockSizeMax): libzstd
    fails the frame."""
    offset, _, _ = _four_streams(zstd_strip)
    d = bytearray(zstd_strip)
    assert d[offset + 4] & 0x20 == 0
    d[offset + 5] = 0  # a 1 KiB window
    _agree(bytes(d), tmp_path, reads=False)


def test_double_symbol_choice_follows_libzstd():
    """HUF_selectDecoder: small literal blocks decode one symbol a lookup,
    large compressible ones two."""
    assert not zstd_decode._double_symbols(1440, 1150)
    assert zstd_decode._double_symbols(128 << 10, 96 << 10)
    assert not zstd_decode._double_symbols(128 << 10, 130 << 10)


# --- ThunderScan -------------------------------------------------------------------------

def test_thunderscan_codes_decode_as_written():
    """Every code of the hand-built fixture: raw 5, +1, skip, -1, +3, skip,
    a run; a run from an odd pixel and 2-bit deltas past the row's end;
    raw 3 under data bits, a run of 0, 3-bit deltas past the end."""
    got = tiff_decode.decode_tiff((FIXTURES / "thunder_codes.tif").read_bytes())[..., 0] >> 4
    assert got.tolist() == [[5, 6, 5, 8, 8, 8, 8], [1, 1, 1, 1, 1, 1, 2],
                            [3, 3, 3, 3, 3, 3, 0]]


@pytest.mark.parametrize("row", [b"\xc5\x03", b"\xc5\x3f", b"\x08", b"\xc1" * 6])
def test_thunderscan_rows_of_other_lengths_fail(row, tmp_path):
    """Too few pixels (the data ends) or a run past the row's end (too much
    data): ThunderDecode fails the strip."""
    _agree(thunderscan_tiff([row], 7, 1, 1), tmp_path, reads=False)


def test_thunderscan_random_codes(tmp_path):
    """Random code bytes in strips of 1 to 3 rows: the port equals PIL or
    both fail."""
    rng = np.random.default_rng(7)
    seen = {}
    for _ in range(120):
        w, h = int(rng.integers(1, 24)), int(rng.integers(1, 5))
        strips = []
        for _ in range(h):
            b = rng.integers(0, 256, int(rng.integers(1, w + 4)), dtype=np.uint8)
            b[rng.random(len(b)) < 0.5] &= 0x0F
            strips.append(b.tobytes())
        got = _outcome(thunderscan_tiff(strips, w, h, 1), tmp_path)
        seen[got] = seen.get(got, 0) + 1
    assert set(seen) == {"equal", "both refuse"}, seen


@pytest.mark.parametrize("kind", ["tiled", "8_bit"])
def test_thunderscan_libtiff_does_not_decode(kind, tmp_path):
    """libtiff's ThunderScan codec decodes strips of 4-bit samples only."""
    values = np.arange(24).reshape(4, 6) % 16
    if kind == "tiled":
        data = tiff_file(values[..., None], 4, 1, comp=32809, tile=(16, 16),
                         codec=lambda c: thunderscan_row([0] * 256))
    else:
        data = thunderscan_coded(values, 4).replace(b"\x02\x01\x03\x00\x01\x00\x00\x00\x04",
                                                    b"\x02\x01\x03\x00\x01\x00\x00\x00\x08")
    _agree(data, tmp_path, reads=False)


# --- CCITT RLEW --------------------------------------------------------------------------

@pytest.mark.parametrize("rows_per_strip", [None, 3])
@pytest.mark.parametrize("lead", [b"", b"Z"])
def test_rlew_as_pil_reads_its_own_files(rows_per_strip, lead, tmp_path):
    """PIL's RLEW files at widths 1 to 40: after each row libtiff drops the
    bits it holds past a 16-bit multiple and, holding none, skips a byte
    at an odd address (the strip's offset in the mapped file), so it
    misreads its own files; the rows end at every bit offset modulo 16."""
    rng = np.random.default_rng(8)
    ends = set()
    for width in range(1, 41):
        ink = rng.random((7, width)) < 0.35
        ends.update(len(mh_row(row.astype(np.uint8))) % 16 for row in ink)
        _agree(rlew_tiff(ink, Image, rows_per_strip=rows_per_strip, lead=lead), tmp_path)
    assert ends == set(range(16))


@pytest.mark.parametrize("lead", [b"", b"Z"])
def test_rlew_rows_ending_on_words(lead, tmp_path):
    """Rows whose codes end on a 16-bit word, at an even and an odd offset."""
    _, strip = rlew_words(np.random.default_rng(9), 29, 8)
    data = tiff_from_chunks([strip], 8, [(256, 4, [29]), (257, 4, [8]), (258, 3, [1]),
                                         (259, 3, [32771]), (262, 3, [0]), (277, 3, [1])],
                            lead=lead)
    _agree(data, tmp_path, reads=True)


# --- IPTC around other formats -----------------------------------------------------------

@pytest.mark.parametrize("fmt", ["PNG", "TIFF", "BMP", "GIF", "WEBP", "PPM", "TGA", "JPEG"])
@pytest.mark.parametrize("band", [None, 1, 3])
def test_iptc_data_of_another_format(fmt, band, tmp_path):
    """PIL opens an IPTC image's compressed data with Image.open: any
    format, in its own mode where the image is one band L; where a band is
    named, merged as that band of RGB (an L image; in band 1, which
    Image.merge does not check, any one-band image, a P one as its
    indices; merge fails on more bands). The port equals PIL or refuses
    where PIL does, the GIF and TGA bodies in mode P or L among them."""
    rgb = Image.fromarray(np.add.outer(np.arange(9), np.arange(11))[..., None].repeat(3, 2)
                          .astype(np.uint8) * 7)
    for im in (rgb, rgb.convert("L")):
        buf = io.BytesIO()
        im.save(buf, fmt)
        with Image.open(io.BytesIO(buf.getvalue())) as body:
            mode = body.mode
        data = iptc_file(11, 9, 1 if band is None else 3, 0 if band is None else 1,
                         buf.getvalue(), 5, band=band, chunk=64)
        got = _outcome(data, tmp_path)
        if band is not None and (mode == "P" and band == 1 or mode == "L" and fmt in (
                "GIF", "TGA")):
            assert got == "equal", (fmt, band, mode, got)
        assert got in ("equal", "both refuse"), (fmt, band, mode, got)


def test_iptc_data_pil_fails_on(tmp_path):
    """IPTC data PIL cannot open (no format, a cut PNG): both fail."""
    for body in (b"not an image", (FIXTURES / "apng_frames.png").read_bytes()[:70]):
        _agree(iptc_file(4, 3, 1, 0, body, 5), tmp_path, reads=False)


def _band_body(fmt: str, mode: str) -> bytes:
    rgb = Image.fromarray(np.add.outer(np.arange(9), np.arange(11))[..., None].repeat(3, 2)
                          .astype(np.uint8) * 7)
    im = {"P": rgb.quantize(5), "PA": rgb.quantize(5).convert("PA"),
          "I;16": Image.fromarray((np.add.outer(np.arange(9), np.arange(11)) * 999)
                                  .astype(np.uint16))}.get(mode) or rgb.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt)
    return buf.getvalue()


@pytest.mark.parametrize("fmt,mode,band", [
    ("PNG", "P", 2), ("GIF", "P", 3), ("TGA", "P", 4), ("BMP", "P", 2), ("TIFF", "P", 3),
    ("PNG", "1", 2), ("PNG", "I;16", 3), ("TIFF", "I;16", 2), ("PNG", "LA", 1),
    ("TIFF", "LA", 2), ("TIFF", "PA", 1), ("PNG", "RGB", 1), ("TGA", "RGBA", 1),
    ("WEBP", "L", 1), ("WEBP", "RGB", 2)])
def test_iptc_band_kinds_pil_refuses_are_refused(fmt, mode, band, tmp_path):
    """The band images Image.merge refuses: a mode other than L past band 1
    ("mode mismatch"), and an image of more than one band in band 1 (the
    C merge's mode error; WebP opens as RGB whatever was saved). PIL
    fails, and the port refuses by name."""
    data = iptc_file(11, 9, 4 if band == 4 else 3, 1, _band_body(fmt, mode), 5, band=band)
    assert _outcome(data, tmp_path) == "both refuse"
    got = _port(data)
    assert isinstance(got, ValueError) and f"as band {band} of" in str(got), got


@pytest.mark.parametrize("fmt,mode", [("PCX", "L"), ("SGI", "L"), ("IM", "P")])
def test_iptc_band_of_a_format_left_for_later_is_refused_by_name(fmt, mode, tmp_path):
    """A band image in a format whose mode the port does not tell from the
    file (PCX, SGI, IM: their decoders convert some modes through others):
    PIL merges it; the port names it and leaves the atlas as it was."""
    data = iptc_file(11, 9, 3, 1, _band_body(fmt, mode), 5, band=1)
    assert _outcome(data, tmp_path).startswith("PIL pixels")
    got = _port(data)
    assert isinstance(got, ValueError) and "IPTC: an image of mode other as band 1" in str(got)


# --- APNG's first frame, and a PNG zlib stream ending on a row ---------------------------

_FULL = np.arange(9 * 12 * 3).reshape(9, 12, 3).astype(np.uint8)
_BOX = (255 - np.arange(4 * 5 * 3)).reshape(4, 5, 3).astype(np.uint8)
APNG = {
    "box_source": png_file(12, 9, actl(1), fctl(0, 5, 4, 3, 2),
                           png_chunk(b"IDAT", png_data(_BOX))),
    "box_previous_over": png_file(12, 9, actl(2), fctl(0, 5, 4, 7, 5, dispose=2, blend=1),
                                  png_chunk(b"IDAT", png_data(_BOX)), fctl(1, 12, 9),
                                  fdat(2, _FULL)),
    "box_background": png_file(12, 9, actl(1), fctl(0, 5, 4, 0, 0, dispose=1),
                               png_chunk(b"IDAT", png_data(_BOX))),
    "actl_without_fctl": png_file(12, 9, actl(1), png_chunk(b"IDAT", png_data(_FULL))),
    "two_fctl": png_file(12, 9, actl(1), fctl(0, 12, 9), fctl(1, 5, 4, 2, 2),
                         png_chunk(b"IDAT", png_data(_BOX))),
    "second_actl": png_file(12, 9, actl(2), actl(2), fctl(0, 5, 4, 1, 1),
                            png_chunk(b"IDAT", png_data(_BOX))),
    "frames_0": png_file(12, 9, actl(0), fctl(0, 5, 4, 1, 1),
                         png_chunk(b"IDAT", png_data(_BOX))),
    "fctl_without_actl": png_file(12, 9, fctl(0, 5, 4, 1, 1),
                                  png_chunk(b"IDAT", png_data(_BOX))),
    "fdat_first": png_file(12, 9, actl(1), fctl(0, 5, 4, 6, 4), fdat(1, _BOX)),
    "out_of_order": png_file(12, 9, actl(1), fctl(1, 5, 4), png_chunk(b"IDAT", png_data(_BOX))),
    "out_of_order_after": png_file(12, 9, actl(1), fctl(0, 12, 9),
                                   png_chunk(b"IDAT", png_data(_FULL)), fctl(3, 12, 9),
                                   fdat(4, _FULL)),
    "fdat_out_of_order": png_file(12, 9, actl(1), fctl(0, 5, 4, 6, 4), fdat(5, _BOX)),
    "box_outside": png_file(12, 9, actl(1), fctl(0, 5, 4, 9, 1),
                            png_chunk(b"IDAT", png_data(_BOX))),
    "box_empty": png_file(12, 9, actl(1), fctl(0, 0, 4, 1, 1),
                          png_chunk(b"IDAT", png_data(_BOX))),
    "actl_short": png_file(12, 9, png_chunk(b"acTL", bytes(4)),
                           png_chunk(b"IDAT", png_data(_FULL))),
    "fctl_short": png_file(12, 9, actl(1), png_chunk(b"fcTL", bytes(20)),
                           png_chunk(b"IDAT", png_data(_FULL))),
}
APNG_FAILS = {"out_of_order", "out_of_order_after", "fdat_out_of_order", "box_outside",
              "box_empty", "actl_short", "fctl_short"}


@pytest.mark.parametrize("name", sorted(APNG))
def test_apng_first_frame(name, tmp_path):
    """PIL's frame 0: the image data in the box of the last fcTL before it
    on a zeroed image (dispose and blend do not touch frame 0), the image
    data whole after an acTL without an fcTL (a default image); the
    sequence, the box and the chunks' lengths checked."""
    _agree(APNG[name], tmp_path, reads=name not in APNG_FAILS)


def test_apng_random_mutations(tmp_path):
    """Random APNGs (a box, dispose and blend ops, frames after) with bytes
    changed: the port equals PIL or both fail."""
    rng = np.random.default_rng(12)
    seen = {}
    for _ in range(150):
        w, h = int(rng.integers(1, 13)), int(rng.integers(1, 10))
        x, y = int(rng.integers(0, 13 - w)), int(rng.integers(0, 10 - h))
        box = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        parts = [actl(int(rng.integers(0, 3)))]
        if rng.random() < 0.7:
            parts.append(fctl(0, w, h, x, y, int(rng.integers(0, 3)), int(rng.integers(0, 2))))
        parts.append(png_chunk(b"IDAT", png_data(box)))
        if rng.random() < 0.5:
            parts += [fctl(int(rng.integers(0, 3)), w, h, x, y), fdat(int(rng.integers(0, 4)), box)]
        data = bytearray(png_file(12, 9, *parts))
        for _ in range(int(rng.integers(0, 3))):
            data[int(rng.integers(8, len(data)))] = int(rng.integers(256))
        got = _outcome(bytes(data), tmp_path)
        seen[got] = seen.get(got, 0) + 1
    assert set(seen) == {"equal", "both refuse"}, seen


@pytest.mark.parametrize("rows", [0, 1, 3, 5])
@pytest.mark.parametrize("partial", [0, 4])
def test_png_zlib_stream_ending_on_a_row(rows, partial, tmp_path):
    """ZipDecode ends the image where the zlib stream ends with a row (the
    rest zero) and fails where it ends inside one, or before the first."""
    data = b"".join(b"\0" + r.tobytes() for r in _FULL[:rows])
    data += (b"\0" + _FULL[rows].tobytes()[:partial]) if partial else b""
    png = png_file(12, 9, png_chunk(b"IDAT", zlib.compress(data)))
    _agree(png, tmp_path, reads=rows > 0 and not partial)


# --- the new fixtures: PIL again in a fresh process, and a scene -------------------------

def test_new_damaged_cases_rederived_with_pil():
    """Every damaged case of the new TIFF and IPTC fixtures opened again by
    PIL in a fresh process: the outcome damaged.json records."""
    rederive(sorted(set(NEW) & set(SWEEP)), 1)


def test_new_fixture_hashes_rederived_with_pil():
    """pil_rgb.json's hash of each new fixture, from PIL in a fresh process."""
    code = ("import sys, json, hashlib, pathlib, numpy as np; from PIL import Image; "
            "here = pathlib.Path(sys.argv[1]); out = {}\n"
            "for name in json.loads(sys.stdin.read()):\n"
            "    with Image.open(here / name) as im:\n"
            "        a = np.asarray(im.convert('RGB'))\n"
            "    out[name] = {'shape': list(a.shape), "
            "'sha256': hashlib.sha256(a.tobytes()).hexdigest()}\n"
            "print(json.dumps(out))")
    res = subprocess.run([sys.executable, "-c", code, str(FIXTURES)], input=json.dumps(NEW),
                         text=True, capture_output=True, check=True, timeout=120)
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(NEW) == 21 and all(got[n] == RECORD[n] for n in NEW)


_TEXTURE_PATHS = ("textures", "textures_packed", "tex_quads", "tex_fp", "objects.tex_offset",
                  "objects.tex_w", "objects.tex_h")


def _leaf(scene, path):
    for part in path.split("."):
        scene = getattr(scene, part)
    return scene


def test_scene_with_thunderscan_and_iptc_png_textures_matches_jax(tmp_path):
    """A DSL scene with a ThunderScan, an RLEW, an IPTC-wrapped PNG and an
    APNG texture, each shared by two objects, through the JAX package's
    build_scene (PIL) and the port's: every texture array exact, and the
    JAX scene carried over by scene_from_numpy equal to the port's own."""
    import jax

    from relativitypathtracer_tpu import build_scene as jbuild
    from relativitypathtracer_tpu.models.dsl import parse_scene as jparse

    names = ["blob_thunder.tif", "iptc_png.iim", "rlew_strips.tif", "apng_box_previous.png"]
    for name in names:
        (tmp_path / name).write_bytes((FIXTURES / name).read_bytes())
    n = len(names)
    objects = [f"{'Os' if k % 2 else 'Oc'}\n p{k % 7 - 3},{k // 7 - 1},{6 + k % 3},0,0,1,0,0.6,"
               f"0.6,0.6\n t{k % n}\n" for k in range(2 * n)]
    text = "".join(f"T{name}\n" for name in names) + "".join(objects) + "R\n"
    js, jm = jbuild(jparse(text, str(tmp_path)))
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None
    try:
        ps, pm = pt.build_scene(pt.parse_scene(text, str(tmp_path)), device="cpu")
    finally:
        sys.modules["PIL"] = saved
    assert pm.textured_ids == tuple(range(2 * n)) and pm.use_footprint_tex == jm.use_footprint_tex
    for path in _TEXTURE_PATHS:
        want = np.asarray(_leaf(js, path))
        got = _leaf(ps, path).numpy()
        assert got.shape == want.shape and np.array_equal(got.astype(np.int64),
                                                          want.astype(np.int64)), path
    carried = pt.scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    for path in _TEXTURE_PATHS + ("objects.m", "objects.color", "tex_textured"):
        a, b = _leaf(carried, path), _leaf(ps, path)
        assert a.dtype == b.dtype and torch.equal(a, b), path
