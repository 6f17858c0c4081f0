"""The port's decoders of PIL's small raster formats (utils/psd_decode,
utils/legacy_raster: SGI, PCX, DCX, Sun raster, QOI, MSP; utils/icon_decode:
ICO, CUR, ICNS; utils/text_raster: XBM, XPM; PIL's LAB conversion in
utils/pil_modes) against PIL, the JAX package's decoder.

Tolerance 0: every decode equals `np.asarray(Image.open(f).convert("RGB"))`
byte for byte, with PIL blocked while the port decodes. Files PIL writes in
each mode it writes, the committed fixtures (tests/torch_textures/
make_fixtures.py's `legacy_fixtures`), the quirks PIL's readers have
(ICO's entry order, CUR's choice, PSD's inverted CMYK and signed Lab,
ICNS's RLE, PCX's plane packing, SGI's row buffer, XBM's 'x' scan), random
PackBits, SGI RLE, PCX RLE, Sun RLE and QOI op streams (hypothesis,
derandomised: both give the same pixels or both refuse), and broken files:
each raises TextureError naming its cause, and PIL fails on it too. A DSL
scene with PSD, SGI, PCX and QOI textures builds to the JAX package's
texture arrays.
"""

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
from torch_textures.make_fixtures import (dcx_file, dib, icns_file, icns_rgb, icon_file, msp_file,
                                          packbits, pcx_file, psd_file, qoi_file, sgi_file,
                                          sgi_rle_row, sun_file, sun_rle, sun_rows, xpm_file)

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch.models import texture
from relativitypathtracer_tpu_torch.models.texture import TextureError, decode_texture, read_texture
from relativitypathtracer_tpu_torch.utils import pil_modes

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "torch_textures"
RECORD = json.loads((FIXTURES / "pil_rgb.json").read_text())["files"]
SUFFIXES = (".psd", ".sgi", ".bw", ".rgb", ".pcx", ".dcx", ".ras", ".qoi", ".msp", ".ico",
            ".cur", ".icns", ".xbm", ".xpm")
LEGACY = sorted(n for n in RECORD if n.endswith(SUFFIXES))


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _pil_outcome(data: bytes):
    """PIL's pixels, or the exception it raises."""
    try:
        return _pil(data)
    except Exception as e:  # noqa: BLE001 - any failure is PIL's refusal
        return e


def _port(data: bytes, monkeypatch=None):
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


def _picture(seed: int, w: int, h: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 7 + y * 3, x * x // 3 + y, (y * 11) ^ (x * 5)], -1) % 256
    return np.clip(base + rng.integers(-30, 30, (h, w, 3)), 0, 255).astype(np.uint8)


def _save(im, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


# --- the committed fixtures -----------------------------------------------------

@pytest.mark.parametrize("name", LEGACY)
def test_fixture_decodes_to_pil_bytes(name):
    """Each committed file of the slice's formats, decoded with PIL blocked,
    equals PIL's convert("RGB") now and the hash PIL gave where it was
    made."""
    import hashlib

    data = (FIXTURES / name).read_bytes()
    got = _port(data)
    assert not isinstance(got, Exception), got
    assert list(got.shape) == RECORD[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == RECORD[name]["sha256"]
    assert np.array_equal(got, _pil(data))


def test_every_format_of_the_slice_has_fixtures():
    with_format = {}
    for name in LEGACY:
        with Image.open(FIXTURES / name) as im:
            with_format.setdefault(im.format, []).append(name)
    assert set(with_format) == {"PSD", "SGI", "PCX", "DCX", "SUN", "QOI", "MSP", "ICO", "CUR",
                                "ICNS", "XBM", "XPM"}
    assert all(len((FIXTURES / n).read_bytes()) < 4096 for n in LEGACY)


# --- files PIL writes --------------------------------------------------------------

def _pil_written():
    cases = {}
    for w, h in ((1, 1), (13, 7), (16, 9), (33, 5)):
        p = Image.fromarray(_picture(w * 7 + h, w, h))
        for mode in ("1", "L", "P", "RGB"):
            im = p.quantize(17) if mode == "P" else p.convert(mode)
            cases[f"pcx_{mode}_{w}x{h}"] = _save(im, "PCX")
        for mode in ("L", "RGB", "RGBA"):
            for bpc in (1, 2):
                cases[f"sgi_{mode}_{bpc}_{w}x{h}"] = _save(p.convert(mode), "SGI", bpc=bpc)
        cases[f"msp_{w}x{h}"] = _save(p.convert("1"), "MSP")
        cases[f"xbm_{w}x{h}"] = _save(p.convert("1"), "XBM")
        cases[f"qoi_rgb_{w}x{h}"] = _save(p, "QOI")
        cases[f"qoi_rgba_{w}x{h}"] = _save(p.convert("RGBA"), "QOI")
    icon = Image.fromarray(_picture(3, 48, 48))
    cases["ico_png"] = _save(icon, "ICO", sizes=[(16, 16), (24, 24), (48, 48)])
    cases["ico_bmp"] = _save(icon, "ICO", sizes=[(16, 16), (32, 32)], bitmap_format="bmp")
    cases["ico_bmp_palette"] = _save(icon.quantize(16), "ICO", sizes=[(16, 16), (32, 32)],
                                     bitmap_format="bmp")
    cases["ico_bmp_1bit"] = _save(icon.convert("1"), "ICO", sizes=[(16, 16)],
                                  bitmap_format="bmp")
    cases["icns"] = _save(Image.fromarray(_picture(4, 40, 40)), "ICNS")
    cases["dcx_of_pil_pages"] = dcx_file([_save(icon.quantize(7), "PCX"),
                                          _save(icon.convert("1"), "PCX")])
    return cases


PIL_WRITTEN = _pil_written()


@pytest.mark.parametrize("case", sorted(PIL_WRITTEN))
def test_pil_written_files_decode_as_pil(case):
    """Each equals PIL's decode; PIL cannot read back its own 1x1 RGB PCX
    (its decoder finds a run across the line), and the port refuses it
    too."""
    if case == "pcx_RGB_1x1":
        assert isinstance(_pil_outcome(PIL_WRITTEN[case]), OSError)
    _agree(PIL_WRITTEN[case])


# --- PIL's quirks ------------------------------------------------------------------

def test_ico_opens_the_lowest_depth_of_the_largest_entries():
    """IcoFile sorts by colour depth, then by area descending (stable): of
    three 12x12 entries at 24, 8 and 4 bits (the last from its colour
    count), PIL opens the 4-bit one; a 0 size byte is 256 wide."""
    rng = np.random.default_rng(5)
    rgb = _picture(5, 12, 12)
    pal = [tuple(int(c) for c in rng.integers(0, 256, 3)) for _ in range(16)]
    idx = rng.integers(0, 16, (12, 12))
    entries = [(12, 12, 0, 24, dib(rgb, 24)), (12, 12, 0, 8, dib(idx, 8, pal + [(0, 0, 0)] * 240)),
               (12, 12, 16, 0, dib(idx, 4, pal)), (8, 8, 0, 32, dib(rgb[:8, :8], 32))]
    data = icon_file(1, entries)
    want = np.asarray(pal, np.uint8)[idx]
    assert np.array_equal(_pil(data), want)
    _equal_to_pil(data)
    entries = [(12, 12, 0, 24, dib(rgb, 24)), (0, 1, 0, 24, dib(rgb[:1, :5], 24))]
    _equal_to_pil(icon_file(1, entries))  # the "256-wide" entry is picked: its DIB is 5 wide


def test_cur_keeps_the_first_entry_unless_both_sides_are_larger():
    rgb = _picture(6, 13, 11)
    entries = [(7, 5, 0, 24, dib(rgb[:5, :7], 24)), (11, 4, 0, 24, dib(rgb[:4, :11], 24)),
               (9, 9, 0, 24, dib(rgb[:9, :9], 24)), (13, 11, 0, 32, dib(rgb, 32))]
    for n, side in ((2, 7), (3, 9), (4, 13)):
        data = icon_file(2, entries[:n])
        _equal_to_pil(data)
        assert _port(data).shape[1] == side


@pytest.mark.parametrize("kind", ["it32", "ih32", "il32", "is32"])
def test_icns_rle_resources(kind):
    """read_32's RLE: a control byte >= 0x80 repeats the next byte
    (byte - 125) times, one below copies byte + 1 bytes; the three channel
    planes one after another; it32 behind 4 zero bytes; a mask beside."""
    side = {"it32": 128, "ih32": 48, "il32": 32, "is32": 16}[kind]
    rgb = _picture(side, side, side) // 32 * 32
    mask = {"ih32": b"h8mk", "il32": b"l8mk", "is32": b"s8mk"}.get(kind)
    blocks = [(kind.encode(), icns_rgb(rgb, it32=kind == "it32"))]
    if mask:
        blocks.append((mask, bytes(side * side)))
    data = icns_file(blocks)
    _equal_to_pil(data)
    assert np.array_equal(_port(data), rgb)
    raw = icns_file([(kind.encode(), (b"\0" * 4 if kind == "it32" else b"") + rgb.tobytes())])
    _equal_to_pil(raw)  # exactly three bytes a pixel: stored raw


def test_psd_cmyk_is_inverted_and_lab_signed():
    """PIL reads PSD CMYK samples inverted (";I") and Lab's a and b with the
    top bit flipped, then converts LAB through littleCMS."""
    rng = np.random.default_rng(9)
    planes = rng.integers(0, 256, (4, 5, 6))
    _equal_to_pil(psd_file(4, 8, planes))
    want = pil_modes.cmyk_to_rgb(255 - planes.transpose(1, 2, 0))
    assert np.array_equal(_port(psd_file(4, 8, planes)), want)
    _equal_to_pil(psd_file(9, 8, planes[:3], comp=1))


def test_lab_conversion_equals_pil_on_a_grid():
    """pil_modes.lab_to_rgb against PIL's LAB -> RGB (littleCMS) on every
    value of L, a and b in steps of 3 plus the ends (636,056 triples; the
    whole 2**24 match too, in about 15 s)."""
    v = np.unique(np.r_[np.arange(0, 256, 3), 255])
    lab = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(1, -1, 3).astype(np.uint8)
    want = np.asarray(Image.frombytes("LAB", (lab.shape[1], 1), lab.tobytes()).convert("RGB"))
    assert np.array_equal(pil_modes.lab_to_rgb(lab), want)


def test_pcx_planes_are_packed_as_pil_packs_them():
    """1-bit planes padded to an even stride, 8-bit planes of an odd width
    padded: PIL's decoder packs each line's planes before unpacking."""
    rng = np.random.default_rng(11)
    for width in (1, 3, 9, 19, 24):
        for planes in (2, 4):
            idx = rng.integers(0, 1 << planes, (5, width))
            stride = -(-width // 8)
            for pad in (0, 1, 2):
                lines = [b"".join(np.packbits((row >> k) & 1).tobytes() + bytes(pad)
                                  for k in range(planes)) for row in idx]
                _agree(pcx_file(lines, width, 5, 1, planes, stride=stride + pad,
                                palette16=rng.integers(0, 256, 48, dtype=np.uint8).tobytes()))
        rgb = _picture(width, width, 4)
        for pad in (0, 1):
            lines = [b"".join(rgb[r, :, c].tobytes() + bytes(pad) for c in range(3))
                     for r in range(4)]
            _agree(pcx_file(lines, width, 4, 8, 3, stride=width + pad))


def test_sgi_rle_row_buffer_and_early_end():
    """SGI's RLE rows fill PIL's row buffer, which keeps the last row's
    samples past a short row; a length counts atoms, and a row whose last
    atom (by that count) is not 0 ends the image there, the rows after it
    black."""
    rgb = _picture(12, 9, 6)
    _equal_to_pil(sgi_file(rgb, rle=True, rows={(0, 2): sgi_rle_row(rgb[::-1][2, :4, 0])}))
    data = bytearray(sgi_file(rgb, rle=True))
    lengths = 512 + 4 * 6 * 3
    data[lengths + 4 * (3 + 6):lengths + 4 * (4 + 6)] = struct.pack(">I", 1)  # channel 1, row 3
    got = _port(bytes(data))
    _equal_to_pil(bytes(data))
    assert (got[:3] == 0).all() and np.array_equal(got[3:], rgb[3:])
    data[lengths + 4 * (3 + 6):lengths + 4 * (4 + 6)] = struct.pack(">I", 3)  # reads on
    _agree(bytes(data))


def test_xbm_reads_bytes_from_each_x():
    """XbmDecode: each 'x' starts a byte from the two characters after it
    (a non-digit counting 0), the next looked for three bytes on; the
    expression takes the last `_bits[]` in the first 512 bytes."""
    body = b"0x1,0xg2, 0xxab 0X12, x34,x5"
    data = b"#define a_width 11\n#define a_height 2\nstatic char a_bits[] = {" + body + b"};"
    _equal_to_pil(data)
    data = b"#define a_width 4\n#define a_height 1\n/* a_bits[] */ x_bits[] = {0x0f};"
    _equal_to_pil(data)


@pytest.mark.parametrize("cpp", [1, 2, 3])
def test_xpm_keys(cpp):
    rng = np.random.default_rng(cpp)
    colours = ["#%06x" % int(c) for c in rng.integers(0, 1 << 24, 40)] + ["None", "#abc"]
    idx = rng.integers(0, 40, (7, 13))
    idx[0, 0] = 41
    _equal_to_pil(xpm_file(idx, colours, cpp))
    _equal_to_pil(xpm_file(idx, colours, cpp, pixels_comment=False))
    big = ["#%06x" % i for i in range(300)]
    _equal_to_pil(xpm_file(rng.integers(0, 300, (5, 6)), big, 2))  # past 256: RGB


def test_msp_v2_rows():
    rng = np.random.default_rng(13)
    rows = rng.integers(0, 256, (6, 5), dtype=np.uint8)
    rows[1] = 0
    rows[3, 1:] = 0xAA
    data = msp_file(37, 6, rows)
    _equal_to_pil(data)
    rowmap = 32
    empty = data[:rowmap + 2] + b"\0\0" + data[rowmap + 4:]  # row 1's length 0: white
    _agree(empty)


def test_sun_rle_runs_cross_rows():
    rng = np.random.default_rng(14)
    idx = rng.integers(0, 4, (5, 7)).astype(np.uint8)
    idx[1:3] = 0x80
    for depth, body in ((8, idx.tobytes()), (24, np.repeat(idx, 3, 1).tobytes())):
        _equal_to_pil(sun_file(7, 5, depth, sun_rle(body), kind=2))
    _equal_to_pil(sun_file(7, 5, 8, sun_rows(idx), kind=1, cmap=bytes(range(12))))


# --- random streams ----------------------------------------------------------------

def _packets(rng, total: int) -> bytes:
    """Random PackBits packets (runs, literals, 0x80 no-ops) of about
    `total` bytes."""
    out, made = bytearray(), 0
    while made < total:
        head = int(rng.integers(0, 256))
        out.append(head)
        if head < 128:
            out += rng.integers(0, 256, head + 1, dtype=np.uint8).tobytes()
            made += head + 1
        elif head > 128:
            out.append(int(rng.integers(0, 256)))
            made += 257 - head
    return bytes(out)


def random_psd(seed: int, width: int, height: int) -> bytes:
    rng = np.random.default_rng(seed)
    mode, channels = [(1, 1), (3, 3), (3, 4), (4, 4), (0, 1)][int(rng.integers(0, 5))]
    bits = 1 if mode == 0 else 8
    row = -(-width // 8) if bits == 1 else width
    streams = [_packets(rng, int(rng.integers(0, 2 * row * height + 2))) for _ in range(channels)]
    counts = []
    for stream in streams:
        cuts = np.sort(rng.integers(0, len(stream) + 1, height - 1))
        counts += np.diff(np.r_[0, cuts, len(stream)]).tolist()
    if rng.random() < 0.1:
        counts[int(rng.integers(0, len(counts)))] += int(rng.integers(1, 9))
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels, height, width, bits, mode)
    data = (head + bytes(12) + struct.pack(">H", 1) + struct.pack(f">{len(counts)}H", *counts)
            + b"".join(streams))
    return data[:int(rng.integers(len(data) - 8, len(data) + 1))] if rng.random() < 0.2 else data


def random_sgi(seed: int, width: int, height: int) -> bytes:
    rng = np.random.default_rng(seed)
    bpc = int(rng.integers(1, 3))
    z = [1, 3, 4][int(rng.integers(0, 3))]
    chunks = []
    for _ in range(z * height):
        atoms, x = [], 0
        for _ in range(int(rng.integers(0, 6))):
            count = int(rng.integers(0, width + 2)) if rng.random() < 0.9 else 0
            count = min(count, 127)
            if rng.random() < 0.5:
                atoms += [0x80 | count] + rng.integers(0, 256, count * bpc).tolist()[::bpc]
            else:
                atoms += [count, int(rng.integers(0, 256))]
            x += count
        if rng.random() < 0.85:
            atoms.append(0)
        atom = (lambda a: bytes([a])) if bpc == 1 else (lambda a: bytes([int(rng.integers(0, 3)), a]))
        chunks.append(b"".join(atom(a) for a in atoms))
    starts, pos = [], 512 + 8 * z * height
    for c in chunks:
        starts.append(pos)
        pos += len(c)
    lengths = [len(c) // bpc + int(rng.integers(-1, 2)) * (rng.random() < 0.2) for c in chunks]
    head = struct.pack(">HBBHHHH", 474, 1, bpc, 3 if z > 1 else 2, width, height, z).ljust(512,
                                                                                           b"\0")
    return (head + struct.pack(f">{len(starts)}I", *starts)
            + struct.pack(f">{len(lengths)}I", *[max(0, v) for v in lengths]) + b"".join(chunks))


def random_pcx(seed: int, width: int, height: int) -> bytes:
    rng = np.random.default_rng(seed)
    bits, planes = [(1, 1), (1, 2), (1, 4), (8, 1), (8, 3)][int(rng.integers(0, 5))]
    stride = -(-width * bits // 8) + int(rng.integers(0, 3))
    total = planes * stride * height
    out, made = bytearray(), 0
    while made < total + int(rng.integers(-3, 3)):
        if rng.random() < 0.4:
            n = int(rng.integers(0, 64))
            out += bytes([0xC0 | n, int(rng.integers(0, 256))])
            made += n
        else:
            out.append(int(rng.integers(0, 0xC0)))
            made += 1
    head = (struct.pack("<BBBBHHHHHH", 10, 5, 1, bits, 0, 0, width - 1, height - 1, 72, 72)
            + rng.integers(0, 256, 48, dtype=np.uint8).tobytes() + b"\0"
            + struct.pack("<BHH", planes, stride, 1)).ljust(128, b"\0")
    tail = (b"\x0c" + rng.integers(0, 256, 768, dtype=np.uint8).tobytes()) if bits == 8 else b""
    return head + bytes(out) + tail


def random_sun(seed: int, width: int, height: int) -> bytes:
    rng = np.random.default_rng(seed)
    depth = [1, 4, 8, 24, 32][int(rng.integers(0, 5))]
    total = (width * depth + 7) // 8 * height
    out, made = bytearray(), 0
    while made < total + int(rng.integers(-2, 2)):
        r = rng.random()
        if r < 0.25:
            n = int(rng.integers(1, 256))
            out += bytes([0x80, n, int(rng.integers(0, 256))])
            made += n + 1
        elif r < 0.35:
            out += b"\x80\x00"
            made += 1
        else:
            out.append(int(rng.integers(0, 256)) & 0x7F)
            made += 1
    cmap = rng.integers(0, 256, 3 * int(rng.integers(1, 20)), dtype=np.uint8).tobytes() \
        if depth in (4, 8) and rng.random() < 0.5 else b""
    return sun_file(width, height, depth, bytes(out), kind=2, cmap=cmap)


def random_qoi(seed: int, width: int, height: int) -> bytes:
    rng = np.random.default_rng(seed)
    channels = int(rng.integers(3, 5))
    out, made = bytearray(), 0
    while made < width * height + int(rng.integers(-2, 2)):
        kind = int(rng.integers(0, 6))
        if kind == 0:
            out += b"\xfe" + rng.integers(0, 256, 3, dtype=np.uint8).tobytes()
        elif kind == 1:
            out += b"\xff" + rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
        elif kind == 2:
            out.append(int(rng.integers(0, 64)))
        elif kind == 3:
            out.append(0x40 | int(rng.integers(0, 64)))
        elif kind == 4:
            out += bytes([0x80 | int(rng.integers(0, 64)), int(rng.integers(0, 256))])
        else:
            n = int(rng.integers(0, 62))
            out.append(0xC0 | n)
            made += n
        made += 1
    return qoi_file(width, height, channels, bytes(out))


STREAMS = {"psd_packbits": random_psd, "sgi_rle": random_sgi, "pcx_rle": random_pcx,
           "sun_rle": random_sun, "qoi_ops": random_qoi}


@pytest.mark.parametrize("kind", sorted(STREAMS))
@settings(derandomize=True, max_examples=60, deadline=None)
@given(width=st.integers(1, 19), height=st.integers(1, 9), seed=st.integers(0, 2**32 - 1))
def test_random_streams_agree_with_pil(kind, width, height, seed):
    """Random streams of each RLE or op code: the port's pixels equal PIL's,
    or both refuse."""
    _agree(STREAMS[kind](seed, width, height))


# --- what is refused -------------------------------------------------------------------

def _truncated():
    cases = {}
    for name in ("blob_packbits.psd", "rgb_raw.psd", "cubes_rle.sgi", "verbatim.rgb",
                 "rgb16.sgi", "palette.pcx", "two_pages.dcx", "sun24_rle.ras", "sun8.ras",
                 "rgb.qoi", "v1.msp", "v2.msp", "bmp_entries.ico", "png_entries.ico",
                 "cursor.cur", "it32.icns", "png.icns", "bitmap.xbm", "one_char.xpm"):
        data = (FIXTURES / name).read_bytes()
        cut = {".pcx": len(data) - 800, ".dcx": len(data) // 3,
               ".cur": len(data) // 3}.get(pathlib.Path(name).suffix, len(data) * 2 // 3)
        cases[f"truncated_{name}"] = (data[:cut], None)
    return cases


def _refused():
    rng = np.random.default_rng(21)
    planes = rng.integers(0, 256, (3, 4, 5))
    psd16 = psd_file(3, 16, np.repeat(planes, 2, 2))
    gradient = np.add.outer(np.arange(128), np.arange(128)).astype(np.uint8)
    j2k = icns_file([(b"ic07", _save(Image.fromarray(np.stack([gradient, gradient.T, 255 - gradient],
                                                              -1)), "JPEG2000", no_jp2=True,
                                     quality_layers=[150])), (b"is32", bytes(768))])
    unknown_colour = xpm_file(rng.integers(0, 2, (2, 3)), ["#ff0000", "red"], 1)
    huge = {
        "psd": psd_file(3, 8, planes).replace(struct.pack(">II", 4, 5), struct.pack(">II", 20000,
                                                                                      10000), 1),
        "sgi": sgi_file(_picture(1, 5, 4)).replace(struct.pack(">HHH", 5, 4, 3),
                                                   struct.pack(">HHH", 30000, 6000, 3), 1),
        "pcx": pcx_file([b"\1\2"] * 2, 2, 2, 8, 1, palette256=bytes(768)).replace(
            struct.pack("<HHHH", 0, 0, 1, 1), struct.pack("<HHHH", 0, 0, 20000, 10000), 1),
        "dcx": dcx_file([pcx_file([b"\1\2"] * 2, 2, 2, 8, 1, palette256=bytes(768)).replace(
            struct.pack("<HHHH", 0, 0, 1, 1), struct.pack("<HHHH", 0, 0, 20000, 10000), 1)]),
        "sun": sun_file(20000, 10000, 8, bytes(30)),
        "qoi": qoi_file(20000, 10000, 3, bytes(30)),
        "msp": msp_file(30000, 6000, np.zeros((1, 2), np.uint8), version=1),
        "ico": icon_file(1, [(4, 4, 0, 24, struct.pack("<IiiHHIIiiII", 40, 20000, 20000, 1, 24,
                                                          0, 0, 0, 0, 0, 0) + bytes(64))]),
        "cur": icon_file(2, [(4, 4, 0, 24, struct.pack("<IiiHHIIiiII", 40, 20000, 20000, 1, 24,
                                                          0, 0, 0, 0, 0, 0) + bytes(64))]),
        "xbm": b"#define a_width 20000\n#define a_height 10000\nstatic char a_bits[] = {0x00};",
        "xpm": xpm_file(np.zeros((1, 1), np.int64), ["#000000"], 1).replace(b'"1 1 ',
                                                                             b'"20000 10000 '),
    }
    cases = {f"huge_{k}": (v, "more pixels than 178,956,970") for k, v in huge.items()}
    cases.update({
        "psd_16_bit": (psd16, "at 16 bits"),
        "psd_version_2": (psd_file(3, 8, planes).replace(b"8BPS\0\1", b"8BPS\0\2", 1),
                          "unknown format"),
        "psd_too_few_channels": (psd_file(3, 8, planes[:2]), "fewer than mode RGB needs"),
        "psd_zip": (psd_file(3, 8, planes).replace(bytes(12) + b"\0\0", bytes(12) + b"\0\2", 1),
                    "compression 2"),
        "xpm_colour_name": (unknown_colour, "colour name 'red'"),
        "xpm_none_used": (xpm_file(np.array([[0, 1]]), ["None", "#ffffff"], 1), "no colour"),
        "icns_jpeg2000": (j2k, DECODED),
        "sgi_bad_mode": (sgi_file(_picture(2, 3, 3), dimension=2), "not a mode PIL reads"),
        "sun_map_on_rgb": (sun_file(2, 2, 24, bytes(12), cmap=bytes(6)), "colour map beside 24"),
        "pcx_planes_3_at_1_bit": (pcx_file([b"\0\0\0"] * 2, 8, 2, 1, 3), "not a mode PIL reads"),
        "msp_bad_checksum": (msp_file(8, 2, np.zeros((2, 1), np.uint8), version=1)[:24] + b"\1"
                             + msp_file(8, 2, np.zeros((2, 1), np.uint8), version=1)[25:],
                             "unknown format"),
    })
    cases.update(_truncated())
    return cases


DECODED = "decoded now"  # a kind once refused that the port decodes
REFUSED = _refused()


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_broken_files_raise_texture_error(tmp_path, kind, monkeypatch):
    """Each raises TextureError naming the file and its cause (truncated
    files: any cause), with PIL blocked, and leaves the atlas as it was.
    A kind once refused and decoded now (JPEG 2000 in ICNS) reads to PIL's
    pixels."""
    data, words = REFUSED[kind]
    path = tmp_path / "t.bin"
    path.write_bytes(data)
    want = _pil(data) if words == DECODED else None
    monkeypatch.setitem(sys.modules, "PIL", None)
    atlas, values = bytearray(b"keep"), []
    if words == DECODED:
        read_texture(str(path), atlas, values)
        h, w, _ = want.shape
        assert values == [4, w, h] and bytes(atlas[4:]) == want.tobytes()
        return
    with pytest.raises(TextureError) as err:
        read_texture(str(path), atlas, values)
    assert str(path) in str(err.value) and (words or "") in str(err.value), str(err.value)
    assert atlas == b"keep" and values == []


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_pil_fails_on_the_broken_files(tmp_path, kind):
    """The broken files are broken for PIL too (opened from a path, as the
    JAX package opens them), the huge ones past its decompression-bomb
    limit; the kinds decoded now open in PIL, to the port's pixels."""
    path = tmp_path / "t.bin"
    path.write_bytes(REFUSED[kind][0])
    if REFUSED[kind][1] == DECODED:
        with Image.open(path) as im:
            assert np.array_equal(np.asarray(im.convert("RGB")), _port(REFUSED[kind][0]))
        return
    with pytest.raises(Image.DecompressionBombError if kind.startswith("huge") else Exception):
        with Image.open(path) as im:
            im.convert("RGB")


@pytest.mark.parametrize("fmt,mode", [("IM", "RGB"), ("IM", "L"), ("SPIDER", "F")])
def test_pil_formats_left_for_later_are_refused_by_name(fmt, mode, monkeypatch):
    """Files PIL writes in formats once left for later (IM, SPIDER) now
    decode, with PIL blocked, to PIL's pixels (utils/im_decode,
    utils/misc_raster)."""
    data = _save(Image.fromarray(_picture(8, 9, 7)).convert(mode), fmt)
    with Image.open(io.BytesIO(data)) as im:
        assert im.format == fmt
    assert fmt not in texture._OTHER_FORMATS
    _equal_to_pil(data)


@pytest.mark.parametrize("name,first", [
    ("FITS", b"SIMPLE  =                    T"), ("JPEG 2000", b"\xff\x4f\xff\x51" + bytes(40)),
    ("FLI/FLC", b"\0\0\0\0\x11\xaf" + bytes(8) + b"\3\0" + bytes(20)),
    ("McIdas", b"\0\0\0\0\0\0\0\4" + bytes(300)), ("PIXAR", b"\x80\xe8\0\0" + bytes(600)),
    ("XVThumb", b"P7 332\n" + bytes(20)), ("PCD", b"\1" * 2048 + b"PCD_" + bytes(1600)),
    ("GBR", struct.pack(">5I", 28, 2, 1, 1, 1) + b"GIMP" + bytes(20)),
    ("AVIF/HEIF", b"\0\0\0\x1cftypavif" + bytes(20))])
def test_other_formats_are_named(name, first):
    """Each format once left for later is told by PIL's own checks. AVIF/HEIF
    is still refused by name. The stubs of formats decoded now: FITS's,
    JPEG 2000's, XVThumb's (no size line) and PCD's (no base image) are
    broken files that the port names by format and cause and that PIL
    fails on too; FLI/FLC's (a header short of 128 bytes), McIdas's (0
    bytes a sample) and PIXAR's (mode (0, 0)) fail their plugin's own
    checks, so PIL identifies no format and the port names none; GBR's is
    a whole 1x1 brush, decoded as PIL decodes it."""
    if name == "AVIF/HEIF":
        with pytest.raises(ValueError, match=f"^{name}: "):
            decode_texture(first)
        assert name in texture._OTHER_FORMATS
        return
    assert name not in texture._OTHER_FORMATS
    if name == "GBR":
        _equal_to_pil(first)
    elif name in ("FLI/FLC", "McIdas", "PIXAR"):
        with pytest.raises(ValueError, match="^unknown format"):
            decode_texture(first)
        assert isinstance(_pil_outcome(first), Image.UnidentifiedImageError)
    else:
        with pytest.raises(ValueError, match=f"^{name}: "):
            decode_texture(first)
        assert isinstance(_pil_outcome(first), Exception)


def test_a_tga_is_never_taken_for_a_brush():
    """A TGA whose first 8 bytes pass GBR's accept test but not its _open
    checks opens as a TGA in PIL and in the port."""
    from torch_textures.make_fixtures import tga_file

    data = bytearray(tga_file(3, 2, 2, 24, bytes(range(18))))
    data[0:8] = b"\0\0\2\x14\0\0\0\1"  # a GBR version 1 header size 0x214; cmap fields
    data = bytes(data)
    with Image.open(io.BytesIO(data)) as im:
        assert im.format == "TGA"
    _equal_to_pil(data)


# --- read_texture, scenes, and the JAX package --------------------------------------------

SCENE_FIXTURES = ("blob_packbits.psd", "cubes_rle.sgi", "palette.pcx", "rgba.qoi", "lab.psd",
                  "two_pages.dcx", "sun8_map_rle.ras", "v2.msp", "equal_sizes.ico", "cursor.cur",
                  "it32.icns", "bitmap.xbm", "two_chars_none.xpm")


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


def test_scene_with_psd_sgi_pcx_and_qoi_textures_matches_jax(tmp_path):
    """A DSL scene with PSD, SGI, PCX and QOI textures, each shared by two
    objects, through the JAX package's build_scene (PIL) and the port's:
    every texture array exact, and the JAX scene carried over by
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


def test_packbits_builder_round_trips():
    """make_fixtures' PackBits and SGI RLE encoders, the fixtures' source,
    code what PIL reads back."""
    rgb = _picture(15, 17, 5)
    rgb[1:3] = 7
    _equal_to_pil(psd_file(3, 8, rgb.transpose(2, 0, 1), comp=1))
    assert np.array_equal(_port(psd_file(3, 8, rgb.transpose(2, 0, 1), comp=1)), rgb)
    assert np.array_equal(_port(sgi_file(rgb, rle=True)), rgb)
    assert len(packbits(bytes(300))) == 6
