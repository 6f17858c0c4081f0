"""The port's JPEG 2000 decoder (utils/j2k_codestream, utils/j2k_tier1,
utils/j2k_decode; JPEG 2000 in ICNS by utils/icon_decode; PIL's YCbCr
conversion in utils/pil_modes) against PIL 12.1.0 with OpenJPEG 2.5.4,
the JAX package's decoder.

Tolerance 0: every decode equals `np.asarray(Image.open(f).convert("RGB"))`
byte for byte, with PIL blocked while the port decodes, irreversible (9/7,
ICT) files included: OpenJPEG's float32 arithmetic is matched, not
approximated. The committed fixtures (tests/torch_textures/make_fixtures.py's
`j2k_fixtures`: PIL's save, libopenjp2's encoder through `openjpeg`, marker
surgery, JP2 boxes, ICNS entries), files PIL writes at several sizes,
tilings and layers, random files from libopenjp2's encoder (hypothesis,
derandomised: the same pixels, or both refuse), broken and truncated files
(TextureError naming the cause, PIL failing too), HTJ2K refused by name
though PIL opens it, and read_texture and a DSL scene against the JAX
package's.
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
from torch_textures.make_fixtures import (htj2k_stub, icns_file, j2k_join, j2k_marker, j2k_split,
                                          j2k_with_main, jp2_box, jp2_file, jp2_palette, openjpeg)

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch.models.texture import TextureError, decode_texture, read_texture
from relativitypathtracer_tpu_torch.utils import pil_modes

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "torch_textures"
RECORD = json.loads((FIXTURES / "pil_rgb.json").read_text())["files"]
J2K = sorted(n for n in RECORD if n.endswith((".j2k", ".jp2")) or n in ("ic08.icns", "ic09.icns"))


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


def _picture(seed: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 7 + y * 3, x * x // 3 + y, (y * 11) ^ (x * 5)], -1) % 256
    return np.clip(base + rng.integers(-30, 30, (h, w, 3)), 0, 255).astype(np.uint8)


def _save(im, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "JPEG2000", **kw)
    return buf.getvalue()


# --- the committed fixtures -----------------------------------------------------

@pytest.mark.parametrize("name", J2K)
def test_fixture_decodes_to_pil_bytes(name):
    """Each committed JPEG 2000 file (and ICNS with JPEG 2000 entries),
    decoded with PIL blocked, equals PIL's convert("RGB") now and the hash
    PIL gave where it was made."""
    data = (FIXTURES / name).read_bytes()
    got = _port(data)
    assert not isinstance(got, Exception), got
    assert list(got.shape) == RECORD[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == RECORD[name]["sha256"]
    assert np.array_equal(got, _pil(data))


def test_the_fixtures_cover_the_kinds():
    """The fixtures hold each marker, style and box they are named for."""
    read = {n: (FIXTURES / n).read_bytes() for n in J2K}
    cod_style = {n: read[n][read[n].index(b"\xff\x52") + 12] for n in read
                 if n.startswith("style_")}
    assert cod_style == {"style_bypass.j2k": 1, "style_reset.j2k": 2, "style_termall.j2k": 4,
                         "style_vsc.j2k": 8, "style_pterm.j2k": 16, "style_segsym.j2k": 32}
    for name, marker in (("ppt.j2k", b"\xff\x61"), ("ppm.j2k", b"\xff\x60"),
                         ("coc_qcc.j2k", b"\xff\x53"), ("coc_qcc.j2k", b"\xff\x5d"),
                         ("roi.j2k", b"\xff\x5e"), ("poc.j2k", b"\xff\x5f"),
                         ("crg_plm.j2k", b"\xff\x63"), ("crg_plm.j2k", b"\xff\x57"),
                         ("tlm.j2k", b"\xff\x55"), ("tlm.j2k", b"\xff\x58"),
                         ("comment_plt.j2k", b"\xff\x64"), ("comment_plt.j2k", b"\xff\x58"),
                         ("sop_eph.j2k", b"\xff\x91"), ("sop_eph.j2k", b"\xff\x92")):
        assert marker in read[name], (name, marker)
    assert read["tile_parts.j2k"].count(b"\xff\x90") > 4
    assert read["ic09.icns"].count(b"\xff\x4f\xff\x51") == 2
    for name in J2K:
        assert len(read[name]) < 4096, name


# --- files PIL writes -----------------------------------------------------------

@pytest.mark.parametrize("size", [(1, 1), (2, 3), (7, 5), (33, 17), (64, 48)])
@pytest.mark.parametrize("irreversible", [False, True])
def test_pil_written_files_at_sizes(size, irreversible):
    w, h = size
    im = Image.fromarray(_picture(w * 100 + h, h, w))
    _agree(_save(im, irreversible=irreversible, mct=1 if min(size) > 1 else 0))


@pytest.mark.parametrize("kw", [
    {"tile_size": (16, 16)}, {"tile_size": (20, 12), "tile_offset": (3, 5), "offset": (7, 9)},
    {"quality_layers": [40, 10, 2]}, {"quality_layers": [60, 20], "irreversible": True},
    {"num_resolutions": 1}, {"num_resolutions": 5, "irreversible": True},
    {"codeblock_size": (4, 4)}, {"codeblock_size": (64, 16), "precinct_size": (32, 16)},
    {"progression": "RPCL", "tile_size": (24, 24), "offset": (5, 0)},
    {"progression": "CPRL", "precinct_size": (16, 16), "quality_layers": [20, 4]},
    {"progression": "PCRL", "irreversible": True, "mct": 1}, {"no_jp2": True, "plt": True}],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()).replace(" ", ""))
def test_pil_written_files_by_tiling_and_layers(kw):
    _agree(_save(Image.fromarray(_picture(5, 45, 52)), **kw))


@pytest.mark.parametrize("mode", ["L", "LA", "RGBA", "I;16"])
def test_pil_written_modes(mode):
    pic = _picture(6, 19, 23)
    im = (Image.fromarray((pic[..., 0].astype(np.uint16) * 9)) if mode == "I;16" else
          Image.fromarray(np.concatenate([pic, pic[..., :1]], -1), "RGBA").convert(mode))
    _agree(_save(im))
    _agree(_save(im, no_jp2=True, irreversible=True))


# --- random files from libopenjp2's encoder ---------------------------------------------

def _planes(rng, n, h, w, bits):
    y, x = np.mgrid[0:h, 0:w]
    return [(x * rng.integers(0, 9) + y * rng.integers(0, 9)
             + rng.integers(0, 1 << max(1, bits - 2), (h, w))) % (1 << bits) for _ in range(n)]


@settings(max_examples=80, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31), n=st.sampled_from([1, 3, 3, 4]),
       w=st.integers(16, 40), h=st.integers(16, 40), res=st.integers(1, 4),
       mode=st.sampled_from([0, 0, 1, 8, 32, 63]), layers=st.integers(1, 3),
       order=st.integers(0, 4))
def test_random_irreversible_files(seed, n, w, h, res, mode, layers, order):
    """9/7 files with the ICT where there are three components or more:
    OpenJPEG's float32 steps matched to the bit."""
    rng = np.random.default_rng(seed)
    rates = sorted(rng.choice([0, 4, 10, 30], layers).tolist())[::-1]
    data = openjpeg(_planes(rng, n, h, w, 8), irreversible=1, numresolution=res, mode=mode,
                    rates=rates, prog_order=order, mct=n >= 3)
    _agree(data)


@settings(max_examples=100, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31), n=st.sampled_from([1, 2, 3, 4]), w=st.integers(2, 40),
       h=st.integers(2, 40), res=st.integers(1, 4), mode=st.integers(0, 63),
       bits=st.sampled_from([1, 5, 8, 12, 16]), signed=st.booleans(),
       csty=st.sampled_from([0, 2, 6]), order=st.integers(0, 4), tiles=st.booleans(),
       offset=st.tuples(st.integers(0, 7), st.integers(0, 7)))
def test_random_reversible_files(seed, n, w, h, res, mode, bits, signed, csty, order, tiles,
                                 offset):
    """5/3 files over precisions, signedness, code-block styles, SOP/EPH,
    progressions, tiles and image offsets."""
    rng = np.random.default_rng(seed)
    planes = _planes(rng, n, h, w, bits)
    if signed:
        planes = [p - (1 << (bits - 1)) for p in planes]
    opts = {"tiles": ((int(rng.integers(8, 24)), int(rng.integers(8, 24))),
                      (int(rng.integers(0, offset[0] + 1)), int(rng.integers(0, offset[1] + 1))))
            } if tiles else {}
    try:
        data = openjpeg(planes, prec=bits, sgnd=signed, offset=offset, numresolution=res,
                        mode=mode, csty=csty, prog_order=order, rates=[8, 0], mct=n >= 3, **opts)
    except RuntimeError:  # the encoder's limits (too many resolutions for a tile)
        return
    _agree(data)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31), dx=st.sampled_from([(1, 2, 2), (1, 2, 1), (2, 1, 1),
                                                        (1, 1, 3), (3, 3, 3)]),
       dy=st.sampled_from([(1, 2, 2), (1, 1, 2), (2, 2, 1)]), w=st.integers(3, 30),
       h=st.integers(3, 30), offset=st.tuples(st.integers(0, 5), st.integers(0, 5)),
       jp2=st.sampled_from([None, 16, 18]), tiles=st.booleans())
def test_random_subsampled_files(seed, dx, dy, w, h, offset, jp2, tiles):
    """Subsampled components: PIL's YCbCr guess (chroma subsampled, no
    colour space given), its stride (the tile's width over the factor,
    rounded down) and the zeros it reads past a tile's data."""
    rng = np.random.default_rng(seed)
    planes = [rng.integers(0, 256, (-(-(h + offset[1]) // dy[k]) + (-offset[1] // dy[k]),
                                    -(-(w + offset[0]) // dx[k]) + (-offset[0] // dx[k])))
              for k in range(3)]
    opts = {"tiles": ((9, 7), (offset[0] // 2, offset[1] // 2))} if tiles else {}
    try:
        data = openjpeg(planes, dx=list(dx), dy=list(dy), offset=offset, numresolution=2, **opts)
    except RuntimeError:
        return
    if jp2 is not None:
        siz = struct.unpack_from(">H8I", data, 6)
        data = jp2_file(data, siz[1] - siz[3], siz[2] - siz[4], 3, colr=jp2)
    _agree(data)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(name=st.sampled_from([n for n in J2K if not n.endswith(".icns")]),
       edits=st.lists(st.tuples(st.floats(0, 1), st.integers(0, 255)), min_size=1,
                      max_size=2), header=st.booleans())
def test_mutated_files_agree(name, edits, header):
    """Committed files with a byte or two changed, in the headers or
    anywhere: OpenJPEG's checks (marker places, Scod, MCT, QCD lengths,
    tile-part indices and counts, PLT, PPM runs, the tile count, unknown
    markers), its tile decode order and its resno_decoded, matched: the
    same pixels, or both refuse."""
    data = bytearray((FIXTURES / name).read_bytes())
    for at, value in edits:
        data[int(at * (min(len(data), 200) if header else len(data) - 1))] = value
    _agree(bytes(data))


def test_ycbcr_to_rgb_is_pils_on_every_input():
    """PIL's YCbCr to RGB (sYCC files, the subsampled guess) on all 2**24
    inputs."""
    i = np.arange(256, dtype=np.uint8)
    ycc = np.stack(np.meshgrid(i, i, i, indexing="ij"), -1).reshape(4096, 4096, 3)
    want = np.asarray(Image.frombytes("YCbCr", (4096, 4096), ycc.tobytes()).convert("RGB"))
    assert np.array_equal(pil_modes.ycbcr_to_rgb(ycc), want)


# --- PIL's quirks, pinned ----------------------------------------------------------

def _cs(n=3, seed=1, h=12, w=14):
    rng = np.random.default_rng(seed)
    return openjpeg([rng.integers(0, 256, (h, w)) for _ in range(n)], numresolution=2)


def test_palette_colours_are_kept_once():
    """PIL's ImagePalette keeps a colour once: an index after a repeated
    entry reads the next distinct colour, and past the palette black."""
    index = openjpeg([np.array([[0, 1, 2, 3, 4, 5, 6]] * 2)], numresolution=1)
    entries = [(10, 20, 30), (40, 50, 60), (10, 20, 30), (70, 80, 90), (1, 2, 3)]
    data = jp2_file(index, 7, 2, 1, colr=16, extra=jp2_palette(entries))
    got = _port(data)
    assert got[0, :, 0].tolist() == [10, 40, 70, 1, 0, 0, 0]
    assert np.array_equal(got, _pil(data))


@pytest.mark.parametrize("colr", [None, 16, 17, 18, 12, 20, 24, bytes([2, 0, 0]) + bytes(40),
                                  bytes([3, 0, 0]) + bytes(4)],
                         ids=["default", "srgb", "grey", "sycc", "cmyk", "enum20", "eycc", "icc",
                              "method3"])
@pytest.mark.parametrize("n", [1, 3, 4])
def test_colour_spaces_choose_pils_unpacker(colr, n):
    """The colr box's colour space and the component count pick PIL's
    unpacker, or none (PIL fails: grey with three components, eYCC...)."""
    _agree(jp2_file(_cs(n), 14, 12, n, colr=colr))


@pytest.mark.parametrize("size", [(14, 12), (15, 12), (14, 13), (13, 12)])
def test_jp2_header_size_must_be_the_codestreams(size):
    """PIL fails where ihdr's size is not the codestream's."""
    _agree(jp2_file(_cs(), size[0], size[1], 3))


def test_cdef_and_a_second_colr_change_nothing():
    """PIL decodes tile by tile, where OpenJPEG applies no cdef; the first
    colr box counts."""
    base = _port(jp2_file(_cs(), 14, 12, 3))
    cdef = jp2_box(b"cdef", struct.pack(">H", 3) + b"".join(struct.pack(">3H", i, 0, 2 - i)
                                                            for i in range(3)))
    for data in (jp2_file(_cs(), 14, 12, 3, extra=cdef),
                 jp2_file(_cs(), 14, 12, 3, extra=jp2_box(b"colr", struct.pack(">BBBI", 1, 0, 0,
                                                                               18)))):
        assert np.array_equal(_port(data), base)
        _agree(data)


def test_tile_part_headers_override_the_main_header():
    """The POC libopenjp2 writes in the first tile's header moved to the
    main header (so every tile takes it); a tile's own QCD (other
    mantissas), RGN and COC (another code-block style bit, PTERM): each
    tile read with its own parameters, as OpenJPEG reads them."""
    rng = np.random.default_rng(7)
    data = openjpeg([rng.integers(0, 256, (24, 30)) for _ in range(3)], irreversible=1,
                    numresolution=2, rates=[8, 3, 1], tiles=((16, 16), (0, 0)), mct=True,
                    pocs=[(0, 0, 1, 2, 3, 2), (0, 0, 3, 2, 3, 0)])
    main, parts = j2k_split(data)
    poc = next(m for m in parts[0][1] if m[:2] == b"\xff\x5f")
    qcd = next(m for m in main if m[:2] == b"\xff\x5c")
    cod = next(m for m in main if m[:2] == b"\xff\x52")
    steps = bytearray(qcd[5:])
    steps[1::2] = bytes((b + 91) & 0xFF for b in steps[1::2])
    tile_qcd = j2k_marker(0xFF5C, bytes([qcd[4]]) + bytes(steps))
    tile_coc = j2k_marker(0xFF53, bytes([2, 0]) + cod[9:12] + bytes([cod[12] ^ 16]) + cod[13:])
    rgn = j2k_marker(0xFF5E, bytes([1, 0, 3]))
    parts = [(sot, [h for h in headers if h[:2] != b"\xff\x5f"]
              + ([tile_qcd, rgn] if i == 1 else []) + ([tile_coc] if i == 2 else []), body)
             for i, (sot, headers, body) in enumerate(parts)]
    moved = j2k_join(main + [poc], parts)
    assert not isinstance(_port(moved), Exception)
    _agree(moved)


@pytest.mark.parametrize("irreversible", [1, 0])
@pytest.mark.parametrize("comp", [0, 1, 2])
def test_mct_over_mixed_transforms(irreversible, comp):
    """A COC that gives one of the MCT's components the other transform:
    OpenJPEG runs the first component's MCT over the bits each keeps
    (integers read as floats, floats as integers), NaN and all."""
    rng = np.random.default_rng(comp)
    data = openjpeg([rng.integers(0, 256, (14, 17)) for _ in range(3)],
                    irreversible=irreversible, numresolution=2, rates=[3], mct=True)
    at = data.index(b"\xff\x52")
    spcod = data[at + 9:at + 14]
    coc = j2k_marker(0xFF53, bytes([comp, 0]) + spcod[:4] + bytes([1 - spcod[4]]))
    _agree(j2k_with_main(data, coc))


def test_eph_is_required_and_sop_is_not():
    """OpenJPEG 2.5.4 fails on a packet header without the EPH marker COD
    promises, and reads on without SOP."""
    rng = np.random.default_rng(2)
    data = openjpeg([rng.integers(0, 256, (16, 16))], numresolution=2, csty=6)
    at, eph = data.index(b"\xff\x90"), data.index(b"\xff\x92")
    psot = struct.unpack_from(">I", data, at + 6)[0]
    no_eph = data[:at + 6] + struct.pack(">I", psot - 2) + data[at + 10:eph] + data[eph + 2:]
    sop = data.index(b"\xff\x91")
    no_sop = data[:at + 6] + struct.pack(">I", psot - 6) + data[at + 10:sop] + data[sop + 6:]
    _agree(no_sop)
    assert not isinstance(_port(no_sop), Exception)
    assert isinstance(_pil_outcome(no_eph), Exception)
    got = _port(no_eph)
    assert isinstance(got, Exception) and "EPH" in str(got)


def test_htj2k_is_refused_by_name_though_pil_opens_it():
    """HTJ2K (Part 15) is left out: no encoder here writes its code-blocks.
    PIL decodes this stub (an empty packet) to grey; the port names it."""
    data = htj2k_stub()
    assert _pil(data).shape == (16, 16, 3)
    got = _port(data)
    assert isinstance(got, Exception) and "HTJ2K" in str(got), got


# --- broken and truncated files ---------------------------------------------------

def _broken():
    rgb = (FIXTURES / "layers_irrev.j2k").read_bytes()
    jp2 = (FIXTURES / "rgba_irrev.jp2").read_bytes()
    tiles = (FIXTURES / "offsets.j2k").read_bytes()
    cs = _cs()
    sig, ftyp = jp2_box(b"jP  ", b"\r\n\x87\n"), jp2_box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
    hdr = jp2_box(b"jp2h", jp2_box(b"ihdr", struct.pack(">IIHBBBB", 12, 14, 3, 7, 7, 0, 0))
                  + jp2_box(b"colr", struct.pack(">BBBI", 1, 0, 0, 16)))
    cases = {
        "no_eoc": (rgb[:-2], "without EOC"),
        "cut_in_packets": (rgb[:len(rgb) // 2], "truncated"),
        "cut_in_header": (rgb[:60], None),
        "cut_tiles": (tiles[:len(tiles) - 300], "truncated"),
        "jp2_cut": (jp2[:len(jp2) - 40], None),
        "jp2_no_ftyp": (sig + hdr + jp2_box(b"jp2c", cs), "file type"),
        "jp2_codestream_first": (sig + ftyp + jp2_box(b"jp2c", cs) + hdr, "codestream box"),
        "jp2_no_ihdr": (sig + ftyp + jp2_box(b"jp2h", jp2_box(b"colr", bytes(7)))
                        + jp2_box(b"jp2c", cs), None),
        "jp2_short_ihdr": (sig + ftyp + jp2_box(b"jp2h", jp2_box(b"ihdr", bytes(13)))
                           + jp2_box(b"jp2c", cs), "header"),
        "jp2_empty_cdef": (jp2_file(cs, 14, 12, 3, extra=jp2_box(b"cdef", b"\0\0")), "cdef"),
        "jp2_palette_of_300": (jp2_file(
            openjpeg([np.arange(120).reshape(10, 12) % 300], prec=9, numresolution=1), 12, 10, 1,
            colr=16, extra=jp2_palette([(i % 256, i // 2, 7) for i in range(300)])),
            "256 colours"),
        "five_components": (_cs(5), "5 components"),
        "grey_on_three": (jp2_file(cs, 14, 12, 3, colr=17), "no unpacker"),
        "eycc": (jp2_file(cs, 14, 12, 3, colr=24), "eYCC"),
        "bad_siz": (cs[:4] + b"\x00\x10" + cs[6:], None),
        "part2_marker": (j2k_with_main(cs, j2k_marker(0xFF74, bytes(6))), "Part 2"),
    }
    cases["huge"] = (cs[:8] + struct.pack(">II", 20000, 10000) + cs[16:],
                     "more pixels than 178,956,970")
    main_end = cs.index(b"\xff\x90")
    cases["zero_tile_data"] = (cs[:main_end] + j2k_marker(0xFF90, struct.pack(">HIBB", 0, 14, 0, 1))
                               + b"\xff\x93\xff\xd9", "without data")
    return cases


BROKEN = _broken()


@pytest.mark.parametrize("kind", sorted(BROKEN))
def test_broken_files_raise_texture_error(tmp_path, kind, monkeypatch):
    """Each raises TextureError naming the file, JPEG 2000 and the cause
    (words None: any cause), with PIL blocked, the atlas untouched."""
    data, words = BROKEN[kind]
    path = tmp_path / "t.j2k"
    path.write_bytes(data)
    monkeypatch.setitem(sys.modules, "PIL", None)
    atlas, values = bytearray(b"keep"), []
    with pytest.raises(TextureError) as err:
        read_texture(str(path), atlas, values)
    assert str(path) in str(err.value) and "JPEG 2000" in str(err.value), str(err.value)
    assert (words or "") in str(err.value), str(err.value)
    assert atlas == b"keep" and values == []


@pytest.mark.parametrize("kind", sorted(BROKEN))
def test_pil_fails_on_the_broken_files(tmp_path, kind):
    """PIL fails on each too, opened from a path as the JAX package opens
    files."""
    path = tmp_path / "t.j2k"
    path.write_bytes(BROKEN[kind][0])
    with pytest.raises(Image.DecompressionBombError if kind == "huge" else Exception):
        with Image.open(path) as im:
            im.convert("RGB")


@pytest.mark.parametrize("cut", [0.97, 0.8, 0.5, 0.2])
def test_truncated_files_fail_in_both(cut):
    """Streams cut anywhere fail in PIL (no EOC after its last tile) and in
    the port; JP2 and tiled files alike."""
    for name in ("layers_irrev.j2k", "offsets.j2k", "blob_irrev.jp2", "ppm.j2k", "ppt.j2k"):
        data = (FIXTURES / name).read_bytes()
        _agree(data[:int(len(data) * cut)])


def test_icns_entries_are_the_resource_alone():
    """PIL opens an ICNS JPEG 2000 resource from its own bytes: one whose
    codestream runs past the resource fails in both."""
    data = _save(Image.fromarray(_picture(3, 16, 16)), no_jp2=True)
    good = icns_file([(b"icp4", data)])
    _agree(good)
    assert not isinstance(_port(good), Exception)
    cut = icns_file([(b"icp4", data[:-10])]) + data[-10:]
    _agree(cut)


# --- read_texture, scenes, and the JAX package --------------------------------------------

SCENE_FIXTURES = ("blob_irrev.jp2", "cubes_lossless.j2k", "sycc.jp2", "palette.jp2",
                  "ic08.icns", "u8.fits", "f32.fits", "gzip16.fits")


def test_read_texture_without_pil_matches_the_jax_package(monkeypatch):
    """read_texture of JPEG 2000 and FITS files, with PIL blocked, gives the
    JAX package's read_texture's atlas bytes and (offset, w, h) values."""
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


def test_scene_with_jpeg2000_and_fits_textures_matches_jax(tmp_path):
    """A DSL scene with JPEG 2000 (J2K, JP2) and FITS textures, each shared
    by two objects, through the JAX package's build_scene (PIL) and the
    port's: every texture array exact, and the JAX scene carried over by
    scene_from_numpy equal to the port's own build."""
    import jax

    from relativitypathtracer_tpu import build_scene as jbuild
    from relativitypathtracer_tpu.models.dsl import parse_scene as jparse

    names = ("blob_irrev.jp2", "cubes_lossless.j2k", "u8.fits", "i16.fits")
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
