"""AVIF at 10 and 12 bits, premultiplied alpha and libavif's own colour
conversions (utils/avif_decode, av1_block, av1_recon, av1_loopfilter,
av1_cdef, av1_restoration, av1_filmgrain, av1_palette, av1_intrabc,
av1_tables) against PIL 12.1.0 (libavif 1.3.0, dav1d 1.5.1, libyuv 1909).

Tolerance 0. The fixtures themselves (`make_fixtures.avif_depths_and_alpha`)
are held to PIL by test_torch_texture_avif.py's fixture test; here: the
10- and 12-bit dequantisers against the library they were packed from;
`high_bitdepth_edit` keeping every other header field; the conversion of
random planes at every depth, subsampling, range, matrix, alpha and
premultiplication against libavif's own avifImageYUVToRGB, and the
un-premultiply on every (colour, alpha) pair against its
avifRGBImageUnpremultiplyAlpha and the limited-range alpha against its
avifLimitedToFullY (all called through ctypes in Pillow's bundled
libavif, skipped where it is absent); edits PIL refuses refused
too; and the tools the depth fixtures cover.
"""

import ctypes
import io
import itertools
import json
import pathlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image
from torch_textures.make_fixtures import (SEED, _color_config, high_bitdepth_edit, nclx_edit,
                                          sequence_header_at_depth)

from relativitypathtracer_tpu_torch.models.texture import decode_texture
from relativitypathtracer_tpu_torch.utils import av1_obu, av1_tables, avif_decode

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "torch_textures"
RECORD = json.loads((FIXTURES / "pil_rgb.json").read_text())["files"]
DEPTH_FIXTURES = sorted(n for n in RECORD if n.startswith(("avif10_", "avif12_")))


def _pil(data: bytes):
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
    except Exception as e:  # noqa: BLE001 - PIL's refusal, compared below
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


def _fixture(name: str) -> bytes:
    return (FIXTURES / name).read_bytes()


# --- the dequantisers ----------------------------------------------------------------

def test_dequantisers_by_depth():
    """Dc_Qlookup and Ac_Qlookup as packed: the 8-bit rows are the typed-in
    DC_Q and AC_Q; the specification's 10- and 12-bit rows start and end
    where its tables do and rise monotonically."""
    dq = av1_tables.DEQUANT
    assert dq.shape == (3, 256, 2)
    assert list(dq[0, :, 0]) == list(av1_tables.DC_Q) and list(dq[0, :, 1]) == list(av1_tables.AC_Q)
    assert list(dq[1, :6, 0]) == [4, 9, 10, 13, 15, 17] and list(dq[2, :6, 0]) == [4, 12, 18, 25,
                                                                                 33, 41]
    assert dq[1, 255].tolist() == [5347, 7312] and dq[2, 255].tolist() == [21387, 29247]
    assert (np.diff(dq[1:], axis=1) >= 0).all()


def test_dequantisers_equal_the_library_they_came_from():
    """The 10- and 12-bit rows as av1_tables packs them equal the bytes
    tools/av1_tables_extract.py reads from Pillow's libavif (dav1d's
    dav1d_dq_tbl, each row also in aom's tables), anchors checked first."""
    sys.path.insert(0, str(REPO / "tools"))
    import av1_tables_extract as X
    lib = X.find_library()
    if lib is None:
        pytest.skip(f"no {X.LIBRARY} beside PIL")
    _, _, dq = X.extract(lib)
    assert np.array_equal(av1_tables.DEQUANT, dq.astype(np.int64))


# --- high_bitdepth_edit --------------------------------------------------------------

def _items(data: bytes) -> dict:
    """Each AV1 item's (sequence header, frame header) fields."""
    info = avif_decode._container(data)[0]
    out = {}
    for item, kind in info["items"].items():
        if kind == b"av01":
            seq, fh = av1_obu.parse_still(avif_decode._item_data(data, info, item))
            out[item] = (vars(seq), {k: v for k, v in vars(fh).items() if k != "tools"})
    return out


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("name", ["blob.avif", "avif_444.avif", "avif_422.avif", "avif_400.avif",
                                  "avif_rgba.avif", "avif_grain444.avif", "avif_matrix0.avif",
                                  "avif_q100.avif"])
def test_high_bitdepth_edit_keeps_every_other_field(name, depth):
    """The edit changes the bit depth, the profile the subsampling needs
    and where color_config() ends, and nothing else: every other field of
    each item's sequence header and frame header (the tiles' bytes among
    them) parses as before, av1C's flags and pixi say `depth`, and an edit
    to 8 bits gives the file back byte for byte."""
    data = _fixture(name)
    assert high_bitdepth_edit(data, 8) == data
    edited = high_bitdepth_edit(data, depth)
    before, after = _items(data), _items(edited)
    assert before.keys() == after.keys()
    for item, (seq, fh) in before.items():
        seq2, fh2 = after[item]
        assert fh2 == fh
        assert seq2["bit_depth"] == depth
        assert seq2["profile"] == _color_config(SimpleNamespace(**seq), depth)[0]
        keep = set(seq) - {"bit_depth", "profile", "color_config_bits"}
        assert {k: seq2[k] for k in keep} == {k: seq[k] for k in keep}
    info = avif_decode._container(edited)[0]
    for item in before:
        props = avif_decode._props(edited, info, item)
        assert avif_decode._check_depth(edited, props) == depth


def test_sequence_header_at_depth_sets_the_profile_bits():
    """4:2:0 and grey stay in profile 0 at 10 bits, 4:4:4 in profile 1,
    4:2:2 in profile 2; at 12 bits all go to profile 2 with twelve_bit."""
    for name, want in (("blob.avif", (0, 2)), ("avif_400.avif", (0, 2)),
                       ("avif_444.avif", (1, 2)), ("avif_422.avif", (2, 2))):
        payload = avif_decode._container(_fixture(name))[3]
        header = next(p for t, _, _, p in av1_obu.obus(payload)
                      if t == av1_obu.OBU_SEQUENCE_HEADER)
        for depth, profile in zip((10, 12), want):
            seq = av1_obu.sequence_header(sequence_header_at_depth(header, depth))
            assert (seq.profile, seq.bit_depth) == (profile, depth), name


# --- libavif's conversions through ctypes ----------------------------------------------

class _Libavif:
    """Pillow's bundled libavif: avifImageYUVToRGB as Pillow's decoder calls
    it (8-bit RGB, or RGBA where the image has alpha) and
    avifRGBImageUnpremultiplyAlpha (libavif 1.3.0's struct offsets)."""

    FORMATS = {"444": 1, "422": 2, "420": 3, "400": 4}

    def __init__(self, path):
        lib = self.lib = ctypes.CDLL(str(path))
        lib.avifImageCreate.restype = ctypes.c_void_p
        lib.avifImageCreate.argtypes = [ctypes.c_uint32] * 3 + [ctypes.c_int]
        lib.avifImagePlane.restype = ctypes.c_void_p
        lib.avifImagePlaneRowBytes.restype = ctypes.c_uint32
        for f in ("avifImageAllocatePlanes", "avifImagePlane", "avifImagePlaneRowBytes"):
            getattr(lib, f).argtypes = [ctypes.c_void_p, ctypes.c_int]
        for f in ("avifImageDestroy", "avifRGBImageAllocatePixels", "avifRGBImageFreePixels",
                  "avifRGBImageUnpremultiplyAlpha"):
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        for f in ("avifRGBImageSetDefaults", "avifImageYUVToRGB"):
            getattr(lib, f).argtypes = [ctypes.c_void_p, ctypes.c_void_p]

    @staticmethod
    def _u32(addr, off):
        return ctypes.c_uint32.from_address(addr + off)

    def _rgb(self, img, rgba: bool):
        buf = (ctypes.c_uint8 * 128)()
        addr = ctypes.addressof(buf)
        self.lib.avifRGBImageSetDefaults(addr, img)
        self._u32(addr, 8).value = 8  # depth
        self._u32(addr, 12).value = int(rgba)  # AVIF_RGB_FORMAT_RGB or RGBA
        assert self.lib.avifRGBImageAllocatePixels(addr) == 0
        return buf, addr

    def _read(self, addr, h, w, ch):
        pixels = ctypes.c_void_p.from_address(addr + 48).value
        row = self._u32(addr, 56).value
        raw = bytes((ctypes.c_uint8 * (row * h)).from_address(pixels))
        return np.frombuffer(raw, np.uint8).reshape(h, row)[:, :w * ch].reshape(h, w, ch)

    def yuv_to_rgb(self, planes, depth, fmt, full, mc, cp, alpha=None, prem=False):
        h, w = planes[0].shape
        img = self.lib.avifImageCreate(w, h, depth, self.FORMATS[fmt])
        try:
            self._u32(img, 16).value = full  # yuvRange
            ctypes.c_uint16.from_address(img + 104).value = cp
            ctypes.c_uint16.from_address(img + 108).value = mc
            assert self.lib.avifImageAllocatePlanes(img, 1 | (2 if alpha is not None else 0)) == 0
            chans = [(0, planes[0])] + ([] if fmt == "400" else [(1, planes[1]), (2, planes[2])])
            if alpha is not None:
                chans.append((3, alpha))
                self._u32(img, 80).value = int(prem)  # alphaPremultiplied
            for ch, a in chans:
                a = np.ascontiguousarray(a.astype(np.uint8 if depth == 8 else np.uint16))
                at, row = self.lib.avifImagePlane(img, ch), self.lib.avifImagePlaneRowBytes(img, ch)
                for r in range(a.shape[0]):
                    ctypes.memmove(at + r * row, a[r].ctypes.data, a.shape[1] * a.itemsize)
            buf, addr = self._rgb(img, alpha is not None)
            try:
                if self.lib.avifImageYUVToRGB(img, addr) != 0:
                    return None
                return self._read(addr, h, w, 4 if alpha is not None else 3)[..., :3].copy()
            finally:
                self.lib.avifRGBImageFreePixels(addr)
        finally:
            self.lib.avifImageDestroy(img)

    def unpremultiply(self, rgba: np.ndarray) -> np.ndarray:
        h, w, _ = rgba.shape
        img = self.lib.avifImageCreate(w, h, 8, 1)
        buf, addr = self._rgb(img, True)
        try:
            pixels = ctypes.c_void_p.from_address(addr + 48).value
            row = self._u32(addr, 56).value
            src = np.ascontiguousarray(rgba.astype(np.uint8))
            for r in range(h):
                ctypes.memmove(pixels + r * row, src[r].ctypes.data, w * 4)
            assert self.lib.avifRGBImageUnpremultiplyAlpha(addr) == 0
            return self._read(addr, h, w, 4).copy()
        finally:
            self.lib.avifRGBImageFreePixels(addr)
            self.lib.avifImageDestroy(img)


@pytest.fixture(scope="module")
def libavif():
    sys.path.insert(0, str(REPO / "tools"))
    import av1_tables_extract as X
    path = X.find_library()
    if path is None:
        pytest.skip(f"no {X.LIBRARY} beside PIL")
    return _Libavif(path)


MATRICES = [(mc, 2) for mc in (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 13)] + [
    (12, cp) for cp in (1, 2, 4, 5, 9, 11, 22, 3)]


@pytest.mark.parametrize("fmt", ["400", "420", "422", "444"])
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_conversion_equals_libavif(libavif, depth, fmt):
    """Random planes of odd and even sizes at `depth` bits in `fmt`, in
    limited and full range, under every matrix avif_decode converts or
    refuses (chromaticity-derived under primaries libyuv has and libavif
    derives), without alpha, with alpha, and premultiplied: the port's
    yuv_to_rgb equals libavif's 8-bit RGB (RGBA where there is alpha, its
    colour kept by convert("RGB")), and fails where libavif fails."""
    rng = np.random.default_rng(depth * 10 + len(fmt) + int(fmt[1]))
    ssx, ssy = {"400": (1, 1), "420": (1, 1), "422": (1, 0), "444": (0, 0)}[fmt]
    seq = SimpleNamespace(mono=int(fmt == "400"), ssx=ssx, ssy=ssy)
    top = (1 << depth) - 1
    cases = 0
    for full, (mc, cp), alpha, prem in itertools.product((0, 1), MATRICES, (0, 1), (0, 1)):
        if prem and not alpha:
            continue
        w, h = int(rng.integers(1, 19)), int(rng.integers(1, 13))
        cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
        y = rng.integers(0, top + 1, (h, w))
        u, v = rng.integers(0, top + 1, (ch, cw)), rng.integers(0, top + 1, (ch, cw))
        a = rng.integers(0, top + 1, (h, w)) if alpha else None
        want = libavif.yuv_to_rgb([y, u, v], depth, fmt, full, mc, cp, a, bool(prem))
        try:
            got = avif_decode.yuv_to_rgb([y, u, v], w, h, seq, depth, mc, cp, full, a, bool(prem))
        except ValueError as e:
            got = e
        if want is None:
            assert isinstance(got, avif_decode.DecodeError), (full, mc, cp, alpha, prem, got)
        else:
            assert not isinstance(got, Exception), (full, mc, cp, alpha, prem, got)
            assert np.array_equal(got, want), (full, mc, cp, alpha, prem)
        cases += 1
    assert cases == 2 * len(MATRICES) * 3


def test_unpremultiply_on_the_exhaustive_grid(libavif):
    """Every (colour, alpha) pair of 8 bits through libavif's
    avifRGBImageUnpremultiplyAlpha (libyuv's ARGBUnattenuate) equals
    avif_decode.unattenuate; a few worked by hand: colour 1 at alpha 2 is
    128, 2 at 3 is 171 (the reciprocal's rounding), alpha 255 keeps the
    colour, alpha 0 gives 0, and alpha 1 under colour 128 and up packs to
    0 (its 16-bit sum past 32767)."""
    c, a = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    grid = np.stack([c, 255 - c, c, a], -1)
    want = libavif.unpremultiply(grid)
    assert (want[..., 3] == a).all()
    got = avif_decode.unattenuate(grid[..., :3], a)
    assert np.array_equal(got, want[..., :3])
    assert [int(avif_decode.unattenuate(np.array([[cc] * 3]), np.array([aa]))[0, 0])
            for cc, aa in ((1, 2), (2, 3), (77, 255), (90, 0), (127, 1), (128, 1))] == [
        128, 171, 77, 0, 255, 0]


def test_limited_range_alpha_widens_as_libavif_does(libavif):
    """An alpha item coded in limited range: libavif's avifLimitedToFullY
    at 8, 10 and 12 bits on every sample value equals the port's
    limited_to_full (rounded half up, divided toward zero, clamped)."""
    fn = libavif.lib.avifLimitedToFullY
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_uint32, ctypes.c_int]
    for depth in (8, 10, 12):
        v = np.arange(1 << depth)
        want = np.array([fn(depth, int(x)) for x in v])
        assert np.array_equal(avif_decode.limited_to_full(v, depth), want), depth


def test_premultiplied_grid_fixture_equals_pil():
    """PIL's own encode of the (colour, alpha) grid with
    alpha_premultiplied=True at quality 100 (lossless): the port's decode,
    the alpha item filtered and divided by, equals PIL's."""
    data = _fixture("avif_prem_grid.avif")
    info, props, size, payload, alpha = avif_decode._container(data)
    assert size == (256, 256) and alpha is not None and alpha[1]
    got = _port(data)
    assert not isinstance(got, Exception), got
    assert np.array_equal(got, _pil(data))


# --- edits PIL refuses ----------------------------------------------------------------

@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("name", ["avif_squares.avif", "avif_squares_444.avif",
                                  "avif_squares_edge.avif", "cubes_screen.avif"])
def test_screen_content_edits_pil_refuses_are_refused(name, depth):
    """The edit reads palette literals and intra block copies under other
    semantics; where PIL's decode of such a stream fails, the port's fails
    too (a desynchronised tile reads past its end or copies from the
    current superblock)."""
    data = high_bitdepth_edit(_fixture(name), depth)
    assert isinstance(_pil(data), Exception)
    assert isinstance(_port(data), ValueError)


@pytest.mark.parametrize("depth", [10, 12])
def test_vertical_partition_in_422_is_refused_as_dav1d_refuses(depth):
    """4:2:2 has no chroma block taller than wide, so a vertical partition
    (V, V4, VERT_A, VERT_B) there is refused by dav1d; flat 4:2:2 squares
    at quality 50, edited to `depth` bits, read one from a desynchronised
    palette (the census's squares): PIL fails and the port names the
    partition."""
    rgb = (np.add.outer(np.arange(64) // 8 * 3, np.arange(64) // 8 * 5) % 6)
    colours = np.random.default_rng(SEED).integers(30, 225, (6, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(colours[rgb]).save(buf, "AVIF", quality=50, speed=6, subsampling="4:2:2",
                                       range="limited")
    data = high_bitdepth_edit(buf.getvalue(), depth)
    assert isinstance(_pil(data), Exception)
    got = _port(data)
    assert isinstance(got, ValueError) and "a vertical partition in 4:2:2" in str(got), got


@pytest.mark.parametrize("depth", [10, 12])
def test_alpha_of_another_depth_fails_as_in_pil(depth):
    """A colour item edited to `depth` bits beside an 8-bit alpha item:
    libavif's alpha decode fails, and so does the port's, by name."""
    data = high_bitdepth_edit(_fixture("avif_prem420_q75.avif"), depth, alpha=False)
    assert isinstance(_pil(data), Exception)
    got = _port(data)
    assert isinstance(got, ValueError) and "bit depth" in str(got), got


@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("edit", ["ycgco_limited", "identity_420"])
def test_conversions_libavif_refuses_fail_as_in_pil(edit, depth):
    """YCgCo in limited range and the identity matrix on 4:2:0: libavif's
    conversion fails, and so does the port's."""
    data = _fixture("avif_limited.avif")
    data = nclx_edit(data, matrix=8, full=0) if edit == "ycgco_limited" else nclx_edit(data,
                                                                                     matrix=0)
    if depth != 8:
        data = high_bitdepth_edit(data, depth)
    assert isinstance(_pil(data), Exception)
    assert isinstance(_port(data), ValueError)


# --- what the depth fixtures cover ---------------------------------------------------------

def test_depth_fixtures_cover_the_tools():
    """At 10 and at 12 bits the fixtures take every subsampling, palette
    (chroma palette too), CDEF, Wiener and self-guided units, film grain
    at every AR lag with chroma scaling from luma and the restricted range,
    quantiser matrices and lossless blocks; at 12 bits intra block copy."""
    want = ({("subsampling", s) for s in ("4:2:0", "4:2:2", "4:4:4", "4:0:0")}
            | {"palette", "chroma palette", "CDEF", "quantizer matrices", "lossless",
               ("restored unit", "Wiener"), ("restored unit", "self-guided"),
               ("film grain", "chroma scaling from luma"), ("film grain", "restricted range")}
            | {("film grain ar lag", lag) for lag in range(4)})
    for depth in (10, 12):
        tools = set()
        for name in DEPTH_FIXTURES:
            if name.startswith(f"avif{depth}_"):
                data = _fixture(name)
                assert av1_obu.parse_still(avif_decode._container(data)[3])[0].bit_depth == depth
                tools |= avif_decode.census(data)
        assert want <= tools, (depth, want - tools)
        assert depth == 10 or "intrabc" in tools
    assert len(DEPTH_FIXTURES) >= 110
