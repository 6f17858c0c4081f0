"""The port's AVIF decoder (utils/avif_decode, av1_obu, av1_entropy,
av1_block, av1_recon, av1_palette, av1_intrabc, av1_loopfilter, av1_cdef,
av1_restoration, av1_filmgrain, av1_tables) against PIL, the JAX package's
decoder.

Tolerance 0: every decode equals `np.asarray(Image.open(f).convert("RGB"))`
byte for byte, with PIL blocked while the port decodes. The committed
fixtures (tests/torch_textures/make_fixtures.py's `avif_fixtures`) against
PIL now and against the hash PIL gave where they were made; the census
(every tool a speed-6 encode of a photograph turns on occurs in a
fixture the port decodes); each tool left for later refused by name, on a
hand-edited header, and the tools once left for later (premultiplied
alpha, more than 8 bits, libavif's own colour conversions) equal to PIL on
such headers; film grain's random numbers, scaling functions and
templates against a line-by-line transcription of the specification's
pseudo-code, and the packed tables against the library they were taken
from; cuts and byte edits of five fixtures against PIL's outcome in a
fresh process (equal, or both refuse); PIL's accept (heic and MP4 brands
are no AVIF); a DSL scene with AVIF textures built to the JAX package's
texture arrays.
"""

import hashlib
import io
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from torch_textures.make_fixtures import AVIF_LATER, nclx_matrix

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch.models import texture
from relativitypathtracer_tpu_torch.models.texture import TextureError, decode_texture, read_texture
from relativitypathtracer_tpu_torch.utils import avif_decode

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "torch_textures"
RECORD = json.loads((FIXTURES / "pil_rgb.json").read_text())["files"]
DECODED = sorted(n for n in RECORD if n.endswith(".avif"))
REFUSED = {}  # the committed fixtures with a tool left for later: none
# header edits of fixtures with a tool once left for later, which PIL
# decodes and the port now decodes as PIL does (a grid item without its
# tiles PIL does not decode, and the port refuses it by name)
LATER_EDITS = {"prem": "premultiplied alpha", "pixi": "more than 8 bits",
               "matrix4": "matrix coefficients 4",
               "identity_limited": "the identity matrix in limited range"}
# what the census (tools/avif_census.py) finds in speed-6 encodes of the
# photographic picture and of textured's texture, and in speed 0-3 ones
SPEED6_TOOLS = {"CFL", "angle deltas", "deblocking filter", "lossless", "tx split",
                ("subsampling", "4:2:0"), ("subsampling", "4:2:2"), ("subsampling", "4:4:4"),
                ("subsampling", "4:0:0")}
SLOWER_TOOLS = {"128x128 superblocks", "AB and 4-way partitions", "filter intra"}
# palette, intra block copy, CDEF and loop restoration (speed 0-3, screen
# content, aom's enable-cdef and a one-bit lr_uv_shift edit)
SCREEN_AND_FILTER_TOOLS = {"screen content tools", "palette", "chroma palette",
                           "palette past the frame's edge", "intrabc", "inter tx split", "CDEF",
                           ("loop restoration", "Wiener"), ("loop restoration", "self-guided"),
                           ("loop restoration", "switchable"), ("restored unit", "Wiener"),
                           ("restored unit", "self-guided"),
                           "loop restoration chroma units halved"}
# film grain (aom's test vectors, tables and estimate) and quantiser
# matrices (each level PIL was asked for, every transform size the matrix
# weights, identity and 1D types read flat)
GRAIN_AND_QM_TOOLS = ({"film grain", "quantizer matrices", ("film grain", "overlap"),
                       ("film grain", "chroma scaling from luma"),
                       ("film grain", "restricted range"), ("film grain", "no luma points"),
                       "qm flat for identity and 1D types"}
                      | {("film grain ar lag", lag) for lag in range(4)}
                      | {("qm level", v) for v in (0, 2, 4, 5, 6, 8, 12, 15)}
                      | {("qm tx size", wh) for wh in ((4, 4), (8, 8), (16, 16), (32, 32),
                                                       (64, 64), (4, 8), (8, 4), (8, 16),
                                                       (16, 8), (16, 32), (32, 16), (32, 64),
                                                       (64, 32), (4, 16), (16, 4), (8, 32),
                                                       (32, 8), (16, 64), (64, 16))})


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _pil_outcome(data: bytes):
    try:
        return _pil(data)
    except Exception as e:  # noqa: BLE001 - PIL's refusal
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


# --- the committed fixtures ---------------------------------------------------------

@pytest.mark.parametrize("name", DECODED)
def test_fixture_decodes_to_pil_bytes(name):
    """Each decoded fixture, with PIL blocked, equals PIL's convert("RGB")
    now and the hash PIL gave where it was made."""
    data = (FIXTURES / name).read_bytes()
    assert len(data) < 16384
    got = _port(data)
    assert not isinstance(got, Exception), got
    assert list(got.shape) == RECORD[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == RECORD[name]["sha256"]
    assert np.array_equal(got, _pil(data))


def test_refused_fixtures_are_the_ones_kept_out_of_the_record():
    assert sorted(REFUSED) == sorted(AVIF_LATER)
    assert not set(REFUSED) & set(RECORD)
    assert sorted(p.name for p in FIXTURES.glob("*.avif")) == sorted(DECODED + list(REFUSED))


@pytest.mark.parametrize("kind", sorted(LATER_EDITS))
def test_fixture_with_a_later_tool_is_refused_by_name(kind, tmp_path):
    """A fixture with a tool once left for later edited into its header (a
    'prem' reference in place of 'auxl', 10 bits in pixi and av1C over an
    8-bit AV1 stream, the FCC matrix, the identity matrix in limited
    range): PIL decodes it, and so does the port with PIL blocked, byte for
    byte through decode_texture, and read_texture fills the atlas with the
    JAX package's (PIL's) bytes and values."""
    from relativitypathtracer_tpu.models.texture import read_texture as jax_read
    data = _later(kind)
    want = _pil(data)
    got = _port(data)
    assert not isinstance(got, Exception), got
    assert np.array_equal(got, want)
    path = tmp_path / f"{kind}.avif"
    path.write_bytes(data)
    want_atlas, want_values = bytearray(b"x"), []
    jax_read(str(path), want_atlas, want_values)
    atlas, values = bytearray(b"x"), []
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None
    try:
        read_texture(str(path), atlas, values)
    finally:
        sys.modules["PIL"] = saved
    assert atlas == want_atlas and values == want_values


def test_census_tools_occur_in_decoded_fixtures():
    """Every tool the census finds in speed-6 encodes of photographic
    content, and the speed 0-3 tools the port decodes, occurs in at least
    one fixture the port decodes; so do all 13 luma modes, all 14 chroma
    modes (CFL among them), the seven intra transform types, palette and
    intra block copy, CDEF, each kind of loop restoration, film grain at
    each AR lag and flag, and quantiser matrices over every transform
    size."""
    tools = set()
    for name in DECODED:
        tools |= avif_decode.census((FIXTURES / name).read_bytes())
    assert SPEED6_TOOLS | SLOWER_TOOLS | SCREEN_AND_FILTER_TOOLS | {"tiles"} <= tools
    assert GRAIN_AND_QM_TOOLS <= tools, GRAIN_AND_QM_TOOLS - tools
    assert {("y mode", m) for m in range(13)} <= tools
    assert {("uv mode", m) for m in range(14)} <= tools
    assert {("tx type", t) for t in (0, 1, 2, 3, 9, 10, 11)} <= tools
    # an intrabc block's inter sets: V_ADST and the flipped ADSTs
    assert {("tx type", t) for t in (12, 14, 15)} <= tools
    assert not any(isinstance(t, tuple) and t[0] == "refused" for t in tools)


def test_fixture_loop_filter_levels():
    """PIL's default encodes run the deblocking filter in both directions;
    quality 10 runs it at level 63."""
    from relativitypathtracer_tpu_torch.utils import av1_obu
    levels = {}
    for name in ("blob.avif", "avif_picture256.avif", "avif_q10.avif"):
        data = (FIXTURES / name).read_bytes()
        info, props, size, payload, alpha = avif_decode._container(data)
        levels[name] = av1_obu.parse_still(payload)[1].lf_level
    assert all(lv[0] > 0 and lv[1] > 0 for lv in levels.values()), levels
    assert levels["avif_q10.avif"][:2] == [63, 63]


@pytest.mark.parametrize("orientation", range(2, 9))
def test_exif_orientation_is_metadata(orientation):
    """PIL reports irot/imir as an EXIF orientation and leaves the pixels
    as decoded: the port's pixels equal PIL's without a transpose."""
    data = (FIXTURES / f"avif_orient{orientation}.avif").read_bytes()
    with Image.open(io.BytesIO(data)) as im:
        assert im.getexif().get(0x0112) == orientation
        assert im.size == (20, 12)
    assert np.array_equal(_port(data), _pil(data))


# --- hand-edited headers ------------------------------------------------------------

def _edit(data: bytes, old: bytes, new: bytes, count: int = 1) -> bytes:
    assert old in data
    return data.replace(old, new, count)


def _ten_bits(data: bytes) -> bytes:
    """pixi's depths and av1C's high_bitdepth set to 10 bits (libavif's parse
    holds the two together)."""
    i = data.find(b"pixi")
    out = bytearray(data)
    n = out[i + 8]
    out[i + 9:i + 9 + n] = bytes([10] * n)
    j = data.find(b"av1C")
    out[j + 6] |= 0x40
    return bytes(out)


def _later(kind: str) -> bytes:
    """A fixture with a tool left for later edited into its header."""
    blob = (FIXTURES / "blob.avif").read_bytes()
    if kind == "grid":
        return _edit(blob, b"av01Color", b"gridColor")
    if kind == "prem":
        return _edit((FIXTURES / "avif_rgba.avif").read_bytes(), b"auxl", b"prem")
    if kind == "pixi":
        return _ten_bits(blob)
    if kind == "matrix4":
        return (FIXTURES / "avif_matrix1.avif").read_bytes().replace(
            b"colrnclx\0\x01\0\x0d\0\x01", b"colrnclx\0\x01\0\x0d\0\x04")
    m0 = (FIXTURES / "avif_matrix0.avif").read_bytes()
    i = m0.find(b"colrnclx")
    return m0[:i + 14] + bytes([m0[i + 14] & 0x7F]) + m0[i + 15:]


@pytest.mark.parametrize("kind,tool", [("grid", "a grid item"), ("prem", "premultiplied alpha"),
                                       ("pixi", "more than 8 bits"),
                                       ("matrix4", "matrix coefficients 4"),
                                       ("identity_limited", "the identity matrix in limited range")])
def test_hand_edited_header_is_refused_by_name(kind, tool):
    """A grid primary item is named, never decoded wrongly; a 'prem'
    reference, 10 bits in the boxes, the FCC matrix and the identity
    matrix in limited range (libavif's own conversion paths), once named
    as `tool`, now give PIL's pixels."""
    data = _later(kind)
    got = _port(data)
    if kind == "grid":
        assert isinstance(got, ValueError) and str(got) == f"AVIF: {tool} is not decoded yet", got
        return
    assert not isinstance(got, Exception), got
    assert np.array_equal(got, _pil(data))


def _superres(data: bytes) -> bytes:
    """A fixture with enable_superres set in its sequence header and the
    first one-bit edit of its frame header that turns use_superres on."""
    from relativitypathtracer_tpu_torch.utils import av1_obu
    payload = avif_decode._container(data)[3]
    at, pos = data.find(payload), 0
    while True:  # the sequence header OBU, then the frame OBU after it
        head = payload[pos]
        size, body = av1_obu.leb128(payload, pos + 1 + ((head >> 2) & 1))
        pos = body + size
        if (head >> 3) & 15 == av1_obu.OBU_SEQUENCE_HEADER:
            break
    bit = av1_obu.sequence_header(payload[body:pos]).color_config_bits[0] - 3
    out = bytearray(data)
    out[at + body + bit // 8] ^= 0x80 >> (bit % 8)  # enable_superres
    frame = at + av1_obu.leb128(payload, pos + 1)[1]
    for i in range(frame, frame + 16):
        for b in range(8):
            edit = bytearray(out)
            edit[i] ^= 1 << b
            got = _port(bytes(edit))
            if isinstance(got, ValueError) and "superres" in str(got):
                return bytes(edit)
    raise ValueError("no use_superres bit found")


@pytest.mark.parametrize("kind,tool", [("grid", "a grid item"), ("superres", "superres"),
                                       ("avis", "an image sequence (avis) without a still item")])
def test_tools_left_for_later_stay_refused_by_name(kind, tool):
    """A grid primary item, a frame with superres (enable_superres and
    use_superres set by bit edits) and an avis file without a still item
    (an ftyp and an empty moov): the port names the tool, never decoding
    wrongly."""
    if kind == "avis":
        data = b"\0\0\0\x1cftypavis\0\0\0\0avisavifmif1" + b"\0\0\0\x08moov"
        assert isinstance(_pil_outcome(data), Exception)
    elif kind == "superres":
        data = _superres((FIXTURES / "blob.avif").read_bytes())
    else:
        data = _later(kind)
    got = _port(data)
    assert isinstance(got, ValueError) and str(got) == f"AVIF: {tool} is not decoded yet", got


@pytest.mark.parametrize("matrix", [3, 10, 11, 13, 14])
def test_matrices_libavif_does_not_convert_fail_as_in_pil(matrix):
    """The reserved and ICtCp-like matrices: libavif's conversion fails,
    and so does the port's, naming the matrix."""
    data = nclx_matrix((FIXTURES / "avif_444.avif").read_bytes(), matrix)
    with pytest.raises(RuntimeError, match="Conversion from YUV failed"):
        _pil(data)
    got = _port(data)
    assert isinstance(got, ValueError) and f"matrix coefficients {matrix}" in str(got)


# --- PIL's accept and parse -----------------------------------------------------------

@pytest.mark.parametrize("name,data", [
    ("heic", b"\0\0\0\x18ftypheic\0\0\0\0mif1heic" + bytes(16)),
    ("mp4", b"\0\0\0\x18ftypisom\0\0\0\0isomavc1" + bytes(16)),
    ("mif1 without avif", b"\0\0\0\x14ftypmif1\0\0\0\0mif1" + bytes(16)),
    ("avif stub", b"\0\0\0\x1cftypavif" + bytes(20))])
def test_files_pil_does_not_identify_are_unknown(name, data):
    """A heic or MP4 brand fails PIL's accept; a mif1 or avif file libavif
    cannot parse fails Pillow's plugin with SyntaxError and PIL moves on:
    PIL identifies no format, and the port names none."""
    from PIL import AvifImagePlugin, UnidentifiedImageError
    assert bool(AvifImagePlugin._accept(data)) == avif_decode.accept(data)
    with pytest.raises(UnidentifiedImageError):
        _pil(data)
    got = _port(data)
    assert isinstance(got, ValueError) and str(got).startswith("unknown format"), got
    assert ("libavif does not parse it" in str(got)) == avif_decode.accept(data)


def test_accept_is_pils_for_every_brand():
    from PIL import AvifImagePlugin
    for brand in (b"avif", b"avis", b"mif1", b"msf1", b"heic", b"heix", b"isom", b"mp41",
                  b"AVIF", b"crx "):
        data = b"\0\0\0\x18ftyp" + brand + bytes(12)
        assert avif_decode.accept(data) == bool(AvifImagePlugin._accept(data)), brand
    assert texture._OTHER_FORMATS == ("EPS",)


# --- film grain and quantiser matrices against the specification --------------------

def _spec_random(state: list, bits: int) -> int:
    """get_random_number() as the specification writes it (state: [r])."""
    r = state[0]
    bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
    r = (r >> 1) | (bit << 15)
    state[0] = r
    return (r >> (16 - bits)) & ((1 << bits) - 1)


def _spec_round2(x: int, n: int) -> int:
    return x if n == 0 else (x + (1 << (n - 1))) >> n


def _spec_templates(g, ssx: int, ssy: int) -> tuple:
    """generate_grain() of section 7.18.3.3 at 8 bits, a sample at a time:
    LumaGrain, CbGrain, CrGrain (lists of rows)."""
    from relativitypathtracer_tpu_torch.utils import av1_tables as T
    shift = 12 - 8 + g.grain_scale_shift
    state = [g.grain_seed]
    luma = [[_spec_round2(int(T.GAUSSIAN_SEQUENCE[_spec_random(state, 11)]), shift)
             if g.num_y_points else 0 for _ in range(82)] for _ in range(73)]
    lag, ar_shift = g.ar_coeff_lag, g.ar_coeff_shift
    for y in range(3, 73):
        for x in range(3, 82 - 3):
            total, pos = 0, 0
            for dr in range(-lag, 1):
                for dc in range(-lag, lag + 1):
                    if dr == 0 and dc == 0:
                        break
                    total += luma[y + dr][x + dc] * g.ar_coeffs_y[pos] if g.num_y_points else 0
                    pos += 1
            if g.num_y_points:
                luma[y][x] = max(-128, min(127, luma[y][x] + _spec_round2(total, ar_shift)))
    ch, cw = (38 if ssy else 73), (44 if ssx else 82)
    chroma = []
    for p, xor in ((0, 0xB524), (1, 0x49D8)):
        state = [g.grain_seed ^ xor]
        on = bool(g.uv_points[p]) or g.chroma_scaling_from_luma
        grain = [[_spec_round2(int(T.GAUSSIAN_SEQUENCE[_spec_random(state, 11)]), shift)
                  if on else 0 for _ in range(cw)] for _ in range(ch)]
        coeffs = g.ar_coeffs_uv[p]
        for y in range(3, ch):
            for x in range(3, cw - 3):
                total, pos = 0, 0
                for dr in range(-lag, 1):
                    for dc in range(-lag, lag + 1):
                        if dr == 0 and dc == 0:
                            if g.num_y_points:
                                ly, lx = ((y - 3) << ssy) + 3, ((x - 3) << ssx) + 3
                                avg = sum(luma[ly + i][lx + j] for i in range(ssy + 1)
                                          for j in range(ssx + 1))
                                total += _spec_round2(avg, ssx + ssy) * coeffs[pos]
                            break
                        total += coeffs[pos] * grain[y + dr][x + dc]
                        pos += 1
                if on:
                    grain[y][x] = max(-128, min(127, grain[y][x] + _spec_round2(total, ar_shift)))
        chroma.append(grain)
    return luma, chroma[0], chroma[1]


def test_film_grain_random_numbers_are_the_specifications():
    """The LFSR from seed 1 worked by hand: 0x8000, 0x4000, 0x2000, 0x1000,
    then bit 12 feeds back (0x8800), 11 bits from the top; and 10,000 draws
    of 1-11 bits from other seeds equal to the specification's function."""
    from relativitypathtracer_tpu_torch.utils.av1_filmgrain import Lfsr
    rng = Lfsr(1)
    assert [rng.take(11) for _ in range(5)] == [1024, 512, 256, 128, 1088]
    for seed in (0x1234, 0xB524 ^ 77, 0xFFFF):
        mine, state = Lfsr(seed), [seed]
        for k in range(10_000):
            bits = 1 + k % 11
            assert mine.take(bits) == _spec_random(state, bits)


def test_film_grain_scaling_lookup_is_the_specifications():
    """dav1d's 256-entry table equals the specification's scale_lut at each
    index, and the values worked by hand from points (0, 20), (100, 70),
    (255, 40): 20 at 0 and 1, 21 at 2, 45 at 50, 69 at 99, 70 at 100, 51 at
    200, 40 at 255; flat before a first point past 0; zero without
    points."""
    from relativitypathtracer_tpu_torch.utils.av1_filmgrain import scaling

    def scale_lut(points, index):
        if not points or index < points[0][0]:
            return points[0][1] if points else 0
        for (x0, y0), (x1, y1) in zip(points, points[1:]):
            if index < x1:
                delta = (y1 - y0) * ((65536 + ((x1 - x0) >> 1)) // (x1 - x0))
                return y0 + _spec_round2((index - x0) * delta, 16)
        return points[-1][1]

    lut = scaling([(0, 20), (100, 70), (255, 40)])
    assert [int(lut[i]) for i in (0, 1, 2, 50, 99, 100, 200, 255)] == [20, 20, 21, 45, 69, 70,
                                                                        51, 40]
    rng = np.random.default_rng(5)
    for k in range(40):
        xs = sorted(set(int(v) for v in rng.integers(0, 256, 1 + k % 14)))
        points = [(x, int(rng.integers(0, 256))) for x in xs]
        lut = scaling(points)
        assert [int(v) for v in lut] == [scale_lut(points, i) for i in range(256)], points
    assert not scaling([]).any()


@pytest.mark.parametrize("name", ["avif_grain_test1.avif", "avif_grain_test15.avif",
                                  "avif_grain_table_lag0.avif", "avif_grain_table_lag1.avif",
                                  "avif_grain422.avif", "avif_grain444.avif",
                                  "avif_grain_table_cfl_no_luma.avif"])
def test_film_grain_templates_are_the_specifications(name):
    """The grain templates (luma's and each chroma plane's, after the AR
    filter) of a fixture's film grain params, vectorised by row, equal the
    specification's generate_grain() run a sample at a time."""
    from relativitypathtracer_tpu_torch.utils import av1_filmgrain, av1_obu
    data = (FIXTURES / name).read_bytes()
    seq, fh = av1_obu.parse_still(avif_decode._container(data)[3])
    g = fh.film_grain
    want = _spec_templates(g, seq.ssx, seq.ssy)
    got = av1_filmgrain.templates(g, seq.mono, seq.ssx, seq.ssy)
    for plane, (mine, spec) in enumerate(zip(got, want)):
        if mine is None:
            assert not (g.uv_points[plane - 1] if plane else g.num_y_points)
            continue
        assert mine.tolist() == spec, (name, plane)


def test_film_grain_clip_ranges_follow_the_matrix():
    """clip_to_restricted_range: luma to [16, 235], chroma to [16, 240], or
    to 235 under the identity matrix (MC 0); otherwise [0, 255]. Flat grain
    of the template's extreme (127) at the strongest scaling pushes every
    sample to the top of its range."""
    from types import SimpleNamespace

    from relativitypathtracer_tpu_torch.utils import av1_filmgrain
    g = SimpleNamespace(grain_seed=7, y_points=[(0, 255)], num_y_points=1,
                        uv_points=[[(0, 255)], [(0, 255)]], chroma_scaling_from_luma=0,
                        scaling_shift=8, ar_coeff_lag=0, ar_coeffs_y=[],
                        ar_coeffs_uv=[[0], [0]], ar_coeff_shift=6, grain_scale_shift=0,
                        uv_mult=[0, 0], uv_luma_mult=[0, 0], uv_offset=[0, 0],
                        overlap_flag=0, clip_to_restricted_range=1)
    planes = [np.full((8, 8), 250), np.full((8, 8), 250), np.full((8, 8), 250)]
    for mc, top_uv in ((1, 240), (0, 235)):
        seq = SimpleNamespace(ssx=0, ssy=0, mono=0, num_planes=3, mc=mc, bit_depth=8)
        out = av1_filmgrain.apply_grain(planes, 8, 8, seq, g)
        assert out[0].max() <= 235 and out[1].max() <= top_uv and out[2].max() <= top_uv
        assert out[1].max() == top_uv or out[1].max() < 240 - 1
        assert min(o.min() for o in out) >= 16
    g.clip_to_restricted_range = 0
    out = av1_filmgrain.apply_grain(planes, 8, 8, SimpleNamespace(
        ssx=0, ssy=0, mono=0, num_planes=3, mc=1, bit_depth=8), g)
    assert max(o.max() for o in out) <= 255 and max(o.max() for o in out) > 240


def test_packed_tables_equal_the_library_they_came_from():
    """Quantizer_Matrix and Gaussian_Sequence as av1_tables packs them equal
    the bytes tools/av1_tables_extract.py reads from Pillow's libavif, where
    that very library is installed (its anchors checked first)."""
    sys.path.insert(0, str(REPO / "tools"))
    import av1_tables_extract as X

    from relativitypathtracer_tpu_torch.utils import av1_tables as T
    lib = X.find_library()
    if lib is None:
        pytest.skip(f"no {X.LIBRARY} beside PIL")
    qm, gauss, _ = X.extract(lib)
    assert np.array_equal(T.QUANTIZER_MATRIX, qm)
    assert np.array_equal(T.GAUSSIAN_SEQUENCE, gauss.astype(np.int64))
    assert T.QUANTIZER_MATRIX.shape == (15, 2, 3344) and T.QM_OFFSET[4] == T.QM_OFFSET[3] == 336


# --- cuts and byte edits against PIL in a fresh process -----------------------------

_PIL_SCRIPT = """
import hashlib, io, json, sys
import numpy as np
from PIL import Image
out = []
for path in sys.argv[1:]:
    try:
        with Image.open(path) as im:
            out.append(hashlib.sha256(np.asarray(im.convert("RGB")).tobytes()).hexdigest())
    except Exception as e:
        out.append("error: " + type(e).__name__)
print(json.dumps(out))
"""


def _mutants(data: bytes, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = [data[:n] for n in sorted({int(x) for x in rng.integers(8, len(data), 10)})]
    for _ in range(30):
        b = bytearray(data)
        pos = int(rng.integers(0, len(data)))
        b[pos] ^= int(rng.integers(1, 256))
        out.append(bytes(b))
    return out


@pytest.mark.parametrize("name,seed", [("blob.avif", 1), ("avif_130x70.avif", 2),
                                       ("avif_squares_spots.avif", 6), ("avif_lr_tall.avif", 4),
                                       ("avif_grain_qm.avif", 7), ("avif10_blob.avif", 100),
                                       ("avif_prem420_q75.avif", 102)])
def test_cuts_and_edits_agree_with_pil(name, seed, tmp_path):
    """40 cuts and one-byte edits of a fixture: PIL's outcome from a fresh
    process and the port's with PIL blocked give the same pixels, or both
    refuse."""
    cases = _mutants((FIXTURES / name).read_bytes(), seed)
    paths = []
    for k, data in enumerate(cases):
        paths.append(tmp_path / f"m{k}.avif")
        paths[-1].write_bytes(data)
    run = subprocess.run([sys.executable, "-c", _PIL_SCRIPT, *map(str, paths)],
                         capture_output=True, text=True, timeout=120, check=True)
    want = json.loads(run.stdout)
    equal = refused = 0
    for data, w in zip(cases, want):
        got = _port(data)
        if isinstance(got, Exception):
            assert w.startswith("error"), (str(got), w)
            refused += 1
        else:
            assert hashlib.sha256(got.tobytes()).hexdigest() == w, w
            equal += 1
    assert equal >= 5 and refused >= 5, (equal, refused)


# --- read_texture, scenes, and the JAX package -----------------------------------------

SCENE_FIXTURES = ("blob.avif", "avif_130x70.avif", "avif_444.avif", "avif_rgba.avif",
                  "avif_squares256.avif", "avif_lr_switchable.avif", "avif_grain_99x75.avif",
                  "avif_qm_bands4.avif", "avif10_blob.avif", "avif12_444.avif",
                  "avif_prem420_q75.avif", "avif_matrix8_444.avif")


def test_read_texture_without_pil_matches_the_jax_package(monkeypatch):
    """read_texture of AVIF files (a 10-bit, a 12-bit, a premultiplied and a
    YCgCo one among them), with PIL blocked, gives the JAX package's
    read_texture's atlas bytes and (offset, w, h) values."""
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


def test_scene_with_avif_textures_matches_jax(tmp_path):
    """A DSL scene with AVIF textures (10 and 12 bits, premultiplied alpha
    and YCgCo among them), each shared by two objects, through
    the JAX package's build_scene (PIL) and the port's: every texture array
    exact, and the JAX scene carried over by scene_from_numpy equal to the
    port's own build."""
    import jax

    from relativitypathtracer_tpu import build_scene as jbuild
    from relativitypathtracer_tpu.models.dsl import parse_scene as jparse

    names = SCENE_FIXTURES
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
