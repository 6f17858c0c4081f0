"""The port's AVIF decoder (utils/avif_decode, av1_obu, av1_entropy,
av1_block, av1_recon, av1_palette, av1_intrabc, av1_loopfilter, av1_cdef,
av1_restoration, av1_tables) against PIL, the JAX package's decoder.

Tolerance 0: every decode equals `np.asarray(Image.open(f).convert("RGB"))`
byte for byte, with PIL blocked while the port decodes. The committed
fixtures (tests/torch_textures/make_fixtures.py's `avif_fixtures`) against
PIL now and against the hash PIL gave where they were made; the census
(every tool a speed-6 encode of a photograph turns on occurs in a
fixture the port decodes); each tool left for later refused by name, on a
file PIL writes or a hand-edited header; cuts and byte edits of two
fixtures against PIL's outcome in a fresh process (equal, or both
refuse); PIL's accept (heic and MP4
brands are no AVIF); a DSL scene with AVIF textures built to the JAX
package's texture arrays.
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
REFUSED = {"avif_film_grain.avif": "film grain", "avif_qm.avif": "quantizer matrices"}
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


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


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


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_fixture_with_a_later_tool_is_refused_by_name(name, tmp_path):
    """PIL decodes these; the port names the tool it does not decode yet,
    before any pixel, through decode_texture and read_texture."""
    data = (FIXTURES / name).read_bytes()
    _pil(data)
    got = _port(data)
    assert isinstance(got, ValueError)
    assert str(got) == f"AVIF: {REFUSED[name]} is not decoded yet"
    path = tmp_path / name
    path.write_bytes(data)
    atlas, values = bytearray(b"x"), []
    with pytest.raises(TextureError, match="is not decoded yet"):
        read_texture(str(path), atlas, values)
    assert atlas == bytearray(b"x") and values == []


def test_census_tools_occur_in_decoded_fixtures():
    """Every tool the census finds in speed-6 encodes of photographic
    content, and the speed 0-3 tools the port decodes, occurs in at least
    one fixture the port decodes; so do all 13 luma modes, all 14 chroma
    modes (CFL among them), the seven intra transform types, palette and
    intra block copy, CDEF and each kind of loop restoration."""
    tools = set()
    for name in DECODED:
        tools |= avif_decode.census((FIXTURES / name).read_bytes())
    assert SPEED6_TOOLS | SLOWER_TOOLS | SCREEN_AND_FILTER_TOOLS | {"tiles"} <= tools
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


@pytest.mark.parametrize("kind,tool", [("grid", "a grid item"), ("prem", "premultiplied alpha"),
                                       ("pixi", "more than 8 bits"),
                                       ("matrix4", "matrix coefficients 4"),
                                       ("identity_limited", "the identity matrix in limited range")])
def test_hand_edited_header_is_refused_by_name(kind, tool):
    """A grid primary item, a 'prem' reference, 10 bits, the FCC matrix
    and the identity matrix in limited range (libavif's own conversion
    paths) are named, never decoded wrongly."""
    blob = (FIXTURES / "blob.avif").read_bytes()
    if kind == "grid":
        data = _edit(blob, b"av01Color", b"gridColor")
    elif kind == "prem":
        data = _edit((FIXTURES / "avif_rgba.avif").read_bytes(), b"auxl", b"prem")
    elif kind == "pixi":
        data = _ten_bits(blob)
    elif kind == "matrix4":
        data = (FIXTURES / "avif_matrix1.avif").read_bytes().replace(
            b"colrnclx\0\x01\0\x0d\0\x01", b"colrnclx\0\x01\0\x0d\0\x04")
    else:
        m0 = (FIXTURES / "avif_matrix0.avif").read_bytes()
        i = m0.find(b"colrnclx")
        data = m0[:i + 14] + bytes([m0[i + 14] & 0x7F]) + m0[i + 15:]
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
                                       ("avif_squares_spots.avif", 6), ("avif_lr_tall.avif", 4)])
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
                  "avif_squares256.avif", "avif_lr_switchable.avif")


def test_read_texture_without_pil_matches_the_jax_package(monkeypatch):
    """read_texture of AVIF files, with PIL blocked, gives the JAX package's
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
    """A DSL scene with AVIF textures, each shared by two objects, through
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
