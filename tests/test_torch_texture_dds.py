"""The port's decoders of block-compressed textures (utils/bcn_decode: BC1-BC7
as PIL's C decoder, DXT1/3/5 as BlpImagePlugin's Python decoders;
utils/dds_decode: DDS, FTEX, BLP) against PIL, the JAX package's decoder.

Tolerance 0: every decode equals `np.asarray(Image.open(f).convert("RGB"))`
byte for byte. The committed DDS, FTEX and BLP fixtures
(tests/torch_textures/make_fixtures.py's `block_fixtures`) with PIL
blocked; seeded random blocks of every BCn kind at random sizes up to
17x17 (hypothesis, derandomised), and of every BC7 and BC6H mode, which
need no encoder (any bit pattern is a block); the DXT blocks of BLP2 at
every alpha flag and odd widths, where PIL's rows shear. Broken, huge and
refused files raise TextureError naming the cause, with the atlas
untouched (PIL fails on each too). read_texture and a DSL scene with DDS,
FTEX and BLP textures build to the JAX package's texture arrays.
"""

import io
import json
import pathlib
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image
from torch_textures.make_fixtures import (DDPF_LUMINANCE, DDPF_PAL8, DDPF_RGB, bc7_mode6,
                                          blp_file, dds_file, ftex_file)

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch.models.texture import TextureError, decode_texture, read_texture
from relativitypathtracer_tpu_torch.utils import bcn_decode

FIXTURES = pathlib.Path(__file__).resolve().parent / "torch_textures"
BLOCK_FIXTURES = sorted(name for name in json.loads((FIXTURES / "pil_rgb.json").read_text())
                        ["files"] if name.endswith((".dds", ".blp", ".ftc", ".ftu")))
# kind -> DXGI format of the DX10 header
DXGI = {"BC1": 71, "BC2": 74, "BC3": 77, "BC4": 80, "BC5": 83, "BC5S": 84, "BC6H": 95,
        "BC6HS": 96, "BC7": 98}


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _equal_to_pil(data: bytes) -> None:
    want = _pil(data)
    got = decode_texture(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), f"{int((got != want).any(-1).sum())} pixels differ"


def _dx10(kind: str, width: int, height: int, blocks: np.ndarray) -> bytes:
    return dds_file(width, height, blocks.tobytes(), fourcc=b"DX10", dxgi=DXGI[kind])


def _random_blocks(seed: int, kind: str, width: int, height: int) -> np.ndarray:
    size = bcn_decode.KINDS[kind][0]
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (bcn_decode.block_count(width, height), size), dtype=np.uint8)


# --- the committed fixtures, PIL blocked -------------------------------------------

@pytest.mark.parametrize("name", BLOCK_FIXTURES)
def test_block_fixtures_decode_as_pil_without_pil(name, monkeypatch):
    """Each DDS, FTEX and BLP fixture decodes, with PIL blocked, to PIL's
    pixels."""
    data = (FIXTURES / name).read_bytes()
    want = _pil(data)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = decode_texture(data)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_fixtures_cover_every_kind_and_mode():
    """The fixtures hold every BCn kind under DX10, every legacy FourCC,
    every BC7 mode (and mode byte 0) and every BC6H mode code."""
    names = set(BLOCK_FIXTURES)
    assert {f"dx10_{k.lower()}.dds" for k in DXGI} <= names
    assert {f"rand_{f}.dds" for f in ("dxt1", "dxt3", "dxt5", "ati1", "bc4u", "ati2", "bc5u",
                                      "bc5s")} <= names
    data = (FIXTURES / "bc7_modes.dds").read_bytes()[148:]
    first = np.frombuffer(data, np.uint8).reshape(-1, 16)[:, 0]
    assert set(bcn_decode._LOWEST_BIT[first].tolist()) == set(range(9))
    for name in ("bc6h_modes.dds", "bc6hs_modes.dds"):
        codes = np.frombuffer((FIXTURES / name).read_bytes()[148:], np.uint8).reshape(-1, 16)
        codes = codes[:, 0] & 0x1F
        codes = np.where((codes & 3) < 2, codes & 3, codes)
        assert set(codes.tolist()) == {0, 1} | set(range(2, 32, 4)) | set(range(3, 32, 4))


# --- random blocks ----------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(DXGI))
@settings(derandomize=True, max_examples=25, deadline=None)
@given(width=st.integers(1, 17), height=st.integers(1, 17), seed=st.integers(0, 2**32 - 1))
def test_random_blocks_decode_as_pil(kind, width, height, seed):
    """Random blocks of each BCn kind at random sizes: the C decoder's
    pixels, the last column and row of blocks cut."""
    _equal_to_pil(_dx10(kind, width, height, _random_blocks(seed, kind, width, height)))


@pytest.mark.parametrize("kind", ["DXT1", "DXT3", "DXT5"])
@settings(derandomize=True, max_examples=25, deadline=None)
@given(width=st.integers(1, 17), height=st.integers(1, 17), alpha=st.booleans(),
       seed=st.integers(0, 2**32 - 1))
def test_random_blp2_dxt_blocks_decode_as_pil(kind, width, height, alpha, seed):
    """Random DXT blocks in a BLP2 at random sizes and alpha flags: PIL's
    Python decoders (no bit replication), the rows of the padded width read
    back at the image's width and mode."""
    enc, size = {"DXT1": (0, 8), "DXT3": (1, 16), "DXT5": (7, 16)}[kind]
    rng = np.random.default_rng(seed)
    body = rng.integers(0, 256, bcn_decode.block_count(width, height) * size, dtype=np.uint8)
    _equal_to_pil(blp_file(2, width, height, body.tobytes(), encoding=2, alpha=int(alpha),
                           alpha_encoding=enc))


@pytest.mark.parametrize("mode", range(9))
def test_every_bc7_mode_decodes_as_pil(mode):
    """96 random blocks forced into BC7 mode `mode` (8: mode byte 0)."""
    blocks = _random_blocks(mode, "BC7", 32, 48)
    blocks[:, 0] = 0 if mode == 8 else (blocks[:, 0] & ((0xFF << (mode + 1)) & 0xFF)) | (1 << mode)
    _equal_to_pil(_dx10("BC7", 31, 45, blocks))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("code", [0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23, 27,
                                  31])
def test_every_bc6h_mode_decodes_as_pil(code, signed):
    """96 random blocks of each BC6H mode code (19, 23, 27 and 31 are
    reserved: black), unsigned and signed."""
    blocks = _random_blocks(code + 100 * signed, "BC6H", 32, 48)
    blocks[:, 0] = (blocks[:, 0] & (0xFC if code < 2 else 0xE0)) | code
    _equal_to_pil(_dx10("BC6HS" if signed else "BC6H", 30, 47, blocks))


def test_bc6h_signed_deltas_are_not_sign_extended_again():
    """PIL's signed BC6H adds a transformed mode's deltas to the base
    endpoint, wraps the sum to the endpoint's bits and unquantises it with
    no second sign extension: a negative base plus a small delta reads as
    a large positive endpoint (saturated white where the spec's decoder
    gives black)."""
    # mode 11 (code 7): 11-bit base, 9-bit deltas; r0 = g0 = b0 = -1, deltas 0
    bits = np.zeros(128, np.uint8)
    bits[:5] = [1, 1, 1, 0, 0]
    bits[5:35] = 1  # r0, g0, b0 bits 0-9
    bits[44] = bits[54] = bits[64] = 1  # their bit 10
    bits[68:72] = 1  # texel 1's index 15: the second endpoint (-1 + 0, wrapped: 0x7FF)
    block = np.packbits(bits, bitorder="little")[None]
    got = bcn_decode.bc6h(block, True)
    assert got[0, 0].tolist() == [0, 0, 0] and got[0, 1].tolist() == [255, 255, 255]
    _equal_to_pil(_dx10("BC6HS", 4, 4, block))


def test_bc5s_moves_signed_endpoints_up_and_sets_blue():
    """BC5S: endpoint bytes read as int8 + 128 (x ^ 0x80), blue 128;
    BC5 unsigned: blue 0."""
    block = np.array([[0x80, 0x7F] + [0] * 6 + [0x7F, 0x80] + [0] * 6], np.uint8)
    assert bcn_decode.bc5(block, True)[0, 0].tolist() == [0, 255, 128]
    assert bcn_decode.bc5(block)[0, 0].tolist() == [128, 127, 0]
    for fourcc in (b"BC5S", b"BC5U"):
        _equal_to_pil(dds_file(4, 4, block.tobytes(), fourcc=fourcc))


def test_dxt_python_and_c_decoders_differ_as_pil_does():
    """BLP2 (PIL's Python decode_dxt1) and DDS (its C decoder) give other
    pixels for the same DXT1 blocks: 5:6:5 widened by a shift against bit
    replication."""
    blocks = _random_blocks(3, "BC1", 16, 16)
    c = bcn_decode.bc1(blocks)[..., :3].astype(int)
    py = bcn_decode.dxt_python(blocks, "DXT1", False).astype(int)
    assert (c != py).any(-1).mean() > 0.5 and np.abs(c - py).max() <= 7
    _equal_to_pil(dds_file(16, 16, blocks.tobytes(), fourcc=b"DXT1"))
    _equal_to_pil(blp_file(2, 16, 16, blocks.tobytes(), encoding=2))


def test_blp2_dxt5_without_alpha_shears_as_pil():
    """A BLP2 DXT5 file whose alpha flag is 0: RGBA texels, four bytes
    each, read back three bytes a pixel, so every pixel after the first
    takes its bytes from the wrong texels, as PIL's do."""
    blocks = _random_blocks(4, "BC3", 12, 8)
    data = blp_file(2, 12, 8, blocks.tobytes(), encoding=2, alpha=0, alpha_encoding=7)
    rgba = bcn_decode.tile(bcn_decode.dxt_python(blocks, "DXT5"), 12, 8)
    got = decode_texture(data)
    assert np.array_equal(got.reshape(-1), rgba.reshape(-1)[:12 * 8 * 3])
    assert np.array_equal(got[0, 0], rgba[0, 0, :3]) and not np.array_equal(got, rgba[..., :3])
    _equal_to_pil(data)


def test_bc7_mode6_builder_keeps_the_picture():
    """make_fixtures.bc7_mode6 (the cubes fixture's encoder) keeps flat
    blocks to within a level and a block whose colours lie on a line to
    within a few."""
    x = np.mgrid[0:16, 0:16][1]
    pic = np.stack([x * 16, x * 8 + 40, 200 - x * 12], -1).astype(np.uint8)
    pic[8:, 8:] = (40, 90, 200)
    got = bcn_decode.tile(bcn_decode.bc7(np.frombuffer(bc7_mode6(pic), np.uint8)
                                         .reshape(-1, 16)), 16, 16)
    assert np.abs(got[8:, 8:, :3].astype(int) - pic[8:, 8:]).max() <= 1
    assert np.abs(got[..., :3].astype(int) - pic).max() <= 4 and (got[..., 3] == 255).all()


def test_uncompressed_dds_kinds_decode_as_pil():
    """Masks of every width, an empty mask, no bytes a pixel (bit count 0)
    or part of one (12 bits: one byte), more bytes a pixel than the masks
    read, 8-bit L, an 8-bit palette, and a truncated RGB file (PIL's
    dds_rgb decoder reads zeros past the end; no error)."""
    rng = np.random.default_rng(11)
    body = rng.integers(0, 256, 6 * 5 * 8, dtype=np.uint8).tobytes()
    for bits, masks in ((0, (0xFF, 0xFF00, 0, 0)), (12, (0xF00, 0xF0, 0xF, 0)),
                        (8, (0xE0, 0x1C, 0x3, 0)), (16, (0x1F, 0x7E0, 0xF800, 0)),
                        (32, (0xFFFFFFFF, 0x0, 0x5, 0)), (64, (0xFF, 0xFF00, 0xFF0000, 0))):
        _equal_to_pil(dds_file(6, 5, body, pfflags=DDPF_RGB, bitcount=bits, masks=masks))
    _equal_to_pil(dds_file(6, 5, body[:37], pfflags=DDPF_RGB, bitcount=24,
                           masks=(0xFF0000, 0xFF00, 0xFF, 0)))
    _equal_to_pil(dds_file(6, 5, body[:30], pfflags=DDPF_LUMINANCE, bitcount=8))
    palette = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    _equal_to_pil(dds_file(6, 5, palette + body[:30], pfflags=DDPF_PAL8, bitcount=8))


# --- what is refused ----------------------------------------------------------------

def _refused():
    rng = np.random.default_rng(12)
    dxt1 = rng.integers(0, 256, 8 * 12, dtype=np.uint8).tobytes()
    blp2 = blp_file(2, 10, 7, rng.integers(0, 256, 6 * 16, dtype=np.uint8).tobytes(), encoding=2,
                    alpha_encoding=7)
    jpeg_io = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(jpeg_io, "JPEG")
    jpeg = jpeg_io.getvalue()
    sos = jpeg.index(b"\xff\xda")
    blp1 = blp_file(1, 8, 8, jpeg[sos:], compression=0, jpeg_header=jpeg[:sos])
    return {
        "dds_truncated": (dds_file(13, 10, dxt1[:-9], fourcc=b"DXT1"), "truncated DDS BC1"),
        "dds_header_cut": (dds_file(4, 4, b"")[:90], "incomplete header"),
        "dds_unknown_fourcc": (dds_file(4, 4, dxt1, fourcc=b"XYZW"),
                               "unimplemented pixel format b'XYZW'"),
        # BC1's sRGB format is not among those PIL lists
        "dds_dxgi_bc1_srgb": (dds_file(4, 4, dxt1, fourcc=b"DX10", dxgi=72),
                              "unimplemented DXGI format 72"),
        "dds_dxgi_float": (dds_file(4, 4, dxt1, fourcc=b"DX10", dxgi=2),
                           "unimplemented DXGI format 2"),
        "dds_header_size": (dds_file(4, 4, dxt1, fourcc=b"DXT1", header_size=100),
                            "header size 100, not 124"),
        "dds_luminance_16": (dds_file(4, 4, dxt1, pfflags=DDPF_LUMINANCE, bitcount=16),
                             "luminance bit count 16"),
        "dds_no_format_flags": (dds_file(4, 4, dxt1, pfflags=0), "unknown pixel format flags"),
        "dds_palette_truncated": (dds_file(4, 4, bytes(1030), pfflags=DDPF_PAL8, bitcount=8),
                                  "truncated DDS palette indices"),
        "dds_huge": (dds_file(20000, 10000, dxt1, fourcc=b"DXT1"), "more pixels than 178,956,970"),
        "ftex_truncated": (ftex_file(13, 10, 0, dxt1[:-1]), "truncated FTEX DXT1"),
        "ftex_two_formats": (ftex_file(4, 4, 0, dxt1, formats=2), "2 formats, not 1"),
        "ftex_bad_format": (ftex_file(4, 4, 5, dxt1), "compression format 5"),
        "ftex_huge": (ftex_file(20000, 10000, 0, dxt1), "more pixels than 178,956,970"),
        "blp2_dxt_truncated": (blp2[:-20], "truncated BLP DXT5 rows"),
        "blp2_short_palette": (blp2[:600], "truncated BLP palette"),
        "blp2_raw_bgra": (blp_file(2, 4, 4, bytes(64), encoding=3), "unknown BLP2 encoding 3"),
        "blp2_alpha_encoding": (blp_file(2, 4, 4, bytes(64), encoding=2, alpha_encoding=8),
                                "unsupported alpha encoding 8"),
        "blp1_encoding": (blp_file(1, 4, 4, bytes(16), encoding=3),
                          "unsupported BLP1 encoding 3"),
        "blp1_palette_short": (blp_file(1, 4, 4, bytes(15), encoding=5),
                               "not enough image data"),
        "blp1_jpeg_truncated": (blp1[:-30], "truncated BLP mip 0"),
        "blp_huge": (blp_file(2, 20000, 10000, bytes(64)), "more pixels than 178,956,970"),
    }


REFUSED = _refused()


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_refused_and_broken_files_raise_texture_error(tmp_path, kind, monkeypatch):
    """Each raises TextureError naming the file and the cause, with PIL
    blocked, and leaves the atlas as it was."""
    data, words = REFUSED[kind]
    path = tmp_path / "t.bin"
    path.write_bytes(data)
    monkeypatch.setitem(sys.modules, "PIL", None)
    atlas, values = bytearray(b"keep"), []
    with pytest.raises(TextureError) as err:
        read_texture(str(path), atlas, values)
    assert str(path) in str(err.value) and words in str(err.value), str(err.value)
    assert atlas == b"keep" and values == []


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_pil_fails_on_the_refused_files(kind):
    """PIL fails on each too, the huge ones past its decompression-bomb
    limit."""
    with pytest.raises(Image.DecompressionBombError if kind.endswith("huge") else Exception):
        _pil(REFUSED[kind][0])


# --- read_texture, scenes, and the JAX package ----------------------------------

SCENE_FIXTURES = ("blob_bc1.dds", "cubes_bc7.dds", "dx10_bc6h.dds", "p8.dds", "dxt1.ftc",
                  "rgb.ftu", "blp1_jpeg_ycck.blp", "blp2_palette_alpha.blp", "blp2_dxt3_a0.blp")


def test_read_texture_without_pil_matches_the_jax_package(monkeypatch):
    """read_texture of DDS, FTEX and BLP files, with PIL blocked, gives the
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


def test_scene_with_dds_ftex_and_blp_textures_matches_jax(tmp_path):
    """A DSL scene with DDS, FTEX and BLP textures, each shared by two
    objects, through the JAX package's build_scene (PIL) and the port's:
    every texture array exact, and the JAX scene carried over by
    scene_from_numpy equal to the port's own build."""
    import jax

    from relativitypathtracer_tpu import build_scene as jbuild
    from relativitypathtracer_tpu.models.dsl import parse_scene as jparse

    for name in SCENE_FIXTURES:
        (tmp_path / name).write_bytes((FIXTURES / name).read_bytes())
    n = len(SCENE_FIXTURES)
    objects = [f"{'Os' if k % 2 else 'Oc'}\n p{k % 7 - 3},{k // 7 - 1},{6 + k % 3},0,0,1,0,0.6,"
               f"0.6,0.6\n t{k % n}\n" for k in range(2 * n)]
    text = "".join(f"T{name}\n" for name in SCENE_FIXTURES) + "".join(objects) + "R\n"
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


def test_blocks_are_decoded_without_a_python_loop_over_them(monkeypatch):
    """BC6H and BC7 decode a mode's blocks in one pass: the per-mode
    decoder runs once per mode present, however many blocks there are."""
    calls = []
    for name in ("_bc7_mode", "_bc6_mode"):
        real = getattr(bcn_decode, name)
        monkeypatch.setattr(bcn_decode, name, lambda *a, _r=real, _n=name: calls.append(_n)
                            or _r(*a))
    blocks = _random_blocks(5, "BC7", 128, 128)
    bcn_decode.bc7(blocks)
    assert len(calls) == len(set(bcn_decode._LOWEST_BIT[blocks[:, 0]].tolist()) - {8})
    calls.clear()
    bcn_decode.bc6h(blocks, False)
    assert 0 < len(calls) <= 14
