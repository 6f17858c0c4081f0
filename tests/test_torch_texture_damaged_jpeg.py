"""Damaged JPEG data read as the JAX package reads it: PIL 12.1.0 with
libjpeg-turbo 3.1.3, which warns on damaged entropy-coded data and reads
on (utils/image_decode, utils/jpeg_arith).

Tolerance 0. tests/torch_textures/damaged.json holds the damaged-data
sweep (make_fixtures.py's `damaged_cases`: 40 edits of each committed JPEG
and IPTC-JPEG fixture, seeded by the file's name, each a byte set, a
marker put into the entropy-coded data, or a cut) and PIL's outcome of
each from three fresh processes: the port, with PIL blocked, gives PIL's
pixels (their SHA-256) where PIL reads the file, and raises TextureError
through read_texture where PIL fails or its pixels vary. Hand-built files
pin each of libjpeg's rules against the installed PIL: a code no table
holds, runs past coefficient 63 and past a progressive band, the three
resynchronisation actions, an RSTn without a restart interval, Huffman
tables 0 and 1 left undefined, a symbol listed twice, a refinement out
of order and one of size 2, DC values past 16 bits. A DSL scene with two
damaged textures builds to the JAX package's texture arrays.
"""

import hashlib
import io
import json
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest
from torch_textures.make_fixtures import damaged, damaged_cases

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch.models.texture import TextureError, decode_texture, read_texture
from relativitypathtracer_tpu_torch.utils.image import _AC_LUMA, _DC_LUMA, _segment

FIXTURES = pathlib.Path(__file__).resolve().parent / "torch_textures"
SWEEP = json.loads((FIXTURES / "damaged.json").read_text())["cases"]
JPEGS = sorted(n for n in SWEEP if not n.endswith(".tif"))


def _blocked(fn, *args):
    """fn(*args) with PIL blocked, or the exception it raises."""
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - compared below
        return e
    finally:
        if saved is None:
            del sys.modules["PIL"]
        else:
            sys.modules["PIL"] = saved


def check_sweep(name: str, tmp_path) -> None:
    """Every case of fixture `name` in damaged.json through read_texture,
    PIL blocked: PIL's SHA-256 where PIL reads it, TextureError where PIL
    fails or varies."""
    data = (FIXTURES / name).read_bytes()
    cases = damaged_cases(name, data)
    assert len(cases) == len(SWEEP[name])
    path = tmp_path / name
    for case, (at, drop, put, want) in zip(cases, SWEEP[name]):
        assert case == (at, drop, bytes.fromhex(put))
        path.write_bytes(damaged(data, case))
        atlas, values = bytearray(), []
        got = _blocked(read_texture, str(path), atlas, values)
        if isinstance(want, dict):
            assert not isinstance(got, Exception), (name, case, got)
            h, w, _ = want["shape"]
            assert values == [0, w, h], (name, case)
            assert hashlib.sha256(bytes(atlas)).hexdigest() == want["sha256"], (name, case)
        else:
            assert isinstance(got, TextureError), (name, case, want, got)


@pytest.mark.parametrize("name", JPEGS)
def test_damaged_jpeg_reads_as_pil_reads_it(name, tmp_path):
    check_sweep(name, tmp_path)


def rederive(names, step: int) -> None:
    """Every `step`-th case of the fixtures `names` opened again by the
    installed PIL in a fresh process: the outcome damaged.json records
    (cases whose pixels varied left out)."""
    pytest.importorskip("PIL")
    order = [(n, i) for n in names for i in range(0, len(SWEEP[n]), step)
             if SWEEP[n][i][3] != "varies"]
    code = ("import sys, json; sys.path.insert(0, %r); import make_fixtures as m; "
            "m._pil_hashes([tuple(x) for x in json.loads(sys.stdin.read())])" % str(FIXTURES))
    res = subprocess.run([sys.executable, "-c", code], input=json.dumps(order), text=True,
                         capture_output=True, check=True, timeout=120)
    got = json.loads(res.stdout.strip().splitlines()[-1])
    for n, i in order:
        assert got[f"{n}/{i}"] == SWEEP[n][i][3], (n, i)


def test_a_sample_of_the_sweep_rederived_with_pil():
    rederive(JPEGS, 7)


# --- hand-built files: each of libjpeg's rules against PIL ---------------------------------

def _codes(spec) -> dict:
    """{symbol: code bits} of a DHT table, codes by position (a symbol's
    first code)."""
    counts, symbols = spec
    out, code, k = {}, 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            out.setdefault(symbols[k], format(code, f"0{length}b"))
            code += 1
            k += 1
        code <<= 1
    return out


DC, AC = _codes(_DC_LUMA), _codes(_AC_LUMA)
EOB, ZRL = AC[0x00], AC[0xF0]
BAD = "1" * 17  # no code of the standard tables starts with sixteen 1s


def _bits(v: int) -> tuple:
    """(size, value bits) of a coefficient or difference."""
    if v == 0:
        return 0, ""
    s = abs(v).bit_length()
    return s, format(v if v > 0 else v + (1 << s) - 1, f"0{s}b")


def _dc(v: int) -> str:
    s, b = _bits(v)
    return DC[s] + b


def _ac(run: int, v: int) -> str:
    s, b = _bits(v)
    return AC[run << 4 | s] + b


def _entropy(bits: str) -> bytes:
    """Bits padded with 1s to a byte, each 0xFF stuffed."""
    bits += "1" * (-len(bits) % 8)
    out = bytearray()
    for i in range(0, len(bits), 8):
        out.append(int(bits[i:i + 8], 2))
        if out[-1] == 0xFF:
            out.append(0)
    return bytes(out)


def _grey(blocks: int, scans, *, progressive=False, dri=0, dht=None, q=1) -> bytes:
    """A greyscale JPEG `blocks` blocks wide and one high: a flat table of
    q, the luma Huffman tables (or `dht`: (class and id, (counts,
    symbols))), the restart interval, then each scan as ((Ss, Se, Ah, Al),
    its entropy-coded bytes)."""
    out = b"\xff\xd8" + _segment(0xDB, bytes([0]) + bytes([q]) * 64)
    out += _segment(0xC2 if progressive else 0xC0,
                    struct.pack(">BHHB", 8, 8, 8 * blocks, 1) + bytes([1, 0x11, 0]))
    for tc_th, (counts, symbols) in dht or ((0x00, _DC_LUMA), (0x10, _AC_LUMA)):
        out += _segment(0xC4, bytes([tc_th]) + bytes(counts) + bytes(symbols))
    if dri:
        out += _segment(0xDD, struct.pack(">H", dri))
    for (ss, se, ah, al), data in scans:
        out += _segment(0xDA, bytes([1, 1, 0x00, ss, se, ah << 4 | al])) + data
    return out + b"\xff\xd9"


def _sequential(bits: str, blocks: int, **kw) -> bytes:
    return _grey(blocks, [((0, 63, 0, 0), _entropy(bits))], **kw)


def _pil(data: bytes) -> np.ndarray:
    from PIL import Image
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _equal_to_pil(data: bytes) -> np.ndarray:
    """The port's pixels, PIL blocked, equal PIL's; PIL must read the file."""
    want = _pil(data)
    got = _blocked(decode_texture, data)
    assert not isinstance(got, Exception), got
    assert got.shape == want.shape and np.array_equal(got, want)
    return got


def test_a_code_no_table_holds_reads_as_symbol_0_after_17_bits():
    """jpeg_huff_decode: a DC difference of 0, or an EOB, and decoding goes
    on with the bits after the 17."""
    bits = (_dc(40) + BAD + _dc(-25) + _ac(0, 30) + _ac(3, -7) + EOB
            + BAD + _ac(1, 12) + EOB + _dc(9) + BAD)
    _equal_to_pil(_sequential(bits, 3, q=4))


def test_runs_past_coefficient_63_land_at_63():
    """A sequential block's run past 63 writes its value at 63
    (jpeg_natural_order's extra entries), a ZRL past it writes nothing,
    and the next block starts after it."""
    bits = (_dc(10) + _ac(15, 5) * 4 + _dc(3) + _ac(15, -9) * 3 + ZRL + _dc(-4)
            + _ac(0, 2) * 60 + _ac(5, 33) + _dc(1) + EOB)
    _equal_to_pil(_sequential(bits, 4, q=3))


def test_a_progressive_run_past_se_writes_past_the_band():
    """An AC first pass over 1..5 whose run passes Se writes coefficient
    k all the same (and 63 past 63); the band's next block follows."""
    dc = _entropy(_dc(20) + _dc(-5) + _dc(7) + _dc(0))
    ac = _entropy(_ac(7, 3) + _ac(2, -2) + _ac(15, 4) + _ac(0, 1) + _ac(15, 6) + _ac(15, 5)
                  + _ac(15, 3) + _ac(15, 2) + EOB)
    rest = _entropy(EOB * 4)
    _equal_to_pil(_grey(4, [((0, 0, 0, 0), dc), ((1, 5, 0, 0), ac), ((6, 63, 0, 0), rest)],
                        progressive=True, q=2))


def _restarts(markers) -> bytes:
    """Eight one-block intervals (DRI 1), with `markers` after the first
    seven in place of RST0-RST6."""
    out = b""
    for k in range(8):
        out += _entropy(_dc(11 * (k + 1) - 40) + _ac(1, 9 - 2 * k) + EOB)
        if k < 7:
            out += markers[k]
    return _grey(8, [((0, 63, 0, 0), out)], dri=1, q=2)


RST = [bytes([0xFF, 0xD0 + (k & 7)]) for k in range(7)]
RESYNC = {
    "in_sequence": RST,
    "too_far_action_1": RST[:2] + [b"\xff\xd6"] + RST[3:],  # RST6 where RST2 is due
    "a_prior_one_action_2": RST[:3] + [b"\xff\xd1"] + RST[4:],  # RST1 where RST3 is due
    "a_low_marker_action_2": RST[:3] + [b"\xff\x05"] + RST[4:],
    "the_next_one_action_3": RST[:2] + [b"\xff\xd3"] + RST[3:],  # RST3 where RST2 is due
    "a_tem_action_2": RST[:1] + [b"\xff\x01"] + RST[2:],
    "all_shifted": [b"\xff" + bytes([0xD1 + k % 8]) for k in range(7)],
}


@pytest.mark.parametrize("kind", sorted(RESYNC))
def test_restart_markers_resynchronise_as_libjpeg_does(kind):
    """jpeg_resync_to_restart's three actions: discard the marker (one too
    far away), scan on to the next marker (a marker below 0xC0, or one of
    the two RSTns before), leave it (one of the next two RSTns, or a
    marker from 0xC0 on: the interval then has no data)."""
    _equal_to_pil(_restarts(RESYNC[kind]))


def test_an_rst_without_a_restart_interval_ends_the_scan_data():
    """DRI 0: an RSTn ends the entropy-coded data (the rest of the scan is
    left as it was), and after the scan libjpeg skips it and the bytes to
    the next marker."""
    first = _entropy(_dc(30) + _ac(0, 5) + EOB + _dc(-8) + EOB)
    rest = _entropy(_dc(12) + _ac(2, 3) + EOB + _dc(1) + EOB)
    _equal_to_pil(_grey(4, [((0, 63, 0, 0), first + b"\xff\xd3" + rest)], q=2))


def test_huffman_tables_0_and_1_left_undefined_are_the_standard_ones():
    """jinit_huff_decoder's std_huff_tables: a stream that leaves AC table
    1 (or every table) undefined decodes with the standard tables, which
    PIL's encoder wrote."""
    from PIL import Image
    rng = np.random.default_rng(5)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)).save(buf, "JPEG")
    data = buf.getvalue()
    parts, pos = [data[:2]], 2
    while data[pos + 1] != 0xDA:
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        parts.append(data[pos:end])
        pos = end
    parts.append(data[pos:])
    no_ac1 = b"".join(p for p in parts if not (p[1] == 0xC4 and p[4] == 0x11))
    no_dht = b"".join(p for p in parts if p[1] != 0xC4)
    assert len(no_ac1) < len(data) and len(no_dht) < len(no_ac1)
    want = _equal_to_pil(data)
    assert np.array_equal(_equal_to_pil(no_ac1), want)
    assert np.array_equal(_equal_to_pil(no_dht), want)


def test_a_symbol_listed_twice_keeps_both_its_codes():
    """jpeg_make_d_derived_tbl gives every position of a table its code:
    DC symbol 0 listed twice has the codes 00 and 01."""
    dc = ([0, 3, 1] + [0] * 13, [0, 0, 1, 2])
    codes = {"d0": "00", "d0'": "01", "d1": "10", "d2": "110"}
    bits = (codes["d2"] + "10" + EOB + codes["d0'"] + _ac(0, 4) + EOB + codes["d0"] + EOB
            + codes["d1"] + "0" + EOB + codes["d0'"] + EOB)
    _equal_to_pil(_sequential(bits, 5, q=5, dht=((0x00, dc), (0x10, _AC_LUMA))))


def test_a_refinement_out_of_order_is_read():
    """An AC refinement (Ah 1) of coefficients no scan sent, and an AC
    scan before any DC scan: jdphuff.c warns (JWRN_BOGUS_PROGRESSION) and
    decodes them."""
    refine = _entropy(AC[0x01] + "1" + AC[0x21] + "0" + EOB + AC[0x11] + "1" + EOB
                      + AC[0x01] + "0" + EOB + EOB)
    dc = _entropy(_dc(14) + _dc(-3) + _dc(6) + _dc(2))
    _equal_to_pil(_grey(4, [((1, 5, 1, 0), refine), ((0, 0, 0, 0), dc)], progressive=True,
                        q=6))


def test_a_refinement_of_size_2_reads_one_bit():
    """decode_mcu_AC_refine reads one bit for a new coefficient whatever
    its size (warning JWRN_HUFF_BAD_CODE for a size other than 1)."""
    dc = _entropy(_dc(5) + _dc(5) + _dc(-6))
    first = _entropy(_ac(0, 1) + EOB + _ac(1, -1) + EOB + EOB)
    # block 0: a size-2 symbol (run 0): the nonzero coefficient 1's
    # correction bit, then the new one at 2; block 1: a size-3 symbol (run
    # 1) past the nonzero 2; block 2: a size-2 ZRL-free run
    refine = _entropy(AC[0x02] + "1" + "1" + EOB + AC[0x13] + "0" + "0" + EOB
                      + AC[0x22] + "1" + EOB)
    _equal_to_pil(_grey(3, [((0, 0, 0, 0), dc), ((1, 5, 0, 1), first), ((1, 5, 1, 0), refine),
                            ((6, 63, 0, 0), _entropy(EOB * 3))], progressive=True, q=7))


def test_dc_values_wrap_at_16_bits():
    """libjpeg keeps the DC prediction in an int and stores each DC as a
    16-bit JCOEF; the SIMD inverse DCT then wraps and saturates its 16-bit
    sums (q 9 takes the products far past them)."""
    bits = (_dc(2047) + EOB) * 40 + (_dc(-2047) + _ac(0, 900) + EOB) * 8
    _equal_to_pil(_sequential(bits, 48, q=9))


def test_every_zig_zag_coefficient_far_out_of_range():
    """Coefficients up to 1023 under tables of 1 and 200 in random
    positions: the 16-bit dequantisation, the DC-only columns' 16-bit
    shift and the wrapping sums of the SIMD inverse DCT
    (utils/image_decode._idct)."""
    rng = np.random.default_rng(11)
    bits = ""
    for _ in range(24):
        bits += _dc(int(rng.integers(-300, 300)))
        k = 1
        while rng.random() < 0.7:
            run = int(rng.integers(0, 16))
            if k + run > 63:
                break
            bits += _ac(run, int(rng.integers(1, 1024)) * int(rng.choice([-1, 1])))
            k += run + 1
        bits += EOB if k <= 63 else ""
    for q in (1, 200):
        _equal_to_pil(_sequential(bits, 24, q=q))


# --- a scene ----------------------------------------------------------------------------

SCENE_CASES = (("baseline.jpg", 12), ("baseline.jpg", 16))  # a bad code; RST7 out of order


def test_scene_with_damaged_textures_matches_jax(tmp_path):
    """A DSL scene whose textures are two damaged files of the sweep (a
    byte that makes a code no table holds; an RST7 out of sequence),
    through the JAX package's build_scene (PIL) and the port's: every
    texture array exact."""
    from relativitypathtracer_tpu import build_scene as jbuild
    from relativitypathtracer_tpu.models.dsl import parse_scene as jparse

    names = []
    for name, i in SCENE_CASES:
        data = (FIXTURES / name).read_bytes()
        assert isinstance(SWEEP[name][i][3], dict)
        names.append(f"damaged_{i}_{name}")
        (tmp_path / names[-1]).write_bytes(damaged(data, damaged_cases(name, data)[i]))
    objects = [f"Os\n p{k - 1},0,7,0,0,1,0,0.6,0.6,0.6\n t{k}\n" for k in range(len(names))]
    text = "".join(f"T{name}\n" for name in names) + "".join(objects) + "R\n"
    js, _ = jbuild(jparse(text, str(tmp_path)))
    ps, _ = pt.build_scene(pt.parse_scene(text, str(tmp_path)), device="cpu")
    for path in ("textures", "tex_quads", "objects.tex_offset", "objects.tex_w",
                 "objects.tex_h"):
        want, got = js, ps
        for part in path.split("."):
            want, got = getattr(want, part), getattr(got, part)
        assert np.array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64)), path
