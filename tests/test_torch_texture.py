"""The port's texture path against the JAX package: PPM decoding, footprint
addressing, the footprint fetch (K2/K8's plain twin) on every atlas tier,
with and without the renderer's flat-colour select, its channel values, the
packed-atlas route, and the routing divergence for BIG atlases.

Tolerances. Addresses (atlas row and half) are integers and must be equal.
RGB within 1e-5, the JAX package's own tolerance for its texture kernels
(tests/test_pallas_interpret.py): XLA on the CPU may contract the bilinear
weights' products into FMAs, the port rounds each product (as the card does
under -fmad=false), so the last bits of a weight may differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import t

from relativitypathtracer_tpu.ops import texture_layout as jlayout
from relativitypathtracer_tpu.ops import texture_sample as jts
from relativitypathtracer_tpu.ops.pallas import texture_kernel as jtk
from relativitypathtracer_tpu_torch.models.texture import read_texture, write_ppm
from relativitypathtracer_tpu_torch.ops import texture_layout as ptl
from relativitypathtracer_tpu_torch.ops import texture_sample as pts
from relativitypathtracer_tpu_torch.ops.kernels import texture_kernel as ptk
from relativitypathtracer_tpu_torch.utils.image_decode import DecodeError
from relativitypathtracer_tpu_torch.utils.raster_decode import decode_pnm


def _atlas_inputs(seed, w, h, n, edges=True):
    """Random footprint atlas covering one w x h region, per-lane 6-row fp,
    sizes and uvs (some at the clamp edges u = 1, v = 0 and exactly 0/1)."""
    rng = np.random.default_rng(seed)
    wb = -(-w // 16)
    rows = int(jlayout.region_quads(np.int64(wb), np.int64(h))) * 4 // 8
    quads = rng.integers(0, 2 ** 24, (rows, 8), dtype=np.uint32)
    fp = np.ascontiguousarray(np.broadcast_to(
        np.array([0, 0, 0, wb, w, h], np.int32)[:, None], (6, n)))
    wa = np.full((n,), w, np.int32)
    ha = np.full((n,), h, np.int32)
    uv = rng.random((2, n)).astype(np.float32)
    if edges:
        uv[0, :256] = 0.999
        uv[1, 256:512] = 0.001
        uv[:, 512:520] = [[0, 1, 0, 1, 0.5, 0.5, 0, 1], [0, 0, 1, 1, 0, 1, 0.5, 0.5]]
    return quads, fp, wa, ha, uv


def _nine(fp6):
    sm1, ss, r16 = jlayout.tile_params(fp6[3].astype(np.int64), fp6[5].astype(np.int64))
    return np.concatenate([fp6, np.stack([sm1, ss, r16]).astype(np.int32)])


def _port_args(quads, fp, wa, ha, uv):
    return t(quads.astype(np.int32)), t(fp), t(wa), t(ha), t(uv)


@pytest.mark.parametrize("rows9", [False, True], ids=["fp6", "fp9"])
def test_address_lanes_equal_jax(rows9):
    """Row and half of every lane bit for bit; the bilinear ratios to 1 ulp."""
    quads, fp, wa, ha, uv = _atlas_inputs(1, 48, 224, 4096)
    fp = _nine(fp) if rows9 else fp
    ji, jf = (np.asarray(a) for a in jtk._address_lanes(quads.shape[0], jnp.asarray(fp),
                                                         jnp.asarray(wa), jnp.asarray(ha),
                                                         jnp.asarray(uv)))
    pi, pf = ptk._address_lanes(quads.shape[0], t(fp), t(wa), t(ha), t(uv))
    assert np.array_equal(pi.numpy(), ji)
    np.testing.assert_allclose(pf.numpy(), jf, rtol=0, atol=1e-5)


def test_footprint_fetch_matches_small_interpret_kernel():
    """A 32x48 region (384 rows, at most MAX_ROWS): K2's interpret kernel."""
    quads, fp, wa, ha, uv = _atlas_inputs(5, 32, 48, 4096)
    assert quads.shape[0] <= jtk.MAX_ROWS
    want = np.asarray(jtk.footprint_sample_small(
        jnp.asarray(quads), jnp.asarray(_nine(fp)), jnp.asarray(wa), jnp.asarray(ha),
        jnp.asarray(uv), interpret=True))
    got = ptk.footprint_sample_small(*_port_args(quads, _nine(fp), wa, ha, uv)).numpy()
    assert np.abs(got - want).max() < 1e-5


def test_footprint_fetch_matches_windowed_interpret_kernel():
    """A 224x240 region (26,880 rows: a MID atlas spanning many 1024-row
    windows), with coherent and scattered blocks: K8's interpret kernel."""
    quads, fp, wa, ha, uv = _atlas_inputs(3, 224, 240, 4096)
    uv[:, 1024:2048] = 0.02 + 0.03 * np.random.default_rng(4).random((2, 1024))
    assert 3 * jtk.W_ROWS < quads.shape[0] <= jtk.WINDOWED_MID_CAP
    want = np.asarray(jtk.footprint_sample_windowed(
        jnp.asarray(quads), jnp.asarray(fp), jnp.asarray(wa), jnp.asarray(ha),
        jnp.asarray(uv), interpret=True))
    got = ptk.footprint_sample_windowed(*_port_args(quads, fp, wa, ha, uv)).numpy()
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("rows9", [False, True], ids=["fp6", "fp9"])
def test_footprint_fetch_matches_gather_on_a_big_atlas(rows9):
    """A 1024x640 region (163,840 rows, over the 65,536-row MID cap, where
    the JAX package takes its XLA gather): the port's fetch equals it."""
    quads, fp, wa, ha, uv = _atlas_inputs(9, 1024, 640, 8192)
    assert quads.shape[0] > jtk.WINDOWED_MID_CAP
    fp = _nine(fp) if rows9 else fp
    want = np.asarray(jts.bilinear_sample_footprint(
        jnp.asarray(quads), jnp.asarray(fp), jnp.asarray(wa), jnp.asarray(ha), jnp.asarray(uv)))
    args = _port_args(quads, fp, wa, ha, uv)
    got = ptk.footprint_sample_windowed(*args).numpy()
    assert np.abs(got - want).max() < 1e-5
    assert np.array_equal(pts.bilinear_sample_footprint(*args).numpy(), got)


def test_texture_route_sends_big_atlases_to_the_kernel():
    """Deliberate divergence: the JAX package gathers BIG footprint atlases
    with XLA (its windowed TPU kernel lost there); the port's one CUDA kernel
    serves every size. Small and MID atlases route as in the JAX package."""
    for rq in (1, jtk.MAX_ROWS, jtk.MAX_ROWS + 1, jtk.WINDOWED_MID_CAP):
        assert ptk.texture_route(rq) == jtk.texture_route(rq, True)
    big = jtk.WINDOWED_MID_CAP + 1
    assert jtk.texture_route(big, True) == "gather"
    assert ptk.texture_route(big) == "windowed"


def test_per_object_table_equals_per_lane_fetch():
    """The renderer's form (per-object table selected in the fetch by each
    lane's object id) against the per-lane form, bit for bit, with the
    quad each lane read."""
    rng = np.random.default_rng(8)
    quads, fp, wa, ha, uv = _atlas_inputs(2, 96, 64, 2048)
    quads = t(quads.astype(np.int32))
    tex_fp = t(np.array([[0, 0, 0, 6, 96, 64], [0, 0, 0, 0, 0, 0], [40, 3, 5, 2, 20, 30]],
                        np.int32))
    tex_w, tex_h = t(np.array([96, 0, 50], np.int32)), t(np.array([64, -1, 40], np.int32))
    table = ptl.texture_table(tex_w, tex_h, tex_fp)
    assert table.dtype == torch.int32 and tuple(table.shape) == (3, ptl.TABLE_COLS)
    assert table[1, :2].tolist() == [1, 1]  # clamped sizes
    obj = t(rng.integers(0, 3, uv.shape[1]).astype(np.int32))
    got, quad = ptk.footprint_fetch(quads, table, obj, t(uv), with_quads=True)
    sel = table[obj.long()].T
    want = ptk.footprint_sample_small(quads, sel[2:], sel[0], sel[1], t(uv))
    assert torch.equal(got, want)
    ai, _ = ptk._address_lanes(quads.shape[0], sel[2:], sel[0], sel[1], t(uv))
    assert torch.equal(quad, ai[0] * 2 + ai[1])


def _mixed_objects(rng, w, h, n):
    """Four objects on one w x h atlas region, one of them untextured (as
    the renderer's scenes have them: zero region, sizes 0), with random flat
    colours, and n lanes on them. Returns numpy (tex_w, tex_h, tex_fp,
    color, textured, obj)."""
    wb = -(-w // 16)
    tex_fp = np.array([[0, 0, 0, wb, w, h], [0, 0, 0, 0, 0, 0], [0, 3, 5, wb, w - 7, h - 9],
                       [0, w // 2, 0, wb, w - w // 2, h]], np.int32)
    tex_w = np.array([w, 0, w, w], np.int32)
    tex_h = np.array([h, 0, h, h], np.int32)
    color = rng.random((4, 3)).astype(np.float32)
    textured = np.array([True, False, True, True])
    obj = rng.integers(0, 4, n).astype(np.int32)
    return tex_w, tex_h, tex_fp, color, textured, obj


@pytest.mark.parametrize("tier", ["small", "windowed"])
def test_footprint_select_matches_jax_frame_select(tier):
    """The fetch with the flat-colour select (K2/K8's twin, the renderer's
    form) against the JAX frame's `jnp.where(textured, tex_rgb, flat_rgb)`
    over its per-lane kernel in interpret mode, on a scene that mixes
    textured and untextured objects: texels within 1e-5, flat colours
    exact."""
    w, h = (32, 48) if tier == "small" else (224, 240)
    quads, _, _, _, uv = _atlas_inputs(30 + w, w, h, 4096)
    rng = np.random.default_rng(w)
    tex_w, tex_h, tex_fp, color, textured, obj = _mixed_objects(rng, w, h, 4096)
    fp, wa, ha = tex_fp[obj].T.copy(), tex_w[obj], tex_h[obj]
    sample = jtk.footprint_sample_small if tier == "small" else jtk.footprint_sample_windowed
    assert ptk.texture_route(quads.shape[0]) == tier
    tex_rgb = sample(jnp.asarray(quads), jnp.asarray(fp), jnp.asarray(wa), jnp.asarray(ha),
                     jnp.asarray(uv), interpret=True)
    want = np.asarray(jnp.where(jnp.asarray(textured[obj])[None, :], tex_rgb,
                                jnp.asarray(color[obj].T)))
    table = ptl.texture_table(t(tex_w), t(tex_h), t(tex_fp))
    got = ptk.footprint_fetch(t(quads.astype(np.int32)), table, t(obj), t(uv), t(color),
                              t(textured)).numpy()
    flat = ~textured[obj]
    assert flat.any() and (~flat).any()
    assert np.array_equal(got[:, flat], color[obj[flat]].T)
    assert np.abs(got - want).max() < 1e-5
    plain = ptk.footprint_fetch(t(quads.astype(np.int32)), table, t(obj), t(uv)).numpy()
    assert np.array_equal(got[:, ~flat], plain[:, ~flat])


def test_twin_channel_values_equal_numpy_division():
    """Each of the 256 channel values the twin weights equals numpy's
    float32 k / 255 (a texel read at ratios 0 is its first tap's channels)."""
    k = np.arange(256, dtype=np.int64)
    quads = np.zeros((128, 8), np.int64)
    quads.reshape(-1, 4)[:, 0] = k | ((255 - k) << 8) | (((k * 7) % 256) << 16)
    addr_i = t(np.stack([k // 2, k % 2]).astype(np.int32))
    rgb = ptk._fetch_mix(t(quads.astype(np.int32)), addr_i, torch.zeros((2, 256))).numpy()
    want = np.float32(255.0)
    assert np.array_equal(ptk.CHANNEL, k.astype(np.float32) / want)
    for ch, vals in enumerate((k, 255 - k, (k * 7) % 256)):
        assert np.array_equal(rgb[ch], vals.astype(np.float32) / want)


def _round_f32(x) -> np.float32:
    """An exact rational rounded to the nearest float32, ties to even."""
    from fractions import Fraction

    if x == 0:
        return np.float32(0.0)
    f = np.float32(float(x))
    cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x), int(c.view(np.uint32)) & 1))


def test_kernel_channel_formula_is_exact():
    """The CUDA kernel's channel (csrc/texture_kernels.cu `channel`):
    q = k * RN(1/255), then fma(fma(-q, 255, k), RN(1/255), q), each step
    rounded once, evaluated here in exact rationals, equals float32 k / 255
    for every k; the product alone does not."""
    from fractions import Fraction as F

    inv = F(float(np.float32(1.0) / np.float32(255.0)))
    off = 0
    for k in range(256):
        q = F(float(_round_f32(k * inv)))
        r = F(float(_round_f32(k - q * 255)))
        got = _round_f32(q + r * inv)
        assert got == ptk.CHANNEL[k], k
        off += float(q) != ptk.CHANNEL[k]
    assert off > 0


def test_scene_textured_flags_follow_tex_offset(tmp_path):
    """The fetch's per-object textured flag, made once per scene, is
    tex_offset != -1 through build_scene and scene_from_numpy alike."""
    import jax
    from PIL import Image

    from relativitypathtracer_tpu import build_scene as jbuild
    from relativitypathtracer_tpu.models.dsl import parse_scene as jparse
    import relativitypathtracer_tpu_torch as pt

    rng = np.random.default_rng(22)
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(tmp_path / "a.png")
    text = ("Ta.png\nOs\n p0,0,5,0,0,1,0,1,1,1\n t0\nOc\n p2,0,6,0.3,0,1,0,1,1,1\n"
            "Oc\n p-2,0,6,0,0,1,0,1,1,1\n t0\nR\n")
    js, _ = jbuild(jparse(text, str(tmp_path)))
    want = np.asarray(js.objects.tex_offset) != -1
    assert want.tolist() == [True, False, True]
    ps, _ = pt.build_scene(pt.parse_scene(text, str(tmp_path)), device="cpu")
    carried = pt.scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    for scene in (ps, carried):
        assert scene.tex_textured.dtype == torch.bool
        assert np.array_equal(scene.tex_textured.numpy(), want)


def test_packed_sample_matches_jax():
    """Two textures in one packed atlas, lanes on either, offsets < 2^24."""
    rng = np.random.default_rng(12)
    atlas = rng.integers(0, 2 ** 24, (700, 8), dtype=np.uint32)
    n = 4096
    which = rng.integers(0, 2, n)
    off = np.where(which, 37 * 21, 0).astype(np.int32)
    w = np.where(which, 16, 37).astype(np.int32)
    h = np.where(which, 40, 21).astype(np.int32)
    uv = rng.random((2, n)).astype(np.float32)
    uv[0, :128] = 1.0
    uv[1, 128:256] = 0.0
    want = np.asarray(jts.bilinear_sample_packed(jnp.asarray(atlas), jnp.asarray(off),
                                                 jnp.asarray(w), jnp.asarray(h),
                                                 jnp.asarray(uv)))
    got = pts.bilinear_sample_packed(t(atlas.astype(np.int32)), t(off), t(w), t(h),
                                     t(uv)).numpy()
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("header", [b"P6\n{w} {h}\n255\n",
                                    b"P6 # made by a test\n{w}\n# x\n{h} 255\n",
                                    b"P6\t{w}  {h}\n255\n"], ids=["plain", "comments", "spaces"])
def test_ppm_decoder_matches_pil(tmp_path, header):
    from PIL import Image

    rng = np.random.default_rng(len(header))
    h, w = 13, 29
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    path = tmp_path / "t.ppm"
    path.write_bytes(header.replace(b"{w}", str(w).encode()).replace(b"{h}", str(h).encode())
                     + rgb.tobytes())
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    got = decode_pnm(path.read_bytes())
    assert np.array_equal(got, want) and np.array_equal(got, rgb)
    atlas, values = bytearray(b"xyz"), []
    read_texture(str(path), atlas, values)
    assert values == [3, w, h] and bytes(atlas[3:]) == rgb.tobytes()


def test_ppm_writer_round_trip_and_other_formats_go_to_their_decoders(tmp_path, monkeypatch):
    """A PPM round trip, and a PNG told by its first bytes and decoded by
    utils/image_decode.decode_png (not PIL) to PIL's pixels."""
    from PIL import Image

    from relativitypathtracer_tpu_torch.models import texture

    rgb = np.random.default_rng(0).integers(0, 256, (7, 5, 3), dtype=np.uint8)
    write_ppm(str(tmp_path / "a.ppm"), rgb)
    assert np.array_equal(decode_pnm((tmp_path / "a.ppm").read_bytes()), rgb)
    Image.fromarray(rgb).save(tmp_path / "a.png")
    with pytest.raises(DecodeError):
        decode_pnm((tmp_path / "a.png").read_bytes())
    calls = []
    real = texture.decode_png
    monkeypatch.setattr(texture, "decode_png", lambda data: calls.append(data) or real(data))
    atlas, values = bytearray(), []
    read_texture(str(tmp_path / "a.png"), atlas, values)
    assert values == [0, 5, 7] and bytes(atlas) == rgb.tobytes()
    assert calls == [(tmp_path / "a.png").read_bytes()]
