"""The whole port: its frames against the JAX package's render_frame.

The three demo fixtures (utils/demo_scene) at 64x64, interval -1, for two
camera states (at rest, and moving at 0.5c at a later time): "blob" (one
untextured 1,280-triangle mesh at subdivision level 3, one light sphere),
"textured" (the same mesh with a 32x32 texture, a small atlas: K2) and
"cubes" (nine cubes, eight sharing a 256x256 texture, a MID atlas: K8, and
analytic occluders: K7). Also interval 0 (no light propagation: ambient 1,
no shadow rays) on the three, msaa 2 and 4, and the packed-atlas route. The JAX
frame comes from its Pallas kernels in interpret mode and from its jnp path;
the port's from its plain twins on the CPU. Parity rule of utils/parity.py:
at most 0.2% of pixels off by more than 1e-3. The hits and shadow_rays
counts must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import build_both, jax_frame, port_frame, write_fixture

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch import render as prender

W = H = 64
STATES = {
    "rest": ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 0.0)),
    "boosted": ((0.3, 0.0, 0.4), (0.7, 0.0, 0.0, 0.0)),
}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return build_both(write_fixture(tmp_path_factory, 3))


@pytest.fixture(scope="module")
def textured(tmp_path_factory):
    return build_both(write_fixture(tmp_path_factory, 3, "textured"))


@pytest.fixture(scope="module")
def cubes(tmp_path_factory):
    return build_both(write_fixture(tmp_path_factory, 3, "cubes"))


def _assert_parity(got, want, paux, jaux, shape=(H, W, 3), slack=0):
    """Parity rule, equal hits, and shadow_rays within `slack` lanes."""
    assert got.shape == want.shape == shape and np.isfinite(got).all()
    diff = np.abs(got - want).max(axis=-1)
    assert float(np.mean(diff > 1e-3)) <= 0.002, f"{np.mean(diff > 1e-3):.4%} pixels off"
    assert paux["hits"] == jaux["hits"]
    assert abs(paux["shadow_rays"] - jaux["shadow_rays"]) <= slack, (paux, jaux)


def _slack(kind, aux):
    """Shadow-ray count slack: 0, except on the cube fixture, where a lane at
    a cube's edge takes one face or the other by the last bit of a product.
    There the JAX package's own eager shade() and its jitted frame (which
    contracts FMAs) differ by one shadow ray at rest, so the port is held to
    0.1% of the hit lanes."""
    return aux["hits"] // 1000 if kind == "cubes" else 0


@pytest.mark.parametrize("mode", ["interpret", False], ids=["pallas_interpret", "jnp"])
@pytest.mark.parametrize("state", list(STATES))
def test_port_frame_matches_jax(scenes, mode, state):
    (js, jm), (ps, pm) = scenes
    want, jaux = jax_frame(js, jm, STATES[state], mode)
    got, paux = port_frame(ps, pm, STATES[state])
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    diff = np.abs(got - want).max(axis=-1)
    assert float(np.mean(diff > 1e-3)) <= 0.002, f"{np.mean(diff > 1e-3):.4%} pixels off"
    assert paux["hits"] == jaux["hits"] > 200
    assert paux["shadow_rays"] == jaux["shadow_rays"] > 50
    assert 0 < paux["lit_rays"] < paux["shadow_rays"]  # lit and occluded lanes both occur


def test_untextured_scene_discards_the_texel_fetch(scenes, monkeypatch):
    """The JAX package runs its small-atlas fetch (K2) on an untextured scene
    and keeps the flat colour on every lane: replacing the fetch's result by
    garbage leaves its frame bit-identical. So the port, which skips the
    fetch, renders the same frame (test_port_frame_matches_jax)."""
    from relativitypathtracer_tpu.ops.pallas import texture_kernel

    (js, jm), _ = scenes
    assert jm.mesh_ids and np.all(np.asarray(js.objects.tex_offset) == -1)
    base, _ = jax_frame(js, jm, STATES["rest"], "interpret")
    calls = []

    def garbage(quads, fp, w, h, uv, interpret=False):
        calls.append(uv.shape)
        return jnp.full((3, uv.shape[1]), 7.0, jnp.float32)

    monkeypatch.setattr(texture_kernel, "footprint_sample_small", garbage)
    stubbed, _ = jax_frame(js, jm, STATES["rest"], "interpret")
    assert calls, "the JAX frame did not reach the small-atlas fetch"
    assert np.array_equal(stubbed, base)


@pytest.mark.parametrize("mode", ["interpret", False], ids=["pallas_interpret", "jnp"])
@pytest.mark.parametrize("state", list(STATES))
@pytest.mark.parametrize("kind", ["textured", "cubes"])
def test_textured_fixture_frame_matches_jax(request, kind, mode, state):
    """The textured fixtures: the JAX frame through K2 (textured) or K8 and
    K7 (cubes) in interpret mode, or through its jnp gather and analytic
    loops; the port's through the plain twins of its CUDA kernels."""
    (js, jm), (ps, pm) = request.getfixturevalue(kind)
    want, jaux = jax_frame(js, jm, STATES[state], mode)
    got, paux = port_frame(ps, pm, STATES[state])
    _assert_parity(got, want, paux, jaux, slack=_slack(kind, jaux))
    assert paux["hits"] > 200 and 0 < paux["lit_rays"] < paux["shadow_rays"]


@pytest.mark.parametrize("mode", ["interpret", False], ids=["pallas_interpret", "jnp"])
@pytest.mark.parametrize("state", list(STATES))
@pytest.mark.parametrize("kind", ["blob", "textured", "cubes"])
def test_interval0_frame_matches_jax(request, kind, mode, state):
    """Interval 0 (the DSL's `I`, the viewer's 'i'): no light propagation,
    ambient 1 and no shadow ray, so no shadow chain (K1), no occlusion walk
    (K6, K7) and no shadow list build. The parity rule, equal hits, and 0
    shadow and lit rays on both sides."""
    (js, jm), (ps, pm) = request.getfixturevalue("scenes" if kind == "blob" else kind)
    want, jaux = jax_frame(js, jm, STATES[state], mode, interval=0)
    got, paux = port_frame(ps, pm, STATES[state], interval=0)
    _assert_parity(got, want, paux, jaux)
    assert paux["hits"] > 200
    assert paux["shadow_rays"] == paux["lit_rays"] == jaux["shadow_rays"] == 0
    lit, _ = port_frame(ps, pm, STATES[state])
    assert not np.array_equal(lit, got)


def test_fixture_atlases_and_routes(textured, cubes):
    """textured: one 512-row atlas (K2's tier); cubes: 32,768 rows (K8's) and
    nine analytic occluders for the light, so both JAX walks are culled."""
    from relativitypathtracer_tpu.ops.pallas import texture_kernel as jtk
    from relativitypathtracer_tpu_torch.ops.kernels import texture_kernel as ptk
    from relativitypathtracer_tpu_torch.ops.texture_layout import texture_table

    (js, _), (ps, pm) = textured
    assert tuple(ps.tex_quads.shape) == (512, 8) and pm.textured_ids == (0,)
    assert torch.equal(ps.tex_table,
                       texture_table(ps.objects.tex_w, ps.objects.tex_h, ps.tex_fp))
    assert ptk.texture_route(512) == jtk.texture_route(512, True) == "small"
    assert np.array_equal(ps.tex_quads.numpy(), np.asarray(js.tex_quads).astype(np.int64))
    (js, _), (ps, pm) = cubes
    assert tuple(ps.tex_quads.shape) == (32768, 8) and pm.textured_ids == tuple(range(1, 9))
    assert ptk.texture_route(32768) == jtk.texture_route(32768, True) == "windowed"
    assert pm.cube_ids == tuple(range(9)) and pm.sphere_ids == pm.light_ids == (9,)
    assert pm.mesh_ids == () and pm.use_footprint_tex


@pytest.mark.parametrize("msaa, size", [(2, (32, 32)), (4, (32, 24))], ids=["msaa2", "msaa4"])
def test_msaa2_frame_matches_jax(textured, msaa, size):
    """msaa 2 at 32x32 and msaa 4 at 32x24 (bench.py's bunny_msaa4): msaa^2
    sample sets averaged, counts summed; the parity rule, equal counts."""
    (js, jm), (ps, pm) = textured
    want, jaux = jax_frame(js, jm, STATES["boosted"], False, size, msaa)
    got, paux = port_frame(ps, pm, STATES["boosted"], size, msaa)
    _assert_parity(got, want, paux, jaux, (size[1], size[0], 3))
    one, oaux = port_frame(ps, pm, STATES["boosted"], size, 1)
    assert paux["hits"] > msaa * msaa // 2 * oaux["hits"] and not np.array_equal(one, got)


@pytest.mark.parametrize("kind", ["textured", "cubes"])
def test_packed_route_matches_jax(request, kind):
    """use_footprint_tex=False on both sides forces the packed-atlas route
    (the JAX package takes it for footprint atlases over 48 MB)."""
    (js, jm), (ps, pm) = request.getfixturevalue(kind)
    assert int(np.asarray(js.objects.tex_offset).max()) < 2 ** 24
    jm = dataclasses.replace(jm, use_footprint_tex=False)
    pm = dataclasses.replace(pm, use_footprint_tex=False)
    want, jaux = jax_frame(js, jm, STATES["rest"], False)
    got, paux = port_frame(ps, pm, STATES["rest"])
    _assert_parity(got, want, paux, jaux, slack=_slack(kind, jaux))


def test_textured_objects_wait_for_k2(textured, monkeypatch):
    """Textured objects, once refused, now take the footprint fetch (K2's
    route) with the per-object table and, for its flat-colour select, the
    objects' colours and textured flags, and the result reaches the frame."""
    from relativitypathtracer_tpu_torch.ops.kernels import texture_kernel as ptk

    _, (ps, pm) = textured
    calls = []
    real = prender.footprint_fetch

    def spy(quads, table, obj, uv, color, textured):
        calls.append((ptk.texture_route(quads.shape[0]), tuple(table.shape)))
        assert color is ps.objects.color and textured is ps.tex_textured
        return real(quads, table, obj, uv, color, textured)

    monkeypatch.setattr(prender, "footprint_fetch", spy)
    base, _ = port_frame(ps, pm, STATES["rest"], (32, 32))
    assert calls == [("small", (2, ptk.TABLE_COLS))]
    monkeypatch.setattr(prender, "footprint_fetch", lambda *a: torch.zeros((3, a[3].shape[1])))
    dark, _ = port_frame(ps, pm, STATES["rest"], (32, 32))
    assert not np.array_equal(base, dark)


def test_analytic_occluders_wait_for_k7(cubes, monkeypatch):
    """Analytic occluders, once refused, now go through K7 with the light's
    params row left out; its twin's result bounds the shadow rays."""
    _, (ps, pm) = cubes
    calls = []
    real = prender.analytic_min_t_general

    def spy(params, o4, d4, n_spheres, n_cubes, tmax):
        calls.append((tuple(params.shape), n_spheres, n_cubes))
        return real(params, o4, d4, n_spheres, n_cubes, tmax)

    monkeypatch.setattr(prender, "analytic_min_t_general", spy)
    _, aux = port_frame(ps, pm, STATES["rest"], (32, 32))
    assert calls == [((9, 32), 0, 9)]
    assert 0 < aux["lit_rays"] < aux["shadow_rays"]


def test_unported_routes_raise(scenes, tmp_path):
    """The routes once refused now build and render: a scene with the blob
    twice gets the fused pool of K9/K10, and a mesh of T_pad > 24,576 the
    large tier's rows (K11/K12)."""
    from relativitypathtracer_tpu_torch.models.scene import _mesh_static
    from relativitypathtracer_tpu_torch.utils.demo_scene import _BLOB_OBJECT, write_demo_scene

    _, (ps, _) = scenes
    path = write_demo_scene(str(tmp_path), 2)
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:  # a second instance, left of the first
        f.write(text.replace(_BLOB_OBJECT, _BLOB_OBJECT + _BLOB_OBJECT.replace(" p1,", " p-0.6,")))
    two, meta = pt.build_scene(pt.load_scene_file(path), device="cpu")
    assert len(meta.mesh_ids) == 2 and two.mesh_batch is not None
    img, aux = port_frame(two, meta, STATES["rest"], (32, 32))
    one, one_meta = pt.build_scene(pt.load_scene_file(write_demo_scene(str(tmp_path / "one"), 2)),
                                   device="cpu")
    _, one_aux = port_frame(one, one_meta, STATES["rest"], (32, 32))
    assert np.isfinite(img).all() and aux["hits"] > one_aux["hits"]

    big = _mesh_static(ps.mesh, tuple(i % 1280 for i in range(30000)))
    assert big.gen_rec is not None and big.gen_rec.shape == (30208, 20)


def test_render_frame_entry_point(scenes):
    _, (ps, pm) = scenes
    img = pt.render_frame(ps, pm, pt.FrameState.initial("cpu"), 32, 32, device="cpu")
    assert img.shape == (32, 32, 3) and bool(torch.isfinite(img).all())


def test_entry_points_default_to_the_card():
    """Every entry point runs on the card unless its caller names the CPU."""
    import inspect

    from relativitypathtracer_tpu_torch.device import DEFAULT_DEVICE
    from relativitypathtracer_tpu_torch.ops.camera import camera_ray_dirs

    assert DEFAULT_DEVICE == "cuda"
    for fn in (pt.build_scene, pt.scene_from_numpy, pt.FrameState.initial, pt.build_render_fn,
               pt.render_frame, camera_ray_dirs):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


@pytest.mark.parametrize("raises", [False, True], ids=["frame", "frame_that_raises"])
def test_full_precision_is_scoped_to_the_frame(scenes, raises, monkeypatch):
    """TF32 is off for matmuls and cuDNN inside a frame only: a caller that
    allows it finds both flags as it set them after building the renderer and
    after a frame, also a frame that raises."""
    _, (ps, pm) = scenes
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    seen = []
    real = prender.object_frames

    def spy(*a):
        seen.append([f.allow_tf32 for f in flags])
        if raises:
            raise RuntimeError("frame failed")
        return real(*a)

    try:
        for f in flags:
            f.allow_tf32 = True
        render = prender.build_render_fn(pm, 32, 32, -1, device="cpu")
        assert [f.allow_tf32 for f in flags] == [True, True]
        monkeypatch.setattr(prender, "object_frames", spy)
        state = prender.FrameState.initial(device="cpu")
        if raises:
            with pytest.raises(RuntimeError, match="frame failed"):
                render(ps, state)
        else:
            assert render(ps, state).shape == (32, 32, 3)
        assert seen == [[False, False]]
        assert [f.allow_tf32 for f in flags] == [True, True]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
