"""The whole slice: the port's frame against the JAX package's render_frame.

The fixture at subdivision level 3 (1,280 triangles, one light sphere) at
64x64, interval -1, for two camera states (at rest, and moving at 0.5c at a
later time). The JAX frame comes from its Pallas kernels in interpret mode
and from its jnp path; the port's from its plain twins on the CPU. Parity
rule of utils/parity.py: at most 0.2% of pixels off by more than 1e-3.
The hits and shadow_rays counts must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import build_both, write_fixture

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu import render as jrender
from relativitypathtracer_tpu.ops import mesh_intersect as jmi
from relativitypathtracer_tpu_torch import render as prender

W = H = 64
STATES = {
    "rest": ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 0.0)),
    "boosted": ((0.3, 0.0, 0.4), (0.7, 0.0, 0.0, 0.0)),
}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return build_both(write_fixture(tmp_path_factory, 3))


def _jax_frame(js, jm, mode, state):
    """JAX frame and aux with the kernel routing forced to `mode`, caches
    cleared on both sides (as conftest.render_with_mode does)."""
    jmi.PALLAS_MODE = mode
    jrender.build_render_fn.cache_clear()
    try:
        fn = jrender.build_render_fn(jm, W, H, -1, 1, True)
        img, aux = fn(js, jrender.FrameState(jnp.asarray(state[0], jnp.float32),
                                             jnp.asarray(state[1], jnp.float32)))
        return np.asarray(img), {k: int(v) for k, v in aux.items()}
    finally:
        jmi.PALLAS_MODE = None
        jrender.build_render_fn.cache_clear()


def _port_frame(ps, pm, state):
    fn = prender.build_render_fn(pm, W, H, -1, with_aux=True)
    img, aux = fn(ps, prender.FrameState(torch.tensor(state[0]), torch.tensor(state[1])))
    return img.numpy(), {k: int(v) for k, v in aux.items()}


@pytest.mark.parametrize("mode", ["interpret", False], ids=["pallas_interpret", "jnp"])
@pytest.mark.parametrize("state", list(STATES))
def test_port_frame_matches_jax(scenes, mode, state):
    (js, jm), (ps, pm) = scenes
    want, jaux = _jax_frame(js, jm, mode, STATES[state])
    got, paux = _port_frame(ps, pm, STATES[state])
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
    base, _ = _jax_frame(js, jm, "interpret", STATES["rest"])
    calls = []

    def garbage(quads, fp, w, h, uv, interpret=False):
        calls.append(uv.shape)
        return jnp.full((3, uv.shape[1]), 7.0, jnp.float32)

    monkeypatch.setattr(texture_kernel, "footprint_sample_small", garbage)
    stubbed, _ = _jax_frame(js, jm, "interpret", STATES["rest"])
    assert calls, "the JAX frame did not reach the small-atlas fetch"
    assert np.array_equal(stubbed, base)


def test_textured_objects_wait_for_k2(scenes):
    _, (ps, pm) = scenes
    meta = dataclasses.replace(pm, textured_ids=(0,))
    fn = prender.build_render_fn(meta, 32, 32, -1)
    with pytest.raises(NotImplementedError, match="K2"):
        fn(ps, prender.FrameState.initial())


def test_analytic_occluders_wait_for_k7(scenes):
    """A second sphere would occlude the light: its shadow test is K7."""
    _, (ps, pm) = scenes
    meta = dataclasses.replace(pm, sphere_ids=(1, 0), mesh_ids=())
    with pytest.raises(NotImplementedError, match="K7"):
        prender.scene_min_t(ps, meta, None, torch.zeros((4, 8)), torch.ones((3, 8)), -1, 1,
                            torch.ones(8), ())


def test_unported_routes_raise(scenes):
    _, (ps, pm) = scenes
    with pytest.raises(NotImplementedError, match="msaa"):
        prender.build_render_fn(pm, 32, 32, -1, msaa=2)
    two_meshes = dataclasses.replace(pm, mesh_ids=(0, 0))
    with pytest.raises(NotImplementedError, match="K9"):
        prender.build_render_fn(two_meshes, 32, 32, -1)(ps, prender.FrameState.initial())
    from relativitypathtracer_tpu_torch.models.scene import _mesh_static

    with pytest.raises(NotImplementedError, match="K11"):
        _mesh_static(ps.mesh, tuple(range(30000)))


def test_render_frame_entry_point(scenes):
    _, (ps, pm) = scenes
    img = pt.render_frame(ps, pm, pt.FrameState.initial(), 32, 32)
    assert img.shape == (32, 32, 3) and bool(torch.isfinite(img).all())
