"""Shared helpers of the PyTorch port's tests (tests/test_torch_*.py).

Inputs are made with numpy from fixed seeds and handed to both packages: the
JAX package (the reference) and `relativitypathtracer_tpu_torch`. The JAX
side runs as its own tests run it on the CPU: Pallas kernels with
interpret=True, frames through conftest.render_with_mode.
"""

from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(1)  # the suite runs several workers on a few cores


def build_both(scene_path: str):
    """((jax_scene, jax_meta), (port_scene, port_meta)) of one scene file,
    each built by its own package (the port's on the CPU)."""
    import relativitypathtracer_tpu as jx
    import relativitypathtracer_tpu_torch as pt

    return (jx.build_scene(jx.load_scene_file(scene_path)),
            pt.build_scene(pt.load_scene_file(scene_path), device="cpu"))


def write_fixture(tmp_path_factory, level: int = 3, kind: str = "blob") -> str:
    """One of the port's demo fixtures (utils/demo_scene) in a fresh temp dir."""
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    return write_demo_scene(str(tmp_path_factory.mktemp(f"fixture_{kind}{level}")), level, kind)


def soup(rng, T: int):
    """Random triangle soup: (vertices (3T, 3), tri_v (T, 3)) float32/int32."""
    cent = rng.uniform(-2.0, 2.0, (T, 3)).astype(np.float32)
    off = rng.uniform(-0.3, 0.3, (T, 2, 3)).astype(np.float32)
    verts = np.concatenate([cent, cent + off[:, 0], cent + off[:, 1]], axis=0)
    ids = np.arange(T, dtype=np.int32)
    return verts, np.stack([ids, ids + T, ids + 2 * T], axis=1)


def repeat_for_ties(tri_v):
    """Exact ties, made in tri_v (T, 3) in place: in every 32-triangle chunk
    c (triangles in index order), triangle 32c + 1 repeats 32c (a tie inside
    a chunk) and, where chunk c + 1 holds it, triangle 32(c + 1) + 2 repeats
    32c + 3 (a tie across two chunks). Returns (inside, across): the first
    triangle of each repeated pair, inside one chunk and across two."""
    T = tri_v.shape[0]
    first = np.arange(0, T, 32)
    inside = first[first + 1 < T]
    across = first[first + 34 < T] + 3
    tri_v[inside + 1] = tri_v[inside]
    tri_v[across + 31] = tri_v[across]
    return inside, across


def tie_soup(rng, T: int):
    """soup() with the ties of repeat_for_ties: (vertices, tri_v, inside,
    across)."""
    verts, tri_v = soup(rng, T)
    return (verts, tri_v, *repeat_for_ties(tri_v))


def aim_at(rng, verts, tri_v, targets, ro):
    """Unit directions from ro (3,) to a random interior point (barycentrics
    0.1-0.45) of triangle targets[i], for each i: (3, len(targets))."""
    a, b = rng.uniform(0.1, 0.45, (2, len(targets)))
    A, B, C = (verts[tri_v[targets, k]] for k in range(3))
    d = (A + a[:, None] * (B - A) + b[:, None] * (C - A) - ro).T
    return (d / np.linalg.norm(d, axis=0)).astype(np.float32)


def t(x, dtype=None):
    """numpy -> CPU tensor."""
    return torch.as_tensor(np.array(x, order="C"), dtype=dtype)


def tie_flip_frac(a, b) -> float:
    return float(np.mean(np.asarray(a) != np.asarray(b)))


def assert_mostly_close(got, want, tol: float, frac: float, hard: float, rel: bool = False):
    """|got - want| <= tol (scaled by |want| when rel) on at least 1 - frac of
    the entries and <= hard on all. For outputs where the JAX package's CPU
    reference contracts a * b + c into one FMA (XLA does) while the port
    rounds twice (as the card does under -fmad=false), and ill-conditioned
    lanes (grazing hits) magnify that last-bit difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want) if rel else 1.0
    err = np.abs(got - want) / np.maximum(scale, 1e-30) if rel else np.abs(got - want)
    assert err.max() <= hard, f"max err {err.max()} > {hard}"
    assert np.mean(err > tol) <= frac, f"{np.mean(err > tol):.4f} of entries > {tol}"


def jax_frame(js, jm, state, mode="interpret", size=(64, 64), msaa=1, large=None):
    """The JAX package's frame (H, W, 3) and aux counts at `size`, interval
    -1, for state ((cam_velocity), (cam_pos)), its kernel routing forced to
    `mode` and its LARGE_MODE to `large`, render caches cleared before and
    after (as conftest.render_with_mode does)."""
    import jax.numpy as jnp

    from relativitypathtracer_tpu import render as jrender
    from relativitypathtracer_tpu.ops import mesh_intersect as jmi

    jmi.PALLAS_MODE, jmi.LARGE_MODE = mode, large
    jrender.build_render_fn.cache_clear()
    try:
        fn = jrender.build_render_fn(jm, size[0], size[1], -1, msaa, True)
        img, aux = fn(js, jrender.FrameState(jnp.asarray(state[0], jnp.float32),
                                             jnp.asarray(state[1], jnp.float32)))
        return np.asarray(img), {k: int(v) for k, v in aux.items()}
    finally:
        jmi.PALLAS_MODE = jmi.LARGE_MODE = None
        jrender.build_render_fn.cache_clear()


def port_frame(ps, pm, state, size=(64, 64), msaa=1):
    """The port's frame and aux counts on the CPU, as jax_frame's."""
    from relativitypathtracer_tpu_torch import render as prender

    fn = prender.build_render_fn(pm, size[0], size[1], -1, msaa, with_aux=True, device="cpu")
    img, aux = fn(ps, prender.FrameState(torch.tensor(state[0]), torch.tensor(state[1])))
    return img.numpy(), {k: int(v) for k, v in aux.items()}


def assert_frame_parity(got, want, paux, jaux):
    """The parity rule of utils/parity.py (at most 0.2% of pixels off by more
    than 1e-3), a mean difference under 1e-4, equal hit and shadow-ray
    counts."""
    assert got.shape == want.shape and got.shape[-1] == 3 and np.isfinite(got).all()
    diff = np.abs(got - want)
    assert float(np.mean(diff.max(axis=-1) > 1e-3)) <= 0.002
    assert float(diff.mean()) < 1e-4, f"mean diff {diff.mean()}"
    assert paux["hits"] == jaux["hits"] and paux["shadow_rays"] == jaux["shadow_rays"]
