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


def list_rays(rng, n: int = 2048, spread: float = 0.3, shadow: bool = False):
    """Rays for the list builds: (d, o, valid, bound), numpy float32/bool.
    Unit dirs around +z; one origin near (0, 0, 0), or for shadow rays
    origins spread over [-1, 1]^3 and the first 256 lanes masked (two
    all-masked 128-lane sub-cones); a lane bound of 3-9 on valid lanes."""
    d = rng.normal(size=(3, n)) * spread
    d[2] = 1.0
    d /= np.linalg.norm(d, axis=0)
    if shadow:
        o = rng.uniform(-1.0, 1.0, (3, n))
    else:
        o = np.broadcast_to(rng.uniform(-0.2, 0.2, (3, 1)), (3, n))
    valid = rng.uniform(size=n) > 0.3
    if shadow:
        valid[:256] = False
    bound = np.where(valid, rng.uniform(3.0, 9.0, n), 0.0)
    return d.astype(np.float32), np.array(o, np.float32), valid, bound.astype(np.float32)


def list_spheres(rng, C: int):
    """C chunk spheres (C, 4) around (0, 0, 6), radii 0.1-0.5; numpy."""
    centres = rng.uniform(-1.5, 1.5, (C, 3)) + np.array([0.0, 0.0, 6.0])
    return np.concatenate([centres, rng.uniform(0.1, 0.5, (C, 1))], axis=1).astype(np.float32)


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


def box_plane_batch(dev, T: int = 200):
    """Inputs of the port's mesh_batch.batched_nearest_shared (consts,
    attrs, spheres, boxes, mats, dir4, d_os, o_os, s_os, chunk_counts) for
    two objects, whose middle ray block runs along a box plane: object 0 sits
    in the identity frame (at rest, unrotated, unscaled) with the shared
    origin ro on the lo.x plane of its union box, and the 1,024 lanes of
    block 1 have an exact-zero x direction (the identity frame keeps dh.x
    exactly 0), so they lie in that plane, inside its y and z slabs: the
    0 * inf slab case of mesh_kernels._safe_inv. Object 1 moves, is rotated
    and scaled, and lies off to +x, out of block 1's way; blocks 0 and 2 look
    at object 0."""
    from relativitypathtracer_tpu_torch.models.scene import MeshArrays
    from relativitypathtracer_tpu_torch.ops import mesh_intersect as mi
    from relativitypathtracer_tpu_torch.ops import relmath
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_batch as mb
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk

    rng = np.random.default_rng(23)
    n = 3 * 1024
    eye = torch.eye(4)
    m1 = relmath.trs(np.array([6.0, 0.0, 8.0], np.float32), np.float32(0.7),
                     np.array([0.3, 1.0, 0.2], np.float32), np.array([1.0, 0.8, 1.2], np.float32))
    frames = [(eye, eye, eye), (relmath.lorentz(torch.tensor([0.0, 0.1, 0.0])),
                                relmath.inverse4(m1), m1)]
    meshes, spheres = [], []
    for g in range(2):
        verts, tri_v = soup(rng, T)
        verts = verts * 0.5 + (np.array([0.0, 0.0, 8.0], np.float32) if g == 0 else 0.0)
        meshes.append(MeshArrays(torch.as_tensor(verts), torch.as_tensor(tri_v), *([None] * 11)))
        perm = torch.arange(T)
        spheres.append(mk.chunk_spheres(*mi.mesh_tri_vertices(meshes[g], perm),
                                        mi.padded_tri_count(T)))
    lo0 = mk._box_of(spheres[0])[0]
    cam = torch.tensor([0.0, float(lo0[0]), 0.0, 0.0])
    d = rng.normal(size=(3, n)).astype(np.float32) * 0.1
    d[0] += -float(lo0[0]) / 8.0
    d[2] = 1.0
    d[0, 1024:2048] = 0.0
    d /= np.linalg.norm(d, axis=0)
    dir4 = torch.as_tensor(np.concatenate([np.full((1, n), -1.0, np.float32), d]))
    factors, attrs, boxes, mats, ros, counts = ([], [], [], []), [], [], [], [], []
    for g, (L, inv_m, m) in enumerate(frames):
        ro = inv_m[:3, :3] @ (L @ cam)[1:4] + inv_m[:3, 3]
        consts, _, _, T_pad = mi.shared_origin_constants(meshes[g], ro, torch.arange(T))
        for f in range(4):
            factors[f].append(consts[f * T_pad:(f + 1) * T_pad])
        attrs.append(torch.as_tensor(rng.normal(size=(T_pad, 15)), dtype=torch.float32))
        boxes.append(torch.cat([*mk._box_of(spheres[g]), ro]))
        mats.append(mb.mat_row(L, inv_m, m, ro))
        ros.append(ro)
        counts.append(T_pad // mk.TC)
    assert float(ros[0][0]) == float(lo0[0]), "ro lies on object 0's lo.x plane"
    mats = torch.stack(mats)
    d_os, s_os = mb.object_dirs(mats, dir4)
    assert bool((d_os[0, 0, 1024:2048] == 0.0).all()), "block 1 runs along the plane"
    o_os = torch.stack(ros)[:, :, None].expand(2, 3, n).contiguous()
    out = (torch.cat(sum(factors, [])), torch.cat(attrs), torch.cat(spheres), torch.stack(boxes),
           mats, dir4, d_os, o_os, s_os)
    return (*(x.to(dev) for x in out), tuple(counts))
