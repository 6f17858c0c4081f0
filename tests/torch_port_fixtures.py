"""Shared helpers of the PyTorch port's tests (tests/test_torch_*.py).

Inputs are made with numpy from fixed seeds and handed to both packages: the
JAX package (the reference) and `relativitypathtracer_tpu_torch`. The JAX
side runs as its own tests run it on the CPU: Pallas kernels with
interpret=True, frames through conftest.render_with_mode.
"""

from __future__ import annotations

import contextlib

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


def jax_frame(js, jm, state, mode="interpret", size=(64, 64), msaa=1, large=None, interval=-1):
    """The JAX package's frame (H, W, 3) and aux counts at `size` and
    `interval` (-1: light propagation and shadows; 0: neither), for state
    ((cam_velocity), (cam_pos)), its kernel routing forced to `mode` and its
    LARGE_MODE to `large`, render caches cleared before and after (as
    conftest.render_with_mode does)."""
    import jax.numpy as jnp

    from relativitypathtracer_tpu import render as jrender
    from relativitypathtracer_tpu.ops import mesh_intersect as jmi

    jmi.PALLAS_MODE, jmi.LARGE_MODE = mode, large
    jrender.build_render_fn.cache_clear()
    try:
        fn = jrender.build_render_fn(jm, size[0], size[1], interval, msaa, True)
        img, aux = fn(js, jrender.FrameState(jnp.asarray(state[0], jnp.float32),
                                             jnp.asarray(state[1], jnp.float32)))
        return np.asarray(img), {k: int(v) for k, v in aux.items()}
    finally:
        jmi.PALLAS_MODE = jmi.LARGE_MODE = None
        jrender.build_render_fn.cache_clear()


def port_frame(ps, pm, state, size=(64, 64), msaa=1, interval=-1):
    """The port's frame and aux counts on the CPU, as jax_frame's."""
    from relativitypathtracer_tpu_torch import render as prender

    fn = prender.build_render_fn(pm, size[0], size[1], interval, msaa, with_aux=True,
                                 device="cpu")
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


# --- Adversarial inputs of the K3/K7 pre-test (object_may_hit_plain) ------

PRETEST_CASES = ("tangent", "edges_corners", "inside", "floor", "boosted", "interval_0",
                 "degenerate", "ragged")


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _perp(rng, v):
    """Random unit vectors perpendicular to the rows of v."""
    e = rng.normal(size=v.shape)
    e -= (e * v).sum(1, keepdims=True) / (v * v).sum(1, keepdims=True) * v
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _turn(rng, D):
    """D turned by 2^-30..2^-8 radians, either way, about a random axis."""
    ang = 2.0 ** rng.uniform(-30, -8, len(D)) * rng.choice([-1.0, 1.0], len(D))
    n = np.linalg.norm(D, axis=1, keepdims=True)
    return D + ang[:, None] * n * _perp(rng, D)


def _tangent_targets(rng, Q):
    """Points where lines from the rows of Q (|Q| > 1) touch the unit sphere."""
    q2 = (Q * Q).sum(1, keepdims=True)
    return Q / q2 + np.sqrt(1.0 - 1.0 / q2) * _perp(rng, Q)


def _cube_targets(rng, n, corner_share=0.5):
    """Cube corners and edge points, some moved by 2^-26..2^-12."""
    X = rng.choice([-1.0, 1.0], size=(n, 3))
    edge = rng.uniform(size=n) > corner_share
    axis = rng.integers(0, 3, n)
    X[edge, axis[edge]] = rng.uniform(-1, 1, int(edge.sum()))
    jig = rng.uniform(size=n) < 0.5
    k = int(jig.sum())
    X[jig] += rng.normal(size=(k, 3)) * 2.0 ** rng.uniform(-26, -12, (k, 1))
    return X


def _objects(rng, kinds, speeds=None, scales=None):
    """(L, inv_m, m) float32 for objects at z 3..7, random turn."""
    from relativitypathtracer_tpu_torch.ops import relmath as prel

    G = len(kinds)
    pos = np.stack([rng.uniform(-2, 2, G), rng.uniform(-1.5, 1.5, G), rng.uniform(3, 7, G)], 1)
    sc = scales if scales is not None else rng.uniform(0.5, 1.2, (G, 3))
    m = torch.stack([prel.trs(pos[g].astype(np.float32), np.float32(rng.uniform(0, 3)),
                              rng.normal(size=3).astype(np.float32),
                              np.asarray(sc[g], np.float32)) for g in range(G)])
    sp = np.zeros(G) if speeds is None else np.asarray(speeds, float)
    vel = _unit(rng, G) * sp[:, None]
    return prel.lorentz(torch.as_tensor(vel, dtype=torch.float32)), prel.inverse4(m), m


def _solve_dirs(A, D, interval):
    """Camera-frame unit 3-directions u with A @ (interval, u) along +D."""
    a0, M = A[:, 0], A[:, 1:]
    p = np.linalg.solve(M, D.T).T
    q = np.linalg.solve(M, a0 * interval)
    pq, pp = p @ q, (p * p).sum(1)
    lam = (pq + np.sqrt(pq * pq - pp * (q @ q - 1.0))) / pp
    return lam[:, None] * p - q


def pretest_inputs(rng, form, case):
    """Adversarial inputs of the K3/K7 pre-test: (params, dir4, origins4 or
    None, n_spheres, n_cubes), CPU float32, for the K3 (shared origin) or K7
    form. G objects (4; 20 for K3 `inside`) and G x 25,000 lanes, every
    object seeing every lane: for each object, rays solved back to
    camera-frame 4-directions (and K7's origins) from object-space targets
    (sphere tangents, cube edges and corners, grazing a face), then turned
    by 2^-30..2^-8 radians either way. Cases as PRETEST_CASES: `inside`
    puts the origins inside, on or just outside the bounding ball (K7: on
    the cube's top face, the floor's shadow origins), `floor` scales the
    cubes 7 x 0.1 x 6, `boosted` moves the objects at 0.6c and 0.9c,
    `interval_0` takes interval 0 (the others -1), `degenerate` makes
    eighths of the lanes zero, huge, infinite, NaN and tiny directions (and
    NaN and infinite K7 origins), `ragged` adds 3 lanes to each object's
    (N not a multiple of 32)."""
    from relativitypathtracer_tpu_torch.ops.kernels import analytic_kernels as ak

    interval = 0.0 if case == "interval_0" else -1.0
    if case == "inside" and form == "K3":
        kinds = ["s"] * 10 + ["c"] * 10
    elif case == "floor":
        kinds = ["c"] * 4
    else:
        kinds = ["s", "s", "c", "c"]
    G = len(kinds)
    n = 100_000 // G + (3 if case == "ragged" else 0)
    speeds = ([0.6, 0.9, 0.6, 0.9] if case == "boosted" else
              [0.0, 0.5, 0.0, 0.3] * (G // 4))
    scales = np.tile([7.0, 0.1, 6.0], (G, 1)) if case == "floor" else None
    L, inv_m, m = _objects(rng, kinds, speeds, scales)
    # object-space origins: K3 one per object (the camera), K7 one per lane
    Qs = []
    for g, kind in enumerate(kinds):
        r2 = 1.0 if kind == "s" else 3.0
        if case == "inside":
            rad = np.sqrt(r2) * [0.3, 0.999, 1.0, 1.0 + 2.0 ** -22, 1.0 + 2.0 ** -12, 1.2][g % 6]
            if kind == "c" and g % 2:  # on a face, or at a corner
                Qs.append(np.array([rng.uniform(-1, 1), 1.0, rng.uniform(-1, 1)]) if g % 4 == 1
                          else np.array([1.0, -1.0, 1.0]))
                continue
            Qs.append(_unit(rng, 1)[0] * rad)
        elif case == "floor":
            Qs.append(np.array([rng.uniform(-3, 3), rng.uniform(5, 40), rng.uniform(-3, 3)]))
        else:
            Qs.append(_unit(rng, 1)[0] * rng.uniform(1.5, 20.0))
    ids = tuple(range(G))
    if form == "K3":
        stat = torch.zeros((G, 4))
        stat[:, 1:] = torch.stack([m[g, :3, :3] @ torch.as_tensor(Qs[g], dtype=torch.float32)
                                   + m[g, :3, 3] for g in range(G)])
        params = ak.pack_analytic_params(L, inv_m, stat, ids)
    else:
        params = ak.pack_analytic_params_general(L, inv_m, ids)
    P = params.double().numpy()
    n_spheres = kinds.count("s")
    dirs, origins = [], []
    for g, kind in enumerate(kinds):
        A = P[g, :12].reshape(3, 4)
        if form == "K3":
            Q = np.asarray(P[g, 12:15])
        elif case == "inside" or case == "floor":  # shadow origins on a face, or inside
            Q = np.stack([rng.uniform(-1, 1, n), np.ones(n), rng.uniform(-1, 1, n)], 1)
            inner = rng.uniform(size=n) < 0.3
            k = int(inner.sum())
            Q[inner] = _unit(rng, k) * rng.uniform(0, 1.7, (k, 1))
        else:
            Q = _unit(rng, n) * rng.uniform(1.8, 20.0, (n, 1))
        Qn = np.broadcast_to(Q, (n, 3)) if Q.ndim == 1 else Q
        if kind == "s" and case != "inside":
            X = _tangent_targets(rng, np.array(Qn))
        else:
            X = _cube_targets(rng, n) if kind == "c" else _unit(rng, n)
        if case in ("inside", "floor") and kind == "c":
            # grazing along the top face, and out of it
            graze = rng.uniform(size=n) < 0.4
            k = int(graze.sum())
            step = _unit(rng, k)
            step[:, 1] = rng.normal(size=k) * 2.0 ** rng.uniform(-30, -10, k)
            X[graze] = Qn[graze] + step
        D = _turn(rng, X - Qn)
        if case == "inside":  # and any way at all
            away = rng.uniform(size=n) < 0.3
            D[away] = _unit(rng, int(away.sum()))
        u = _solve_dirs(A, D, interval)
        dirs.append(u)
        if form == "K7":
            t0 = rng.uniform(0.0, 5.0, n)
            o = np.linalg.solve(A[:, 1:], (Qn - P[g, 12:15] - A[:, 0] * t0[:, None]).T).T
            origins.append(np.concatenate([t0[:, None], o], 1))
    # every object's lanes side by side: each object sees every lane
    u = np.concatenate(dirs)
    N = len(u)
    dir4 = np.concatenate([np.full((1, N), interval), u.T]).astype(np.float32)
    o4 = np.concatenate(origins).T.astype(np.float32) if form == "K7" else None
    if case == "degenerate":
        k = N // 8
        dir4[1:, :k] = 0.0
        dir4[1:, k:2 * k] *= np.float32(1e19)
        dir4[1:, 2 * k:3 * k] *= np.float32(1e30)
        dir4[1, 3 * k:4 * k] = np.inf
        dir4[2, 4 * k:5 * k] = np.nan
        dir4[1:, 5 * k:6 * k] *= np.float32(1e-20)
        dir4[0, 6 * k:7 * k] = np.nan
        if o4 is not None:
            o4[1, 7 * k:7 * k + k // 2] = np.nan
            o4[2, 7 * k + k // 2:8 * k] = np.inf
    return (params, torch.as_tensor(dir4), None if o4 is None else torch.as_tensor(o4),
            n_spheres, G - n_spheres)


# The octree builders (test_torch_octree_builder.py, test_torch_octree.py)
ARRAYS = ("node_min", "node_max", "node_tris_index", "node_tris_count", "node_children",
          "node_neighbors", "oct_tris")
OCTREE_CASES = {  # case -> the OBJ files read into one pool, in order
    "blob2": ("blob2",),
    "blob3": ("blob3",),
    "blob4_fma": ("blob4",),
    "blob5": ("blob5",),
    "stand_in": ("stand_in",),
    "stand_in_then_blob2": ("stand_in", "blob2"),
    "blob2_then_stand_in": ("blob2", "stand_in"),
    "one_triangle": ("one_triangle",),
    "degenerate": ("degenerate",),
}
ONE_TRIANGLE = "v 0.1 -0.2 0.3\nv 1.7 0.4 -0.5\nv -0.6 1.3 0.9\nvn 0 0 1\nf 1//1 2//1 3//1\n"
# zero-area triangles: collinear points, a repeated vertex, a point; and one
# proper triangle, so that the root box has an extent
DEGENERATE = ("v 0 0 0\nv 1 1 1\nv 2 2 2\nv 0.5 -1 0.25\nv 1 0 -1\nvn 0 1 0\n"
              "f 1//1 2//1 3//1\nf 4//1 4//1 5//1\nf 2//1 2//1 2//1\nf 3//1 1//1 2//1\n"
              "f 1//1 4//1 5//1\n")


def octree_objs(root):
    """The OBJ files of OCTREE_CASES written under root (a pathlib.Path), by
    name."""
    from relativitypathtracer_tpu_torch.utils.demo_scene import (
        write_bunny_stand_in,
        write_demo_scene,
    )

    paths = {}
    for level in (2, 3, 4, 5):
        write_demo_scene(str(root / f"blob{level}"), level, "blob")
        paths[f"blob{level}"] = str(root / f"blob{level}" / "Models" / "blob.obj")
    paths["stand_in"] = write_bunny_stand_in(str(root / "stand_in" / "bunny_stand_in.obj"))
    for name, text in (("one_triangle", ONE_TRIANGLE), ("degenerate", DEGENERATE)):
        (root / f"{name}.obj").write_text(text)
        paths[name] = str(root / f"{name}.obj")
    return paths


@contextlib.contextmanager
def _attr(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def port_mesh(paths, plain: bool = False):
    """The port's HostMesh of the OBJ files, its octree built by the C++
    builder or, with plain, by the numpy twin."""
    from relativitypathtracer_tpu_torch.models import obj_loader, octree
    from relativitypathtracer_tpu_torch.models.mesh import HostMesh

    mesh = HostMesh()
    build = octree.generate_octree_plain if plain else obj_loader.generate_octree
    with _attr(obj_loader, "generate_octree", build):
        for p in paths:
            obj_loader.read_obj(p, mesh)
    return mesh


def jax_mesh(paths):
    """The JAX package's HostMesh, its octree built by its numpy builder."""
    from relativitypathtracer_tpu.models import obj_loader as jol
    from relativitypathtracer_tpu.models import octree as jo
    from relativitypathtracer_tpu.models.mesh import HostMesh as JaxHostMesh

    mesh = JaxHostMesh()
    with _attr(jo, "_NATIVE", None):
        for p in paths:
            jol.read_obj(p, mesh)
    return mesh


def octree_case(objs, case: str, side: str):
    """The mesh of an OCTREE_CASES case by side: "cpp" (the port's C++
    builder), "plain" (its numpy twin) or "jax" (the JAX package's numpy
    builder)."""
    paths = [objs[n] for n in OCTREE_CASES[case]]
    return jax_mesh(paths) if side == "jax" else port_mesh(paths, plain=side == "plain")


def assert_same_octree(got, want):
    """Bit for bit: the seven arrays (float bounds as their bits), depth,
    roots, each root's reachable triangles and seeded range."""
    for name in ARRAYS:
        a, b = np.asarray(getattr(got.octree, name)), np.asarray(getattr(want.octree, name))
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if a.dtype.kind == "f":
            assert a.dtype == b.dtype == np.float32, name
            a, b = a.view(np.int32), b.view(np.int32)
        assert np.array_equal(a, b), name
    assert got.octree.max_depth == want.octree.max_depth
    assert got.mesh_indices == want.mesh_indices
    assert got.root_tri_ranges == want.root_tri_ranges
    assert sorted(got.root_tri_lists) == sorted(want.root_tri_lists)
    for root, tris in want.root_tri_lists.items():
        assert np.array_equal(got.root_tri_lists[root], tris), root
