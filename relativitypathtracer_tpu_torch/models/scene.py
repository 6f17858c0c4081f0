"""Scene data model: tensors on one device plus static host metadata.

Torch counterpart of `relativitypathtracer_tpu.models.scene`. `build_scene`
turns a parsed HostScene into the same structure of arrays as the JAX
package (ObjectsSoA, MeshArrays, MeshStatic, Scene), as tensors on an explicit
device, and a hashable `SceneMeta`. A mesh whose padded triangle count is
above `mesh_intersect.large_tier_threshold()` is built for the large tier
(K11/K12); a scene with several mesh objects, none of them large, also gets
the fused pool of the batched walks (K9/K10, `MeshBatchStatic`).
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from ..ops.texture_layout import (
    MAX_TILES_PER_AXIS, region_quads, region_tile_grid, texture_table, tile_slot)

SPHERE = 0
CUBE = 1
MESH = 2


class ObjectsSoA(NamedTuple):
    """Per-object arrays, leading dim O (struct Object, Object.h:6-22)."""

    m: torch.Tensor  # (O, 4, 4) model matrix
    inv_m: torch.Tensor  # (O, 4, 4)
    velocity: torch.Tensor  # (O, 3) units of c
    color: torch.Tensor  # (O, 3)
    obj_type: torch.Tensor  # (O,) int32 SPHERE/CUBE/MESH
    mesh_root: torch.Tensor  # (O,) int32 octree root (-1 if not a mesh)
    tex_offset: torch.Tensor  # (O,) int32 atlas byte offset (-1 if none)
    tex_w: torch.Tensor  # (O,) int32
    tex_h: torch.Tensor  # (O,) int32
    light: torch.Tensor  # (O,) bool
    flash_period: torch.Tensor  # (O,) f32
    flash_duration: torch.Tensor  # (O,) f32


class MeshArrays(NamedTuple):
    """All meshes in one flat pool (Mesh.h:5-16) plus the flattened octree."""

    vertices: torch.Tensor  # (V, 3) f32
    tri_v: torch.Tensor  # (T, 3) int32
    tri_uv: torch.Tensor  # (T, 3) int32
    tri_n: torch.Tensor  # (T, 3) int32
    uvs: torch.Tensor  # (U, 2) f32
    normals: torch.Tensor  # (NN, 3) f32
    node_min: torch.Tensor  # (Q, 3) f32
    node_max: torch.Tensor  # (Q, 3) f32
    node_tris_index: torch.Tensor  # (Q,) int32
    node_tris_count: torch.Tensor  # (Q,) int32
    node_children: torch.Tensor  # (Q, 8) int32
    node_neighbors: torch.Tensor  # (Q, 6) int32
    oct_tris: torch.Tensor  # (P,) int32


class MeshStatic(NamedTuple):
    """Frame-invariant inputs of the mesh walks for one mesh object."""

    attrs: torch.Tensor  # (T_pad, 15) barycentric attribute operators
    spheres: torch.Tensor  # (T_pad / TC, 4) chunk bounding spheres
    gen_cols: torch.Tensor  # (4 * T_pad, 10) factor-grouped Plucker operators
    gen_spheres: torch.Tensor  # (T_pad / TC_GEN, 4)
    # Large tier only, and its marker (as in the JAX package): the (T_pad, 20)
    # general triangle rows K12 reads. The JAX package's lane-major DMA
    # records and bf16-split attributes have no counterpart: the port's large
    # walks read the same rows as K5/K6.
    gen_rec: torch.Tensor | None = None


class MeshBatchStatic(NamedTuple):
    """The fused pool of the batched walks (K9/K10): every mesh object's
    constants concatenated in meta.mesh_ids order, the Plucker operators
    regrouped by factor over the whole pool. Chunks per object are in
    SceneMeta.mesh_chunk_counts."""

    attrs: torch.Tensor  # (Tsum_pad, 15)
    gen_cols: torch.Tensor  # (4 * Tsum_pad, 10)
    spheres: torch.Tensor  # (C, 4) object-major


class Scene(NamedTuple):
    objects: ObjectsSoA
    mesh: MeshArrays
    textures: torch.Tensor  # (B,) uint8 interleaved-RGB atlas
    textures_packed: torch.Tensor  # (R, 8) int32 texels R | G << 8 | B << 16
    tex_quads: torch.Tensor  # (Rq, 8) int32 footprint atlas
    tex_fp: torch.Tensor  # (O, 6) int32 footprint regions [base rx ry wb rw rh]
    tex_table: torch.Tensor  # (O, 11) int32 footprint-fetch constants (texture_table)
    tex_textured: torch.Tensor  # (O,) bool: tex_offset != -1, the fetch's flat-colour select
    mesh_static: tuple  # MeshStatic per mesh object (meta.mesh_ids order)
    white_point: torch.Tensor  # (3,) f32
    ambient: torch.Tensor  # () f32
    mesh_batch: MeshBatchStatic | None = None  # the pool of several meshes


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static facts that shape the frame program; hashable. The fields are the
    JAX package's, plus `textured_ids`, which the port's router reads."""

    num_objects: int
    sphere_ids: tuple
    cube_ids: tuple
    mesh_ids: tuple
    mesh_roots: tuple
    mesh_tri_ranges: tuple
    mesh_perms: tuple
    light_ids: tuple
    default_interval: int
    num_tris: int
    num_nodes: int
    max_octree_depth: int
    use_footprint_tex: bool = True
    any_flash: bool = False
    mesh_chunk_counts: tuple = ()
    textured_ids: tuple = ()


def _morton_perm(verts: np.ndarray, tri_v: np.ndarray, tri_ids: np.ndarray) -> tuple:
    """Morton (Z-curve) order of the given absolute triangle ids by quantized
    centroid, so 32-triangle chunks are spatially tight."""
    if len(tri_ids) == 0:
        return ()
    tv = tri_v[tri_ids]
    cent = (verts[tv[:, 0]] + verts[tv[:, 1]] + verts[tv[:, 2]]) / 3.0
    lo_c = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo_c, 1e-12)
    q = np.minimum((1023.0 * (cent - lo_c) / span).astype(np.uint64), 1023)

    def spread(x):
        x = x & 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return tuple(int(tri_ids[i]) for i in np.argsort(code, kind="stable"))


def _footprint_atlas(packed_texels: np.ndarray, texture_values: list, regions: list):
    """Each region's exact 4-tap bilinear footprint per integer (x0, y0), in
    16x16-texel Morton-ordered tiles (opencl_kernel.cl:427-470). Returns
    ((Rq, 8) u32 atlas, {region: (base, rx, ry, wb)})."""
    quads = []
    params = {}
    total = 0
    B = 16
    dims = {int(texture_values[k]): (texture_values[k + 1], texture_values[k + 2])
            for k in range(0, len(texture_values), 3)}
    for region in dict.fromkeys(regions):
        off, xl, xh, yl, yh = region
        w, h = dims[int(off)]
        tex = packed_texels[off // 3: off // 3 + w * h].reshape(h, w)
        rw = xh - xl + 1
        rh = yh - yl + 1
        x0 = np.broadcast_to(np.arange(xl, xh + 1)[None, :], (rh, rw))
        y0 = np.broadcast_to(np.arange(yl, yh + 1)[:, None], (rh, rw))
        x1 = np.clip(x0 + 1, 0, w - 1)
        y1 = np.clip(y0 + 1, 0, h - 1)
        x2 = np.clip(x1 - 1, 0, w - 1)
        foot = np.stack([tex[y0, x0], tex[y0, x1], tex[y1, x1], tex[y1, x2]], axis=-1)
        wb = -(-rw // B)
        hb = -(-rh // B)
        if max(wb, hb) > MAX_TILES_PER_AXIS:
            raise ValueError("texture axis > 4096 texels")
        wb2, hb2 = region_tile_grid(np.int64(wb), np.int64(rh))
        tiled = np.zeros((hb * B, wb * B, 4), np.uint32)
        tiled[:rh, :rw] = foot
        lx = np.broadcast_to(np.arange(wb * B)[None, :], (hb * B, wb * B))
        ly = np.broadcast_to(np.arange(hb * B)[:, None], (hb * B, wb * B))
        slot = tile_slot(lx.astype(np.int64), ly.astype(np.int64),
                         np.int64(wb), np.int64(rh))
        out = np.zeros((int(wb2 * hb2) * B * B, 4), np.uint32)
        out[slot.reshape(-1)] = tiled.reshape(-1, 4)
        params[region] = (total, int(xl), int(yl), int(wb))
        quads.append(out)
        total += int(region_quads(np.int64(wb), np.int64(rh)))
    if not quads:
        quads = [np.zeros((2, 4), np.uint32)]
    flat = np.concatenate(quads, axis=0).reshape(-1)
    rows = -(-len(flat) // 8)
    return np.pad(flat, (0, rows * 8 - len(flat))).reshape(rows, 8), params


def _mesh_static(mesh: MeshArrays, perm: tuple) -> MeshStatic:
    from ..ops.kernels.mesh_kernels import chunk_spheres, general_tri_rows
    from ..ops.mesh_intersect import (
        general_ray_constants, large_tier_threshold, mesh_tri_vertices, padded_tri_count,
        tri_attr_matrix)

    perm_t = torch.as_tensor(perm, dtype=torch.long, device=mesh.vertices.device)
    T_pad = padded_tri_count(len(perm))
    A, B, C = mesh_tri_vertices(mesh, perm_t)
    gen_cols = general_ray_constants(mesh, perm_t)
    return MeshStatic(
        attrs=tri_attr_matrix(mesh, perm_t, T_pad),
        spheres=chunk_spheres(A, B, C, T_pad),
        gen_cols=gen_cols,
        gen_spheres=chunk_spheres(A, B, C, T_pad),
        gen_rec=general_tri_rows(gen_cols) if T_pad > large_tier_threshold() else None,
    )


def _mesh_batch(mesh_static: tuple):
    """(MeshBatchStatic, chunks per object) for several mesh objects none of
    which is in the large tier, else (None, ())."""
    from ..ops.kernels.mesh_kernels import TC

    if len(mesh_static) < 2 or any(ms.gen_rec is not None for ms in mesh_static):
        return None, ()
    tpads = [ms.attrs.shape[0] for ms in mesh_static]
    factors = [ms.gen_cols[f * tp:(f + 1) * tp] for f in range(4)
               for ms, tp in zip(mesh_static, tpads)]
    return (MeshBatchStatic(attrs=torch.cat([ms.attrs for ms in mesh_static]),
                            gen_cols=torch.cat(factors),
                            spheres=torch.cat([ms.spheres for ms in mesh_static])),
            tuple(tp // TC for tp in tpads))


def build_scene(host, device=DEFAULT_DEVICE) -> tuple[Scene, SceneMeta]:
    """Convert a parsed HostScene (models.dsl) into tensors on `device` + meta."""
    o = host.objects
    num = len(o)

    def stack(attr, shape):
        if num == 0:
            return np.zeros((0, *shape), np.float32)
        return np.stack([np.asarray(getattr(ob, attr), np.float32).reshape(shape) for ob in o])

    types = np.array([ob.obj_type for ob in o], np.int32)
    mesh_root = np.array([ob.mesh_root for ob in o], np.int32)
    tex_offset = np.array([ob.tex_offset for ob in o], np.int32)
    tex_w = np.array([ob.tex_w for ob in o], np.int32)
    tex_h = np.array([ob.tex_h for ob in o], np.int32)
    light = np.array([ob.light for ob in o], bool)
    flash_period = np.array([ob.flash_period for ob in o], np.float32)
    flash_duration = np.array([ob.flash_duration for ob in o], np.float32)

    msh = host.mesh
    verts = np.asarray(msh.vertices, np.float32).reshape(-1, 3) if len(msh.vertices) else np.zeros((1, 3), np.float32)
    tris = np.asarray(msh.triangles, np.int32).reshape(-1, 9) if len(msh.triangles) else np.zeros((0, 9), np.int32)
    uvs = np.asarray(msh.uvs, np.float32).reshape(-1, 2) if len(msh.uvs) else np.zeros((1, 2), np.float32)
    normals = np.asarray(msh.normals, np.float32).reshape(-1, 3) if len(msh.normals) else np.zeros((1, 3), np.float32)
    oct = msh.octree
    q = len(oct.node_min) if oct is not None and len(oct.node_min) else 0
    if q:
        octree = dict(
            node_min=np.asarray(oct.node_min, np.float32),
            node_max=np.asarray(oct.node_max, np.float32),
            node_tris_index=np.asarray(oct.node_tris_index, np.int32),
            node_tris_count=np.asarray(oct.node_tris_count, np.int32),
            node_children=np.asarray(oct.node_children, np.int32),
            node_neighbors=np.asarray(oct.node_neighbors, np.int32),
            oct_tris=np.asarray(oct.oct_tris, np.int32) if len(oct.oct_tris) else np.zeros((1,), np.int32),
        )
    else:
        octree = dict(
            node_min=np.zeros((1, 3), np.float32), node_max=np.zeros((1, 3), np.float32),
            node_tris_index=np.zeros((1,), np.int32), node_tris_count=np.zeros((1,), np.int32),
            node_children=-np.ones((1, 8), np.int32), node_neighbors=-np.ones((1, 6), np.int32),
            oct_tris=np.zeros((1,), np.int32),
        )
    no_tris = np.zeros((1, 3), np.int32)

    tex_np = np.frombuffer(bytes(host.textures), np.uint8) if len(host.textures) else np.zeros((3,), np.uint8)
    packed = (tex_np[0::3].astype(np.uint32) | (tex_np[1::3].astype(np.uint32) << 8)
              | (tex_np[2::3].astype(np.uint32) << 16))
    # Addressable texel rect per object: the full texture for analytic UVs,
    # the uv-pool hull (+/- 2 texels) for meshes.
    uv_pool = uvs if len(msh.uvs) else np.zeros((1, 2), np.float32)
    u_lo, v_lo = uv_pool.min(axis=0)
    u_hi, v_hi = uv_pool.max(axis=0)
    regions = []
    for i in range(num):
        off = int(tex_offset[i])
        if off < 0:
            regions.append(None)
            continue
        w_i, h_i = int(tex_w[i]), int(tex_h[i])
        if types[i] == MESH:
            xl = int(np.clip(np.floor(w_i * u_lo) - 2, 0, w_i - 1))
            xh = int(np.clip(np.floor(w_i * u_hi) + 2, 0, w_i - 1))
            yl = int(np.clip(np.floor(h_i * (1.0 - v_hi)) - 2, 0, h_i - 1))
            yh = int(np.clip(np.floor(h_i * (1.0 - v_lo)) + 2, 0, h_i - 1))
        else:
            xl, xh, yl, yh = 0, w_i - 1, 0, h_i - 1
        regions.append((off, xl, xh, yl, yh))
    quads, region_params = _footprint_atlas(
        packed, host.texture_values, [r for r in regions if r is not None])
    tex_fp = np.zeros((num, 6), np.int32)
    for i, r in enumerate(regions):
        if r is not None:
            base, rx, ry, wb = region_params[r]
            tex_fp[i] = (base, rx, ry, wb, r[2] - r[1] + 1, r[4] - r[3] + 1)
    rows = -(-len(packed) // 8)
    packed = np.pad(packed, (0, rows * 8 - len(packed))).reshape(rows, 8)

    mesh_ids = tuple(int(i) for i in np.nonzero(types == MESH)[0])
    tri_ranges = tuple(
        host.mesh.root_tri_ranges.get(int(mesh_root[i]), (0, len(tris))) for i in mesh_ids)
    perms = tuple(
        _morton_perm(verts, tris[:, 0::3].astype(np.int64), np.asarray(
            host.mesh.root_tri_lists.get(
                int(mesh_root[i]), np.arange(rng[0], rng[1], dtype=np.int64))))
        for i, rng in zip(mesh_ids, tri_ranges))

    arrays = SimpleNamespace(
        objects=ObjectsSoA(
            m=stack("m", (4, 4)), inv_m=stack("inv_m", (4, 4)),
            velocity=stack("velocity", (3,)), color=stack("color", (3,)),
            obj_type=types, mesh_root=mesh_root, tex_offset=tex_offset, tex_w=tex_w,
            tex_h=tex_h, light=light, flash_period=flash_period,
            flash_duration=flash_duration),
        mesh=MeshArrays(
            vertices=verts,
            tri_v=tris[:, 0::3] if len(tris) else no_tris,
            tri_uv=tris[:, 1::3] if len(tris) else no_tris,
            tri_n=tris[:, 2::3] if len(tris) else no_tris,
            uvs=uvs, normals=normals, **octree),
        textures=tex_np, textures_packed=packed, tex_quads=quads, tex_fp=tex_fp,
        white_point=np.asarray(host.white_point, np.float32),
        ambient=np.float32(host.ambient),
        mesh_static=(),
    )
    scene = _to_device(arrays, device)
    mesh_static = tuple(_mesh_static(scene.mesh, perm) for perm in perms)
    mesh_batch, chunk_counts = _mesh_batch(mesh_static)
    scene = scene._replace(mesh_static=mesh_static, mesh_batch=mesh_batch)

    meta = SceneMeta(
        num_objects=num,
        sphere_ids=tuple(int(i) for i in np.nonzero(types == SPHERE)[0]),
        cube_ids=tuple(int(i) for i in np.nonzero(types == CUBE)[0]),
        mesh_ids=mesh_ids,
        mesh_roots=tuple(int(mesh_root[i]) for i in mesh_ids),
        mesh_tri_ranges=tri_ranges,
        mesh_perms=perms,
        light_ids=tuple(int(i) for i in np.nonzero(light)[0]),
        default_interval=int(host.default_interval),
        num_tris=int(len(tris)),
        num_nodes=int(q) if q else 1,
        max_octree_depth=int(getattr(oct, "max_depth", 0) if oct is not None else 0),
        use_footprint_tex=bool(quads.size * 4 <= 48 * 1024 * 1024),
        any_flash=bool((flash_period > 0).any()),
        mesh_chunk_counts=chunk_counts,
        textured_ids=tuple(int(i) for i in np.nonzero(tex_offset != -1)[0]),
    )
    return scene, meta


def _tensor(x, device, dtype):
    return torch.as_tensor(np.array(x, order="C")).to(device=device, dtype=dtype)


def _to_device(src, device) -> Scene:
    """Scene from an object holding the Scene fields as numpy arrays (nested
    ObjectsSoA / MeshArrays / MeshStatic fields by name)."""
    f32, i32 = torch.float32, torch.int32

    def conv(nt_cls, obj, dtypes):
        return nt_cls(**{f: None if getattr(obj, f) is None
                         else _tensor(getattr(obj, f), device, dtypes.get(f, f32))
                         for f in nt_cls._fields})

    int_objects = dict.fromkeys(("obj_type", "mesh_root", "tex_offset", "tex_w", "tex_h"), i32)
    int_mesh = dict.fromkeys(("tri_v", "tri_uv", "tri_n", "node_tris_index", "node_tris_count",
                              "node_children", "node_neighbors", "oct_tris"), i32)
    objects = conv(ObjectsSoA, src.objects, {**int_objects, "light": torch.bool})
    tex_fp = _tensor(src.tex_fp, device, i32)
    return Scene(
        objects=objects,
        mesh=conv(MeshArrays, src.mesh, int_mesh),
        textures=_tensor(src.textures, device, torch.uint8),
        # packed texels are < 2^24: int32 holds the uint32 values exactly
        textures_packed=_tensor(np.asarray(src.textures_packed, np.int64), device, i32),
        tex_quads=_tensor(np.asarray(src.tex_quads, np.int64), device, i32),
        tex_fp=tex_fp,
        # per scene, not per frame: the table is some 50 small ops
        tex_table=texture_table(objects.tex_w, objects.tex_h, tex_fp),
        tex_textured=objects.tex_offset != -1,
        mesh_static=tuple(conv(MeshStatic, ms, {}) for ms in src.mesh_static),
        white_point=_tensor(src.white_point, device, f32),
        ambient=_tensor(src.ambient, device, f32),
        mesh_batch=None if getattr(src, "mesh_batch", None) is None
        else conv(MeshBatchStatic, src.mesh_batch, {}),
    )


def scene_from_numpy(arrays, device=DEFAULT_DEVICE) -> Scene:
    """The port's Scene from the JAX package's Scene with numpy leaves
    (e.g. `jax.tree.map(np.asarray, scene)`), so tests can feed identical
    state to both packages. The multi-mesh pool carries over as it is; a
    large-tier mesh's records (lane-major, for the TPU's DMAs) become the
    port's general triangle rows."""
    from ..ops.kernels.mesh_kernels import general_tri_rows

    scene = _to_device(arrays, device)
    return scene._replace(mesh_static=tuple(
        ms if ms.gen_rec is None else ms._replace(gen_rec=general_tri_rows(ms.gen_cols))
        for ms in scene.mesh_static))
