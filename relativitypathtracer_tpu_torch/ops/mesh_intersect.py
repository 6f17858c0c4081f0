"""Ray/triangle-mesh intersection for one mesh object, through the K5/K6 walks.

Torch counterpart of the kernel routes of `relativitypathtracer_tpu.ops.
mesh_intersect` (Moller-Trumbore, opencl_kernel.cl:106-126, factored into
per-triangle constants):

* Shared-origin rays (all primary rays of an object start at its
  stationaryCam): with o - A constant per triangle, det, u_num and v_num are
  dot products of the ray direction with per-triangle 3-vectors and t_num is
  a per-triangle scalar (`shared_origin_constants`).
* General rays (per-lane shadow-ray origins): the ray lifts to the Plucker
  10-vector [d, o x d, o, 1] and each factor is a dot product with a
  per-triangle operator (`general_ray_constants`).

Triangles are taken in the mesh's Morton order (`perm`, absolute ids) and
padded to a multiple of 256 with zero rows, which the det epsilon rejects.
Rays are on the last axis: directions (3, N), origins (3,) or (3, N).

A mesh in the large tier (its MeshStatic carries `gen_rec`, see
models.scene) walks through K11/K12 instead of K5/K6. Several mesh objects
with a fused pool (Scene.mesh_batch) go through K9/K10 in one walk
(`mesh_intersect_shared_batched`, `mesh_min_t_general_batched`).
"""

from __future__ import annotations

import torch

from .intersect import INF, apply_affine3, apply_linear3, apply_normal3, norm3, normalize3
from .kernels._build import constant
from .kernels.mesh_batch import (
    batched_min_t_general, batched_nearest_shared, mat_row, pool_boxes)
from .kernels.mesh_kernels import general_min_t, shared_nearest_hit
from .kernels.mesh_large import LARGE_T, large_general_min_t, large_shared_nearest_hit

# Tier override, read when a scene is built (models.scene): None takes the
# large tier for T_pad > LARGE_T, True for every mesh (the tests force it on
# small meshes), False as None, as in the JAX package.
LARGE_MODE = None


def large_tier_threshold() -> int:
    """T_pad above which a mesh is built for the large tier."""
    return -1 if LARGE_MODE else LARGE_T


def _cross_cols(a, b):
    """Cross product over the last axis of (T, 3) rows."""
    return torch.stack([
        a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0],
    ], dim=-1)


def _pad_rows(x, T_pad: int):
    return torch.nn.functional.pad(x, (0, 0, 0, T_pad - x.shape[0]))


def tri_count(perm) -> int:
    return int(perm.shape[0])


def padded_tri_count(T: int) -> int:
    """T rounded up to a multiple of 256 (a multiple of every chunk size)."""
    return -(-max(T, 1) // 256) * 256


def mesh_tri_vertices(mesh, perm):
    """(A, B, C) vertex rows (T, 3) of the absolute triangle ids `perm`."""
    tv = mesh.tri_v[perm].long()
    return mesh.vertices[tv[:, 0]], mesh.vertices[tv[:, 1]], mesh.vertices[tv[:, 2]]


def shared_origin_constants(mesh, ro, perm):
    """Per-triangle constants for rays from the object-space origin ro (3,):
    (consts (4 * T_pad, 3) = [cross(e2, e1); cross(e2, ro - A); qvec; ct in
    column 0], c_t (T_pad,), T, T_pad)."""
    T = tri_count(perm)
    A, B, C = mesh_tri_vertices(mesh, perm)
    e1 = B - A
    e2 = C - A
    qvec = _cross_cols(ro[None, :] - A, e1)
    c_det = _cross_cols(e2, e1)
    c_u = _cross_cols(e2, ro[None, :] - A)
    c_t = torch.sum(e2 * qvec, dim=-1)
    T_pad = padded_tri_count(T)
    c_t = torch.nn.functional.pad(c_t, (0, T_pad - T))
    ct_block = torch.cat([c_t[:, None], torch.zeros((T_pad, 2), device=c_t.device)], dim=1)
    consts = torch.cat([_pad_rows(c_det, T_pad), _pad_rows(c_u, T_pad),
                        _pad_rows(qvec, T_pad), ct_block], dim=0)
    return consts, c_t, T, T_pad


def tri_attr_matrix(mesh, perm, T_pad: int):
    """(T_pad, 15) operators [nA uvA | nB-nA uvB-uvA | nC-nA uvC-uvA] so that
    attr(u, v) = base + u * du + v * dv is the barycentric interpolation."""
    tn = mesh.tri_n[perm].long()
    tuv = mesh.tri_uv[perm].long()
    nA, nB, nC = (mesh.normals[tn[:, k]] for k in range(3))
    uA, uB, uC = (mesh.uvs[tuv[:, k]] for k in range(3))
    return _pad_rows(torch.cat([nA, uA, nB - nA, uB - uA, nC - nA, uC - uA], dim=1), T_pad)


def general_ray_constants(mesh, perm):
    """Factor-grouped Plucker operators (4 * T_pad, 10): rows [0, T_pad) are
    the det operators, then the u, v and t blocks."""
    T_pad = padded_tri_count(tri_count(perm))
    A, B, C = mesh_tri_vertices(mesh, perm)
    e1 = B - A
    e2 = C - A
    z3 = torch.zeros_like(A)
    z1 = torch.zeros_like(A[:, :1])
    col_det = torch.cat([_cross_cols(e2, e1), z3, z3, z1], dim=-1)
    col_u = torch.cat([_cross_cols(A, e2), e2, z3, z1], dim=-1)
    col_v = torch.cat([-_cross_cols(A, e1), -e1, z3, z1], dim=-1)
    tnum = -torch.sum(e2 * _cross_cols(A, e1), dim=-1)
    col_t = torch.cat([z3, z3, _cross_cols(e1, e2), tnum[:, None]], dim=-1)
    return torch.cat([_pad_rows(c, T_pad) for c in (col_det, col_u, col_v, col_t)], dim=0)


def mesh_intersect_shared(mesh, m4, inv_m, o3, d3, perm, static):
    """Nearest hit of rays sharing the rest-frame origin o3 (3,) with dirs
    d3 (3, N), through the K5 walk (K11 in the large tier). Returns (t,
    normal (3, N), uv (2, N), valid); t is the shared 4D ray parameter,
    converted through the world distance as intersect_octree does
    (opencl_kernel.cl:301-303)."""
    n = d3.shape[1]
    if tri_count(perm) == 0:
        dev = d3.device
        return (torch.full((n,), INF, device=dev), torch.zeros((3, n), device=dev),
                torch.zeros((2, n), device=dev), torch.zeros((n,), dtype=torch.bool, device=dev))
    ro = apply_affine3(inv_m, o3)
    d = apply_linear3(inv_m, d3)
    dh = d / norm3(d)
    consts, c_t, T, _ = shared_origin_constants(mesh, ro, perm)
    if static.gen_rec is not None:
        bt, bu, bv, btri, battr = large_shared_nearest_hit(consts, c_t, static.attrs,
                                                           static.spheres, dh, ro, T)
    else:
        bt, bu, bv, btri, battr = shared_nearest_hit(consts, c_t, static.attrs,
                                                     static.spheres, dh, ro)
    valid = btri >= 0
    interp = battr[0:5] + bu * battr[5:10] + bv * battr[10:15]
    normal = normalize3(apply_normal3(inv_m, interp[0:3]))
    world_pt = apply_affine3(m4, ro[:, None] + bt * dh)
    t = norm3(world_pt - o3[:, None]) / norm3(d3)
    return torch.where(valid, t, INF), normal, interp[3:5], valid


def mesh_min_t_general(mesh, m4, inv_m, o3, d3, perm, static, tmax):
    """Min hit parameter of rays with per-lane origins o3 (3, N) and dirs
    d3 (3, N), bounded by tmax (N,) in ray-parameter units, through the K6
    walk (K12 in the large tier, with static.gen_rec its triangle rows).
    Lanes with tmax == 0 are masked: they leave the culling cones and
    keep an exact zero bound. A lane's result may be any value >= tmax when
    its nearest hit lies beyond tmax (callers test t < tmax)."""
    n = d3.shape[1]
    if tri_count(perm) == 0:
        return torch.full((n,), INF, device=d3.device)
    ro = apply_affine3(inv_m, o3)
    d = apply_linear3(inv_m, d3)
    dh = d / norm3(d)
    mom = torch.stack([ro[1] * dh[2] - ro[2] * dh[1],
                       ro[2] * dh[0] - ro[0] * dh[2],
                       ro[0] * dh[1] - ro[1] * dh[0]])
    r10 = torch.cat([dh, mom, ro, torch.ones_like(dh[:1])], dim=0)
    # The t-parameter bound in object-space distance, t = bt * |M3 dh| / |d3|,
    # with a 0.1% margin so a miss stays strictly beyond the caller's test;
    # masked lanes keep an exact 0. tcut is the inverse margin below which a
    # hit proves the lane shadowed (occlusion retirement in the walk).
    valid = tmax > 0.0
    tmax_base = tmax * norm3(d3) / norm3(apply_linear3(m4, dh))
    tmax_obj = torch.where(valid, tmax_base * 1.001 + 1e-3, 0.0)
    tcut_obj = torch.where(valid, torch.clamp(tmax_base * 0.999 - 1e-3, min=0.0), 0.0)
    if static.gen_rec is not None:
        # The large tier's lists and bits are at TC granularity (static.spheres).
        bt = large_general_min_t(static.gen_rec, static.spheres, r10, tmax_obj, valid,
                                 tcut_obj, tri_count(perm))
    else:
        bt = general_min_t(static.gen_cols, static.gen_spheres, r10, tmax_obj, valid,
                           tcut_obj)
    world_pt = apply_affine3(m4, ro + bt * dh)
    t = norm3(world_pt - o3) / norm3(d3)
    return torch.where(bt < INF, t, INF)


def _object_scale(m4, dh, d3):
    """Per-lane object distance -> shared ray parameter: |M_R dh| / |d3|."""
    return norm3(apply_linear3(m4, dh)) / norm3(d3)


def mesh_intersect_shared_batched(mesh, meta, batch, L, inv_ms, m4s, stat_cams, dir4, perms):
    """Nearest hit over every mesh object in one K9 walk, for rays from each
    object's camera event. batch: models.scene.MeshBatchStatic; L, inv_ms,
    m4s (O_total, 4, 4) and stat_cams (O_total, 4) indexed by meta.mesh_ids;
    dir4 (4, N) camera-frame 4-dirs; perms from render.mesh_perm_tensors.
    Returns (t, normal (3, N) in the winner's rest frame, uv (2, N), obj
    (N,) global id, valid), mergeable with the analytic candidates. t comes
    out of the walk in shared units: it is not converted through the world
    distance as in the one-mesh route."""
    n = dir4.shape[1]
    consts = ([], [], [], [])
    mats, d_os, o_os, s_os = [], [], [], []
    for k, i in enumerate(meta.mesh_ids):
        d4 = L[i] @ dir4
        ro = apply_affine3(inv_ms[i], stat_cams[i, 1:4])
        d = apply_linear3(inv_ms[i], d4[1:4])
        dh = d / norm3(d)
        cst, _, _, T_pad = shared_origin_constants(mesh, ro, perms[k])
        for f in range(4):
            consts[f].append(cst[f * T_pad:(f + 1) * T_pad])
        d_os.append(dh)
        o_os.append(ro)
        s_os.append(_object_scale(m4s[i], dh, d4[1:4]))
        mats.append(mat_row(L[i], inv_ms[i], m4s[i], ro))
    boxes = torch.cat([pool_boxes(batch.spheres, meta.mesh_chunk_counts), torch.stack(o_os)], 1)
    t, bu, bv, btri, slot, battr = batched_nearest_shared(
        torch.cat(sum(consts, [])), batch.attrs, batch.spheres, boxes,
        torch.stack(mats), dir4, torch.stack(d_os),
        torch.stack(o_os)[:, :, None].expand(len(o_os), 3, n), torch.stack(s_os),
        meta.mesh_chunk_counts)
    valid = btri >= 0
    interp = battr[0:5] + bu * battr[5:10] + bv * battr[10:15]
    # The winner's normal transform and global id by integer gathers on its
    # slot (the JAX package selects them with f32 one-hot products).
    slot_l = slot.clamp(min=0).long()
    ids = constant(meta.mesh_ids, torch.int32, dir4.device)
    nt = torch.stack([inv_ms[i][:3, :3].T for i in meta.mesh_ids])[slot_l]  # (N, 3, 3)
    n3 = interp[0:3]
    normal = normalize3(torch.stack([nt[:, r, 0] * n3[0] + nt[:, r, 1] * n3[1]
                                     + nt[:, r, 2] * n3[2] for r in range(3)]))
    obj = torch.where(valid, ids[slot_l], 0)
    return torch.where(valid, t, INF), normal, interp[3:5], obj, valid


def mesh_min_t_general_batched(meta, batch, L, inv_ms, m4s, origins4, dir4, exclude_id, tmax):
    """Min hit over every mesh object but `exclude_id` (the light) in one
    K10 walk, for shadow rays with camera-frame 4-origins and 4-dirs (4, N),
    bounded by tmax (N,) in shared units (0 masks a lane). Returns (N,)
    min(t, tmax) in shared units."""
    d_os, o_os, s_os, mats = [], [], [], []
    for i in meta.mesh_ids:
        o4 = L[i] @ origins4
        d4 = L[i] @ dir4
        ro = apply_affine3(inv_ms[i], o4[1:4])
        d = apply_linear3(inv_ms[i], d4[1:4])
        dh = d / norm3(d)
        d_os.append(dh)
        o_os.append(ro)
        s_os.append(_object_scale(m4s[i], dh, d4[1:4]))
        mats.append(mat_row(L[i], inv_ms[i], m4s[i]))
    return batched_min_t_general(
        batch.gen_cols, batch.spheres, torch.stack(mats), origins4, dir4, torch.stack(d_os),
        torch.stack(o_os), torch.stack(s_os), tmax, meta.mesh_chunk_counts,
        enabled=tuple(i != exclude_id for i in meta.mesh_ids), valid=tmax > 0.0)
