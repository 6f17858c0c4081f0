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
"""

from __future__ import annotations

import torch

from .intersect import INF, apply_affine3, apply_linear3, apply_normal3, norm3, normalize3
from .kernels.mesh_kernels import general_min_t, shared_nearest_hit


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
    d3 (3, N), through the K5 walk. Returns (t, normal (3, N), uv (2, N),
    valid); t is the shared 4D ray parameter, converted through the world
    distance as intersect_octree does (opencl_kernel.cl:301-303)."""
    n = d3.shape[1]
    if tri_count(perm) == 0:
        dev = d3.device
        return (torch.full((n,), INF, device=dev), torch.zeros((3, n), device=dev),
                torch.zeros((2, n), device=dev), torch.zeros((n,), dtype=torch.bool, device=dev))
    ro = apply_affine3(inv_m, o3)
    d = apply_linear3(inv_m, d3)
    dh = d / norm3(d)
    consts, c_t, _, _ = shared_origin_constants(mesh, ro, perm)
    bt, bu, bv, btri, battr = shared_nearest_hit(consts, c_t, static.attrs, static.spheres,
                                                 dh, ro)
    valid = btri >= 0
    interp = battr[0:5] + bu * battr[5:10] + bv * battr[10:15]
    normal = normalize3(apply_normal3(inv_m, interp[0:3]))
    world_pt = apply_affine3(m4, ro[:, None] + bt * dh)
    t = norm3(world_pt - o3[:, None]) / norm3(d3)
    return torch.where(valid, t, INF), normal, interp[3:5], valid


def mesh_min_t_general(mesh, m4, inv_m, o3, d3, perm, static, tmax):
    """Min hit parameter of rays with per-lane origins o3 (3, N) and dirs
    d3 (3, N), bounded by tmax (N,) in ray-parameter units, through the K6
    walk. Lanes with tmax == 0 are masked: they leave the culling cones and
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
    bt = general_min_t(static.gen_cols, static.gen_spheres, r10, tmax_obj, valid, tcut_obj)
    world_pt = apply_affine3(m4, ro + bt * dh)
    t = norm3(world_pt - o3) / norm3(d3)
    return torch.where(bt < INF, t, INF)
