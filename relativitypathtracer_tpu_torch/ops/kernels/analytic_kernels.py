"""Analytic primitives (spheres, cubes): K3, the shared-origin nearest hit.

Torch counterpart of `relativitypathtracer_tpu.ops.pallas.analytic_kernels`
(`pack_analytic_params`, `_finish_uv`, `analytic_nearest_shared`). Each
object's frame chain (Lorentz boost, then inverse model matrix) is fused into
one 32-float row per frame, so rays enter in the camera frame. Geometry as
intersect_sphere / intersect_cube (opencl_kernel.cl:312-359).

`analytic_nearest_shared` launches the CUDA kernel
(csrc/analytic_kernels.cu) on CUDA tensors and calls its plain twin
`analytic_nearest_plain` on CPU tensors. Both walk every object, spheres
before cubes, and compute the spherical UVs themselves.
"""

from __future__ import annotations

import math

import torch

from ._build import check_cuda, launch

EPSILON = 1e-7
INF = 1e20
# params row: [0:12) A, the (3, 4) dir transform row-major | [12:15) the
# object-space origin | [15:24) inv_m[:3, :3]^T row-major | [24] object id
PARAM_COLS = 32


def pack_analytic_params(L, inv_m, stat_cam, ids):
    """(G, PARAM_COLS) kernel constants for the objects `ids` (spheres first,
    then cubes). L: (O, 4, 4) camera -> rest frame; inv_m: (O, 4, 4);
    stat_cam: (O, 4) camera event in each rest frame."""
    idx = torch.as_tensor(ids, dtype=torch.long, device=L.device)
    R = inv_m[idx][:, :3, :3]
    A = torch.einsum("gij,gjk->gik", R, L[idx][:, 1:4, :])
    ro = torch.einsum("gij,gj->gi", R, stat_cam[idx][:, 1:4]) + inv_m[idx][:, :3, 3]
    nt = R.transpose(1, 2).reshape(-1, 9)
    rows = torch.cat([A.reshape(-1, 12), ro, nt, idx.to(torch.float32)[:, None]], dim=1)
    return torch.nn.functional.pad(rows, (0, PARAM_COLS - rows.shape[1])).contiguous()


def _finish_uv(kind, s3):
    """Spherical UVs from the winner's object-space point (kind 0), or the
    cube UVs the walk already formed (kind 1)."""
    u_s = 0.5 + torch.atan2(s3[2], s3[0]) / (2.0 * math.pi)
    v_s = torch.asin(torch.clamp(s3[1], -1.0, 1.0)) / math.pi + 0.5
    is_sphere = kind == 0.0
    return torch.stack([torch.where(is_sphere, u_s, s3[0]), torch.where(is_sphere, v_s, s3[1])])


def _rows3(p, base: int, stride: int, v):
    """[sum_j p[base + stride*ax + j] * v[j] for ax in 0..2], left to right."""
    out = []
    for ax in range(3):
        acc = p[base + stride * ax] * v[0]
        for j in range(1, len(v)):
            acc = acc + p[base + stride * ax + j] * v[j]
        out.append(acc)
    return out


def analytic_nearest_plain(params, dir4, n_spheres: int, n_cubes: int):
    """Plain twin of the K3 kernel: every object in order, strict <.
    Returns (t (N,), normal (3, N), uv (2, N), obj (N,) int32)."""
    n = dir4.shape[1]
    dev = dir4.device
    w = [dir4[i] for i in range(4)]
    best_t = torch.full((n,), INF, device=dev)
    best_obj = torch.zeros((n,), device=dev)
    best_kind = torch.zeros((n,), device=dev)
    best_n = [torch.zeros((n,), device=dev) for _ in range(3)]
    best_s = [torch.zeros((n,), device=dev) for _ in range(3)]
    for g in range(n_spheres + n_cubes):
        p = params[g]
        d = _rows3(p, 0, 4, w)
        scale = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        dh = [dk / scale for dk in d]
        ro = [p[12 + k] for k in range(3)]
        if g < n_spheres:
            b = -(ro[0] * dh[0] + ro[1] * dh[1] + ro[2] * dh[2])
            c = ro[0] * ro[0] + ro[1] * ro[1] + ro[2] * ro[2] - 1.0
            disc = b * b - c
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            near = b - sq
            far = b + sq
            use_near = near > EPSILON
            dist = torch.where(use_near, near, far)
            valid = (disc >= 0.0) & (use_near | (far > EPSILON))
            s3 = [ro[k] + dh[k] * dist for k in range(3)]
            nin = s3
        else:
            inside = torch.maximum(torch.maximum(ro[0].abs(), ro[1].abs()), ro[2].abs()) < 1.0
            winding = torch.where(inside, -1.0, 1.0)
            sgn = [-torch.sign(dh[k]) for k in range(3)]
            dc = [(winding * sgn[k] - ro[k]) / dh[k] for k in range(3)]

            def face(ax, a1, a2):
                p1 = (ro[a1] + dh[a1] * dc[ax]).abs()
                p2 = (ro[a2] + dh[a2] * dc[ax]).abs()
                return (dc[ax] >= 0.0) & (p1 < 1.0) & (p2 < 1.0)

            tx, ty, tz = face(0, 1, 2), face(1, 2, 0), face(2, 0, 1)
            zero = torch.zeros_like(dc[0])
            nin = [torch.where(tx, sgn[0], zero), torch.where(~tx & ty, sgn[1], zero),
                   torch.where(~tx & ~ty & tz, sgn[2], zero)]
            on_x, on_y = nin[0] != 0.0, nin[1] != 0.0
            dist = torch.where(on_x, dc[0], torch.where(on_y, dc[1], dc[2]))
            valid = on_x | on_y | (nin[2] != 0.0)
            pt = [ro[k] + dh[k] * dist for k in range(3)]
            u = torch.where(on_x, pt[1], pt[0])
            v = torch.where(on_x | on_y, pt[2], pt[1])
            s3 = [(u + 1.0) / 2.0, (v + 1.0) / 2.0, zero]
        nt = _rows3(p, 15, 3, nin)
        inv = 1.0 / torch.sqrt(nt[0] * nt[0] + nt[1] * nt[1] + nt[2] * nt[2])
        t = torch.where(valid, dist / scale, INF)
        better = t < best_t
        best_t = torch.where(better, t, best_t)
        best_obj = torch.where(better, p[24], best_obj)
        best_kind = torch.where(better, 0.0 if g < n_spheres else 1.0, best_kind)
        best_n = [torch.where(better, nt[k] * inv, best_n[k]) for k in range(3)]
        best_s = [torch.where(better, s3[k], best_s[k]) for k in range(3)]
    uv = _finish_uv(best_kind, torch.stack(best_s))
    return best_t, torch.stack(best_n), uv, best_obj.to(torch.int32)


def analytic_nearest_shared(params, dir4, n_spheres: int, n_cubes: int):
    """Nearest sphere/cube hit of rays sharing the camera origin. params:
    (G, PARAM_COLS) from pack_analytic_params; dir4: (4, N) camera-frame
    4-directions. Returns (t, normal (3, N) rest frame, uv (2, N), obj (N,)
    int32 global ids); t = INF and obj 0 where nothing was hit."""
    if dir4.device.type == "cpu":
        return analytic_nearest_plain(params, dir4, n_spheres, n_cubes)
    dir4 = dir4.contiguous()
    n = dir4.shape[1]
    check_cuda("analytic_nearest_shared",
               (params, torch.float32, (n_spheres + n_cubes, PARAM_COLS)),
               (dir4, torch.float32, (4, n)))
    t = torch.empty(n, dtype=torch.float32, device=dir4.device)
    obj = torch.empty(n, dtype=torch.int32, device=dir4.device)
    nrm = torch.empty((3, n), dtype=torch.float32, device=dir4.device)
    uv = torch.empty((2, n), dtype=torch.float32, device=dir4.device)
    launch("rpt_analytic_nearest", params, n_spheres, n_cubes, dir4, n, t, obj, nrm, uv)
    return t, nrm, uv, obj
