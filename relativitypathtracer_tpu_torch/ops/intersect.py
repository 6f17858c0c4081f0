"""Batched analytic primitive intersectors (sphere, cube) on (3, N) rays.

Torch counterpart of `relativitypathtracer_tpu.ops.intersect` (the
reference's intersect_sphere / intersect_cube, opencl_kernel.cl:310-359).
Rays live on the last axis: 3-vectors are (3, N), scalars (N,). The slice's
frame path takes spheres through the K3 kernel (ops.kernels.analytic_kernels);
these per-object forms are the readable statement of the same geometry.
"""

from __future__ import annotations

import math

import torch

EPSILON = 1e-7
INF = 1e20


def apply_affine3(m, p):
    """(4, 4) affine applied to (3, ...) points (implicit w = 1)."""
    shape = (3,) + (1,) * (p.dim() - 1)
    return torch.tensordot(m[:3, :3], p, dims=1) + m[:3, 3].reshape(shape)


def apply_linear3(m, d):
    """Linear 3x3 part of a (4, 4) applied to (3, ...) directions."""
    return torch.tensordot(m[:3, :3], d, dims=1)


def apply_normal3(inv_m, n):
    """Inverse-transpose normal transform: inv_m[:3, :3]^T @ n."""
    return torch.tensordot(inv_m[:3, :3].T, n, dims=1)


def norm3(v):
    return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def normalize3(v):
    return v / norm3(v)


def sphere_intersect(inv_m, o3, d3):
    """Unit-sphere hit in object space. inv_m: (4, 4); o3: (3,) or (3, N);
    d3: (3, N). Returns (t, normal (3, N), uv (2, N), valid), t = dist/scale."""
    ro = apply_affine3(inv_m, o3)
    d = apply_linear3(inv_m, d3)
    scale = norm3(d)
    dh = d / scale
    if ro.dim() == 1:
        ro = ro[:, None]
    b = -(ro[0] * dh[0] + ro[1] * dh[1] + ro[2] * dh[2])
    c = ro[0] * ro[0] + ro[1] * ro[1] + ro[2] * ro[2] - 1.0
    disc = b * b - c
    hit = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    near = b - sq
    far = b + sq
    use_near = near > EPSILON
    dist = torch.where(use_near, near, far)
    valid = hit & (use_near | (far > EPSILON))
    t = torch.where(valid, dist / scale, torch.full_like(dist, INF))
    obj_pt = ro + dh * dist
    normal = normalize3(apply_normal3(inv_m, obj_pt))
    u = 0.5 + torch.atan2(obj_pt[2], obj_pt[0]) / (2.0 * math.pi)
    v = torch.asin(torch.clamp(obj_pt[1], -1.0, 1.0)) / math.pi + 0.5
    return t, normal, torch.stack([u, v]), valid


def cube_intersect(inv_m, o3, d3):
    """Unit-cube [-1, 1]^3 slab hit (Majercik et al., opencl_kernel.cl:312-333).
    Shapes as sphere_intersect."""
    ro = apply_affine3(inv_m, o3)
    d = apply_linear3(inv_m, d3)
    scale = norm3(d)
    dh = d / scale
    if ro.dim() == 1:
        ro = ro[:, None]
    ro = ro.expand_as(dh)
    inside = torch.maximum(torch.maximum(ro[0].abs(), ro[1].abs()), ro[2].abs()) < 1.0
    winding = torch.where(inside, -1.0, 1.0)
    sgn = -torch.sign(dh)
    dcand = (winding * sgn - ro) / dh

    def face_test(axis, a1, a2):
        da = dcand[axis]
        p1 = (ro[a1] + dh[a1] * da).abs()
        p2 = (ro[a2] + dh[a2] * da).abs()
        return (da >= 0.0) & (p1 < 1.0) & (p2 < 1.0)

    tx = face_test(0, 1, 2)
    ty = face_test(1, 2, 0)
    tz = face_test(2, 0, 1)
    zero = torch.zeros_like(dh[0])
    sx = torch.where(tx, sgn[0], zero)
    sy = torch.where(~tx & ty, sgn[1], zero)
    sz = torch.where(~tx & ~ty & tz, sgn[2], zero)
    dist = torch.where(sx != 0.0, dcand[0], torch.where(sy != 0.0, dcand[1], dcand[2]))
    valid = (sx != 0.0) | (sy != 0.0) | (sz != 0.0)
    t = torch.where(valid, dist / scale, torch.full_like(dist, INF))
    obj_pt = ro + dh * dist
    normal = normalize3(apply_normal3(inv_m, torch.stack([sx, sy, sz])))
    on_x = sx != 0.0
    on_y = sy != 0.0
    u = torch.where(on_x, obj_pt[1], obj_pt[0])
    v = torch.where(on_x | on_y, obj_pt[2], obj_pt[1])
    return t, normal, torch.stack([(u + 1.0) / 2.0, (v + 1.0) / 2.0]), valid
