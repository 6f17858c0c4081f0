"""Special-relativity and affine-transform math, batched over leading axes.

Torch counterpart of `relativitypathtracer_tpu.ops.relmath` (the reference's
host math, Vector.cpp:94-232). Every function takes tensors, or numpy arrays
and Python sequences that it converts to float32 CPU tensors, so the scene
parser can build model matrices on the host without a device.

Convention: 4-vectors are (t, x, y, z); 4x4 matrices act on column 4-vectors.
"""

from __future__ import annotations

import torch


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32)


def lorentz(v):
    """Symmetric Lorentz boost for 3-velocity v (units of c), Vector.cpp:175-187.

    v: (..., 3) -> (..., 4, 4); v == 0 yields the identity exactly.
    """
    v = _f32(v)
    vsqr = torch.sum(v * v, dim=-1)
    gamma = 1.0 / torch.sqrt(1.0 - vsqr)
    safe_vsqr = torch.where(vsqr == 0.0, torch.ones_like(vsqr), vsqr)
    g1 = (gamma - 1.0) / safe_vsqr
    vg = -v * gamma[..., None]
    top = torch.cat([gamma[..., None], vg], dim=-1)
    outer = v[..., :, None] * v[..., None, :]
    eye3 = torch.eye(3, dtype=v.dtype, device=v.device)
    spatial = eye3 + g1[..., None, None] * outer
    rows = torch.cat([vg[..., :, None], spatial], dim=-1)
    m = torch.cat([top[..., None, :], rows], dim=-2)
    eye4 = torch.eye(4, dtype=v.dtype, device=v.device).expand_as(m)
    return torch.where(vsqr[..., None, None] == 0.0, eye4, m)


def add_velocity(v1, v2):
    """Relativistic velocity composition, v1 boosted by v2 (Vector.cpp:189-193):
    w = (v1 + v2 + gamma / (1 + gamma) * v1 x (v1 x v2)) / (1 + v1 . v2),
    gamma from v1. (..., 3) each."""
    v1 = _f32(v1)
    v2 = _f32(v2)
    gamma = 1.0 / torch.sqrt(1.0 - torch.sum(v1 * v1, dim=-1))
    coef = gamma / (1.0 + gamma)
    num = v1 + v2 + coef[..., None] * torch.linalg.cross(v1, torch.linalg.cross(v1, v2))
    return num / (1.0 + torch.sum(v2 * v1, dim=-1))[..., None]


def matmul4(a, b):
    """Batched 4x4 matrix product a @ b."""
    return torch.einsum("...ij,...jk->...ik", a, b)


def transform4(m, v):
    """(..., 4, 4) applied to (..., 4) 4-vectors (opencl_kernel.cl:84-91)."""
    return torch.einsum("...ij,...j->...i", m, v)


def rotation_axis_angle(angle, axis):
    """Rodrigues rotation about `axis` by `angle` radians (Vector.cpp:151-160);
    angle == 0 yields the identity whatever the axis."""
    angle = _f32(angle)
    axis = _f32(axis)
    c = torch.cos(angle)
    s = torch.sin(angle)
    m = torch.sqrt(torch.sum(axis * axis, dim=-1, keepdim=True))
    u = axis / torch.where(m == 0.0, torch.ones_like(m), m)
    one_c = 1.0 - c
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    r = torch.stack([
        torch.stack([c + ux * ux * one_c, ux * uy * one_c - uz * s, ux * uz * one_c + uy * s], dim=-1),
        torch.stack([uy * ux * one_c + uz * s, c + uy * uy * one_c, uy * uz * one_c - ux * s], dim=-1),
        torch.stack([uz * ux * one_c - uy * s, uz * uy * one_c + ux * s, c + uz * uz * one_c], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=torch.float32, device=r.device).expand_as(r)
    return torch.where(angle[..., None, None] == 0.0, eye, r)


def trs(translation, angle, axis, scale):
    """Model matrix translation * rotation(axis, angle) * scale: the upper
    3x3 is R * diag(scale), the last column the translation."""
    translation = _f32(translation)
    scale = _f32(scale)
    rs = rotation_axis_angle(angle, axis) * scale[..., None, :]
    top = torch.cat([rs, translation[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=top.device).expand(
        *top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def inverse4(m):
    """Analytic 4x4 inverse via the adjugate, term for term as the JAX
    package's inverse4 (calcInvM, Vector.cpp:94-149)."""
    m = _f32(m)

    def det2(r0, r1, c0, c1):
        return m[..., r0, c0] * m[..., r1, c1] - m[..., r0, c1] * m[..., r1, c0]

    A2323 = det2(2, 3, 2, 3)
    A1323 = det2(2, 3, 1, 3)
    A1223 = det2(2, 3, 1, 2)
    A0323 = det2(2, 3, 0, 3)
    A0223 = det2(2, 3, 0, 2)
    A0123 = det2(2, 3, 0, 1)
    A2313 = det2(1, 3, 2, 3)
    A1313 = det2(1, 3, 1, 3)
    A1213 = det2(1, 3, 1, 2)
    A2312 = det2(1, 2, 2, 3)
    A1312 = det2(1, 2, 1, 3)
    A1212 = det2(1, 2, 1, 2)
    A0313 = det2(1, 3, 0, 3)
    A0213 = det2(1, 3, 0, 2)
    A0312 = det2(1, 2, 0, 3)
    A0212 = det2(1, 2, 0, 2)
    A0113 = det2(1, 3, 0, 1)
    A0112 = det2(1, 2, 0, 1)

    m00, m01, m02, m03 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2], m[..., 0, 3]
    m10, m11, m12, m13 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2], m[..., 1, 3]

    det = (
        m00 * (m11 * A2323 - m12 * A1323 + m13 * A1223)
        - m01 * (m10 * A2323 - m12 * A0323 + m13 * A0223)
        + m02 * (m10 * A1323 - m11 * A0323 + m13 * A0123)
        - m03 * (m10 * A1223 - m11 * A0223 + m12 * A0123)
    )
    inv_det = 1.0 / det
    r0 = torch.stack([
        m11 * A2323 - m12 * A1323 + m13 * A1223,
        -(m01 * A2323 - m02 * A1323 + m03 * A1223),
        m01 * A2313 - m02 * A1313 + m03 * A1213,
        -(m01 * A2312 - m02 * A1312 + m03 * A1212),
    ], dim=-1)
    r1 = torch.stack([
        -(m10 * A2323 - m12 * A0323 + m13 * A0223),
        m00 * A2323 - m02 * A0323 + m03 * A0223,
        -(m00 * A2313 - m02 * A0313 + m03 * A0213),
        m00 * A2312 - m02 * A0312 + m03 * A0212,
    ], dim=-1)
    r2 = torch.stack([
        m10 * A1323 - m11 * A0323 + m13 * A0123,
        -(m00 * A1323 - m01 * A0323 + m03 * A0123),
        m00 * A1313 - m01 * A0313 + m03 * A0113,
        -(m00 * A1312 - m01 * A0312 + m03 * A0112),
    ], dim=-1)
    r3 = torch.stack([
        -(m10 * A1223 - m11 * A0223 + m12 * A0123),
        m00 * A1223 - m01 * A0223 + m02 * A0123,
        -(m00 * A1213 - m01 * A0213 + m02 * A0113),
        m00 * A1212 - m01 * A0212 + m02 * A0112,
    ], dim=-1)
    return torch.stack([r0, r1, r2, r3], dim=-2) * inv_det[..., None, None]
