"""Analytic primitives (spheres, cubes): K3, the shared-origin nearest hit,
and K7, the occlusion min-t of shadow rays with per-lane origins.

Torch counterpart of `relativitypathtracer_tpu.ops.pallas.analytic_kernels`
(`pack_analytic_params`, `pack_analytic_params_general`, `_finish_uv`,
`analytic_nearest_shared`, `analytic_min_t_general`). Each object's frame
chain (Lorentz boost, then inverse model matrix) is fused into one 32-float
row per frame, so rays enter in the camera frame. Geometry as
intersect_sphere / intersect_cube (opencl_kernel.cl:312-359).

`analytic_nearest_shared` and `analytic_min_t_general` call the operators
torch.ops.rpt.analytic_nearest and torch.ops.rpt.analytic_min_t, which launch
their CUDA kernels (csrc/analytic_kernels.cu) on CUDA tensors and run their
plain twins `analytic_nearest_plain` and `analytic_min_t_plain` on CPU
tensors. All walk
every object in index order, spheres before cubes (the JAX kernels walk
per-block culled lists from 5 objects of a kind on); K3 computes the
spherical UVs itself. The kernels skip an object for a warp whose 32 lanes
all fail a bounding-sphere pre-test (`object_may_hit_plain`), which never
fails a lane the full test hits, so their results equal the twins'.
"""

from __future__ import annotations

import math

import torch

from ._build import check_cuda, constant, counter, define_op, launch, on_cpu

EPSILON = 1e-7
INF = 1e20
# The kernels' per-lane pre-test (object_may_hit_plain), with the margins
# that csrc/analytic_kernels.cu derives ("The pre-test's margins"):
PRETEST_KAPPA = 2.0 ** -14  # slack of the discriminant, relative to |d|^2 (|ro|^2 + r^2)
PRETEST_MU = 2.0 ** -14  # slack of "the origin lies outside", relative to |ro|^2
PRETEST_DD_MIN = 2.0 ** -100  # below this |d|^2 a lane always may hit
WARP = 32  # lanes that vote together in the kernels
# params row: [0:12) A, the (3, 4) dir transform row-major | [12:15) the
# object-space origin | [15:24) inv_m[:3, :3]^T row-major | [24] object id
PARAM_COLS = 32


def pack_analytic_params(L, inv_m, stat_cam, ids):
    """(G, PARAM_COLS) kernel constants for the objects `ids` (spheres first,
    then cubes). L: (O, 4, 4) camera -> rest frame; inv_m: (O, 4, 4);
    stat_cam: (O, 4) camera event in each rest frame."""
    idx = constant(ids, torch.long, L.device)
    R = inv_m[idx][:, :3, :3]
    A = torch.einsum("gij,gjk->gik", R, L[idx][:, 1:4, :])
    ro = torch.einsum("gij,gj->gi", R, stat_cam[idx][:, 1:4]) + inv_m[idx][:, :3, 3]
    nt = R.transpose(1, 2).reshape(-1, 9)
    rows = torch.cat([A.reshape(-1, 12), ro, nt, idx.to(torch.float32)[:, None]], dim=1)
    return torch.nn.functional.pad(rows, (0, PARAM_COLS - rows.shape[1])).contiguous()


def pack_analytic_params_general(L, inv_m, ids):
    """pack_analytic_params for rays with per-lane origins: columns [12:15)
    hold inv_m's translation, and the kernel forms ro = A @ o4 + b."""
    idx = constant(ids, torch.long, L.device)
    R = inv_m[idx][:, :3, :3]
    A = torch.einsum("gij,gjk->gik", R, L[idx][:, 1:4, :])
    nt = R.transpose(1, 2).reshape(-1, 9)
    rows = torch.cat([A.reshape(-1, 12), inv_m[idx][:, :3, 3], nt,
                      idx.to(torch.float32)[:, None]], dim=1)
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


def _sphere_hit(ro, dh):
    """Unit-sphere hit in object space; ro, dh: 3 lists of (N,) (or scalar)
    origin and unit direction components. Returns (dist along dh, valid)."""
    b = -(ro[0] * dh[0] + ro[1] * dh[1] + ro[2] * dh[2])
    c = ro[0] * ro[0] + ro[1] * ro[1] + ro[2] * ro[2] - 1.0
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    near = b - sq
    far = b + sq
    use_near = near > EPSILON
    return torch.where(use_near, near, far), (disc >= 0.0) & (use_near | (far > EPSILON))


def _cube_hit(ro, dh):
    """Unit-cube [-1, 1]^3 slab hit. Returns (dist, valid, nin: the hit
    face's object-space normal as 3 (N,) components, one non-zero)."""
    inside = torch.maximum(torch.maximum(torch.abs(ro[0]), torch.abs(ro[1])),
                           torch.abs(ro[2])) < 1.0
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
    dist = torch.where(nin[0] != 0.0, dc[0], torch.where(nin[1] != 0.0, dc[1], dc[2]))
    valid = (nin[0] != 0.0) | (nin[1] != 0.0) | (nin[2] != 0.0)
    return dist, valid, nin


def object_may_hit_plain(params, dir4, n_spheres: int, n_cubes: int, origins4=None):
    """The per-lane pre-test of the K3 and K7 kernels, in their fp32
    operations: (G, N) bool, whether lane j may hit object g. False only
    where the object-space line ro + s d, s >= 0 (d = A @ w as the full test
    forms it; ro the shared origin of the row, or A @ origins4 + b per lane
    for K7) provably misses the object's bounding sphere |x|^2 <= r^2 (r^2 = 1
    for a sphere, 3 for the cube [-1, 1]^3), so that the full test finds no
    hit there. With rr = |ro|^2, c = rr - r^2, rd = ro . d, dd = |d|^2 and
    disc = rd^2 - dd c, a lane is dead where disc is finite, dd >=
    PRETEST_DD_MIN and either disc < -dd PRETEST_KAPPA (rr + r^2) (the line
    misses the sphere) or rd > 0 and c > PRETEST_MU rr (it starts outside
    and moves away). Any NaN or infinity reads as "may hit". The kernels do
    not apply tmax; their masked lanes (K7's tmax == 0, lanes past N) vote
    no. Used by the tests and chip_smoke.py, never on the frame path."""
    w = [dir4[i] for i in range(4)]
    o = None if origins4 is None else [origins4[i] for i in range(4)]
    rows = []
    for g in range(n_spheres + n_cubes):
        p = params[g]
        r2 = 1.0 if g < n_spheres else 3.0
        d = _rows3(p, 0, 4, w)
        if o is None:
            ro = [p[12 + k] for k in range(3)]
        else:
            ro = [r + p[12 + k] for k, r in enumerate(_rows3(p, 0, 4, o))]
        rr = ro[0] * ro[0] + ro[1] * ro[1] + ro[2] * ro[2]
        c = rr - r2
        kr = PRETEST_KAPPA * (rr + r2)
        mr = PRETEST_MU * rr
        rd = ro[0] * d[0] + ro[1] * d[1] + ro[2] * d[2]
        dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        disc = rd * rd - dd * c
        dead = (torch.isfinite(disc) & (dd >= PRETEST_DD_MIN)
                & ((disc < -(dd * kr)) | ((rd > 0.0) & (c > mr))))
        rows.append(~dead)
    if not rows:
        return torch.zeros((0, dir4.shape[1]), dtype=torch.bool, device=dir4.device)
    return torch.stack(rows)


def warp_votes_plain(may):
    """(warp, object) pairs whose vote runs the kernel's full test: the
    groups of WARP consecutive lanes of `may` (G, N) with any lane True
    (lanes past N vote no)."""
    G, n = may.shape
    pad = -n % WARP
    may = torch.cat([may, may.new_zeros((G, pad))], dim=1)
    return int(may.reshape(G, -1, WARP).any(dim=2).sum())


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
            dist, valid = _sphere_hit(ro, dh)
            s3 = [ro[k] + dh[k] * dist for k in range(3)]
            nin = s3
        else:
            dist, valid, nin = _cube_hit(ro, dh)
            on_x, on_y = nin[0] != 0.0, nin[1] != 0.0
            pt = [ro[k] + dh[k] * dist for k in range(3)]
            u = torch.where(on_x, pt[1], pt[0])
            v = torch.where(on_x | on_y, pt[2], pt[1])
            s3 = [(u + 1.0) / 2.0, (v + 1.0) / 2.0, torch.zeros_like(dist)]
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


def _nearest_cuda(params, dir4, n_spheres: int, n_cubes: int, count: bool):
    n = dir4.shape[1]
    check_cuda("analytic_nearest_shared",
               (params, torch.float32, (n_spheres + n_cubes, PARAM_COLS)),
               (dir4, torch.float32, (4, n)))
    t, nrm, uv, obj, _ = _nearest_fake(params, dir4, n_spheres, n_cubes, count)
    tested = counter(dir4, count)
    launch("rpt_analytic_nearest", params, n_spheres, n_cubes, dir4, n, t, obj, nrm, uv,
           tested if count else None)
    return t, nrm, uv, obj, tested


def _nearest_cpu(params, dir4, n_spheres: int, n_cubes: int, count: bool):
    return (*analytic_nearest_plain(params, dir4, n_spheres, n_cubes), counter(dir4, count))


def _nearest_fake(params, dir4, n_spheres: int, n_cubes: int, count: bool):
    n = dir4.shape[1]
    f32 = torch.float32
    return (dir4.new_empty(n, dtype=f32), dir4.new_empty((3, n), dtype=f32),
            dir4.new_empty((2, n), dtype=f32), dir4.new_empty(n, dtype=torch.int32),
            dir4.new_empty(1 if count else 0, dtype=torch.int32))


_nearest_op = define_op(
    "analytic_nearest", "(Tensor params, Tensor dir4, int n_spheres, int n_cubes, bool count) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor)", _nearest_cuda, _nearest_cpu, _nearest_fake)


def analytic_nearest_shared(params, dir4, n_spheres: int, n_cubes: int, tested=None):
    """Nearest sphere/cube hit of rays sharing the camera origin. params:
    (G, PARAM_COLS) from pack_analytic_params; dir4: (4, N) camera-frame
    4-directions. Returns (t, normal (3, N) rest frame, uv (2, N), obj (N,)
    int32 global ids); t = INF and obj 0 where nothing was hit. tested, a
    (1,) int32 tensor on the card, gains the (warp, object) pairs that ran
    the kernel's full test (warp_votes_plain of object_may_hit_plain); CPU
    tensors leave it; the frame path passes none."""
    if not on_cpu("analytic_nearest_shared", dir4):
        dir4 = dir4.contiguous()
    t, nrm, uv, obj, count = _nearest_op(params, dir4, n_spheres, n_cubes, tested is not None)
    if tested is not None:
        tested += count
    return t, nrm, uv, obj


def analytic_min_t_plain(params, origins4, dir4, n_spheres: int, n_cubes: int, tmax):
    """Plain twin of the K7 kernel: the minimum hit parameter over every
    object, INF on lanes with tmax == 0 (their result is not read)."""
    w = [dir4[i] for i in range(4)]
    o = [origins4[i] for i in range(4)]
    best = torch.full(tmax.shape, INF, device=tmax.device, dtype=dir4.dtype)
    for g in range(n_spheres + n_cubes):
        p = params[g]
        d = _rows3(p, 0, 4, w)
        ro = [r + p[12 + k] for k, r in enumerate(_rows3(p, 0, 4, o))]
        scale = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        dh = [dk / scale for dk in d]
        dist, valid = _sphere_hit(ro, dh) if g < n_spheres else _cube_hit(ro, dh)[:2]
        best = torch.minimum(best, torch.where(valid, dist / scale, INF))
    return torch.where(tmax == 0.0, INF, best)


def _min_t_cuda(params, origins4, dir4, n_spheres: int, n_cubes: int, tmax, count: bool):
    n = dir4.shape[1]
    check_cuda("analytic_min_t_general",
               (params, torch.float32, (n_spheres + n_cubes, PARAM_COLS)),
               (origins4, torch.float32, (4, n)), (dir4, torch.float32, (4, n)),
               (tmax, torch.float32, (n,)))
    t = dir4.new_empty(n, dtype=torch.float32)
    tested = counter(dir4, count)
    launch("rpt_analytic_min_t", params, n_spheres, n_cubes, origins4, dir4, tmax, n, t,
           tested if count else None)
    return t, tested


def _min_t_cpu(params, origins4, dir4, n_spheres: int, n_cubes: int, tmax, count: bool):
    return (analytic_min_t_plain(params, origins4, dir4, n_spheres, n_cubes, tmax),
            counter(dir4, count))


def _min_t_fake(params, origins4, dir4, n_spheres: int, n_cubes: int, tmax, count: bool):
    return (dir4.new_empty(dir4.shape[1], dtype=torch.float32),
            dir4.new_empty(1 if count else 0, dtype=torch.int32))


_min_t_op = define_op(
    "analytic_min_t", "(Tensor params, Tensor origins4, Tensor dir4, int n_spheres, "
    "int n_cubes, Tensor tmax, bool count) -> (Tensor, Tensor)", _min_t_cuda, _min_t_cpu,
    _min_t_fake)


def analytic_min_t_general(params, origins4, dir4, n_spheres: int, n_cubes: int, tmax,
                           tested=None):
    """Min hit parameter over spheres and cubes for shadow rays with per-lane
    origins. params: (G, PARAM_COLS) from pack_analytic_params_general (the
    light left out by omitting its row); origins4, dir4: (4, N) camera frame;
    tmax: (N,) search bound, 0 on masked lanes. Returns (N,) f32: the nearest
    hit, INF where none (and on masked lanes). Callers test t < tmax. tested
    as for analytic_nearest_shared (masked lanes vote no)."""
    if not on_cpu("analytic_min_t_general", dir4):
        origins4, dir4, tmax = origins4.contiguous(), dir4.contiguous(), tmax.contiguous()
    t, count = _min_t_op(params, origins4, dir4, n_spheres, n_cubes, tmax, tested is not None)
    if tested is not None:
        tested += count
    return t
