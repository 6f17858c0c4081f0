"""Mesh walks over every mesh object at once: K9 (primary) and K10 (shadow).

Torch counterpart of `relativitypathtracer_tpu.ops.pallas.mesh_batch`. A
scene with several mesh objects concatenates their Morton-ordered chunk
constants into one pool (models.scene.MeshBatchStatic) with a chunk ->
object table, so each ray block walks one live list over all objects:
- each chunk is tested in its own object's rest frame: the kernels derive a
  lane's object-frame ray from the camera-frame 4-dir (and 4-origin) and the
  object's row of an (O, MAT_COLS) transform table;
- distances from different frames are made comparable by a per-lane scale
  s (object distance -> shared 4D ray parameter, t = dist * |M_R dh| /
  |d3|), so the nearest-hit reduce, the walk bound and early termination
  run in shared units;
- the live lists (`live_chunk_lists_multi`, K4's kernels over one cone
  table of every object, made in one launch with its per-object glue) cull
  each chunk against its own object's cones
  and scale its floors by the block's minimum per-lane s, a lower bound, so
  stopping on them stays sound.

`batched_shared_walk` and `batched_general_walk` (through their operators
torch.ops.rpt.batched_shared_walk and torch.ops.rpt.batched_general_walk)
launch the CUDA kernels
(csrc/mesh_batch.cu: a cluster of 8 CTAs per ray block, a warp per ray,
each CTA's per-object rays staged in shared memory) on CUDA tensors; on CPU
tensors they call their plain twins `batched_shared_walk_plain` /
`batched_general_walk_plain`, which derive every object's rays for every
lane with the kernels' operations in their order, then walk the same lists
with the same early termination. With `walked=True` the twins also return
the chunks each block walked, and `object_switches` counts how often a walk
changes object.
"""

from __future__ import annotations

import torch

from ._build import cached_constant, check_cuda, constant, define_op, launch, on_cpu
from .mesh_kernels import (
    INF, N_ATTR, NB, SUB, SUB_LANES, TC, _box_bound, _dot_rows, _list_ops, _mt,
    _pad_lanes, _round_up, general_tri_rows, shared_tri_rows)

# The per-object transform table: one row of MAT_COLS floats per mesh object.
MAT_COLS = 40
_A = 0  # 12: fused dir/origin transform inv_m[:3, :3] @ L[1:4, :], row-major
_B = 12  # 3: inv_m translation (the origin's affine part)
_RO = 15  # 3: the object-space camera origin (shared-origin walk; 0 for shadows)
_MR = 18  # 9: m[:3, :3] row-major (object -> rest scale, for s)
_L3 = 27  # 12: L[1:4, :] row-major (|d3|, for s)


def mat_row(L, inv_m, m, ro=None):
    """One object's MAT_COLS row from its frame matrix L, inverse model
    matrix inv_m and model matrix m (each (4, 4)); ro (3,) the object-space
    camera origin for the shared-origin walk."""
    A = inv_m[:3, :3] @ L[1:4, :]
    return torch.cat([A.reshape(12), inv_m[:3, 3], torch.zeros(3, device=L.device)
                      if ro is None else ro, m[:3, :3].reshape(9), L[1:4, :].reshape(12),
                      torch.zeros(MAT_COLS - 39, device=L.device)])


def _mat_rows(m, base: int, vec, ncols: int = 4):
    """[sum_j m[base + ncols * i + j] * vec[j] for i < 3], left to right."""
    out = []
    for i in range(3):
        acc = m[base + ncols * i] * vec[0]
        for j in range(1, ncols):
            acc = acc + m[base + ncols * i + j] * vec[j]
        out.append(acc)
    return out


def _len3(v):
    return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def object_dirs(mats, dir4):
    """Every object's unit object-space dirs and scales of the camera-frame
    4-dirs dir4 (4, ...): (dh (O, 3, ...), s (O, ...)), with the kernels'
    operations in their order (mesh_batch._fill_ray_scratch)."""
    dhs, ss = [], []
    for m in mats:
        d = _mat_rows(m, _A, dir4)
        dn = _len3(d)
        dh = [x / dn for x in d]
        d3n = _len3(_mat_rows(m, _L3, dir4))
        ss.append(_len3(_mat_rows(m, _MR, dh, 3)) / d3n)
        dhs.append(torch.stack(dh))
    return torch.stack(dhs), torch.stack(ss)


def object_rays(mats, origins4, dir4):
    """Every object's general rays [dh, ro x dh, ro, 1] and scales of the
    camera-frame 4-origins and 4-dirs (4, ...): (r10 (O, 10, ...), s (O, ...))."""
    dh, s = object_dirs(mats, dir4)
    rays = []
    for m, d in zip(mats, dh):
        ro = _mat_rows(m, _A, origins4)
        ro = [ro[k] + m[_B + k] for k in range(3)]
        mom = [ro[1] * d[2] - ro[2] * d[1], ro[2] * d[0] - ro[0] * d[2],
               ro[0] * d[1] - ro[1] * d[0]]
        rays.append(torch.cat([d, torch.stack(mom), torch.stack(ro), torch.ones_like(d[:1])]))
    return torch.stack(rays), s


def _lists_multi(plain, spheres, chunk_counts, d_os, o_os, s_os, valid, enabled,
                 lane_bound_shared):
    table_of, cull, sort = _list_ops(plain)
    # one cone table of every object, its glue in the same pass: the lane
    # bound in each object's units (t_shared = t_obj * s), a disabled
    # object's cones off, and the block's minimum scale (a lower bound)
    table, smin = table_of(d_os, o_os, valid, lane_bound_shared, SUB_LANES, s_os,
                           None if enabled is None else enabled_mask(enabled, d_os.device))
    return sort(*cull(spheres, table, SUB, lane_bound_shared is not None,
                      chunk_objects(chunk_counts, spheres.device), smin))


def live_chunk_lists_multi(spheres, chunk_counts, d_os, o_os, s_os, valid=None, enabled=None,
                           lane_bound_shared=None):
    """Live lists over the concatenated pool. spheres (C, 4) object-space
    chunk spheres, object-major; chunk_counts: chunks per object; d_os/o_os
    (O, 3, n_pad) per-object dirs and origins; s_os (O, n_pad) scales;
    valid (n_pad,) optional; enabled: per object, False keeps its chunks
    dead (the light's own mesh for its shadow rays); lane_bound_shared
    (n_pad,) optional bound in shared units, converted per object for the
    segment cull. Each chunk is culled against its own object's cones (one
    cone table for all objects, the chunk's row picked by its slot).
    Floors come out in shared units: each object's scaled by the block's
    minimum s over its valid lanes. Returns bucket_order's (order, minds,
    counts). K4's kernels on CUDA tensors, their twins on CPU tensors."""
    return _lists_multi(False, spheres, chunk_counts, d_os, o_os, s_os, valid, enabled,
                        lane_bound_shared)


def live_chunk_lists_multi_plain(spheres, chunk_counts, d_os, o_os, s_os, valid=None,
                                 enabled=None, lane_bound_shared=None):
    """live_chunk_lists_multi with the kernels' plain twins, on any device."""
    return _lists_multi(True, spheres, chunk_counts, d_os, o_os, s_os, valid, enabled,
                        lane_bound_shared)


@cached_constant
def _chunk_objects(chunk_counts: tuple, device: torch.device):
    return torch.cat([torch.full((c,), g, dtype=torch.int32, device=device)
                      for g, c in enumerate(chunk_counts)])


def chunk_objects(chunk_counts, device):
    """(C,) int32 object slot of every pool chunk. Made once per pool layout
    and device, then shared (`_build.cached_constant`; an exported program
    holds it as a constant): callers only read it."""
    return _chunk_objects(tuple(int(c) for c in chunk_counts), torch.device(device))


def enabled_mask(enabled, device):
    """(O,) int32: 1 for each enabled object, 0 for a disabled one. Made
    once per pattern and device, then shared (`_build.constant`): callers
    only read it."""
    return constant([int(bool(e)) for e in enabled], torch.int32, device)


# A disabled object's box in the shadow walk's bound, as in the JAX package.
# Its lo lies above its hi, but the slab test (csrc/common.cuh box_bound,
# mesh_kernels._box_bound) takes the min and max of each axis's two planes,
# so it reads the box as the unit cube [0, 1]^3: a lane whose ray crosses
# that cube may get a wider bound, and no result changes.
STAND_IN_BOX = (1.0, 1.0, 1.0, 0.0, 0.0, 0.0)


def pool_boxes(spheres, chunk_counts):
    """(O, 6) [lo hi]: each pool object's union box of its chunk spheres,
    over the whole pool at once (the per-object `_box_of`: a min and a max
    are exact in any order, so the boxes are the same to the bit)."""
    cobj = chunk_objects(chunk_counts, spheres.device).long()[:, None].expand(-1, 3)
    c, r = spheres[:, :3], spheres[:, 3:4]
    lo = spheres.new_full((len(chunk_counts), 3), INF).scatter_reduce(0, cobj, c - r, "amin")
    hi = spheres.new_full((len(chunk_counts), 3), -INF).scatter_reduce(0, cobj, c + r, "amax")
    return torch.cat([lo, hi], dim=1)


def batched_shared_walk_plain(order, minds, counts, cobj, boxes, mats, tri, attrs, dir4_p,
                              walked=False):
    """Plain twin of the K9 kernel. Returns (t in shared units, u, v, tri
    (pool row), obj (slot), attr (15, n)); tri and obj are -1 on a miss.
    With `walked`, also the chunks each block walked ((B,) int64)."""
    n_pad = dir4_p.shape[1]
    B = n_pad // NB
    dev = dir4_p.device
    dh_all, s_all = object_dirs(mats, dir4_p.reshape(4, B, NB))  # (O, 3, B, NB), (O, B, NB)
    bound = torch.zeros((B, NB), device=dev)
    for g in range(mats.shape[0]):
        bx = boxes[g]
        bound = torch.maximum(bound, _box_bound(bx[0:3], bx[3:6], bx[6:9], dh_all[g]) * s_all[g])
    mb = bound.amax(dim=1)
    best_t = torch.full((B, NB), INF, device=dev)
    best_u = torch.zeros((B, NB), device=dev)
    best_v = torch.zeros((B, NB), device=dev)
    best_tri = torch.full((B, NB), -1, dtype=torch.int32, device=dev)
    best_obj = torch.full((B, NB), -1, dtype=torch.int32, device=dev)
    rows = tri.reshape(-1, TC, 10)
    running = torch.ones(B, dtype=torch.bool, device=dev)
    blocks = torch.arange(B, device=dev)
    n_walked = torch.zeros(B, dtype=torch.int64, device=dev)
    for j in range(order.shape[1]):
        k_all = order[:, j].long()
        running &= (j < counts) & (minds[blocks, k_all] < mb)
        idx = running.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        n_walked[idx] += 1
        k = k_all[idx]
        g = cobj[k].long()
        c = rows[k]
        d = dh_all[g, :, idx].permute(1, 0, 2)  # (3, b, NB)
        dist, u, v = _mt(_dot_rows(c, 0, 3, d, 0), _dot_rows(c, 3, 6, d, 0),
                         _dot_rows(c, 6, 9, d, 0), c[:, :, 9:10])
        tsh = torch.where(dist < INF, dist * s_all[g, idx][:, None, :], INF)
        arg = tsh.argmin(dim=1, keepdim=True)  # first minimum, as jnp.argmin
        dmin = tsh.gather(1, arg)[:, 0]
        bt = best_t[idx]
        better = dmin < bt
        best_t[idx] = torch.where(better, dmin, bt)
        best_u[idx] = torch.where(better, u.gather(1, arg)[:, 0], best_u[idx])
        best_v[idx] = torch.where(better, v.gather(1, arg)[:, 0], best_v[idx])
        tri_id = (k[:, None] * TC + arg[:, 0]).to(torch.int32)
        best_tri[idx] = torch.where(better, tri_id, best_tri[idx])
        best_obj[idx] = torch.where(better, g[:, None].to(torch.int32), best_obj[idx])
        mb[idx] = torch.minimum(best_t[idx], bound[idx]).amax(dim=1)
    flat_tri = best_tri.reshape(-1)
    attr = torch.where((flat_tri >= 0)[:, None], attrs[flat_tri.clamp(min=0).long()], 0.0)
    out = (best_t.reshape(-1), best_u.reshape(-1), best_v.reshape(-1), flat_tri,
           best_obj.reshape(-1), attr.T.contiguous())
    return (*out, n_walked) if walked else out


def _shared_cuda(order, minds, counts, cobj, boxes, mats, tri, attrs, dir4_p):
    B, C = order.shape
    O = mats.shape[0]
    n_pad = B * NB
    f32, i32 = torch.float32, torch.int32
    check_cuda("batched_shared_walk", (order, i32, (B, C)), (minds, f32, (B, C)),
               (counts, i32, (B,)), (cobj, i32, (C,)), (boxes, f32, (O, 9)),
               (mats, f32, (O, MAT_COLS)), (tri, f32, (C * TC, 10)),
               (attrs, f32, (C * TC, N_ATTR)), (dir4_p, f32, (4, n_pad)))
    t, u, v, tri_out, obj_out, attr = _shared_fake(order, minds, counts, cobj, boxes, mats,
                                                   tri, attrs, dir4_p)
    launch("rpt_batched_shared_walk", order, minds, counts, cobj, boxes, mats, tri, attrs,
           dir4_p, n_pad, C, O, t, u, v, tri_out, obj_out, attr)
    return t, u, v, tri_out, obj_out, attr


def _shared_fake(order, minds, counts, cobj, boxes, mats, tri, attrs, dir4_p):
    n_pad = order.shape[0] * NB
    return (*(mats.new_empty(n_pad) for _ in range(3)),
            *(mats.new_empty(n_pad, dtype=torch.int32) for _ in range(2)),
            mats.new_empty((N_ATTR, n_pad)))


_shared_op = define_op(
    "batched_shared_walk", "(Tensor order, Tensor minds, Tensor counts, Tensor cobj, "
    "Tensor boxes, Tensor mats, Tensor tri, Tensor attrs, Tensor dir4_p) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)", _shared_cuda,
    batched_shared_walk_plain, _shared_fake)


def batched_shared_walk(order, minds, counts, cobj, boxes, mats, tri, attrs, dir4_p):
    """K9 walk: the CUDA kernel on CUDA tensors, the plain twin on CPU
    tensors. order/minds (B, C), counts (B,), cobj (C,) int32, boxes (O, 9)
    [lo hi ro] per object, mats (O, MAT_COLS), tri (C * TC, 10), attrs
    (C * TC, 15), dir4_p (4, B * NB) camera-frame 4-dirs."""
    on_cpu("batched_shared_walk", dir4_p)
    return _shared_op(order, minds, counts, cobj, boxes, mats, tri, attrs, dir4_p)


def batched_general_walk_plain(order, minds, counts, cobj, boxes, mats, rows, o4_p, dir4_p,
                               tmax_p, walked=False):
    """Plain twin of the K10 kernel: min(nearest hit, tmax) per lane in
    shared units, with occlusion retirement on any hit below tmax. Every
    lane is tested; a lane with tmax <= 0 changes neither its result (tmax)
    nor the walk, which the kernel relies on. With `walked`, also the chunks
    each block walked ((B,) int64)."""
    n_pad = dir4_p.shape[1]
    B = n_pad // NB
    dev = dir4_p.device
    r_all, s_all = object_rays(mats, o4_p.reshape(4, B, NB), dir4_p.reshape(4, B, NB))
    tmax = tmax_p.reshape(B, NB)
    bound = torch.zeros((B, NB), device=dev)
    for g in range(mats.shape[0]):
        bound = torch.maximum(bound, _box_bound(boxes[g, 0:3], boxes[g, 3:6], r_all[g, 6:9],
                                                r_all[g, 0:3]) * s_all[g])
    teff = torch.minimum(tmax, bound)
    mb = teff.amax(dim=1)
    best_t = torch.full((B, NB), INF, device=dev)
    crows = rows.reshape(-1, TC, 20)
    running = torch.ones(B, dtype=torch.bool, device=dev)
    blocks = torch.arange(B, device=dev)
    n_walked = torch.zeros(B, dtype=torch.int64, device=dev)
    for j in range(order.shape[1]):
        k_all = order[:, j].long()
        running &= (j < counts) & (minds[blocks, k_all] < mb)
        idx = running.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        n_walked[idx] += 1
        k = k_all[idx]
        g = cobj[k].long()
        c = crows[k]
        x = r_all[g, :, idx].permute(1, 0, 2)  # (10, b, NB)
        dist, _, _ = _mt(_dot_rows(c, 0, 3, x, 0), _dot_rows(c, 3, 9, x, 0),
                         _dot_rows(c, 9, 15, x, 0), _dot_rows(c, 15, 19, x, 6))
        tsh = torch.where(dist < INF, dist * s_all[g, idx][:, None, :], INF)
        new_t = torch.minimum(best_t[idx], tsh.amin(dim=1))
        best_t[idx] = new_t
        live = torch.where(new_t < tmax[idx], 0.0, torch.minimum(new_t, teff[idx]))
        mb[idx] = live.amax(dim=1)
    t = torch.minimum(best_t, tmax).reshape(-1)
    return (t, n_walked) if walked else t


def object_switches(order, cobj, n_walked):
    """(B,) int64: how often each block's walk changes object, from one
    walked chunk to the next, over the first n_walked[b] entries of its list
    order[b] (the walks' `walked` counts); cobj (C,) the chunk -> object
    table."""
    g = cobj[order.long()]  # (B, C) object of each list entry
    change = g[:, 1:] != g[:, :-1]
    pos = torch.arange(1, order.shape[1], device=order.device)
    return (change & (pos[None, :] < n_walked[:, None])).sum(dim=1)


def _general_cuda(order, minds, counts, cobj, boxes, mats, rows, o4_p, dir4_p, tmax_p):
    B, C = order.shape
    O = mats.shape[0]
    n_pad = B * NB
    f32, i32 = torch.float32, torch.int32
    check_cuda("batched_general_walk", (order, i32, (B, C)), (minds, f32, (B, C)),
               (counts, i32, (B,)), (cobj, i32, (C,)), (boxes, f32, (O, 6)),
               (mats, f32, (O, MAT_COLS)), (rows, f32, (C * TC, 20)),
               (o4_p, f32, (4, n_pad)), (dir4_p, f32, (4, n_pad)), (tmax_p, f32, (n_pad,)))
    t = _general_fake(order, minds, counts, cobj, boxes, mats, rows, o4_p, dir4_p, tmax_p)
    launch("rpt_batched_general_walk", order, minds, counts, cobj, boxes, mats, rows, o4_p,
           dir4_p, tmax_p, n_pad, C, O, t)
    return t


def _general_fake(order, minds, counts, cobj, boxes, mats, rows, o4_p, dir4_p, tmax_p):
    return mats.new_empty(order.shape[0] * NB)


_general_op = define_op(
    "batched_general_walk", "(Tensor order, Tensor minds, Tensor counts, Tensor cobj, "
    "Tensor boxes, Tensor mats, Tensor rows, Tensor o4_p, Tensor dir4_p, Tensor tmax_p) "
    "-> Tensor", _general_cuda, batched_general_walk_plain, _general_fake)


def batched_general_walk(order, minds, counts, cobj, boxes, mats, rows, o4_p, dir4_p, tmax_p):
    """K10 walk: the CUDA kernel on CUDA tensors, the plain twin on CPU
    tensors. boxes (O, 6) [lo hi] per object, rows (C * TC, 20), o4_p and
    dir4_p (4, B * NB) camera-frame 4-origins and 4-dirs, tmax_p (B * NB,)
    in shared units (0 masks a lane); the rest as `batched_shared_walk`."""
    on_cpu("batched_general_walk", dir4_p)
    return _general_op(order, minds, counts, cobj, boxes, mats, rows, o4_p, dir4_p, tmax_p)


def batched_nearest_shared(consts, attrs, spheres, boxes, mats, dir4, d_os, o_os, s_os,
                           chunk_counts):
    """Nearest hit over all mesh objects of rays sharing each object's
    origin. consts (4 * Tsum_pad, 3) factor-grouped pool; attrs (Tsum_pad,
    15); spheres (C, 4); boxes (O, 9); mats (O, MAT_COLS); dir4 (4, N)
    camera 4-dirs; d_os/o_os (O, 3, N) and s_os (O, N) per-object dirs,
    origins and scales for the list build. Returns (t in shared units, u,
    v, tri (pool row), obj (slot), attr (15, N)); tri/obj -1 on a miss."""
    Tsum_pad = attrs.shape[0]
    n = dir4.shape[1]
    n_pad = _round_up(n, NB)
    order, minds, counts = live_chunk_lists_multi(
        spheres, chunk_counts, _pad_lanes(d_os, n_pad, 1.0), _pad_lanes(o_os, n_pad),
        _pad_lanes(s_os, n_pad, 1.0))
    t, u, v, tri, obj, attr = batched_shared_walk(
        order, minds, counts, chunk_objects(chunk_counts, dir4.device), boxes.contiguous(),
        mats.contiguous(), shared_tri_rows(consts, consts[3 * Tsum_pad:, 0]),
        attrs.contiguous(), _pad_lanes(dir4, n_pad, 1.0).contiguous())
    return t[:n], u[:n], v[:n], tri[:n], obj[:n], attr[:, :n]


def batched_min_t_general(cols, spheres, mats, origins4, dir4, d_os, o_os, s_os, tmax,
                          chunk_counts, enabled=None, valid=None):
    """Min hit over all mesh objects of shadow rays, in shared units. cols
    (4 * Tsum_pad, 10) factor-grouped pool; origins4/dir4 (4, N) camera
    4-origins and 4-dirs; tmax (N,) shared-unit bound (0 masks a lane);
    enabled: per object, False leaves it out (a disabled object gets
    STAND_IN_BOX in the walk bound, as in the JAX package);
    valid (N,) the lanes that shape the culling cones. Returns (N,)
    min(t, tmax)."""
    n = dir4.shape[1]
    n_pad = _round_up(n, NB)
    tmax_p = _pad_lanes(tmax, n_pad)
    order, minds, counts = live_chunk_lists_multi(
        spheres, chunk_counts, _pad_lanes(d_os, n_pad, 1.0), _pad_lanes(o_os, n_pad),
        _pad_lanes(s_os, n_pad, 1.0), valid=None if valid is None else
        _pad_lanes(valid, n_pad, False), enabled=enabled, lane_bound_shared=tmax_p)
    boxes = pool_boxes(spheres, chunk_counts)
    if enabled is not None and not all(enabled):
        boxes = torch.where(enabled_mask(enabled, spheres.device)[:, None] > 0, boxes,
                            constant(STAND_IN_BOX, torch.float32, spheres.device))
    t = batched_general_walk(
        order, minds, counts, chunk_objects(chunk_counts, dir4.device), boxes,
        mats.contiguous(), general_tri_rows(cols), _pad_lanes(origins4, n_pad).contiguous(),
        _pad_lanes(dir4, n_pad, 1.0).contiguous(), tmax_p.contiguous())
    return t[:n]
