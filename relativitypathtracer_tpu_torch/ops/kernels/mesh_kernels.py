"""Mesh walks over per-block live-chunk lists: K5 (primary) and K6 (shadow).

Torch counterpart of `relativitypathtracer_tpu.ops.pallas.mesh_kernels` at
its default settings (NB=1024, SUB=8, TC=TC_GEN=32, shadow cull "boxfar", the
16-bucket counting sort). Triangles sit in 32-triangle Morton-ordered chunks.
Outside the kernels, torch ops cull every (ray block, chunk) pair with a
cone-vs-sphere test at 128-lane sub-cone granularity and sort each block's
live chunks front to back by bucket floor (`live_chunk_lists`, K4 in the
roadmap, still torch ops here). The kernels walk that list per 1024-ray
block and stop once the block's farthest useful bound is nearer than the next
chunk's floor.

`shared_walk` and `general_walk` launch the CUDA kernels
(csrc/mesh_kernels.cu) on CUDA tensors; on CPU tensors they call their
plain twins `shared_walk_plain` / `general_walk_plain`, which walk the same
lists with the same early termination, vectorized over the blocks that are
still walking (`walk_shared_lists`, `walk_general_lists`, which the large
tier's twins share).

The two-level lists of the large-mesh tier live here too, as in the JAX
package: `live_chunk_lists2` (superchunk order reduced from the chunk-level
cull), `live_chunk_lists3` (super-sphere cull, block-cone chunk bits),
`super_spheres_of` and `pack_bits`; `mesh_large` picks between them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_cuda, launch

EPSILON = 1e-7
INF = 1e20
NB = 1024  # rays per block: one 32x32 screen tile
SUB = 8  # culling sub-cones per block (128 lanes each)
TC = 32  # triangles per chunk, primary walk
TC_GEN = 32  # triangles per chunk, shadow walk
NBKT = 16  # counting-sort buckets
N_ATTR = 15  # [normal(3) + uv(2)] x [base, du, dv]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_lanes(x, n_pad: int, value=0):
    """Pad the last (ray) axis of x to n_pad lanes with `value`."""
    fill = torch.full((*x.shape[:-1], n_pad - x.shape[-1]), value, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, fill], dim=-1)


def _safe_inv(d):
    """NaN-safe reciprocal for slab tests: |d| < 1e-12 is clamped to 1e-12 so
    an axis-parallel ray on a box plane gives a huge finite t, not 0 * inf."""
    tiny = torch.where(d < 0, -1e-12, 1e-12)
    return 1.0 / torch.where(d.abs() < 1e-12, tiny, d)


def chunk_spheres(A, B, C, T_pad: int, tc: int = TC):
    """Bounding sphere (cx cy cz r) per tc-triangle chunk: (T_pad / tc, 4).
    Padding triangles repeat the last real triangle."""
    pad = T_pad - A.shape[0]

    def padv(x):
        return torch.cat([x, x[-1:].expand(pad, 3)], dim=0)

    pts = torch.stack([padv(A), padv(B), padv(C)]).reshape(3, T_pad // tc, tc, 3)
    lo = pts.amin(dim=0).amin(dim=1)
    hi = pts.amax(dim=0).amax(dim=1)
    c = (lo + hi) / 2.0
    h = (hi - lo) / 2.0
    r = torch.sqrt(h[:, 0] * h[:, 0] + h[:, 1] * h[:, 1] + h[:, 2] * h[:, 2])
    return torch.cat([c, r[:, None]], dim=1)


def _cones_of(d, o):
    """Bounding cone per ray group. d/o: (3, groups, lanes) dirs / origins.
    Returns (apex (3, G), axis (3, G), cos_a (G,), o_rad (G,))."""
    oc = o.mean(dim=2)
    o_rad = torch.sqrt(((o - oc[:, :, None]) ** 2).sum(dim=0).amax(dim=1))
    mean = d.mean(dim=2)
    axis = mean / torch.clamp(torch.sqrt((mean * mean).sum(dim=0)), min=1e-12)
    cos_a = (d * axis[:, :, None]).sum(dim=0).amin(dim=1)
    return oc, axis, cos_a, o_rad


def _mask_invalid_lanes(d, o, valid):
    """Replace masked lanes' rays by their group's mean so that garbage rays
    cannot widen the group's cone. d/o: (3, groups, lanes)."""
    v = valid.reshape(1, d.shape[1], d.shape[2])
    nv = torch.clamp(v.sum(dim=2, keepdim=True), min=1)
    o_mean = torch.where(v, o, 0.0).sum(dim=2, keepdim=True) / nv
    d_mean = torch.where(v, d, 0.0).sum(dim=2, keepdim=True) / nv
    return torch.where(v, d, d_mean), torch.where(v, o, o_mean)


def _cone_cull(spheres, d, o):
    """Cone-vs-sphere culling. spheres: (C, 4); d/o: (3, G, lanes).
    Returns (mind (G, C) conservative min distances, overlap (G, C) bool)."""
    apex, axis, cos_a, o_rad = _cones_of(d, o)
    c = spheres[:, :3]
    r = spheres[:, 3][None, :] + o_rad[:, None]
    dc = c[None, :, :] - apex.T[:, None, :]
    dlen = torch.sqrt((dc * dc).sum(dim=-1))
    mind = torch.clamp(dlen - r, min=0.0)
    cos_d = (dc * axis.T[:, None, :]).sum(dim=-1) / torch.clamp(dlen, min=1e-12)
    sin_b = torch.clamp(r / torch.clamp(dlen, min=1e-12), max=1.0)
    cos_b = torch.sqrt(torch.clamp(1.0 - sin_b * sin_b, min=0.0))
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    # a + b >= pi (cos_b <= -cos_a) would wrap cos(a + b): always overlap.
    overlap = (dlen <= r) | (cos_b <= -cos_a[:, None]) | (
        cos_d >= cos_a[:, None] * cos_b - sin_a[:, None] * sin_b)
    return mind, overlap


def bucket_order(mind, overlap):
    """Front-to-back compaction of live chunks per block by a 16-bucket
    counting sort. mind/overlap: (B, C). Returns (order (B, C) int32 chunk
    ids, live ones first; minds (B, C) f32 bucket floors keyed by chunk id;
    counts (B,) int32 live counts). Floors never exceed a chunk's true
    distance and never decrease along `order`, so stopping on them is sound."""
    n_chunks = mind.shape[1]
    lo_k = mind.amin(dim=1, keepdim=True)
    hi_k = torch.where(overlap, mind, -INF).amax(dim=1, keepdim=True)
    span = torch.clamp(hi_k - lo_k, min=1e-6)
    x = (mind - lo_k) / span * (NBKT - 1)
    # Saturating float -> int (NaN -> 0), as XLA converts.
    bucket = torch.clamp(torch.where(x > 0, x, 0.0), max=NBKT - 1).to(torch.int32)
    key = lo_k + bucket.to(torch.float32) * (span / (NBKT - 1))
    bucket = torch.where(overlap, bucket, NBKT).long()  # dead chunks go last
    onehot = F.one_hot(bucket, NBKT + 1)  # (B, C, NBKT + 1)
    per_bucket = onehot.sum(dim=1)
    offsets = torch.cumsum(per_bucket, dim=1) - per_bucket
    rank = torch.cumsum(onehot, dim=1).gather(2, bucket[:, :, None])[:, :, 0] - 1
    pos = offsets.gather(1, bucket) + rank  # (B, C): a permutation per row
    ids = torch.arange(n_chunks, dtype=torch.int32, device=mind.device)
    order = torch.empty_like(pos, dtype=torch.int32).scatter_(
        1, pos, ids.expand_as(pos).contiguous())
    counts = overlap.sum(dim=1).to(torch.int32)
    return order, key, counts


def _sub_cone_cull(spheres, dh_p, o_p, valid=None, lane_bound=None):
    """Cull at 128-lane sub-cones, then reduce to 1024-lane blocks: overlap =
    any sub overlaps, mind = min over overlapping subs. valid drops masked
    lanes from the cones and all-masked subs entirely; lane_bound culls rays
    as segments. Returns (mind, overlap) shaped (B, C)."""
    nb = NB // SUB
    n_sub = dh_p.shape[1] // nb
    d = dh_p.reshape(3, n_sub, nb)
    o = o_p.reshape(3, n_sub, nb)
    if valid is not None:
        d, o = _mask_invalid_lanes(d, o, valid)
    mind_s, over_s = _cone_cull(spheres, d, o)
    if valid is not None:
        over_s = over_s & valid.reshape(n_sub, nb).any(dim=1)[:, None]
    if lane_bound is not None:
        sub_bound = lane_bound.reshape(n_sub, nb).amax(dim=1)
        over_s = over_s & (mind_s <= sub_bound[:, None] + 1e-3)
    C = mind_s.shape[1]
    over_s = over_s.reshape(n_sub // SUB, SUB, C)
    mind_s = torch.where(over_s, mind_s.reshape(n_sub // SUB, SUB, C), INF)
    return mind_s.amin(dim=1), over_s.any(dim=1)


def live_chunk_lists(spheres, dh_p, o_p, valid=None, lane_bound=None):
    """Per-block live-chunk lists for rays dh_p/o_p (3, n_pad): the cull of
    `_sub_cone_cull` followed by `bucket_order`."""
    mind, overlap = _sub_cone_cull(spheres, dh_p, o_p, valid, lane_bound)
    return bucket_order(mind, overlap)


def pack_bits(overlap):
    """(B, C) bool -> (B, ceil(C / 32)) int32: bit k of word w is chunk
    w * 32 + k; bit 31 is the sign bit, as the JAX package packs it."""
    B, C = overlap.shape
    words = -(-C // 32)
    ov = torch.cat([overlap, overlap.new_zeros((B, words * 32 - C))], dim=1)
    weights = torch.ones(32, dtype=torch.int64, device=overlap.device) << torch.arange(
        32, device=overlap.device)
    packed = (ov.reshape(B, words, 32).long() * weights).sum(dim=2)
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed).to(torch.int32)


def _pad_cols(x, width: int, value):
    return torch.cat([x, torch.full((x.shape[0], width - x.shape[1]), value, dtype=x.dtype,
                                    device=x.device)], dim=1)


def live_chunk_lists2(spheres, dh_p, o_p, valid=None, lane_bound=None, s=8):
    """Two-level lists: front-to-back order of superchunks of `s`
    consecutive chunks, their floors reduced from the chunk-level cull (min
    over the group's live chunks, any for overlap), and the chunk-level
    overlap packed as bits. Returns (order (B, C_s), minds (B, C_s), counts
    (B,), bits (B, ceil(C / 32)))."""
    mind_c, over_c = _sub_cone_cull(spheres, dh_p, o_p, valid, lane_bound)
    B, C = mind_c.shape
    C_s = -(-C // s)
    mind_g = _pad_cols(mind_c, C_s * s, INF)  # already INF where over_c is False
    over_g = _pad_cols(over_c, C_s * s, False)
    order, minds, counts = bucket_order(mind_g.reshape(B, C_s, s).amin(dim=2),
                                        over_g.reshape(B, C_s, s).any(dim=2))
    return order, minds, counts, pack_bits(over_c)


def super_spheres_of(spheres, s):
    """(C, 4) chunk spheres -> (ceil(C / s), 4) spheres each containing its
    group of s consecutive chunks' spheres: centre of the group's extent box,
    radius the farthest child surface; the pad entries of a ragged last group
    are masked out."""
    C = spheres.shape[0]
    C_s = -(-C // s)
    pad = C_s * s - C
    c = torch.cat([spheres[:, :3], spheres.new_zeros((pad, 3))]).reshape(C_s, s, 3)
    r = torch.cat([spheres[:, 3], spheres.new_zeros(pad)]).reshape(C_s, s)
    real = (torch.arange(C_s * s, device=spheres.device) < C).reshape(C_s, s)
    lo = torch.where(real[..., None], c - r[..., None], INF).amin(dim=1)
    hi = torch.where(real[..., None], c + r[..., None], -INF).amax(dim=1)
    center = 0.5 * (lo + hi)
    dist = torch.sqrt(((c - center[:, None, :]) ** 2).sum(dim=-1))
    rad = torch.where(real, dist + r, 0.0).amax(dim=1)
    return torch.cat([center, rad[:, None]], dim=1)


def live_chunk_lists3(spheres, dh_p, o_p, valid=None, lane_bound=None, s=128):
    """live_chunk_lists2 for very large chunk counts: order, floors and
    segment culling against the super spheres (sub-cone work (n_sub, C / s)
    instead of (n_sub, C)), and the chunk bits from one block-cone pass.
    The bit columns are padded to C_s * s, since the walk's cursor reaches
    the pad positions of a ragged last super. Same outputs as lists2."""
    mind_s, over_s = _sub_cone_cull(super_spheres_of(spheres, s), dh_p, o_p, valid, lane_bound)
    order, minds, counts = bucket_order(mind_s, over_s)
    B = dh_p.shape[1] // NB
    d = dh_p.reshape(3, B, NB)
    o = o_p.reshape(3, B, NB)
    if valid is not None:
        d, o = _mask_invalid_lanes(d, o, valid)
    _, over_c = _cone_cull(spheres, d, o)
    if valid is not None:
        # an all-masked block's degenerate cone reads as overlapping all
        over_c = over_c & valid.reshape(B, NB).any(dim=1)[:, None]
    C_s = -(-spheres.shape[0] // s)
    return order, minds, counts, pack_bits(_pad_cols(over_c, C_s * s, False))


def _box_of(spheres):
    lo = (spheres[:, :3] - spheres[:, 3:4]).amin(dim=0)
    hi = (spheres[:, :3] + spheres[:, 3:4]).amax(dim=0)
    return lo, hi


def _box_bound(lo, hi, o, d):
    """Per-lane union-box exit with the kernels' margin, 0 on a miss.
    o: (3,) or (3, ...) origins; d: (3, ...) dirs."""
    far = torch.full_like(d[0], INF)
    near = torch.full_like(d[0], -INF)
    for ax in range(3):
        inv = _safe_inv(d[ax])
        t0 = (lo[ax] - o[ax]) * inv
        t1 = (hi[ax] - o[ax]) * inv
        near = torch.maximum(near, torch.minimum(t0, t1))
        far = torch.minimum(far, torch.maximum(t0, t1))
    hits_box = (near <= far) & (far > 0)
    return torch.where(hits_box, far * 1.001 + 1e-3, 0.0)


def _general_lane_bound(tmax_lanes, r10_p, lo, hi):
    """Culling bound per lane ("boxfar"): min(tmax, union-box exit), the same
    cap the walk applies, so culling never drops a chunk the walk could use."""
    return torch.minimum(tmax_lanes, _box_bound(lo, hi, r10_p[6:9], r10_p[0:3]))


def shared_tri_rows(consts, c_t):
    """(T_pad, 10) triangle rows [det(3) u(3) v(3) ct] of the shared-origin
    constants (4 * T_pad, 3) from mesh_intersect.shared_origin_constants."""
    T_pad = c_t.shape[0]
    return torch.cat([consts[:T_pad], consts[T_pad:2 * T_pad],
                      consts[2 * T_pad:3 * T_pad], c_t[:, None]], dim=1).contiguous()


def general_tri_rows(cols):
    """(T_pad, 20) triangle rows [det(3) u(6) v(6) t(4) 0] of the
    factor-grouped Plucker operators (4 * T_pad, 10): the entries each factor
    reads (det reads dh, u and v read dh and the moment, t reads o and 1)."""
    T_pad = cols.shape[0] // 4
    return torch.cat([cols[:T_pad, 0:3], cols[T_pad:2 * T_pad, 0:6],
                      cols[2 * T_pad:3 * T_pad, 0:6], cols[3 * T_pad:, 6:10],
                      torch.zeros_like(cols[:T_pad, :1])], dim=1).contiguous()


def _mt(det, un, vn, tn, tri_ok=None):
    """Moller-Trumbore acceptance in the TPU's form (one reciprocal, then
    products); returns (dist with INF where rejected, u, v). tri_ok, where
    given, rejects the triangles it is False for."""
    inv_det = 1.0 / det
    u = un * inv_det
    v = vn * inv_det
    dist = tn * inv_det
    ok = ((det.abs() >= EPSILON) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (dist >= 0.0))
    if tri_ok is not None:
        ok = ok & tri_ok
    return torch.where(ok, dist, INF), u, v


def _below_t(k, T):
    """(b, TC, 1) mask of the triangles of chunks k (b,) below the real
    triangle count T, or None when T masks nothing."""
    if T is None:
        return None
    i = torch.arange(TC, device=k.device)
    return ((k[:, None] * TC + i[None, :]) < T)[:, :, None]


def _dot_rows(rows, lo: int, hi: int, x, xlo: int):
    """sum_c rows[:, :, c] * x[xlo + c - lo], left to right: rows (b, TC, k),
    x (k', b, NB) -> (b, TC, NB)."""
    acc = rows[:, :, lo:lo + 1] * x[xlo][:, None, :]
    for c in range(lo + 1, hi):
        acc = acc + rows[:, :, c:c + 1] * x[xlo + c - lo][:, None, :]
    return acc


def walk_shared_lists(chunks, floors, n_live, box, tri, attrs, dh_p, T=None, walked=False):
    """The shared-origin walk of K5 and K11, vectorized over the blocks
    still walking: block b tests chunks[b, j] for j < n_live[b] in order and
    stops at the first whose floors[b, j] is not below its bound. T masks
    the triangles at or past it. Returns (t, u, v, tri (int32, -1 on a
    miss), attr (15, n)), and with `walked` also the chunks each block
    walked ((B,) int64)."""
    n_pad = dh_p.shape[1]
    B = n_pad // NB
    dev = dh_p.device
    dh = dh_p.reshape(3, B, NB)
    bound = _box_bound(box[0:3], box[3:6], box[6:9], dh)  # (B, NB)
    mb = bound.amax(dim=1)
    best_t = torch.full((B, NB), INF, device=dev)
    best_u = torch.zeros((B, NB), device=dev)
    best_v = torch.zeros((B, NB), device=dev)
    best_tri = torch.full((B, NB), -1, dtype=torch.int32, device=dev)
    rows = tri.reshape(-1, TC, 10)
    running = torch.ones(B, dtype=torch.bool, device=dev)
    n_walked = torch.zeros(B, dtype=torch.int64, device=dev)
    for j in range(chunks.shape[1]):
        running &= (j < n_live) & (floors[:, j] < mb)
        idx = running.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        n_walked[idx] += 1
        k = chunks[idx, j].long()
        c = rows[k]
        d = dh[:, idx]
        dist, u, v = _mt(_dot_rows(c, 0, 3, d, 0), _dot_rows(c, 3, 6, d, 0),
                         _dot_rows(c, 6, 9, d, 0), c[:, :, 9:10], _below_t(k, T))
        arg = dist.argmin(dim=1, keepdim=True)  # first minimum, as jnp.argmin
        dmin = dist.gather(1, arg)[:, 0]
        bt = best_t[idx]
        better = dmin < bt
        best_t[idx] = torch.where(better, dmin, bt)
        best_u[idx] = torch.where(better, u.gather(1, arg)[:, 0], best_u[idx])
        best_v[idx] = torch.where(better, v.gather(1, arg)[:, 0], best_v[idx])
        tri_id = (k[:, None] * TC + arg[:, 0]).to(torch.int32)
        best_tri[idx] = torch.where(better, tri_id, best_tri[idx])
        mb[idx] = torch.minimum(best_t[idx], bound[idx]).amax(dim=1)
    flat_tri = best_tri.reshape(-1)
    attr = torch.where((flat_tri >= 0)[:, None], attrs[flat_tri.clamp(min=0).long()], 0.0)
    out = (best_t.reshape(-1), best_u.reshape(-1), best_v.reshape(-1), flat_tri,
           attr.T.contiguous())
    return (*out, n_walked) if walked else out


def shared_walk_plain(order, minds, counts, box, tri, attrs, dh_p):
    """Plain twin of the K5 kernel: the walk of `walk_shared_lists` over
    each block's live list, each chunk's floor read by its id."""
    return walk_shared_lists(order, minds.gather(1, order.long()), counts, box, tri, attrs,
                             dh_p)


def shared_walk(order, minds, counts, box, tri, attrs, dh_p):
    """K5 walk over live lists: the CUDA kernel on CUDA tensors, the plain
    twin on CPU tensors. order/minds (B, C), counts (B,), box (9,)
    [lo hi ro], tri (T_pad, 10), attrs (T_pad, 15), dh_p (3, B * NB)."""
    if dh_p.device.type == "cpu":
        return shared_walk_plain(order, minds, counts, box, tri, attrs, dh_p)
    B, C = order.shape
    n_pad = B * NB
    f32, i32 = torch.float32, torch.int32
    check_cuda("shared_walk", (order, i32, (B, C)), (minds, f32, (B, C)), (counts, i32, (B,)),
               (box, f32, (9,)), (tri, f32, (C * TC, 10)), (attrs, f32, (C * TC, N_ATTR)),
               (dh_p, f32, (3, n_pad)))
    t = torch.empty(n_pad, dtype=torch.float32, device=dh_p.device)
    u, v = torch.empty_like(t), torch.empty_like(t)
    tri_out = torch.empty(n_pad, dtype=torch.int32, device=dh_p.device)
    attr = torch.empty((N_ATTR, n_pad), dtype=torch.float32, device=dh_p.device)
    launch("rpt_shared_walk", order, minds, counts, box, tri, attrs, dh_p, n_pad, C,
           t, u, v, tri_out, attr)
    return t, u, v, tri_out, attr


def walk_general_lists(chunks, floors, n_live, box, rows, r10_p, tmax2, T=None, walked=False):
    """The bounded shadow walk of K6 and K12 with occlusion retirement, over
    lists given as in `walk_shared_lists`, vectorized over the blocks still
    walking. Every lane is tested; a lane with tmax <= 0 changes neither its
    result (tmax) nor the walk, which the kernel relies on. Returns min(nearest
    hit, tmax) per lane, and with `walked` also the chunks each block walked
    ((B,) int64)."""
    n_pad = r10_p.shape[1]
    B = n_pad // NB
    dev = r10_p.device
    r10 = r10_p.reshape(10, B, NB)
    tmax = tmax2[0].reshape(B, NB)
    tcut = tmax2[1].reshape(B, NB)
    teff = torch.minimum(tmax, _box_bound(box[0:3], box[3:6], r10[6:9], r10[0:3]))
    mb = teff.amax(dim=1)
    best_t = torch.full((B, NB), INF, device=dev)
    crows = rows.reshape(-1, TC_GEN, 20)
    running = torch.ones(B, dtype=torch.bool, device=dev)
    n_walked = torch.zeros(B, dtype=torch.int64, device=dev)
    for j in range(chunks.shape[1]):
        running &= (j < n_live) & (floors[:, j] < mb)
        idx = running.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        n_walked[idx] += 1
        k = chunks[idx, j].long()
        c = crows[k]
        x = r10[:, idx]
        dist, _, _ = _mt(_dot_rows(c, 0, 3, x, 0), _dot_rows(c, 3, 9, x, 0),
                         _dot_rows(c, 9, 15, x, 0), _dot_rows(c, 15, 19, x, 6), _below_t(k, T))
        new_t = torch.minimum(best_t[idx], dist.amin(dim=1))
        best_t[idx] = new_t
        live = torch.where(new_t < tcut[idx], 0.0, torch.minimum(new_t, teff[idx]))
        mb[idx] = live.amax(dim=1)
    t = torch.minimum(best_t, tmax).reshape(-1)
    return (t, n_walked) if walked else t


def general_walk_plain(order, minds, counts, box, rows, r10_p, tmax2):
    """Plain twin of the K6 kernel: the walk of `walk_general_lists` over
    each block's live list, each chunk's floor read by its id."""
    return walk_general_lists(order, minds.gather(1, order.long()), counts, box, rows, r10_p,
                              tmax2)


def general_walk(order, minds, counts, box, rows, r10_p, tmax2):
    """K6 walk: the CUDA kernel on CUDA tensors, the plain twin on CPU
    tensors. box (6,) [lo hi], rows (T_pad, 20), r10_p (10, B * NB),
    tmax2 (2, B * NB) [tmax; tcut]."""
    if r10_p.device.type == "cpu":
        return general_walk_plain(order, minds, counts, box, rows, r10_p, tmax2)
    B, C = order.shape
    n_pad = B * NB
    f32, i32 = torch.float32, torch.int32
    check_cuda("general_walk", (order, i32, (B, C)), (minds, f32, (B, C)), (counts, i32, (B,)),
               (box, f32, (6,)), (rows, f32, (C * TC_GEN, 20)), (r10_p, f32, (10, n_pad)),
               (tmax2, f32, (2, n_pad)))
    t = torch.empty(n_pad, dtype=torch.float32, device=r10_p.device)
    launch("rpt_general_walk", order, minds, counts, box, rows, r10_p, tmax2, n_pad, C, t)
    return t


def shared_nearest_hit(consts, c_t, attrs, spheres, dh, ro):
    """Nearest triangle hit of rays sharing origin ro (3,), dirs dh (3, N)
    (unit, object space). consts: (4 * T_pad, 3); c_t: (T_pad,); attrs:
    (T_pad, 15); spheres: (T_pad / TC, 4). Returns (t, u, v, tri, attr
    (15, N)); tri is -1 where nothing was hit."""
    n = dh.shape[1]
    n_pad = _round_up(n, NB)
    dh_p = _pad_lanes(dh, n_pad, 1.0)
    order, minds, counts = live_chunk_lists(spheres, dh_p, ro[:, None].expand(3, n_pad))
    lo, hi = _box_of(spheres)
    box = torch.cat([lo, hi, ro])
    t, u, v, tri, attr = shared_walk(order, minds, counts, box, shared_tri_rows(consts, c_t),
                                     attrs.contiguous(), dh_p)
    return t[:n], u[:n], v[:n], tri[:n], attr[:, :n]


def general_min_t(cols_grouped, spheres, r10, tmax_obj, valid, tcut_obj):
    """Min object-space hit distance of rays r10 (10, N) = [dh, o x dh, o, 1],
    bounded by tmax_obj (N,): the result is min(nearest hit, tmax_obj).
    valid (N,) selects the lanes that shape the culling cones; a lane with a
    hit below tcut_obj (N,) stops extending the walk (its result is then any
    hit below tcut, which callers comparing against tmax_obj accept)."""
    n = r10.shape[1]
    n_pad = _round_up(n, NB)
    r10_p = _pad_lanes(r10, n_pad, 1.0)
    tmax2 = _pad_lanes(torch.stack([tmax_obj, tcut_obj]), n_pad)
    valid_p = _pad_lanes(valid, n_pad, False)
    lo, hi = _box_of(spheres)
    lane_bound = _general_lane_bound(tmax2[0], r10_p, lo, hi)
    order, minds, counts = live_chunk_lists(spheres, r10_p[0:3], r10_p[6:9],
                                            valid=valid_p, lane_bound=lane_bound)
    t = general_walk(order, minds, counts, torch.cat([lo, hi]),
                     general_tri_rows(cols_grouped), r10_p, tmax2)
    return t[:n]
