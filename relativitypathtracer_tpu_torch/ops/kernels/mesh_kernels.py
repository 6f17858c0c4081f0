"""The live-chunk list build (K4) and the mesh walks over its lists: K5 (primary) and K6 (shadow).

Torch counterpart of `relativitypathtracer_tpu.ops.pallas.mesh_kernels` at
its default settings (NB=1024, SUB=8, TC=TC_GEN=32, shadow cull "boxfar", the
16-bucket counting sort). Triangles sit in 32-triangle Morton-ordered chunks.
Before the walks, K4 culls every (ray block, chunk) pair with a
cone-vs-sphere test at 128-lane sub-cone granularity and sorts each block's
live chunks front to back by bucket floor (`live_chunk_lists`): three CUDA
kernels (csrc/live_lists.cu) make the cones' table (`cone_table`), cull
(`live_cull`) and sort (`bucket_order`) on CUDA tensors, their plain twins
(`cone_table_plain`, `live_cull_plain`, `bucket_order_plain`) on CPU
tensors; each list function has a `_plain` form that uses the twins on any
device. The walks take that list per 1024-ray block and stop once the
block's farthest useful bound is nearer than the next chunk's floor.

`shared_walk` and `general_walk` launch the CUDA kernels
(csrc/mesh_kernels.cu) on CUDA tensors; on CPU tensors they call their
plain twins `shared_walk_plain` / `general_walk_plain`, which walk the same
lists with the same early termination, vectorized over the blocks that are
still walking (`walk_shared_lists`, `walk_general_lists`, which the large
tier's twins share).

The two-level lists of the large-mesh tier live here too, as in the JAX
package: `live_chunk_lists2` (superchunk order reduced from the chunk-level
cull, the cull kernel's superchunk variant), `live_chunk_lists3`
(super-sphere cull, block-cone chunk bits), `super_spheres_of` and
`pack_bits`; `mesh_large` picks between them.

Each kernel's wrapper calls its operator torch.ops.rpt.<kernel> (_build),
whose CUDA implementation launches the kernel and whose CPU implementation
is the twin.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_cuda, counter, define_op, launch, on_cpu

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
    """Pad the last (ray) axis of x to n_pad lanes with `value`; x itself
    where it has n_pad lanes already."""
    if x.shape[-1] == n_pad:
        return x
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


# --- K4: the live-chunk list build --------------------------------------------
#
# rpt_cone_table makes the culling cones' rows (its twin cone_table_plain);
# rpt_live_cull culls every (ray block, chunk) pair against them and
# rpt_bucket_order sorts each block's live entries (csrc/live_lists.cu; twins
# live_cull_plain and bucket_order_plain). The list functions below compose
# the three for each kind of list, with the kernels (live_chunk_lists, ...)
# or with the twins (live_chunk_lists_plain, ...).

CONE_COLS = 12  # a cone's row: apex(3) axis(3) cos_a sin_a o_rad bound has_valid enabled
SUB_LANES = NB // SUB  # lanes of a culling sub-cone


def _tree_sum(x):
    """Sum over the last axis, of a power-of-two length, as a pairwise tree:
    lanes 2i and 2i + 1 first, then neighbouring pairs of those, and so on,
    each add the lower node plus the upper. rpt_cone_table adds in the same
    tree (a thread's four lanes, then shuffles, then its warps in order), so
    the sums agree to the bit on any device."""
    while x.shape[-1] > 1:
        x = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
        x = x[..., 0] + x[..., 1]
    return x[..., 0]


def _divide(x, k: int):
    """x / k as a true division on every device (CUDA turns a division by a
    Python number into a product with its reciprocal)."""
    return x / torch.full_like(x, k)


def cone_table_plain(d, o, valid=None, lane_bound=None, lanes=SUB_LANES, s=None, enabled=None):
    """Plain twin of the rpt_cone_table kernel: the culling cones of rays
    d/o (..., 3, n_pad), `...` empty or (O,), one per `lanes` consecutive
    lanes (128-lane sub-cones; 1024-lane block cones for live_chunk_lists3's
    bits): (..., n_pad // lanes, CONE_COLS) rows [apex(3) axis(3) cos_a sin_a
    o_rad bound has_valid enabled], which the cull and its twin read.

    valid (n_pad,) replaces masked lanes' rays by the mean of their group's
    valid ones, so that they cannot widen the cone (has_valid 0 for a group
    with none); lane_bound (n_pad,) or (..., n_pad) gives each group's bound,
    its lanes' max (0 without one). The pool (s given, (O, n_pad) scales):
    the lane bound is in shared units and is divided by clamp(s, 1e-12)
    first, enabled (O,) int zeroes a disabled object's enabled column (1
    elsewhere), and the result is (rows, smin), smin (O, n_pad // NB) the
    minimum of s over each block's valid lanes (INF where it has none).

    The order is the kernel's: the means (and the masked lanes' sums) are
    pairwise trees (`_tree_sum`) divided by a tensor, sums over x, y, z run
    left to right, and amin / amax are order-free; a NaN in a max or min
    wins, as torch's amin / amax give it (which NaN, where several differ in
    their bits, and the sign of a zero max or min among +0 and -0, follow
    the reduction order; the kernel's may differ there)."""
    G = d.shape[-1] // lanes
    d = d.reshape(*d.shape[:-1], G, lanes)
    o = o.reshape(*o.shape[:-1], G, lanes)
    if valid is not None:
        v = valid.reshape(G, lanes)
        nv = torch.clamp(v.sum(dim=-1), min=1).to(torch.float32)
        o = torch.where(v, o, (_tree_sum(torch.where(v, o, 0.0)) / nv)[..., None])
        d = torch.where(v, d, (_tree_sum(torch.where(v, d, 0.0)) / nv)[..., None])
    oc = _divide(_tree_sum(o), lanes)  # (..., 3, G)
    e0, e1, e2 = (o - oc[..., None]).unbind(-3)
    o_rad = torch.sqrt((e0 * e0 + e1 * e1 + e2 * e2).amax(dim=-1))
    mean = _divide(_tree_sum(d), lanes)
    m0, m1, m2 = mean.unbind(-2)
    axis = mean / torch.clamp(torch.sqrt(m0 * m0 + m1 * m1 + m2 * m2), min=1e-12)[..., None, :]
    a0, a1, a2 = (x[..., None] for x in axis.unbind(-2))
    d0, d1, d2 = d.unbind(-3)
    cos_a = (d0 * a0 + d1 * a1 + d2 * a2).amin(dim=-1)
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    zero = torch.zeros_like(cos_a)
    bound = zero
    if lane_bound is not None:
        lb = lane_bound if s is None else lane_bound / torch.clamp(s, min=1e-12)
        bound = torch.broadcast_to(lb.reshape(*lb.shape[:-1], G, lanes).amax(dim=-1),
                                   cos_a.shape)
    has_valid = zero + (1.0 if valid is None else valid.reshape(G, lanes).any(dim=1))
    on = zero + (1.0 if enabled is None else (enabled != 0)[:, None])
    rows = torch.stack([*oc.unbind(-2), *axis.unbind(-2), cos_a, sin_a, o_rad, bound,
                        has_valid, on], dim=-1).contiguous()
    if s is None:
        return rows
    sv = s if valid is None else torch.where(valid, s, INF)
    return rows, sv.reshape(s.shape[0], -1, NB).amin(dim=-1)


def _strides(x, dims: int):
    """x's element strides, stride 0 in front for the axes it lacks of `dims`."""
    return [0] * (dims - x.dim()) + list(x.stride())


def _cone_table_cuda(d, o, valid, lane_bound, lanes: int, s, enabled):
    n_pad = d.shape[-1]
    O = d.shape[0] if d.dim() == 3 else 1
    f32 = torch.float32
    specs = [(d, f32, d.shape), (o, f32, d.shape)]
    if lane_bound is not None:
        if lane_bound.shape not in ((n_pad,), d.shape[:-2] + (n_pad,)):
            raise ValueError(f"cone_table: lane_bound of shape {tuple(lane_bound.shape)}")
        specs.append((lane_bound, f32, lane_bound.shape))
    if s is not None:
        specs.append((s, f32, (O, n_pad)))
    if valid is not None:
        specs.append((valid, torch.bool, (n_pad,)))
    if enabled is not None:
        specs.append((enabled, torch.int32, (O,)))
    check_cuda("cone_table", *specs, contiguous=False)
    if any(x is not None and not x.is_contiguous() for x in (valid, enabled)):
        raise ValueError("cone_table: valid and enabled must be contiguous")
    if any(st >= 2 ** 31 for x, *_ in specs for st in x.stride()):
        raise ValueError("cone_table: strides beyond 2^31 elements")
    sd, so = _strides(d, 3), _strides(o, 3)
    slb = _strides(lane_bound, 2) if lane_bound is not None else [0, 0]
    ss = _strides(s, 2) if s is not None else [0, 0]
    rows, smin = _cone_table_fake(d, o, valid, lane_bound, lanes, s, enabled)
    launch("rpt_cone_table", d, *sd, o, *so, valid, lane_bound, *slb, s, *ss, enabled, O,
           n_pad, lanes, rows, smin if s is not None else None)
    return rows, smin


def _cone_table_cpu(d, o, valid, lane_bound, lanes: int, s, enabled):
    out = cone_table_plain(d, o, valid, lane_bound, lanes, s, enabled)
    return out if s is not None else (out, d.new_empty(0))


def _cone_table_fake(d, o, valid, lane_bound, lanes: int, s, enabled):
    n_pad = d.shape[-1]
    rows = d.new_empty((*d.shape[:-2], n_pad // lanes, CONE_COLS), dtype=torch.float32)
    smin = d.new_empty((d.shape[0], n_pad // NB) if s is not None else 0, dtype=torch.float32)
    return rows, smin


_cone_table_op = define_op(
    "cone_table", "(Tensor d, Tensor o, Tensor? valid, Tensor? lane_bound, int lanes, "
    "Tensor? s, Tensor? enabled) -> (Tensor, Tensor)", _cone_table_cuda, _cone_table_cpu,
    _cone_table_fake)


def cone_table(d, o, valid=None, lane_bound=None, lanes=SUB_LANES, s=None, enabled=None):
    """K4's cone table: the rpt_cone_table kernel on CUDA tensors, the plain
    twin on CPU tensors; arguments and results as `cone_table_plain`. The
    kernel reads d, o, lane_bound and s where they lie (any strides: a
    stride-0 origin, rows of a larger array); valid and enabled are
    contiguous; n_pad is a multiple of NB and lanes is 128 or 1024."""
    if d.device.type != "cpu":
        if lanes not in (SUB_LANES, NB):
            raise ValueError(f"cone_table: lanes must be {SUB_LANES} or {NB}, got {lanes}")
        n_pad = d.shape[-1]
        if n_pad % NB or d.dim() not in (2, 3) or d.shape[-2] != 3:
            raise ValueError(f"cone_table: d must be (3, n_pad) or (O, 3, n_pad) with n_pad a "
                             f"multiple of {NB}, got {tuple(d.shape)}")
        if s is not None and d.dim() != 3:
            raise ValueError("cone_table: the pool's scales need (O, 3, n_pad) rays")
        on_cpu("cone_table", d)
    rows, smin = _cone_table_op(d, o, valid, lane_bound, lanes, s, enabled)
    return rows if s is None else (rows, smin)


def _pad_cols(x, width: int, value):
    return torch.cat([x, torch.full((x.shape[0], width - x.shape[1]), value, dtype=x.dtype,
                                    device=x.device)], dim=1)


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


def live_cull_plain(spheres, table, sub=SUB, use_bound=False, cobj=None, smin=None, s=0,
                    n_words=0, floors=True):
    """Plain twin of the rpt_live_cull kernel. Each of B blocks' `sub` cones
    (table (B * sub, CONE_COLS), or (O, B * sub, CONE_COLS) per object for a
    pool) against each chunk sphere (spheres (C, 4)), the sums written out
    left to right as the kernel adds them; overlap needs has_valid and, with
    use_bound, mind <= bound + 1e-3; then per (block, chunk) the min of the
    overlapping cones' minds (INF if none) and any-overlap. A pool gives
    cobj (C,), each chunk's object, and smin (O, B), the block's minimum
    scale: floors are scaled by it, and a disabled object's chunks are INF
    and dead. s = 0 returns (mind (B, C), overlap (B, C)); s > 0 returns the
    overlap packed as bits (B, n_words) and, with `floors`, the supers' of s
    chunks (B, ceil(C / s)) min floor and any-overlap, the pad past C INF
    and dead (else None, None)."""
    if cobj is None:
        q = table[:, None, :].unbind(-1)  # (B * sub, 1) each
    else:
        q = table[cobj.long()].transpose(0, 1).unbind(-1)  # (B * sub, C) each
    c = spheres.unbind(1)
    r = c[3] + q[8]
    dc = [c[k] - q[k] for k in range(3)]
    dlen = torch.sqrt(dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2])
    mind = torch.clamp(dlen - r, min=0.0)
    dl = torch.clamp(dlen, min=1e-12)
    cos_d = (dc[0] * q[3] + dc[1] * q[4] + dc[2] * q[5]) / dl
    sin_b = torch.clamp(r / dl, max=1.0)
    cos_b = torch.sqrt(torch.clamp(1.0 - sin_b * sin_b, min=0.0))
    # a + b >= pi (cos_b <= -cos_a) would wrap cos(a + b): always overlap.
    over = (dlen <= r) | (cos_b <= -q[6]) | (cos_d >= q[6] * cos_b - q[7] * sin_b)
    over = over & (q[10] != 0)
    if use_bound:
        over = over & (mind <= q[9] + 1e-3)
    n, C = over.shape
    over = over.reshape(n // sub, sub, C)
    mind = torch.where(over, mind.reshape(n // sub, sub, C), INF).amin(dim=1)
    over = over.any(dim=1)
    if smin is not None:
        on = q[11][0] != 0
        mind = torch.where(on, mind * smin[cobj.long()].T, INF)
        over = over & on
    if not s:
        return mind, over
    bits = pack_bits(_pad_cols(over, n_words * 32, False))
    if not floors:
        return bits, None, None
    B = mind.shape[0]
    C_s = -(-C // s)
    return (bits, _pad_cols(mind, C_s * s, INF).reshape(B, C_s, s).amin(dim=2),
            _pad_cols(over, C_s * s, False).reshape(B, C_s, s).any(dim=2))


GROUP = 32  # chunks a warp of rpt_live_cull holds: the pre-test's group
# The pre-test's margins (derived in csrc/live_lists.cu, "The group pre-test"):
GROUP_KAPPA = 2.0 ** -7  # added to the group's sin_b: at least that much angle, in radians
GROUP_TAU = 2.0 ** -16  # slack of the pre-test's two cosine comparisons
GROUP_MU = 2.0 ** -18  # relative slack of the distances, the group radius and its mind
_REAL_INF = float("inf")


def group_may_overlap_plain(spheres, table, sub=SUB, use_bound=False, cobj=None):
    """The pre-test of the rpt_live_cull kernel, in its operations: for each
    block and each group of GROUP consecutive chunks, whether any of the
    block's `sub` cones may overlap any chunk of the group (B, ceil(C /
    GROUP)) bool. Where it is False, every cone test of the group is dead,
    so the kernel writes the dead chunks' results without running them.
    Arguments as `live_cull_plain`; a pool group whose chunks belong to two
    objects is never tested (True). The group's sphere contains its real
    chunks' spheres: centre of their box, radius the farthest surface, grown
    by GROUP_MU; each cone is tested in the dense test's form with the
    margins GROUP_KAPPA, GROUP_TAU and GROUP_MU, and a NaN reads as "may
    overlap". Used by the tests, never on the frame path."""
    C = spheres.shape[0]
    G = -(-C // GROUP)
    pad = G * GROUP - C
    s = torch.cat([spheres, spheres.new_zeros((pad, 4))]).reshape(G, GROUP, 4)
    real = (torch.arange(G * GROUP, device=spheres.device) < C).reshape(G, GROUP)
    c, r = s[..., :3], s[..., 3:4]
    lo = torch.where(real[..., None], c - r, _REAL_INF).amin(dim=1)
    hi = torch.where(real[..., None], c + r, -_REAL_INF).amax(dim=1)
    centre = (lo + hi) * 0.5
    dc = (c - centre[:, None, :]).unbind(-1)
    dist = torch.sqrt(dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2])
    rad = torch.where(real, dist + s[..., 3], -_REAL_INF).amax(dim=1) * (1.0 + GROUP_MU)
    if cobj is None:
        q = table[None].transpose(0, 1).unbind(-1)  # (B * sub, 1) each
        tested = torch.ones(G, dtype=torch.bool, device=spheres.device)
    else:
        obj = torch.cat([cobj.long(), cobj.long()[-1:].expand(pad)]).reshape(G, GROUP)
        tested = (obj == obj[:, :1]).all(dim=1)
        q = table[obj[:, 0]].transpose(0, 1).unbind(-1)  # (B * sub, G) each
    r = rad + q[8]
    d = [centre[:, k] - q[k] for k in range(3)]
    dlen = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    dl = torch.clamp(dlen, min=1e-12)
    cos_d = (d[0] * q[3] + d[1] * q[4] + d[2] * q[5]) / dl
    sin_b = torch.clamp(r / dl + GROUP_KAPPA, max=1.0)
    cos_b = torch.sqrt(torch.clamp(1.0 - sin_b * sin_b, min=0.0))
    # every comparison False on a NaN: a NaN never makes a cone dead
    dead = ((dlen > r + 2.0 * GROUP_KAPPA * dl) & (cos_b > -q[6] + GROUP_TAU)
            & (cos_d < q[6] * cos_b - q[7] * sin_b - GROUP_TAU)) | (q[10] == 0)
    if use_bound:
        dead = dead | ((dlen - r) - GROUP_MU * (dlen + r) > q[9] + 1e-3)
    n = dead.shape[0]
    return ~(dead.reshape(n // sub, sub, -1).all(dim=1) & tested)


def _cull_cuda(spheres, table, sub: int, use_bound: bool, cobj, smin, s: int, n_words: int,
               floors: bool, count: bool):
    C = spheres.shape[0]
    O = table.shape[0] if table.dim() == 3 else 1
    B = table.shape[-2] // sub
    f32 = torch.float32
    specs = [(spheres, f32, (C, 4)), (table, f32, (*table.shape[:-2], B * sub, CONE_COLS))]
    if cobj is not None:
        specs += [(cobj, torch.int32, (C,)), (smin, f32, (O, B))]
    check_cuda("live_cull", *specs)
    a, b, c, _ = _cull_fake(spheres, table, sub, use_bound, cobj, smin, s, n_words, floors,
                            count)
    skipped = counter(spheres, count)
    skip = skipped if count else None
    if not s:
        launch("rpt_live_cull", spheres, C, table, B, sub, cobj, smin, int(use_bound), 0, 0,
               a, b, None, None, None, skip)
    else:
        launch("rpt_live_cull", spheres, C, table, B, sub, cobj, smin, int(use_bound), s,
               n_words, None, None, a, b if floors else None, c if floors else None, skip)
    return a, b, c, skipped


def _cull_cpu(spheres, table, sub: int, use_bound: bool, cobj, smin, s: int, n_words: int,
              floors: bool, count: bool):
    out = live_cull_plain(spheres, table, sub, use_bound, cobj, smin, s, n_words, floors)
    if not s:
        return *out, spheres.new_empty(0), counter(spheres, count)
    bits, mg, og = out
    if not floors:
        mg, og = spheres.new_empty(0), spheres.new_empty(0, dtype=torch.bool)
    return bits, mg, og, counter(spheres, count)


def _cull_fake(spheres, table, sub: int, use_bound: bool, cobj, smin, s: int, n_words: int,
               floors: bool, count: bool):
    C = spheres.shape[0]
    B = table.shape[-2] // sub
    skipped = spheres.new_empty(1 if count else 0, dtype=torch.int32)
    if not s:
        return (spheres.new_empty((B, C)), spheres.new_empty((B, C), dtype=torch.bool),
                spheres.new_empty(0), skipped)
    C_s = -(-C // s) if floors else 0
    return (spheres.new_empty((B, n_words), dtype=torch.int32),
            spheres.new_empty((B, C_s) if floors else 0),
            spheres.new_empty((B, C_s) if floors else 0, dtype=torch.bool), skipped)


_cull_op = define_op(
    "live_cull", "(Tensor spheres, Tensor table, int sub, bool use_bound, Tensor? cobj, "
    "Tensor? smin, int s, int n_words, bool floors, bool count) "
    "-> (Tensor, Tensor, Tensor, Tensor)", _cull_cuda, _cull_cpu, _cull_fake)


def live_cull(spheres, table, sub=SUB, use_bound=False, cobj=None, smin=None, s=0, n_words=0,
              floors=True, skipped=None):
    """K4's cull: the rpt_live_cull kernel on CUDA tensors, the plain twin
    on CPU tensors; arguments and results as `live_cull_plain`. s must
    divide 32 or be a multiple of it. skipped, a (1,) int32 tensor on the
    card, gains the (block, GROUP-chunk group) pairs whose cone tests the
    kernel's pre-test skipped (the twin skips none and leaves it); the frame
    path passes none."""
    if not on_cpu("live_cull", spheres) and s and (32 % s if s < 32 else s % 32):
        raise ValueError(f"live_cull: s must divide 32 or be a multiple of it, got {s}")
    a, b, c, count = _cull_op(spheres, table, sub, bool(use_bound), cobj, smin, s, n_words,
                              floors, skipped is not None)
    if skipped is not None:
        skipped += count
    if not s:
        return a, b
    return (a, b, c) if floors else (a, None, None)


def bucket_ids_plain(mind, overlap):
    """Each entry's counting-sort bucket (B, C) int32: its floor's bucket
    0-15 between the block's min floor (lo, over every entry) and its live
    entries' max (hi), a dead entry NBKT; and (lo, span) (B, 1) each, span =
    clamp(hi - lo, 1e-6)."""
    lo_k = mind.amin(dim=1, keepdim=True)
    hi_k = torch.where(overlap, mind, -INF).amax(dim=1, keepdim=True)
    span = torch.clamp(hi_k - lo_k, min=1e-6)
    x = (mind - lo_k) / span * (NBKT - 1)
    # Saturating float -> int (NaN -> 0), as XLA converts.
    bucket = torch.clamp(torch.where(x > 0, x, 0.0), max=NBKT - 1).to(torch.int32)
    return bucket, lo_k, span


def bucket_order_plain(mind, overlap):
    """Plain twin of the rpt_bucket_order kernel: front-to-back compaction
    of live entries per block by a 16-bucket counting sort. mind/overlap:
    (B, C). Returns (order (B, C) int32 entry ids, live ones first; minds
    (B, C) f32 bucket floors keyed by entry id; counts (B,) int32 live
    counts). Floors never exceed an entry's true distance and never decrease
    along `order`, so stopping on them is sound. The order is by bucket,
    then by entry id: a stable sort of the bucket ids."""
    n_chunks = mind.shape[1]
    bucket, lo_k, span = bucket_ids_plain(mind, overlap)
    key = lo_k + bucket.to(torch.float32) * _divide(span, NBKT - 1)
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


def _sort_cuda(mind, overlap):
    B, C = mind.shape
    check_cuda("bucket_order", (mind, torch.float32, (B, C)), (overlap, torch.bool, (B, C)))
    order, key, counts = _sort_fake(mind, overlap)
    launch("rpt_bucket_order", mind, overlap, B, C, order, key, counts)
    return order, key, counts


def _sort_fake(mind, overlap):
    B, C = mind.shape
    return (mind.new_empty((B, C), dtype=torch.int32), mind.new_empty((B, C)),
            mind.new_empty(B, dtype=torch.int32))


_sort_op = define_op("bucket_order", "(Tensor mind, Tensor overlap) -> (Tensor, Tensor, Tensor)",
                     _sort_cuda, bucket_order_plain, _sort_fake)


def bucket_order(mind, overlap):
    """K4's sort: the rpt_bucket_order kernel on CUDA tensors, the plain
    twin on CPU tensors; arguments and results as `bucket_order_plain`."""
    on_cpu("bucket_order", mind)
    return _sort_op(mind, overlap)


def _list_ops(plain: bool):
    """(table, cull, sort): K4's kernels, or their twins."""
    if plain:
        return cone_table_plain, live_cull_plain, bucket_order_plain
    return cone_table, live_cull, bucket_order


def _lists(plain, spheres, dh_p, o_p, valid, lane_bound):
    table_of, cull, sort = _list_ops(plain)
    table = table_of(dh_p, o_p, valid, lane_bound)
    return sort(*cull(spheres, table, SUB, lane_bound is not None))


def live_chunk_lists(spheres, dh_p, o_p, valid=None, lane_bound=None):
    """Per-block live-chunk lists for rays dh_p/o_p (3, n_pad): each
    128-lane sub-cone culled against every chunk sphere (valid drops masked
    lanes from the cones and all-masked subs entirely; lane_bound culls rays
    as segments), reduced to 1024-lane blocks (overlap = any sub overlaps,
    mind = min over overlapping subs), then sorted front to back. Returns
    (order (B, C), minds (B, C), counts (B,)). K4's kernels on CUDA tensors,
    their twins on CPU tensors."""
    return _lists(False, spheres, dh_p, o_p, valid, lane_bound)


def live_chunk_lists_plain(spheres, dh_p, o_p, valid=None, lane_bound=None):
    """live_chunk_lists with the kernels' plain twins, on any device."""
    return _lists(True, spheres, dh_p, o_p, valid, lane_bound)


def _lists2(plain, spheres, dh_p, o_p, valid, lane_bound, s):
    table_of, cull, sort = _list_ops(plain)
    table = table_of(dh_p, o_p, valid, lane_bound)
    bits, mind_g, over_g = cull(spheres, table, SUB, lane_bound is not None, None, None, s,
                                -(-spheres.shape[0] // 32), True)
    return (*sort(mind_g, over_g), bits)


def live_chunk_lists2(spheres, dh_p, o_p, valid=None, lane_bound=None, s=8):
    """Two-level lists: front-to-back order of superchunks of `s`
    consecutive chunks, their floors reduced from the chunk-level cull (min
    over the group's live chunks, any for overlap), and the chunk-level
    overlap packed as bits. Returns (order (B, C_s), minds (B, C_s), counts
    (B,), bits (B, ceil(C / 32))). K4's kernels on CUDA tensors (s dividing
    32 or a multiple of it), their twins on CPU tensors."""
    return _lists2(False, spheres, dh_p, o_p, valid, lane_bound, s)


def live_chunk_lists2_plain(spheres, dh_p, o_p, valid=None, lane_bound=None, s=8):
    """live_chunk_lists2 with the kernels' plain twins, on any device."""
    return _lists2(True, spheres, dh_p, o_p, valid, lane_bound, s)


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


def _lists3(plain, spheres, dh_p, o_p, valid, lane_bound, s):
    table_of, cull, sort = _list_ops(plain)
    table = table_of(dh_p, o_p, valid, lane_bound)
    order, minds, counts = sort(*cull(super_spheres_of(spheres, s), table, SUB,
                                      lane_bound is not None))
    # The chunk bits from one cone per block; an all-masked block's
    # degenerate cone reads as overlapping all, so has_valid drops it. The
    # bit columns cover C_s * s chunks: the walk's cursor reaches the pad
    # positions of a ragged last super.
    blocks = table_of(dh_p, o_p, valid, None, NB)
    width = -(-spheres.shape[0] // s) * s
    bits, _, _ = cull(spheres, blocks, 1, False, None, None, s, -(-width // 32), False)
    return order, minds, counts, bits


def live_chunk_lists3(spheres, dh_p, o_p, valid=None, lane_bound=None, s=128):
    """live_chunk_lists2 for very large chunk counts: order, floors and
    segment culling against the super spheres (sub-cone work (n_sub, C / s)
    instead of (n_sub, C)), and the chunk bits from one block-cone pass,
    padded to C_s * s columns. Same outputs as lists2. K4's kernels on CUDA
    tensors (s dividing 32 or a multiple of it), their twins on CPU
    tensors."""
    return _lists3(False, spheres, dh_p, o_p, valid, lane_bound, s)


def live_chunk_lists3_plain(spheres, dh_p, o_p, valid=None, lane_bound=None, s=128):
    """live_chunk_lists3 with the kernels' plain twins, on any device."""
    return _lists3(True, spheres, dh_p, o_p, valid, lane_bound, s)


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


def _shared_walk_cuda(order, minds, counts, box, tri, attrs, dh_p):
    B, C = order.shape
    n_pad = B * NB
    f32, i32 = torch.float32, torch.int32
    check_cuda("shared_walk", (order, i32, (B, C)), (minds, f32, (B, C)), (counts, i32, (B,)),
               (box, f32, (9,)), (tri, f32, (C * TC, 10)), (attrs, f32, (C * TC, N_ATTR)),
               (dh_p, f32, (3, n_pad)))
    t, u, v, tri_out, attr = _shared_walk_fake(order, minds, counts, box, tri, attrs, dh_p)
    launch("rpt_shared_walk", order, minds, counts, box, tri, attrs, dh_p, n_pad, C,
           t, u, v, tri_out, attr)
    return t, u, v, tri_out, attr


def _shared_walk_fake(order, minds, counts, box, tri, attrs, *rest):
    """Results of a shared-origin walk over B blocks: t, u, v, tri, attr."""
    n_pad = order.shape[0] * NB
    return (*(box.new_empty(n_pad) for _ in range(3)), box.new_empty(n_pad, dtype=torch.int32),
            box.new_empty((N_ATTR, n_pad)))


_shared_walk_op = define_op(
    "shared_walk", "(Tensor order, Tensor minds, Tensor counts, Tensor box, Tensor tri, "
    "Tensor attrs, Tensor dh_p) -> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    _shared_walk_cuda, shared_walk_plain, _shared_walk_fake)


def shared_walk(order, minds, counts, box, tri, attrs, dh_p):
    """K5 walk over live lists: the CUDA kernel on CUDA tensors, the plain
    twin on CPU tensors. order/minds (B, C), counts (B,), box (9,)
    [lo hi ro], tri (T_pad, 10), attrs (T_pad, 15), dh_p (3, B * NB)."""
    on_cpu("shared_walk", dh_p)
    return _shared_walk_op(order, minds, counts, box, tri, attrs, dh_p)


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


def _general_walk_cuda(order, minds, counts, box, rows, r10_p, tmax2):
    B, C = order.shape
    n_pad = B * NB
    f32, i32 = torch.float32, torch.int32
    check_cuda("general_walk", (order, i32, (B, C)), (minds, f32, (B, C)), (counts, i32, (B,)),
               (box, f32, (6,)), (rows, f32, (C * TC_GEN, 20)), (r10_p, f32, (10, n_pad)),
               (tmax2, f32, (2, n_pad)))
    t = _general_walk_fake(order)
    launch("rpt_general_walk", order, minds, counts, box, rows, r10_p, tmax2, n_pad, C, t)
    return t


def _general_walk_fake(order, *rest):
    """Result of a shadow walk over B blocks: t (B * NB,) f32."""
    return order.new_empty(order.shape[0] * NB, dtype=torch.float32)


_general_walk_op = define_op(
    "general_walk", "(Tensor order, Tensor minds, Tensor counts, Tensor box, Tensor rows, "
    "Tensor r10_p, Tensor tmax2) -> Tensor", _general_walk_cuda, general_walk_plain,
    _general_walk_fake)


def general_walk(order, minds, counts, box, rows, r10_p, tmax2):
    """K6 walk: the CUDA kernel on CUDA tensors, the plain twin on CPU
    tensors. box (6,) [lo hi], rows (T_pad, 20), r10_p (10, B * NB),
    tmax2 (2, B * NB) [tmax; tcut]."""
    on_cpu("general_walk", r10_p)
    return _general_walk_op(order, minds, counts, box, rows, r10_p, tmax2)


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
