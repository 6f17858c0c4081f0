"""Mesh walks of the large-mesh tier: K11 (primary) and K12 (shadow).

Torch counterpart of `relativitypathtracer_tpu.ops.pallas.mesh_large`. A
mesh whose padded triangle count is above LARGE_T keeps the walks of K5/K6
but not their lists: the counting sort's permutation inversion grows as the
square of the chunk count, so the front-to-back order runs over superchunks
of S consecutive chunks, and a per-(block, chunk) overlap bitmask keeps the
walk as tight as the chunk-level cull (`large_live_lists`). The kernels run
a cursor over the positions of each block's live supers, skip the chunks
whose bit is clear, and stop at the first live chunk whose super's floor is
not below the block bound (both walk each super's bit words with a
find-first-set, so S is a multiple of 32).

The TPU streams per-chunk records from HBM into VMEM with double-buffered
DMAs (its VMEM holds no large pool), packed lane-major because Mosaic
needs 128-lane DMA regions; the port's kernels read the same (T_pad, 10),
(T_pad, 20) and (T_pad, 15) rows as K5/K6, so the large tier needs no
records of its own (`pack_*_records` and the bf16-split attributes are not
ported).

`large_shared_walk` and `large_general_walk` (through their operators
torch.ops.rpt.large_shared_walk and torch.ops.rpt.large_general_walk)
launch the CUDA kernels
(csrc/mesh_kernels.cu, the K5/K6 walks fed the superchunk lists) on CUDA
tensors; on CPU tensors they call their plain twins, which write the cursor
out as a per-block list of live chunks with their floors
(`super_cursor_lists`) and walk it with K5/K6's twins.
"""

from __future__ import annotations

import torch

from ._build import check_cuda, define_op, launch, on_cpu
from .mesh_kernels import (
    N_ATTR, NB, TC, _box_of, _general_lane_bound, _general_walk_fake, _pad_lanes, _round_up,
    _shared_walk_fake, live_chunk_lists2, live_chunk_lists2_plain, live_chunk_lists3,
    live_chunk_lists3_plain, shared_tri_rows, walk_general_lists, walk_shared_lists)

S_SUPER = 32  # chunks per superchunk
LARGE_T = 24576  # T_pad above which the JAX package's VMEM kernels stop fitting
# Above this chunk count the dense chunk-level cull stops scaling: order and
# floors come from super spheres of S_SUPER_XL chunks (live_chunk_lists3).
SUPER_CULL_C = 16384
S_SUPER_XL = 128


def _super_s(C: int) -> int:
    """Ordering granularity for a C-chunk pool."""
    return S_SUPER if C <= SUPER_CULL_C else S_SUPER_XL


def large_live_lists(spheres, dh_p, o_p, valid=None, lane_bound=None):
    """Superchunk order, floors, counts and chunk bits for rays dh_p/o_p
    (3, n_pad): live_chunk_lists2 at S_SUPER up to SUPER_CULL_C chunks,
    live_chunk_lists3 at S_SUPER_XL above."""
    C = spheres.shape[0]
    if C <= SUPER_CULL_C:
        return live_chunk_lists2(spheres, dh_p, o_p, valid, lane_bound, s=S_SUPER)
    return live_chunk_lists3(spheres, dh_p, o_p, valid, lane_bound, s=S_SUPER_XL)


def large_live_lists_plain(spheres, dh_p, o_p, valid=None, lane_bound=None):
    """large_live_lists with K4's plain twins, on any device."""
    if spheres.shape[0] <= SUPER_CULL_C:
        return live_chunk_lists2_plain(spheres, dh_p, o_p, valid, lane_bound, s=S_SUPER)
    return live_chunk_lists3_plain(spheres, dh_p, o_p, valid, lane_bound, s=S_SUPER_XL)


def super_cursor_lists(order, minds, counts, bits, S: int, C: int):
    """The kernels' cursor written out. Position p of block b's walk is chunk
    order[b, p // S] * S + p % S, for p below counts[b] * S; it is live when
    the chunk is below C and its bit is set. Returns each block's live chunks
    in walk order, with the floor of the super each belongs to: (chunks
    (B, P) int32, floors (B, P), n_live (B,)), P = C_s * S."""
    B, C_s = order.shape
    P = C_s * S
    p = torch.arange(P, device=order.device)
    sup = order[:, p // S].long()
    chunk = sup * S + p % S
    safe = chunk.clamp(max=C - 1)
    bit = (bits.gather(1, safe >> 5).long() >> (safe & 31)) & 1
    live = (p[None, :] < counts[:, None].long() * S) & (chunk < C) & (bit != 0)
    # live positions first, each group in walk order (the keys are distinct)
    pick = torch.where(live, p, P + p).argsort(dim=1)
    return (chunk.gather(1, pick).to(torch.int32), minds.gather(1, sup).gather(1, pick),
            live.sum(dim=1))


def large_shared_walk_plain(order, minds, counts, bits, box, tri, attrs, dh_p, S: int,
                            C: int, T: int):
    """Plain twin of the K11 kernel."""
    chunks, floors, n_live = super_cursor_lists(order, minds, counts, bits, S, C)
    return walk_shared_lists(chunks, floors, n_live, box, tri, attrs, dh_p, T)


def _shared_cuda(order, minds, counts, bits, box, tri, attrs, dh_p, S: int, C: int, T: int):
    B, C_s = order.shape
    W = bits.shape[1]
    n_pad = B * NB
    f32, i32 = torch.float32, torch.int32
    check_cuda("large_shared_walk", (order, i32, (B, C_s)), (minds, f32, (B, C_s)),
               (counts, i32, (B,)), (bits, i32, (B, W)), (box, f32, (9,)),
               (tri, f32, (C * TC, 10)), (attrs, f32, (C * TC, N_ATTR)),
               (dh_p, f32, (3, n_pad)))
    t, u, v, tri_out, attr = _shared_walk_fake(order, minds, counts, box, tri, attrs)
    launch("rpt_large_shared_walk", order, minds, counts, bits, box, tri, attrs, dh_p, n_pad,
           C_s, W, S, C, T, t, u, v, tri_out, attr)
    return t, u, v, tri_out, attr


def _shared_fake(order, minds, counts, bits, box, tri, attrs, dh_p, S: int, C: int, T: int):
    return _shared_walk_fake(order, minds, counts, box, tri, attrs)


_shared_op = define_op(
    "large_shared_walk", "(Tensor order, Tensor minds, Tensor counts, Tensor bits, Tensor box, "
    "Tensor tri, Tensor attrs, Tensor dh_p, int S, int C, int T) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor)", _shared_cuda, large_shared_walk_plain,
    _shared_fake)


def large_shared_walk(order, minds, counts, bits, box, tri, attrs, dh_p, S: int, C: int,
                      T: int):
    """K11 walk: the CUDA kernel on CUDA tensors, the plain twin on CPU
    tensors. order/minds (B, C_s), counts (B,), bits (B, W), box (9,)
    [lo hi ro], tri (C * TC, 10), attrs (C * TC, 15), dh_p (3, B * NB); S
    chunks per super, C chunks, T real triangles."""
    if dh_p.device.type != "cpu" and S % 32 != 0:
        raise ValueError(f"large_shared_walk: S must be a multiple of 32, got {S}")
    on_cpu("large_shared_walk", dh_p)
    return _shared_op(order, minds, counts, bits, box, tri, attrs, dh_p, S, C, T)


def large_general_walk_plain(order, minds, counts, bits, box, rows, r10_p, tmax2, S: int,
                             C: int, T: int):
    """Plain twin of the K12 kernel."""
    chunks, floors, n_live = super_cursor_lists(order, minds, counts, bits, S, C)
    return walk_general_lists(chunks, floors, n_live, box, rows, r10_p, tmax2, T)


def _general_cuda(order, minds, counts, bits, box, rows, r10_p, tmax2, S: int, C: int,
                  T: int):
    B, C_s = order.shape
    W = bits.shape[1]
    n_pad = B * NB
    f32, i32 = torch.float32, torch.int32
    check_cuda("large_general_walk", (order, i32, (B, C_s)), (minds, f32, (B, C_s)),
               (counts, i32, (B,)), (bits, i32, (B, W)), (box, f32, (6,)),
               (rows, f32, (C * TC, 20)), (r10_p, f32, (10, n_pad)), (tmax2, f32, (2, n_pad)))
    t = _general_walk_fake(order)
    launch("rpt_large_general_walk", order, minds, counts, bits, box, rows, r10_p, tmax2,
           n_pad, C_s, W, S, C, T, t)
    return t


_general_op = define_op(
    "large_general_walk", "(Tensor order, Tensor minds, Tensor counts, Tensor bits, "
    "Tensor box, Tensor rows, Tensor r10_p, Tensor tmax2, int S, int C, int T) -> Tensor",
    _general_cuda, large_general_walk_plain, _general_walk_fake)


def large_general_walk(order, minds, counts, bits, box, rows, r10_p, tmax2, S: int, C: int,
                       T: int):
    """K12 walk: the CUDA kernel on CUDA tensors, the plain twin on CPU
    tensors. box (6,) [lo hi], rows (C * TC, 20), r10_p (10, B * NB), tmax2
    (2, B * NB) [tmax; tcut]; the lists as for `large_shared_walk`."""
    if r10_p.device.type != "cpu" and S % 32 != 0:
        raise ValueError(f"large_general_walk: S must be a multiple of 32, got {S}")
    on_cpu("large_general_walk", r10_p)
    return _general_op(order, minds, counts, bits, box, rows, r10_p, tmax2, S, C, T)


def large_shared_nearest_hit(consts, c_t, attrs, spheres, dh, ro, T: int):
    """shared_nearest_hit for the large tier: the same inputs (consts
    (4 * T_pad, 3), c_t (T_pad,), attrs (T_pad, 15), spheres (T_pad / TC, 4),
    unit dirs dh (3, N) from ro (3,)), T the real triangle count. Returns
    (t, u, v, tri, attr (15, N))."""
    n = dh.shape[1]
    C = spheres.shape[0]
    dh_p = _pad_lanes(dh, _round_up(n, NB), 1.0)
    order, minds, counts, bits = large_live_lists(spheres, dh_p,
                                                  ro[:, None].expand_as(dh_p))
    lo, hi = _box_of(spheres)
    t, u, v, tri, attr = large_shared_walk(
        order, minds, counts, bits, torch.cat([lo, hi, ro]), shared_tri_rows(consts, c_t),
        attrs.contiguous(), dh_p, _super_s(C), C, T)
    return t[:n], u[:n], v[:n], tri[:n], attr[:, :n]


def large_general_min_t(rows, spheres, r10, tmax_obj, valid, tcut_obj, T: int):
    """general_min_t for the large tier: rows (T_pad, 20) from
    general_tri_rows, spheres (T_pad / TC, 4); the tmax/tcut contract of
    mesh_kernels.general_min_t."""
    n = r10.shape[1]
    C = spheres.shape[0]
    n_pad = _round_up(n, NB)
    r10_p = _pad_lanes(r10, n_pad, 1.0)
    tmax2 = _pad_lanes(torch.stack([tmax_obj, tcut_obj]), n_pad)
    lo, hi = _box_of(spheres)
    order, minds, counts, bits = large_live_lists(
        spheres, r10_p[0:3], r10_p[6:9], valid=_pad_lanes(valid, n_pad, False),
        lane_bound=_general_lane_bound(tmax2[0], r10_p, lo, hi))
    t = large_general_walk(order, minds, counts, bits, torch.cat([lo, hi]), rows, r10_p,
                           tmax2, _super_s(C), C, T)
    return t[:n]
