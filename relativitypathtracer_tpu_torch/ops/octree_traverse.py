"""The reference's stackless octree walk, as a masked loop of torch ops.

Torch counterpart of `relativitypathtracer_tpu.ops.octree_traverse`
(intersect_octree, opencl_kernel.cl:200-308): descend to the leaf that holds
the ray's entry point, test the leaf's triangles, then hop to the neighbour
across the exit face; repeat until the walk leaves the tree or passes the
best hit. Every ray advances in lockstep, finished lanes masked.

It is the validation path beside the chunk walks (K5/K6 and the others),
not a frame route: every step gathers node fields per ray. Each iteration
tests one triangle a lane (the cursor within its leaf), or hops and
descends where the leaf is exhausted. Whether any lane is still walking is
read every CHECK_EVERY iterations (each read waits for the device); the
extra iterations of finished lanes change nothing.
"""

from __future__ import annotations

import torch

from .intersect import apply_affine3, apply_linear3, apply_normal3, norm3, normalize3

EPSILON = 1e-7
INF = 1e20
CHECK_EVERY = 16
MAX_DEPTH_STEPS = 8  # the octree builder's MAX_DEPTH is 6


def _dot(a, b):
    """Dot product over axis 0 of (3, N), in a fixed order on every device."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    """Cross product over axis 0 of (3, N), each product rounded on its own
    (torch.linalg.cross's CPU kernel may contract into FMAs; the card's
    does not)."""
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _cols(x, idx):
    """Rows `idx` of a (Q, k) table as (k, N) columns."""
    return x[idx].T


def _aabb_entry(bmin, bmax, o, dh):
    """Slab test: (t_near, t_far, hit); every argument (3, N)."""
    inv = 1.0 / dh
    t0 = (bmin - o) * inv
    t1 = (bmax - o) * inv
    near = torch.minimum(t0, t1).amax(dim=0)
    far = torch.maximum(t0, t1).amin(dim=0)
    return near, far, (near <= far) & (far > 0)


def _rnd(x):
    """OpenCL's round (half away from zero) for x >= -0.5: torch.round is half
    to even, which at a cell centre (0.5) picks the low child while the fmod
    reparametrisation below assumes the high one."""
    return torch.floor(x + 0.5).long()


def _descend(children, node, pos):
    """Descend from `node` (N,) to the leaf holding the node-normalised
    position pos (3, N) in [0, 1], as the child round and fmod
    reparametrisation of opencl_kernel.cl:236-241. Returns (node, pos)."""
    for _ in range(MAX_DEPTH_STEPS):
        ch = children[node]  # (N, 8)
        inner = ch[:, 0] != -1
        ci = torch.clamp(_rnd(pos[2]) + 2 * _rnd(pos[1]) + 4 * _rnd(pos[0]), 0, 7)
        child = ch.gather(1, ci[:, None])[:, 0].long()
        # torch.fmod is C's fmod (truncated), as the reference's
        new_pos = 2.0 * torch.fmod(torch.clamp(pos, max=1.0 - EPSILON), 0.5)
        node = torch.where(inner, child, node)
        pos = torch.where(inner[None, :], new_pos, pos)
    return node, pos


def _exit_face(sdir, pos):
    """Move the node-normalised pos to the exit face along sdir: (face,
    new_pos), as getOppositeBoxSide (opencl_kernel.cl:172-198)."""
    inv = 1.0 / sdir
    s = (inv < 0).long()  # (3, N)
    d = (1.0 - s.float() - pos) * inv
    dx, dy, dz = d[0], d[1], d[2]
    take_x = (dx < dy) & (dx < dz)
    take_y = ~take_x & (dy < dz)
    step = torch.where(take_x, dx, torch.where(take_y, dy, dz))
    face = torch.where(take_x, 3 - s[0], torch.where(take_y, 5 - s[1], 1 - s[2]))
    return face, pos + sdir * step


def octree_intersect(mesh, root: int, m4, inv_m, o3, d3, *, iteration_cap: int = 16384,
                     stats: dict | None = None):
    """Nearest hit through the octree walk: o3 (3,) shared origin, d3 (3, N).

    Returns (t, normal (3, N), uv (2, N), valid, converged): the hit
    semantics of mesh_intersect_shared, and a bool, False when the iteration
    cap stopped the walk with lanes still walking. Then the result may be
    incomplete and must not be used as an oracle. With `stats`, its
    "iterations" is set to the iterations run (a multiple of CHECK_EVERY,
    or the cap)."""
    from ..render import full_precision

    with full_precision():  # the transforms are matmuls: no TF32
        return _walk(mesh, int(root), m4, inv_m, o3, d3, int(iteration_cap), stats)


def _walk(mesh, root, m4, inv_m, o3, d3, iteration_cap, stats):
    n = d3.shape[1]
    dev = d3.device
    ro = apply_affine3(inv_m, o3)  # (3,)
    d = apply_linear3(inv_m, d3)
    dh = d / norm3(d)
    o = ro[:, None].expand_as(dh)

    root_arr = torch.full((n,), root, dtype=torch.long, device=dev)
    bmin = _cols(mesh.node_min, root_arr)
    bmax = _cols(mesh.node_max, root_arr)
    near, _, hit_root = _aabb_entry(bmin, bmax, o, dh)
    pos_w = o + dh * near

    # An origin inside the root (opencl_kernel.cl:233-248): descend by the
    # normalised origin, then re-enter that leaf.
    inside = near < 0
    node_in, _ = _descend(mesh.node_children, root_arr, (o - bmin) / (bmax - bmin))
    near2, _, hit_leaf = _aabb_entry(_cols(mesh.node_min, node_in),
                                     _cols(mesh.node_max, node_in), o, dh)
    pos_w = torch.where(inside[None, :], o + dh * near2, pos_w)
    node = torch.where(inside, node_in, root_arr)
    active = hit_root & torch.where(inside, hit_leaf, True)

    sdir = normalize3(dh / (_cols(mesh.node_max, node) - _cols(mesh.node_min, node)))

    best_t = torch.full((n,), INF, device=dev)
    best_u = torch.zeros((n,), device=dev)
    best_v = torch.zeros((n,), device=dev)
    best_tri = torch.zeros((n,), dtype=torch.long, device=dev)
    cursor = torch.full((n,), -1, dtype=torch.long, device=dev)  # -1: descend first
    last_slot = mesh.oct_tris.shape[0] - 1

    def body(active, node, pos_w, cursor, best_t, best_u, best_v, best_tri):
        # descend (masked): normalise into the node, walk down to its leaf
        need_descend = active & (cursor < 0)
        nmin, nmax = _cols(mesh.node_min, node), _cols(mesh.node_max, node)
        node_d, _ = _descend(mesh.node_children, node, (pos_w - nmin) / (nmax - nmin))
        node = torch.where(need_descend, node_d, node)
        cursor = torch.where(need_descend, 0, cursor)

        # one triangle a lane
        in_leaf = cursor < mesh.node_tris_count[node]
        slot = torch.clamp(mesh.node_tris_index[node] + cursor, 0, last_slot)
        tri = mesh.oct_tris[slot].long()
        tv = mesh.tri_v[tri].long()
        A = _cols(mesh.vertices, tv[:, 0])
        e1 = _cols(mesh.vertices, tv[:, 1]) - A
        e2 = _cols(mesh.vertices, tv[:, 2]) - A
        pvec = _cross(dh, e2)
        det = _dot(e1, pvec)
        tvec = o - A
        u = _dot(tvec, pvec) / det
        qvec = _cross(tvec, e1)
        v = _dot(dh, qvec) / det
        dist = _dot(e2, qvec) / det
        ok = (active & in_leaf & (det.abs() >= EPSILON) & (u >= 0) & (u <= 1) & (v >= 0)
              & (u + v <= 1) & (dist >= 0) & (dist < best_t))
        best_t = torch.where(ok, dist, best_t)
        best_u = torch.where(ok, u, best_u)
        best_v = torch.where(ok, v, best_v)
        best_tri = torch.where(ok, tri, best_tri)
        cursor = torch.where(active & in_leaf, cursor + 1, cursor)

        # hop to the neighbour where the leaf is exhausted
        exhausted = active & ~in_leaf & (cursor >= 0)
        nmin, nmax = _cols(mesh.node_min, node), _cols(mesh.node_max, node)
        ext = nmax - nmin
        face, pos_exit = _exit_face(sdir, (pos_w - nmin) / ext)
        pos_w_new = nmin + pos_exit * ext
        nb = mesh.node_neighbors[node].gather(1, face[:, None])[:, 0].long()
        leave = exhausted & ((nb == -1) | (norm3(pos_w_new - o) > best_t))
        hop = exhausted & ~leave
        active = active & ~leave
        node = torch.where(hop, nb, node)
        pos_w = torch.where(hop[None, :], pos_w_new, pos_w)
        cursor = torch.where(hop, -1, cursor)
        return active, node, pos_w, cursor, best_t, best_u, best_v, best_tri

    state = (active, node, pos_w, cursor, best_t, best_u, best_v, best_tri)
    it = 0
    while it < iteration_cap and bool(state[0].any()):
        for _ in range(min(CHECK_EVERY, iteration_cap - it)):
            state = body(*state)
        it += min(CHECK_EVERY, iteration_cap - it)
    active, _, _, _, best_t, best_u, best_v, best_tri = state
    converged = not bool(active.any())
    if stats is not None:
        stats["iterations"] = it

    valid = best_t < INF
    tri = torch.clamp(best_tri, 0, mesh.tri_v.shape[0] - 1)
    w0 = 1.0 - best_u - best_v
    tn = mesh.tri_n[tri].long()
    nrm = (w0 * _cols(mesh.normals, tn[:, 0]) + best_u * _cols(mesh.normals, tn[:, 1])
           + best_v * _cols(mesh.normals, tn[:, 2]))
    normal = normalize3(apply_normal3(inv_m, nrm))
    tuv = mesh.tri_uv[tri].long()
    uv = (w0 * _cols(mesh.uvs, tuv[:, 0]) + best_u * _cols(mesh.uvs, tuv[:, 1])
          + best_v * _cols(mesh.uvs, tuv[:, 2]))
    world_pt = apply_affine3(m4, ro[:, None] + best_t * dh)
    t = norm3(world_pt - o3[:, None]) / norm3(d3)
    return torch.where(valid, t, INF), normal, uv, valid, converged
