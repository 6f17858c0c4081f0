"""Host-side octree acceleration-structure construction.

Re-implements the behavior of the reference's octree construction
(Octree.cpp:6-248, Mesh.cpp:5-28). The output is a flat SoA ready to upload
as device arrays:

- 8-way subdivision down to depth 6, with the reference's adaptive stop rule:
  a child stops subdividing when its triangle count <= the parent's maximum
  triangles-per-vertex (Octree.cpp:180-190, 245-247).
- Face-neighbor links (z-/z+/x-/x+/y-/y+ = indices 0..5) for stackless
  traversal (Octree.cpp:213-244).
- The root is seeded with EVERY triangle in the shared pool, not just the new
  mesh's (Mesh.cpp:16-19) -- a reference quirk preserved for parity; bounds
  cover only the new mesh so foreign tris are culled during subdivision.

`generate_octree` always runs the port's C++ builder (csrc/octree_builder.cpp,
through ctypes), which ops/kernels/_build.build_host compiles at first use
into build/host/; a host without a C++ compiler cannot build a mesh scene.
`generate_octree_plain` is its twin in numpy (separating-axis tests
vectorized over a node's whole triangle list), which the tests hold it to
bit for bit; nothing on the scene build calls it. Both round every product
on its own (the library is compiled with -ffp-contract=off): an FMA would
keep or drop a triangle that grazes a box otherwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_DEPTH = 6


@dataclasses.dataclass
class OctreeArrays:
    node_min: list
    node_max: list
    node_tris_index: list
    node_tris_count: list
    node_children: list
    node_neighbors: list
    oct_tris: list
    max_depth: int = 0

    @staticmethod
    def empty() -> "OctreeArrays":
        return OctreeArrays([], [], [], [], [], [], [], 0)

    def __len__(self):
        return len(self.node_min)


def tri_box_overlap(A, B, C, box_min, box_max):
    """Vectorized SAT triangle/AABB overlap for K triangles vs one box.

    A, B, C: (K, 3) float32 triangle vertices; box_min/box_max: (3,).
    Returns (K,) bool. Axis set and per-axis vertex picks follow the
    Akenine-Moller optimized 13-axis test used by the reference
    (Octree.cpp:6-169).
    """
    center = (box_min + box_max) / 2.0
    ext = (box_max - box_min) / 2.0
    a = A - center
    b = B - center
    c = C - center
    ba = b - a
    cb = c - b
    ac = a - c

    # Nine edge-cross-axis tests; per-axis vertex picks differ per edge.
    keep = edge_tests_ba(ba, a, b, c, ext)
    keep &= edge_tests_cb(cb, a, b, c, ext)
    keep &= edge_tests_ac(ac, a, b, c, ext)

    # Face-plane test.
    n = np.cross(ba, cb)
    vmin = np.where(n > 0, -ext[None, :] - a, ext[None, :] - a)
    vmax = np.where(n > 0, ext[None, :] - a, -ext[None, :] - a)
    keep &= ~(np.sum(n * vmin, axis=1) > 0)
    keep &= ~(np.sum(n * vmax, axis=1) < 0)

    # Triangle bbox vs box extents.
    tmin = np.minimum(np.minimum(a, b), c)
    tmax = np.maximum(np.maximum(a, b), c)
    keep &= ~np.any((tmin > ext[None, :]) | (tmax < -ext[None, :]), axis=1)
    return keep


def _axis_test(p0, p1, rad):
    lo = np.minimum(p0, p1)
    hi = np.maximum(p0, p1)
    return ~((lo > rad) | (hi < -rad))


def edge_tests_ba(ba, a, b, c, ext):
    ex, ey, ez = np.abs(ba[:, 0]), np.abs(ba[:, 1]), np.abs(ba[:, 2])
    m = _axis_test(
        ba[:, 2] * a[:, 1] - ba[:, 1] * a[:, 2],
        ba[:, 2] * c[:, 1] - ba[:, 1] * c[:, 2],
        ez * ext[1] + ey * ext[2],
    )
    m &= _axis_test(
        -ba[:, 2] * a[:, 0] + ba[:, 0] * a[:, 2],
        -ba[:, 2] * c[:, 0] + ba[:, 0] * c[:, 2],
        ez * ext[0] + ex * ext[2],
    )
    m &= _axis_test(
        ba[:, 1] * b[:, 0] - ba[:, 0] * b[:, 1],
        ba[:, 1] * c[:, 0] - ba[:, 0] * c[:, 1],
        ey * ext[0] + ex * ext[1],
    )
    return m


def edge_tests_cb(cb, a, b, c, ext):
    ex, ey, ez = np.abs(cb[:, 0]), np.abs(cb[:, 1]), np.abs(cb[:, 2])
    m = _axis_test(
        cb[:, 2] * a[:, 1] - cb[:, 1] * a[:, 2],
        cb[:, 2] * c[:, 1] - cb[:, 1] * c[:, 2],
        ez * ext[1] + ey * ext[2],
    )
    m &= _axis_test(
        -cb[:, 2] * a[:, 0] + cb[:, 0] * a[:, 2],
        -cb[:, 2] * c[:, 0] + cb[:, 0] * c[:, 2],
        ez * ext[0] + ex * ext[2],
    )
    m &= _axis_test(
        cb[:, 1] * a[:, 0] - cb[:, 0] * a[:, 1],
        cb[:, 1] * b[:, 0] - cb[:, 0] * b[:, 1],
        ey * ext[0] + ex * ext[1],
    )
    return m


def edge_tests_ac(ac, a, b, c, ext):
    ex, ey, ez = np.abs(ac[:, 0]), np.abs(ac[:, 1]), np.abs(ac[:, 2])
    m = _axis_test(
        ac[:, 2] * a[:, 1] - ac[:, 1] * a[:, 2],
        ac[:, 2] * b[:, 1] - ac[:, 1] * b[:, 2],
        ez * ext[1] + ey * ext[2],
    )
    m &= _axis_test(
        -ac[:, 2] * a[:, 0] + ac[:, 0] * a[:, 2],
        -ac[:, 2] * b[:, 0] + ac[:, 0] * b[:, 2],
        ez * ext[0] + ex * ext[2],
    )
    m &= _axis_test(
        ac[:, 1] * b[:, 0] - ac[:, 0] * b[:, 1],
        ac[:, 1] * c[:, 0] - ac[:, 0] * c[:, 1],
        ey * ext[0] + ex * ext[1],
    )
    return m


def _subdivide(oct: OctreeArrays, verts: np.ndarray, tri_v: np.ndarray,
               node: int, min_tris: int, depth: int, cur_depth: int):
    """Recursive 8-way subdivision with neighbor links.

    Mirrors Subdivide (Octree.cpp:171-248): children are
    created in (x, y, z) loop order at slot z + 2y + 4x; the next level's
    min_tris is this node's max triangles-per-vertex.
    """
    oct.max_depth = max(oct.max_depth, cur_depth)
    count = oct.node_tris_count[node]
    if depth <= 0 or count <= min_tris:
        return
    start = oct.node_tris_index[node]
    tris = np.asarray(oct.oct_tris[start:start + count], np.int64)
    vids = tri_v[tris].ravel()
    max_tris_per_vertex = int(np.bincount(vids).max()) if len(vids) else 0

    nmin = np.asarray(oct.node_min[node], np.float32)
    nmax = np.asarray(oct.node_max[node], np.float32)
    half = (nmax - nmin) / 2.0

    A = verts[tri_v[tris, 0]]
    B = verts[tri_v[tris, 1]]
    C = verts[tri_v[tris, 2]]

    children = [-1] * 8
    for x in range(2):
        for y in range(2):
            for z in range(2):
                cmin = nmin + half * np.array([x, y, z], np.float32)
                cmax = cmin + half
                child = len(oct.node_min)
                children[z + 2 * y + 4 * x] = child
                inside = tri_box_overlap(A, B, C, cmin, cmax) if len(tris) else np.zeros(0, bool)
                kept = tris[inside]
                oct.node_min.append(cmin)
                oct.node_max.append(cmax)
                oct.node_tris_index.append(len(oct.oct_tris))
                oct.node_tris_count.append(int(len(kept)))
                oct.node_children.append([-1] * 8)
                oct.node_neighbors.append([-1] * 6)
                oct.oct_tris.extend(int(t) for t in kept)
    oct.node_children[node] = children

    pn = oct.node_neighbors[node]
    for x in range(2):
        for y in range(2):
            for z in range(2):
                ci = 4 * x + 2 * y + z
                cn = oct.node_neighbors[children[ci]]
                cn[0] = pn[0] if z == 0 else children[ci - 1]
                cn[1] = children[ci + 1] if z == 0 else pn[1]
                cn[2] = pn[2] if x == 0 else children[ci - 4]
                cn[3] = children[ci + 4] if x == 0 else pn[3]
                cn[4] = pn[4] if y == 0 else children[ci - 2]
                cn[5] = children[ci + 2] if y == 0 else pn[5]

    for i in range(8):
        _subdivide(oct, verts, tri_v, children[i], max_tris_per_vertex, depth - 1, cur_depth + 1)


def load_builder(path):
    """ctypes handle to a compiled builder library, its entries typed."""
    import ctypes

    lib = ctypes.CDLL(str(path))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.rpt_octree_build.restype = ctypes.c_void_p
    lib.rpt_octree_build.argtypes = [
        f32p, ctypes.c_int32, i32p, ctypes.c_int32, f32p, f32p, ctypes.c_int32,
    ]
    for name in ("rpt_octree_num_nodes", "rpt_octree_pool_size", "rpt_octree_max_depth"):
        getattr(lib, name).restype = ctypes.c_int32
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.rpt_octree_export.restype = None
    lib.rpt_octree_export.argtypes = [
        ctypes.c_void_p, f32p, f32p, i32p, i32p, i32p, i32p, i32p,
    ]
    lib.rpt_octree_free.restype = None
    lib.rpt_octree_free.argtypes = [ctypes.c_void_p]
    return lib


_LIB = None


def _library():
    """The C++ builder, compiled at its first use in a process."""
    global _LIB
    if _LIB is None:
        from ..ops.kernels._build import build_host

        _LIB = load_builder(build_host())
    return _LIB


def _cpp_build(oct: OctreeArrays, verts, tri_v, bmin, bmax):
    """Run the C++ builder and append its output to the shared pools."""
    lib = _library()
    verts32 = np.ascontiguousarray(verts, np.float32)
    tri32 = np.ascontiguousarray(tri_v, np.int32)
    h = lib.rpt_octree_build(
        verts32, np.int32(len(verts32)), tri32, np.int32(len(tri32)),
        np.ascontiguousarray(bmin, np.float32), np.ascontiguousarray(bmax, np.float32),
        np.int32(MAX_DEPTH),
    )
    if not h:
        raise MemoryError("rpt_octree_build failed")
    try:
        q = lib.rpt_octree_num_nodes(h)
        p = lib.rpt_octree_pool_size(h)
        node_min = np.empty((q, 3), np.float32)
        node_max = np.empty((q, 3), np.float32)
        tris_index = np.empty(q, np.int32)
        tris_count = np.empty(q, np.int32)
        children = np.empty((q, 8), np.int32)
        neighbors = np.empty((q, 6), np.int32)
        pool = np.empty(p, np.int32)
        lib.rpt_octree_export(h, node_min, node_max, tris_index, tris_count,
                              children, neighbors, pool)
        depth = lib.rpt_octree_max_depth(h)
    finally:
        lib.rpt_octree_free(h)

    # Rebase into the shared flat pools (node + pool indices shift).
    node_base = len(oct.node_min)
    pool_base = len(oct.oct_tris)
    oct.node_min.extend(node_min)
    oct.node_max.extend(node_max)
    oct.node_tris_index.extend((tris_index + pool_base).tolist())
    oct.node_tris_count.extend(tris_count.tolist())
    oct.node_children.extend(np.where(children >= 0, children + node_base, -1).tolist())
    oct.node_neighbors.extend(np.where(neighbors >= 0, neighbors + node_base, -1).tolist())
    oct.oct_tris.extend(pool.tolist())
    oct.max_depth = max(oct.max_depth, int(depth))
    return node_base


def _pool_and_bounds(mesh, first_tri_index: int):
    """(verts (V, 3) float32, tri_v (T, 3), bmin, bmax): the whole pool's
    triangles and the bounds of the vertices referenced from flat-stream
    index `first_tri_index` onward."""
    tri_flat = np.asarray(mesh.triangles, np.int64)
    verts = np.asarray(mesh.vertices, np.float32).reshape(-1, 3)
    tri_v = tri_flat.reshape(-1, 9)[:, 0::3].astype(np.int64)
    vs = verts[tri_flat[first_tri_index::3]]
    return verts, tri_v, vs.min(axis=0), vs.max(axis=0)


def generate_octree(mesh, first_tri_index: int) -> int:
    """Build an octree over the mesh pool starting at flat-stream index
    `first_tri_index` with the C++ builder; returns the new root node index.

    Mirrors Mesh::GenerateOctree (Mesh.cpp:5-28): bounds span
    only the vertices referenced from `first_tri_index` onward, but the root
    triangle list is seeded with the ENTIRE pool.
    """
    return _cpp_build(mesh.octree, *_pool_and_bounds(mesh, first_tri_index))


def generate_octree_plain(mesh, first_tri_index: int) -> int:
    """generate_octree's twin in numpy, equal to it bit for bit: the same
    nodes in the same order, pools, neighbour links and depth."""
    verts, tri_v, bmin, bmax = _pool_and_bounds(mesh, first_tri_index)
    oct = mesh.octree
    root = len(oct.node_min)
    total_tris = len(tri_v)
    oct.node_min.append(bmin.astype(np.float32))
    oct.node_max.append(bmax.astype(np.float32))
    oct.node_tris_index.append(len(oct.oct_tris))
    oct.node_tris_count.append(total_tris)
    oct.node_children.append([-1] * 8)
    oct.node_neighbors.append([-1] * 6)
    oct.oct_tris.extend(range(total_tris))

    _subdivide(oct, verts, tri_v, root, 0, MAX_DEPTH, 0)
    return root
