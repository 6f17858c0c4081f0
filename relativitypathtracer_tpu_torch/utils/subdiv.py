"""Midpoint subdivision and OBJ writing for procedural meshes.

Copy of `subdivide` and `write_obj` from `relativitypathtracer_tpu.utils.subdiv`,
with optional per-vertex UVs in `write_obj` for the textured fixture:
the generated mesh is written as a plain OBJ and loaded through the normal
loader, so smooth normals, the octree and scene construction follow the
reference semantics (Render.cpp:436-538).
"""

from __future__ import annotations


def subdivide(verts, faces, levels: int):
    """Midpoint (1:4) subdivision: each edge gains its midpoint, each
    triangle splits into 4. Shared-edge midpoints are deduplicated so the
    surface stays watertight (smooth normals then interpolate correctly)."""
    for _ in range(levels):
        mid = {}

        def midpoint(a, b):
            key = (a, b) if a < b else (b, a)
            m = mid.get(key)
            if m is None:
                va, vb = verts[a], verts[b]
                verts.append(((va[0] + vb[0]) / 2.0, (va[1] + vb[1]) / 2.0,
                              (va[2] + vb[2]) / 2.0))
                m = len(verts) - 1
                mid[key] = m
            return m

        out = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            out += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        faces = out
    return verts, faces


def write_obj(path: str, verts, faces, uvs=None):
    """Write an OBJ. With `uvs` (one (u, v) per vertex) it also writes `vt`
    lines and `f v/vt` faces that reuse each vertex's index for its uv."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        for uv in uvs or ():
            f.write(f"vt {uv[0]:.9g} {uv[1]:.9g}\n")
        for a, b, c in faces:
            if uvs:
                f.write(f"f {a + 1}/{a + 1} {b + 1}/{b + 1} {c + 1}/{c + 1}\n")
            else:
                f.write(f"f {a + 1} {b + 1} {c + 1}\n")
