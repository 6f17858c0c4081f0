"""Wavefront OBJ loader with the reference's exact indexing semantics.

Re-implements ReadOBJ (Render.cpp:436-538):
- supports `f v`, `f v/vt`, `f v/vt/vn` (first three refs of each face line);
- 1-based indices offset by the running pool sizes for multi-mesh imports;
- faces with no `vn` ref register their vertices for area-weighted smooth
  normal generation (sum of unnormalized face cross products per vertex,
  Render.cpp:508-533), appended to the pool in ascending vertex-index order;
- after parsing, an octree is generated for the new triangles.
"""

from __future__ import annotations

import numpy as np

from .mesh import HostMesh
from .octree import generate_octree


class ObjError(ValueError):
    pass


def read_obj(path: str, mesh: HostMesh) -> None:
    if not str(path).endswith(".obj"):
        raise ObjError(f"Not an .obj file: {path}")

    first_tri_index = len(mesh.triangles)
    first_vert = len(mesh.vertices)
    first_norm = len(mesh.normals)
    first_uv = len(mesh.uvs)
    vert_to_tris: dict[int, list[int]] = {}

    with open(path, "r") as f:
        for lineno, line in enumerate(f, 1):
            parts = line.split()
            if not parts:
                continue
            prefix = parts[0]
            try:
                if prefix == "v":
                    mesh.vertices.append(
                        (float(parts[1]), float(parts[2]), float(parts[3]))
                    )
                elif prefix == "vt":
                    mesh.uvs.append((float(parts[1]), float(parts[2])))
                elif prefix == "vn":
                    n = np.array([float(parts[1]), float(parts[2]), float(parts[3])], np.float32)
                    n = n / np.linalg.norm(n)
                    mesh.normals.append(tuple(n))
                elif prefix == "f":
                    tri_index = len(mesh.triangles) // 9
                    for ref in parts[1:4]:
                        fields = ref.split("/")
                        vert_index = int(fields[0]) - 1 + first_vert
                        uv = fields[1] if len(fields) > 1 and fields[1] else "1"
                        if len(fields) > 2 and fields[2]:
                            norm = fields[2]
                        else:
                            norm = "1"
                            vert_to_tris.setdefault(vert_index, []).append(tri_index)
                        mesh.triangles.append(vert_index)
                        mesh.triangles.append(int(uv) - 1 + first_uv)
                        mesh.triangles.append(int(norm) - 1 + first_norm)
            except (ValueError, IndexError) as e:
                raise ObjError(
                    f'Error reading OBJ file "{path}": invalid syntax on line {lineno}'
                ) from e

    # Area-weighted smooth vertex normals for faces that lacked vn refs.
    # Vectorized; iteration order matches the reference exactly: vertices in
    # ascending index (std::map ordering), each vertex's faces in
    # registration order, and only the FIRST matching corner of a degenerate
    # triangle gets patched (the reference's else-if chain).
    if vert_to_tris:
        verts_np = np.asarray(mesh.vertices, np.float32).reshape(-1, 3)
        tri_flat = np.asarray(mesh.triangles, np.int64)
        tv = tri_flat.reshape(-1, 9)[:, 0::3]  # (T, 3) vertex ids
        A = verts_np[tv[:, 0]]
        face_n = np.cross(verts_np[tv[:, 1]] - A, verts_np[tv[:, 2]] - A)  # (T, 3)

        order = sorted(vert_to_tris)
        base = len(mesh.normals)
        for out_i, vert_index in enumerate(order):
            tris = np.asarray(vert_to_tris[vert_index], np.int64)
            # fp parity: accumulate per-face crosses in registration order
            N = face_n[tris].astype(np.float32).cumsum(axis=0, dtype=np.float32)[-1]
            mesh.normals.append(tuple(N / np.linalg.norm(N)))
            corners = tv[tris]  # (k, 3)
            first = np.argmax(corners == vert_index, axis=1)  # first matching slot
            for t, slot in zip(tris, first):
                mesh.triangles[2 + 9 * int(t) + 3 * int(slot)] = base + out_i

    root = generate_octree(mesh, first_tri_index)
    mesh.mesh_indices.append(root)
    mesh.root_tri_ranges[root] = (0, len(mesh.triangles) // 9)
    # Triangles actually reachable by the stackless walk through this root:
    # the union of the subtree's LEAF lists (the SAT filter drops
    # foreign/out-of-bounds tris during subdivision; an unsubdivided root is
    # its own leaf and keeps its full seed). Mirrors the reference's
    # effective multi-mesh semantics (SURVEY.md section 3.4 quirk).
    oct = mesh.octree
    reachable = []
    for node in range(root, len(oct.node_min)):
        if oct.node_children[node][0] == -1:
            s0 = oct.node_tris_index[node]
            reachable.extend(oct.oct_tris[s0:s0 + oct.node_tris_count[node]])
    mesh.root_tri_lists[root] = np.unique(np.asarray(reachable, np.int64))
