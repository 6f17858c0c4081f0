"""Midpoint subdivision and OBJ writing for procedural meshes.

Copy of `relativitypathtracer_tpu.utils.subdiv`, with optional per-vertex
UVs in `write_obj` for the textured fixtures: the generated mesh is written
as a plain OBJ and loaded through the normal loader, so smooth normals, the
octree and scene construction follow the reference semantics
(Render.cpp:436-538). `make_subdivided_scene` grows any OBJ into a large
mesh, which is how the large-mesh tier (K11/K12) meets a real model.
"""

from __future__ import annotations

import os


def _parse_obj_vf(path: str):
    """Vertices and faces (first three vertex indices, 0-based) of an OBJ."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append((float(t[1]), float(t[2]), float(t[3])))
            elif t[0] == "f":
                faces.append(tuple(int(p.split("/")[0]) - 1 for p in t[1:4]))
    return verts, faces


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


def make_subdivided_scene(src_obj: str, levels: int, workdir: str, light: bool = True) -> str:
    """Write (once per workdir) a scene directory holding `src_obj`
    subdivided `levels` times and a bunny.txt-style scene file (the mesh, a
    light sphere, ambient); return the scene file's path."""
    root = os.path.join(workdir, f"subdiv_{os.path.basename(src_obj).split('.')[0]}_{levels}")
    scene_txt = os.path.join(root, "Scenes", "scene.txt")
    obj_path = os.path.join(root, "Models", "big.obj")
    if not os.path.exists(scene_txt):
        os.makedirs(os.path.dirname(obj_path), exist_ok=True)
        os.makedirs(os.path.dirname(scene_txt), exist_ok=True)
        verts, faces = subdivide(*_parse_obj_vf(src_obj), levels)
        write_obj(obj_path, verts, faces)
        light_block = "Os\n l1\n p0,2,4,0,0,0,0,0.1,0.1,0.1\n c1,1,1\n" if light else ""
        with open(scene_txt, "w") as f:
            f.write("MModels/big.obj\nOm0\n p-0.5,-3,5,3.14,0,1,0,20,20,20\n c0.8,0.5,0.3\n"
                    f"{light_block}A0.2\nR\n")
    return scene_txt
