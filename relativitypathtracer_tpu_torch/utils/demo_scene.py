"""Procedural fixture for the port's main path: a bumpy mesh and a light.

It stands in for bunny.txt's structure without its texture: one OBJ mesh of
20 * 4**level triangles (level 4 gives 5,120, the same padded size and chunk
count as bunny's 4,968) and one emissive light sphere, with light
propagation and shadows on. The mesh is an icosphere displaced radially so
that its bumps shadow their neighbours, and it moves at 0.5c, so every frame
exercises the boost chain. The files are written in the layout
`load_scene_file` resolves (Scenes/ and Models/ side by side) and go through
the ordinary parse -> build_scene -> build_render_fn entry points.

Usage: python -m relativitypathtracer_tpu_torch.utils.demo_scene DIR [LEVEL]
"""

from __future__ import annotations

import math
import os
import sys

from .subdiv import subdivide, write_obj

_T = (1.0 + math.sqrt(5.0)) / 2.0
_ICO_VERTS = [(-1, _T, 0), (1, _T, 0), (-1, -_T, 0), (1, -_T, 0),
              (0, -1, _T), (0, 1, _T), (0, -1, -_T), (0, 1, -_T),
              (_T, 0, -1), (_T, 0, 1), (-_T, 0, -1), (-_T, 0, 1)]
_ICO_FACES = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
              (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
              (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
              (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]

# The scene: the mesh's rest-frame position sits right of centre so that,
# seen along the past light cone at 0.5c, it appears near the middle of the
# frame; the light sphere sits at rest above and left of where the mesh is
# seen, so the bumps on the lit side shadow some of their neighbours.
# No T (texture) and no I (interval 0) command.
SCENE_TXT = """MModels/blob.obj
Om0
 p1,-0.2,3.2,0,0,1,0,1.25,1.25,1.25
 c0.8,0.55,0.35
 v0.5,0,0
Os
 l1
 p-1.6,1.4,2.4,0,0,0,0,0.2,0.2,0.2
 c1,1,1
A0.2
R
"""


def blob_mesh(level: int):
    """Icosphere subdivided `level` times, displaced radially by smooth bumps.
    Returns (vertices, faces) with outward (counter-clockwise) winding."""
    verts = [tuple(float(c) for c in v) for v in _ICO_VERTS]
    verts, faces = subdivide(verts, list(_ICO_FACES), level)
    out = []
    for x, y, z in verts:
        n = math.sqrt(x * x + y * y + z * z)
        ux, uy, uz = x / n, y / n, z / n
        r = 1.0 + 0.3 * math.sin(4.0 * ux + 1.0) * math.sin(4.0 * uy) * math.cos(3.0 * uz)
        out.append((ux * r, uy * r, uz * r))
    return out, faces


def write_demo_scene(root: str, level: int = 4) -> str:
    """Write Scenes/scene.txt and Models/blob.obj under `root`; return the
    scene file's path."""
    scenes = os.path.join(root, "Scenes")
    models = os.path.join(root, "Models")
    os.makedirs(scenes, exist_ok=True)
    os.makedirs(models, exist_ok=True)
    verts, faces = blob_mesh(level)
    write_obj(os.path.join(models, "blob.obj"), verts, faces)
    path = os.path.join(scenes, "scene.txt")
    with open(path, "w") as f:
        f.write(SCENE_TXT)
    return path


if __name__ == "__main__":
    print(write_demo_scene(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 4))
