"""Procedural fixtures for the port's paths, written as scene files.

Five scenes, each a directory in the layout `load_scene_file` resolves
(Scenes/, Models/ and Textures/ side by side), so they go through the
ordinary parse -> build_scene -> build_render_fn entry points. All run with
light propagation and shadows on (no I command, so interval -1).

- "blob": bunny.txt's structure without its texture. One OBJ mesh of
  20 * 4**level triangles (level 4 gives 5,120, the same padded size and
  chunk count as bunny's 4,968) and one emissive light sphere. The mesh is an
  icosphere displaced radially so that its bumps shadow their neighbours, and
  it moves at 0.5c, so every frame exercises the boost chain.
- "textured": bunny.txt's structure in full, which is bench.py's main path:
  the same mesh written with spherical `vt` UVs and `f v/vt` faces, bound to
  a 32x32 seeded texture (a P6 PPM). The mesh's footprint atlas is 512 rows,
  within the small-atlas tier (K2).
- "cubes": analytic objects with textures and shadows, as cubes.txt. Eight
  cubes in two rows (one at rest, one moving at 0.6c) share one 256x256
  seeded texture, whose footprint atlas is 32,768 rows (the MID tier, K8); an
  untextured flat floor cube lies under them and a light sphere above, so
  the cubes' shadows on the floor need the analytic occlusion walk (K7).
- "instances": one OBJ instanced four times (`Om0` four times, as the
  reference's DSL allows), so the scene takes the batched walks (K9, K10):
  at level 4 that is 4 x 5,120 = 20,480 triangles in a 640-chunk pool. The
  instances differ in scale (one non-uniformly), so each has its own
  object-to-shared scale s; one is at rest, one moves at 0.5c along x, one
  at 0.7c along y, and a small textured one (the 32x32 texture of
  "textured") hangs between the light and the instance at rest, so that
  shadow rays from one instance find occluders in another's chunks.
- "large": the blob at LARGE_LEVEL (327,680 triangles: T_pad 327,680 and
  10,240 chunks, above LARGE_T, so the large-mesh tier K11/K12 with 320
  superchunks of 32), moving at 0.5c, with the light sphere; `level` is not
  read. The size class of a scanned or subdivided model of 10^5 to 10^6
  triangles, as the JAX package's 317,952-triangle tier.

Textures are written as binary PPM, or with `texture_format` as a baseline
4:2:0 JPEG (utils/image.encode_jpeg, quality 85; lossy, so its texels
differ from the PPM's) or as a PNG (utils/image.write_png; the PPM's
pixels exactly).

`write_bunny_stand_in` writes an OBJ with the face count and the box of the
reference's Models/bunny.obj, for utils/largedemo where the reference's
assets are absent.

Usage: python -m relativitypathtracer_tpu_torch.utils.demo_scene DIR [LEVEL] [KIND]
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

from ..models.texture import write_ppm
from .image import encode_jpeg, write_png
from .subdiv import subdivide, write_obj

_T = (1.0 + math.sqrt(5.0)) / 2.0
_ICO_VERTS = [(-1, _T, 0), (1, _T, 0), (-1, -_T, 0), (1, -_T, 0),
              (0, -1, _T), (0, 1, _T), (0, -1, -_T), (0, 1, -_T),
              (_T, 0, -1), (_T, 0, 1), (-_T, 0, -1), (-_T, 0, 1)]
_ICO_FACES = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
              (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
              (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
              (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]

KINDS = ("blob", "textured", "cubes", "instances", "large")
TEXTURE_FORMATS = ("ppm", "jpg", "png")
BUNNY_FACES = 4968  # Models/bunny.obj's triangles
# Models/bunny.obj's box (the Stanford bunny's coordinates): about 0.16 x
# 0.15 x 0.12, its base at y = 0.033
BUNNY_BOX = ((-0.0947, 0.0330, -0.0619), (0.0611, 0.1873, 0.0588))
SEED = 7  # the textures' numpy seed
LARGE_LEVEL = 7  # the "large" blob's subdivision level

# The blob scenes: the mesh's rest-frame position sits right of centre so
# that, seen along the past light cone at 0.5c, it appears near the middle of
# the frame; the light sphere sits at rest above and left of where the mesh
# is seen, so the bumps on the lit side shadow some of their neighbours.
_BLOB_OBJECT = """Om0
 p1,-0.2,3.2,0,0,1,0,1.25,1.25,1.25
 c0.8,0.55,0.35
 v0.5,0,0
"""
_LIGHT = """Os
 l1
 p{},0,0,0,0,0.2,0.2,0.2
 c1,1,1
A0.2
R
"""
SCENE_TXT = "MModels/blob.obj\n" + _BLOB_OBJECT + _LIGHT.format("-1.6,1.4,2.4")
TEXTURED_TXT = ("TTextures/blob.ppm\nMModels/blob.obj\n" + _BLOB_OBJECT + " t0\n"
                + _LIGHT.format("-1.6,1.4,2.4"))
# Four instances of one mesh: at rest; at 0.5c along x; at 0.7c along y (its
# rest-frame position is high so that, seen along the past light cone, it
# appears in frame); small and textured, between the light and the first.
INSTANCES_TXT = """TTextures/blob.ppm
MModels/blob.obj
Om0
 p-2.6,-0.9,4.0,0,0,1,0,1.0,1.0,1.0
 c0.8,0.55,0.35
Om0
 p4.2,-0.6,4.6,0.6,0,1,0,1.3,1.3,1.3
 c0.35,0.6,0.8
 v0.5,0,0
Om0
 p0.2,7.4,6.2,0.4,1,0,0,1.2,0.9,1.4
 c0.55,0.8,0.4
 v0,0.7,0
Om0
 p-2.3,0.9,3.1,0,0,1,0,0.4,0.4,0.4
 c1,1,1
 t0
""" + _LIGHT.format("-1.6,1.9,2.6")


def _cubes_txt() -> str:
    """Floor cube (object 0, untextured), eight textured cubes (1-8): the
    row at rest in front, the row at 0.6c behind it, placed right of centre
    so that it appears in frame along the past light cone; light sphere 9."""
    lines = ["TTextures/cubes.ppm", "Oc", " p0,-1.3,7,0,0,1,0,7,0.1,6", " c0.55,0.6,0.5"]
    for k in range(4):
        lines += ["Oc", f" p{-2.1 + 1.4 * k:.2f},-0.75,5,{0.3 * k:.2f},0,1,0,0.45,0.45,0.45",
                  " c1,1,1", " t0"]
    for k in range(4):
        lines += ["Oc", f" p{2.2 + 1.5 * k:.2f},0.3,8,{0.5 + 0.3 * k:.2f},1,1,0,0.5,0.5,0.5",
                  " c1,1,1", " t0", " v0.6,0,0"]
    return "\n".join(lines) + "\n" + _LIGHT.format("-2.5,2.2,3")


def blob_mesh(level: int):
    """Icosphere subdivided `level` times, displaced radially by smooth bumps.
    Returns (vertices, faces, uvs): outward (counter-clockwise) winding, and
    each vertex's spherical (u, v) from its undisplaced direction."""
    verts = [tuple(float(c) for c in v) for v in _ICO_VERTS]
    verts, faces = subdivide(verts, list(_ICO_FACES), level)
    out, uvs = [], []
    for x, y, z in verts:
        n = math.sqrt(x * x + y * y + z * z)
        ux, uy, uz = x / n, y / n, z / n
        r = 1.0 + 0.3 * math.sin(4.0 * ux + 1.0) * math.sin(4.0 * uy) * math.cos(3.0 * uz)
        out.append((ux * r, uy * r, uz * r))
        uvs.append((0.5 + math.atan2(uz, ux) / (2.0 * math.pi), 0.5 + math.asin(uy) / math.pi))
    return out, faces, uvs


def demo_texture(size: int, seed: int = SEED) -> np.ndarray:
    """(size, size, 3) uint8: a checker of 4x4-texel squares in seeded colours
    with seeded per-texel noise, so that every bilinear tap differs."""
    rng = np.random.default_rng(seed + size)
    palette = rng.integers(40, 216, (8, 3))
    ij = np.arange(size) // 4
    square = (ij[:, None] * 3 + ij[None, :] * 5) % 8
    noise = rng.integers(-40, 40, (size, size, 3))
    return np.clip(palette[square] + noise, 0, 255).astype(np.uint8)


def write_bunny_stand_in(path: str) -> str:
    """Write a stand-in for the reference's Models/bunny.obj to `path`: the
    level-4 blob without its last 152 faces (4,968, bunny's count, so a
    scene subdivided from it has the JAX package's large-tier shapes), its
    vertices scaled into bunny's box, where the subdivided scene's transform
    (utils/subdiv.make_subdivided_scene) frames it as it frames the bunny.
    Name it other than bunny.obj (e.g. bunny_stand_in.obj): the subdivided
    scene and its pickle are keyed by the source's file name. Returns
    `path`."""
    verts, faces, _ = blob_mesh(4)
    faces = faces[:BUNNY_FACES]
    used = sorted({i for face in faces for i in face})
    index = {v: n for n, v in enumerate(used)}
    v = np.asarray([verts[i] for i in used])
    lo, hi = v.min(axis=0), v.max(axis=0)
    box_lo, box_hi = np.asarray(BUNNY_BOX)
    v = box_lo + (v - lo) / (hi - lo) * (box_hi - box_lo)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_obj(path, v.tolist(), [tuple(index[i] for i in face) for face in faces])
    return path


def _write_texture(path_stem: str, rgb: np.ndarray, texture_format: str) -> None:
    """Write (h, w, 3) uint8 `rgb`, top row first, as PATH_STEM.FORMAT."""
    path = f"{path_stem}.{texture_format}"
    if texture_format == "ppm":
        write_ppm(path, rgb)
    elif texture_format == "jpg":
        with open(path, "wb") as f:
            f.write(encode_jpeg(rgb))
    else:
        write_png(path, rgb[::-1])  # write_png takes bottom-up rows


def write_demo_scene(root: str, level: int = 4, kind: str = "blob",
                     texture_format: str = "ppm") -> str:
    """Write scene `kind` (one of KINDS) under `root`; return the scene file's
    path. `level` is the blob mesh's subdivision level (unused by cubes and
    large); `texture_format` (one of TEXTURE_FORMATS) the texture files'."""
    if kind not in KINDS:
        raise ValueError(f"unknown demo scene {kind!r}; expected one of {KINDS}")
    if texture_format not in TEXTURE_FORMATS:
        raise ValueError(f"unknown texture format {texture_format!r}; expected one of "
                         f"{TEXTURE_FORMATS}")
    dirs = {d: os.path.join(root, d) for d in ("Scenes", "Models", "Textures")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    if kind == "cubes":
        _write_texture(os.path.join(dirs["Textures"], "cubes"), demo_texture(256), texture_format)
        text = _cubes_txt()
    else:
        verts, faces, uvs = blob_mesh(LARGE_LEVEL if kind == "large" else level)
        textured = kind in ("textured", "instances")
        write_obj(os.path.join(dirs["Models"], "blob.obj"), verts, faces,
                  uvs if textured else None)
        if textured:
            _write_texture(os.path.join(dirs["Textures"], "blob"), demo_texture(32),
                           texture_format)
        text = {"textured": TEXTURED_TXT, "instances": INSTANCES_TXT}.get(kind, SCENE_TXT)
    text = text.replace(".ppm\n", f".{texture_format}\n")
    path = os.path.join(dirs["Scenes"], "scene.txt")
    with open(path, "w") as f:
        f.write(text)
    return path


if __name__ == "__main__":
    print(write_demo_scene(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 4,
                           sys.argv[3] if len(sys.argv) > 3 else "blob"))
