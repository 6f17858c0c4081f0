"""Scene-DSL parser, byte-compatible with the reference's inputScene
(Render.cpp:211-416) so all 8 shipped Scenes/*.txt parse
unchanged. A numpy/torch copy of `relativitypathtracer_tpu.models.dsl`:
model matrices come from the torch `ops.relmath` on CPU tensors.

Commands (applied to the most recently created object where relevant):
  O[s|c|m#]  new sphere / cube / mesh-instance object
  p tx,ty,tz,a,rx,ry,rz,sx,sy,sz   TRS model matrix
  c r,g,b    flat color            t#   texture index (import order)
  l#         light flag            v x,y,z  3-velocity (units of c)
  f p,d      proper-time flash     T<path>  import texture
  M<path>    import OBJ mesh       A#   ambient    W r,g,b  white point
  I          default interval = 0  R    finalize (stop parsing)

Post-parse, texture indices are remapped to (atlas byte offset, w, h) and mesh
indices to octree root node indices (Render.cpp:393-413).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..ops import relmath
from .mesh import HostMesh
from .obj_loader import read_obj
from .scene import CUBE, MESH, SPHERE
from .texture import read_texture


class SceneError(ValueError):
    pass


def _identity4():
    return np.eye(4, dtype=np.float32)


@dataclasses.dataclass
class HostObject:
    obj_type: int
    m: np.ndarray = dataclasses.field(default_factory=_identity4)
    inv_m: np.ndarray = dataclasses.field(default_factory=_identity4)
    velocity: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    color: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    mesh_root: int = -1  # mesh import index while parsing; octree root after post-pass
    tex_offset: int = -1  # texture import index while parsing; byte offset after
    tex_w: int = 0
    tex_h: int = 0
    light: bool = False
    flash_period: float = 0.0
    flash_duration: float = 0.0


@dataclasses.dataclass
class HostScene:
    objects: list = dataclasses.field(default_factory=list)
    mesh: HostMesh = dataclasses.field(default_factory=HostMesh)
    textures: bytearray = dataclasses.field(default_factory=bytearray)
    texture_values: list = dataclasses.field(default_factory=list)  # flat (offset, w, h)
    white_point: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3, np.float32))
    ambient: float = 1.0
    default_interval: int = -1


def _atoi(s: str) -> int:
    """C atoi: parse a leading integer, 0 if none (never raises)."""
    import re

    m = re.match(r"\s*[+-]?\d+", s)
    return int(m.group()) if m else 0


def _atof(s: str) -> float:
    """C atof: parse a leading float, 0.0 if none (never raises)."""
    import re

    m = re.match(r"\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", s)
    return float(m.group()) if m else 0.0


def _floats(s: str, n: int) -> list[float]:
    """Comma-separated float list, strtod-style: missing/unparsable -> 0.0."""
    out = []
    for piece in s.split(",")[:n]:
        try:
            out.append(float(piece))
        except ValueError:
            out.append(0.0)
    out.extend([0.0] * (n - len(out)))
    return out


def resolve_asset(path: str, asset_root: str) -> str:
    """Resolve a scene-relative asset path with tolerant fallbacks.

    The reference runs on a case-insensitive filesystem and its scene corpus
    has two path quirks: shadows.txt says Models/Pear.obj for on-disk pear.obj,
    and bunny.txt references the missing large blob Models/StanfordBunny.obj
    (the same Stanford bunny ships as Models/bunny.obj). We resolve: exact
    match, then case-insensitive match in the same directory, then the known
    StanfordBunny -> bunny substitution.
    """
    cand = os.path.join(asset_root, path)
    if os.path.exists(cand):
        return cand
    d, base = os.path.dirname(cand), os.path.basename(cand)
    if os.path.isdir(d):
        lower = base.lower()
        for entry in sorted(os.listdir(d)):
            if entry.lower() == lower:
                return os.path.join(d, entry)
        if lower == "stanfordbunny.obj":
            alt = os.path.join(d, "bunny.obj")
            if os.path.exists(alt):
                return alt
    return cand  # let the open() fail with the original name


def _apply_trs(obj: HostObject, args: list[float]) -> None:
    m = relmath.trs(
        np.array(args[0:3], np.float32),
        np.float32(args[3]),
        np.array(args[4:7], np.float32),
        np.array(args[7:10], np.float32),
    )
    obj.m = m.numpy()
    obj.inv_m = relmath.inverse4(m).numpy()


def parse_scene(text: str, asset_root: str = ".", strict: bool = True) -> HostScene:
    """Parse DSL text (entire scene file / stdin capture) into a HostScene.

    strict=False reproduces the reference's tolerant behavior: malformed
    commands print to stderr and parsing CONTINUES (the `break` inside the
    reference's switch, Render.cpp:227-259) -- a scene the
    reference renders with warnings must render here too. Asset load
    failures and the two post-pass index checks stay hard errors in both
    modes (the reference exit(EXIT_FAILURE)s there, Render.cpp:340-359,
    396-410). strict=True (default, used by tests) raises on the first
    malformed command instead.
    """
    import sys

    scene = HostScene()
    objects = scene.objects
    done = False

    def bad(msg: str) -> None:
        """Malformed-command handling: raise in strict mode, warn otherwise."""
        if strict:
            raise SceneError(msg)
        print(msg, file=sys.stderr)

    for line in text.splitlines():
        if done:
            break
        for tok in line.split():
            if done:
                break
            cmd = tok[0]
            if cmd == "O":
                if len(tok) < 2:
                    bad("Object command missing argument")
                    continue
                kind = tok[1]
                if kind == "s":
                    objects.append(HostObject(SPHERE))
                elif kind == "c":
                    objects.append(HostObject(CUBE))
                elif kind == "m":
                    if len(tok) < 3:
                        bad("Object mesh command missing argument")
                        continue
                    ob = HostObject(MESH)
                    ob.mesh_root = _atoi(tok[2:])
                    objects.append(ob)
                else:
                    bad(f'Object command unrecognized argument: "{tok[1:]}"')
            elif cmd == "p":
                if not _have_object(objects, "transformation", bad) or not _have_arg(tok, "Transformation", bad):
                    continue
                _apply_trs(objects[-1], _floats(tok[1:], 10))
            elif cmd == "c":
                if not _have_object(objects, "color", bad) or not _have_arg(tok, "Color", bad):
                    continue
                objects[-1].color = np.array(_floats(tok[1:], 3), np.float32)
            elif cmd == "t":
                if not _have_object(objects, "texture", bad) or not _have_arg(tok, "Texture", bad):
                    continue
                objects[-1].tex_offset = _atoi(tok[1:])
            elif cmd == "l":
                if not _have_object(objects, "light", bad) or not _have_arg(tok, "Light", bad):
                    continue
                objects[-1].light = bool(_atoi(tok[1:]))
            elif cmd == "v":
                if not _have_object(objects, "velocity", bad) or not _have_arg(tok, "Velocity", bad):
                    continue
                objects[-1].velocity = np.array(_floats(tok[1:], 3), np.float32)
            elif cmd == "f":
                if not _have_object(objects, "periodic flash", bad) or not _have_arg(tok, "Flash", bad):
                    continue
                args = _floats(tok[1:], 2)
                objects[-1].flash_period = args[0]
                objects[-1].flash_duration = args[1]
            elif cmd == "T":
                if not _have_arg(tok, "Texture", bad):
                    continue
                read_texture(resolve_asset(tok[1:], asset_root), scene.textures, scene.texture_values)
            elif cmd == "M":
                if not _have_arg(tok, "Mesh", bad):
                    continue
                read_obj(resolve_asset(tok[1:], asset_root), scene.mesh)
            elif cmd == "A":
                if not _have_arg(tok, "Ambient", bad):
                    continue
                scene.ambient = _atof(tok[1:])
            elif cmd == "W":
                if not _have_arg(tok, "White-point", bad):
                    continue
                scene.white_point = np.array(_floats(tok[1:], 3), np.float32)
            elif cmd == "I":
                scene.default_interval = 0
            elif cmd == "R":
                done = True
            else:
                bad(f'Unrecognized command: "{tok}"')

    # Post-pass: resolve texture import indices -> (byte offset, w, h) and mesh
    # import indices -> octree root node indices (Render.cpp:393-413).
    tv = scene.texture_values
    for ob in scene.objects:
        if ob.tex_offset != -1:
            idx = ob.tex_offset
            # idx < 0 must be rejected explicitly: Python's negative
            # indexing would otherwise silently bind a wrapped-around
            # texture (t-2 -> the second-to-last import).
            if idx < 0 or 3 * (idx + 1) > len(tv):
                raise SceneError(f"Texture index {idx} out of range")
            ob.tex_offset = tv[3 * idx + 0]
            ob.tex_w = tv[3 * idx + 1]
            ob.tex_h = tv[3 * idx + 2]
        if ob.obj_type == MESH:
            idx = ob.mesh_root
            if idx < 0 or idx >= len(scene.mesh.mesh_indices):
                raise SceneError(f"Mesh index {idx} out of range")
            ob.mesh_root = scene.mesh.mesh_indices[idx]
    return scene


def _have_object(objects, what: str, bad) -> bool:
    if not objects:
        bad(f"Object must be defined before applying a {what}")
        return False
    return True


def _have_arg(tok: str, what: str, bad) -> bool:
    if len(tok) < 2:
        bad(f"{what} command missing argument")
        return False
    return True


def load_scene_file(path: str, asset_root: str | None = None, strict: bool = True) -> HostScene:
    with open(path, "r") as f:
        text = f.read()
    if asset_root is None:
        # Reference scenes use paths relative to the repo root (one level above
        # Scenes/), e.g. "Models/bunny.obj".
        asset_root = os.path.dirname(os.path.dirname(os.path.abspath(path)))
    return parse_scene(text, asset_root, strict=strict)
