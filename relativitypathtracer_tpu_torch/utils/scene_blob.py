"""The binary scene blob that the C++ oracle (native/cpu_reference.cpp) renders.

Torch counterpart of `relativitypathtracer_tpu.utils.scene_blob`, byte for
byte: a flat snapshot of the Scene plus one frame's boost matrices. Python
owns all scene construction (parsing, OBJ, octree, textures); the oracle owns
only the per-pixel algorithm, as the reference feeds host-built buffers to
its kernel (main.cpp:33-55). The layout (little-endian) is read by
`readBlob` in native/cpu_reference.cpp; a change bumps MAGIC_VERSION on both
sides.

Every field of the torch Scene is read through `.cpu().numpy()`, wherever the
scene lives, and the frame's matrices are computed on the host in float32
numpy (`_object_frames_np`): products on the card could run in TF32 and would
feed the oracle degraded boosts.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"RPTB"
MAGIC_VERSION = 3


def _np(x, dtype) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array of `dtype`."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _lorentz_np(v: np.ndarray) -> np.ndarray:
    """Host float32 boost matrices: the numpy form of ops.relmath.lorentz."""
    v = np.asarray(v, np.float32)
    vsqr = np.sum(v * v, axis=-1)
    gamma = (1.0 / np.sqrt(1.0 - vsqr)).astype(np.float32)
    safe_vsqr = np.where(vsqr == 0.0, np.float32(1.0), vsqr)
    g1 = ((gamma - 1.0) / safe_vsqr).astype(np.float32)
    vg = (-v * gamma[..., None]).astype(np.float32)
    top = np.concatenate([gamma[..., None], vg], axis=-1)
    outer = v[..., :, None] * v[..., None, :]
    spatial = (np.eye(3, dtype=np.float32) + g1[..., None, None] * outer).astype(np.float32)
    rows = np.concatenate([vg[..., :, None], spatial], axis=-1)
    M = np.concatenate([top[..., None, :], rows], axis=-2)
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), M.shape)
    return np.where(vsqr[..., None, None] == 0.0, eye, M).astype(np.float32)


def _object_frames_np(objects, state):
    """Host float32 form of render.object_frames: (L, inv_L, stat_cam)."""
    vel = _np(objects.velocity, np.float32)
    cam_v = _np(state.cam_velocity, np.float32)
    cam_pos = _np(state.cam_pos, np.float32)
    cam_l = _lorentz_np(cam_v)
    cam_inv_l = _lorentz_np(-cam_v)
    obj_l = _lorentz_np(vel)
    obj_inv_l = _lorentz_np(-vel)
    L = obj_l @ cam_inv_l[None]
    inv_L = cam_l[None] @ obj_inv_l
    stat_cam = np.einsum("oij,j->oi", L, cam_pos).astype(np.float32)
    return L.astype(np.float32), inv_L.astype(np.float32), stat_cam


def scene_blob(scene, meta, state, width: int, height: int,
               interval: int | None = None) -> bytes:
    """Serialize the scene and the frame matrices of `state` for one frame."""
    if interval is None:
        interval = meta.default_interval
    L, inv_L, stat_cam = _object_frames_np(scene.objects, state)
    o = scene.objects

    out = bytearray()
    out += MAGIC
    out += struct.pack("<IIIi", MAGIC_VERSION, width, height, int(interval))
    out += _np(scene.white_point, np.float32).tobytes()
    out += struct.pack("<f", float(_np(scene.ambient, np.float32)))

    n = meta.num_objects
    out += struct.pack("<I", n)
    m = _np(o.m, np.float32)
    inv_m = _np(o.inv_m, np.float32)
    color = _np(o.color, np.float32)
    ints = [_np(f, np.int64) for f in (o.obj_type, o.mesh_root, o.tex_offset, o.tex_w,
                                       o.tex_h, o.light)]
    flash = [_np(f, np.float32) for f in (o.flash_period, o.flash_duration)]
    for i in range(n):
        out += m[i].tobytes()
        out += inv_m[i].tobytes()
        out += L[i].tobytes()
        out += inv_L[i].tobytes()
        out += stat_cam[i].tobytes()
        out += color[i].tobytes()
        out += struct.pack("<iiiiiiff", *(int(f[i]) for f in ints),
                           *(float(f[i]) for f in flash))

    msh = scene.mesh
    verts = _np(msh.vertices, np.float32)
    out += struct.pack("<I", verts.shape[0]) + verts.tobytes()
    tri = np.stack([_np(msh.tri_v, np.int32), _np(msh.tri_uv, np.int32),
                    _np(msh.tri_n, np.int32)], axis=-1).reshape(-1, 9)
    # interleaved [v, uv, n] x 3, as the reference's triangle stream
    out += struct.pack("<I", tri.shape[0]) + tri.astype(np.int32).tobytes()
    uvs = _np(msh.uvs, np.float32)
    out += struct.pack("<I", uvs.shape[0]) + uvs.tobytes()
    normals = _np(msh.normals, np.float32)
    out += struct.pack("<I", normals.shape[0]) + normals.tobytes()

    node_min = _np(msh.node_min, np.float32)
    node_max = _np(msh.node_max, np.float32)
    tidx = _np(msh.node_tris_index, np.int32)
    tcnt = _np(msh.node_tris_count, np.int32)
    ch = _np(msh.node_children, np.int32)
    nb = _np(msh.node_neighbors, np.int32)
    out += struct.pack("<I", node_min.shape[0])
    for i in range(node_min.shape[0]):
        out += node_min[i].tobytes() + node_max[i].tobytes()
        out += struct.pack("<ii", int(tidx[i]), int(tcnt[i]))
        out += ch[i].tobytes() + nb[i].tobytes()

    oct_tris = _np(msh.oct_tris, np.int32)
    out += struct.pack("<I", oct_tris.shape[0]) + oct_tris.tobytes()

    tex = _np(scene.textures, np.uint8)
    out += struct.pack("<Q", tex.shape[0]) + tex.tobytes()
    return bytes(out)


def write_scene_blob(path: str, scene, meta, state, width, height, interval=None):
    with open(path, "wb") as f:
        f.write(scene_blob(scene, meta, state, width, height, interval))
