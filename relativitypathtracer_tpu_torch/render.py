"""The wavefront renderer: one call renders one frame.

Torch counterpart of `relativitypathtracer_tpu.render`: per-object boost
algebra each frame (`object_frames`), camera rays in 32x32-tile order so
every 1024-ray block is a compact screen tile, the analytic nearest hit (K3),
the mesh primary walk, the texel fetch (K2/K8 through the footprint atlas,
or the packed-atlas gather) or flat colour, proper-time flash, ambient and
emissive terms, and per light the shadow chain (K1), the analytic occlusion
walk (K7) and the mesh shadow walk; then the MSAA sample average, Hable
tonemap, unswizzle and crop. Semantics mirror
trace()/intersect_scene()/sample_light() (opencl_kernel.cl:361-604). Rays
sit on the last axis: (3, N), (4, N).

The mesh walks, under the JAX package's conditions (render.py:230, :289):
several mesh objects with a fused pool (Scene.mesh_batch) take one batched
walk over all of them, K9 primary and K10 shadow; otherwise each mesh object
walks on its own, K5/K6, or K11/K12 for a mesh in the large tier (whose
scene builds no pool).
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch

from .device import DEFAULT_DEVICE, resolve
from .models.scene import Scene, SceneMeta
from .ops.camera import camera_ray_dirs
from .ops.intersect import INF, normalize3
from .ops.kernels.analytic_kernels import (
    analytic_min_t_general, analytic_nearest_shared, pack_analytic_params,
    pack_analytic_params_general)
from .ops.kernels.shadow_chain import pack_chain_mats, pack_light_row, shadow_chain
from .ops.kernels.texture_kernel import footprint_fetch
from .ops.mesh_intersect import (
    mesh_intersect_shared, mesh_intersect_shared_batched, mesh_min_t_general,
    mesh_min_t_general_batched)
from .ops.relmath import lorentz, matmul4, transform4
from .ops.texture_sample import bilinear_sample_packed
from .ops.tonemap import tonemap
from .utils.frame_graph import FrameGraph

MISS_COLOR = (0.15, 0.15, 0.25)
TILE = 32  # pixel tile edge: one tile is one 1024-ray kernel block


class FrameState(NamedTuple):
    """Per-frame camera state (Render.cpp:10-11): cam_velocity (3,) in units
    of c and cam_pos (4,) = (t, x, y, z); scene time is cam_pos[0]."""

    cam_velocity: torch.Tensor
    cam_pos: torch.Tensor

    @staticmethod
    def initial(device=DEFAULT_DEVICE):
        return FrameState(torch.zeros(3, device=device), torch.zeros(4, device=device))


def object_frames(objects, state: FrameState):
    """(L, inv_L, stat_cam) per object (Render.cpp:179-200):
    L = L(v_obj) @ L(-v_cam) maps the camera frame to the rest frame,
    inv_L = L(v_cam) @ L(-v_obj) maps back, stat_cam = L @ cam_pos."""
    L = matmul4(lorentz(objects.velocity), lorentz(-state.cam_velocity)[None])
    inv_L = matmul4(lorentz(state.cam_velocity)[None], lorentz(-objects.velocity))
    return L, inv_L, transform4(L, state.cam_pos[None, :])


def _merge_best(best, cand):
    take = cand[0] < best[0]
    return (torch.where(take, cand[0], best[0]),
            torch.where(take[None, :], cand[1], best[1]),
            torch.where(take[None, :], cand[2], best[2]),
            torch.where(take, cand[3], best[3]))


def mesh_perm_tensors(meta: SceneMeta, device):
    """Each mesh object's Morton triangle order as a device tensor, made once
    per renderer (the JAX package folds them into its compiled frame)."""
    return tuple(torch.as_tensor(p, dtype=torch.long, device=device) for p in meta.mesh_perms)


def intersect_scene(scene: Scene, meta: SceneMeta, L, stat_cam, dir4, perms):
    """Nearest hit over all objects for rays from the camera origin.
    dir4: (4, N) = (interval, unit camera dir); perms from mesh_perm_tensors.
    Returns (t, normal (3, N) in the hit object's rest frame, uv (2, N),
    obj (N,) int32, did_hit)."""
    objects = scene.objects
    n = dir4.shape[1]
    dev = dir4.device
    best = (torch.full((n,), INF, device=dev), torch.zeros((3, n), device=dev),
            torch.zeros((2, n), device=dev), torch.zeros((n,), dtype=torch.int32, device=dev))
    ids = tuple(meta.sphere_ids) + tuple(meta.cube_ids)
    if ids:
        params = pack_analytic_params(L, objects.inv_m, stat_cam, ids)
        best = _merge_best(best, analytic_nearest_shared(
            params, dir4, len(meta.sphere_ids), len(meta.cube_ids)))
    if len(meta.mesh_ids) > 1 and scene.mesh_batch is not None:
        best = _merge_best(best, mesh_intersect_shared_batched(
            scene.mesh, meta, scene.mesh_batch, L, objects.inv_m, objects.m, stat_cam, dir4,
            perms)[:4])
        t, normal, uv, obj = best
        return t, normal, uv, obj, t < INF
    for k, i in enumerate(meta.mesh_ids):
        d4 = L[i] @ dir4
        t, nrm, uv, _ = mesh_intersect_shared(
            scene.mesh, objects.m[i], objects.inv_m[i], stat_cam[i, 1:4], d4[1:4], perms[k],
            scene.mesh_static[k])
        best = _merge_best(best, (t, nrm, uv, torch.full((n,), i, dtype=torch.int32, device=dev)))
    t, normal, uv, obj = best
    return t, normal, uv, obj, t < INF


def scene_min_t(scene: Scene, meta: SceneMeta, L, origins4, dir3, interval: int,
                exclude_id: int, tmax, perms):
    """Min hit parameter over all objects but `exclude_id` for shadow rays
    with per-lane origins (sample_light, opencl_kernel.cl:488-545), searched
    up to tmax (N,); lanes with tmax 0 are masked."""
    n = origins4.shape[1]
    dir4 = torch.cat([torch.full((1, n), float(interval), device=dir3.device),
                      normalize3(dir3)], dim=0)
    best = torch.full((n,), INF, device=dir3.device)
    sph = tuple(i for i in meta.sphere_ids if i != exclude_id)
    cub = tuple(i for i in meta.cube_ids if i != exclude_id)
    if sph or cub:  # the light is left out by omitting its params row
        params = pack_analytic_params_general(L, scene.objects.inv_m, sph + cub)
        best = analytic_min_t_general(params, origins4, dir4, len(sph), len(cub), tmax)
    if len(meta.mesh_ids) > 1 and scene.mesh_batch is not None:
        return torch.minimum(best, mesh_min_t_general_batched(
            meta, scene.mesh_batch, L, scene.objects.inv_m, scene.objects.m, origins4, dir4,
            exclude_id, tmax))
    for k, i in enumerate(meta.mesh_ids):
        if i == exclude_id:
            continue
        o4 = L[i] @ origins4
        d4 = L[i] @ dir4
        best = torch.minimum(best, mesh_min_t_general(
            scene.mesh, scene.objects.m[i], scene.objects.inv_m[i], o4[1:4], d4[1:4], perms[k],
            scene.mesh_static[k], tmax))
    return best


def shade(scene: Scene, meta: SceneMeta, L, inv_L, stat_cam, dirs, interval: int, perms,
          miss):
    """Full trace of unit camera dirs (3, N): nearest hit, texel or flat
    colour and proper-time flash, ambient and emissive terms, and per light
    the direct term behind a 4D shadow ray; `miss` (3, 1) is the colour of a
    lane that hits nothing. Returns (color (3, N), aux) with
    aux counts hits, shadow_rays (lanes a light's shadow ray was traced for)
    and lit_rays (those the light reached)."""
    objects = scene.objects
    n = dirs.shape[1]
    dev = dirs.device
    dir4 = torch.cat([torch.full((1, n), float(interval), device=dev), dirs], dim=0)
    t, normal, uv, obj, did_hit = intersect_scene(scene, meta, L, stat_cam, dir4, perms)
    obj_l = obj.long()

    # Per-object attributes by integer gathers (the JAX package's f32
    # one-hot select rounds tex_offset past 2^24; ROADMAP Queue 3). The
    # footprint fetch (K2/K8) selects the texel or the flat colour itself.
    if meta.textured_ids and meta.use_footprint_tex:
        hit_color = footprint_fetch(scene.tex_quads, scene.tex_table, obj, uv, objects.color,
                                    scene.tex_textured)
    elif meta.textured_ids:
        tex_off = objects.tex_offset[obj_l]
        tex_rgb = bilinear_sample_packed(
            scene.textures_packed, torch.clamp(tex_off, min=0) // 3,
            torch.clamp(objects.tex_w[obj_l], min=1),
            torch.clamp(objects.tex_h[obj_l], min=1), uv)
        hit_color = torch.where((tex_off != -1)[None, :], tex_rgb, objects.color.T[:, obj_l])
    else:
        # An untextured scene makes no fetch (the JAX package fetches a texel
        # for every lane and then keeps the flat colour on every lane).
        hit_color = objects.color.T[:, obj_l]
    if meta.any_flash:
        period = objects.flash_period[obj_l]
        duration = objects.flash_duration[obj_l]
        event_t = stat_cam[obj_l, 0] + (L[obj_l, 0, :].T * dir4).sum(dim=0) * t
        safe_period = torch.where(period > 0, period, 1.0)
        flashing = (period > 0) & (
            event_t - safe_period * torch.floor(event_t / safe_period) < duration)
        hit_color = torch.where(flashing[None, :], hit_color * 2.0, hit_color)

    ambient = scene.ambient if interval != 0 else torch.ones((), device=dev)
    color = hit_color * ambient
    color = color + torch.where(objects.light[obj_l][None, :], hit_color, 0.0)

    shadow_rays = torch.zeros((), dtype=torch.int64, device=dev)
    lit_rays = torch.zeros((), dtype=torch.int64, device=dev)
    if interval != 0 and meta.light_ids:
        mats = pack_chain_mats(L, inv_L, stat_cam)
        for i in meta.light_ids:
            light_row = pack_light_row(L[i], inv_L[i], objects.m[i][:3, 3])
            hit_pos, ld3, ndotl, tmax, llen = shadow_chain(
                mats, light_row, dir4, t, normal, obj, interval)
            relevant = did_hit & (obj != i) & (ndotl > 0)
            occ_t = scene_min_t(scene, meta, L, hit_pos, ld3, interval, i,
                                torch.where(relevant, tmax, 0.0), perms)
            falloff = 1.0 / (1.0 + 0.1 * llen + 0.01 * (llen * llen))
            contrib = (ndotl * falloff)[None, :] * hit_color * objects.color[i][:, None]
            mask = relevant & objects.light[i] & (occ_t >= tmax)
            color = color + torch.where(mask[None, :], contrib, 0.0)
            shadow_rays = shadow_rays + relevant.sum()
            lit_rays = lit_rays + mask.sum()

    color = torch.where(did_hit[None, :], color, miss)
    return color, {"hits": did_hit.sum(), "shadow_rays": shadow_rays, "lit_rays": lit_rays}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tile_swizzle(img_vec, ph: int, pw: int):
    """(k, ph*pw) row-major pixels -> 32x32 tiles, quadrant-major within each
    tile (four 16x16 quadrants of 256 lanes), as the JAX package orders them."""
    k = img_vec.shape[0]
    h = TILE // 2
    x = img_vec.reshape(k, ph // TILE, 2, h, pw // TILE, 2, h)
    return x.permute(0, 1, 4, 2, 5, 3, 6).reshape(k, ph * pw)


def tile_unswizzle(img_vec, ph: int, pw: int, p: int = TILE):
    """Inverse of tile_swizzle for p = TILE; the sharded renderer's folded
    msaa (parallel/tiles) passes its patch edge p = TILE // m, its samples
    already averaged away."""
    k = img_vec.shape[0]
    h = p // 2
    x = img_vec.reshape(k, ph // p, pw // p, 2, 2, h, h)
    return x.permute(0, 1, 3, 5, 2, 4, 6).reshape(k, ph * pw)


def msaa_swizzle(dirs_samples, ph: int, pw: int, m: int):
    """Fold the m*m sample sets into the ray axis, patch-major, as the JAX
    package's msaa_swizzle (JAX render.py:561-584): each 1024-lane block
    covers a (TILE // m)^2-pixel patch with all its samples (the sample index
    minor), in four quadrants of 256 lanes. Only the sharded renderer uses
    it (folding keeps every shard a whole number of blocks); the
    single-device renderer takes one pass per sample set.
    dirs_samples: (m*m, ph, pw, 3). Returns (3, ph*pw*m*m)."""
    p = TILE // m  # pixel patch edge
    h = p // 2
    x = dirs_samples.permute(3, 1, 2, 0)  # (3, ph, pw, S)
    x = x.reshape(3, ph // p, 2, h, pw // p, 2, h, m * m)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)  # (3, pr, pc, qr, qc, r, c, S)
    return x.reshape(3, ph * pw * m * m)


def msaa_mean_unswizzle(vec, ph: int, pw: int, m: int):
    """Average the folded samples and restore row-major pixel order (JAX
    render.py:587-595). vec: (k, ph*pw*m*m) in msaa_swizzle order.
    Returns (k, ph*pw)."""
    k = vec.shape[0]
    p = TILE // m
    h = p // 2
    x = vec.reshape(k, ph // p, pw // p, 2, 2, h, h, m * m).mean(dim=7)
    return x.permute(0, 1, 3, 5, 2, 4, 6).reshape(k, ph * pw)


@contextlib.contextmanager
def full_precision():
    """Full fp32 products inside the block: TF32 off for matmuls and cuDNN,
    and the caller's two flags restored after it, also when it raises (the
    JAX package scopes its `default_matmul_precision("highest")` to the
    frame the same way). PERF.md "What lost" records that reduced-precision
    matrix products (bf16 passes on the TPU, TF32 here) broke parity with
    the fp32 reference."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def to_uint8(img):
    """Pack a [0, 1] float image to uint8 on its device, truncating as the
    JAX package's `astype(jnp.uint8)` does (multiplying by 255 is exact)."""
    return (img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def render_constants(meta: SceneMeta, width: int, height: int, msaa: int, device):
    """The constants of build_render_fn's frame, made once per renderer:
    dirs (msaa**2, 3, ph*pw), each sample set's camera dirs in tile order;
    the meshes' Morton orders (mesh_perm_tensors); the miss colour (3, 1)."""
    ph = _round_up(height, TILE)
    pw = _round_up(width, TILE)
    samples = camera_ray_dirs(width, height, msaa, pw, ph, device=device).reshape(
        msaa * msaa, -1, 3)
    dirs = torch.stack([tile_swizzle(d.T, ph, pw) for d in samples])
    return dirs, mesh_perm_tensors(meta, device), torch.tensor(MISS_COLOR, device=device)[:, None]


def trace_frame(scene: Scene, meta: SceneMeta, state: FrameState, dirs, perms, miss,
                interval: int, width: int, height: int, with_aux: bool = False,
                out_uint8: bool = False):
    """One frame of build_render_fn's renderer from its constants
    (render_constants): one shade pass per sample set of dirs, colours
    averaged, tonemap, unswizzle and crop. The caller holds
    `full_precision()`."""
    ph = _round_up(height, TILE)
    pw = _round_up(width, TILE)
    L, inv_L, stat_cam = object_frames(scene.objects, state)
    color, aux = shade(scene, meta, L, inv_L, stat_cam, dirs[0], interval, perms, miss)
    for k in range(1, dirs.shape[0]):
        c, a = shade(scene, meta, L, inv_L, stat_cam, dirs[k], interval, perms, miss)
        color = color + c
        aux = {key: aux[key] + a[key] for key in aux}
    if dirs.shape[0] > 1:
        color = color / float(dirs.shape[0])
    img = tonemap(tile_unswizzle(color, ph, pw).T, scene.white_point)
    img = img.reshape(ph, pw, 3)[:height, :width]
    if out_uint8:
        img = to_uint8(img)
    return (img, aux) if with_aux else img


def build_render_fn(meta: SceneMeta, width: int, height: int, interval: int,
                    msaa: int = 1, with_aux: bool = False, out_uint8: bool = False,
                    device=DEFAULT_DEVICE):
    """A frame renderer for (scene meta, resolution, interval, msaa) on
    `device`: render(scene, state) -> (H, W, 3) float image in bottom-up row
    order, and the aux counts when with_aux (summed over the msaa**2 sample
    sets). The pixel grid is padded to 32x32 tiles and traced in tile order;
    the padding is cropped after shading. With msaa > 1, one shade pass per
    sample set, colours averaged: the JAX package's default per-sample loop
    (opencl_kernel.cl:642-648). out_uint8 packs the frame to uint8 on the
    device (`to_uint8`). Each frame runs under `full_precision()`; building
    the renderer changes no process-wide setting.

    On a CUDA device the frame is one CUDA graph (utils/frame_graph), captured
    at the first call for each input layout and replayed after; on the CPU it
    runs eagerly. `render_constants` and `trace_frame` give the same frame
    eagerly. Renderers are cached per arguments (64 of them), as the JAX
    package caches its jitted ones (JAX render.py:596)."""
    if msaa < 1:
        raise ValueError(f"msaa must be >= 1, got {msaa}")
    return _cached_render_fn(meta, int(width), int(height), int(interval), int(msaa),
                             bool(with_aux), bool(out_uint8), resolve(device))


@functools.lru_cache(maxsize=64)
def _cached_render_fn(meta: SceneMeta, width: int, height: int, interval: int, msaa: int,
                      with_aux: bool, out_uint8: bool, device: torch.device):
    dirs, perms, miss = render_constants(meta, width, height, msaa, device)

    def render(scene: Scene, state: FrameState):
        with full_precision():
            return trace_frame(scene, meta, state, dirs, perms, miss, interval, width, height,
                               with_aux, out_uint8)

    return FrameGraph(render, device)


def box_pool(img, pool: int):
    """(H, W, 3) -> (H/pool, W/pool, 3) mean of each pool x pool box, as an
    explicit sum in row-major order times 1/pool**2 (a power of two, so
    exact): the same bits on any device, where a reduction's order is not
    fixed."""
    h, w = img.shape[0] // pool, img.shape[1] // pool
    x = img.reshape(h, pool, w, pool, 3)
    acc = x[:, 0, :, 0]
    for dy in range(pool):
        for dx in range(pool):
            if dy or dx:
                acc = acc + x[:, dy, :, dx]
    return acc * (1.0 / (pool * pool))


def build_viewer_render_fn(meta: SceneMeta, pad_height: int, pad_width: int, interval: int,
                           pool: int = 1, device=DEFAULT_DEVICE):
    """The live viewer's renderer (msaa 1) over a fixed padded grid: the
    camera dirs are an argument (`viewer_dirs`), so any logical size whose
    32-aligned pad fits (pad_height, pad_width) renders through it, and a
    resize recomputes only the dirs (the JAX package's resolution-polymorphic
    renderer, JAX render.py:696-739). pool > 1 box-filters the tonemapped
    frame by pool x pool (`box_pool`) before the uint8 pack.

    Returns render(scene, state, dirs_t) -> (pad_h/pool, pad_w/pool, 3)
    uint8, bottom-up, on `device`; the caller crops to the logical size.
    Each frame runs under `full_precision()`. On a CUDA device the frame is
    one CUDA graph (utils/frame_graph) with dirs_t among its inputs: new dirs
    of the same pad replay the same graph."""
    ph, pw = int(pad_height), int(pad_width)
    if ph % TILE or pw % TILE:
        raise ValueError(f"pad {pw}x{ph} not {TILE}-aligned")
    if pool not in (1, 2, 4):
        raise ValueError(f"pool must be 1/2/4, got {pool}")
    device = resolve(device)
    perms = mesh_perm_tensors(meta, device)
    miss = torch.tensor(MISS_COLOR, device=device)[:, None]

    def render(scene: Scene, state: FrameState, dirs_t):
        with full_precision():
            L, inv_L, stat_cam = object_frames(scene.objects, state)
            color, _ = shade(scene, meta, L, inv_L, stat_cam, dirs_t, interval, perms, miss)
            img = tonemap(tile_unswizzle(color, ph, pw).T, scene.white_point).reshape(ph, pw, 3)
            if pool > 1:
                img = box_pool(img, pool)
            return to_uint8(img)

    return FrameGraph(render, device)


def viewer_dirs(width: int, height: int, pad_height: int, pad_width: int,
                device=DEFAULT_DEVICE):
    """Swizzled (3, pad_h * pad_w) camera dirs for `build_viewer_render_fn`:
    the projection uses the logical size, the grid is the pad."""
    dirs = camera_ray_dirs(width, height, 1, pad_width, pad_height, device=device)
    return tile_swizzle(dirs.reshape(-1, 3).T, pad_height, pad_width).contiguous()


def render_frame(scene: Scene, meta: SceneMeta, state: FrameState, width: int, height: int,
                 interval: int | None = None, msaa: int = 1, device=DEFAULT_DEVICE):
    """Convenience single-frame entry point, through the cached renderer of
    `build_render_fn`."""
    if interval is None:
        interval = meta.default_interval
    return build_render_fn(meta, width, height, int(interval), msaa, device=device)(scene, state)
