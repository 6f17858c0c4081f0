"""Sharded rendering: the frame's 1024-ray blocks dealt over CUDA devices.

Torch counterpart of `relativitypathtracer_tpu.parallel.tiles`. The frame is
padded so that every shard gets an equal number of kernel blocks (32x32
screen tiles, or with msaa m > 1 (32/m)^2-pixel patches with all their
samples folded into the block, `render.msaa_swizzle`); each shard traces its
blocks on its device with the scene copied there, and the blocks are gathered
onto the first device, de-interleaved and cropped. Rays never cross blocks,
so a ray's result does not depend on the shard that traces it: at msaa 1 the
sharded frame equals `build_render_fn`'s bit for bit. The only sum across
shards is that of the aux counters (the JAX package's psum).

Blocks are dealt "strided" by default: shard b takes the blocks of the
diagonal class (patch_r + patch_c) % n == b, so every shard samples the whole
image (scene geometry concentrates in the frame's centre, where contiguous
bands would leave edge shards idle). `per_block_mesh_work` and
`partition_work` measure the deal's load skew.

The JAX package runs the shards under shard_map, one program over a device
mesh. Here one host thread issues the shards one after another, each on its
device's current stream (single-controller, as shard_map; no
torch.distributed). `devices` may name one device several times: logical
shards on one card, which trace the same blocks as shards on separate cards.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..device import DEFAULT_DEVICE
from ..models.dsl import load_scene_file
from ..models.scene import Scene, SceneMeta, build_scene
from ..ops.camera import camera_ray_dirs
from ..ops.tonemap import tonemap
from ..render import (
    MISS_COLOR, TILE, FrameState, _round_up, build_render_fn, full_precision, intersect_scene,
    mesh_perm_tensors, msaa_swizzle, object_frames, shade, tile_swizzle, tile_unswizzle)
from ..utils.demo_scene import write_demo_scene
from ..utils.frame_graph import FrameGraph
from ..utils.parity import compare

LANES = TILE * TILE  # rays per kernel block
MSAA = (1, 2, 4, 8, 16)  # the sample counts whose patches tile a block


def deal_blocks(n_dev: int, rows: int, cols: int, assign: str):
    """Deal the frame's kernel blocks (a rows x cols patch grid in
    patch-row-major order) to n_dev shards, as the JAX package's deal_blocks.
    "contiguous": shard b owns the b-th band of blocks; "strided": shard b
    owns the diagonal class (r + c) % n_dev == b, a stable sort spilling
    boundary blocks to the next shard where the classes are unequal, so
    every shard has the same count. Returns (dev_blocks (n_dev, bpd) int64,
    inv (n_blocks,)), inv the permutation that de-interleaves the gathered
    blocks."""
    if assign not in ("contiguous", "strided"):
        raise ValueError(f"band assign must be contiguous|strided, got {assign}")
    n_blocks = rows * cols
    if n_blocks % n_dev:
        raise ValueError(f"{n_blocks} blocks not divisible by {n_dev} devices")
    bpd = n_blocks // n_dev
    if assign == "contiguous":
        dev_blocks = np.arange(n_blocks, dtype=np.int64).reshape(n_dev, bpd)
    else:
        f = np.arange(n_blocks, dtype=np.int64)
        cls = (f // cols + f % cols) % n_dev
        dev_blocks = f[np.argsort(cls, kind="stable")].reshape(n_dev, bpd)
    inv = np.argsort(dev_blocks.reshape(-1))
    return dev_blocks, inv


def _tree_to(tree, dev):
    """The pytree's tensors on `dev`: a tensor already there is not copied."""
    return pytree.tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x, tree)


class ShardPart(torch.nn.Module):
    """The shards dealt to one device, as a module: their swizzled dirs and
    the device's mesh orders and miss colour are buffers. forward(scene,
    state), both on the device: the frame algebra once, then per shard a
    shade of its blocks, the msaa average and the tonemap. Returns (blocks,
    auxes), a (bpd, q, 3) image and an aux dict per shard, in deal order."""

    def __init__(self, meta: SceneMeta, interval: int, msaa: int, bpd: int, q: int, bands,
                 device: torch.device):
        super().__init__()
        self.meta, self.interval, self.msaa, self.bpd, self.q = meta, interval, msaa, bpd, q
        self.n_bands, self.n_perms = len(bands), len(meta.mesh_perms)
        for k, band in enumerate(bands):
            self.register_buffer(f"band{k}", band.contiguous().to(device))
        for k, perm in enumerate(mesh_perm_tensors(meta, device)):
            self.register_buffer(f"perm{k}", perm)
        self.register_buffer("miss", torch.tensor(MISS_COLOR, device=device)[:, None])

    def forward(self, scene: Scene, state: FrameState):
        perms = tuple(getattr(self, f"perm{k}") for k in range(self.n_perms))
        L, inv_L, stat_cam = object_frames(scene.objects, state)
        blocks, auxes = [], []
        for k in range(self.n_bands):
            color, aux = shade(scene, self.meta, L, inv_L, stat_cam, getattr(self, f"band{k}"),
                               self.interval, perms, self.miss)
            if self.msaa > 1:
                # lanes run (quad_r, quad_c, r, c, sample): average the minor
                # sample axis, pixels stay in block quadrant-major order
                color = color.reshape(3, self.bpd * self.q, self.msaa ** 2).mean(dim=2)
            blocks.append(tonemap(color.T, scene.white_point).reshape(self.bpd, self.q, 3))
            auxes.append(aux)
        return blocks, auxes


class ShardGather(torch.nn.Module):
    """The frame on the first device from every ShardPart's result, as a
    module (the de-interleave permutation is a buffer): forward(parts),
    parts[j] the result of the part of distinct device j, gathers the blocks
    in shard order, de-interleaves, unswizzles and crops them; with_aux it
    also sums the aux over the shards."""

    def __init__(self, devices, distinct, inv, deinterleave: bool, ph: int, pw: int, p: int,
                 width: int, height: int, with_aux: bool):
        super().__init__()
        self.devices, self.distinct, self.deinterleave = devices, distinct, deinterleave
        self.ph, self.pw, self.p, self.width, self.height = ph, pw, p, width, height
        self.with_aux = with_aux
        self.register_buffer("inv", torch.as_tensor(inv, device=devices[0]))

    def forward(self, parts):
        first = self.devices[0]
        shards = [iter(zip(*part)) for part in parts]
        blocks, auxes = [], []
        for dev in self.devices:
            img, aux = next(shards[self.distinct.index(dev)])
            blocks.append(img.to(first))
            auxes.append(aux)
        out = torch.cat(blocks)
        if self.deinterleave:
            out = out[self.inv]
        vec = out.permute(2, 0, 1).reshape(3, self.ph * self.pw)
        img = tile_unswizzle(vec, self.ph, self.pw, self.p)
        img = img.reshape(3, self.ph, self.pw).permute(1, 2, 0)[:self.height, :self.width]
        if not self.with_aux:
            return img
        total = {k: v.to(first) for k, v in auxes[0].items()}
        for aux in auxes[1:]:
            total = {k: total[k] + aux[k].to(first) for k in total}
        return img, total


class ShardedFrame:
    """The sharded frame's modules: a ShardPart a distinct device (`parts`,
    in the order of `distinct`) and the ShardGather on the first device
    (`gather`). build_sharded_render_fn graphs each part; utils/aot exports
    each part and the gather."""

    def __init__(self, meta: SceneMeta, width: int, height: int, interval: int, devices,
                 msaa: int = 1, with_aux: bool = False, band_assign: str = "strided"):
        if msaa not in MSAA:
            raise ValueError(f"sharded renderer supports msaa in 1/2/4/8/16, got {msaa}")
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("sharded renderer needs at least one device")
        n_dev = len(self.devices)
        pw = _round_up(width, TILE)
        ph = _round_up(-(-height // n_dev), TILE) * n_dev
        p = TILE // msaa  # patch edge in pixels
        n_blocks = (ph // p) * (pw // p)
        dev_blocks, inv = deal_blocks(n_dev, ph // p, pw // p, band_assign)

        # The dirs as build_render_fn makes them, on the first device (a ray's
        # dir is the same on every pad), then each shard's blocks on its own.
        first = self.devices[0]
        dirs = camera_ray_dirs(width, height, msaa, pw, ph, device=first)
        if msaa == 1:
            full = tile_swizzle(dirs.reshape(-1, 3).T, ph, pw)
        else:
            full = msaa_swizzle(dirs, ph, pw, msaa)
        full = full.reshape(3, n_blocks, LANES)
        self.distinct = list(dict.fromkeys(self.devices))
        self.parts = [
            ShardPart(meta, int(interval), msaa, n_blocks // n_dev, p * p,
                      [full[:, torch.as_tensor(dev_blocks[b], device=first)].reshape(3, -1)
                       for b, d in enumerate(self.devices) if d == dev], dev)
            for dev in self.distinct]
        self.gather = ShardGather(self.devices, self.distinct, inv,
                                  band_assign != "contiguous", ph, pw, p, width, height,
                                  with_aux)


def build_sharded_render_fn(meta: SceneMeta, width: int, height: int, interval: int, devices,
                            msaa: int = 1, with_aux: bool = False,
                            band_assign: str = "strided"):
    """A renderer that splits the frame's kernel blocks over `devices` (a
    sequence of torch devices; one may appear several times). Returns
    render(scene, state) -> (H, W, 3) image on devices[0], or (image, aux)
    with aux summed over the shards. The image is padded so that every shard
    gets an equal number of blocks: band height round_up(ceil(H / n), 32),
    padded height n times that; the padding is cropped after the gather.
    msaa folds the sample sets into each block's rays (render.msaa_swizzle);
    1, 2, 4, 8 and 16 are supported. Each frame runs under
    `full_precision()`.

    Each distinct CUDA device runs its shards as one CUDA graph
    (utils/frame_graph, `ShardPart`), whose static inputs are that device's
    copy of the scene and state: the scene reaches a card by one copy a
    frame into its graph's inputs. The gather on the first device stays
    eager, a few ops: on distinct cards it needs every card's blocks, and
    one code path for logical and distinct shards keeps a one-card run on
    the path that distinct cards take. On the CPU every part runs eagerly."""
    frame = ShardedFrame(meta, width, height, interval, devices, msaa, with_aux, band_assign)
    return _graphed(frame.parts, frame.distinct, frame.gather)


def _graphed(parts, distinct, gather):
    """render(scene, state): each part (a module of its device's shards)
    as a FrameGraph on its device, then the gather, eager. `render.parts`
    are the FrameGraphs."""
    def part(module, dev):
        def run(scene: Scene, state: FrameState):
            with full_precision():
                return module(_tree_to(scene, dev), _tree_to(state, dev))

        return FrameGraph(run, dev)

    graphs = [part(m, dev) for m, dev in zip(parts, distinct)]

    def render(scene: Scene, state: FrameState):
        # The first device's part is issued last, so that the copies of the
        # scene to the other devices are not queued behind its replay.
        out = [None] * len(graphs)
        for j in reversed(range(len(graphs))):
            out[j] = graphs[j](scene, state)
        return gather(out)

    render.parts = graphs
    return render


def per_block_mesh_work(scene: Scene, meta: SceneMeta, width: int, height: int, n_dev: int,
                        state=None, interval: int | None = None):
    """Per-block mesh-work proxy: primary rays whose nearest hit is a mesh
    object, summed per 1024-lane block of the n_dev-padded grid (padding rows
    and columns masked). The intersect does not depend on the deal: compute
    it once and repartition with partition_work. Runs on the scene's device.
    Returns (per_block (n_blocks,) float32 numpy, grid_rows, grid_cols)."""
    dev = scene.white_point.device
    if state is None:
        state = FrameState.initial(dev)
    if interval is None:
        interval = meta.default_interval
    pw = _round_up(width, TILE)
    ph = _round_up(-(-height // n_dev), TILE) * n_dev
    n_blocks = (ph // TILE) * (pw // TILE)
    dirs = camera_ray_dirs(width, height, 1, pw, ph, device=dev)
    d = tile_swizzle(dirs.reshape(-1, 3).T, ph, pw)
    with full_precision():
        L, _, stat_cam = object_frames(scene.objects, state)
        dir4 = torch.cat([torch.full((1, d.shape[1]), float(interval), device=dev), d])
        _, _, _, obj, did_hit = intersect_scene(scene, meta, L, stat_cam, dir4,
                                                mesh_perm_tensors(meta, dev))
    mesh_hit = did_hit & torch.isin(obj, torch.as_tensor(meta.mesh_ids, dtype=torch.int32,
                                                         device=dev))
    rows = torch.arange(ph, device=dev)[:, None].expand(ph, pw)
    cols = torch.arange(pw, device=dev)[None, :].expand(ph, pw)
    row = tile_swizzle(rows.reshape(1, -1), ph, pw)[0]
    col = tile_swizzle(cols.reshape(1, -1), ph, pw)[0]
    work = (mesh_hit & (row < height) & (col < width)).to(torch.float32)
    per_block = work.reshape(n_blocks, LANES).sum(dim=1).cpu().numpy()
    return per_block, ph // TILE, pw // TILE


def partition_work(per_block, grid_rows: int, grid_cols: int, n_dev: int, assign: str):
    """Deal per-block work onto n_dev shards under `assign`; returns
    (counts (n_dev,) int64, skew = max / mean)."""
    dev_blocks, _ = deal_blocks(n_dev, grid_rows, grid_cols, assign)
    counts = np.array([int(per_block[dev_blocks[b]].sum()) for b in range(n_dev)])
    mean = counts.mean()
    skew = float(counts.max() / mean) if mean > 0 else 0.0
    return counts, skew


def band_mesh_work(scene: Scene, meta: SceneMeta, width: int, height: int, n_dev: int,
                   assign: str = "strided", state=None, interval: int | None = None):
    """counts and skew for one assignment (per_block_mesh_work, then
    partition_work)."""
    per_block, rows, cols = per_block_mesh_work(scene, meta, width, height, n_dev, state=state,
                                                interval=interval)
    return partition_work(per_block, rows, cols, n_dev, assign)


def default_devices(n: int | None = None) -> list:
    """The card's CUDA devices, the first n of them (all by default), for
    build_sharded_render_fn; the counterpart of the JAX package's
    default_mesh. Raises on a host without a CUDA device, or with fewer
    than n."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the sharded renderer's default devices are cards; "
                           "pass CPU devices explicitly to run the plain twins")
    count = torch.cuda.device_count()
    if n is not None and n > count:
        raise ValueError(f"asked for {n} CUDA devices, the host has {count}")
    return [torch.device("cuda", i) for i in range(count if n is None else n)]


def dryrun_multichip(n: int, device=DEFAULT_DEVICE) -> dict:
    """Dry run of the sharded renderer on n logical shards of one device:
    the "textured" fixture (utils/demo_scene, level 2: a textured mesh and a
    light sphere) at 64x64, msaa 2 (the folded layout), with the aux
    counters; the frame held to the single-device renderer's under the parity
    rule (utils/parity.compare) and hits > 0. Returns the comparison with
    the counts. Raises on a failed check."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to dry-run on the plain twins")
    with tempfile.TemporaryDirectory() as tmp:
        scene, meta = build_scene(load_scene_file(write_demo_scene(tmp, 2, "textured")),
                                  device=dev)
    state = FrameState(torch.tensor([0.3, 0.0, 0.0], device=dev),
                       torch.tensor([0.1, 0.0, 0.0, 0.0], device=dev))
    img, aux = build_sharded_render_fn(meta, 64, 64, -1, [dev] * n, msaa=2, with_aux=True)(
        scene, state)
    ref = build_render_fn(meta, 64, 64, -1, 2, device=dev)(scene, state)
    if tuple(img.shape) != (64, 64, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"dry run: frame {tuple(img.shape)} not finite of 64x64x3")
    if int(aux["hits"]) <= 0:
        raise AssertionError(f"dry run: no hits {aux}")
    cmp = compare(img.cpu().numpy(), ref.cpu().numpy())
    if not cmp["ok"] or cmp["mean_diff"] >= 1e-4:
        raise AssertionError(f"dry run: sharded frame off the single-device frame: {cmp}")
    return {**cmp, **{k: int(v) for k, v in aux.items()}}
