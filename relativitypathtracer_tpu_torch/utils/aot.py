"""Export of the frame renderer as a portable artifact (torch.export).

Torch counterpart of `relativitypathtracer_tpu.utils.aot`. `export_render`
traces the frame of `build_render_fn` into an ExportedProgram and serializes
it (`torch.export.save`) to bytes; `load_render` deserializes it into
render(scene, state). A serving host then renders without the Python scene
pipeline or `build_render_fn`. The scene stays an argument, so one
artifact serves any scene whose build gives the same tensor shapes (the same
object counts, texture atlas and mesh pools): scene edits, camera motion and
boosts with no re-export. The renderer's constants (the swizzled camera
dirs, the meshes' Morton orders, the miss colour) are buffers of the
exported module. A sharded renderer's artifact is a zip archive of one
program per device and one of the gather (`export_sharded_render`).

Every kernel of the frame is an operator torch.ops.rpt.* (ops/kernels/
_build.define_op): the program records each launch as one node, and the
loaded program's CUDA nodes launch the same kernels, counted in
_build.LAUNCHES as the live renderer's. The export traces the operators'
shapes only (their fake implementations), never a plain twin's
data-dependent loop.

Not ported from the JAX package's aot.py:
- the VMEM-budget lint of TPU exports (`_finish`, utils/mosaic_lint): it
  bounds the TPU's on-core scratch memory, which the card does not have; a
  CUDA kernel checks its own shared memory at launch;
- lowering for other platforms than the host's (`platforms=("tpu",)` from a
  CPU box): an export traces the port on `device`, so a CUDA artifact is
  exported on the card, and a CPU artifact runs the plain twins.
"""

from __future__ import annotations

import io
import itertools
import zipfile

import torch
from torch.utils import _pytree as pytree

from ..device import DEFAULT_DEVICE
from ..models.scene import MeshArrays, MeshBatchStatic, MeshStatic, ObjectsSoA, Scene
from ..parallel.tiles import ShardedFrame, _graphed, _tree_to
from ..render import FrameState, full_precision, render_constants, trace_frame
from .frame_graph import FrameGraph

# The artifact's input spec names every NamedTuple node of (Scene,
# FrameState); the names are a compatibility contract, the JAX package's.
for _t in (ObjectsSoA, MeshArrays, MeshStatic, MeshBatchStatic, Scene, FrameState):
    if _t not in pytree.SUPPORTED_SERIALIZED_TYPES:
        pytree._register_namedtuple(_t, serialized_type_name=f"rpt.{_t.__name__}")

# The types an artifact pickles (its example inputs): the only globals the
# safe unpickler (torch.load with weights_only=True) is allowed beyond
# tensors and containers when it loads one.
_PICKLED = [ObjectsSoA, MeshArrays, MeshStatic, MeshBatchStatic, Scene, FrameState]

# The members of a sharded artifact: a program per distinct device, then the
# gather's.
SHARD_PART, SHARD_GATHER = "sharded/part{}.pt2", "sharded/gather.pt2"


class RenderModule(torch.nn.Module):
    """build_render_fn's frame as a module: the constants as buffers, the
    scene and the FrameState as the arguments of forward."""

    def __init__(self, meta, width: int, height: int, interval: int, msaa: int, device):
        super().__init__()
        if msaa < 1:
            raise ValueError(f"msaa must be >= 1, got {msaa}")
        self.meta, self.interval = meta, int(interval)
        self.width, self.height = width, height
        dirs, perms, miss = render_constants(meta, width, height, msaa, device)
        self.register_buffer("dirs", dirs)
        self.n_perms = len(perms)
        for k, perm in enumerate(perms):
            self.register_buffer(f"perm{k}", perm)
        self.register_buffer("miss", miss)

    def forward(self, scene: Scene, state: FrameState):
        perms = tuple(getattr(self, f"perm{k}") for k in range(self.n_perms))
        return trace_frame(scene, self.meta, state, self.dirs, perms, self.miss, self.interval,
                           self.width, self.height)


def _card(dev: torch.device) -> None:
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: export on the card, or pass device='cpu'")


def _save(module: torch.nn.Module, args) -> bytes:
    """Export `module` with `args` as its example inputs; return the
    serialized program."""
    with full_precision():
        program = torch.export.export(module, args, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_render(scene, meta, width: int, height: int, interval: int | None = None,
                  msaa: int = 1, device=DEFAULT_DEVICE) -> bytes:
    """Serialize the frame renderer of (meta, width, height, interval, msaa)
    on `device`. `scene` gives only the input shapes (it is not baked in).
    Returns the bytes of the ExportedProgram, whose forward is render(scene,
    state) -> (H, W, 3) image."""
    dev = torch.device(device)
    _card(dev)
    if interval is None:
        interval = meta.default_interval
    return _save(RenderModule(meta, width, height, int(interval), msaa, dev),
                 (_tree_to(scene, dev), FrameState.initial(dev)))


def export_sharded_render(scene, meta, width: int, height: int, devices,
                          interval: int | None = None, msaa: int = 1) -> bytes:
    """Serialize the sharded renderer (parallel/tiles.py) over `devices`: a
    zip archive of one program per distinct device (`SHARD_PART`, its
    ShardPart: its shards' dirs and its mesh orders, the scene and state on
    that device as inputs) and the program of the gather (`SHARD_GATHER`,
    ShardGather on devices[0], whose example inputs come from one eager run
    of the parts). The caller passes the scene and state on devices[0];
    load_render graphs each part on its device, as the live renderer does."""
    devices = [torch.device(d) for d in devices]
    for dev in devices:
        _card(dev)
    if interval is None:
        interval = meta.default_interval
    frame = ShardedFrame(meta, width, height, int(interval), devices, msaa)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as archive:
        outs = []
        for j, (part, dev) in enumerate(zip(frame.parts, frame.distinct)):
            args = (_tree_to(scene, dev), FrameState.initial(dev))
            archive.writestr(SHARD_PART.format(j), _save(part, args))
            with full_precision():
                outs.append(part(*args))
        archive.writestr(SHARD_GATHER, _save(frame.gather, (outs,)))
    return buf.getvalue()


def _program_device(program) -> torch.device:
    """The one device of an exported program's tensors; raises on several."""
    devices = {t.device for t in (*program.state_dict.values(), *program.constants.values())
               if isinstance(t, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"load_render: a program's tensors lie on {sorted(map(str, devices))}"
                         "; each program of an artifact runs on one device")
    return devices.pop()


def load_program(data: bytes):
    """torch.export.load with the port's pickled types allowed to the safe
    unpickler, so that torch never retries with a full unpickle (which
    could run code from the artifact); what the safe load refuses raises."""
    with torch.serialization.safe_globals(_PICKLED):
        return torch.export.load(io.BytesIO(data))


def load_render(data: bytes):
    """Deserialize an exported renderer; returns render(scene, state) ->
    (H, W, 3) image on the artifact's (first) device. Each call runs under
    `full_precision()`: the TF32 switches are process state, not part of the
    program, so the loaded program would otherwise follow the caller's.
    Importing this module registers the operators the program calls.

    On a CUDA device the loaded program runs as one CUDA graph
    (utils/frame_graph), captured at its first call per input layout: the
    replay runs the program's kernels with none of its Python. A sharded
    artifact (export_sharded_render) runs as the live sharded renderer:
    each part's program a graph on its device, the gather's program eager
    on the first; `render.parts` are the graphs.

    The module checks each call's inputs against the exported ones (their
    tree and shapes) in its pre-hook, when it runs: at a capture, where a
    new layout starts one. It is built without torch's
    generated guard function (check_guards=False), whose code names an input
    by a textual replace that mangles a path with a sibling as its prefix
    (`objects.m` inside `objects.mesh_root`).

    The artifact is unpickled only by torch's safe loader (weights_only),
    allowed the port's NamedTuples and nothing else: an artifact that needs
    more raises."""
    with zipfile.ZipFile(io.BytesIO(data)) as archive:
        names = set(archive.namelist())
        if SHARD_GATHER not in names:
            program = load_program(data)
            module = program.module(check_guards=False)

            def render(scene: Scene, state: FrameState):
                with full_precision():
                    return module(scene, state)

            return FrameGraph(render, _program_device(program))
        parts = [load_program(archive.read(SHARD_PART.format(j)))
                 for j in itertools.takewhile(lambda j: SHARD_PART.format(j) in names,
                                              itertools.count())]
        gather = load_program(archive.read(SHARD_GATHER))
    return _graphed([p.module(check_guards=False) for p in parts],
                    [_program_device(p) for p in parts], gather.module(check_guards=False))
