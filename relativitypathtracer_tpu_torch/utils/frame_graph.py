"""The frame as one CUDA graph: the port's counterpart of `jax.jit`.

The JAX package never runs a frame one op at a time: `build_render_fn`
returns `jax.jit(render)` (JAX render.py:692), and the viewer's, the sharded
and the exported renderers are jitted too, so one host call dispatches one
compiled program. PyTorch runs eagerly, and the port's frame is some 220-730
launches issued from Python. `FrameGraph(fn, device)` wraps such a frame:
on a CUDA device its first call for an input layout (the tree structure,
shapes, dtypes and devices of the inputs' tensors, the other leaves' values;
`layout_key`) runs fn once eagerly on a side stream (the warm-up that
builds the kernel library, makes the walks' shared-memory opt-in and fills
the caches of `_build.cached_constant`), then captures one more call of fn
into a `torch.cuda.CUDAGraph`; every call replays the graph of its layout.
A new layout is a new capture, as a new shape is a new trace under
`jax.jit`; a small bounded cache keeps the latest layouts.

Every graph of a device draws its intermediates from one memory pool, and
is warmed up and captured on one side stream, both the device's
(`_device_pool`): a replay's intermediates are dead when it ends, and
replays run one after another on the caller's stream, so one graph may
reuse what another freed. What a graph keeps is its static inputs and its
outputs; the pool holds the largest frame's intermediates once, however
many renderers are cached.

Semantics kept from `jax.jit`:
- a call reads the values it is given: the graph owns static copies of
  every tensor of its inputs, and each call copies the caller's tensors into
  them before the replay (so a second scene of the same shapes, or a
  caller's in-place edit, renders right with no new capture);
- a call returns new tensors: the outputs are cloned after the replay, so a
  frame the caller keeps is not overwritten by the next replay of any graph;
- `_build.LAUNCHES` keeps meaning "launches issued to the card": the counts
  made while capturing are taken out, and each replay adds them.

On a CPU device fn runs eagerly on every call: the CPU path is the kernels'
plain twins, and CUDA graphs do not exist there. There is no switch to turn
the graph off on a card, and no eager fallback: a failed capture raises.

Each graph keeps its template (`keep_graph=True`) beside the instantiated
graph, so that `kernel_names` can list what a replay launches: exactly the
graph's kernel nodes.
"""

from __future__ import annotations

import collections
import ctypes

import torch
from torch.utils import _pytree as pytree

from ..device import resolve
from ..ops.kernels import _build

MAX_LAYOUTS = 4  # graphs kept per FrameGraph, the latest layouts
_POOLS: dict = {}  # device -> (memory pool handle, capture stream)


def layout_key(leaves, spec):
    """What a captured graph is specialised to: the tree structure, each
    tensor's shape, dtype and device, each other leaf's value. Tensor values
    are not part of it."""
    return spec, tuple((tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor)
                       else ("value", x) for x in leaves)


def _device_pool(device: torch.device):
    """The memory pool and the side stream (warm-up and capture) that every
    graph of `device` shares. A stream of the device itself: torch's default
    capture stream is made once, on the device current at its first capture.
    One stream, because cuBLAS keeps a workspace (32 MiB on Hopper) for each
    stream it has run on, for the life of the process."""
    device = resolve(device)
    if device not in _POOLS:
        _POOLS[device] = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(device))
    return _POOLS[device]


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h, CUDA 12)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_bytes", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _libcuda():
    """libcuda.so.1, with the four calls kernel_names makes declared."""
    cu = ctypes.CDLL("libcuda.so.1")
    node_p = ctypes.POINTER(ctypes.c_void_p)
    for name, args in (("cuGraphGetNodes", (ctypes.c_void_p, node_p,
                                            ctypes.POINTER(ctypes.c_size_t))),
                       ("cuGraphNodeGetType", (ctypes.c_void_p, ctypes.POINTER(ctypes.c_int))),
                       ("cuGraphKernelNodeGetParams_v2", (ctypes.c_void_p,
                                                          ctypes.POINTER(_KernelNodeParams))),
                       ("cuFuncGetName", (ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p))):
        fn = getattr(cu, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return cu


def kernel_names(graph) -> list[str]:
    """The function name (mangled) of each kernel node of a captured
    `torch.cuda.CUDAGraph(keep_graph=True)`: the kernels each replay
    launches, in node order. Read through libcuda (CUDA 12.3 or later for
    cuFuncGetName), which names the port's kernels too: they are launched
    by the kernel library's own CUDA runtime, whose functions torch's
    runtime cannot name."""
    cu = _libcuda()

    def call(name, *args):
        err = getattr(cu, name)(*args)
        if err:
            raise RuntimeError(f"{name} failed: CUresult {err}")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", handle, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call("cuGraphGetNodes", handle, nodes, ctypes.byref(n))
    names = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int()
        call("cuGraphNodeGetType", node, ctypes.byref(kind))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = _KernelNodeParams()
        call("cuGraphKernelNodeGetParams_v2", node, ctypes.byref(params))
        name = ctypes.c_char_p()
        call("cuFuncGetName", ctypes.byref(name), params.func)
        names.append(name.value.decode())
    return names


class CapturedFrame:
    """One layout's graph: the static inputs it reads, the outputs it writes,
    and the kernel launches it holds (counted in `_build.LAUNCHES` per
    replay). `graph` is anything with `replay()`."""

    def __init__(self, graph, statics, outputs, launches):
        self.graph, self.statics, self.outputs = graph, statics, outputs
        self.launches = collections.Counter(launches)
        self.input_bytes = sum(x.numel() * x.element_size() for x in statics)

    def run(self, leaves):
        """Copy the caller's tensors into the static inputs, replay, count
        the graph's launches; a clone of the outputs."""
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        if tensors:
            torch._foreach_copy_(self.statics, tensors)
        self.graph.replay()
        _build.LAUNCHES.update(self.launches)
        return pytree.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                               self.outputs)


class FrameGraph:
    """fn(*inputs) captured once per input layout on `device` and replayed
    (module docstring); fn runs eagerly on a CPU device. fn must not read
    a device value on the host (`.item()`, `bool(tensor)`) nor make a tensor
    from host data after its warm-up: capture refuses both."""

    def __init__(self, fn, device):
        self.fn = fn
        self.device = resolve(device)
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.captures = 0  # graphs captured, over the renderer's life

    def __call__(self, *inputs):
        if self.device.type != "cuda":
            return self.fn(*inputs)
        leaves, spec = pytree.tree_flatten(inputs)
        key = layout_key(leaves, spec)
        with torch.cuda.device(self.device):
            frame = self.graphs.get(key)
            if frame is None:
                frame = self._capture(leaves, spec)
                self.graphs[key] = frame
                while len(self.graphs) > MAX_LAYOUTS:
                    self.graphs.popitem(last=False)
            else:
                self.graphs.move_to_end(key)
            return frame.run(leaves)

    @property
    def input_bytes(self) -> int:
        """Bytes a call copies into the latest layout's static inputs."""
        return next(reversed(self.graphs.values())).input_bytes if self.graphs else 0

    def _capture(self, leaves, spec) -> CapturedFrame:
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        statics = [torch.empty_like(x, device=self.device) for x in tensors]
        if statics:
            torch._foreach_copy_(statics, tensors)
        it = iter(statics)
        inputs = pytree.tree_unflatten(
            [next(it) if isinstance(x, torch.Tensor) else x for x in leaves], spec)
        pool, stream = _device_pool(self.device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self.fn(*inputs)  # warm-up: real launches, counted as such
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = collections.Counter(_build.LAUNCHES)
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                outputs = self.fn(*inputs)
        finally:
            launches = _build.LAUNCHES - before  # captured, not launched
            _build.LAUNCHES.clear()
            _build.LAUNCHES.update(before)
        graph.instantiate()
        self.captures += 1
        return CapturedFrame(graph, statics, outputs, launches)
