"""The frame as one CUDA graph (utils/frame_graph) and the repairs it needs,
on the CPU.

A CUDA graph exists only on the card; here the renderers run their frames
eagerly through the same FrameGraph, and the tests hold what the CPU can
show:
- FrameGraph's CPU route calls its function on every call, and the
  renderers' frames equal the eager frame (`render_constants` +
  `trace_frame`) exactly;
- the input-layout key a graph is specialised to tells shapes, dtypes and
  structure apart and ignores tensor values;
- a replay copies the caller's tensors into the graph's inputs, adds the
  captured launches to `_build.LAUNCHES` and returns fresh outputs (a stub
  graph object stands in for `torch.cuda.CUDAGraph`);
- no frame after the first makes a tensor from host data (a capture
  refuses the host-to-device copy): `torch.tensor` raises in the second
  frame of the `instances` fixture, of a variant whose light is one of the
  meshes (the shadow walk's stand-in box), and of `textured` and `cubes`,
  and that frame equals the first; the mesh-light frame also against the
  JAX package's under the parity rule;
- `render_frame` builds its renderer once (the JAX package's lru_cache).
"""

import collections
import contextlib

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch_port_fixtures import assert_frame_parity, build_both, jax_frame, write_fixture

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch import render as prender
from relativitypathtracer_tpu_torch.ops.kernels import _build
from relativitypathtracer_tpu_torch.utils.frame_graph import CapturedFrame, FrameGraph, layout_key

STATE = ((0.3, 0.0, 0.4), (0.7, 0.0, 0.0, 0.0))


def _state(s=STATE):
    return pt.FrameState(torch.tensor(s[0]), torch.tensor(s[1]))


@contextlib.contextmanager
def no_host_tensors(monkeypatch):
    """torch.tensor, and torch.as_tensor of anything but a tensor, raise."""
    real = torch.as_tensor

    def tensor(*args, **kwargs):
        raise AssertionError("torch.tensor in a frame after the first")

    def as_tensor(x, *args, **kwargs):
        if not isinstance(x, torch.Tensor):
            raise AssertionError("torch.as_tensor of host data in a frame after the first")
        return real(x, *args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(torch, "tensor", tensor)
        m.setattr(torch, "as_tensor", as_tensor)
        yield


def _mesh_light(path):
    """The instances fixture with its first mesh instance made a light."""
    with open(path) as f:
        text = f.read()
    first = text.index("Om0\n")
    with open(path, "w") as f:
        f.write(text[:first] + "Om0\n l1\n" + text[first + 4:])
    return path


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """kind -> (JAX scene and meta or None, port scene and meta)."""
    out = {"mesh_light": build_both(_mesh_light(write_fixture(tmp_path_factory, 2, "instances")))}
    for kind in ("instances", "textured", "cubes"):
        path = write_fixture(tmp_path_factory, 2, kind)
        out[kind] = (None, pt.build_scene(pt.load_scene_file(path), device="cpu"))
    return out


@pytest.mark.parametrize("kind", ["instances", "mesh_light", "textured", "cubes"])
def test_no_host_tensor_after_the_first_frame(fixtures, kind, monkeypatch):
    _, (ps, pm) = fixtures[kind]
    if kind == "mesh_light":  # the light's own mesh takes the stand-in box
        assert set(pm.light_ids) & set(pm.mesh_ids) and ps.mesh_batch is not None
    render = prender.build_render_fn(pm, 32, 32, -1, with_aux=True, device="cpu")
    state = _state()
    first, first_aux = render(ps, state)
    with no_host_tensors(monkeypatch):
        second, second_aux = render(ps, state)
    assert torch.equal(first, second)
    assert {k: int(v) for k, v in first_aux.items()} == {k: int(v) for k, v in second_aux.items()}


def test_mesh_light_frame_matches_jax(fixtures):
    """The stand-in box keeps the JAX package's shadow walk: the frame of a
    scene whose light is a mesh under the parity rule, equal counts."""
    (js, jm), (ps, pm) = fixtures["mesh_light"]
    want, jaux = jax_frame(js, jm, STATE, False)
    render = prender.build_render_fn(pm, 64, 64, -1, with_aux=True, device="cpu")
    got, paux = render(ps, _state())
    assert_frame_parity(got.numpy(), want, {k: int(v) for k, v in paux.items()}, jaux)
    assert paux["shadow_rays"] > 0


@pytest.mark.parametrize("with_aux, out_uint8", [(True, False), (False, True)])
def test_renderer_equals_the_eager_frame(fixtures, with_aux, out_uint8):
    _, (ps, pm) = fixtures["instances"]
    render = prender.build_render_fn(pm, 32, 32, -1, with_aux=with_aux, out_uint8=out_uint8,
                                     device="cpu")
    assert isinstance(render, FrameGraph) and render.device.type == "cpu"
    dirs, perms, miss = prender.render_constants(pm, 32, 32, 1, "cpu")
    with prender.full_precision():
        want = prender.trace_frame(ps, pm, _state(), dirs, perms, miss, -1, 32, 32, with_aux,
                                   out_uint8)
    got = render(ps, _state())
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        assert torch.equal(g, w)
    assert render.captures == 0 and not render.graphs


def test_render_frame_builds_its_renderer_once(fixtures, monkeypatch):
    _, (ps, pm) = fixtures["instances"]
    calls = []
    real = prender.render_constants

    def counted(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(prender, "render_constants", counted)
    prender._cached_render_fn.cache_clear()
    a = pt.render_frame(ps, pm, _state(), 32, 32, device="cpu")
    b = pt.render_frame(ps, pm, _state(), 32, 32, device="cpu")
    assert len(calls) == 1 and torch.equal(a, b)
    assert prender.build_render_fn(pm, 32, 32, pm.default_interval, device="cpu") is \
        prender.build_render_fn(pm, 32, 32, pm.default_interval, 1, False, False,
                                torch.device("cpu"))


def test_cpu_route_calls_the_function_every_time():
    calls = []

    def fn(x, scale):
        calls.append(scale)
        return x * scale

    graph = FrameGraph(fn, "cpu")
    x = torch.arange(4.0)
    assert torch.equal(graph(x, 2.0), x * 2.0) and torch.equal(graph(x, 3.0), x * 3.0)
    assert calls == [2.0, 3.0] and graph.captures == 0 and graph.input_bytes == 0


def _key(*inputs):
    return layout_key(*pytree.tree_flatten(inputs))


def test_layout_key_tells_shapes_and_dtypes_apart_and_ignores_values():
    state = pt.FrameState(torch.zeros(3), torch.zeros(4))
    other = pt.FrameState(torch.ones(3), torch.full((4,), 7.0))
    dirs = torch.zeros(3, 1024)
    assert _key(state, dirs) == _key(other, dirs.clone().uniform_())
    assert _key(state, dirs) != _key(state, torch.zeros(3, 2048))
    assert _key(state, dirs) != _key(state, dirs.double())
    assert _key(state, dirs) != _key(pt.FrameState(torch.zeros(3), torch.zeros(5)), dirs)
    assert _key(state, dirs) != _key((torch.zeros(3), torch.zeros(4)), dirs)
    assert _key(state, 1) != _key(state, 2) and _key(state, None) == _key(other, None)


class StubGraph:
    """Stands in for torch.cuda.CUDAGraph: a replay writes twice the static
    input into the static output."""

    def __init__(self, static, out):
        self.static, self.out, self.replays = static, out, 0

    def replay(self):
        self.out.copy_(self.static * 2.0)
        self.replays += 1


def test_replay_copies_inputs_counts_launches_and_returns_fresh_outputs():
    static, out = torch.zeros(3), torch.zeros(3)
    graph = StubGraph(static, out)
    captured = CapturedFrame(graph, [static], {"img": out}, {"rpt_a": 3, "rpt_b": 1})
    assert captured.input_bytes == 12
    saved = collections.Counter(_build.LAUNCHES)
    try:
        _build.LAUNCHES.clear()
        first = captured.run([torch.tensor([1.0, 2.0, 3.0]), "not a tensor"])
        second = captured.run([torch.tensor([4.0, 5.0, 6.0]), "not a tensor"])
        assert dict(_build.LAUNCHES) == {"rpt_a": 6, "rpt_b": 2} and graph.replays == 2
        assert torch.equal(first["img"], torch.tensor([2.0, 4.0, 6.0]))  # kept, not overwritten
        assert torch.equal(second["img"], torch.tensor([8.0, 10.0, 12.0]))
        assert first["img"] is not out and second["img"] is not out
    finally:
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(saved)


def test_sharded_parts_run_eagerly_on_the_cpu(fixtures):
    from relativitypathtracer_tpu_torch.parallel import tiles

    _, (ps, pm) = fixtures["instances"]
    render = tiles.build_sharded_render_fn(pm, 32, 64, -1, ["cpu"] * 2, with_aux=True)
    img, aux = render(ps, _state())
    want, waux = prender.build_render_fn(pm, 32, 64, -1, with_aux=True, device="cpu")(ps,
                                                                                     _state())
    assert torch.equal(img, want) and {k: int(v) for k, v in aux.items()} == \
        {k: int(v) for k, v in waux.items()}
    assert len(render.parts) == 1 and render.parts[0].captures == 0
    assert np.isfinite(img.numpy()).all()
