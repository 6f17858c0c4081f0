"""Export of the port's renderer (utils/aot.py) and the operators under its
kernels, on the CPU.

An exported program calls the operators torch.ops.rpt.*, whose CPU
implementations are the kernels' plain twins, so a CPU artifact renders
the same frame as the live renderer: held torch.equal at 64x64, for a new
scene of the same shapes and a new state too (the counterpart of the JAX
package's test_exported_artifact_takes_new_scene_and_state). Each operator's
fake implementation, which the export traces, gives the shapes and dtypes of
its real results.
"""

import io
import logging
import os
import pathlib
import subprocess
import sys
import zipfile

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch_port_fixtures import write_fixture

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch.ops import mesh_intersect
from relativitypathtracer_tpu_torch.ops.kernels import _build
from relativitypathtracer_tpu_torch.utils import aot

REPO = pathlib.Path(__file__).resolve().parents[1]
W = H = 64
STATES = [((0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 0.0)), ((0.5, 0.0, 0.0), (2 / 30, 0.0, 0.0, 0.0))]


def _state(i):
    return pt.FrameState(torch.tensor(STATES[i][0]), torch.tensor(STATES[i][1]))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return {kind: pt.build_scene(pt.load_scene_file(write_fixture(tmp_path_factory, 2, kind)),
                                 device="cpu")
            for kind in ("textured", "cubes", "instances")}


def _other_scene(scene):
    """The same shapes with other velocities and colours."""
    objects = scene.objects._replace(velocity=scene.objects.velocity.flip(0) * 0.8,
                                     color=scene.objects.color.roll(1, dims=1))
    return scene._replace(objects=objects, ambient=scene.ambient * 0.5)


@pytest.mark.parametrize("kind", ["textured", "cubes", "instances"])
def test_exported_frame_equals_the_live_frame(scenes, kind):
    scene, meta = scenes[kind]
    render = aot.load_render(aot.export_render(scene, meta, W, H, device="cpu"))
    live = pt.build_render_fn(meta, W, H, meta.default_interval, device="cpu")
    for i in range(len(STATES)):
        assert torch.equal(render(scene, _state(i)), live(scene, _state(i)))


def test_exported_artifact_takes_new_scene_and_state(scenes):
    scene, meta = scenes["textured"]
    render = aot.load_render(aot.export_render(scene, meta, W, H, device="cpu"))
    other = _other_scene(scene)
    got = render(other, _state(1))
    want = pt.build_render_fn(meta, W, H, meta.default_interval, device="cpu")(other, _state(1))
    assert torch.equal(got, want)
    assert not torch.equal(got, render(scene, _state(1)))


def test_exported_artifact_refuses_other_shapes(scenes):
    """The loaded module checks its inputs' shapes against the exported ones."""
    scene, meta = scenes["cubes"]
    render = aot.load_render(aot.export_render(scene, meta, W, H, device="cpu"))
    bigger = scene._replace(tex_quads=torch.cat([scene.tex_quads, scene.tex_quads]))
    with pytest.raises(Exception, match="shape|size"):
        render(bigger, _state(0))


def test_exported_sharded_frame_equals_the_live_frame(scenes):
    from relativitypathtracer_tpu_torch.parallel.tiles import build_sharded_render_fn

    scene, meta = scenes["textured"]
    data = aot.export_sharded_render(scene, meta, W, H, ["cpu"] * 2)
    got = aot.load_render(data)(scene, _state(1))
    want = build_sharded_render_fn(meta, W, H, meta.default_interval, ["cpu"] * 2)(
        scene, _state(1))
    assert torch.equal(got, want)


def test_exported_sharded_frame_holds_a_program_per_device(scenes):
    """A sharded artifact over two distinct devices ("cpu" and "cpu:0" are
    two device names to the renderer) holds a program per device and the
    gather's; loaded, it renders the live sharded frame and the single
    frame to the bit, at two states and a second scene of the same shapes,
    through one part a device."""
    from relativitypathtracer_tpu_torch.parallel.tiles import build_sharded_render_fn

    scene, meta = scenes["instances"]
    devices = ["cpu", "cpu:0", "cpu", "cpu:0"]
    data = aot.export_sharded_render(scene, meta, W, H, devices)
    with zipfile.ZipFile(io.BytesIO(data)) as archive:
        assert sorted(archive.namelist()) == [aot.SHARD_GATHER, aot.SHARD_PART.format(0),
                                              aot.SHARD_PART.format(1)]
    loaded = aot.load_render(data)
    live = build_sharded_render_fn(meta, W, H, meta.default_interval, devices)
    single = pt.build_render_fn(meta, W, H, meta.default_interval, device="cpu")
    other = scene._replace(objects=scene.objects._replace(
        velocity=scene.objects.velocity.flip(0) * 0.8))
    assert len(loaded.parts) == 2
    for sc, st in ((scene, _state(0)), (scene, _state(1)), (other, _state(1))):
        got = loaded(sc, st)
        assert torch.equal(got, live(sc, st)) and torch.equal(got, single(sc, st))


class _SafeLoadsOnly(logging.Handler):
    """torch.load refusing weights_only=False (the full unpickle torch's
    export loader falls back to, which can run code from the artifact), and
    the records torch's loader logs meanwhile."""

    def __init__(self, monkeypatch):
        super().__init__()
        self.real, self.records = torch.load, []
        self.logger = logging.getLogger("torch._export.serde.serialize")
        monkeypatch.setattr(torch, "load", self.load)

    def load(self, *args, **kwargs):
        if kwargs.get("weights_only") is False:
            raise AssertionError("torch.load(weights_only=False)")
        return self.real(*args, **kwargs)

    def emit(self, record):
        self.records.append(record)

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def test_load_render_runs_no_full_unpickle(scenes, monkeypatch):
    """load_render of a single and of a sharded artifact unpickles with
    torch's safe loader only (the port's NamedTuples allowed): no
    torch.load(weights_only=False), no fallback logged, and the loaded
    frames torch.equal to the live ones."""
    from relativitypathtracer_tpu_torch.parallel.tiles import build_sharded_render_fn

    scene, meta = scenes["textured"]
    single = aot.export_render(scene, meta, W, H, device="cpu")
    sharded = aot.export_sharded_render(scene, meta, W, H, ["cpu", "cpu:0"])
    with _SafeLoadsOnly(monkeypatch) as guard:
        renders = [aot.load_render(single), aot.load_render(sharded)]
    assert not [r for r in guard.records if "weights_only" in str(r.msg)]
    lives = [pt.build_render_fn(meta, W, H, meta.default_interval, device="cpu"),
             build_sharded_render_fn(meta, W, H, meta.default_interval, ["cpu", "cpu:0"])]
    for render, live in zip(renders, lives):
        for i in range(len(STATES)):
            assert torch.equal(render(scene, _state(i)), live(scene, _state(i)))


def test_the_guard_catches_torchs_fallback(scenes, monkeypatch):
    """The guard of the test above is not vacuous: torch.export.load without
    the port's types allowed falls back to a full unpickle, which it stops."""
    scene, meta = scenes["cubes"]
    data = aot.export_render(scene, meta, W, H, device="cpu")
    with _SafeLoadsOnly(monkeypatch), pytest.raises(AssertionError, match="weights_only=False"):
        torch.export.load(io.BytesIO(data))


class _Record(TorchDispatchMode):
    """Every call of an rpt operator with its inputs and real results."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "rpt":
            self.calls.setdefault((func, tuple(a for a in args if not torch.is_tensor(a))),
                                  (args, kwargs or {}, out))
        return out


@pytest.fixture(scope="module")
def op_calls(scenes, tmp_path_factory):
    """Each operator's calls of 32x32 frames of textured, cubes, instances and
    a forced-large blob, and its counter variants."""
    from relativitypathtracer_tpu_torch.ops.kernels import analytic_kernels as ak
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk

    mesh_intersect.LARGE_MODE = True
    try:
        large = pt.build_scene(pt.load_scene_file(write_fixture(tmp_path_factory, 1, "blob")),
                               device="cpu")
    finally:
        mesh_intersect.LARGE_MODE = None
    rec = _Record()
    with rec:
        for scene, meta in (*scenes.values(), large):
            pt.build_render_fn(meta, 32, 32, -1, device="cpu")(scene, _state(1))
        dir4 = torch.nn.functional.normalize(torch.randn(4, 64), dim=0)
        params = torch.randn(2, ak.PARAM_COLS)
        ak.analytic_nearest_shared(params, dir4, 1, 1, tested=torch.zeros(1, dtype=torch.int32))
        ak.analytic_min_t_general(params, dir4, dir4, 1, 1, torch.ones(64),
                                  tested=torch.zeros(1, dtype=torch.int32))
        spheres = torch.rand(40, 4)
        table = mk.cone_table(torch.randn(3, 1024), torch.zeros(3, 1024))
        mk.live_cull(spheres, table, skipped=torch.zeros(1, dtype=torch.int32))
        mk.live_cull(spheres, table, s=8, n_words=2, floors=False)
    return rec.calls


def test_every_operator_is_called(op_calls):
    names = {func._opname for func, _ in op_calls}
    assert names == {name[len("rpt_"):] for name in _build._SIGNATURES}


def test_fake_results_match_the_real_results(op_calls):
    for (func, _), (args, kwargs, out) in op_calls.items():
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake_args = [mode.from_tensor(a) if torch.is_tensor(a) else a for a in args]
            fake = func(*fake_args, **kwargs)
        outs = (out,) if torch.is_tensor(out) else out
        fakes = (fake,) if torch.is_tensor(fake) else fake
        assert len(outs) == len(fakes), func
        for o, f in zip(outs, fakes):
            assert (o.shape, o.dtype) == (f.shape, f.dtype), (func, o.shape, f.shape)


def test_export_tool_selfcheck_on_the_cpu(tmp_path):
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("XLA_FLAGS", None)
    out = tmp_path / "textured.pt2"
    scene = write_demo_scene(str(tmp_path), 2, "textured")
    proc = subprocess.run(
        [sys.executable, "tools/export_renderer_torch.py", "--scene", scene, "--size", "64x48",
         "--device", "cpu", "--out", str(out), "--selfcheck"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("equals the live frame") == 2 and out.stat().st_size > 0


def test_export_defaults_to_the_card(scenes):
    """Without a card, an export on the default device raises instead of
    tracing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    scene, meta = scenes["cubes"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aot.export_render(scene, meta, W, H)
