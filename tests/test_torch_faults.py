"""Faults of the port found against the reference, pinned on the CPU.

- An index-less CUDA device ("cuda", torch.device("cuda")) is resolved once,
  at build, to the card current then (`device.resolve`): the cached
  renderer's key, the viewer renderer's and FrameGraph's device name one
  card, whichever card is current at a later call. On the CPU the device is
  left as it is, and "cpu" and torch.device("cpu") share one cached
  renderer. (The card case, a renderer built on card 1, is in
  tests/test_torch_cuda.py.)
- The parity CLI: no scene and `all` both run the fixture kinds
  (utils/demo_scene.KINDS), where the JAX package's run its corpus; a
  corpus name resolves under $REF_ASSETS/Scenes when the file is there and
  raises FileNotFoundError when it is not.
"""

import pytest
import torch

from relativitypathtracer_tpu_torch import device as pdevice
from relativitypathtracer_tpu_torch import render as prender
from relativitypathtracer_tpu_torch.models.dsl import load_scene_file, parse_scene
from relativitypathtracer_tpu_torch.models.scene import build_scene
from relativitypathtracer_tpu_torch.utils import parity
from relativitypathtracer_tpu_torch.utils.demo_scene import KINDS
from relativitypathtracer_tpu_torch.utils.frame_graph import FrameGraph

SCENE = """
Os
 p0,3,6,0,0,1,0,0.3,0.3,0.3
 c1,1,1
 l1
Oc
 p0,-1,5,0,0,1,0,1,1,1
 c0.8,0.2,0.2
R
"""


@pytest.fixture
def card_3(monkeypatch):
    """torch reports card 3 as the current one."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)


def test_resolve_names_the_current_card(card_3):
    for dev in ("cuda", torch.device("cuda")):
        assert pdevice.resolve(dev) == torch.device("cuda", 3)
    assert pdevice.resolve("cuda:1") == torch.device("cuda", 1)
    for dev in ("cpu", torch.device("cpu")):
        assert pdevice.resolve(dev) == torch.device("cpu")


def test_renderers_resolve_the_card_at_build(card_3, monkeypatch):
    """build_render_fn keys its cache by the resolved card; the viewer's
    renderer and FrameGraph keep it (no tensor is made: the cached renderer
    factory and the viewer's constants are stubbed, as there is no card
    here)."""
    keys = []
    monkeypatch.setattr(prender, "_cached_render_fn", lambda *args: keys.append(args[-1]))
    meta = build_scene(parse_scene(SCENE), device="cpu")[1]
    prender.build_render_fn(meta, 32, 24, -1, device="cuda")
    prender.build_render_fn(meta, 32, 24, -1, device=torch.device("cuda"))
    assert keys == [torch.device("cuda", 3)] * 2
    assert FrameGraph(lambda: None, "cuda").device == torch.device("cuda", 3)
    made = []
    monkeypatch.setattr(prender, "mesh_perm_tensors", lambda meta, dev: made.append(dev))
    monkeypatch.setattr(prender.torch, "tensor", lambda *a, device=None, **k: (
        made.append(device), torch.zeros(3))[1])
    render = prender.build_viewer_render_fn(meta, 32, 32, -1, device="cuda")
    assert made == [torch.device("cuda", 3)] * 2 and render.device == torch.device("cuda", 3)


def test_cpu_renderer_is_cached_once_for_both_spellings():
    meta = build_scene(parse_scene(SCENE), device="cpu")[1]
    a = prender.build_render_fn(meta, 32, 24, -1, device="cpu")
    assert prender.build_render_fn(meta, 32, 24, -1, device=torch.device("cpu")) is a
    assert a.device == torch.device("cpu")


def test_parity_cli_all_runs_the_fixture_kinds(monkeypatch):
    """main([]) and main(["all"]) take the fixture kinds, in their order; the
    device check passes as on a card (fullres_parity is stubbed)."""
    ran = []

    def fake(name, device=None, **kw):
        ran.append((name, device))
        return {"scene": name, "frac_bad": 0.0, "mean_diff": 0.0, "ok": True}

    monkeypatch.setattr(parity, "fullres_parity", fake)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for argv in ([], ["all"]):
        ran.clear()
        assert parity.main(argv) == 0
        assert ran == [(kind, "cuda") for kind in KINDS]
    ran.clear()
    assert parity.main(["cubes", "--device", "cpu"]) == 0 and ran == [("cubes", "cpu")]


def test_parity_scene_file_finds_a_corpus_scene(tmp_path, monkeypatch):
    scenes = tmp_path / "ref" / "Scenes"
    scenes.mkdir(parents=True)
    (scenes / "bunny.txt").write_text(SCENE)
    monkeypatch.setattr(parity, "REF", str(tmp_path / "ref"))
    assert parity.scene_file("bunny", str(tmp_path)) == str(scenes / "bunny.txt")
    with pytest.raises(FileNotFoundError):
        parity.scene_file("shadows", str(tmp_path))
    monkeypatch.setattr(parity, "REF", None)
    with pytest.raises(FileNotFoundError):
        parity.scene_file("bunny", str(tmp_path))
    fixture = parity.scene_file("blob", str(tmp_path))  # a fixture kind is written
    assert fixture.startswith(str(tmp_path)) and load_scene_file(fixture).objects
