"""The port's interactive viewer path against the JAX package's.

- `utils/framestate.step` and `add_velocity_np` bit for bit with the JAX
  package's over a seeded 200-frame key timeline; `ops/relmath.add_velocity`
  within rtol 1e-6, atol 1e-7 of the JAX package's jnp form (XLA contracts
  products into FMAs).
- `render.build_viewer_render_fn` (dirs as an argument over a padded grid)
  against `build_render_fn(out_uint8=True)` byte for byte at 64x48 and
  96x64 on the textured fixture; its pool against numpy's box mean.
- `viewer.ViewerCore` on the CPU against the JAX package's ViewerCore on one
  timeline: the JAX core returns the previous state's frame (its one-frame
  device pipeline), the port's the current one, so the port's frame k is
  held to the JAX core's frame k + 1: at most 0.2% of pixels off by more
  than 1 lsb (the parity rule's share; the two packages' floats differ in
  the last bits, which truncation to uint8 can turn into 1 lsb).
- The frame after a resize (within the pad and growing it) is the new
  size's frame of the current state: no stale frame.
- stream_scale pooling within 1.5 lsb of host pooling (the JAX package's
  rule), the size snap, and the ValueError with msaa > 1.
- The web front end end to end over HTTP on port 0 (its served frame, from
  utils/image.encode_jpeg, decoded by PIL), and run_window with
  SDL_VIDEODRIVER=dummy.
"""

import io
import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_port_fixtures import build_both, write_fixture

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch import render as prender
from relativitypathtracer_tpu_torch import viewer
from relativitypathtracer_tpu_torch.utils import framestate as fs
from relativitypathtracer_tpu_torch.viewer import KEY_CHARS, ViewerCore, run_web, run_window

# Tiny asset-free scene: a sphere light and a coloured cube (the JAX
# package's viewer tests use the same).
SCENE = """
Os
 p0,3,6,0,0,1,0,0.3,0.3,0.3
 c1,1,1
 l1
Oc
 p0,-1,5,0,0,1,0,1,1,1
 c0.8,0.2,0.2
A0.3
W2,2,2
R
"""


def _core(w=64, h=48, **kw):
    return ViewerCore(pt.parse_scene(SCENE), w, h, device="cpu", **kw)


def _static(core, w, h, msaa=1):
    """The static renderer's uint8 frame of the core's current state,
    flipped to display order."""
    return prender.build_render_fn(core.meta, w, h, core.sim.interval, msaa, out_uint8=True,
                                   device="cpu")(core.scene, core.sim.frame).numpy()[::-1]


def _timeline(n, seed=17):
    """n frames of (held keys, frame_ms): random holds of wasdqe, space and i
    taps, an occasional r; frame_ms 5-40."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        keys = rng.uniform(size=9) < np.array([0.4, 0.2, 0.2, 0.2, 0.1, 0.1, 0.05, 0.1, 0.1])
        out.append((keys.tolist(), float(rng.uniform(5.0, 40.0))))
    return out


def test_step_matches_jax_bit_for_bit():
    from relativitypathtracer_tpu.utils import framestate as jfs

    sim, jsim = fs.SimState.initial(-1, device="cpu"), jfs.SimState.initial(-1)
    for keys, ms in _timeline(200):
        sim, jsim = fs.step(sim, keys, ms), jfs.step(jsim, keys, ms)
        for got, want in ((sim.frame.cam_velocity, jsim.frame.cam_velocity),
                          (sim.frame.cam_pos, jsim.frame.cam_pos)):
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            assert np.array_equal(got.numpy().view(np.int32),
                                  np.asarray(want, np.float32).view(np.int32))
        assert (sim.paused, sim.interval, sim.prev_space, sim.prev_i) == (
            jsim.paused, jsim.interval, jsim.prev_space, jsim.prev_i)
    assert float(np.linalg.norm(sim.frame.cam_velocity.numpy())) > 0.0


def test_add_velocity_np_matches_jax_bit_for_bit():
    from relativitypathtracer_tpu.utils.framestate import add_velocity_np as jax_np

    rng = np.random.default_rng(3)
    for _ in range(200):
        v1 = rng.normal(size=3)
        v1 = (v1 * rng.uniform(0.0, 0.95) / np.linalg.norm(v1)).astype(np.float32)
        v2 = (rng.normal(size=3) * 0.05).astype(np.float32)
        assert np.array_equal(fs.add_velocity_np(v1, v2).view(np.int32),
                              jax_np(v1, v2).view(np.int32))


def test_add_velocity_matches_jax():
    from relativitypathtracer_tpu.ops.relmath import add_velocity as jax_add

    from relativitypathtracer_tpu_torch.ops.relmath import add_velocity

    rng = np.random.default_rng(4)
    v1 = rng.normal(size=(64, 3)).astype(np.float32)
    v1 *= (rng.uniform(0.0, 0.95, (64, 1)) / np.linalg.norm(v1, axis=1, keepdims=True)).astype(
        np.float32)
    v2 = (rng.normal(size=(64, 3)) * 0.1).astype(np.float32)
    got = add_velocity(torch.as_tensor(v1), torch.as_tensor(v2)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_add(jnp.asarray(v1), jnp.asarray(v2))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[0], fs.add_velocity_np(v1[0], v2[0]), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def textured(tmp_path_factory):
    return build_both(write_fixture(tmp_path_factory, 3, "textured"))[1]


@pytest.mark.parametrize("size", [(64, 48), (96, 64)])
def test_viewer_renderer_matches_static_renderer(textured, size):
    ps, pm = textured
    w, h = size
    state = prender.FrameState(torch.tensor([0.3, 0.0, 0.1]), torch.tensor([0.5, 0.0, 0.0, 0.0]))
    ph, pw = prender._round_up(h, prender.TILE), prender._round_up(w, prender.TILE)
    want = prender.build_render_fn(pm, w, h, -1, out_uint8=True, device="cpu")(ps, state)
    got = prender.build_viewer_render_fn(pm, ph, pw, -1, device="cpu")(
        ps, state, prender.viewer_dirs(w, h, ph, pw, device="cpu"))
    assert got.dtype == torch.uint8 and got.shape == (ph, pw, 3)
    assert torch.equal(got[:h, :w], want)
    assert int(want.max()) > 0


def test_viewer_renderer_checks_pad_and_pool(textured):
    _, pm = textured
    with pytest.raises(ValueError, match="aligned"):
        prender.build_viewer_render_fn(pm, 48, 64, -1, device="cpu")
    with pytest.raises(ValueError, match="pool"):
        prender.build_viewer_render_fn(pm, 64, 64, -1, pool=3, device="cpu")


@pytest.mark.parametrize("pool", [2, 4])
def test_box_pool_matches_numpy_mean(pool):
    img = torch.as_tensor(np.random.default_rng(pool).uniform(0, 1, (32, 64, 3)).astype(
        np.float32))
    want = img.numpy().astype(np.float64).reshape(32 // pool, pool, 64 // pool, pool, 3).mean(
        axis=(1, 3))
    np.testing.assert_allclose(prender.box_pool(img, pool).numpy(), want, rtol=0, atol=1e-6)


def test_uint8_pack_truncates():
    img = torch.tensor([[[-0.5, 0.0, 0.999], [1.0 / 255.0, 0.5, 2.0]]])
    assert prender.to_uint8(img).tolist() == [[[0, 0, 254], [1, 127, 255]]]


def test_core_matches_jax_core_a_frame_ahead():
    """The same keys and timestamps through both cores; the JAX core's frame
    k + 1 is the image of the state it stepped at frame k."""
    from relativitypathtracer_tpu.models.dsl import parse_scene as jparse
    from relativitypathtracer_tpu.viewer import ViewerCore as JaxCore

    port, jax_core = _core(), JaxCore(jparse(SCENE), 64, 48)
    timeline = [(set(), 0.0), ({"w"}, 0.015), ({"w", " "}, 0.030), ({"w"}, 0.045),
                ({"d", "e"}, 0.060), ({"i"}, 0.075), (set(), 0.090), ({"s"}, 0.105),
                ({"r"}, 0.120), (set(), 0.135)]
    got = [port.frame(k, now_s=t) for k, t in timeline]
    want = [jax_core.frame(k, now_s=t) for k, t in timeline]
    for k in range(len(timeline) - 1):
        a, b = got[k].astype(np.int16), want[k + 1].astype(np.int16)
        assert a.shape == b.shape == (48, 64, 3)
        off = np.abs(a - b).max(axis=-1) > 1
        assert off.mean() <= 0.002, f"frame {k}: {off.mean():.4%} pixels off by more than 1 lsb"
    assert port.stats()["interval"] == 0 and port.stats()["speed_c"] == 0.0


def test_frame_is_the_current_state_and_resize_has_no_stale_frame():
    core = _core(96, 64)
    core.frame(set(), now_s=1.0)
    img = core.frame({"w"}, now_s=1.016)  # the frame of the state just stepped
    assert np.array_equal(img, _static(core, 96, 64))
    core.request_resize(64, 48)  # within the pad: only the dirs change
    renders = set(core._renders)
    img = core.frame({"w"}, now_s=1.032)
    assert set(core._renders) == renders and core._pad == (64, 96)
    assert img.shape == (48, 64, 3) and np.array_equal(img, _static(core, 64, 48))
    core.request_resize(128, 96)  # grows the pad: a new renderer, this frame
    img = core.frame(set(), now_s=1.048)
    assert core._pad == (96, 128) and img.shape == (96, 128, 3)
    assert np.array_equal(img, _static(core, 128, 96))


def test_msaa_core_renders_the_static_frame():
    core = _core(msaa=2)
    core.frame(set(), now_s=0.0)
    img = core.frame({"a"}, now_s=0.02)
    assert img.shape == (48, 64, 3) and np.array_equal(img, _static(core, 64, 48, msaa=2))


def test_stream_scale_pools_on_the_device():
    full, pooled = _core(64, 64), _core(64, 64, stream_scale=2)
    a = full.frame(set(), now_s=1.0)
    b = pooled.frame(set(), now_s=1.0)
    assert b.shape == (32, 32, 3)
    host_pool = a.astype(np.float32).reshape(32, 2, 32, 2, 3).mean((1, 3))
    # pooling precedes the uint8 truncation on the device
    assert np.abs(host_pool - b.astype(np.float32)).max() <= 1.5


def test_stream_scale_requires_msaa1():
    with pytest.raises(ValueError, match="stream_scale"):
        _core(64, 64, msaa=2, stream_scale=2)


def test_resize_snaps_to_stream_scale():
    core = _core(65, 49, stream_scale=2)
    assert (core.width, core.height) == (64, 48)
    core.frame(set(), now_s=1.0)
    core.resize(97, 65)
    assert (core.width, core.height) == (96, 64)
    assert core.frame(set(), now_s=1.016).shape == (32, 48, 3)


def test_compiling_is_set_while_a_renderer_warms(monkeypatch):
    core = _core()
    seen = []
    real = prender.build_viewer_render_fn

    def spy(*a, **kw):
        render = real(*a, **kw)

        def wrapped(*args):
            seen.append(core.stats()["compiling"])
            return render(*args)

        return wrapped

    monkeypatch.setattr(viewer, "build_viewer_render_fn", spy)
    core.request_resize(128, 96)
    core.frame(set(), now_s=0.0)
    assert seen[0] is True and seen[-1] is False and not core.stats()["compiling"]


def test_keys_and_stats():
    core = _core()
    assert KEY_CHARS == "wasdqer i" and core.stats()["frame"] == 0
    core.frame({" "}, now_s=0.0)
    core.frame({"w"}, now_s=0.1)
    s = core.stats()
    assert s["frame"] == 2 and not s["paused"] and s["speed_c"] > 0 and s["time_s"] == 0.1
    assert set(s) >= {"fps", "paused", "interval", "speed_c", "time_s", "size", "compiling"}


def test_web_frontend_end_to_end():
    core = _core()
    stop, ready, port_holder = threading.Event(), threading.Event(), {}

    def on_ready(port):
        port_holder["port"] = port
        ready.set()

    t = threading.Thread(target=run_web, kwargs=dict(core=core, port=0, on_ready=on_ready,
                                                     stop_event=stop), daemon=True)
    t.start()
    assert ready.wait(30)
    base = f"http://127.0.0.1:{port_holder['port']}"

    def post(path):
        urllib.request.urlopen(urllib.request.Request(base + path, method="POST"), timeout=10)

    def stats_when(cond):
        deadline, stats = time.monotonic() + 20, {}
        while time.monotonic() < deadline:
            stats = json.loads(urllib.request.urlopen(f"{base}/stats", timeout=10).read())
            if cond(stats):
                break
            time.sleep(0.05)
        return stats

    try:
        assert b"Relativistic Ray Tracer" in urllib.request.urlopen(f"{base}/", timeout=10).read()
        jpeg = urllib.request.urlopen(f"{base}/frame", timeout=30).read()
        assert jpeg[:2] == b"\xff\xd8"
        served = Image.open(io.BytesIO(jpeg))
        assert served.mode == "RGB" and served.size == (64, 48)
        post("/key?c=w&d=1")
        stats = stats_when(lambda s: s["speed_c"] > 0)
        post("/key?c=*&d=0")
        assert stats["speed_c"] > 0 and stats["size"] == [64, 48]
        post("/resize?w=96&h=64")  # applied on the render-loop thread
        assert stats_when(lambda s: s["size"] == [96, 64])["size"] == [96, 64]
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()


def test_window_frontend_smoke(monkeypatch):
    pygame = pytest.importorskip("pygame")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    core = _core()
    pygame.display.init()
    pygame.display.set_mode((64, 48))
    for ev in (pygame.event.Event(pygame.KEYDOWN, key=pygame.K_w),
               pygame.event.Event(pygame.KEYDOWN, key=pygame.K_SPACE),
               pygame.event.Event(pygame.VIDEORESIZE, w=96, h=64)):
        pygame.event.post(ev)
    try:
        assert run_window(core, max_frames=3) == 0
        assert (core.width, core.height) == (96, 64)
        assert core.stats()["speed_c"] > 0 and not core.sim.paused
        pygame.display.init()
        pygame.display.set_mode((96, 64))
        pygame.event.post(pygame.event.Event(pygame.QUIT))
        assert run_window(core, max_frames=100) == 0
    finally:
        pygame.quit()


def test_viewer_modules_import_without_jax():
    code = ("import sys, relativitypathtracer_tpu_torch.viewer, "
            "relativitypathtracer_tpu_torch.utils.parity, "
            "relativitypathtracer_tpu_torch.utils.scene_blob, "
            "relativitypathtracer_tpu_torch.utils.timing, "
            "relativitypathtracer_tpu_torch.ops.octree_traverse; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.split('.')[0] == 'relativitypathtracer_tpu'); print(bad); sys.exit(bool(bad))")
    repo = str(pathlib.Path(__file__).resolve().parents[1])
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                          timeout=120, env={**os.environ, "PYTHONPATH": repo})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_viewer_main_on_the_cpu_and_without_a_card(tmp_path, monkeypatch, capsys):
    """`main` serves max_frames frames with --device cpu, and refuses the
    default device (the card) where there is none."""
    scene = tmp_path / "scene.txt"
    scene.write_text(SCENE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert viewer.main(["--scene", str(scene)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert viewer.main(["--scene", str(scene), "--device", "cpu", "--frontend", "web",
                        "--port", "0", "--max-frames", "2", "--size", "64x48"]) == 0
    assert "viewer: http://127.0.0.1:" in capsys.readouterr().out
