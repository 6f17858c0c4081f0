"""The interactive bench (tools/interact_bench_torch.py) on the CPU: its
`main` at 128x96 on a small textured fixture, the web viewer over real HTTP
on port 0, under a time limit of its own. The JSON carries the JAX tool's
keys (tools/interact_bench.py) plus `device` and `encode_ms_p50`; both
resizes are reached (at 128x96 the shrink goes to 64x64 and the grow past
the pad to 192x160); the pulled frames are JPEGs that PIL decodes, and
session.gif, made from their decodes, holds one frame each."""

import importlib.util
import io
import json
import pathlib
import threading

from PIL import Image

from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_KEYS = {"scene", "size", "platform", "idle_fps", "flying_fps", "device_frame_ms",
            "device_fps", "stream_scale", "key_latency_ms_space_p50",
            "key_latency_ms_space_all", "key_latency_ms_w", "resize_latency_ms_first",
            "resize_latency_ms_grow_pad", "frames_counted", "cadence_cap_fps"}
TIME_LIMIT_S = 240


def _tool():
    spec = importlib.util.spec_from_file_location(
        "interact_bench_torch", REPO / "tools" / "interact_bench_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_interact_bench_on_the_cpu(tmp_path):
    scene = write_demo_scene(str(tmp_path / "fx"), 1, "textured")
    out = tmp_path / "interact"
    tool, rc = _tool(), []
    run = threading.Thread(target=lambda: rc.append(tool.main([
        "--device", "cpu", "--size", "128x96", "--window", "0.3", "--scene", scene,
        "--out", str(out)])), daemon=True)
    run.start()
    run.join(TIME_LIMIT_S)
    assert not run.is_alive(), f"the bench did not end within {TIME_LIMIT_S} s"
    assert rc == [0]
    res = json.loads((out / "interact.json").read_text())
    assert set(res) == JAX_KEYS | {"device", "encode_ms_p50"}
    assert res["size"] == [128, 96] and res["platform"] == "cpu" and res["device"] == "cpu"
    assert res["idle_fps"] > 0 and res["flying_fps"] > 0 and res["device_fps"] > 0
    assert res["frames_counted"] > 0 and res["encode_ms_p50"] > 0
    assert len(res["key_latency_ms_space_all"]) == 5 and res["key_latency_ms_w"] > 0
    # _await_stats raises unless the size was reached: both latencies exist
    assert res["resize_latency_ms_first"] > 0 and res["resize_latency_ms_grow_pad"] > 0
    frames = sorted(out.glob("frame_*.jpg"))
    assert frames
    for path in frames:
        img = Image.open(io.BytesIO(path.read_bytes()))
        img.load()
        assert img.format == "JPEG" and img.mode == "RGB" and img.size == (128, 96)
    with Image.open(out / "session.gif") as gif:
        assert gif.format == "GIF" and gif.size == (128, 96) and gif.n_frames == len(frames)
        assert gif.info["duration"] == 120
