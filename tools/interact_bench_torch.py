#!/usr/bin/env python3
"""Interactive bench of the port's web viewer: HTTP keys in, JPEG frames out.

    python tools/interact_bench_torch.py [--scene textured] [--size 960x540]
        [--frames N] [--window 3.0] [--stream-scale 1|2|4] [--device cuda|cpu]
        [--out build/interact]

The counterpart of tools/interact_bench.py, with its protocol in its order.
It builds viewer.ViewerCore on the scene (a scene file, a fixture kind of
utils/demo_scene at level 4, or a corpus name under $REF_ASSETS/Scenes:
utils.parity.scene_file), then, on this thread and before the server
starts, times the core's current viewer renderer at its pad with the core's
dirs (device_frame_ms: CUDA events, utils.timing.cuda_frame_times_ms; on a
CPU device the host clock, and "platform": "cpu") and encode_jpeg on 20 of
the core's frames (encode_ms_p50). Then it serves viewer.run_web on port 0
from a thread of its own and acts as a scripted browser:

  1. settle 1 s;
  2. idle fps over --window s, counted by /stats["frame"];
  3. 5 space presses, each timed until /stats["paused"] flips;
  4. reset ('r'), then 'w' timed until /stats["speed_c"] > 0;
  5. flying fps over --window s with 'w' held;
  6. a shrink to (max(w/2, 64), max(h/2, 64)), timed until /stats["size"]
     shows it, and back;
  7. a grow past the pad to (w + 64, h + 64): a new viewer renderer and its
     graph's capture on the server's thread (the counterpart of the JAX
     tool's compile), timed, and back.

It prints one JSON line and writes it to DIR/interact.json: the JAX tool's
keys (scene, size, platform ("gpu" on the card), idle_fps, flying_fps,
device_frame_ms, device_fps, stream_scale, key_latency_ms_space_p50,
key_latency_ms_space_all, key_latency_ms_w, resize_latency_ms_first,
resize_latency_ms_grow_pad, frames_counted, cadence_cap_fps) plus device
(the card's name) and encode_ms_p50. The JPEGs it pulled while counting
frames are written as DIR/frame_NNN.jpg and, decoded by
utils/image_decode.decode_jpeg, as the session's GIF, DIR/session.gif
(utils/image.write_gif, 120 ms a frame, as the JAX tool's).

Only the server's render loop touches the device while the server runs:
every graph of a card shares one memory pool (utils/frame_graph), so
replays must run one after another from one thread, and a capture (the
grow past the pad) fails if another thread makes a CUDA call meanwhile.
This tool's own thread only speaks HTTP then. Calling into the card from a
second thread while the server runs breaks that rule.

Without a CUDA device it exits 1 unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import threading
import time
import urllib.request

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

DEVICE_FRAMES = 60  # timed device frames, after 5 warm-up frames
ENCODE_FRAMES = 20  # frames encode_jpeg is timed on
GIF_SAMPLES = 12  # JPEGs pulled per fps window, as the JAX tool's GIF frames
GIF_FPS = 8.0  # write_gif's delay int(1000 / fps) // 10 = 12 cs: the JAX tool's 120 ms


def _post(port, path):
    urllib.request.urlopen(
        urllib.request.Request(f"http://127.0.0.1:{port}{path}", method="POST"),
        timeout=5).read()


def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return json.loads(r.read())


def _get_frame(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/frame", timeout=10) as r:
        return r.read()


def _await_stats(port, pred, timeout_s=5.0, poll_s=0.002):
    """Poll /stats until pred(stats) holds; returns elapsed seconds."""
    t0 = time.perf_counter()
    while True:
        if pred(_get_json(port, "/stats")):
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout_s:
            raise TimeoutError("stats predicate never held")
        time.sleep(poll_s)


def _await_released(port):
    """Wait until a frame began after a key-up: the render loop reads the
    held keys once a frame, so a press that comes before then would meet no
    key edge (a slow frame, as on a CPU device, would otherwise hide it)."""
    up = _get_json(port, "/stats")["frame"]
    _await_stats(port, lambda s: s["frame"] >= up + 2)


def _count_frames(port, seconds, jpegs):
    """Frames rendered over a window, by the viewer's monotone frame counter
    (stats["frame"]), pulling GIF_SAMPLES JPEGs on the way."""
    start = _get_json(port, "/stats")["frame"]
    deadline = time.perf_counter() + seconds
    next_pull = 0.0
    while time.perf_counter() < deadline:
        now = time.perf_counter()
        if now >= next_pull:
            jpegs.append(_get_frame(port))
            next_pull = now + seconds / GIF_SAMPLES
        time.sleep(0.02)
    return _get_json(port, "/stats")["frame"] - start


def _device_frame_ms(core, on_card: bool) -> list:
    """Ascending ms of the core's current viewer renderer at its pad, with
    its dirs: CUDA events on the card, the host clock on a CPU device."""
    from relativitypathtracer_tpu_torch.render import FrameState
    from relativitypathtracer_tpu_torch.utils.timing import cuda_frame_times_ms

    render = core._get_render(core.sim.interval)
    state = FrameState(core.sim.frame.cam_velocity.to(core.device),
                       core.sim.frame.cam_pos.to(core.device))

    def frame(scene, st):
        return render(scene, st, core._dirs)

    if on_card:
        return cuda_frame_times_ms(frame, core.scene, state, frames=DEVICE_FRAMES)
    for _ in range(5):
        frame(core.scene, state)
    times = []
    for _ in range(DEVICE_FRAMES):
        t0 = time.perf_counter()
        frame(core.scene, state)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)


def main(argv=None) -> int:
    import torch

    from relativitypathtracer_tpu_torch.device import DEFAULT_DEVICE

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="textured",
                    help="a scene file, a fixture kind or a corpus name (default textured)")
    ap.add_argument("--size", default="960x540", help="the reference's window size")
    ap.add_argument("--frames", type=int, default=None,
                    help="cap render-loop frames (default: until the protocol ends)")
    ap.add_argument("--window", type=float, default=3.0,
                    help="seconds per fps measurement segment")
    ap.add_argument("--stream-scale", type=int, default=1, choices=(1, 2, 4),
                    help="box-filter the frame on the device by this factor before the fetch")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help=f"torch device (default {DEFAULT_DEVICE})")
    ap.add_argument("--out", default=str(REPO / "build" / "interact"),
                    help="directory for interact.json and the frames")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("Error: no CUDA device (pass --device cpu to run the plain twins)",
              file=sys.stderr)
        return 1
    from relativitypathtracer_tpu_torch.cli import _parse_size
    from relativitypathtracer_tpu_torch.models.dsl import load_scene_file
    from relativitypathtracer_tpu_torch.utils.image import encode_jpeg, write_gif
    from relativitypathtracer_tpu_torch.utils.image_decode import decode_jpeg
    from relativitypathtracer_tpu_torch.utils.parity import scene_file
    from relativitypathtracer_tpu_torch.utils.timing import percentile
    from relativitypathtracer_tpu_torch.viewer import MIN_FRAME_S, ViewerCore, run_web

    w, h = _parse_size(args.size)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for old in out.glob("frame_*.jpg"):  # an earlier run's frames
        old.unlink()
    print(f"building the viewer core {w}x{h} ({args.scene}, {args.device}) ...", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        host = load_scene_file(scene_file(args.scene, tmp))
    core = ViewerCore(host, w, h, stream_scale=args.stream_scale, device=dev)

    # the renderer alone, then the encoder alone: on this thread, before the
    # server's render loop takes the device
    device_ms = percentile(_device_frame_ms(core, on_card), 50)
    encode_ms = []
    for _ in range(ENCODE_FRAMES):
        img = core.frame(set())
        t0 = time.perf_counter()
        encode_jpeg(img)
        encode_ms.append((time.perf_counter() - t0) * 1e3)
    encode_ms.sort()

    ready, stop, port_box = threading.Event(), threading.Event(), {}

    def on_ready(p):
        port_box["port"] = p
        ready.set()

    server = threading.Thread(target=run_web, args=(core,), daemon=True, kwargs=dict(
        port=0, max_frames=args.frames, on_ready=on_ready, stop_event=stop))
    server.start()
    if not ready.wait(60):
        raise RuntimeError("the web viewer never came up")
    port = port_box["port"]
    print(f"viewer live on :{port}", flush=True)

    jpegs: list = []
    result = {"scene": args.scene, "size": [w, h],
              "platform": "gpu" if on_card else dev.type}
    try:
        time.sleep(1.0)  # settle

        t0 = time.perf_counter()
        n0 = _count_frames(port, args.window, jpegs)
        idle_fps = n0 / (time.perf_counter() - t0)

        lat_space = []
        for _ in range(5):
            paused = _get_json(port, "/stats")["paused"]
            _post(port, "/key?c=%20&d=1")
            dt = _await_stats(port, lambda s, p=paused: s["paused"] != p)
            _post(port, "/key?c=%20&d=0")
            lat_space.append(dt * 1e3)
            _await_released(port)
            time.sleep(0.15)
        if _get_json(port, "/stats")["paused"]:  # fly unpaused
            _post(port, "/key?c=%20&d=1")
            _await_stats(port, lambda s: not s["paused"])
            _post(port, "/key?c=%20&d=0")

        _post(port, "/key?c=r&d=1")  # reset the velocity first
        _await_stats(port, lambda s: s["speed_c"] == 0.0)
        _post(port, "/key?c=r&d=0")
        _post(port, "/key?c=w&d=1")
        lat_w = _await_stats(port, lambda s: s["speed_c"] > 0.0) * 1e3

        t0 = time.perf_counter()
        n1 = _count_frames(port, args.window, jpegs)
        fly_fps = n1 / (time.perf_counter() - t0)
        _post(port, "/key?c=w&d=0")
        _post(port, "/key?c=r&d=1")
        _post(port, "/key?c=r&d=0")

        w2, h2 = max(w // 2, 64), max(h // 2, 64)  # within the pad: new dirs only
        _post(port, f"/resize?w={w2}&h={h2}")
        lat_resize = _await_stats(port, lambda s: s["size"] == [w2, h2], timeout_s=240) * 1e3
        _post(port, f"/resize?w={w}&h={h}")
        _await_stats(port, lambda s: s["size"] == [w, h], timeout_s=240)
        w3, h3 = w + 64, h + 64  # past the pad: a new renderer and its capture
        _post(port, f"/resize?w={w3}&h={h3}")
        lat_grow = _await_stats(port, lambda s: s["size"] == [w3, h3], timeout_s=240) * 1e3
        _post(port, f"/resize?w={w}&h={h}")
        _await_stats(port, lambda s: s["size"] == [w, h], timeout_s=240)

        result.update({
            "idle_fps": round(idle_fps, 2),
            "flying_fps": round(fly_fps, 2),
            "device_frame_ms": round(device_ms, 3),
            "device_fps": round(1e3 / device_ms, 1),
            "stream_scale": args.stream_scale,
            "key_latency_ms_space_p50": round(sorted(lat_space)[2], 2),
            "key_latency_ms_space_all": [round(x, 2) for x in lat_space],
            "key_latency_ms_w": round(lat_w, 2),
            "resize_latency_ms_first": round(lat_resize, 2),
            "resize_latency_ms_grow_pad": round(lat_grow, 2),
            "frames_counted": n0 + n1,
            "cadence_cap_fps": round(1.0 / MIN_FRAME_S, 1),
            "device": torch.cuda.get_device_name(dev) if on_card else dev.type,
            "encode_ms_p50": round(percentile(encode_ms, 50), 3),
        })
    finally:
        stop.set()
        server.join(timeout=30)
    if server.is_alive():
        raise RuntimeError("the web viewer did not stop")

    for k, jpeg in enumerate(jpegs):
        (out / f"frame_{k:03d}.jpg").write_bytes(jpeg)
    (out / "session.gif").unlink(missing_ok=True)
    if jpegs:  # write_gif takes bottom-up frames; the decodes are top-down
        write_gif(str(out / "session.gif"), [decode_jpeg(j)[::-1] for j in jpegs], GIF_FPS)
    (out / "interact.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    print(f"wrote {out / 'interact.json'}, {len(jpegs)} frames and their GIF", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
