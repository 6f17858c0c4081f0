"""The interactive viewer: the reference's GLUT presentation layer
(gl_interop.cpp:10-72, Render.cpp:25-119) on the port's renderer.

Torch counterpart of `relativitypathtracer_tpu.viewer`. The reference opens a
960x540 window, redraws on a 15 ms timer and moves the camera from key
callbacks (wasdqe move, r reset, space pause, i interval toggle). Here:

- ViewerCore: the front-end-free loop. `frame(keys, now_s)` steps the
  SimState as the reference's render() callback does (frame_ms from the
  clock, Render.cpp:89-98) and returns the frame of the state it just
  stepped, top-down uint8. At msaa 1 the renderer works over a fixed padded
  grid (render.build_viewer_render_fn), so a resize within the pad only
  recomputes the camera dirs; the 'i' toggle swaps between renderers built
  and warmed at start-up. stream_scale > 1 box-filters the frame on the
  device before it is fetched.
- run_window(): a pygame window (pygame imported when it starts).
- run_web(): a localhost MJPEG streamer (stdlib http.server, the JPEG from
  utils/image.encode_jpeg, numpy only) with key capture in the browser.

The JAX package keeps one frame in flight (its frame() returns the previous
state's image, so a relay's fetch overlaps the next frame) and so serves one
stale frame after a resize; the port renders and returns the current frame.

Usage:
  python -m relativitypathtracer_tpu_torch.viewer --scene Scenes/cube.txt
      [--size 960x540] [--frontend auto|window|web] [--port 8734] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .cli import _parse_size
from .device import DEFAULT_DEVICE, resolve
from .models.dsl import SceneError, load_scene_file, parse_scene
from .models.obj_loader import ObjError
from .models.scene import build_scene
from .models.texture import TextureError
from .render import (
    TILE, FrameState, _round_up, build_render_fn, build_viewer_render_fn, viewer_dirs)
from .utils.framestate import SimState, step
from .utils.image import encode_jpeg

# Key order matches utils.framestate.KEY_* (w a s d q e r space i), which
# matches the reference's downKeys[9] (Render.cpp:9,25-86).
KEY_CHARS = "wasdqer i"

MIN_FRAME_S = 0.015  # the reference's 15 ms redisplay timer (gl_interop.cpp:69-72)


class ViewerCore:
    """Front-end-free interactive loop: the scene on `device`, its renderers
    and the SimState. The frames depend only on the scene and the (keys,
    timestamp) sequence fed to frame(). Only the thread that calls frame()
    touches the device; other threads call request_resize() and stats().
    All times are seconds."""

    def __init__(self, host_scene, width: int, height: int, msaa: int = 1,
                 stream_scale: int = 1, device=DEFAULT_DEVICE):
        self.device = resolve(device)  # one card, whichever thread renders
        self.scene, self.meta = build_scene(host_scene, device=self.device)
        self.msaa = int(msaa)
        self.stream_scale = int(stream_scale)
        # msaa 1 (the interactive default) renders over a padded grid with
        # the camera dirs as an argument; msaa > 1 builds a renderer a size.
        self._poly = self.msaa == 1
        if self.stream_scale > 1 and not self._poly:
            # pooling exists only on the padded-grid renderer; serving
            # full-size frames while stats report a stream_scale would lie
            raise ValueError("stream_scale > 1 requires msaa == 1")
        self.width, self.height = self._snap(width), self._snap(height)
        # the sim lives on the host: step() never touches the device
        self.sim = SimState.initial(self.meta.default_interval, device="cpu")
        self._prev_t: float | None = None
        self.compiling = False  # true while a renderer's first frame runs
        self.fps = 0.0  # EMA, like the reference's commented-out readout
        self.frame_count = 0  # monotone; lets clients count real frames
        self._pending_resize = None  # set by request_resize, applied in frame()
        self._renders: dict = {}
        self._stats = None
        if self._poly:
            self._pad = (_round_up(self.height, TILE), _round_up(self.width, TILE))
            self._set_dirs()
        # Build and warm every renderer the loop can reach without a resize
        # now, not on first use: the first launch loads the kernel library
        # (nvcc at the first use in a process). The 'i' toggle cycles the
        # default interval, 0 and -1 (utils.framestate.step).
        self._get_render(self.sim.interval)
        if self._poly:
            for iv in (0, -1):
                if iv != int(self.sim.interval):
                    self._get_render(iv)
        warm = step(self.sim, [True] + [False] * 8, 16.0)  # a moved camera
        self._render_dev(self._get_render(self.sim.interval), warm.frame)

    def _snap(self, v: int) -> int:
        """Round a logical dimension down to a stream_scale multiple: a ragged
        last pooled row or column would filter padding into the frame."""
        s = self.stream_scale
        return max((int(v) // s) * s, s)

    def _set_dirs(self) -> None:
        self._dirs = viewer_dirs(self.width, self.height, *self._pad, device=self.device)

    def _render_dev(self, render, frame_state):
        """One frame of `frame_state` on the device, fetched to the host:
        (rows, cols, 3) uint8, bottom-up, still padded on the msaa-1 path."""
        state = FrameState(frame_state.cam_velocity.to(self.device),
                           frame_state.cam_pos.to(self.device))
        if self._poly:
            return render(self.scene, state, self._dirs).cpu().numpy()
        return render(self.scene, state).cpu().numpy()

    def _get_render(self, interval: int):
        """The renderer of the current size (msaa > 1) or pad (msaa 1) and
        `interval`, built and warmed with one frame at its first use."""
        interval = int(interval)
        if self._poly:
            key = (self._pad, interval, self.stream_scale)
        else:
            key = (self.width, self.height, interval, self.msaa)
        render = self._renders.get(key)
        if render is None:
            if self._poly:
                render = build_viewer_render_fn(self.meta, *self._pad, interval,
                                                self.stream_scale, device=self.device)
            else:
                render = build_render_fn(self.meta, self.width, self.height, interval,
                                         self.msaa, out_uint8=True, device=self.device)
            self.compiling = True
            try:
                self._render_dev(render, self.sim.frame)
            finally:
                self.compiling = False
            self._renders[key] = render
        return render

    def resize(self, width: int, height: int) -> None:
        """Change the logical size (the reference's VBO re-allocation,
        Render.cpp:100-119). On the msaa-1 path a size within the pad
        recomputes only the camera dirs; a larger one grows the pad (never
        shrinks it) and builds its renderers. Call only from the thread that
        calls frame(); other threads use request_resize."""
        width, height = self._snap(width), self._snap(height)
        if (width, height) == (self.width, self.height) or width < 32 or height < 32:
            return
        self.width, self.height = width, height
        if self._poly:
            ph, pw = _round_up(height, TILE), _round_up(width, TILE)
            self._pad = (max(ph, self._pad[0]), max(pw, self._pad[1]))
            self._set_dirs()
        self._get_render(self.sim.interval)

    def request_resize(self, width: int, height: int) -> None:
        """Thread-safe resize request: stores the target size (one tuple
        write); the next frame() applies it on the render-loop thread."""
        self._pending_resize = (int(width), int(height))

    def frame(self, keys_down, now_s: float | None = None) -> np.ndarray:
        """Advance one frame and render it: keys_down holds the chars of
        KEY_CHARS now held. Returns the new state's frame, (H, W, 3) uint8
        top-down (display order); (H/s, W/s, 3) with stream_scale s."""
        if now_s is None:
            now_s = time.perf_counter()
        frame_ms = 0.0 if self._prev_t is None else max(0.0, (now_s - self._prev_t) * 1e3)
        self._prev_t = now_s

        keys = [c in keys_down for c in KEY_CHARS]
        self.sim = step(self.sim, keys, frame_ms)
        pr = self._pending_resize
        if pr is not None:
            self._pending_resize = None
            self.resize(*pr)
        render = self._get_render(self.sim.interval)
        t0 = time.perf_counter()
        out = self._render_dev(render, self.sim.frame)
        dt = time.perf_counter() - t0
        inst = 1.0 / max(dt, 1e-6)
        self.fps = inst if self.fps == 0.0 else 0.9 * self.fps + 0.1 * inst
        # stats() serves this snapshot, so front-end threads read no tensor
        vel = self.sim.frame.cam_velocity.numpy()
        self.frame_count += 1
        self._stats = {
            "fps": round(self.fps, 1),
            "frame": self.frame_count,
            "paused": bool(self.sim.paused),
            "interval": int(self.sim.interval),
            "speed_c": round(float(np.linalg.norm(vel)), 4),
            "time_s": round(float(self.sim.frame.cam_pos[0]), 3),
            "size": [self.width, self.height],
            "stream_scale": self.stream_scale,
        }
        # the padded (and pooled) frame is cropped to the logical size,
        # then flipped from GL's bottom-up rows to display order
        if self._poly:
            s = self.stream_scale
            out = out[:-(-self.height // s), :-(-self.width // s)]
        return out[::-1]

    def stats(self) -> dict:
        s = dict(self._stats or {
            "fps": 0.0, "frame": 0, "paused": bool(self.sim.paused),
            "interval": int(self.sim.interval), "speed_c": 0.0,
            "time_s": 0.0, "size": [self.width, self.height],
            "stream_scale": self.stream_scale,
        })
        s["compiling"] = bool(self.compiling)
        return s


# ---------------------------------------------------------------------------
# pygame window front end


def run_window(core: ViewerCore, max_frames: int | None = None) -> int:
    """A live pygame window, as the reference's GLUT loop: redisplay at
    >= 15 ms cadence, key-down/up tracking without auto-repeat
    (glutSetKeyRepeat(GLUT_KEY_REPEAT_OFF), gl_interop.cpp:27)."""
    import pygame

    pygame.display.init()
    pygame.display.set_caption("Relativistic Ray Tracer")
    screen = pygame.display.set_mode((core.width, core.height), pygame.RESIZABLE)
    pygame.key.set_repeat()  # no repeat: held state is tracked here

    keymap = {
        pygame.K_w: "w", pygame.K_a: "a", pygame.K_s: "s", pygame.K_d: "d",
        pygame.K_q: "q", pygame.K_e: "e", pygame.K_r: "r",
        pygame.K_SPACE: " ", pygame.K_i: "i",
    }
    held: set[str] = set()
    frames = 0
    try:
        while max_frames is None or frames < max_frames:
            t0 = time.perf_counter()
            for ev in pygame.event.get():
                if ev.type == pygame.QUIT:
                    return 0
                if ev.type == pygame.KEYDOWN and ev.key == pygame.K_ESCAPE:
                    return 0
                if ev.type == pygame.KEYDOWN and ev.key in keymap:
                    held.add(keymap[ev.key])
                elif ev.type == pygame.KEYUP and ev.key in keymap:
                    held.discard(keymap[ev.key])
                elif ev.type == pygame.VIDEORESIZE:
                    core.resize(ev.w, ev.h)
                    screen = pygame.display.set_mode((core.width, core.height),
                                                     pygame.RESIZABLE)
            img = core.frame(held)
            # pygame surfaces are (W, H) indexed; transpose the (H, W, 3) frame
            surf = pygame.surfarray.make_surface(img.transpose(1, 0, 2))
            if img.shape[:2] != (core.height, core.width):
                # stream_scale > 1: the frame was pooled; scale it for display
                surf = pygame.transform.scale(surf, (core.width, core.height))
            screen.blit(surf, (0, 0))
            pygame.display.flip()
            s = core.stats()
            pygame.display.set_caption(
                f"Relativistic Ray Tracer — {s['fps']:.1f} fps, "
                f"v={s['speed_c']}c{' [PAUSED]' if s['paused'] else ''}")
            frames += 1
            leftover = MIN_FRAME_S - (time.perf_counter() - t0)
            if leftover > 0:
                time.sleep(leftover)
    finally:
        pygame.display.quit()
    return 0


# ---------------------------------------------------------------------------
# web (MJPEG) front end: stdlib http.server, no display needed

_PAGE = """<!doctype html>
<html><head><title>Relativistic Ray Tracer</title><style>
 body { background:#111; color:#ddd; font:14px monospace; margin:0; text-align:center }
 #hud { padding:6px }
 img { image-rendering:pixelated; outline:none }
</style></head><body>
<div id="hud">connecting…</div>
<img id="view" src="/stream" tabindex="0">
<div id="hud2">keys: w/a/s/d/q/e move &nbsp; r reset velocity &nbsp; space pause &nbsp; i interval toggle</div>
<script>
const KEYS = new Set(['w','a','s','d','q','e','r',' ','i']);
function send(c, d) {
  fetch('/key?c=' + encodeURIComponent(c) + '&d=' + d, {method:'POST'});
}
window.addEventListener('keydown', e => {
  const k = e.key.toLowerCase();
  if (KEYS.has(k)) { e.preventDefault(); if (!e.repeat) send(k, 1); }
});
window.addEventListener('keyup', e => {
  const k = e.key.toLowerCase();
  if (KEYS.has(k)) { e.preventDefault(); send(k, 0); }
});
window.addEventListener('blur', () => send('*', 0));  // drop all held keys
setInterval(async () => {
  try {
    const s = await (await fetch('/stats')).json();
    document.getElementById('hud').textContent =
      s.fps.toFixed(1) + ' fps | v = ' + s.speed_c + 'c | t = ' + s.time_s +
      's | interval ' + s.interval + (s.paused ? ' | PAUSED' : '') +
      (s.compiling ? ' | BUILDING…' : '');
    // stream_scale > 1 sends pooled frames: display at the logical size
    const v = document.getElementById('view');
    v.style.width = s.size[0] + 'px'; v.style.height = s.size[1] + 'px';
  } catch (e) {}
}, 500);
</script></body></html>
"""


class _WebViewer:
    """The render loop and the state shared with the HTTP handlers."""

    def __init__(self, core: ViewerCore, jpeg_quality: int = 85):
        self.core = core
        self.quality = int(jpeg_quality)
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.held: set[str] = set()
        self.jpeg: bytes | None = None
        self.seq = 0
        self.stop = threading.Event()

    def set_key(self, c: str, down: bool) -> None:
        with self.lock:
            if c == "*":
                self.held.clear()
            elif down:
                self.held.add(c)
            else:
                self.held.discard(c)

    def render_loop(self, max_frames: int | None = None) -> None:
        frames = 0
        while not self.stop.is_set() and (max_frames is None or frames < max_frames):
            t0 = time.perf_counter()
            with self.lock:
                held = set(self.held)
            jpeg = encode_jpeg(self.core.frame(held), self.quality)
            with self.cond:
                self.jpeg = jpeg
                self.seq += 1
                self.cond.notify_all()
            frames += 1
            leftover = MIN_FRAME_S - (time.perf_counter() - t0)
            if leftover > 0:
                time.sleep(leftover)
        with self.cond:  # release any stream readers blocked on a new frame
            self.cond.notify_all()

    def wait_frame(self, last_seq: int, timeout: float = 5.0):
        """Block until a frame newer than last_seq exists; returns (jpeg, seq)."""
        deadline = time.monotonic() + timeout
        with self.cond:
            while self.jpeg is None or self.seq == last_seq:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self.stop.is_set():
                    break
                self.cond.wait(remaining)
            return self.jpeg, self.seq


def _make_handler(wv: _WebViewer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self._send(200, "text/html; charset=utf-8", _PAGE.encode())
            elif url.path == "/stats":
                self._send(200, "application/json", json.dumps(wv.core.stats()).encode())
            elif url.path == "/frame":
                jpeg, _ = wv.wait_frame(-1)
                if jpeg is None:
                    self._send(503, "text/plain", b"no frame yet")
                else:
                    self._send(200, "image/jpeg", jpeg)
            elif url.path == "/stream":
                self.send_response(200)
                self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                seq = -1
                try:
                    while not wv.stop.is_set():
                        jpeg, seq = wv.wait_frame(seq)
                        if jpeg is None:
                            continue
                        self.wfile.write(b"--frame\r\nContent-Type: image/jpeg\r\n"
                                         b"Content-Length: " + str(len(jpeg)).encode()
                                         + b"\r\n\r\n" + jpeg + b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/key":
                q = parse_qs(url.query)
                c = q.get("c", [""])[0]
                down = q.get("d", ["0"])[0] == "1"
                if c == "*" or c in KEY_CHARS:
                    wv.set_key(c, down)
                self._send(200, "text/plain", b"ok")
            elif url.path == "/resize":
                q = parse_qs(url.query)
                try:
                    w = int(q.get("w", ["0"])[0])
                    h = int(q.get("h", ["0"])[0])
                except ValueError:
                    self._send(400, "text/plain", b"bad size")
                    return
                wv.core.request_resize(w, h)
                self._send(200, "text/plain", b"ok")
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def run_web(core: ViewerCore, port: int = 8734, max_frames: int | None = None,
            on_ready=None, stop_event: threading.Event | None = None) -> int:
    """Serve the viewer at http://127.0.0.1:<port>/ (MJPEG stream and key
    capture). Blocks until the render loop ends (max_frames, stop_event) or
    Ctrl-C. on_ready, if given, is called with the bound port (for port=0).
    The render loop runs on the calling thread; the handlers' threads only
    read the latest JPEG, the stats snapshot and set held keys."""
    wv = _WebViewer(core)
    if stop_event is not None:
        wv.stop = stop_event
    httpd = ThreadingHTTPServer(("127.0.0.1", port), _make_handler(wv))
    httpd.daemon_threads = True
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    bound = httpd.server_address[1]
    print(f"viewer: http://127.0.0.1:{bound}/  "
          "(w/a/s/d/q/e move, r reset, space pause, i interval, Ctrl-C quit)", flush=True)
    if on_ready is not None:
        on_ready(bound)
    try:
        wv.render_loop(max_frames)
    except KeyboardInterrupt:
        pass
    finally:
        wv.stop.set()
        httpd.shutdown()
        httpd.server_close()
        server_thread.join(timeout=10)
    return 0


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="relativitypathtracer_tpu_torch.viewer")
    ap.add_argument("--scene", required=True, help="scene DSL file, or '-' for stdin")
    ap.add_argument("--asset-root", default=None)
    ap.add_argument("--size", default="960x540",
                    help="WxH (default 960x540, the reference's window size)")
    ap.add_argument("--msaa", type=int, default=1)
    ap.add_argument("--stream-scale", type=int, default=1, choices=(1, 2, 4),
                    help="box-filter the frame on the device by this factor before it is "
                         "fetched; the display scales it back to the logical size")
    ap.add_argument("--frontend", default="auto", choices=("auto", "window", "web"))
    ap.add_argument("--port", type=int, default=8734, help="web front end port")
    ap.add_argument("--max-frames", type=int, default=None,
                    help="stop after N frames (smoke testing)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help=f"torch device (default {DEFAULT_DEVICE})")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("Error: no CUDA device (pass --device cpu to run the plain twins)",
              file=sys.stderr)
        return 1
    try:
        if args.scene == "-":
            host = parse_scene(sys.stdin.read(), args.asset_root or ".", strict=False)
        else:
            host = load_scene_file(args.scene, args.asset_root, strict=False)
    except (SceneError, ObjError, TextureError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    try:
        w, h = _parse_size(args.size)
    except ValueError:
        print(f"Error: bad --size {args.size!r} (expected WxH)", file=sys.stderr)
        return 1
    print(f"building the renderers ({w}x{h}, {args.device})…", flush=True)
    core = ViewerCore(host, w, h, args.msaa, stream_scale=args.stream_scale,
                      device=args.device)

    if args.frontend in ("auto", "window"):
        # Fall back to the web front end only when the display itself cannot
        # start; an error while rendering surfaces as itself.
        try:
            import pygame

            pygame.display.init()
        except Exception as e:  # noqa: BLE001 - headless hosts raise varied types
            if args.frontend == "window":
                print(f"Error: window front end failed: {e}", file=sys.stderr)
                return 1
            print(f"no display ({e.__class__.__name__}); falling back to the web viewer",
                  flush=True)
        else:
            return run_window(core, args.max_frames)
    return run_web(core, args.port, args.max_frames)


if __name__ == "__main__":
    sys.exit(main())
