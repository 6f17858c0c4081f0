"""Headless renderer CLI of the port.

Render N frames of a scene to PNG/GIF with deterministic camera state, and
optionally print timing as JSON:

  python -m relativitypathtracer_tpu_torch.cli --scene Scenes/scene.txt \\
      --size 1024x768 --frames 10 --out out.png [--gif out.gif] [--time 0] \\
      [--dt 0.0333] [--paused] [--velocity 0.5,0,0] [--interval -1|0] [--msaa 2] \\
      [--asset-root DIR] [--metrics] [--profile DIR] [--device cuda]

--scene '-' reads the scene DSL from stdin. The flags and the --metrics keys
are those of the JAX package's CLI, with their meaning there
(`mrays_per_sec_p50` counts primary rays only); the port adds
`rays_last_frame` and `mrays_per_sec_p50_with_shadow` (primary plus the last
frame's shadow rays) and `device`. On a CUDA device frame times come from
CUDA events; on the CPU (the plain twins) from the host clock. --profile
writes a torch.profiler trace of the frame loop to DIR/trace.json.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from .device import DEFAULT_DEVICE


def _parse_size(s: str):
    w, h = s.lower().split("x")
    return int(w), int(h)


def _parse_vec3(s: str):
    parts = [float(x) for x in s.split(",")]
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(f"expected x,y,z, got {s!r}")
    return parts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="relativitypathtracer_tpu_torch")
    ap.add_argument("--scene", required=True, help="scene DSL file, or '-' for stdin")
    ap.add_argument("--asset-root", default=None, help="base dir for scene asset paths")
    ap.add_argument("--size", default="960x540", help="WxH (default 960x540)")
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--time", type=float, default=0.0, help="scene start time")
    ap.add_argument("--dt", type=float, default=1.0 / 30.0, help="per-frame time step")
    ap.add_argument("--velocity", type=_parse_vec3, default=[0.0, 0.0, 0.0],
                    help="camera 3-velocity (units of c)")
    ap.add_argument("--interval", type=int, default=None, choices=(-1, 0),
                    help="override light-propagation interval")
    ap.add_argument("--msaa", type=int, default=1, help="samples per pixel axis")
    ap.add_argument("--out", default=None, help="output PNG (last frame)")
    ap.add_argument("--gif", default=None, help="output animated GIF (all frames)")
    ap.add_argument("--paused", action="store_true", help="do not advance scene time")
    ap.add_argument("--metrics", action="store_true", help="print timing JSON")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the frame loop to DIR/trace.json")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help=f"torch device (default {DEFAULT_DEVICE})")
    args = ap.parse_args(argv)
    if args.frames < 1:
        ap.error(f"--frames must be >= 1 (got {args.frames})")
    if args.msaa < 1:
        ap.error(f"--msaa must be >= 1 (got {args.msaa})")
    if args.gif and args.dt <= 0:
        ap.error(f"--gif needs --dt > 0 for its frame rate (got {args.dt})")

    import torch

    from . import FrameState, build_render_fn, build_scene, load_scene_file, parse_scene
    from .models.dsl import SceneError
    from .models.obj_loader import ObjError
    from .models.texture import TextureError
    from .utils.image import write_gif, write_png

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
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
    scene, meta = build_scene(host, device=device)
    width, height = _parse_size(args.size)
    interval = meta.default_interval if args.interval is None else args.interval
    render = build_render_fn(meta, width, height, interval, args.msaa, with_aux=True,
                             device=device)
    vel = torch.tensor(args.velocity, dtype=torch.float32, device=device)
    on_card = device.type == "cuda"
    profiler = contextlib.nullcontext()
    if args.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
    t = args.time
    timings, frames, shadow_rays, img = [], [], 0, None
    with profiler:
        for _ in range(args.frames):
            state = FrameState(vel, torch.tensor([t, 0.0, 0.0, 0.0], device=device))
            if on_card:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                img, aux = render(scene, state)
                end.record()
                end.synchronize()
                timings.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                img, aux = render(scene, state)
                timings.append((time.perf_counter() - t0) * 1e3)
            shadow_rays = int(aux["shadow_rays"])
            if args.gif:
                frames.append(img.cpu().numpy())
            if not args.paused:
                t += args.dt
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    if args.out:
        write_png(args.out, img.cpu().numpy())
    if args.gif:
        write_gif(args.gif, frames, fps=1.0 / args.dt)
    if args.metrics:
        p50 = sorted(timings)[len(timings) // 2]
        primary = width * height * args.msaa * args.msaa
        rays = primary + shadow_rays
        print(json.dumps({
            "width": width, "height": height, "frames": args.frames,
            "first_ms": timings[0], "p50_ms": p50, "best_ms": min(timings),
            "primary_rays": primary, "mrays_per_sec_p50": primary / (p50 * 1e3),
            "platform": "gpu" if on_card else device.type,
            "rays_last_frame": rays, "mrays_per_sec_p50_with_shadow": rays / (p50 * 1e3),
            "device": torch.cuda.get_device_name(device) if on_card else device.type,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
