"""Headless renderer CLI of the port.

Render N frames of a scene to PNG with deterministic camera state, and
optionally print per-frame timing as JSON:

  python -m relativitypathtracer_tpu_torch.cli --scene Scenes/scene.txt \\
      --size 1024x768 --frames 10 --out out.png [--time 0] [--dt 0.0333] \\
      [--velocity 0.5,0,0] [--interval -1|0] [--msaa 2] [--metrics] [--device cuda]

--scene '-' reads the scene DSL from stdin. On a CUDA device frame times
come from CUDA events; on the CPU (the plain twins) from the host clock.
"""

from __future__ import annotations

import argparse
import json
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
    ap.add_argument("--metrics", action="store_true", help="print timing JSON")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help=f"torch device (default {DEFAULT_DEVICE})")
    args = ap.parse_args(argv)
    if args.frames < 1:
        ap.error(f"--frames must be >= 1 (got {args.frames})")
    if args.msaa < 1:
        ap.error(f"--msaa must be >= 1 (got {args.msaa})")

    import torch

    from . import FrameState, build_render_fn, build_scene, load_scene_file, parse_scene
    from .models.dsl import SceneError
    from .models.obj_loader import ObjError
    from .models.texture import TextureError
    from .utils.image import write_png

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("Error: no CUDA device (pass --device cpu to run the plain twins)",
              file=sys.stderr)
        return 1
    try:
        if args.scene == "-":
            host = parse_scene(sys.stdin.read(), ".", strict=False)
        else:
            host = load_scene_file(args.scene, strict=False)
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
    t = args.time
    timings, shadow_rays, img = [], 0, None
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
        t += args.dt
    if args.out:
        write_png(args.out, img.cpu().numpy())
    if args.metrics:
        p50 = sorted(timings)[len(timings) // 2]
        rays = width * height * args.msaa * args.msaa + shadow_rays
        print(json.dumps({
            "width": width, "height": height, "frames": args.frames,
            "first_ms": timings[0], "p50_ms": p50, "best_ms": min(timings),
            "rays_last_frame": rays, "mrays_per_sec_p50": rays / (p50 * 1e3),
            "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
