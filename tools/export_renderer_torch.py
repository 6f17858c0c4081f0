#!/usr/bin/env python3
"""Export the port's frame renderer as a portable artifact (utils/aot.py).

    python tools/export_renderer_torch.py (--scene FILE | --fixture KIND)
        [--size 1024x768] [--msaa N] [--device cuda|cpu] [--out FILE] [--selfcheck]

It builds the scene (a scene file, or a procedural fixture of
utils/demo_scene at level 4, as chip_smoke.py builds them: blob, textured,
cubes, instances or large),
exports build_render_fn's frame with torch.export on the device and writes
the serialized program to --out (default build/export/<name>.pt2 in the
checkout). The device decides the kernels: a CUDA artifact launches the
port's CUDA kernels, a CPU artifact runs their plain twins. On the serving
host:

    from relativitypathtracer_tpu_torch.utils.aot import load_render
    render = load_render(open("renderer.pt2", "rb").read())
    img = render(scene, state)   # the scene and the state are arguments

--selfcheck loads the artifact back, renders two states (at rest, and the
camera at 0.5c a frame later) with it and with the live renderer, and exits
1 unless the frames are equal to the bit.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--scene", help="a scene file")
    src.add_argument("--fixture", help="a utils/demo_scene kind")
    ap.add_argument("--size", default="1024x768")
    ap.add_argument("--msaa", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    ap.add_argument("--selfcheck", action="store_true")
    args = ap.parse_args(argv)

    import torch

    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch.device import DEFAULT_DEVICE
    from relativitypathtracer_tpu_torch.utils.aot import export_render, load_render
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    dev = torch.device(args.device or DEFAULT_DEVICE)
    W, H = (int(x) for x in args.size.lower().split("x"))
    with tempfile.TemporaryDirectory() as tmp:
        path = args.scene or write_demo_scene(tmp, 4, args.fixture)
        scene, meta = pt.build_scene(pt.load_scene_file(path), device=dev)
    name = args.fixture or pathlib.Path(args.scene).stem
    out = pathlib.Path(args.out or REPO / "build" / "export" / f"{name}.pt2")

    t0 = time.perf_counter()
    data = export_render(scene, meta, W, H, msaa=args.msaa, device=dev)
    seconds = time.perf_counter() - t0
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(data)
    print(f"wrote {out}: {len(data)} bytes, {W}x{H} msaa {args.msaa} on {dev}, "
          f"exported in {seconds:.1f} s")

    if args.selfcheck:
        render = load_render(out.read_bytes())
        live = pt.build_render_fn(meta, W, H, meta.default_interval, args.msaa, device=dev)
        states = [pt.FrameState.initial(dev),
                  pt.FrameState(torch.tensor([0.5, 0.0, 0.0], device=dev),
                                torch.tensor([1 / 30, 0.0, 0.0, 0.0], device=dev))]
        for i, state in enumerate(states):
            got, want = render(scene, state), live(scene, state)
            equal = bool(torch.equal(got, want))
            print(f"selfcheck state {i}: artifact {'equals' if equal else 'differs from'} the "
                  f"live frame (max |diff| {float((got - want).abs().max()):g})")
            if not equal:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
