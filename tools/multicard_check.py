#!/usr/bin/env python3
"""The sharded renderer on distinct cards of one host.

    python tools/multicard_check.py [PATH ...]   (default: textured instances large)

It needs two or more CUDA devices, and fails (exit 1) with fewer. For each
path of chip_smoke.py (utils/demo_scene at level 4, large at its own level,
1024x768, interval -1, the camera at 0.5c) it renders the frame on cuda:0
with build_render_fn, then with the sharded renderer (parallel/tiles) over
every card (`default_devices()`), blocks dealt strided and contiguous, the
scene built on cuda:0 and copied to the other cards by the renderer; each
sharded frame and its aux counts must equal the single frame's to the bit,
and the sharded frame must launch each kernel n-cards times a single
frame's (each renderer's launches counted in a replay after its first
call, which captures its CUDA graphs: one a card for the sharded one).
This runs every kernel of the path, the walks' shared-memory opt-in
included, on cards other than the current device (cuda:0) from one host
thread. The sharded artifact over the cards (utils/aot.export_sharded_render,
a program a card, loaded and graphed a card) is held to the same frame and
launches. It then times, in turns (three rounds of 20 frames, CUDA
events on cuda:0 with a synchronize per frame), the single frame, the
sharded frame over the cards, the loaded artifact over the cards and the
sharded frame over as many logical shards of cuda:0, and runs
parallel.tiles.dryrun_multichip on each card.
It prints one JSON line: the cards' names and power limits, and per path
the checks' results and the p50/p95 ms of each round.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("multicard_check: needs two or more CUDA devices", file=sys.stderr)
        return 1
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch.ops.kernels import _build
    from relativitypathtracer_tpu_torch.parallel import tiles
    from relativitypathtracer_tpu_torch.utils import aot
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene
    from relativitypathtracer_tpu_torch.utils.timing import cuda_frame_times_ms, percentile

    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip().splitlines()
    devices = tiles.default_devices()
    n = len(devices)
    dev = devices[0]
    state = pt.FrameState(torch.tensor([0.5, 0.0, 0.0], device=dev),
                          torch.tensor([2 / 30, 0.0, 0.0, 0.0], device=dev))
    out = {"cards": cards, "devices": [str(d) for d in devices]}

    def counted(render, scene):
        render(scene, state)  # the capture: a renderer's first call also warms up
        for d in devices:
            torch.cuda.synchronize(d)
        _build.LAUNCHES.clear()
        res = render(scene, state)
        for d in devices:
            torch.cuda.synchronize(d)
        return res, dict(_build.LAUNCHES)

    for path in argv or ("textured", "instances", "large"):
        with tempfile.TemporaryDirectory() as tmp:
            scene, meta = pt.build_scene(pt.load_scene_file(write_demo_scene(tmp, 4, path)),
                                         device=dev)
        single = pt.build_render_fn(meta, 1024, 768, -1, with_aux=True, device=dev)
        (want, waux), one = counted(single, scene)
        r = {"launches_single": one}
        renders = {"single": single}
        for assign in ("strided", "contiguous"):
            render = tiles.build_sharded_render_fn(meta, 1024, 768, -1, devices, with_aux=True,
                                                   band_assign=assign)
            (img, aux), launches = counted(render, scene)
            r[f"{assign}_equal"] = bool(torch.equal(img, want)) and (
                {k: int(v) for k, v in aux.items()} == {k: int(v) for k, v in waux.items()})
            r[f"{assign}_launches_x{n}"] = launches == {k: n * c for k, c in one.items()}
            renders[f"cards_{assign}"] = render
        # the sharded artifact: a program a card, each graphed on its card
        loaded = aot.load_render(aot.export_sharded_render(scene, meta, 1024, 768, devices, -1))
        img, launches = counted(loaded, scene)
        r["exported_equal"] = bool(torch.equal(img, want))
        r[f"exported_launches_x{n}"] = launches == {k: n * c for k, c in one.items()}
        renders["cards_exported"] = loaded
        renders["logical_strided"] = tiles.build_sharded_render_fn(
            meta, 1024, 768, -1, [dev] * n, with_aux=True)
        for name in renders:
            r[name] = {"p50": [], "p95": []}
        for _ in range(3):
            for name, render in renders.items():
                times = cuda_frame_times_ms(render, scene, state, frames=20, warmup=3)
                r[name]["p50"].append(percentile(times, 50))
                r[name]["p95"].append(percentile(times, 95))
        out[path] = r
        if not all(v for k, v in r.items() if k.endswith(("_equal", f"_x{n}"))):
            print(json.dumps(out), flush=True)
            print(f"multicard_check: {path} failed", file=sys.stderr)
            return 1
        del scene, renders
    out["dryrun"] = [tiles.dryrun_multichip(n, device=d) for d in devices]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
