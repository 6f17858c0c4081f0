#!/usr/bin/env python3
"""Where the host time of a loaded renderer goes, against the live renderer.

    python tools/export_host_probe.py [PATH ...]   (default: instances textured)

For each path of chip_smoke.py (utils/demo_scene at level 4, 1024x768,
interval -1, the camera at 0.5c) it exports build_render_fn's frame on the
card (utils/aot), loads it back, and measures in turns, two rounds: the
live frame, the loaded frame (both replays of a CUDA graph since the frame
graph, utils/frame_graph), and the loaded module called eagerly without
its pre-hook's input check (`validate_inputs` off). For each it prints the host ms a frame
of 20 frames issued back to back with one synchronize at the end
(`issue_ms`), the collections of Python's garbage collector in those frames
by generation and their ms (`gc`), and the issue ms again with the collector
off (`issue_ms_gc_off`); and, from torch.profiler over 5 frames, the wall
ms a frame and the host ms a frame spent inside operators (the self CPU
time of every event but the CUDA runtime's) (`op_host_ms`). It prints one
JSON line with the card's name and power limit. Needs a CUDA device and
nvcc.
"""

from __future__ import annotations

import gc
import json
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

FRAMES = 20


class GcClock:
    """Collections by generation and their total ms, through gc.callbacks."""

    def __init__(self):
        self.count, self.ms, self._t0 = [0, 0, 0], 0.0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.count[info["generation"]] += 1
            self.ms += (time.perf_counter() - self._t0) * 1e3


def _issue(torch, fn, clock=None) -> float:
    torch.cuda.synchronize()
    if clock is not None:
        gc.callbacks.append(clock)
    try:
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / FRAMES
    finally:
        if clock is not None:
            gc.callbacks.remove(clock)


def _profile(torch, fn, reps: int = 5) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    ops = sum(e.self_cpu_time_total for e in prof.key_averages()
              if not e.key.startswith("cuda")) / 1e3 / reps
    return {"wall_ms": wall, "op_host_ms": ops}


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("export_host_probe: needs a CUDA device", file=sys.stderr)
        return 1
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch.ops.kernels import _build
    from relativitypathtracer_tpu_torch.render import full_precision
    from relativitypathtracer_tpu_torch.utils import aot
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.library()
    dev = torch.device("cuda")
    state = pt.FrameState(torch.tensor([0.5, 0.0, 0.0], device=dev),
                          torch.tensor([2 / 30, 0.0, 0.0, 0.0], device=dev))
    out = {"card": card, "torch": torch.__version__}
    for path in argv or ("instances", "textured"):
        with tempfile.TemporaryDirectory() as tmp:
            scene, meta = pt.build_scene(pt.load_scene_file(write_demo_scene(tmp, 4, path)),
                                         device=dev)
        live = pt.build_render_fn(meta, 1024, 768, -1, device=dev)
        data = aot.export_render(scene, meta, 1024, 768, device=dev)
        unchecked = aot.load_program(data).module(check_guards=False)
        unchecked.validate_inputs = False

        def no_check(sc, st, _m=unchecked):
            with full_precision():
                return _m(sc, st)

        renders = {"live": live, "loaded": aot.load_render(data), "loaded_no_check": no_check}
        want = live(scene, state)
        r = {"tracked_objects": len(gc.get_objects())}
        for name, render in renders.items():
            if not torch.equal(render(scene, state), want):
                raise AssertionError(f"{path} {name}: frame differs from the live frame")
            r[name] = {"issue_ms": [], "gc": [], "issue_ms_gc_off": []}
        for _ in range(2):
            for name, render in renders.items():
                def frame(f=render):
                    f(scene, state)
                clock = GcClock()
                r[name]["issue_ms"].append(_issue(torch, frame, clock))
                r[name]["gc"].append({"count": clock.count, "ms": clock.ms})
                gc.disable()
                try:
                    r[name]["issue_ms_gc_off"].append(_issue(torch, frame))
                finally:
                    gc.enable()
        for name, render in renders.items():
            r[name].update(_profile(torch, lambda f=render: f(scene, state)))
        out[path] = r
        del scene, renders
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
