#!/usr/bin/env python3
"""The sharded and exported renderers against the live one on the card, in turns.

    python tools/shard_turns.py [PATH ...]   (default: textured instances)

For each path of chip_smoke.py (utils/demo_scene at level 4, 1024x768,
interval -1, the camera moving at 0.5c) it builds six renderers of the same
frame: the live `build_render_fn` (one CUDA graph, utils/frame_graph); the
eager frame (`render_constants`, then `trace_frame` under
`full_precision()` each call); the torch.export artifact loaded back
(utils/aot: `export_render`, `load_render`, graphed too); and the sharded
renderer (parallel/tiles, a graph for the card's shards) on 1, 2 and 4
logical shards of the one card. Each renderer
is checked equal to the live frame to the bit, then timed in turns (three
rounds, the renderers in the same order each round): 20 frames between CUDA
events with a synchronize per frame (p50 and p95 ms), and 20 frames issued
back to back with one synchronize at the end on the host clock (`issue_ms`,
ms a frame: the rate of a caller that does not wait per frame). It prints
one JSON line with the card's name and power limit, the export seconds and
bytes, and per path and renderer the kernels a frame (torch.profiler over 5
frames, copies and fills left out), the port's counted launches a frame
(`_build.LAUNCHES`) and the three rounds' numbers; the loaded program's
graph nodes (`graph_nodes`, its call_function nodes, each an operator call
from the graph's generated Python); and the host microseconds of one call
of a small CUDA product as a tensor method (`a * b`) and as the operator
overload a graph node calls (`torch.ops.aten.mul.Tensor`), 20,000 calls
each (`host_us`). Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import io
import json
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SHARDS = (1, 2, 4)
FRAMES = 20


def _kernels_a_frame(torch, fn, reps: int = 5) -> float:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and "memcpy" not in e.name.lower() and "memset" not in e.name.lower())
    return n / reps


def _issue_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / FRAMES


def _host_us(torch, dev) -> dict:
    a, b = torch.ones(4, device=dev), torch.ones(4, device=dev)
    calls = {"method": lambda: a * b, "opoverload": lambda: torch.ops.aten.mul.Tensor(a, b)}
    out = {}
    for name, fn in calls.items():
        for _ in range(1000):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20000):
            fn()
        out[name] = (time.perf_counter() - t0) / 20000 * 1e6
        torch.cuda.synchronize()
    return out


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("shard_turns: needs a CUDA device", file=sys.stderr)
        return 1
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch import render as prender
    from relativitypathtracer_tpu_torch.ops.kernels import _build
    from relativitypathtracer_tpu_torch.parallel.tiles import build_sharded_render_fn
    from relativitypathtracer_tpu_torch.utils import aot
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene
    from relativitypathtracer_tpu_torch.utils.timing import cuda_frame_times_ms, percentile

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.library()
    dev = torch.device("cuda")
    state = pt.FrameState(torch.tensor([0.5, 0.0, 0.0], device=dev),
                          torch.tensor([2 / 30, 0.0, 0.0, 0.0], device=dev))
    out = {"card": card, "torch": torch.__version__, "host_us": _host_us(torch, dev)}
    for path in argv or ("textured", "instances"):
        with tempfile.TemporaryDirectory() as tmp:
            scene, meta = pt.build_scene(pt.load_scene_file(write_demo_scene(tmp, 4, path)),
                                         device=dev)
        live = pt.build_render_fn(meta, 1024, 768, -1, device=dev)
        t0 = time.perf_counter()
        data = aot.export_render(scene, meta, 1024, 768, device=dev)
        t_export = time.perf_counter() - t0
        consts = prender.render_constants(meta, 1024, 768, 1, dev)

        def eager(sc, st, c=consts, m=meta):
            with prender.full_precision():
                return prender.trace_frame(sc, m, st, *c, -1, 1024, 768)

        renders = {"live": live, "eager": eager, "exported": aot.load_render(data)}
        for n in SHARDS:
            renders[f"sharded_{n}"] = build_sharded_render_fn(meta, 1024, 768, -1, [dev] * n)
        want = live(scene, state)
        nodes = torch.export.load(io.BytesIO(data)).graph.nodes
        r = {"export_s": t_export, "artifact_bytes": len(data),
             "graph_nodes": sum(1 for node in nodes if node.op == "call_function")}
        for name, render in renders.items():
            if not torch.equal(render(scene, state), want):
                raise AssertionError(f"{path} {name}: frame differs from the live frame")
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            render(scene, state)
            torch.cuda.synchronize()
            launches = sum(_build.LAUNCHES.values())
            r[name] = {"kernels": _kernels_a_frame(torch, lambda f=render: f(scene, state)),
                       "port_launches": launches, "p50": [], "p95": [], "issue_ms": []}
        for _ in range(3):
            for name, render in renders.items():
                times = cuda_frame_times_ms(render, scene, state, frames=FRAMES, warmup=3)
                r[name]["p50"].append(percentile(times, 50))
                r[name]["p95"].append(percentile(times, 95))
                r[name]["issue_ms"].append(_issue_ms(torch, lambda f=render: f(scene, state)))
        out[path] = r
        del scene, renders, consts
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
