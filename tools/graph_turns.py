#!/usr/bin/env python3
"""The graphed frame against the eager frame on the card, in turns.

    python tools/graph_turns.py [PATH ...]   (default: the five paths)

For each path of chip_smoke.py (utils/demo_scene at level 4, `large` at its
own level; 1024x768, interval -1, the camera moving at 0.5c) it builds two
renderers of the same frame: the eager frame (`render_constants` once, then
`trace_frame` under `full_precision()` each call, a launch at a time from
Python) and `build_render_fn`'s, one CUDA graph (utils/frame_graph). It
records the graph's first call (warm-up, capture and the first replay:
`capture_s`), the bytes a call copies into the graph's inputs, the peak
memory of the eager frames and of the capture and replays (each above the
memory held before, after `reset_peak_memory_stats`), and the memory the
graph keeps reserved; checks the graphed frame equal to the eager one
to the bit with equal counts and launches; times the clone of the image a
replay returns (`clone_ms`, CUDA events over 100 clones); then times both
in turns, eager, graph, graph, eager, three rounds: FRAMES frames between
CUDA events with a synchronize per frame (p50 and p95 ms) and FRAMES frames
issued back to back with one synchronize (`issue_ms`, ms a frame). Last,
the memory reserved as nine cached renderers of textured (intervals -1 to
7) are built and called one after another (`cached_renderers`): every
graph of a card shares one pool. For each path it also prices the template
that FrameGraph keeps (`keep_graph`): the eager frame captured with
`CUDAGraph(keep_graph=True)` then `instantiate()`, as FrameGraph does, and
with `CUDAGraph()` (instantiated at the capture's end, the template
dropped), in turns, kept, dropped, dropped, kept, twice: seconds from the
warm-up to the first replay, replay p50, peak memory above what was
allocated before, and the process's resident host memory gained. Prints one
JSON line with the card's name and power limit. Needs a CUDA device and
nvcc; about 3 minutes for the five paths.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from relativitypathtracer_tpu_torch.utils.timing import cuda_frame_times_ms, percentile  # noqa: E402

PATHS = ("blob", "textured", "cubes", "instances", "large")
FRAMES = 30


def _issue_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / FRAMES


def _counted(torch, build, fn):
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(build.LAUNCHES)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("graph_turns: needs a CUDA device", file=sys.stderr)
        return 1
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch import render as prender
    from relativitypathtracer_tpu_torch.ops.kernels import _build
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.library()
    dev = torch.device("cuda")
    state = pt.FrameState(torch.tensor([0.5, 0.0, 0.0], device=dev),
                          torch.tensor([2 / 30, 0.0, 0.0, 0.0], device=dev))
    out = {"card": card, "torch": torch.__version__}
    mib = 2.0 ** -20
    for path in argv or PATHS:
        with tempfile.TemporaryDirectory() as tmp:
            scene, meta = pt.build_scene(pt.load_scene_file(write_demo_scene(tmp, 4, path)),
                                         device=dev)
        consts = prender.render_constants(meta, 1024, 768, 1, dev)

        def eager(sc=scene, st=state, c=consts, m=meta):
            with prender.full_precision():
                return prender.trace_frame(sc, m, st, *c, -1, 1024, 768, True)

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (want, waux), eager_launches = _counted(torch, _build, eager)
        for _ in range(4):
            eager()
        torch.cuda.synchronize()
        eager_peak = (torch.cuda.max_memory_allocated() - base) * mib
        del want, waux
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        graphed = pt.build_render_fn(meta, 1024, 768, -1, with_aux=True, device=dev)
        t0 = time.perf_counter()
        first, _ = graphed(scene, state)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        for _ in range(4):
            graphed(scene, state)
        torch.cuda.synchronize()
        graph_peak = (torch.cuda.max_memory_allocated() - base) * mib
        pool = (torch.cuda.memory_reserved() - reserved) * mib
        want, waux = eager()
        (img, aux), graph_launches = _counted(torch, _build, lambda: graphed(scene, state))
        if not (torch.equal(img, want) and torch.equal(first, want)
                and {k: int(v) for k, v in aux.items()} == {k: int(v) for k, v in waux.items()}):
            raise AssertionError(f"{path}: the graphed frame differs from the eager frame")
        if graph_launches != eager_launches:
            raise AssertionError(f"{path}: launches {graph_launches}, eager {eager_launches}")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(100):
            img.clone()
        end.record()
        end.synchronize()
        r = {"capture_s": capture_s, "captures": graphed.captures,
             "input_bytes": graphed.input_bytes, "eager_peak_mib": eager_peak,
             "graph_peak_mib": graph_peak, "graph_pool_mib": pool,
             "launches": sum(eager_launches.values()), "clone_ms": start.elapsed_time(end) / 100,
             "image_bytes": img.numel() * img.element_size()}
        renders = {"eager": eager, "graph": lambda: graphed(scene, state)}
        for key in ("p50", "p95", "issue_ms"):
            r[key] = {"eager": [], "graph": []}
        for _ in range(3):
            for name in ("eager", "graph", "graph", "eager"):
                fn = renders[name]
                times = cuda_frame_times_ms(lambda s, t, f=fn: f(), None, None, frames=FRAMES,
                                            warmup=3)
                r["p50"][name].append(percentile(times, 50))
                r["p95"][name].append(percentile(times, 95))
                r["issue_ms"][name].append(_issue_ms(torch, fn))
        r["keep_graph"] = _keep_graph_turns(torch, eager, want)
        out[path] = r
        print(json.dumps({path: r}), flush=True)
        del scene, consts, graphed, renders, img, want, first
        torch.cuda.empty_cache()
    out["cached_renderers"] = _cached_renderers(torch, pt, write_demo_scene, dev, state)
    print(json.dumps(out), flush=True)
    return 0


def _rss_mib() -> float:
    for line in pathlib.Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 1024
    return float("nan")


def _capture_cost(torch, fn, want, keep: bool) -> dict:
    """fn captured as FrameGraph captures it (a warm-up on a side stream,
    then the capture), with its template kept or dropped."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rss = _rss_mib()
    t0 = time.perf_counter()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=keep)
    with torch.cuda.graph(graph, stream=side):
        img, _ = fn()
    if keep:
        graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    r = {"capture_s": time.perf_counter() - t0, "host_rss_mib": _rss_mib() - rss}
    if not torch.equal(img, want):
        raise AssertionError(f"keep_graph={keep}: the replay differs from the eager frame")
    times = cuda_frame_times_ms(lambda s, t: graph.replay(), None, None, frames=FRAMES,
                                warmup=3)
    r["p50"] = percentile(times, 50)
    r["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    del graph, img
    return r


def _keep_graph_turns(torch, fn, want) -> dict:
    out = {"kept": [], "dropped": []}
    for _ in range(2):
        for name in ("kept", "dropped", "dropped", "kept"):
            out[name].append(_capture_cost(torch, fn, want, name == "kept"))
    return {name: {k: [r[k] for r in runs] for k in runs[0]} for name, runs in out.items()}


def _cached_renderers(torch, pt, write_demo_scene, dev, state) -> dict:
    """The memory that cached renderers keep: nine graphed renderers of
    textured at 1024x768 (intervals -1 to 7, each built, called twice and
    kept), the memory reserved after each, above what was reserved before
    the first."""
    with tempfile.TemporaryDirectory() as tmp:
        scene, meta = pt.build_scene(pt.load_scene_file(write_demo_scene(tmp, 4, "textured")),
                                     device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    renders, reserved_mib = [], []
    for interval in range(-1, 8):
        renders.append(pt.build_render_fn(meta, 1024, 768, interval, device=dev))
        renders[-1](scene, state)
        renders[-1](scene, state)
        torch.cuda.synchronize()
        reserved_mib.append((torch.cuda.memory_reserved() - base) / 2**20)
    return {"path": "textured", "reserved_mib": reserved_mib,
            "input_bytes": renders[0].input_bytes}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
