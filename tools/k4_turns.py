#!/usr/bin/env python3
"""K4, the live-chunk list build, of one or more checkouts of this
repository, timed in turns.

    python tools/k4_turns.py CHECKOUT [CHECKOUT ...]

Name a checkout twice to alternate (`old new new old`): each one is
measured in a fresh process, in the order given. That process imports the
checkout's own relativitypathtracer_tpu_torch, builds its kernels and, for
each mesh path of chip_smoke.py (utils/demo_scene at 1024x768, interval -1,
the camera moving at 0.5c), renders one frame while it captures every list
build and every call of K4's parts (the cone table `cone_table`, the cull
`live_cull`, the sort `bucket_order`; a checkout whose cone table is torch
ops is timed the same way). It prints one JSON line: the card's name and
power limit, and per path
  - `k4_ms`: device ms a frame of the frame's list builds, each replayed
    from a CUDA graph (chip_smoke.kernel_ms of this tree: inputs read from
    memory, a broadcast origin kept one), three times;
  - `table_ms`, `cull_ms`, `sort_ms`: device ms of each call of that part,
    timed the same way, three times;
  - `k4_launches`: the kernels (and copies) a frame's list builds launch,
    from torch.profiler; `k4_port_launches`: the port's counted launches of
    K4's keys (`_build.LAUNCHES`) in a frame;
  - `frame_launches`: kernels a frame, from torch.profiler over 5 frames;
  - `frame_p50`, `frame_p95`: ms over 60 frames after 5 warm-up frames,
    CUDA events around each.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import collections
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parents[1]
PATHS = ("blob", "textured", "instances", "large")
PARTS = {"table": "cone_table", "cull": "live_cull", "sort": "bucket_order"}
K4_KEYS = ("rpt_cone_table", "rpt_live_cull", "rpt_bucket_order")


def _smoke():
    """This tree's chip_smoke.py (its kernel_ms), whatever the checkout."""
    spec = importlib.util.spec_from_file_location("k4_turns_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _device_kernels(torch, fn, reps: int):
    """CUDA kernels a rep of fn() launches (memory copies and fills
    left out), from torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and "memcpy" not in e.name.lower() and "memset" not in e.name.lower())
    return n / reps


def measure(checkout: str) -> dict:
    root = pathlib.Path(checkout).resolve()
    smoke = _smoke()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch

    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch import render as prender
    from relativitypathtracer_tpu_torch.ops.kernels import _build
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_batch as mb
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_large as ml
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    _build.library()
    dev = torch.device("cuda")
    out = {"checkout": str(root), "card": card}
    builds = ((mk, "live_chunk_lists"), (mb, "live_chunk_lists_multi"),
              (ml, "large_live_lists"))
    for path in PATHS:
        with tempfile.TemporaryDirectory() as tmp:
            scene, meta = pt.build_scene(pt.load_scene_file(write_demo_scene(tmp, 4, path)),
                                         device=dev)
        render = pt.build_render_fn(meta, 1024, 768, -1, device=dev)
        consts = prender.render_constants(meta, 1024, 768, 1, dev)

        def eager(sc, st, _m=meta, _c=consts):  # a graph's replay runs no Python to hook
            with prender.full_precision():
                return prender.trace_frame(sc, _m, st, *_c, -1, 1024, 768)

        state = pt.FrameState(torch.tensor([0.5, 0.0, 0.0], device=dev),
                              torch.tensor([2 / 30, 0.0, 0.0, 0.0], device=dev))
        eager(scene, state)
        torch.cuda.synchronize()
        calls, parts, real = [], collections.defaultdict(list), {}
        for mod, attr in builds:
            real[(mod, attr)] = getattr(mod, attr)
            setattr(mod, attr, lambda *a, _f=real[(mod, attr)], **kw: calls.append(
                (_f, a, kw)) or _f(*a, **kw))
        for part, attr in PARTS.items():  # where the list builds look them up
            for mod in (mk, mb, ml):
                if hasattr(mod, attr):
                    real[(mod, attr)] = getattr(mod, attr)
                    setattr(mod, attr, lambda *a, _f=real[(mod, attr)], _p=part, **kw:
                            parts[_p].append((_f, a, kw)) or _f(*a, **kw))
        _build.LAUNCHES.clear()
        try:
            eager(scene, state)
            torch.cuda.synchronize()
        finally:
            for (mod, attr), f in real.items():
                setattr(mod, attr, f)
        counted = sum(_build.LAUNCHES[k] for k in K4_KEYS)

        def replay(_calls=calls):
            for f, a, kw in _calls:
                f(*a, **kw)

        r = {"builds": len(calls), "k4_port_launches": counted,
             "k4_launches": _device_kernels(torch, replay, 3),
             "k4_ms": [sum(smoke.kernel_ms(torch, lambda *x, _f=f, _n=len(a), _k=list(kw):
                                           _f(*x[:_n], **dict(zip(_k, x[_n:]))),
                                           [*a, *kw.values()]) for f, a, kw in calls)
                       for _ in range(3)]}
        for part, seen in parts.items():
            r[f"{part}_ms"] = [[smoke.kernel_ms(torch, lambda *x, _f=f, _n=len(a), _k=list(kw):
                                                _f(*x[:_n], **dict(zip(_k, x[_n:]))),
                                                [*a, *kw.values()]) for f, a, kw in seen]
                               for _ in range(3)]
        r["frame_launches"] = _device_kernels(torch, lambda: render(scene, state), 5)
        for _ in range(5):
            render(scene, state)
        times = []
        for _ in range(60):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            render(scene, state)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        r["frame_p50"], r["frame_p95"] = times[30], times[int(0.95 * 59)]
        out[path] = r
        del scene, calls, parts
        torch.cuda.empty_cache()
    return out


def main() -> int:
    checkouts = sys.argv[1:]
    if not checkouts:
        print(__doc__, file=sys.stderr)
        return 2
    if len(checkouts) > 1:
        for c in checkouts:
            subprocess.run([sys.executable, os.path.abspath(__file__), c], check=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k4_turns: needs a CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(measure(checkouts[0])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
