#!/usr/bin/env python3
"""Where the port's frame time goes on the card, per demo path.

    python tools/torch_profile.py [PATH ...]     (default: blob textured cubes)

For each path of chip_smoke.py (utils/demo_scene at 1024x768, interval -1,
the camera moving at 0.5c) it renders 5 warm-up frames, then times 30 frames
back to back on the host clock with one synchronize at the end (the frame
rate a caller that does not wait per frame sees), then traces 10 more frames
with torch.profiler. It prints one JSON line per path: the card, the frame
time, the kernels launched per frame, the device busy time per frame (the
union of kernel and copy intervals) and its share of the frame, each of the
port's CUDA kernels' device time per frame, and the five other kernels with
the most device time. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import collections
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import relativitypathtracer_tpu_torch as pt  # noqa: E402
from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene  # noqa: E402

PORT_KERNELS = ("shadow_chain_kernel", "footprint_kernel", "analytic_nearest_kernel",
                "analytic_min_t_kernel", "shared_walk_kernel", "general_walk_kernel")


def _union_ms(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def profile_path(kind: str, card: str, timed: int = 30, traced: int = 10) -> dict:
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        scene, meta = pt.build_scene(pt.load_scene_file(write_demo_scene(tmp, 4, kind)),
                                     device=dev)
    render = pt.build_render_fn(meta, 1024, 768, -1, device=dev)
    state = pt.FrameState(torch.tensor([0.5, 0.0, 0.0], device=dev),
                          torch.tensor([2 / 30, 0.0, 0.0, 0.0], device=dev))
    for _ in range(5):
        render(scene, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        render(scene, state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / timed

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(traced):
            render(scene, state)
        torch.cuda.synchronize()
    by_name, spans, launches = collections.Counter(), [], 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3 / traced
        launches += "memcpy" not in e.name.lower() and "memset" not in e.name.lower()
    busy = _union_ms(spans) / traced
    port = {k: sum(v for n, v in by_name.items() if k in n) for k in PORT_KERNELS}
    others = [(n, v) for n, v in by_name.most_common()
              if not any(k in n for k in PORT_KERNELS)][:5]
    return {"path": kind, "card": card, "wall_ms_per_frame": wall_ms,
            "kernels_per_frame": launches / traced, "busy_ms_per_frame": busy,
            "busy_share": busy / wall_ms, "port_kernels_ms_per_frame": port,
            "top_other_ms_per_frame": others}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    for kind in sys.argv[1:] or ("blob", "textured", "cubes"):
        print(json.dumps(profile_path(kind, card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
