#!/usr/bin/env python3
"""Where the port's frame time goes on the card, per demo path.

    python tools/torch_profile.py [PATH ...]  (default: all five paths)

For each path of chip_smoke.py (utils/demo_scene at 1024x768, interval -1,
the camera moving at 0.5c) it renders 5 warm-up frames of `build_render_fn`'s
renderer (one CUDA graph, utils/frame_graph), then times 30 frames
back to back on the host clock with one synchronize at the end (the frame
rate a caller that does not wait per frame sees), then traces 10 more frames
with torch.profiler. It prints one JSON line per path: the card, the frame
time, the kernels launched per frame, the device busy time per frame (the
union of kernel and copy intervals) and its share of the frame, each of the
port's CUDA kernels' device time per frame, and the five other kernels with
the most device time. K4, the live-chunk list build, is three kernels (the
cone table "K4 table", the cull "K4 cull" and the counting sort "K4
sort"): every list build of one eager frame (`render_constants`,
`trace_frame`: a graph's replay runs no Python to hook) is captured and
replayed 10 times
under the profiler alone, which gives its device time per frame (`k4`:
builds per frame, device ms, and the bound of the same work: the spheres,
rays and lane masks read once (a broadcast origin once) and the lists
written once over the memory rate, or about 30 operations per cone test
that the cull ran, read through its group pre-test's skip counter in the
captured frame, and 40 per (block, entry) of the counting sort over the
fp32 rate, the larger of the two; and the cone tables' own bound, their
inputs read once and their rows written once over the memory rate). K3 and K7 (`analytic`): each call of the traced
frame run once more with its `tested` counter, the (warp, object) pairs
whose vote ran the full test and the share skipped, and the bound of the
call as chip_smoke.py counts it: the bytes it must move (K7 reads origins
and directions only on lanes with tmax != 0), or the operations of every
pre-test and of the full tests that ran. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import collections
import json
import math
import pathlib
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import relativitypathtracer_tpu_torch as pt  # noqa: E402
from relativitypathtracer_tpu_torch import render as prender  # noqa: E402
from relativitypathtracer_tpu_torch.ops.kernels import analytic_kernels as ak  # noqa: E402
from relativitypathtracer_tpu_torch.ops.kernels import mesh_batch as mb  # noqa: E402
from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk  # noqa: E402
from relativitypathtracer_tpu_torch.ops.kernels import mesh_large as ml  # noqa: E402
from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene  # noqa: E402

# The port's kernels by what their trace names hold (a name may be mangled or
# demangled; the walks of K5/K6 and K11/K12 are one template fed two lists).
PORT_KERNELS = {"K1": ("shadow_chain_kernel",), "K2/K8": ("footprint_kernel",),
                "K3": ("analytic_nearest_kernel",), "K7": ("analytic_min_t_kernel",),
                "K5": ("shared_walk_kernel", "FlatList"), "K6": ("general_walk_kernel", "FlatList"),
                "K11": ("shared_walk_kernel", "SuperList"),
                "K12": ("general_walk_kernel", "SuperList"),
                "K9": ("batched_shared_walk_kernel",), "K10": ("batched_general_walk_kernel",),
                "K4 table": ("cone_table_kernel",), "K4 cull": ("live_cull",),
                "K4 sort": ("bucket_order_kernel",)}


def _port_kernel(name: str):
    """The id of the port kernel a trace name belongs to, or None."""
    for kid, parts in PORT_KERNELS.items():
        if all(p in name for p in parts) and ("batched" in name) == ("batched" in parts[0]):
            return kid
    return None
# K4's entry points, by the module attribute the walks call them through
LIST_BUILDS = ((mk, "live_chunk_lists"), (mb, "live_chunk_lists_multi"),
               (ml, "large_live_lists"))
PEAK_OPS, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM: fp32 outside the tensor cores, HBM3
# K3/K7 fp32 operations, as chip_smoke.py counts them: a lane's pre-test of
# one object, and the rest of the full test on each lane of a tested warp
K3_OPS, K7_OPS = (40.0, 60.0), (70.0, 55.0)


def _union_ms(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _device_ms(fn, reps: int) -> float:
    """Device time of fn() (the sum of its CUDA kernels and copies) per rep."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def _bytes(*xs) -> int:
    """Bytes of the tensors among xs, each element once: a broadcast
    (stride-0) axis counts one element."""
    return sum(math.prod(n for n, st in zip(x.shape, x.stride()) if st != 0) * x.element_size()
               for x in xs if torch.is_tensor(x))


def _list_bound_ms(args, kw, out, tests) -> float:
    """The least time of one list build (see the module docstring)."""
    moved = _bytes(*args, *kw.values(), *out)
    return max(moved / PEAK_BYTES, (30.0 * tests + 40.0 * out[0].numel()) / PEAK_OPS) * 1e3


def _cull_tests(args, skipped) -> int:
    """The cone tests one cull ran: its group pre-test's `sub` a (block,
    32-chunk group) pair, and the dense 32 x `sub` for each pair that the
    pre-test did not skip."""
    spheres, table, sub = args[:3]
    pairs = table.shape[-2] // sub * -(-spheres.shape[0] // 32)
    return sub * (pairs + 32 * (pairs - int(skipped)))


def list_build(render, scene, state, reps: int = 10) -> dict:
    """K4 per frame: every list build of one frame captured, then replayed."""
    calls, culls, originals = [], [], {}
    for mod, attr in LIST_BUILDS:
        real = originals[(mod, attr)] = getattr(mod, attr)

        def rec(*a, _real=real, _name=attr, **kw):
            first = len(culls)
            out = _real(*a, **kw)
            calls.append((_real, _name, a, kw, out, culls[first:]))
            return out

        setattr(mod, attr, rec)
    real_cull = originals[(mk, "live_cull")] = mk.live_cull

    def counted(*a):
        skipped = torch.zeros(1, dtype=torch.int32, device=a[0].device)
        culls.append((a, skipped))
        return real_cull(*a, skipped=skipped)

    mk.live_cull = counted
    real_table = originals[(mk, "cone_table")] = mk.cone_table
    table_bytes = []

    def table(*a):
        out = real_table(*a)
        table_bytes.append(_bytes(*a, *(out if isinstance(out, tuple) else (out,))))
        return out

    mk.cone_table = table
    try:
        render(scene, state)
    finally:
        for (mod, attr), real in originals.items():
            setattr(mod, attr, real)
    torch.cuda.synchronize()
    ms = _device_ms(lambda: [fn(*a, **kw) for fn, _, a, kw, _, _ in calls], reps)
    return {"builds_per_frame": collections.Counter(c[1] for c in calls),
            "device_ms_per_frame": ms,
            "bound_ms_per_frame": sum(
                _list_bound_ms(a, kw, o, sum(_cull_tests(*c) for c in cs))
                for _, _, a, kw, o, cs in calls),
            "table_bound_ms_per_frame": sum(table_bytes) / PEAK_BYTES * 1e3}


def analytic_work(render, scene, state) -> dict:
    """K3 and K7 of one frame: each call run again with its `tested`
    counter; per kernel the pairs tested, the (warp, object) pairs, the share
    skipped and the bound ms, summed over the frame's calls."""
    calls, originals = [], {}
    for attr in ("analytic_nearest_shared", "analytic_min_t_general"):
        real = originals[attr] = getattr(prender, attr)

        def rec(*a, _real=real, _attr=attr):
            calls.append((_real, _attr, a))
            return _real(*a)

        setattr(prender, attr, rec)
    try:
        render(scene, state)
    finally:
        for attr, real in originals.items():
            setattr(prender, attr, real)
    out = {}
    for real, attr, a in calls:
        tested = torch.zeros(1, dtype=torch.int32, device=a[0].device)
        real(*a, tested=tested)
        G = a[0].shape[0]
        if attr == "analytic_nearest_shared":
            kid, (pre, full), n = "K3", K3_OPS, a[1].shape[1]
            lanes, moved = n, a[0].nbytes + a[1].nbytes + 28 * n
        else:
            kid, (pre, full), n = "K7", K7_OPS, a[5].shape[0]
            lanes = int((a[5] != 0).sum())
            moved = a[0].nbytes + 32 * lanes + 8 * n
        ops = pre * G * lanes + full * 32 * int(tested)
        r = out.setdefault(kid, {"calls": 0, "tested": 0, "pairs": 0, "bound_ms": 0.0})
        r["calls"] += 1
        r["tested"] += int(tested)
        r["pairs"] += G * -(-n // ak.WARP)
        r["bound_ms"] += max(moved / PEAK_BYTES, ops / PEAK_OPS) * 1e3
    for r in out.values():
        r["skipped_share"] = 1.0 - r["tested"] / max(r["pairs"], 1)
    return out


def profile_path(kind: str, card: str, timed: int = 30, traced: int = 10) -> dict:
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        scene, meta = pt.build_scene(pt.load_scene_file(write_demo_scene(tmp, 4, kind)),
                                     device=dev)
    render = pt.build_render_fn(meta, 1024, 768, -1, device=dev)
    consts = prender.render_constants(meta, 1024, 768, 1, dev)

    def eager(sc, st):  # the same frame a launch at a time, for the hooks below
        with prender.full_precision():
            return prender.trace_frame(sc, meta, st, *consts, -1, 1024, 768)

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
    port = collections.Counter()
    for n, v in by_name.items():
        if _port_kernel(n):
            port[_port_kernel(n)] += v
    others = [(n, v) for n, v in by_name.most_common() if not _port_kernel(n)][:5]
    return {"path": kind, "card": card, "wall_ms_per_frame": wall_ms,
            "kernels_per_frame": launches / traced, "busy_ms_per_frame": busy,
            "busy_share": busy / wall_ms, "port_kernels_ms_per_frame": port,
            "top_other_ms_per_frame": others, "k4": list_build(eager, scene, state),
            "analytic": analytic_work(eager, scene, state)}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    for kind in sys.argv[1:] or ("blob", "textured", "cubes", "instances", "large"):
        print(json.dumps(profile_path(kind, card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
