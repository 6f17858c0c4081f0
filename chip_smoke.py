#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root:  python3 chip_smoke.py

It needs a CUDA device and nvcc, and fails (non-zero exit, no result line)
without them. In order it:
  1. builds the port's CUDA kernels from relativitypathtracer_tpu_torch/csrc;
  2. writes the procedural fixture (utils/demo_scene, subdivision level 4:
     one 5,120-triangle mesh moving at 0.5c and one light sphere) and loads it
     through load_scene_file -> build_scene(device="cuda") -> build_render_fn
     at 1024x768, interval -1 (light propagation and shadows on);
  3. renders 3 frames with advancing time, the last with the camera moving at
     0.5c, and checks the image and the counts, and that each of the path's
     four kernels (K1 shadow chain, K3 analytic nearest hit, K5 mesh primary
     walk, K6 mesh shadow walk) was launched;
  4. runs each kernel against its plain PyTorch twin, both on the card, on
     the inputs the first frame gave it, and times both (CUDA events,
     median of 20 runs);
  5. renders the same frame with the port on the CPU (the plain twins) and
     holds the card's frame to it under the parity rule (at most 0.2% of
     pixels off by more than 1e-3);
  6. times the frame (p50/p95 over 60 frames after warm-up, CUDA events) and
     reports Mrays/s counting primary plus shadow rays.
It prints the kernels' JSON line, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}. Any failed check raises.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

WIDTH, HEIGHT = 1024, 768
LEVEL = 4
DEVICE = "cuda"
REPLACES = {  # C entry -> (id, source, TPU kernel it replaces)
    "rpt_shadow_chain": ("K1", "relativitypathtracer_tpu_torch/csrc/shadow_chain.cu",
                         "relativitypathtracer_tpu/ops/pallas/shadow_chain.py:50"),
    "rpt_analytic_nearest": ("K3", "relativitypathtracer_tpu_torch/csrc/analytic_kernels.cu",
                             "relativitypathtracer_tpu/ops/pallas/analytic_kernels.py:308"),
    "rpt_shared_walk": ("K5", "relativitypathtracer_tpu_torch/csrc/mesh_kernels.cu",
                        "relativitypathtracer_tpu/ops/pallas/mesh_kernels.py:514"),
    "rpt_general_walk": ("K6", "relativitypathtracer_tpu_torch/csrc/mesh_kernels.cu",
                         "relativitypathtracer_tpu/ops/pallas/mesh_kernels.py:825"),
}


class CheckFailed(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int = 20, warmup: int = 2) -> float:
    """Median milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch import render as prender
    from relativitypathtracer_tpu_torch.ops.kernels import _build
    from relativitypathtracer_tpu_torch.ops.kernels import analytic_kernels as ak
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk
    from relativitypathtracer_tpu_torch.ops.kernels import shadow_chain as sc
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")

    dev = torch.device(DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        host = pt.load_scene_file(write_demo_scene(tmp, LEVEL))
        scene, meta = pt.build_scene(host, device=dev)
        log(f"scene: {meta.num_tris} triangles, {len(meta.sphere_ids)} sphere(s), "
            f"lights {meta.light_ids}, built in {time.perf_counter() - t0:.1f} s")
    check(meta.num_tris == 20 * 4 ** LEVEL and meta.light_ids, "fixture shape")
    render = pt.build_render_fn(meta, WIDTH, HEIGHT, -1, with_aux=True, device=dev)
    states = [
        pt.FrameState(torch.zeros(3, device=dev), torch.tensor([0.0, 0, 0, 0], device=dev)),
        pt.FrameState(torch.zeros(3, device=dev), torch.tensor([1 / 30, 0, 0, 0], device=dev)),
        pt.FrameState(torch.tensor([0.5, 0.0, 0.0], device=dev),
                      torch.tensor([2 / 30, 0, 0, 0], device=dev)),
    ]

    # Record each kernel's inputs during the first frame (the wrappers are
    # looked up through these module attributes on the main path).
    captured, recording = {}, [True]
    hooks = [(prender, "shadow_chain", "rpt_shadow_chain"),
             (prender, "analytic_nearest_shared", "rpt_analytic_nearest"),
             (mk, "shared_walk", "rpt_shared_walk"),
             (mk, "general_walk", "rpt_general_walk")]
    originals = {}
    for mod, attr, name in hooks:
        fn = getattr(mod, attr)
        originals[name] = fn

        def rec(*args, _fn=fn, _name=name):
            if recording[0] and _name not in captured:
                captured[_name] = args
            return _fn(*args)

        setattr(mod, attr, rec)

    # --- the main path: three frames --------------------------------------
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    frames = []
    for i, st in enumerate(states):
        img, aux = render(scene, st)
        if i == 0:
            recording[0] = False
        frames.append((img, {k: int(v) for k, v in aux.items()}))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for mod, attr, name in hooks:
        setattr(mod, attr, originals[name])
    log(f"main path launches: {launches}")
    for img, aux in frames:
        check(tuple(img.shape) == (HEIGHT, WIDTH, 3), f"image shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), "non-finite pixels")
        check(aux["hits"] > 0 and aux["shadow_rays"] > 0, f"counts {aux}")
        check(0 < aux["lit_rays"] < aux["shadow_rays"], f"no lit or no occluded lanes: {aux}")
        log(f"frame: {aux}, mean {float(img.mean()):.6f}")
    for name in REPLACES:
        check(launches.get(name, 0) > 0, f"{name} was not launched on the main path")
        check(name in captured, f"{name}: no inputs captured")

    # --- each kernel against its plain twin, on the card ------------------
    INF = 1e20
    results = {}

    def record(name, err, fn, plain):
        results[name] = {"max_abs_err": err, "ms": time_ms(torch, fn),
                         "plain_ms": time_ms(torch, plain)}
        log(f"{name}: max_abs_err {err:.3e}, kernel {results[name]['ms']:.4f} ms, "
            f"plain {results[name]['plain_ms']:.4f} ms")

    args = captured["rpt_shadow_chain"]
    got = originals["rpt_shadow_chain"](*args)
    want = sc.shadow_chain_plain(*args)
    light = meta.light_ids[0]
    relevant = (args[3] < INF) & (args[5] != light) & (want[2] > 0)
    check(int(relevant.sum()) > 0, "K1: no relevant lanes")
    err = 0.0
    for g, w in zip(got, want):
        check(torch.allclose(g[..., relevant], w[..., relevant], rtol=1e-5, atol=1e-6),
              "K1 disagrees with its twin")
        err = max(err, float((g[..., relevant] - w[..., relevant]).abs().max()))
    record("rpt_shadow_chain", err, lambda: originals["rpt_shadow_chain"](*args),
           lambda: sc.shadow_chain_plain(*args))

    args3 = captured["rpt_analytic_nearest"]
    gt, gn, guv, go = originals["rpt_analytic_nearest"](*args3)
    wt, wn, wuv, wo = ak.analytic_nearest_plain(*args3)
    hit = wt < INF
    check(bool(torch.equal(gt < INF, hit)) and int(hit.sum()) > 0, "K3 hit masks")
    check(float((go[hit] != wo[hit]).float().mean()) <= 1e-3, "K3 object ids")
    same = hit & (go == wo)
    check(torch.allclose(gt[same], wt[same], rtol=1e-5), "K3 t")
    check(torch.allclose(gn[:, same], wn[:, same], atol=1e-5), "K3 normal")
    check(torch.allclose(guv[:, same], wuv[:, same], atol=1e-5), "K3 uv")
    err = max(float((gt[same] - wt[same]).abs().max()), float((gn - wn)[:, same].abs().max()),
              float((guv - wuv)[:, same].abs().max()))
    record("rpt_analytic_nearest", err, lambda: originals["rpt_analytic_nearest"](*args3),
           lambda: ak.analytic_nearest_plain(*args3))

    args5 = captured["rpt_shared_walk"]
    gt, gu, gv, gtri, gattr = originals["rpt_shared_walk"](*args5)
    wt, wu, wv, wtri, wattr = mk.shared_walk_plain(*args5)
    hit = wtri >= 0
    check(bool(torch.equal(gtri >= 0, hit)) and int(hit.sum()) > 0, "K5 hit masks")
    check(float((gtri != wtri).float().mean()) <= 1e-3, "K5 triangle ids")
    same = hit & (gtri == wtri)
    check(torch.allclose(gt[same], wt[same], rtol=1e-5), "K5 t")
    check(torch.allclose(gattr[:, same], wattr[:, same], atol=1e-4), "K5 attributes")
    err = max(float((gt[same] - wt[same]).abs().max()),
              float((gattr - wattr)[:, same].abs().max()))
    record("rpt_shared_walk", err, lambda: originals["rpt_shared_walk"](*args5),
           lambda: mk.shared_walk_plain(*args5))

    args6 = captured["rpt_general_walk"]
    got6 = originals["rpt_general_walk"](*args6)
    want6 = mk.general_walk_plain(*args6)
    tmax = args6[6][0]
    masked = tmax > 0
    check(int(masked.sum()) > 0, "K6: no shadow lanes")
    check(bool(torch.equal((got6 >= tmax)[masked], (want6 >= tmax)[masked])), "K6 lit masks")
    err = float((got6 - want6).abs().max())
    record("rpt_general_walk", err, lambda: originals["rpt_general_walk"](*args6),
           lambda: mk.general_walk_plain(*args6))
    del captured

    # --- the card's frame against the port's CPU frame --------------------
    t0 = time.perf_counter()
    cpu_scene, cpu_meta = pt.build_scene(host, device="cpu")
    cpu_render = pt.build_render_fn(cpu_meta, WIDTH, HEIGHT, -1, with_aux=True, device="cpu")
    cpu_state = pt.FrameState(states[2].cam_velocity.cpu(), states[2].cam_pos.cpu())
    cpu_img, cpu_aux = cpu_render(cpu_scene, cpu_state)
    cpu_s = time.perf_counter() - t0
    card_img, card_aux = frames[2]
    diff = (card_img.cpu() - cpu_img).abs().amax(dim=-1)
    frac_bad = float((diff > 1e-3).float().mean())
    log(f"card vs CPU frame at {WIDTH}x{HEIGHT}: frac_bad {frac_bad:.6f}, max diff "
        f"{float(diff.max()):.3e}; CPU {cpu_s:.1f} s, card counts {card_aux}, "
        f"CPU counts {({k: int(v) for k, v in cpu_aux.items()})}")
    check(frac_bad <= 0.002, f"card frame off the CPU frame on {frac_bad:.4%} of pixels")

    # --- frame time --------------------------------------------------------
    state = states[2]
    for _ in range(5):
        render(scene, state)
    times = []
    for _ in range(60):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, aux = render(scene, state)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    p50, p95 = times[len(times) // 2], times[int(0.95 * (len(times) - 1))]
    rays = WIDTH * HEIGHT + int(aux["shadow_rays"])
    log(f"frame {WIDTH}x{HEIGHT} on {card}: p50 {p50:.3f} ms, p95 {p95:.3f} ms, "
        f"{rays / (p50 * 1e3):.2f} Mrays/s ({rays} rays: primary + {int(aux['shadow_rays'])}"
        f" shadow), peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")

    kernels = []
    for name, (kid, source, replaces) in REPLACES.items():
        r = results[name]
        kernels.append({"name": f"{kid} {name}", "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
