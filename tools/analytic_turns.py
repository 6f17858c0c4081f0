#!/usr/bin/env python3
"""K3 and K7, and K2/K8 with its flat-colour select, of one or more
checkouts of this repository, timed in turns.

    python tools/analytic_turns.py CHECKOUT [CHECKOUT ...]

Name a checkout twice to alternate (`old new new old`): each one is
measured in a fresh process, in the order given. That process imports the
checkout's own relativitypathtracer_tpu_torch and chip_smoke.py, builds its
kernels, renders the first frame of the cubes, textured and instances
fixtures (utils/demo_scene, 1024x768, interval -1, the camera at rest) and
captures the inputs of that frame's K3, K7 and footprint-fetch calls. It
prints one JSON line: the card's name and power limit; for each K3/K7 call,
the kernel's device ms a launch three times (chip_smoke.kernel_ms:
CUDA-graph replay, inputs read from memory); whether it equals its plain
twin (K3's t, normal and object id, K7's t, to the bit); the share of
(warp, object) pairs in which the twin, run on each object alone, hits some
lane (K7: lanes with tmax != 0); and, where the checkout has
`object_may_hit_plain`, the share of pairs that its pre-test lets through.
For each fetch (`fetch PATH`), timed the same way three times:
  - `texel_ms`: the kernel alone, the texel on every lane (like for like
    across checkouts);
  - `ops_ms`: where the checkout selects the flat colour in torch ops after
    the kernel (render.shade: the colour and tex_offset gathers, `!= -1`,
    `torch.where`), those four ops alone;
  - `hit_color_ms`: what the frame spends for the hit colour: the kernel
    with its select where it takes one, else the kernel and the four ops;
and the lanes, the textured lanes, `copy_ms` (a clone of a (3, N) f32
tensor, timed the same way: 24 B a lane read and written, the fetch's
lane bytes), the bound of the kernel's bytes (ids, uv and RGB once a lane,
the atlas and object rows once, over 3.35 TB/s), and its hit colour's max
abs difference from the checkout's twin. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import inspect
import json
import os
import pathlib
import subprocess
import sys
import tempfile

WARP = 32


def _pair_share(torch, mask) -> float:
    """Share of (warp, object) groups of `mask` (G, N) with any lane set."""
    G, n = mask.shape
    mask = torch.cat([mask, mask.new_zeros((G, -n % WARP))], dim=1)
    return float(mask.reshape(G, -1, WARP).any(dim=2).float().mean())


def _fetch(torch, smoke, tk, scene, fn, args) -> dict:
    """The frame's footprint fetch (its captured arguments) and the hit
    colour it gives: the kernel alone, the four select ops after it where
    the checkout's frame runs them, and the two together."""
    quads, table, obj, uv = args[:4]
    objects = scene.objects
    obj_l = obj.long()
    textured = objects.tex_offset[obj_l] != -1

    def ops(tex_rgb, color, tex_offset, o_l):  # render.shade's select before the kernel took it
        return torch.where((tex_offset[o_l] != -1)[None, :], tex_rgb, color.T[:, o_l])

    texel = [smoke.kernel_ms(torch, fn, [quads, table, obj, uv]) for _ in range(3)]
    if "color" in inspect.signature(fn).parameters:
        got, want = fn(*args), tk.footprint_fetch_plain(*args)[0]
        r = {"select_in_kernel": True, "ops_ms": None,
             "hit_color_ms": [smoke.kernel_ms(torch, fn, list(args)) for _ in range(3)]}
    else:
        rest = [objects.color, objects.tex_offset, obj_l]
        tex_rgb = fn(*args)
        got, want = ops(tex_rgb, *rest), ops(tk.footprint_fetch_plain(*args)[0], *rest)
        r = {"select_in_kernel": False,
             "ops_ms": [smoke.kernel_ms(torch, ops, [tex_rgb, *rest]) for _ in range(3)],
             "hit_color_ms": [smoke.kernel_ms(
                 torch, lambda q, t, o, u, *more: ops(fn(q, t, o, u), *more),
                 [quads, table, obj, uv, *rest]) for _ in range(3)]}
    n = obj.numel()
    moved = sum(x.numel() * x.element_size()
                for x in (quads, table, obj, uv, objects.color, objects.tex_offset)) + 12 * n
    # a yardstick of the bytes: one PyTorch copy that reads and writes
    # 24 B a lane, as the fetch's lanes do
    lanes = torch.empty((3, n), dtype=torch.float32, device=obj.device)
    return {"route": tk.texture_route(quads.shape[0]), "lanes": n,
            "textured_lanes": int(textured.sum()), "texel_ms": texel, **r,
            "copy_ms": [smoke.kernel_ms(torch, torch.clone, [lanes]) for _ in range(3)],
            "bound_ms": moved / 3.35e12 * 1e3,
            "max_abs_err_twin": float((got - want).abs().max())}


def measure(checkout: str) -> dict:
    root = pathlib.Path(checkout).resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch

    import chip_smoke
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch import render as prender
    from relativitypathtracer_tpu_torch.ops.kernels import analytic_kernels as ak
    from relativitypathtracer_tpu_torch.ops.kernels import texture_kernel as tk
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    out = {"checkout": str(root), "card": card}
    kernels = {"K3": "analytic_nearest_shared", "K7": "analytic_min_t_general",
               "fetch": "footprint_fetch"}
    for path in ("cubes", "textured", "instances"):
        with tempfile.TemporaryDirectory() as tmp:
            scene, meta = pt.build_scene(pt.load_scene_file(write_demo_scene(tmp, 4, path)),
                                         device=dev)
        captured, real = {}, {k: getattr(prender, a) for k, a in kernels.items()}
        for kid, attr in kernels.items():
            setattr(prender, attr,
                    lambda *a, _k=kid: captured.setdefault(_k, a) and real[_k](*a))
        try:
            pt.build_render_fn(meta, 1024, 768, -1, device=dev)(
                scene, pt.FrameState(torch.zeros(3, device=dev), torch.zeros(4, device=dev)))
        finally:
            for kid, attr in kernels.items():
                setattr(prender, attr, real[kid])
        for kid, args in captured.items():
            fn = real[kid]
            if kid == "fetch":
                out[f"fetch {path}"] = _fetch(torch, chip_smoke, tk, scene, fn, args)
                continue
            if kid == "K3":
                params, dir4, ns, nc = args
                origins, active = None, torch.ones(dir4.shape[1], dtype=torch.bool, device=dev)
                got, want = fn(*args), ak.analytic_nearest_plain(*args)
                equal = all(torch.equal(g, w) for i, (g, w) in enumerate(zip(got, want))
                            if i != 2)  # uv: CUDA's atan2f/asinf against PyTorch's
                one = [ak.analytic_nearest_plain(params[g:g + 1], dir4, int(g < ns),
                                                 int(g >= ns))[0] for g in range(ns + nc)]
            else:
                params, origins, dir4, ns, nc, tmax = args
                active = tmax != 0
                got, want = fn(*args), ak.analytic_min_t_plain(*args)
                equal = torch.equal(got.view(torch.int32), want.view(torch.int32))
                ones = torch.ones_like(tmax)
                one = [ak.analytic_min_t_plain(params[g:g + 1], origins, dir4, int(g < ns),
                                               int(g >= ns), ones) for g in range(ns + nc)]
            hit = (torch.stack(one) != ak.INF) & active
            r = {"objects": ns + nc, "equal_to_twin": bool(equal),
                 "ms": [chip_smoke.kernel_ms(torch, fn, list(args)) for _ in range(3)],
                 "hit_pair_share": _pair_share(torch, hit)}
            if hasattr(ak, "object_may_hit_plain"):
                may = ak.object_may_hit_plain(params, dir4, ns, nc, origins) & active
                r["pretest_pair_share"] = _pair_share(torch, may)
            out[f"{kid} {path}"] = r
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
        print("analytic_turns: needs a CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(measure(checkouts[0])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
