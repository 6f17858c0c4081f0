#!/usr/bin/env python3
"""K3 and K7 of one or more checkouts of this repository, timed in turns.

    python tools/analytic_turns.py CHECKOUT [CHECKOUT ...]

Name a checkout twice to alternate (`old new new old`): each one is
measured in a fresh process, in the order given. That process imports the
checkout's own relativitypathtracer_tpu_torch and chip_smoke.py, builds its
kernels, renders the first frame of the cubes and textured fixtures
(utils/demo_scene, 1024x768, interval -1, the camera at rest) and captures
the inputs of that frame's K3 and K7 calls. It prints one JSON line: the
card's name and power limit; for each call, the kernel's device ms a launch
three times (chip_smoke.kernel_ms: CUDA-graph replay, inputs read from
memory); whether it equals its plain twin (K3's t, normal and object id,
K7's t, to the bit); the share of (warp, object) pairs in which the twin,
run on each object alone, hits some lane (K7: lanes with tmax != 0); and,
where the checkout has `object_may_hit_plain`, the share of pairs that its
pre-test lets through. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

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


def measure(checkout: str) -> dict:
    root = pathlib.Path(checkout).resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch

    import chip_smoke
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch import render as prender
    from relativitypathtracer_tpu_torch.ops.kernels import analytic_kernels as ak
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    out = {"checkout": str(root), "card": card}
    kernels = {"K3": "analytic_nearest_shared", "K7": "analytic_min_t_general"}
    for path in ("cubes", "textured"):
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
