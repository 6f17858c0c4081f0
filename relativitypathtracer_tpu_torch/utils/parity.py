"""Full-resolution parity of the port's frame against the C++ oracle.

Torch counterpart of `relativitypathtracer_tpu.utils.parity`. The oracle
(native/cpu_reference.cpp) implements the whole reference algorithm
independently, the octree walk included (opencl_kernel.cl:620-660); a frame
passes when at most MAX_FRAC_BAD of its pixels are off the oracle's by more
than 1e-3 in some channel.

The oracle is compiled from the repository's source, at its first use in a
process, into build/oracle/ with the flags of native/Makefile (the tracked
binary native/cpu_reference was built with -march=native on another host).
A failed build or run raises.

  python -m relativitypathtracer_tpu_torch.utils.parity [--out FILE] [--device D]
      [SCENE ...|all]

SCENE is a scene file, a fixture kind of utils/demo_scene (blob, textured,
cubes, instances, large) or a corpus name resolved under $REF_ASSETS/Scenes;
`all` is the five fixtures. Exits 1 when a scene fails.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import pathlib
import platform
import subprocess
import sys
import tempfile

import numpy as np
import torch

from .. import __version__
from ..device import DEFAULT_DEVICE
from ..models.dsl import load_scene_file
from ..models.scene import build_scene
from ..render import FrameState, render_frame
from .demo_scene import KINDS, write_demo_scene
from .scene_blob import write_scene_blob

REPO = pathlib.Path(__file__).resolve().parents[2]
REF = os.environ.get("REF_ASSETS")  # the reference's asset tree (Scenes/, Models/, ...)
ORACLE_SRC = REPO / "native" / "cpu_reference.cpp"
ORACLE_DIR = REPO / "build" / "oracle"
ORACLE_FLAGS = ("-O3", "-march=native", "-std=c++17", "-Wall", "-Wextra")  # native/Makefile
MAX_FRAC_BAD = 0.002  # at most 0.2% of pixels off by more than 1e-3
FIXTURE_LEVEL = 4  # the fixtures' subdivision level, as chip_smoke.py builds them


def _host_cpu() -> str:
    """The host's CPU model and feature flags: a -march=native binary runs
    only on a CPU with the features it was built for."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().split("\n\n")[0].splitlines()
        return " ".join(line for line in lines if line.startswith(("model name", "flags")))
    except OSError:
        return platform.processor() or platform.machine()


@functools.cache
def oracle_path() -> str:
    """The oracle binary for this host, compiled from native/cpu_reference.cpp
    into build/oracle/ unless a build of the same source, compiler flags and
    CPU (model and features) is there (written under a temporary name and renamed, so concurrent
    processes never run a half-written binary)."""
    key = hashlib.sha256(ORACLE_SRC.read_bytes() + " ".join(ORACLE_FLAGS).encode()
                         + _host_cpu().encode() + platform.machine().encode()).hexdigest()[:16]
    binary = ORACLE_DIR / f"cpu_reference-{key}"
    if not binary.exists():
        ORACLE_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=ORACLE_DIR, prefix=".build-")
        os.close(fd)
        try:
            res = subprocess.run([os.environ.get("CXX", "g++"), *ORACLE_FLAGS, "-o", tmp,
                                  str(ORACLE_SRC), "-lpthread"], capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"oracle build failed:\n{res.stderr}")
            os.replace(tmp, binary)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return str(binary)


def run_oracle(scene, meta, state, width: int, height: int, workdir: str, tag: str,
               interval: int | None = None, frames: int = 1):
    """Render one frame of `state` with the oracle: ((H, W, 3) float32
    image, bottom-up as the port's, and the oracle's JSON line: p50_ms over
    `frames` runs on every hardware thread, threads, rays)."""
    blob = os.path.join(workdir, f"parity_{tag}.blob")
    out = os.path.join(workdir, f"parity_{tag}.rgb")
    write_scene_blob(blob, scene, meta, state, width, height, interval)
    res = subprocess.run([oracle_path(), blob, out, str(frames)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"oracle failed ({res.returncode}) on {tag}:\n{res.stderr}")
    stats = json.loads(res.stdout.strip().splitlines()[-1])
    return np.fromfile(out, np.float32).reshape(height, width, 3), stats


def compare(ours, ref) -> dict:
    """frac_bad (pixels with a channel off by more than 1e-3), mean_diff, ok."""
    diff = np.abs(np.asarray(ref, np.float32) - np.asarray(ours, np.float32))
    frac_bad = float(np.mean(diff.max(-1) > 1e-3))
    return {"frac_bad": round(frac_bad, 6), "mean_diff": round(float(diff.mean()), 7),
            "ok": bool(frac_bad <= MAX_FRAC_BAD)}


def scene_file(scene: str, workdir: str) -> str:
    """A scene file path for a path, a fixture kind (written under
    `workdir`) or a corpus name (under $REF_ASSETS/Scenes)."""
    if os.path.isfile(scene):
        return scene
    if scene in KINDS:
        return write_demo_scene(os.path.join(workdir, f"fixture_{scene}"), FIXTURE_LEVEL, scene)
    corpus = pathlib.Path(REF or ".") / "Scenes" / f"{scene}.txt"
    if REF and corpus.is_file():
        return str(corpus)
    raise FileNotFoundError(f"{scene!r}: no such scene file, fixture kind ({', '.join(KINDS)}) "
                            "or corpus scene under $REF_ASSETS/Scenes")


def fullres_parity(scene: str, width: int = 1024, height: int = 768,
                   workdir: str | None = None, state=None, tag: str | None = None,
                   device=DEFAULT_DEVICE) -> dict:
    """Render `scene` (a scene file, a fixture kind or a corpus name) with the
    port on `device` and with the oracle, at `state` (default the initial
    one), and compare. Returns {"scene", "frac_bad", "mean_diff", "ok"}."""
    with tempfile.TemporaryDirectory() as tmp:
        workdir = workdir or tmp
        scene_obj, meta = build_scene(load_scene_file(scene_file(scene, workdir)),
                                      device=device)
        if state is None:
            state = FrameState.initial(device)
        tag = tag or pathlib.Path(scene).stem
        ref, _ = run_oracle(scene_obj, meta, state, width, height, workdir, tag)
        ours = render_frame(scene_obj, meta, state, width, height, device=device)
        return {"scene": tag, **compare(ours.cpu().numpy(), ref)}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="relativitypathtracer_tpu_torch.utils.parity")
    ap.add_argument("scenes", nargs="*", default=["all"],
                    help="scene files, fixture kinds or corpus names, or 'all' (the fixtures)")
    ap.add_argument("--out", default=None, help="write the results as one JSON file")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help=f"torch device (default {DEFAULT_DEVICE})")
    args = ap.parse_args(argv)
    device = args.device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("Error: no CUDA device (pass --device cpu to run the plain twins)",
              file=sys.stderr)
        return 1
    names = list(KINDS) if args.scenes == ["all"] else args.scenes
    rc = 0
    results = []
    for name in names:
        res = fullres_parity(name, device=device)
        print(json.dumps(res), flush=True)
        results.append(res)
        if not res["ok"]:
            rc = 1
    if args.out:
        dev = torch.device(device)
        pathlib.Path(args.out).write_text(json.dumps({
            "resolution": "1024x768",
            "max_frac_bad": MAX_FRAC_BAD,
            "platform": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "version": __version__,
            "scenes": results,
            "ok": rc == 0,
        }, indent=1))
        print(f"wrote {args.out}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
