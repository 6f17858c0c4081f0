"""Time utils/image_decode.decode_jpeg of two trees of the port in turns on
this host's CPU: the 2048x2048 utils/demo_scene.demo_texture through
utils/image.encode_jpeg (chip_smoke.py's corpus-sized JPEG), decoded by
each tree in a fresh process, in the order A, B, B, A (then again for
--rounds), each process taking the best of --repeat decodes.

    python tools/jpeg_decode_turns.py A_ROOT B_ROOT [--rounds 2] [--repeat 3]

A_ROOT and B_ROOT are checkouts (each holding relativitypathtracer_tpu_torch/).
Prints one JSON line a process (tree, seconds, the decode's SHA-256) and a
last JSON line with each tree's median, B's over A's, the host's CPU model
and, where nvidia-smi answers, the card's name and power limit: these are
host CPU times, not a card's. Exits 1 if the trees decode to other bytes.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

CHILD = """
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
from relativitypathtracer_tpu_torch.utils import image, image_decode
from relativitypathtracer_tpu_torch.utils.demo_scene import demo_texture
data = image.encode_jpeg(demo_texture(2048))
best, rgb = None, None
for _ in range(int(sys.argv[2])):
    t0 = time.perf_counter()
    rgb = image_decode.decode_jpeg(data)
    s = time.perf_counter() - t0
    best = s if best is None else min(best, s)
print(json.dumps({"seconds": best, "sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
                  "bytes": len(data)}))
"""


def _cpu_model() -> str:
    try:
        for line in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def _card() -> str | None:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a_root")
    ap.add_argument("b_root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    roots = {"A": str(pathlib.Path(args.a_root).resolve()),
             "B": str(pathlib.Path(args.b_root).resolve())}
    times, hashes = {"A": [], "B": []}, set()
    for _ in range(args.rounds):
        for tree in "ABBA":
            out = subprocess.run([sys.executable, "-c", CHILD, roots[tree], str(args.repeat)],
                                 capture_output=True, text=True, check=True)
            got = json.loads(out.stdout.strip().splitlines()[-1])
            times[tree].append(got["seconds"])
            hashes.add(got["sha256"])
            print(json.dumps({"tree": tree, "root": roots[tree], **got}), flush=True)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(json.dumps({"median_s": med, "b_over_a": med["B"] / med["A"], "same_bytes":
                      len(hashes) == 1, "cpu": _cpu_model(), "card": _card()}))
    return 0 if len(hashes) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
