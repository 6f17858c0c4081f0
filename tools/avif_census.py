"""The AVIF tool census: which AV1 and container tools PIL's own AVIF
encodes turn on, over a fixed sweep, and whether the port decodes each.

The sweep: quality 10, 30, 50, 75, 90 and 100; speed 0, 3, 6, 8 and 10;
subsampling 4:2:0, 4:2:2, 4:4:4 and 4:0:0; full and limited range; four
contents: a seeded 128x128 photographic picture (the fixtures'
`_picture`), the textured scene's 32x32 texture, 64x64 flat squares and
those squares tiled to 256x256 (the cubes scene's texture size, where aom
turns on intra block copy). Then, at quality 50 and speed 6 in each
subsampling and content: aom's film grain test vectors 1-16
(`film-grain-test`), grain aom estimates (`denoise-noise-level` 25) and
quantiser matrices at each level 0-15 (`enable-qm` with qm-min = qm-max).
Each file is encoded by PIL (Pillow with libavif and aom) and read by
`utils/avif_decode.census`; every file the port decodes is also held to
PIL's pixels.

    python tools/avif_census.py [--jobs N] [--out build/avif_census.json]

prints one line per (tool, content) with the settings that turned it on,
and writes every file's tools as JSON. It needs Pillow; the port does not.
"""

from __future__ import annotations

import argparse
import io
import itertools
import json
import multiprocessing
import pathlib
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests" / "torch_textures"))

QUALITIES = (10, 30, 50, 75, 90, 100)
SPEEDS = (0, 3, 6, 8, 10)
SUBSAMPLINGS = ("4:2:0", "4:2:2", "4:4:4", "4:0:0")
RANGES = ("full", "limited")
CONTENTS = ("picture", "texture", "squares", "squares256")


def content(name: str) -> np.ndarray:
    from make_fixtures import SEED, _picture

    from relativitypathtracer_tpu_torch.utils.demo_scene import demo_texture
    if name == "picture":
        return _picture(np.random.default_rng(SEED), 128, 128)
    if name == "texture":
        return demo_texture(32)
    square = np.add.outer(np.arange(64) // 8 * 3, np.arange(64) // 8 * 5) % 6
    colours = np.random.default_rng(SEED).integers(30, 225, (6, 3)).astype(np.uint8)
    if name == "squares256":
        return np.tile(colours[square], (4, 4, 1))
    return colours[square]


def one(case: tuple) -> dict:
    from PIL import Image

    from relativitypathtracer_tpu_torch.utils import avif_decode
    name, q, speed, ss, rg, advanced = case
    buf = io.BytesIO()
    Image.fromarray(content(name)).save(buf, "AVIF", quality=q, speed=speed, subsampling=ss,
                                        range=rg, advanced=dict(advanced))
    data = buf.getvalue()
    tools = avif_decode.census(data)
    refused = sorted(t[1] for t in tools if isinstance(t, tuple) and t[0] == "refused")
    equal = None
    if not refused:
        mine = avif_decode.decode_avif(data)
        equal = bool(np.array_equal(mine, np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))))
    names = sorted(t if isinstance(t, str) else f"{t[0]} {t[1]}" for t in tools
                   if not (isinstance(t, tuple) and t[0] == "refused"))
    return {"content": name, "quality": q, "speed": speed, "subsampling": ss, "range": rg,
            "advanced": dict(advanced), "bytes": len(data), "tools": names, "refused": refused,
            "equal_to_pil": equal}


def cases() -> list:
    """The sweep's (content, quality, speed, subsampling, range, aom options)."""
    out = [case + ((),) for case in itertools.product(CONTENTS, QUALITIES, SPEEDS,
                                                      SUBSAMPLINGS, RANGES)]
    options = ([(("film-grain-test", str(t)),) for t in range(1, 17)]
               + [(("denoise-noise-level", "25"),)]
               + [(("enable-qm", "1"), ("qm-min", str(v)), ("qm-max", str(v)))
                  for v in range(16)])
    for name, ss, opts in itertools.product(CONTENTS, SUBSAMPLINGS, options):
        out.append((name, 50, 6, ss, "full", opts))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default=str(ROOT / "build" / "avif_census.json"))
    args = ap.parse_args()
    with ProcessPoolExecutor(args.jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        rows = list(pool.map(one, cases(), chunksize=4))
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(rows, indent=0) + "\n")
    table: dict = {}
    for r in rows:
        for t in r["tools"] + [f"REFUSED {x}" for x in r["refused"]]:
            table.setdefault((t, r["content"]), []).append(r)
    for (tool, name), rs in sorted(table.items()):
        options = sorted({" ".join(f"{k}={v}" for k, v in r["advanced"].items())
                          for r in rs if r["advanced"]})
        speeds = sorted({r["speed"] for r in rs})
        quals = sorted({r["quality"] for r in rs})
        sss = sorted({r["subsampling"] for r in rs})
        print(f"{tool:44s} {name:8s} files {len(rs):3d} speeds {speeds} qualities {quals} "
              f"subsamplings {sss}" + (f" options {len(options)}" if options else ""))
    for tool in sorted({t for t, _ in table}):
        print(f"files with {tool}: {sum(len(rs) for (t, _), rs in table.items() if t == tool)}")
    bad = [r for r in rows if r["equal_to_pil"] is False]
    refused = [r for r in rows if r["refused"]]
    print(f"files {len(rows)}, decoded {sum(r['equal_to_pil'] is not None for r in rows)}, "
          f"unequal to PIL {len(bad)}, refused {len(refused)}"
          + "".join(f"\n  refused: {r['content']} q{r['quality']} s{r['speed']} "
                    f"{r['subsampling']} {r['range']} {r['advanced']}: {', '.join(r['refused'])}"
                    for r in refused))
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
