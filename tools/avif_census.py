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
Then premultiplied alpha (`alpha_premultiplied=True`, a seeded alpha
plane) at quality 30, 75 and 100, speed 3 and 6, in each subsampling and
content. Each file is encoded by PIL (Pillow with libavif and aom), and
each encode also edited to 10 and to 12 bits (the fixtures'
`high_bitdepth_edit`: the same AV1 symbols under a high-bit-depth sequence
header, which PIL decodes or refuses); every file is read by
`utils/avif_decode.census`, and every file PIL decodes is held to PIL's
pixels with PIL blocked from the port; where PIL refuses an edit (a
palette's literals read with more bits desynchronise the tile), the port
must refuse it too.

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


def _alpha(shape: tuple) -> np.ndarray:
    """A seeded alpha plane: a diagonal ramp under noise, 0 and 255 among
    its values."""
    from make_fixtures import SEED
    h, w = shape
    ramp = np.add.outer(np.arange(h) * 255 // max(h - 1, 1), np.arange(w) * 255 // max(w - 1, 1))
    noise = np.random.default_rng(SEED + 1).integers(-40, 40, (h, w))
    return np.clip(ramp // 2 + noise, 0, 255).astype(np.uint8)


def _row(data: bytes) -> dict:
    """What PIL and the port make of one file: the tools, whether each
    decodes, and whether the pixels agree."""
    from PIL import Image

    from relativitypathtracer_tpu_torch.utils import avif_decode
    try:
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:  # noqa: BLE001 - PIL's refusal is a result here
        want = None
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None
    try:
        tools = avif_decode.census(data)
        refused = sorted(t[1] for t in tools if isinstance(t, tuple) and t[0] == "refused")
        mine = None if refused else avif_decode.decode_avif(data)
    except ValueError:
        tools, refused, mine = set(), [], None
    finally:
        sys.modules["PIL"] = saved
    names = sorted(t if isinstance(t, str) else f"{t[0]} {t[1]}" for t in tools
                   if not (isinstance(t, tuple) and t[0] == "refused"))
    return {"bytes": len(data), "tools": names, "refused": refused,
            "pil_decodes": want is not None, "port_decodes": mine is not None,
            "equal_to_pil": (bool(np.array_equal(mine, want))
                             if want is not None and mine is not None else None)}


def one(case: tuple) -> list:
    """The rows of a case: its encode, then the encode at 10 and 12 bits."""
    from make_fixtures import high_bitdepth_edit
    from PIL import Image
    name, q, speed, ss, rg, advanced, prem = case
    buf = io.BytesIO()
    pixels = content(name)
    im = (Image.fromarray(np.dstack([pixels, _alpha(pixels.shape[:2])]), "RGBA") if prem
          else Image.fromarray(pixels))
    im.save(buf, "AVIF", quality=q, speed=speed, subsampling=ss, range=rg,
            advanced=dict(advanced), **({"alpha_premultiplied": True} if prem else {}))
    data = buf.getvalue()
    base = {"content": name, "quality": q, "speed": speed, "subsampling": ss, "range": rg,
            "advanced": dict(advanced), "premultiplied": prem}
    return [dict(base, depth=depth, **_row(data if depth == 8 else
                                           high_bitdepth_edit(data, depth)))
            for depth in (8, 10, 12)]


def cases() -> list:
    """The sweep's (content, quality, speed, subsampling, range, aom options)."""
    out = [case + ((), False) for case in itertools.product(CONTENTS, QUALITIES, SPEEDS,
                                                             SUBSAMPLINGS, RANGES)]
    options = ([(("film-grain-test", str(t)),) for t in range(1, 17)]
               + [(("denoise-noise-level", "25"),)]
               + [(("enable-qm", "1"), ("qm-min", str(v)), ("qm-max", str(v)))
                  for v in range(16)])
    for name, ss, opts in itertools.product(CONTENTS, SUBSAMPLINGS, options):
        out.append((name, 50, 6, ss, "full", opts, False))
    for name, q, speed, ss in itertools.product(CONTENTS, (30, 75, 100), (3, 6), SUBSAMPLINGS):
        out.append((name, q, speed, ss, "full", (), True))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default=str(ROOT / "build" / "avif_census.json"))
    args = ap.parse_args()
    with ProcessPoolExecutor(args.jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        rows = [r for rs in pool.map(one, cases(), chunksize=2) for r in rs]
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(rows, indent=0) + "\n")
    table: dict = {}
    for r in rows:
        for t in (r["tools"] if r["port_decodes"] else []) + [f"REFUSED {x}" for x in r["refused"]]:
            table.setdefault((t, r["content"]), []).append(r)
    for (tool, name), rs in sorted(table.items()):
        options = sorted({" ".join(f"{k}={v}" for k, v in r["advanced"].items())
                          for r in rs if r["advanced"]})
        speeds = sorted({r["speed"] for r in rs})
        quals = sorted({r["quality"] for r in rs})
        sss = sorted({r["subsampling"] for r in rs})
        depths = sorted({r["depth"] for r in rs})
        print(f"{tool:44s} {name:10s} files {len(rs):4d} speeds {speeds} qualities {quals} "
              f"subsamplings {sss} depths {depths}"
              + (f" options {len(options)}" if options else ""))
    for tool in sorted({t for t, _ in table}):
        print(f"decoded files with {tool}: "
              f"{sum(len(rs) for (t, _), rs in table.items() if t == tool)}")
    bad = [r for r in rows if r["equal_to_pil"] is False or r["pil_decodes"] != r["port_decodes"]]
    refused = [r for r in rows if r["refused"]]
    for depth in (8, 10, 12):
        rs = [r for r in rows if r["depth"] == depth]
        print(f"{depth}-bit files {len(rs)} (premultiplied {sum(r['premultiplied'] for r in rs)}): "
              f"PIL decodes {sum(r['pil_decodes'] for r in rs)}, the port decodes "
              f"{sum(r['port_decodes'] for r in rs)}, equal to PIL "
              f"{sum(bool(r['equal_to_pil']) for r in rs)}, both refuse "
              f"{sum(not r['pil_decodes'] and not r['port_decodes'] for r in rs)}")
    print(f"files {len(rows)}, decoded {sum(r['equal_to_pil'] is not None for r in rows)}, "
          f"unequal to PIL or decoded by one side only {len(bad)}, refused {len(refused)}"
          + "".join(f"\n  refused: {r['content']} q{r['quality']} s{r['speed']} "
                    f"{r['subsampling']} {r['range']} {r['advanced']}: {', '.join(r['refused'])}"
                    for r in refused))
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
