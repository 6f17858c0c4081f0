"""Extract the AV1 specification's Quantizer_Matrix and Gaussian_Sequence
from the libavif library that ships in Pillow 12.1.0's wheel, and pack them
into utils/av1_tables.py as `_QM_BLOB` and `_GAUSS_BLOB` (zlib, then base64,
as `_CDF_BLOB` is packed).

Where the bytes come from: `pillow.libs/libavif-01e67780.so.16.3.0` (libavif
1.3.0, which links aom and dav1d 1.5.1 statically) holds
- aom's `iwt_matrix_ref`, the specification's Quantizer_Matrix[15][2][3344]
  (level, then luma and chroma, each plane's sizes 4x4, 8x8, 16x16, 32x32,
  4x8, 8x4, 8x16, 16x8, 16x32, 32x16, 4x16, 16x4, 8x32, 32x8 one after the
  other), as 100,320 uint8 at byte offset 4,078,880;
- dav1d's `dav1d_gaussian_sequence`, the specification's
  Gaussian_Sequence[2048], as little-endian int16 at byte offset 4,651,456.
The anchors checked before anything is written: level 0's luma 4x4 reads
32 43 73 97 43 67 94 110 73 94 137 150 97 110 150 200 and occurs once in the
file, its chroma starts 35 46 57 66, level 14 lies within 30-32; the
sequence starts 56 568 -180 172 124 -84, ends 944 428 -484, spans -1752 to
1688 and occurs once in the file.

    python tools/av1_tables_extract.py [--lib PATH] [--write]

Without --write it checks that the committed tables equal the library's
bytes (exit 1 if not); with --write it rewrites the two blobs. Without
--lib it looks for the library beside the installed PIL package.
"""

from __future__ import annotations

import argparse
import base64
import pathlib
import re
import sys
import zlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
TABLES = ROOT / "relativitypathtracer_tpu_torch" / "utils" / "av1_tables.py"
LIBRARY = "libavif-01e67780.so.16.3.0"
QM_OFFSET, QM_COUNT = 4_078_880, 15 * 2 * 3344
GAUSS_OFFSET, GAUSS_COUNT = 4_651_456, 2048
QM_ANCHOR = bytes([32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150, 97, 110, 150, 200])


def find_library() -> pathlib.Path | None:
    """The libavif of the installed Pillow wheel, or None."""
    try:
        import PIL
    except ImportError:
        return None
    path = pathlib.Path(PIL.__file__).resolve().parents[1] / "pillow.libs" / LIBRARY
    return path if path.is_file() else None


def extract(lib: pathlib.Path) -> tuple:
    """(Quantizer_Matrix as (15, 2, 3344) uint8, Gaussian_Sequence as (2048,)
    int16), after the anchors' checks."""
    data = lib.read_bytes()
    qm = np.frombuffer(data, np.uint8, QM_COUNT, QM_OFFSET).reshape(15, 2, 3344)
    gauss = np.frombuffer(data, "<i2", GAUSS_COUNT, GAUSS_OFFSET).astype(np.int16)
    checks = {
        "the luma 4x4 of level 0": qm[0, 0, :16].tobytes() == QM_ANCHOR,
        "that 4x4 once in the file": data.count(QM_ANCHOR) == 1,
        "the chroma 4x4 of level 0": list(qm[0, 1, :4]) == [35, 46, 57, 66],
        "level 14 near flat": int(qm[14].min()) >= 30 and int(qm[14].max()) <= 32,
        "the sequence's start": list(gauss[:6]) == [56, 568, -180, 172, 124, -84],
        "the sequence's end": list(gauss[-3:]) == [944, 428, -484],
        "the sequence's range": (int(gauss.min()), int(gauss.max())) == (-1752, 1688),
        "the sequence once in the file": data.count(gauss.astype("<i2").tobytes()) == 1,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"{lib}: anchors fail: {', '.join(failed)}")
    return qm, gauss


def pack(raw: bytes, name: str) -> str:
    text = base64.b64encode(zlib.compress(raw, 9)).decode()
    lines = [f'    "{text[i:i + 92]}"' for i in range(0, len(text), 92)]
    return f"{name} = (\n" + "\n".join(lines) + ")\n"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lib", help=f"the {LIBRARY} to read (default: beside PIL)")
    ap.add_argument("--write", action="store_true", help="rewrite the blobs in av1_tables.py")
    args = ap.parse_args()
    lib = pathlib.Path(args.lib) if args.lib else find_library()
    if lib is None:
        raise SystemExit(f"no {LIBRARY} beside PIL; give --lib")
    qm, gauss = extract(lib)
    if args.write:
        src = TABLES.read_text()
        for name, raw in (("_QM_BLOB", qm.tobytes()),
                          ("_GAUSS_BLOB", gauss.astype("<i2").tobytes())):
            block = re.compile(rf"^{name} = \(\n(?:    \".*\"\n?)*\)\n", re.M)
            if not block.search(src):
                raise SystemExit(f"{TABLES.name} has no {name} to rewrite")
            src = block.sub(lambda _: pack(raw, name), src)
        TABLES.write_text(src)
        print(f"wrote {TABLES.relative_to(ROOT)}")
        return
    sys.path.insert(0, str(ROOT))
    from relativitypathtracer_tpu_torch.utils import av1_tables as T
    same = (np.array_equal(T.QUANTIZER_MATRIX, qm)
            and np.array_equal(T.GAUSSIAN_SEQUENCE, gauss.astype(np.int64)))
    print(f"{lib.name}: Quantizer_Matrix {qm.shape}, Gaussian_Sequence {gauss.shape}: "
          f"{'equal to' if same else 'DIFFERENT FROM'} the committed tables")
    if not same:
        sys.exit(1)


if __name__ == "__main__":
    main()
