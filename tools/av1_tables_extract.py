"""Extract the AV1 specification's Quantizer_Matrix, Gaussian_Sequence and
the 10- and 12-bit rows of Dc_Qlookup and Ac_Qlookup from the libavif
library that ships in Pillow 12.1.0's wheel, and pack them into
utils/av1_tables.py as `_QM_BLOB`, `_GAUSS_BLOB` and `_DQ_BLOB` (zlib, then
base64, as `_CDF_BLOB` is packed).

Where the bytes come from: `pillow.libs/libavif-01e67780.so.16.3.0` (libavif
1.3.0, which links aom and dav1d 1.5.1 statically) holds
- aom's `iwt_matrix_ref`, the specification's Quantizer_Matrix[15][2][3344]
  (level, then luma and chroma, each plane's sizes 4x4, 8x8, 16x16, 32x32,
  4x8, 8x4, 8x16, 16x8, 16x32, 32x16, 4x16, 16x4, 8x32, 32x8 one after the
  other), as 100,320 uint8 at byte offset 4,078,880;
- dav1d's `dav1d_gaussian_sequence`, the specification's
  Gaussian_Sequence[2048], as little-endian int16 at byte offset 4,651,456;
- dav1d's `dav1d_dq_tbl[3][256][2]`, Dc_Qlookup and Ac_Qlookup
  interleaved (bit depth 8, 10, 12; then q index; then DC, AC), as
  little-endian uint16 at byte offset 4,693,696.
The anchors checked before anything is written: level 0's luma 4x4 reads
32 43 73 97 43 67 94 110 73 94 137 150 97 110 150 200 and occurs once in the
file, its chroma starts 35 46 57 66, level 14 lies within 30-32; the
sequence starts 56 568 -180 172 124 -84, ends 944 428 -484, spans -1752 to
1688 and occurs once in the file; the dequantiser table's 8-bit rows equal
the committed DC_Q and AC_Q (the specification's, typed in), its 10-bit DC
row starts 4 9 10 13 15 17, its 12-bit AC row ends 29247, each 10- and
12-bit row also occurs in aom's own tables (dc_qlookup_10_QTX and the
rest), and the table occurs once in the file.

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
DQ_OFFSET, DQ_COUNT = 4_693_696, 3 * 256 * 2
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
    int16, the dequantisers as (3, 256, 2) uint16), after the anchors'
    checks."""
    sys.path.insert(0, str(ROOT))
    from relativitypathtracer_tpu_torch.utils import av1_tables as T
    data = lib.read_bytes()
    qm = np.frombuffer(data, np.uint8, QM_COUNT, QM_OFFSET).reshape(15, 2, 3344)
    gauss = np.frombuffer(data, "<i2", GAUSS_COUNT, GAUSS_OFFSET).astype(np.int16)
    dq = np.frombuffer(data, "<u2", DQ_COUNT, DQ_OFFSET).reshape(3, 256, 2).astype(np.uint16)
    rows = [dq[b, :, k].astype("<i2").tobytes() for b in (1, 2) for k in (0, 1)]
    checks = {
        "the luma 4x4 of level 0": qm[0, 0, :16].tobytes() == QM_ANCHOR,
        "that 4x4 once in the file": data.count(QM_ANCHOR) == 1,
        "the chroma 4x4 of level 0": list(qm[0, 1, :4]) == [35, 46, 57, 66],
        "level 14 near flat": int(qm[14].min()) >= 30 and int(qm[14].max()) <= 32,
        "the sequence's start": list(gauss[:6]) == [56, 568, -180, 172, 124, -84],
        "the sequence's end": list(gauss[-3:]) == [944, 428, -484],
        "the sequence's range": (int(gauss.min()), int(gauss.max())) == (-1752, 1688),
        "the sequence once in the file": data.count(gauss.astype("<i2").tobytes()) == 1,
        "the 8-bit dequantisers": (list(dq[0, :, 0]) == list(T.DC_Q)
                                   and list(dq[0, :, 1]) == list(T.AC_Q)),
        "the 10-bit DC row's start": list(dq[1, :6, 0]) == [4, 9, 10, 13, 15, 17],
        "the 12-bit AC row's end": int(dq[2, 255, 1]) == 29247,
        "the 10- and 12-bit rows in aom's tables": all(data.count(r) >= 1 for r in rows),
        "the dequantisers once in the file": data.count(dq.astype("<u2").tobytes()) == 1,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"{lib}: anchors fail: {', '.join(failed)}")
    return qm, gauss, dq


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
    qm, gauss, dq = extract(lib)
    if args.write:
        src = TABLES.read_text()
        for name, raw in (("_QM_BLOB", qm.tobytes()),
                          ("_GAUSS_BLOB", gauss.astype("<i2").tobytes()),
                          ("_DQ_BLOB", dq.astype("<u2").tobytes())):
            block = re.compile(rf"^{name} = \(\n(?:    \".*\"\n?)*\)\n", re.M)
            if not block.search(src):
                raise SystemExit(f"{TABLES.name} has no {name} to rewrite")
            src = block.sub(lambda _: pack(raw, name), src)
        TABLES.write_text(src)
        print(f"wrote {TABLES.relative_to(ROOT)}")
        return
    from relativitypathtracer_tpu_torch.utils import av1_tables as T
    same = (np.array_equal(T.QUANTIZER_MATRIX, qm)
            and np.array_equal(T.GAUSSIAN_SEQUENCE, gauss.astype(np.int64))
            and np.array_equal(T.DEQUANT, dq.astype(np.int64)))
    print(f"{lib.name}: Quantizer_Matrix {qm.shape}, Gaussian_Sequence {gauss.shape}, "
          f"Dc_Qlookup and Ac_Qlookup {dq.shape}: "
          f"{'equal to' if same else 'DIFFERENT FROM'} the committed tables")
    if not same:
        sys.exit(1)


if __name__ == "__main__":
    main()
