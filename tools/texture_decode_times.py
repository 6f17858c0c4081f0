"""Time the port's texture decoders on this host's CPU: one 1024x1024 file
of each format and kind (ICNS: its largest RGB resource, it32, is
128x128; the committed tools/avif_512_cdef_lr.avif,
tools/avif_512_grain_qm.avif and tools/avif_512_10bit.avif are 512x512 and
their rows give each pass's seconds), written by PIL (or, where PIL writes none, by
tests/torch_textures/make_fixtures.py's builders) from
utils/demo_scene.demo_texture(1024), decoded by
models/texture.decode_texture and held to PIL's decode byte for byte.

    python tools/texture_decode_times.py

Needs PIL (to write the files and to check them). Prints one JSON line a
file (format, bytes, seconds: the best of REPEAT decodes, one for JPEG 2000,
whose tier 1 takes 40-50 s, and AVIF, whose symbol loop is Python too;
equal to PIL, the file handed to PIL in one
read) and a
last line with the host's CPU model: these are host CPU times, not a card's.
"""

from __future__ import annotations

import io
import json
import pathlib
import platform
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

REPEAT = 3


def _cpu_model() -> str:
    try:
        for line in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def files(Image) -> dict:
    """name -> bytes, 1024x1024 each."""
    from torch_textures.make_fixtures import (arith_jpeg, bc7_mode6, blp_file, bmp_file, bmp_rle,
                                              dds_file, fits_file, fits_gzip, icns_file,
                                              icns_rgb, jpeg_scans, jpeg_tiff, ojpeg_tiff,
                                              psd_file, sgi_file, tiff_file)

    from relativitypathtracer_tpu_torch.utils.demo_scene import demo_texture

    rgb = demo_texture(1024)
    im = Image.fromarray(rgb)

    def save(image, fmt, **kw):
        buf = io.BytesIO()
        image.save(buf, fmt, **kw)
        return buf.getvalue()

    def noise(size):
        return np.random.default_rng(size).integers(0, 256, 65536 * size, dtype=np.uint8).tobytes()

    pal = im.quantize(16)
    idx = np.asarray(pal)
    colours = np.asarray(pal.getpalette()[:48], np.uint8).reshape(16, 3)
    out = {
        "P6 (binary PPM)": save(im, "PPM"),
        "P3 (plain PPM)": b"P3 1024 1024 255\n" + b"\n".join(
            b" ".join(b"%d" % v for v in row) for row in rgb.reshape(1024, -1)) + b"\n",
        "BMP 24-bit": save(im, "BMP"),
        "BMP 8-bit palette": save(im.quantize(256), "BMP"),
        "BMP RLE8": bmp_file(1024, 1024, 8, bmp_rle(idx, False),
                             [tuple(c) for c in colours.tolist()], compression=1),
        "BMP RLE4": bmp_file(1024, 1024, 4, bmp_rle(idx, True),
                             [tuple(c) for c in colours.tolist()], compression=2),
        "TGA": save(im, "TGA"),
        "TGA RLE": save(im, "TGA", rle=True),
        "GIF": save(im.quantize(256), "GIF"),
        "TIFF": save(im, "TIFF"),
        "TIFF LZW predictor 2": save(im, "TIFF", compression="tiff_lzw", tiffinfo={317: 2}),
        "TIFF Deflate": save(im, "TIFF", compression="tiff_adobe_deflate"),
        "TIFF PackBits": save(im, "TIFF", compression="packbits"),
        "TIFF planar LZW tiles": tiff_file(rgb, 8, 2, comp=5, planar=2, tile=(256, 256)),
        "JPEG": save(im, "JPEG", quality=90),
        "JPEG CMYK": save(im.convert("CMYK"), "JPEG", quality=90),
        # libjpeg's default progression cut after its third scan: luma ACs
        # 1-5 at Al 2, Cr's at Al 1, the rest unsent (block-smoothed)
        "JPEG progressive, unsent bits": jpeg_scans(save(im, "JPEG", quality=90,
                                                         progressive=True), {0, 1, 2}),
        "JPEG arithmetic": arith_jpeg(save(im, "JPEG", quality=90)),
        "JPEG arithmetic progressive": arith_jpeg(save(im, "JPEG", quality=90,
                                                       progressive=True)),
        "TIFF JPEG 4:2:0 tiles": jpeg_tiff(rgb, 6, (256, 256), Image, tile=True,
                                           subsampling="4:2:0", quality=90),
        "TIFF old-style JPEG": ojpeg_tiff(save(im, "JPEG", quality=90), "jif_sos"),
        "PNG": save(im, "PNG"),
        "WebP lossless": save(im, "WEBP", lossless=True),
        "WebP lossy": save(im, "WEBP", quality=90),
        "DDS BC1 (PIL's DXT1)": save(im, "DDS", pixel_format="DXT1"),
        "DDS BC7 mode 6": dds_file(1024, 1024, bc7_mode6(rgb), fourcc=b"DX10", dxgi=98),
        # seeded random blocks: every mode, in the share random bits give
        "DDS BC6H random blocks": dds_file(1024, 1024, noise(16), fourcc=b"DX10", dxgi=95),
        # PIL's DXT5 blocks in a BLP2 (its Python decoder)
        "BLP2 DXT5": blp_file(2, 1024, 1024, save(im, "DDS", pixel_format="DXT5")[128:],
                              encoding=2, alpha=1, alpha_encoding=7),
        # PIL writes no PSD and no ICNS it32: built here
        "PSD PackBits": psd_file(3, 8, rgb.transpose(2, 0, 1), comp=1),
        "SGI RLE": sgi_file(rgb, rle=True),
        "PCX 8-bit": save(im.quantize(256), "PCX"),
        "QOI": save(im, "QOI"),
        "ICNS it32 (128x128)": icns_file([(b"it32", icns_rgb(rgb[::8, ::8], it32=True))]),
        # tier 1 is a Python loop over the MQ decoder's decisions: timed once
        "JPEG 2000 reversible (J2K, 5/3, RCT)": save(im, "JPEG2000", no_jp2=True, mct=1),
        "JPEG 2000 irreversible (JP2, 9/7, ICT)": save(im, "JPEG2000", irreversible=True, mct=1),
        "FITS 8-bit": fits_file(rgb[..., 1], 8),
        "FITS float32": fits_file(rgb[..., 0] * 1.5 - 20.0, -32),
        "FITS GZIP_1 16-bit": fits_gzip(rgb[..., 2].astype(np.int64) * 9, 16),
        # PIL's default AVIF encode (quality 75, speed 6, 4:2:0) of this
        # texture, as committed for chip_smoke.py: timed once
        "AVIF q75 (PIL's default)": (ROOT / "tools" / "avif_1024_q75.avif").read_bytes(),
        # 512x512: demo_texture(512) at quality 30, speed 0, with aom's CDEF
        # on; its CDEF and loop-restoration passes timed apart
        "AVIF 512x512 CDEF and loop restoration": (
            ROOT / "tools" / "avif_512_cdef_lr.avif").read_bytes(),
        # 512x512: demo_texture(512) at quality 40 with quantiser matrix
        # level 5 and aom's film grain test vector 4; its passes timed apart
        "AVIF 512x512 film grain and quantiser matrices": (
            ROOT / "tools" / "avif_512_grain_qm.avif").read_bytes(),
        # 512x512: PIL's default encode of demo_texture(512) edited to 10
        # bits (make_fixtures.high_bitdepth_edit); its passes timed apart
        "AVIF 512x512 10-bit": (ROOT / "tools" / "avif_512_10bit.avif").read_bytes(),
    }
    return out


ONCE = ("JPEG 2000", "AVIF")  # formats timed once, not REPEAT times


def main() -> int:
    from PIL import Image

    from relativitypathtracer_tpu_torch.models.texture import decode_texture
    from relativitypathtracer_tpu_torch.utils.avif_decode import decode_avif

    ok = True
    for name, data in files(Image).items():
        best = float("inf")
        repeat = 1 if name.startswith(ONCE) else REPEAT
        passes: dict = {}
        for _ in range(repeat):
            t0 = time.perf_counter()
            if name.startswith("AVIF 512"):
                got = decode_avif(data, passes)
            else:
                got = decode_texture(data)
            best = min(best, time.perf_counter() - t0)
        with Image.open(io.BytesIO(data)) as im:
            # in one read: libjpeg's arithmetic decoder cannot wait for PIL's next
            im.decodermaxblock = len(data) + 1
            equal = bool(np.array_equal(got, np.asarray(im.convert("RGB"))))
        ok = ok and equal
        row = {"format": name, "bytes": len(data), "seconds": round(best, 4), "repeat": repeat,
               "equal_to_pil": equal}
        row.update({f"{k} seconds": round(v, 4) for k, v in passes.items()})
        print(json.dumps(row), flush=True)
    print(json.dumps({"host_cpu": _cpu_model(), "repeat": REPEAT,
                      "note": "host CPU seconds, not a card's", "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
