"""The port's image output (utils/image: PNG, GIF and JPEG in numpy and the
standard library) held against PIL's decoders, on the CPU.

- PNG: decodes to the input bit for bit (odd sizes, float and uint8), the
  same pixels as the JAX package's PIL-written PNG.
- GIF: decodes to the palette-quantised input bit for bit, every frame, with
  the JAX package's delay and loop; the quantiser picks a nearest palette
  colour; LZW past a full code table (random frames) and on long runs.
- JPEG: PIL opens it as RGB at the right size, with libjpeg's quality-85
  tables (as PIL's own encoder writes them) and the Annex K Huffman tables;
  PSNR on a rendered textured frame at least 32 dB (35.31 dB measured;
  PIL's own encoder 35.28 dB);
  the entropy coder on crafted coefficients (ZRL runs, a coefficient at
  position 63 with no EOB, DC swings across the MCU order, 0xFF stuffing)
  decoded by libjpeg to the inverse DCT of those coefficients.
"""

import io
import struct

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

import relativitypathtracer_tpu_torch as pt
from relativitypathtracer_tpu_torch.utils import image


def _segments(data: bytes) -> dict:
    """marker -> payloads of a JPEG's header segments, up to its scan."""
    out, i = {}, 2
    while True:
        marker, length = data[i + 1], struct.unpack(">H", data[i + 2:i + 4])[0]
        out.setdefault(marker, []).append(data[i + 4:i + 2 + length])
        if marker == 0xDA:
            return out
        i += 2 + length


def _pil_jpeg(img, quality=85) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _psnr(a, b) -> float:
    mse = float(((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2).mean())
    return 10.0 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def textured_frame(tmp_path_factory):
    """A 96x64 uint8 frame of the textured fixture, display order, at a
    state drawn from a seed."""
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_demo_scene

    host = pt.load_scene_file(write_demo_scene(str(tmp_path_factory.mktemp("img")), 2,
                                               "textured"))
    scene, meta = pt.build_scene(host, device="cpu")
    rng = np.random.default_rng(16)
    state = pt.FrameState(torch.tensor(rng.uniform(-0.4, 0.4, 3), dtype=torch.float32),
                          torch.tensor([rng.uniform(0, 0.1), 0, 0, 0], dtype=torch.float32))
    img = pt.build_render_fn(meta, 96, 64, -1, out_uint8=True, device="cpu")(scene, state)
    return np.ascontiguousarray(img.numpy()[::-1])


@pytest.mark.parametrize("h, w", [(1, 1), (7, 13), (64, 33)])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_png_decodes_to_the_input(tmp_path, h, w, dtype):
    from relativitypathtracer_tpu.utils.image import write_png as jax_write_png

    rng = np.random.default_rng(h * w)
    img = rng.uniform(-0.1, 1.1, (h, w, 3)).astype(np.float32)
    if dtype == "uint8":
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    image.write_png(str(tmp_path / "a.png"), img)
    jax_write_png(str(tmp_path / "b.png"), img)
    got = Image.open(tmp_path / "a.png")
    assert got.mode == "RGB" and got.size == (w, h)
    want = (img if dtype == "uint8" else image.to_uint8(img))[::-1]
    assert np.array_equal(np.asarray(got), want)
    assert np.array_equal(np.asarray(got), np.asarray(Image.open(tmp_path / "b.png")))


@pytest.mark.parametrize("content", ["random", "flat", "dark"])
def test_gif_decodes_to_the_quantised_input(tmp_path, content):
    """Every frame decodes to the palette colour quantize() chose for each
    pixel; 150x200 random frames fill the 4096-entry code table several
    times (clear codes), flat ones make the longest strings."""
    rng = np.random.default_rng(3)
    shape = (150, 200, 3) if content == "random" else (37, 61, 3)
    if content == "random":
        frames = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(3)]
    elif content == "flat":
        frames = [np.full(shape, v, np.uint8) for v in (0, 77, 255)]
    else:
        frames = [(rng.random(shape) ** 4).astype(np.float32) for _ in range(3)]
    path = tmp_path / "a.gif"
    image.write_gif(str(path), frames, fps=2.0)
    gif = Image.open(path)
    assert gif.n_frames == 3 and gif.info["duration"] == 500 and gif.info["loop"] == 0
    shots = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(gif)]
    for shot, frame in zip(shots, frames):
        rgb = frame if frame.dtype == np.uint8 else image.to_uint8(frame)
        assert np.array_equal(shot, image.PALETTE[image.quantize(rgb[::-1])])


def test_gif_delay_follows_the_jax_writer(tmp_path):
    """The delay PIL reads back is the JAX package's int(1000 / fps) ms in
    whole centiseconds."""
    for fps in (1.5, 7.0, 30.0):
        image.write_gif(str(tmp_path / "d.gif"), [np.zeros((2, 2, 3), np.uint8)] * 2, fps=fps)
        assert Image.open(tmp_path / "d.gif").info["duration"] == int(1000.0 / fps) // 10 * 10


def test_gif_lzw_ends_at_every_table_state(tmp_path):
    """One-row images of 1 to 600 random pixels end the code stream at every
    table size up to 600 entries, across the 9- to 10-bit width change."""
    rng = np.random.default_rng(5)
    for n in range(1, 601):
        row = np.zeros((1, n, 3), np.uint8)
        row[0, :, 0] = rng.integers(0, 256, n)
        image.write_gif(str(tmp_path / "r.gif"), [row])
        got = np.asarray(Image.open(tmp_path / "r.gif").convert("RGB"))
        assert np.array_equal(got, image.PALETTE[image.quantize(row)]), n


def test_quantize_picks_a_nearest_palette_colour():
    x = np.random.default_rng(7).integers(0, 256, (20000, 3))
    idx = image.quantize(x[None].astype(np.uint8))[0]
    dist = ((x[:, None, :] - image.PALETTE[None].astype(np.int64)) ** 2).sum(-1)
    assert image.PALETTE.shape == (256, 3) and len(np.unique(image.PALETTE, axis=0)) == 256
    assert np.array_equal(dist[np.arange(len(x)), idx], dist.min(1))


def test_jpeg_of_a_textured_frame(textured_frame):
    """PIL opens it as RGB at 96x64 with libjpeg's quality-85 tables; PSNR
    against the frame at least 32 dB (35.31 dB measured; PIL's own encoder
    at quality 85 gets 35.28)."""
    data = image.encode_jpeg(textured_frame)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    got = Image.open(io.BytesIO(data))
    assert got.format == "JPEG" and got.mode == "RGB" and got.size == (96, 64)
    assert got.quantization == Image.open(io.BytesIO(_pil_jpeg(textured_frame))).quantization
    assert _psnr(np.asarray(got), textured_frame) >= 32.0


@pytest.mark.parametrize("h, w", [(1, 1), (17, 33), (64, 96), (31, 250)])
def test_jpeg_of_a_random_image(h, w):
    """Any size (padding to 16-pixel MCUs), the IJG tables, the Annex K
    Huffman tables as libjpeg writes them; the decoded image as far from the
    input as PIL's own encoding at the same quality (noise at 4:2:0)."""
    img = np.random.default_rng(h + w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    data, ref = image.encode_jpeg(img), _pil_jpeg(img)
    got = Image.open(io.BytesIO(data))
    assert got.mode == "RGB" and got.size == (w, h)
    assert got.quantization == Image.open(io.BytesIO(ref)).quantization
    assert b"".join(_segments(data)[0xC4]) == b"".join(_segments(ref)[0xC4])
    sof = _segments(data)[0xC0][0]
    assert struct.unpack(">HH", sof[1:5]) == (h, w)
    assert _psnr(np.asarray(got), img) >= _psnr(np.asarray(Image.open(io.BytesIO(ref))), img) - 0.5


def test_quant_tables_scale_as_libjpeg():
    for q in (1, 10, 50, 85, 100):
        ref = Image.open(io.BytesIO(_pil_jpeg(np.zeros((8, 8, 3), np.uint8), q))).quantization
        qy, qc = image.quant_tables(q)
        assert list(qy) == list(ref[0]) and list(qc) == list(ref[1]), q


def _idct(coefs_zigzag):
    """The inverse DCT of one block's zig-zag coefficients at unit
    quantisation, in float64: (8, 8)."""
    natural = np.zeros(64)
    natural[image.ZIGZAG] = coefs_zigzag
    n = np.arange(8)
    c = np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c.T @ natural.reshape(8, 8) @ c


def test_entropy_coder_on_crafted_coefficients():
    """Coefficients at unit quantisation through `jfif`, decoded by libjpeg
    as YCbCr: each Y block equals the inverse DCT of its coefficients plus
    128 within libjpeg's integer IDCT (1 level), and each chroma block's
    centre its DC / 8 + 128. The blocks hold a lone coefficient after runs
    of 15, 16, 17, 31, 32 and 47 zeros (ZRLs), the last coefficient at
    position 63 (no EOB) and at 62, the largest DC category (11) on both
    sides of each component's predictor, and values whose codes put 0xFF
    bytes in the scan."""
    rng = np.random.default_rng(11)
    mcus = 12  # a 48x64 image: 3 x 4 MCUs
    coefs = np.zeros((mcus, 6, 64), np.int32)
    crafted = []
    for run in (15, 16, 17, 31, 32, 47):
        b = np.zeros(64, np.int32)
        b[1 + run] = rng.choice([-1, 1]) * rng.integers(1, 200)
        crafted.append(b)
    for last in (63, 62):
        b = np.zeros(64, np.int32)
        b[last] = 37
        b[1:last:5] = rng.integers(-30, 30, len(range(1, last, 5)))
        crafted.append(b)
    k = 0
    for m in range(mcus):
        for j in range(4):
            coefs[m, j] = crafted[k % len(crafted)]
            k += 1
        # DC swings: -1016 .. 1016 alternating, differences up to 2032 (size 11)
        coefs[m, :4, 0] = [1016, -1016, 1016, -1016] if m % 2 else [-1016, 1016, -1016, 1016]
        coefs[m, 4, 0] = 1000 if m % 2 else -1000
        coefs[m, 5, 0] = -1000 if m % 2 else 1000
    coefs[:, :4, 1:] = np.clip(coefs[:, :4, 1:], -1023, 1023)
    ones = np.ones(64, np.int64)
    data = image.jfif(coefs, 48, 64, ones, ones)
    assert b"\xff\x00" in data[data.index(b"\xff\xda"):]  # stuffing was exercised
    dec = Image.open(io.BytesIO(data))
    dec.draft("YCbCr", dec.size)
    ycc = np.asarray(dec).astype(np.float64)
    assert ycc.shape == (48, 64, 3)
    for m in range(mcus):
        my, mx = divmod(m, 4)
        for j in range(4):
            by, bx = divmod(j, 2)
            want = np.clip(_idct(coefs[m, j]) + 128.0, 0, 255)
            got = ycc[16 * my + 8 * by:16 * my + 8 * by + 8, 16 * mx + 8 * bx:16 * mx + 8 * bx + 8, 0]
            assert np.abs(got - want).max() <= 1.0, (m, j)
        for ch, comp in ((1, 4), (2, 5)):
            centre = ycc[16 * my + 4:16 * my + 12, 16 * mx + 4:16 * mx + 12, ch]
            want = np.clip(coefs[m, comp, 0] / 8.0 + 128.0, 0, 255)
            assert np.abs(centre - want).max() <= 1.0, (m, ch)
