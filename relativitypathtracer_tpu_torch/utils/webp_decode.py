"""WebP files in numpy and the standard library: the RIFF container, the
canvas and the alpha channel, as PIL opens them.

`decode_webp` returns the (H, W, 3) uint8 pixels that PIL 12.1's
`Image.open(f).convert("RGB")` gives for a WebP file, byte for byte. PIL
opens every WebP, still or animated, through libwebp's WebPAnimDecoder
(WebPImagePlugin.py), so the picture is the first frame drawn on the
canvas: the canvas is VP8X's (a simple file's is its one image), it starts
transparent black (ANIM's background colour is not used), the first frame
is a key frame drawn at its ANMF offset without blending, in
non-premultiplied RGBA; `convert("RGB")` drops the alpha, so the canvas
outside the frame reads (0, 0, 0) and a transparent pixel keeps its RGB.

The container is checked as libwebp's demuxer checks it (demux.c): the
RIFF size (bytes past it are ignored, a file shorter than it is
truncated), chunk sizes inside the RIFF, VP8X's flags (no reserved bit)
and canvas, ANIM before ANMF, frames inside the canvas (a still image
exactly the canvas), an image chunk in every frame, ALPH only before a VP8
chunk (and dropped in a still image whose VP8X lacks the alpha flag), each
frame's bitstream header. The first frame is decoded: VP8L by
utils/webp_lossless, VP8 by utils/webp_lossy, its ALPH decoded as libwebp
decodes it (so that a broken alpha channel is refused as PIL refuses it)
and then dropped.
"""

from __future__ import annotations

import numpy as np

from .image_decode import DecodeError, _check_size
from .webp_lossless import decode_vp8l, decode_vp8l_stream, vp8l_header
from .webp_lossy import decode_vp8, vp8_header

_MAX_CHUNK = (1 << 32) - 1 - 8 - 1  # MAX_CHUNK_PAYLOAD
_VALID_FLAGS = 0x3E  # ICC, alpha, EXIF, XMP, animation


def is_webp(data: bytes) -> bool:
    """PIL's WebPImagePlugin._accept: RIFF, WEBP, then a VP8, VP8L or VP8X
    chunk."""
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP" and data[12:16] in (b"VP8 ", b"VP8L",
                                                                            b"VP8X")


class _Frame:
    def __init__(self, x=0, y=0):
        self.x, self.y = x, y
        self.image = self.alpha = None  # (fourcc, payload)
        self.width = self.height = 0


def _chunk(data: bytes, pos: int) -> tuple:
    """(fourcc, payload, end past its padding) of the chunk at `pos`."""
    if pos + 8 > len(data):
        raise DecodeError("truncated WebP file: a chunk header past the end")
    fourcc, size = data[pos:pos + 4], int.from_bytes(data[pos + 4:pos + 8], "little")
    end = pos + 8 + size + (size & 1)
    if size > _MAX_CHUNK or end > len(data):
        raise DecodeError(f"truncated WebP file: chunk {fourcc!r} runs past the RIFF's end")
    return fourcc, data[pos + 8:pos + 8 + size], end


def _image_size(fourcc: bytes, payload: bytes) -> tuple:
    """An image chunk's size as WebPGetFeatures reads it."""
    if fourcc == b"VP8L":
        return vp8l_header(payload)[:2]
    return vp8_header(payload)[:2]


def _store_frame(data: bytes, pos: int, frame: _Frame) -> int:
    """libwebp's StoreFrame: an ALPH chunk and then a VP8 or VP8L chunk
    from `pos` (any other chunk ends the frame); the offset after them."""
    while pos < len(data):
        fourcc, payload, end = _chunk(data, pos)
        if fourcc == b"ALPH" and frame.alpha is None and frame.image is None:
            frame.alpha = payload
        elif fourcc in (b"VP8 ", b"VP8L") and frame.image is None:
            if fourcc == b"VP8L" and frame.alpha is not None:
                raise DecodeError("WebP: an ALPH chunk before a VP8L image")
            frame.image = (fourcc, payload)
            frame.width, frame.height = _image_size(fourcc, payload)
        else:
            break
        pos = end
    return pos


def _frames(data: bytes) -> tuple:
    """(canvas width, height, frames) of a WebP file's chunks (its data
    cut at the RIFF's end)."""
    first = data[12:16]
    if first != b"VP8X":
        frame = _Frame()
        _store_frame(data, 12, frame)
        if frame.image is None:
            raise DecodeError("WebP: no image chunk")
        frame.alpha = None  # a simple file has no alpha flag
        return frame.width, frame.height, [frame]
    _, vp8x, pos = _chunk(data, 12)
    if len(vp8x) < 10:
        raise DecodeError("WebP: short VP8X chunk")
    flags = vp8x[0]
    width = 1 + int.from_bytes(vp8x[4:7], "little")
    height = 1 + int.from_bytes(vp8x[7:10], "little")
    if width * height >= 1 << 32:
        raise DecodeError(f"WebP: a {width}x{height} canvas")
    animated = bool(flags & 2)
    frames, anim = [], False
    while pos < len(data):
        fourcc, payload, end = _chunk(data, pos)
        if fourcc == b"VP8X":
            raise DecodeError("WebP: two VP8X chunks")
        if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
            if anim or animated or frames:
                raise DecodeError("WebP: an image chunk outside ANMF in an animation")
            frame = _Frame()
            end = _store_frame(data, pos, frame)
            if not flags & 0x10:  # no alpha flag: libwebp drops the ALPH chunk
                frame.alpha = None
            frames.append(frame)
        elif fourcc == b"ANIM":
            if len(payload) + (len(payload) & 1) < 6:
                raise DecodeError("WebP: short ANIM chunk")
            anim = True
        elif fourcc == b"ANMF":
            if not anim:
                raise DecodeError("WebP: ANMF before ANIM")
            if len(payload) + (len(payload) & 1) < 16:
                raise DecodeError("WebP: short ANMF chunk")
            frame = _Frame(2 * int.from_bytes(payload[0:3], "little"),
                           2 * int.from_bytes(payload[3:6], "little"))
            w, h = (1 + int.from_bytes(payload[k:k + 3], "little") for k in (6, 9))
            if w * h >= 1 << 32:
                raise DecodeError(f"WebP: a {w}x{h} frame")
            stop = _store_frame(data, pos + 24, frame)
            if stop - (pos + 24) > len(payload) + (len(payload) & 1) - 16:
                raise DecodeError("WebP: a frame's chunks run past its ANMF chunk")
            if animated and (frame.image is not None or frame.alpha is not None):
                frames.append(frame)
            end = stop
        pos = end
    if not frames:
        raise DecodeError("WebP: no frame")
    if flags & ~_VALID_FLAGS & 0xFF:
        raise DecodeError(f"WebP: reserved VP8X flags {flags:#04x}")
    for f in frames:
        if f.image is None:
            raise DecodeError("WebP: a frame without an image chunk")
        if animated:
            inside = f.x + f.width <= width and f.y + f.height <= height
        else:
            inside = (f.x, f.y, f.width, f.height) == (0, 0, width, height)
        if not inside:
            raise DecodeError(f"WebP: a {f.width}x{f.height} frame at ({f.x}, {f.y}) does "
                              f"not fit the {width}x{height} canvas")
    return width, height, frames


def _alpha(payload: bytes, width: int, height: int) -> np.ndarray:
    """An ALPH chunk's (height, width) uint8 plane (libwebp alpha_dec.c):
    its header byte (compression 0 raw or 1 lossless, filter, pre-processing
    0 or 1, reserved 0), then the filtered values, unfiltered row by row
    (none, horizontal, vertical, gradient; row 0 from the left, its first
    value from 0; a row's first value from the one above)."""
    if len(payload) <= 1:
        raise DecodeError("WebP: empty ALPH chunk")
    method, filt, pre, rsrv = payload[0] & 3, (payload[0] >> 2) & 3, (payload[0] >> 4) & 3, \
        payload[0] >> 6
    if method > 1 or pre > 1 or rsrv:
        raise DecodeError(f"WebP: bad ALPH header {payload[0]:#04x}")
    if method == 0:
        if len(payload) - 1 < width * height:
            raise DecodeError("WebP: truncated ALPH data")
        a = np.frombuffer(payload, np.uint8, width * height, 1).reshape(height, width)
    else:
        a = ((decode_vp8l_stream(payload[1:], width, height) >> 8) & 255).astype(np.uint8)
    if filt == 0:
        return a
    a = a.astype(np.int64)
    out = np.empty_like(a)
    out[0] = np.cumsum(a[0]) & 255
    for y in range(1, height):
        if filt == 1:
            out[y] = (np.cumsum(a[y]) + out[y - 1, 0]) & 255
        elif filt == 2:
            out[y] = (a[y] + out[y - 1]) & 255
        else:  # gradient: clip(left + top - top-left), the first from above
            top, row = out[y - 1].tolist(), a[y].tolist()
            left = top_left = top[0]
            res = []
            for x in range(width):
                g = left + top[x] - top_left
                left = (row[x] + (0 if g < 0 else 255 if g > 255 else g)) & 255
                top_left = top[x]
                res.append(left)
            out[y] = res
    return out.astype(np.uint8)


def decode_webp(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a WebP file, as PIL's `convert("RGB")` of
    its first frame on the canvas; raises DecodeError on what is corrupt or
    truncated."""
    data = bytes(data)
    if not is_webp(data) or len(data) < 20:
        raise DecodeError("not a WebP file")
    riff = int.from_bytes(data[4:8], "little")
    if riff < 8 or riff > _MAX_CHUNK:
        raise DecodeError(f"WebP: a RIFF size of {riff}")
    if len(data) < riff + 8:
        raise DecodeError("truncated WebP file: shorter than its RIFF size")
    width, height, frames = _frames(data[:riff + 8])
    _check_size(width, height)
    frame = frames[0]
    fourcc, payload = frame.image
    if fourcc == b"VP8L":
        rgb = decode_vp8l(payload)[..., :3]
    else:
        rgb = decode_vp8(payload)
        if frame.alpha is not None:
            _alpha(frame.alpha, frame.width, frame.height)
    canvas = np.zeros((height, width, 3), np.uint8)
    canvas[frame.y:frame.y + frame.height, frame.x:frame.x + frame.width] = rgb
    return canvas
