"""Image output helpers.

The renderer produces (H, W, 3) float images in bottom-up row order (pixel
row 0 = bottom of screen, matching the reference's GL presentation,
gl_interop.cpp:51-67). The PNG and GIF writers flip to top-down.
"""

from __future__ import annotations

import numpy as np


def to_uint8(img) -> np.ndarray:
    """Float [0,1] -> uint8 by truncation, like the reference's uchar cast
    (opencl_kernel.cl:653-657)."""
    arr = np.asarray(img)
    return (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)


def flip_vertical(img) -> np.ndarray:
    return np.asarray(img)[::-1]


def write_png(path: str, img) -> None:
    """img: (H, W, 3) float [0,1] bottom-up, or uint8."""
    from PIL import Image

    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    Image.fromarray(flip_vertical(arr)).save(path)


def write_gif(path: str, frames, fps: float = 30.0) -> None:
    """frames: sequence of (H, W, 3) float [0,1] or uint8 bottom-up images;
    one GIF frame each, looping, 1000 / fps ms apart."""
    from PIL import Image

    ims = []
    for fr in frames:
        arr = np.asarray(fr)
        if arr.dtype != np.uint8:
            arr = to_uint8(arr)
        ims.append(Image.fromarray(flip_vertical(arr)))
    ims[0].save(path, save_all=True, append_images=ims[1:], duration=int(1000.0 / fps), loop=0)
