"""Primary-ray generation for the pinhole camera.

Torch counterpart of `relativitypathtracer_tpu.ops.camera` (createCamRay,
opencl_kernel.cl:55-73): camera at the origin of its frame, image plane at
z = 0.5, aspect-corrected x, pixel (0, 0) at the bottom left.
"""

from __future__ import annotations

import torch


def camera_ray_dirs(width: int, height: int, pad_width: int | None = None,
                    pad_height: int | None = None, device="cpu"):
    """Unit ray directions (H, W, 3) float32 for every pixel at msaa 1.

    pad_width/pad_height add off-sensor columns/rows (projection still uses
    width/height) so the grid tiles into 32x32 blocks; the caller crops.
    """
    pw = pad_width or width
    ph = pad_height or height
    xs = torch.arange(pw, dtype=torch.float32, device=device)
    ys = torch.arange(ph, dtype=torch.float32, device=device)
    aspect = float(width) / float(height)
    px = (xs / width - 0.5) * aspect
    py = ys / height - 0.5
    d = torch.stack([
        px[None, :].expand(ph, pw),
        py[:, None].expand(ph, pw),
        torch.full((ph, pw), 0.5, dtype=torch.float32, device=device),
    ], dim=-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
