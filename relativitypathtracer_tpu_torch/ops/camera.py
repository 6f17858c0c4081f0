"""Primary-ray generation for the pinhole camera.

Torch counterpart of `relativitypathtracer_tpu.ops.camera` (createCamRay,
opencl_kernel.cl:55-73): camera at the origin of its frame, image plane at
z = 0.5, aspect-corrected x, pixel (0, 0) at the bottom left.
"""

from __future__ import annotations

import torch

from ..device import DEFAULT_DEVICE


def camera_ray_dirs(width: int, height: int, msaa: int = 1, pad_width: int | None = None,
                    pad_height: int | None = None, device=DEFAULT_DEVICE):
    """Unit ray directions for every (sub)pixel: (msaa*msaa, H, W, 3) float32
    when msaa > 1, else (H, W, 3). Subpixel offsets follow the reference's
    MSAA loop (opencl_kernel.cl:642-647): k/msaa for k in [0, msaa), x fastest.

    pad_width/pad_height add off-sensor columns/rows (projection still uses
    width/height) so the grid tiles into 32x32 blocks; the caller crops.
    """
    pw = pad_width or width
    ph = pad_height or height
    xs = torch.arange(pw, dtype=torch.float32, device=device)
    ys = torch.arange(ph, dtype=torch.float32, device=device)
    aspect = float(width) / float(height)

    def dirs_at(dx: float, dy: float):
        px = ((xs + dx) / width - 0.5) * aspect
        py = (ys + dy) / height - 0.5
        d = torch.stack([
            px[None, :].expand(ph, pw),
            py[:, None].expand(ph, pw),
            torch.full((ph, pw), 0.5, dtype=torch.float32, device=device),
        ], dim=-1)
        return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)

    if msaa == 1:
        return dirs_at(0.0, 0.0)
    return torch.stack([dirs_at(sx / msaa, sy / msaa)
                        for sy in range(msaa) for sx in range(msaa)])
