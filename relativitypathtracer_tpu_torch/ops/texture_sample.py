"""Bilinear texture sampling: the packed-atlas route and the plain footprint
fetch.

Torch counterpart of `relativitypathtracer_tpu.ops.texture_sample`. Both
reproduce the reference's tap pattern (opencl_kernel.cl:427-470), including
its clamp quirk: after clamping x+1 for the second tap, the fourth tap uses
clamp((x+1)-1), which differs from x at the border. The packed route is an
XLA gather in the JAX package, not a Pallas kernel, so plain PyTorch serves
it on the card too; the renderer takes it only when the footprint atlas
would exceed 48 MB (SceneMeta.use_footprint_tex).

Rays on the last axis: uv is (2, N), outputs (3, N).
"""

from __future__ import annotations

import torch

from .kernels.texture_kernel import _address_lanes, _fetch_mix


def bilinear_sample_packed(atlas, offset_texels, width, height, uv):
    """Bilinear sample from the packed atlas. atlas: (R, 8) int32 texels
    R | G << 8 | B << 16 (flat texel index = 8 * row + lane); offset_texels:
    (N,) int32 (byte offset / 3); width/height: (N,) int32; uv: (2, N).
    Returns (3, N) float RGB in [0, 1]."""
    w, h = width, height
    u = w.to(torch.float32) * uv[0]
    v = h.to(torch.float32) * (1.0 - uv[1])
    x = torch.minimum(torch.floor(u).to(torch.int32), w - 1)
    y = torch.minimum(torch.floor(v).to(torch.int32), h - 1)
    u_ratio = u - x.to(torch.float32)
    v_ratio = v - y.to(torch.float32)
    u_opp = 1.0 - u_ratio
    v_opp = 1.0 - v_ratio

    def clip(a, hi):
        return torch.minimum(torch.clamp(a, min=0), hi)

    x0, y0 = clip(x, w - 1), clip(y, h - 1)
    x1, y1 = clip(x0 + 1, w - 1), clip(y0 + 1, h - 1)
    x2 = clip(x1 - 1, w - 1)  # the reference's tap quirk
    flat = atlas.reshape(-1)
    limit = flat.shape[0] - 1

    def fetch(xi, yi):
        packed = flat[torch.clamp(offset_texels + w * yi + xi, 0, limit).long()]
        rgb = torch.stack([packed & 0xFF, (packed >> 8) & 0xFF, (packed >> 16) & 0xFF])
        return rgb.to(torch.float32) / 255.0

    row1 = (fetch(x0, y0) * u_opp + fetch(x1, y0) * u_ratio) * v_opp
    row2 = (fetch(x1, y1) * u_ratio + fetch(x2, y1) * u_opp) * v_ratio
    return row1 + row2


def bilinear_sample_footprint(quads, fp, width, height, uv):
    """Bilinear sample through the footprint atlas, one row read per lane:
    the plain version of the footprint fetch. quads: (Rq, 8) int32; fp:
    (6, N) int32 [base rx ry wb rw rh] or (9, N) with the tile_params rows;
    width/height: (N,) int32; uv: (2, N). Returns (3, N) RGB in [0, 1]."""
    return _fetch_mix(quads, *_address_lanes(quads.shape[0], fp, width, height, uv))
