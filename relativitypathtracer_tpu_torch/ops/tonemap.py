"""Hable filmic tonemapping normalized by a white point.

Torch counterpart of `relativitypathtracer_tpu.ops.tonemap`; constants as
opencl_kernel.cl:607-616.
"""

from __future__ import annotations

import torch

_A = 0.15
_B = 0.50
_C = 0.10
_D = 0.20
_E = 0.02
_F = 0.30


def hable(x):
    return ((x * (_A * x + _C * _B) + _D * _E) / (x * (_A * x + _B) + _D * _F)) - _E / _F


def tonemap(color, white_point):
    """hable(color) / hable(white_point), clamped to <= 1.
    color: (..., 3); white_point: (3,)."""
    return torch.clamp(hable(color) / hable(white_point), max=1.0)
