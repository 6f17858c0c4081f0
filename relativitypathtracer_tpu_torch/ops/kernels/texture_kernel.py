"""Footprint-atlas texel fetch: K2 (small atlases) and K8 (larger), one kernel.

Torch counterpart of `relativitypathtracer_tpu.ops.pallas.texture_kernel`
(`_address_lanes`, `footprint_sample_small`, `footprint_sample_windowed`,
`texture_route`). Each footprint-atlas row holds two footprint quads: the four
texels [(x0,y0), (x1,y0), (x1,y1), (x2,y1)] of the reference's bilinear taps
(opencl_kernel.cl:427-470), with its border clamp already applied when the
atlas was built (models.scene._footprint_atlas). A fetch is the Morton
address of (x0, y0), one row read, and the reference's weighting.

On the TPU, K2 is a one-hot MXU product over a VMEM-resident atlas of at
most MAX_ROWS rows and K8 walks larger atlases in DMA windows, because the TPU
has no fast gather. The card has one: a MID atlas (65,536 rows x 32 B = 2 MB)
sits in the 50 MB L2 many times over, so one direct-gather CUDA kernel
(csrc/texture_kernels.cu) computes both, on every atlas size. `texture_route`
therefore sends MID and BIG atlases alike to that kernel (the JAX package
sends BIG ones to an XLA gather); the route only names the TPU kernel a
launch stands for, in the launch counts.

`footprint_fetch` is the renderer's form: a per-object table (O, TABLE_COLS)
and each lane's object id, so the per-object selection happens inside the
kernel; given each object's flat colour and textured flag, it also makes
the select that follows the fetch in the renderer (the JAX package's
`jnp.where(textured, tex_rgb, flat_rgb)`), so a lane on an untextured object
gets its flat colour. `footprint_sample_small` / `footprint_sample_windowed`
keep the JAX package's per-lane signature, the texel on every lane. All
call the operator torch.ops.rpt.footprint_sample, which launches the CUDA
kernel on CUDA tensors and runs the plain twin `footprint_fetch_plain` on CPU
tensors.

A channel is k / 255 rounded to float32, which the twin reads from the
256-entry table CHANNEL (numpy's float32 division) and the kernel computes
exactly: a CUDA division by a Python scalar multiplies by the reciprocal,
which is one bit off for 126 of the 256 values.
"""

from __future__ import annotations

import numpy as np
import torch

from ..texture_layout import TABLE_COLS, tile_params, tile_slot, tile_slot_fast
from ._build import check_cuda, constant, define_op, launch, on_cpu

MAX_ROWS = 1024  # the JAX package's small-atlas (K2) limit
# float32 k / 255 for every channel value k, correctly rounded
CHANNEL = np.arange(256, dtype=np.float32) / np.float32(255.0)


def texture_route(rq: int) -> str:
    """The TPU kernel an Rq-row footprint atlas's fetch stands for: "small"
    (K2) up to MAX_ROWS rows, "windowed" (K8) above. Both run the same CUDA
    kernel; the JAX package's third route, an XLA gather for atlases over
    65,536 rows, is not taken (see the module docstring)."""
    return "small" if rq <= MAX_ROWS else "windowed"


def _address_lanes(quads_rows: int, fp, width, height, uv):
    """Footprint addressing of every lane, as the JAX package's: uv to the
    atlas row and half. fp is (6, N) [base rx ry wb rw rh] or (9, N) with the
    tile_params rows [sm1 ss r16] appended. Returns (addr_i (2, N) int32 rows
    [row, hi_half], addr_f (2, N) f32 rows [u_ratio, v_ratio])."""
    w, h = width, height
    u = w.to(torch.float32) * uv[0]
    v = h.to(torch.float32) * (1.0 - uv[1])
    x = torch.minimum(torch.floor(u).to(torch.int32), w - 1)
    y = torch.minimum(torch.floor(v).to(torch.int32), h - 1)
    u_ratio = u - x.to(torch.float32)
    v_ratio = v - y.to(torch.float32)
    x0 = torch.minimum(torch.clamp(x, min=0), w - 1)
    y0 = torch.minimum(torch.clamp(y, min=0), h - 1)
    base, rx, ry, wb, rw, rh = fp[0], fp[1], fp[2], fp[3], fp[4], fp[5]
    lx = torch.minimum(torch.clamp(x0 - rx, min=0), torch.clamp(rw - 1, min=0))
    ly = torch.minimum(torch.clamp(y0 - ry, min=0), torch.clamp(rh - 1, min=0))
    if fp.shape[0] >= 9:
        slot = tile_slot_fast(lx, ly, fp[6], fp[7], fp[8])
    else:
        slot = tile_slot(lx, ly, wb, rh)
    idx4 = torch.clamp((base + slot) * 4, 0, quads_rows * 8 - 4)
    addr_i = torch.stack([idx4 >> 3, ((idx4 & 7) >= 4).to(torch.int32)])
    return addr_i, torch.stack([u_ratio, v_ratio])


def _fetch_mix(quads, addr_i, addr_f):
    """Read each lane's footprint quad and weight its four taps in the
    reference order. quads: (Rq, 8) int32 packed texels R | G << 8 | B << 16.
    Returns (3, N) f32 RGB in [0, 1]."""
    quad = quads.view(-1, 2, 4)[addr_i[0].long(), addr_i[1].long()].T  # (4, N)
    u_ratio, v_ratio = addr_f[0], addr_f[1]
    u_opp = 1.0 - u_ratio
    v_opp = 1.0 - v_ratio
    channel = constant(CHANNEL.tolist(), torch.float32, quads.device)

    def texel(k):
        q = quad[k]
        return channel[torch.stack([q & 0xFF, (q >> 8) & 0xFF, (q >> 16) & 0xFF]).long()]

    row1 = texel(0) * u_opp + texel(1) * u_ratio
    row2 = texel(2) * u_ratio + texel(3) * u_opp
    return row1 * v_opp + row2 * v_ratio


def footprint_fetch_plain(quads, table, obj, uv, color=None, textured=None):
    """Plain twin of the kernel. Returns (rgb (3, N) f32, quad (N,) int32: the
    footprint quad each lane read, 2 * row + hi_half). With color and
    textured, a lane whose object is untextured gets its flat colour."""
    obj_l = obj.long()
    sel = table[obj_l].T  # (TABLE_COLS, N)
    addr_i, addr_f = _address_lanes(quads.shape[0], sel[2:], sel[0], sel[1], uv)
    rgb = _fetch_mix(quads, addr_i, addr_f)
    if color is not None:
        rgb = torch.where(textured[obj_l][None, :], rgb, color.T[:, obj_l])
    return rgb, addr_i[0] * 2 + addr_i[1]


def _fetch_cuda(quads, table, obj, uv, color, textured, with_quads: bool):
    n, rq, o = uv.shape[1], quads.shape[0], table.shape[0]
    specs = [(quads, torch.int32, (rq, 8)), (table, torch.int32, (o, TABLE_COLS)),
             (obj, torch.int32, (n,))]
    if color is not None:
        specs += [(color, torch.float32, (o, 3)), (textured, torch.bool, (o,))]
    check_cuda("footprint_fetch", *specs, (uv, torch.float32, (2, n)), contiguous=False)
    if not all(x.is_contiguous() for x, _, _ in specs):
        raise ValueError("footprint_fetch: every input but uv must be contiguous")
    if uv.stride(1) != 1:
        raise ValueError("footprint_fetch: uv's rows must be contiguous")
    if quads.data_ptr() % 16:
        raise ValueError("footprint_fetch: the atlas must be 16-byte aligned")
    rgb, quad = _fetch_fake(quads, table, obj, uv, color, textured, with_quads)
    launch("rpt_footprint_sample", quads, rq, table, o, color, textured, obj, uv[0], uv[1], n,
           rgb, quad if with_quads else None, key=f"rpt_footprint_sample/{texture_route(rq)}")
    return rgb, quad


def _fetch_cpu(quads, table, obj, uv, color, textured, with_quads: bool):
    rgb, quad = footprint_fetch_plain(quads, table, obj, uv, color, textured)
    return rgb, quad if with_quads else quad.new_empty(0)


def _fetch_fake(quads, table, obj, uv, color, textured, with_quads: bool):
    n = uv.shape[1]
    return (uv.new_empty((3, n), dtype=torch.float32),
            uv.new_empty(n if with_quads else 0, dtype=torch.int32))


_fetch_op = define_op(
    "footprint_sample", "(Tensor quads, Tensor table, Tensor obj, Tensor uv, Tensor? color, "
    "Tensor? textured, bool with_quads) -> (Tensor, Tensor)", _fetch_cuda, _fetch_cpu,
    _fetch_fake)


def footprint_fetch(quads, table, obj, uv, color=None, textured=None, with_quads: bool = False):
    """Bilinear texel of every lane from the footprint atlas. quads: (Rq, 8)
    int32; table: (O, TABLE_COLS) int32 from texture_layout.texture_table (or
    one row per lane); obj: (N,) int32 row of `table` per lane; uv: (2, N)
    f32, its rows may have any stride. color: (O, 3) f32 flat colours and
    textured: (O,) bool, both or neither: with them a lane whose object is
    untextured gets its flat colour instead of a texel. Returns (3, N) f32
    RGB, and with `with_quads` also the (N,) int32 quad index each lane
    read. The launch counts under texture_route's route for Rq."""
    if (color is None) != (textured is None):
        raise ValueError("footprint_fetch: give color and textured together")
    if not on_cpu("footprint_fetch", uv) and (uv.dim() != 2 or uv.stride(1) != 1):
        uv = uv.contiguous()
    rgb, quad = _fetch_op(quads, table, obj, uv, color, textured, with_quads)
    return (rgb, quad) if with_quads else rgb


def footprint_sample_small(quads, fp, width, height, uv):
    """The JAX package's per-lane signature: quads (Rq, 8) int32, fp (6|9, N)
    int32, width/height (N,) int32, uv (2, N). Returns (3, N) RGB. Runs the
    fetch with one table row per lane."""
    if fp.shape[0] < 9:
        fp = torch.cat([fp, torch.stack(tile_params(fp[3], fp[5]))])
    table = torch.cat([width[None], height[None], fp]).T.to(torch.int32).contiguous()
    obj = torch.arange(uv.shape[1], dtype=torch.int32, device=uv.device)
    return footprint_fetch(quads, table, obj, uv)


def footprint_sample_windowed(quads, fp, width, height, uv):
    """footprint_sample_small for atlases over MAX_ROWS rows: the same kernel."""
    return footprint_sample_small(quads, fp, width, height, uv)
